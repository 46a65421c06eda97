"""The port's recurrent model families (`repro_torch.models.rglru`,
`repro_torch.models.ssd`, and recurrentgemma / mamba2 through
`models.model`, `quant.int8` and the serving engine) against the JAX
reference on the CPU, at the reduced configs.

Weights: the model-level tests draw them with the port's `init_params`
(each leaf scaled by its layer's own fan-in, as the port serves them),
hand them to the reference as numpy arrays and carry them back with
`from_jax`, so both sides run the same numbers. The reference's own
`init_params` scales a stacked leaf by the group count (2 here), which
drives the RG-LRU gates to pre-activations of about N(0, 32); there
sqrt(1 - a^2) loses fp32 accuracy on both sides alike (against a
float64 evaluation of the gates both are 1.3e-4 off, and 3e-5 from each
other), which no implementation of the same fp32 formula avoids.

Tolerances: fp32 logits within 1e-5 of max|logit| (sums run in another
order on each side); the int8 candidate within 1e-4 (the reference's
int8 path applies the scale after the fp32 sum, the port's CPU path
before it); layer-level functions as the reference's own tests hold
them (tests/test_layers.py)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jax_reduced_config
from repro.models import init_params as jax_init_params
from repro.models import rglru as JR
from repro.models import ssd as JS
from repro.models.config import RGLRUConfig as JaxRGLRUConfig
from repro.models.config import ModelConfig as JaxModelConfig
from repro.models.model import decode_step as jax_decode_step
from repro.models.model import forward as jax_forward
from repro.models.model import prefill as jax_prefill
from repro.models.params import block_tree as jax_block_tree
from repro.quant.int8 import quantize_exec_tree as jax_quantize
from repro.serving.engine import InferenceEngine as JaxEngine
from repro_torch.configs import get_config, reduced_config
from repro_torch.models import (decode_step, forward, from_jax, init_cache,
                                init_params, prefill)
from repro_torch.models import rglru as TR
from repro_torch.models import ssd as TS
from repro_torch.models.config import ModelConfig, RGLRUConfig
from repro_torch.models.params import tree_leaves, tree_map
from repro_torch.quant.int8 import quantize_exec_tree
from repro_torch.serving.engine import InferenceEngine

TOL = 1e-5
INT8_TOL = 1e-4
ARCHS = ["recurrentgemma_2b", "mamba2_2_7b"]
# The reference's entry points, jitted (the config is static).
jax_forward = jax.jit(jax_forward, static_argnums=2)
jax_prefill = jax.jit(jax_prefill, static_argnums=(2, 3))
jax_decode_step = jax.jit(jax_decode_step, static_argnums=4)


def _close(got, want, tol=TOL):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(1.0, np.abs(want).max()))


def _cfgs(arch, impl="naive"):
    return (dataclasses.replace(jax_reduced_config(arch), attn_impl="naive"),
            dataclasses.replace(reduced_config(arch), attn_impl=impl))


def _weights(arch, seed=0, quant=None):
    """(reference params, port params): the port's init on the CPU,
    carried to the reference as numpy and back with from_jax; int8
    trees quantized on each side from the same fp32 weights."""
    _, tcfg = _cfgs(arch)
    drawn = init_params(tcfg, seed, device="cpu")
    jp = jax.tree.map(jnp.asarray, tree_map(lambda t: t.numpy(), drawn))
    tp = from_jax(jp, device="cpu")
    if quant == "int8":
        jp, tp = jax_quantize(jp), quantize_exec_tree(tp)
    return jp, tp


def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(
        np.int32)


# -- layer functions ---------------------------------------------------------

def _rglru_params(W=16):
    """The reference test's block (tests/test_layers.py:138): every leaf
    normal * 0.3, on both sides."""
    cfg = JaxModelConfig(name="t", family="hybrid", n_layers=1, d_model=W,
                         n_heads=4, n_kv_heads=4, head_dim=4, d_ff=32,
                         vocab=64, pattern=("rglru",),
                         rglru=JaxRGLRUConfig(lru_width=W))
    key, counter = jax.random.PRNGKey(0), [0]

    def mk(shape, axes, init):
        counter[0] += 1
        return jax.random.normal(jax.random.fold_in(key, counter[0]),
                                 shape) * 0.3
    jp = jax_block_tree(cfg, "rglru", mk)
    tcfg = ModelConfig(**dict(dataclasses.asdict(cfg),
                              rglru=RGLRUConfig(lru_width=W)))
    return cfg, jp, tcfg, from_jax(jp, device="cpu")


@pytest.mark.parametrize("T", [1, 10, 33])
def test_rglru_scan_matches_step_and_jax(T):
    """The doubling scan equals the step form run T times (and its final
    state), and the reference's associative scan, from a zero and from a
    given state."""
    jcfg, jp, tcfg, tp = _rglru_params()
    x = np.random.default_rng(T).normal(size=(2, T, 16)).astype(np.float32)
    h0 = np.random.default_rng(T + 1).normal(size=(2, 16)).astype(np.float32)
    u = torch.from_numpy(x) @ tp["w_in"]
    for start in (None, h0):
        th0 = None if start is None else torch.from_numpy(start)
        y, h_last = TR.rglru_scan(tp, u, tcfg, th0)
        h = torch.zeros(2, 16) if start is None else th0
        outs = []
        for t in range(T):
            yt, h = TR.rglru_step(tp, u[:, t:t + 1], tcfg, h)
            outs.append(yt)
        np.testing.assert_allclose(y.numpy(), torch.cat(outs, 1).numpy(),
                                   atol=1e-5)
        np.testing.assert_allclose(h_last.numpy(), h.numpy(), atol=1e-5)
        jy, jh = JR.rglru_scan(jp, jnp.asarray(u.numpy()), jcfg,
                               None if start is None else jnp.asarray(start))
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-5)
        np.testing.assert_allclose(h_last.numpy(), np.asarray(jh), atol=1e-5)


def test_causal_conv_matches_jax_and_streams(rng):
    w = rng.normal(size=(6, 4)).astype(np.float32)
    x = rng.normal(size=(2, 9, 6)).astype(np.float32)
    y, state = TR.causal_conv1d(torch.from_numpy(w), torch.from_numpy(x))
    jy, jstate = JR.causal_conv1d(jnp.asarray(w), jnp.asarray(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-6)
    np.testing.assert_array_equal(state.numpy(), np.asarray(jstate))
    st, ys = None, []
    for t in range(9):
        yt, st = TR.causal_conv1d(torch.from_numpy(w),
                                  torch.from_numpy(x[:, t:t + 1]), st)
        ys.append(yt)
    np.testing.assert_allclose(torch.cat(ys, 1).numpy(), np.asarray(jy),
                               atol=1e-5)


def _ssd_inputs(rng, B, T, H, P, N, G):
    return (rng.normal(size=(B, T, H, P)).astype(np.float32),
            rng.uniform(0.01, 0.2, size=(B, T, H)).astype(np.float32),
            -rng.uniform(0.5, 2.0, size=(H,)).astype(np.float32),
            rng.normal(size=(B, T, G, N)).astype(np.float32),
            rng.normal(size=(B, T, G, N)).astype(np.float32))


@pytest.mark.parametrize("G", [1, 2])
@pytest.mark.parametrize("chunk", [4, 5, 12, 16])
def test_ssd_chunked_matches_jax(chunk, G, rng):
    """Both the single-group and the per-head branch, T = 12 at chunks
    that divide it, that do not (padded to a whole chunk), and that
    exceed it; from a zero and from a given state."""
    B, T, H, P, N = 2, 12, 4, 4, 8
    ins = _ssd_inputs(rng, B, T, H, P, N, G)
    S0 = rng.normal(size=(B, H, N, P)).astype(np.float32)
    for start in (None, S0):
        y, S = TS.ssd_chunked(*map(torch.from_numpy, ins), chunk,
                              None if start is None
                              else torch.from_numpy(start))
        jy, jS = JS.ssd_chunked(*map(jnp.asarray, ins), chunk,
                                None if start is None else jnp.asarray(start))
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=2e-5)
        np.testing.assert_allclose(S.numpy(), np.asarray(jS), atol=2e-5)


@pytest.mark.parametrize("G", [1, 2])
def test_ssd_step_continues_chunked(G, rng):
    """A step after a chunked prefill of T = 8 (chunk 3: padded) gives the
    output at position 8 of one chunked pass over 9 tokens, and the
    reference's step from the reference's state."""
    B, T, H, P, N = 1, 8, 4, 4, 4
    x, dt, A, Bm, Cm = map(torch.from_numpy,
                           _ssd_inputs(rng, B, T + 1, H, P, N, G))
    y_all, _ = TS.ssd_chunked(x, dt, A, Bm, Cm, chunk=3)
    _, S_pre = TS.ssd_chunked(x[:, :T], dt[:, :T], A, Bm[:, :T], Cm[:, :T],
                              chunk=3)
    y_step, S_new = TS.ssd_step(x[:, T:], dt[:, T:], A, Bm[:, T:],
                                Cm[:, T:], S_pre)
    np.testing.assert_allclose(y_step[:, 0].numpy(), y_all[:, T].numpy(),
                               atol=1e-4)
    jy, jS = JS.ssd_step(*(jnp.asarray(t[:, T:].numpy()) for t in (x, dt)),
                         jnp.asarray(A.numpy()),
                         *(jnp.asarray(t[:, T:].numpy()) for t in (Bm, Cm)),
                         jnp.asarray(S_pre.numpy()))
    np.testing.assert_allclose(y_step.numpy(), np.asarray(jy), atol=1e-5)
    np.testing.assert_allclose(S_new.numpy(), np.asarray(jS), atol=1e-5)


# -- configs and parameter trees ----------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_configs_and_trees_match_reference(arch):
    """The full configs equal the reference's field by field, the reduced
    ones keep its sub-configs, the port's parameter and cache trees have
    the reference's structure, shapes and dtypes, and from_jax carries
    every leaf of a reference tree across."""
    from repro.configs import get_config as jax_get_config
    from repro.models.model import init_cache as jax_init_cache
    for full in (True, False):
        j = jax_get_config(arch) if full else jax_reduced_config(arch)
        t = get_config(arch) if full else reduced_config(arch)
        assert dataclasses.asdict(j) == dataclasses.asdict(t)
    jcfg, tcfg = _cfgs(arch)
    jp = jax_init_params(jcfg, jax.random.PRNGKey(3))
    tp = init_params(tcfg, 3, device="cpu")
    carried = from_jax(jp, device="cpu")
    shapes = lambda tree: jax.tree.map(lambda a: (tuple(a.shape),
                                                  str(a.dtype)[-7:]), tree)
    assert jax.tree.structure(shapes(jp)) == jax.tree.structure(shapes(tp))
    assert shapes(jp) == shapes(carried) == shapes(
        tree_map(lambda t: t.numpy(), tp))
    for a, b in zip(jax.tree.leaves(jp), jax.tree.leaves(carried)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    jc = jax_init_cache(jcfg, 2, 16)
    tc = init_cache(tcfg, 2, 16, device="cpu")
    assert shapes(jc) == shapes(tree_map(lambda t: t.numpy(), tc))


def test_recurrent_inits_follow_reference_ranges():
    """The RG-LRU and SSD inits draw from the reference's ranges: a =
    exp(-8 softplus(Lambda)) in [0.9, 0.999], A = exp(A_log) in [1, 16),
    softplus(dt_bias) in [1e-3, 1e-1], D and the gated norm ones, and
    the same seed gives the same tree."""
    sp = torch.nn.functional.softplus
    rg = init_params(reduced_config("recurrentgemma_2b"), 5, device="cpu")
    a = torch.exp(-8.0 * sp(rg["blocks"][0]["lam"]))
    assert 0.9 - 1e-6 <= float(a.min()) and float(a.max()) <= 0.999 + 1e-6
    mb = init_params(reduced_config("mamba2_2_7b"), 5, device="cpu")
    blk = mb["blocks"][0]
    A = torch.exp(blk["A_log"])
    assert 1.0 - 1e-6 <= float(A.min()) and float(A.max()) < 16.0
    dt = sp(blk["dt_bias"])
    assert 1e-3 - 1e-7 <= float(dt.min()) and float(dt.max()) <= 1e-1 + 1e-7
    assert bool((blk["D"] == 1).all()) and bool((blk["norm_w"] == 1).all())
    again = init_params(reduced_config("mamba2_2_7b"), 5, device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(mb),
                                                  tree_leaves(again)))


# -- the models ---------------------------------------------------------------

@pytest.mark.parametrize("impl", ["naive", "cuda"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_prefill_decode_match_jax(arch, impl):
    """forward, a prefill of 12 tokens and 8 decode steps equal the
    reference's, and so do the recurrent states of the cache; each decode
    step also equals the port's own forward at that position."""
    jcfg, tcfg = _cfgs(arch, impl)
    jp, tp = _weights(arch, 1)
    toks = _tokens(1, (2, 20))
    want = np.asarray(jax_forward(jp, jnp.asarray(toks), jcfg)[0])
    full = forward(tp, torch.from_numpy(toks), tcfg)[0]
    _close(full, want)
    lg, tc = prefill(tp, torch.from_numpy(toks[:, :12]), tcfg, 32)
    jl, jc = jax_prefill(jp, jnp.asarray(toks[:, :12]), jcfg, 32)
    _close(lg, jl)
    for t in range(12, 20):
        lg, tc = decode_step(tp, torch.from_numpy(toks[:, t:t + 1]), tc, t,
                             tcfg)
        jl, jc = jax_decode_step(jp, jnp.asarray(toks[:, t:t + 1]), jc,
                                 jnp.int32(t), jcfg)
        _close(lg, jl)
        _close(lg[:, 0], full[:, t].numpy())
    for part in ("blocks", "tail"):
        for t_c, j_c in zip(tc[part], jc[part]):
            for key in ("h", "S", "conv"):
                for a, b in zip(jax.tree.leaves(t_c.get(key)),
                                jax.tree.leaves(j_c.get(key))):
                    _close(a, b)


@pytest.mark.parametrize("impl", ["naive", "cuda"])
def test_ring_buffer_window_decode(impl):
    """recurrentgemma decoding three windows past its local layers' ring
    (tests/test_decode.py:36): every step equals the reference's decode,
    and the last one the reference's forward over the whole sequence."""
    jcfg, tcfg = _cfgs("recurrentgemma_2b", impl)
    jp, tp = _weights("recurrentgemma_2b", 2)
    T = 3 * tcfg.window
    x = _tokens(2, (1, T))
    full = np.asarray(jax_forward(jp, jnp.asarray(x), jcfg)[0])
    _, tc = prefill(tp, torch.from_numpy(x[:, :4]), tcfg, T)
    _, jc = jax_prefill(jp, jnp.asarray(x[:, :4]), jcfg, T)
    assert tc["blocks"][2]["k"].shape[2] == tcfg.window
    for t in range(4, T):
        lg, tc = decode_step(tp, torch.from_numpy(x[:, t:t + 1]), tc, t,
                             tcfg)
        jl, jc = jax_decode_step(jp, jnp.asarray(x[:, t:t + 1]), jc,
                                 jnp.int32(t), jcfg)
        _close(lg, jl)
    _close(lg[:, 0], full[:, -1])
    np.testing.assert_array_equal(tc["blocks"][2]["pos"].numpy(),
                                  np.asarray(jc["blocks"][2]["pos"]))


@pytest.mark.parametrize("impl", ["naive", "cuda"])
def test_prefill_longer_than_window(impl):
    """A prefill of T > window fills the ring as the reference does, and
    the decode after it agrees."""
    jcfg, tcfg = _cfgs("recurrentgemma_2b", impl)
    jp, tp = _weights("recurrentgemma_2b", 3)
    x = _tokens(3, (2, 21))
    lg, tc = prefill(tp, torch.from_numpy(x[:, :20]), tcfg, 32)
    jl, jc = jax_prefill(jp, jnp.asarray(x[:, :20]), jcfg, 32)
    _close(lg, jl)
    lg, _ = decode_step(tp, torch.from_numpy(x[:, 20:]), tc, 20, tcfg)
    jl, _ = jax_decode_step(jp, jnp.asarray(x[:, 20:]), jc, jnp.int32(20),
                            jcfg)
    _close(lg, jl)


def test_int8_candidate_matches_jax():
    """recurrentgemma int8: the execution trees of the two sides are equal
    bit for bit, with the MLP and attention projections of both block
    kinds int8 and the RG-LRU mixer fp32; forward, prefill and decode
    within 1e-4 of max|logit|. mamba2 has no key the int8 path takes,
    so its tree stays fp32, as in the reference."""
    arch = "recurrentgemma_2b"
    jcfg, tcfg = _cfgs(arch, "cuda")
    jp, tp = _weights(arch, 4, quant="int8")
    want = from_jax(jp, device="cpu")
    assert jax.tree.structure(jax.tree.map(lambda _: 0, want)) == \
        jax.tree.structure(jax.tree.map(lambda _: 0, tp))
    for a, b in zip(jax.tree.leaves(tp), jax.tree.leaves(want)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    rg, loc = tp["blocks"][0], tp["blocks"][2]
    assert rg["mlp"]["w_down"]["q"].dtype == torch.int8
    assert loc["wq"]["q"].dtype == torch.int8
    for key in ("w_gate_branch", "w_in", "w_a", "w_x", "w_out"):
        assert rg[key].dtype == torch.float32, key
    toks = _tokens(4, (2, 12))
    _close(forward(tp, torch.from_numpy(toks), tcfg)[0],
           jax_forward(jp, jnp.asarray(toks), jcfg)[0], INT8_TOL)
    lg, tc = prefill(tp, torch.from_numpy(toks[:, :10]), tcfg, 16)
    jl, jc = jax_prefill(jp, jnp.asarray(toks[:, :10]), jcfg, 16)
    _close(lg, jl, INT8_TOL)
    lg, _ = decode_step(tp, torch.from_numpy(toks[:, 10:11]), tc, 10, tcfg)
    jl, _ = jax_decode_step(jp, jnp.asarray(toks[:, 10:11]), jc,
                            jnp.int32(10), jcfg)
    _close(lg, jl, INT8_TOL)
    _, mp = _weights("mamba2_2_7b", 4)
    mq = quantize_exec_tree(mp)
    assert all(a.dtype == torch.float32 and torch.equal(a, b)
               for a, b in zip(tree_leaves(mq), tree_leaves(mp)))


# -- the engine ---------------------------------------------------------------

def _engine(arch, params, impl="cuda", batch_size=2, max_seq=32):
    _, tcfg = _cfgs(arch, impl)
    eng = InferenceEngine(tcfg, params, batch_size=batch_size,
                          max_seq=max_seq, device="cpu")
    eng.warmup(prompt_len=6)
    return eng


@pytest.mark.parametrize("arch, quant", [("recurrentgemma_2b", None),
                                         ("recurrentgemma_2b", "int8"),
                                         ("mamba2_2_7b", None)])
def test_generate_matches_jax_engine(arch, quant):
    """Same weights and prompts: the port's engine (kernel path) generates
    the JAX engine's greedy tokens, over two groups in turn (the second
    shorter, past the ring of the first for recurrentgemma)."""
    jcfg, _ = _cfgs(arch)
    jp, tp = _weights(arch, 6, quant)
    je = JaxEngine(jcfg, jp, batch_size=2, max_seq=32)
    te = _engine(arch, tp)
    for T, n in ((12, 6), (5, 4)):
        prompts = _tokens(T, (2, T))
        np.testing.assert_array_equal(te.generate(prompts, n),
                                      je.generate(prompts, n))


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_steps_match_model_on_fresh_cache(arch):
    """The engine's steps over its one persistent cache (a longer group
    before, its ring slots and recurrent state stale) give the bits of
    `models.model` prefill / decode_step on a fresh cache."""
    _, tp = _weights(arch, 7)
    eng = _engine(arch, tp)
    ptrs = [t.data_ptr() for t in tree_leaves(eng.cache)]
    got, want = [], []
    for T, n in ((14, 3), (5, 4)):
        prompts = _tokens(T + 1, (2, T))
        got.append(eng.run_prefill(prompts))
        lg, cache = prefill(tp, torch.from_numpy(prompts), eng.cfg, 32,
                            logits_last_only=True)
        want.append(lg[:, 0].numpy())
        for i in range(n):
            nxt = got[-1].argmax(-1).astype(np.int32)[:, None]
            got.append(eng.run_decode(nxt))
            lg, cache = decode_step(tp, torch.from_numpy(nxt), cache, T + i,
                                    eng.cfg)
            want.append(lg[:, 0].numpy())
    for i, (g, w) in enumerate(zip(got, want)):
        assert np.array_equal(g, w), i
    assert [t.data_ptr() for t in tree_leaves(eng.cache)] == ptrs


@pytest.mark.parametrize("arch", ARCHS)
def test_padded_prompts_and_backfill_rejected(arch):
    """As the reference (tests/test_measured_serving.py:102): a recurrent
    pattern takes no per-row mask, so padded prompts, valid_from and slot
    backfill raise."""
    _, tp = _weights(arch, 8)
    eng = _engine(arch, tp)
    assert not eng._maskable and not eng._backfillable
    with pytest.raises(NotImplementedError, match="recurrent"):
        eng.run_prefill(np.zeros((2, 8), np.int32), lengths=[8, 4])
    eng.run_prefill(np.zeros((2, 8), np.int32))
    with pytest.raises(NotImplementedError, match="backfill"):
        eng.prefill_row(np.zeros(4, np.int32), 0)
    with pytest.raises(NotImplementedError, match="recurrent"):
        forward(tp, torch.zeros((2, 4), dtype=torch.int32), eng.cfg,
                valid_from=torch.zeros(2, dtype=torch.int32))
