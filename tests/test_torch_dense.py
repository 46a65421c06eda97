"""The port's five attention-only architectures (gemma2-9b, yi-9b,
deepseek-coder-33b, musicgen-large, chameleon-34b) against the JAX
reference on the CPU, at the reduced configs: configs, parameter and
cache trees, `forward`, `prefill` and `decode_step` under the naive and
the kernel ("cuda": the kernels' plain versions here) attention paths,
gemma2's local ring past its window, embeddings input, padded heads,
the int8 execution trees, the harness's group-by-group int8 build, and
the serving engine.

Weights: the reference's `init_params`, carried across with `from_jax`
(the JAX side runs the naive attention path). Tolerance: fp32 logits
within 1e-4 of max|JAX logit|, int8 logits too (the reference applies
the scale after the fp32 sum, the port's plain version before it); the
int8 trees bit for bit."""

import dataclasses
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced_config as jax_reduced_config
from repro.models import init_params as jax_init_params
from repro.models.model import decode_step as jax_decode_step
from repro.models.model import forward as jax_forward
from repro.models.model import init_cache as jax_init_cache
from repro.models.model import prefill as jax_prefill
from repro.quant.int8 import quantize_exec_tree as jax_quantize
from repro.serving.engine import InferenceEngine as JaxEngine
from repro_torch.configs import get_config, reduced_config
from repro_torch.models import (decode_step, forward, from_jax, init_cache,
                                init_params, prefill)
from repro_torch.models.params import tree_leaves, tree_map
from repro_torch.quant.int8 import quantize_exec_tree
from repro_torch.serving.engine import InferenceEngine

TOL = 1e-4
ARCHS = ["gemma2_9b", "yi_9b", "deepseek_coder_33b", "musicgen_large",
         "chameleon_34b"]
TOKEN_ARCHS = ["gemma2_9b", "yi_9b", "deepseek_coder_33b"]
EMBED_ARCHS = ["musicgen_large", "chameleon_34b"]
IMPLS = ["naive", "cuda"]
# The reference's entry points, jitted (the config is static).
jax_forward = jax.jit(jax_forward, static_argnums=2)
jax_prefill = jax.jit(jax_prefill, static_argnums=(2, 3))
jax_decode_step = jax.jit(jax_decode_step, static_argnums=4)


def _chip_smoke():
    """chip_smoke.py as a module (for its `tree_by_group`)."""
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _close(got, want, tol=TOL):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(1.0, np.abs(want).max()))


def _cfgs(arch, impl="naive", **kw):
    """(reference config, port config), reduced; kw replaces fields on
    both sides."""
    return (dataclasses.replace(jax_reduced_config(arch), attn_impl="naive",
                                **kw),
            dataclasses.replace(reduced_config(arch), attn_impl=impl, **kw))


def _weights(jcfg, seed=0, quant=None):
    """(reference params, port params): the reference's init carried
    across with from_jax; int8 trees quantized on each side."""
    jp = jax_init_params(jcfg, jax.random.PRNGKey(seed))
    tp = from_jax(jp, device="cpu")
    if quant == "int8":
        jp, tp = jax_quantize(jp), quantize_exec_tree(tp)
    return jp, tp


def _inputs(cfg, seed, B, T):
    """(B, T) tokens, or (B, T, d) frame / patch embeddings."""
    rng = np.random.default_rng(seed)
    if cfg.input_mode == "embeddings":
        return rng.normal(size=(B, T, cfg.d_model)).astype(np.float32)
    return rng.integers(0, cfg.vocab, (B, T)).astype(np.int32)


def _shapes(tree):
    return jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)[-7:]), tree)


# -- configs and trees --------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_configs_and_trees_match_reference(arch):
    """The full and reduced configs equal the reference's field by field
    (attn_impl aside: the reference's impls are not the port's), with
    the same parameter count; the port's parameter and cache trees have
    the reference's structure, shapes and dtypes, and from_jax carries
    every leaf across."""
    for full in (True, False):
        j = jax_get_config(arch) if full else jax_reduced_config(arch)
        t = get_config(arch) if full else reduced_config(arch)
        ja, ta = dataclasses.asdict(j), dataclasses.asdict(t)
        ja.pop("attn_impl"), ta.pop("attn_impl")
        assert ja == ta
        assert j.param_count() == t.param_count()
    jcfg, tcfg = _cfgs(arch)
    jp, carried = _weights(jcfg, 3)
    tp = init_params(tcfg, 3, device="cpu")
    assert jax.tree.structure(_shapes(jp)) == jax.tree.structure(_shapes(tp))
    assert _shapes(jp) == _shapes(carried) == _shapes(
        tree_map(lambda t: t.numpy(), tp))
    for a, b in zip(jax.tree.leaves(jp), jax.tree.leaves(carried)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert sum(t.numel() for t in tree_leaves(tp)) == tcfg.param_count()
    jc = jax_init_cache(jcfg, 2, 16)
    tc = init_cache(tcfg, 2, 16, device="cpu")
    assert _shapes(jc) == _shapes(tree_map(lambda t: t.numpy(), tc))


# -- the models ---------------------------------------------------------------

def _prefill_decode(jcfg, tcfg, jp, tp, x, T0, max_seq=32):
    """forward over x, then prefill of x[:, :T0] and a decode step at each
    later position, on both sides: every step within TOL of the
    reference's and of the port's own forward at that position; the
    caches' k / v / pos within TOL (pos equal). Returns the last
    decode's port logits."""
    T = x.shape[1]
    want = np.asarray(jax_forward(jp, jnp.asarray(x), jcfg)[0])
    full = forward(tp, torch.from_numpy(x), tcfg)[0]
    _close(full, want)
    lg, tc = prefill(tp, torch.from_numpy(x[:, :T0]), tcfg, max_seq)
    jl, jc = jax_prefill(jp, jnp.asarray(x[:, :T0]), jcfg, max_seq)
    _close(lg, jl)
    for t in range(T0, T):
        lg, tc = decode_step(tp, torch.from_numpy(x[:, t:t + 1]), tc, t, tcfg)
        jl, jc = jax_decode_step(jp, jnp.asarray(x[:, t:t + 1]), jc,
                                 jnp.int32(t), jcfg)
        _close(lg, jl)
        _close(lg[:, 0], full[:, t].numpy())
    for t_c, j_c in zip(tc["blocks"] + tc["tail"], jc["blocks"] + jc["tail"]):
        _close(t_c["k"], j_c["k"])
        _close(t_c["v"], j_c["v"])
        np.testing.assert_array_equal(t_c["pos"].numpy(),
                                      np.asarray(j_c["pos"]))
    return lg


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_prefill_decode_match_jax(arch, impl):
    """forward over 20 positions, a prefill of 12 and 8 decode steps
    equal the reference's (tokens, or embeddings for musicgen and
    chameleon): softcaps, sandwich norms, embed_scale, tanh GELU,
    local/global alternation (gemma2), qk-norm (chameleon), an ungated
    MLP (musicgen)."""
    jcfg, tcfg = _cfgs(arch, impl)
    jp, tp = _weights(jcfg, 1)
    _prefill_decode(jcfg, tcfg, jp, tp, _inputs(tcfg, 1, 2, 20), 12)


@pytest.mark.parametrize("impl", IMPLS)
def test_gemma2_ring_decode_three_windows(impl):
    """gemma2 decoding three windows past its local layers' window
    (tests/test_decode.py:36): the local layers keep an 8-slot ring, the
    global ones a linear cache; every step equals the reference's decode
    and the last one the reference's forward over the whole sequence."""
    jcfg, tcfg = _cfgs("gemma2_9b", impl)
    jp, tp = _weights(jcfg, 2)
    T = 3 * tcfg.window
    x = _inputs(tcfg, 2, 1, T)
    full = np.asarray(jax_forward(jp, jnp.asarray(x), jcfg)[0])
    _, tc = prefill(tp, torch.from_numpy(x[:, :4]), tcfg, T)
    _, jc = jax_prefill(jp, jnp.asarray(x[:, :4]), jcfg, T)
    local, glob = tc["blocks"]
    assert local["k"].shape[2] == tcfg.window and glob["k"].shape[2] == T
    for t in range(4, T):
        lg, tc = decode_step(tp, torch.from_numpy(x[:, t:t + 1]), tc, t, tcfg)
        jl, jc = jax_decode_step(jp, jnp.asarray(x[:, t:t + 1]), jc,
                                 jnp.int32(t), jcfg)
        _close(lg, jl)
    _close(lg[:, 0], full[:, -1])
    for i in range(2):
        np.testing.assert_array_equal(tc["blocks"][i]["pos"].numpy(),
                                      np.asarray(jc["blocks"][i]["pos"]))


@pytest.mark.parametrize("impl", IMPLS)
def test_gemma2_prefill_longer_than_window(impl):
    """A prefill of T = 20 > window 8 fills the local ring as the
    reference does (tests/test_decode.py:53), and the steps after it
    agree with the reference and with the forward over the sequence."""
    jcfg, tcfg = _cfgs("gemma2_9b", impl)
    jp, tp = _weights(jcfg, 3)
    _prefill_decode(jcfg, tcfg, jp, tp, _inputs(tcfg, 3, 2, 23), 20,
                    max_seq=64)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("arch", EMBED_ARCHS)
def test_embeddings_input_decode(arch, impl):
    """Frame / patch embeddings in (tests/test_decode.py:68): a prefill of
    T - 1 embeddings and one decode step give the last position of one
    forward over all T, on both sides."""
    jcfg, tcfg = _cfgs(arch, impl)
    jp, tp = _weights(jcfg, 4)
    B, T = 2, 10
    x = _inputs(tcfg, 4, B, T)
    full = forward(tp, torch.from_numpy(x), tcfg)[0]
    _close(full, jax_forward(jp, jnp.asarray(x), jcfg)[0])
    _, tc = prefill(tp, torch.from_numpy(x[:, :T - 1]), tcfg, 16)
    _, jc = jax_prefill(jp, jnp.asarray(x[:, :T - 1]), jcfg, 16)
    lg, _ = decode_step(tp, torch.from_numpy(x[:, T - 1:]), tc, T - 1, tcfg)
    jl, _ = jax_decode_step(jp, jnp.asarray(x[:, T - 1:]), jc,
                            jnp.int32(T - 1), jcfg)
    _close(lg, jl)
    _close(lg[:, 0], full[:, -1].numpy())


@pytest.mark.parametrize("impl", IMPLS)
def test_deepseek_padded_heads(impl):
    """deepseek with its 4 reduced q heads padded to tp_pad_heads = 8 on
    both sides (the reduced config sets 0): 8 q heads on 2 kv heads in
    wq, wo and attention, every step equal to the reference's."""
    jcfg, tcfg = _cfgs("deepseek_coder_33b", impl, tp_pad_heads=8)
    jp, tp = _weights(jcfg, 5)
    assert tcfg.q_heads_padded == 8 and tcfg.n_heads == 4
    blk = tp["blocks"][0]
    assert tuple(blk["wq"].shape[1:]) == (tcfg.d_model, 8, tcfg.head_dim)
    assert tuple(blk["wo"].shape[1:]) == (8, tcfg.head_dim, tcfg.d_model)
    _prefill_decode(jcfg, tcfg, jp, tp, _inputs(tcfg, 5, 2, 16), 10)


# -- int8 ---------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_int8_trees_match_reference(arch):
    """The int8 execution trees of the two sides are equal bit for bit
    (every projection int8, embeddings, lm_head and norms fp32); the
    int8 candidate's forward, prefill and a decode step within TOL of
    the reference's."""
    jcfg, tcfg = _cfgs(arch, "cuda")
    jp, tp = _weights(jcfg, 6, quant="int8")
    want = from_jax(jp, device="cpu")
    assert jax.tree.structure(jax.tree.map(lambda _: 0, want)) == \
        jax.tree.structure(jax.tree.map(lambda _: 0, tp))
    for a, b in zip(jax.tree.leaves(tp), jax.tree.leaves(want)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    blk = tp["blocks"][0]
    for key in ("wq", "wk", "wv", "wo"):
        assert blk[key]["q"].dtype == torch.int8, key
    for key in blk["mlp"]:
        assert blk["mlp"][key]["q"].dtype == torch.int8, key
    assert tp["embed"].dtype == torch.float32
    x = _inputs(tcfg, 6, 2, 12)
    _close(forward(tp, torch.from_numpy(x), tcfg)[0],
           jax_forward(jp, jnp.asarray(x), jcfg)[0])
    lg, tc = prefill(tp, torch.from_numpy(x[:, :10]), tcfg, 16)
    jl, jc = jax_prefill(jp, jnp.asarray(x[:, :10]), jcfg, 16)
    _close(lg, jl)
    lg, _ = decode_step(tp, torch.from_numpy(x[:, 10:11]), tc, 10, tcfg)
    jl, _ = jax_decode_step(jp, jnp.asarray(x[:, 10:11]), jc, jnp.int32(10),
                            jcfg)
    _close(lg, jl)


@pytest.mark.parametrize("arch", ARCHS)
def test_int8_build_by_group_equals_quantize_exec_tree(arch):
    """chip_smoke's group-by-group build (each group's fp32 slice drawn,
    quantized and written into the int8 stacks) equals
    `quantize_exec_tree` of the fp32 tree stacked from the same draws,
    bit for bit; the same padded heads as the full config (deepseek)."""
    build = _chip_smoke().tree_by_group
    cfg = reduced_config(arch)
    if arch == "deepseek_coder_33b":
        cfg = dataclasses.replace(cfg, tp_pad_heads=8)
    fp32 = build(cfg, 7, device="cpu", quantize=False)
    want = quantize_exec_tree(fp32)
    got = build(cfg, 7, device="cpu")
    assert jax.tree.structure(jax.tree.map(lambda _: 0, want)) == \
        jax.tree.structure(jax.tree.map(lambda _: 0, got))
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)
    assert _shapes(fp32) == _shapes(tree_map(
        lambda t: t.numpy(), init_params(cfg, 7, device="cpu")))


# -- the engine ---------------------------------------------------------------

def _engine(tcfg, params, batch_size=2, max_seq=32):
    eng = InferenceEngine(tcfg, params, batch_size=batch_size,
                          max_seq=max_seq, device="cpu")
    eng.warmup(prompt_len=6)
    return eng


@pytest.mark.parametrize("arch", TOKEN_ARCHS)
def test_generate_matches_jax_engine(arch):
    """Same weights and prompts: the port's engine (kernel path) generates
    the JAX engine's greedy tokens over two groups in turn (for gemma2
    the first prompt is past its window of 8)."""
    jcfg, tcfg = _cfgs(arch, "cuda")
    jp, tp = _weights(jcfg, 8)
    je = JaxEngine(jcfg, jp, batch_size=2, max_seq=32)
    te = _engine(tcfg, tp)
    for T, n in ((12, 6), (5, 4)):
        prompts = _inputs(tcfg, T, 2, T)
        np.testing.assert_array_equal(te.generate(prompts, n),
                                      je.generate(prompts, n))


def test_gemma2_engine_steps_match_model_on_fresh_cache():
    """gemma2's engine steps over its one persistent cache (a longer
    group before, past the window, its ring slots stale) give the bits
    of `models.model` prefill / decode_step on a fresh cache."""
    _, tcfg = _cfgs("gemma2_9b", "cuda")
    _, tp = _weights(_cfgs("gemma2_9b")[0], 9)
    eng = _engine(tcfg, tp)
    vf = torch.zeros(2, dtype=torch.int32)
    got, want = [], []
    for T, n in ((14, 5), (5, 4)):
        prompts = _inputs(tcfg, T + 1, 2, T)
        got.append(eng.run_prefill(prompts))
        lg, cache = prefill(tp, torch.from_numpy(prompts), tcfg, 32,
                            logits_last_only=True, valid_from=vf)
        want.append(lg[:, 0].numpy())
        for i in range(n):
            nxt = got[-1].argmax(-1).astype(np.int32)[:, None]
            got.append(eng.run_decode(nxt))
            lg, cache = decode_step(tp, torch.from_numpy(nxt), cache, T + i,
                                    tcfg, valid_from=vf)
            want.append(lg[:, 0].numpy())
    for i, (g, w) in enumerate(zip(got, want)):
        assert np.array_equal(g, w), i


@pytest.mark.parametrize("max_seq", [8, 32])
def test_gemma2_backfill_past_window_refused_as_reference(max_seq):
    """gemma2 with max_seq > window (its local ring wraps slots): both
    engines refuse prefill_row with NotImplementedError; at max_seq ==
    window both backfill and agree."""
    jcfg, tcfg = _cfgs("gemma2_9b", "cuda")
    jp, tp = _weights(jcfg, 10)
    je = JaxEngine(jcfg, jp, batch_size=2, max_seq=max_seq)
    te = _engine(tcfg, tp, max_seq=max_seq)
    prompts = _inputs(tcfg, 10, 2, 4)
    row = _inputs(tcfg, 11, 1, 4)[0]
    for eng in (je, te):
        assert eng._backfillable == (max_seq <= tcfg.window)
        eng.run_prefill(prompts)
    if max_seq > tcfg.window:
        for eng in (je, te):
            with pytest.raises(NotImplementedError, match="backfill"):
                eng.prefill_row(row, 0)
    else:
        _close(te.prefill_row(row, 0, length=3),
               je.prefill_row(row, 0, length=3))
