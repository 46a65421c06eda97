"""The port's model path (`repro_torch.models`, `repro_torch.quant`) on
weights carried across from the JAX reference with `from_jax`, against
the reference's forward / prefill / decode_step on the CPU.

Logits agree within 1e-5 of max|logit| (both sides are fp32; sums run
in another order), int8 candidates within 1e-4 (see below). int8
execution trees are built on each side from the
same fp32 weights and must be equal bit for bit."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jax_reduced_config
from repro.configs.paper_zoo import MEASURED_ZOO
from repro.models import init_params as jax_init_params
from repro.models.model import decode_step as jax_decode_step
from repro.models.model import forward as jax_forward
from repro.models.model import prefill as jax_prefill
from repro.quant.int8 import quantize_exec_tree as jax_quantize
from repro_torch.configs import reduced_config
from repro_torch.models import decode_step, forward, from_jax, prefill
from repro_torch.models.params import tree_leaves
from repro_torch.quant.int8 import quantize_exec_tree
from repro_torch.serving.measured import build_model

TOL = 1e-5
INT8_TOL = 1e-4


def _cfgs(name, attn_impl="naive"):
    spec = MEASURED_ZOO[name]
    kw = dict(d_model=spec["d_model"], d_ff=spec["d_ff"],
              n_layers=spec["n_layers"])
    jcfg = dataclasses.replace(jax_reduced_config(spec["arch"]),
                               attn_impl="naive", **kw)
    tcfg = dataclasses.replace(reduced_config(spec["arch"]),
                               attn_impl=attn_impl, **kw)
    return jcfg, tcfg


def _zoo_weights(name, seed=0):
    """(jax params, port params) of one MEASURED_ZOO row, int8 rows
    quantized on each side from the same fp32 weights."""
    jcfg, _ = _cfgs(name)
    jp = jax_init_params(jcfg, jax.random.PRNGKey(seed))
    tp = from_jax(jp, device="cpu")
    if MEASURED_ZOO[name]["quant"] == "int8":
        jp, tp = jax_quantize(jp), quantize_exec_tree(tp)
    return jp, tp


def _close(got, want, tol=TOL):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=tol * max(1.0, np.abs(want).max()))


@functools.lru_cache(maxsize=None)
def _jax_run(name):
    """The reference's logits (jit, CPU) for one zoo row: a forward, a
    left-padded prefill and three decode steps, plus the filled cache."""
    jcfg, _ = _cfgs(name)
    jp, _ = _zoo_weights(name)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, jcfg.vocab, (2, 8)).astype(np.int32)
    dec = rng.integers(0, jcfg.vocab, (3, 2, 1)).astype(np.int32)
    vf = jnp.asarray(VF)
    fwd = jax.jit(jax_forward, static_argnums=2)
    pre = jax.jit(jax_prefill, static_argnums=(2, 3),
                  static_argnames="logits_last_only")
    step = jax.jit(jax_decode_step, static_argnums=4)
    out = [fwd(jp, jnp.asarray(toks), jcfg)[0]]
    lg, cache = pre(jp, jnp.asarray(toks), jcfg, 16, logits_last_only=True,
                    valid_from=vf)
    out.append(lg)
    for s in range(3):
        lg, cache = step(jp, jnp.asarray(dec[s]), cache, jnp.int32(8 + s),
                         jcfg, valid_from=vf)
        out.append(lg)
    return toks, dec, [np.asarray(o) for o in out], jax.tree.map(
        np.asarray, cache)


VF = np.asarray([0, 3], np.int32)


@pytest.mark.parametrize("impl", ["naive", "cuda"])
@pytest.mark.parametrize("name", list(MEASURED_ZOO))
def test_zoo_logits_match_jax(name, impl):
    """Every MEASURED_ZOO row (fp32 and int8) on both attention impls:
    forward, a left-padded prefill and three decode steps equal the
    reference's, and so does the filled cache."""
    toks, dec, want, jc = _jax_run(name)
    _, tcfg = _cfgs(name, impl)
    _, tp = _zoo_weights(name)
    # The reference's int8 path applies the scale after the fp32 sum
    # (its Pallas kernel), the port's CPU path before it (the plain
    # version): a rounding difference that compounds over the layers.
    tol = TOL if MEASURED_ZOO[name]["quant"] is None else INT8_TOL
    got = [forward(tp, torch.from_numpy(toks), tcfg)[0]]
    lg, tc = prefill(tp, torch.from_numpy(toks), tcfg, 16,
                     logits_last_only=True, valid_from=torch.from_numpy(VF))
    got.append(lg)
    for s in range(3):
        lg, tc = decode_step(tp, torch.from_numpy(dec[s]), tc, 8 + s, tcfg,
                             valid_from=torch.from_numpy(VF))
        got.append(lg)
    for g, w in zip(got, want):
        _close(g, w, tol)
    jk = jc["blocks"][0]["k"]
    _close(tc["blocks"][0]["k"], jk, tol)
    np.testing.assert_array_equal(tc["blocks"][0]["pos"].numpy(),
                                  jc["blocks"][0]["pos"])


@pytest.mark.parametrize("impl", ["naive", "cuda"])
def test_padded_prefill_matches_unpadded(impl):
    """A left-padded row with valid_from produces the unpadded prompt's
    logits (RoPE is shift-invariant; pads are masked out)."""
    _, tcfg = _cfgs("lm_small", impl)
    _, tp = _zoo_weights("lm_small")
    rng = np.random.default_rng(2)
    short = torch.from_numpy(rng.integers(0, 256, 5).astype(np.int32))
    padded = torch.zeros((1, 8), dtype=torch.int32)
    padded[0, 3:] = short
    lp, _ = prefill(tp, padded, tcfg, 16, logits_last_only=True,
                    valid_from=torch.tensor([3], dtype=torch.int32))
    lu, _ = prefill(tp, short[None], tcfg, 16, logits_last_only=True)
    np.testing.assert_allclose(lp.numpy(), lu.numpy(), atol=1e-4)


@pytest.mark.parametrize("impl", ["naive", "cuda"])
def test_valid_from_zero_is_exact_noop(impl):
    """valid_from = 0 is bit-identical to no valid_from on the port."""
    _, tcfg = _cfgs("lm_small_int8", impl)
    _, tp = _zoo_weights("lm_small_int8")
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, 256, (2, 8)).astype(np.int32))
    a, ca = prefill(tp, toks, tcfg, 16)
    b, cb = prefill(tp, toks, tcfg, 16, valid_from=torch.zeros(
        2, dtype=torch.int32))
    assert torch.equal(a, b)
    tok = toks[:, :1]
    a, _ = decode_step(tp, tok, ca, 8, tcfg)
    b, _ = decode_step(tp, tok, cb, 8, tcfg,
                       valid_from=torch.zeros(2, dtype=torch.int32))
    assert torch.equal(a, b)


@pytest.mark.parametrize("name", ["lm_small_int8", "lm_base_int8"])
def test_int8_exec_tree_equals_jax(name):
    """round-half-to-even on both sides: q and scales are bit-equal, and
    the tree keeps the reference's structure."""
    jcfg, _ = _cfgs(name)
    jp = jax_init_params(jcfg, jax.random.PRNGKey(4))
    want = from_jax(jax_quantize(jp), device="cpu")
    got = quantize_exec_tree(from_jax(jp, device="cpu"))
    assert jax.tree.structure(jax.tree.map(lambda _: 0, want)) == \
        jax.tree.structure(jax.tree.map(lambda _: 0, got))
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert got["blocks"][0]["wq"]["q"].dtype == torch.int8


def test_resident_bytes_match_reference():
    """Sizes the ModelZoo budgets with (benchmarks/results/
    BENCH_measured_serving.json): the port's trees hold the same bytes."""
    want = {"lm_tiny": 308160, "lm_small": 837504,
            "lm_small_int8": 364416, "lm_base_int8": 1130112}
    for name, n in want.items():
        m = build_model(name, batch_size=2, max_seq=32, device="cpu")
        assert m.size_bytes == m.engine.resident_bytes == n, name


def test_from_jax_keeps_structure_and_bf16():
    jcfg, _ = _cfgs("lm_tiny")
    jp = jax_init_params(dataclasses.replace(jcfg, param_dtype="bfloat16"),
                         jax.random.PRNGKey(0))
    tp = from_jax(jp, device="cpu")
    assert set(tp) == set(jp) and isinstance(tp["blocks"], tuple)
    assert tp["blocks"][0]["wq"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        tp["embed"].float().numpy(),
        np.asarray(jp["embed"].astype(jnp.float32)))


def test_unported_kinds_raise():
    _, tcfg = _cfgs("lm_tiny")
    from repro_torch.models import init_cache
    moe = init_cache(dataclasses.replace(tcfg, pattern=("moe",)), 1, 8,
                     device="cpu")["blocks"][0]
    assert set(moe) == {"k", "v", "pos"} and moe["k"].shape[2] == 8
    # Past Tq*Tk = 4096² "auto" computes, as the reference's does: it
    # takes the chunked attention (tests/test_torch_chunked.py holds
    # that against the reference).
    big = dataclasses.replace(tcfg, attn_impl="auto", attn_chunk=1024)
    q = torch.randn(1, 4097, 1, 16, generator=torch.Generator().manual_seed(0))
    from repro_torch.models.layers import attention
    pos = torch.arange(4097)
    got = attention(q, q, q, pos, pos, big, window=0)
    want = attention(q, q, q, pos, pos,
                     dataclasses.replace(big, attn_impl="chunked"), window=0)
    assert torch.equal(got, want)


def _slice_weights(impl, quant=None, seed=7):
    """The slice's reduced size (2 layers, d 96): reference config and
    params, and the port's on the same weights."""
    kw = dict(d_model=96, d_ff=192, n_layers=2)
    jcfg = dataclasses.replace(jax_reduced_config("stablelm_1_6b"),
                               attn_impl="naive", **kw)
    tcfg = dataclasses.replace(reduced_config("stablelm_1_6b"),
                               attn_impl=impl, **kw)
    jp = jax_init_params(jcfg, jax.random.PRNGKey(seed))
    tp = from_jax(jp, device="cpu")
    if quant == "int8":
        jp, tp = jax_quantize(jp), quantize_exec_tree(tp)
    return jcfg, jp, tcfg, tp


@pytest.mark.parametrize("impl", ["naive", "cuda"])
def test_decode_step_tensor_cache_pos(impl):
    """cache_pos as a 0-d int32 tensor (what a captured step reads) gives
    the int form's bits, in the logits and in every cache tensor, and the
    reference's decode_step given jnp.int32(pos), within 2e-5."""
    jcfg, jp, tcfg, tp = _slice_weights(impl)
    rng = np.random.default_rng(8)
    toks = rng.integers(0, jcfg.vocab, (2, 8)).astype(np.int32)
    dec = rng.integers(0, jcfg.vocab, (3, 2, 1)).astype(np.int32)
    vf = np.asarray([0, 3], np.int32)
    lg, jc = jax_prefill(jp, jnp.asarray(toks), jcfg, 16,
                         logits_last_only=True, valid_from=jnp.asarray(vf))
    tvf = torch.from_numpy(vf)
    _, c_int = prefill(tp, torch.from_numpy(toks), tcfg, 16,
                       logits_last_only=True, valid_from=tvf)
    _, c_t = prefill(tp, torch.from_numpy(toks), tcfg, 16,
                     logits_last_only=True, valid_from=tvf)
    for s in range(3):
        want, jc = jax_decode_step(jp, jnp.asarray(dec[s]), jc,
                                   jnp.int32(8 + s), jcfg,
                                   valid_from=jnp.asarray(vf))
        tok = torch.from_numpy(dec[s])
        a, c_int = decode_step(tp, tok, c_int, 8 + s, tcfg, valid_from=tvf)
        b, c_t = decode_step(tp, tok, c_t, torch.tensor(8 + s,
                                                        dtype=torch.int32),
                             tcfg, valid_from=tvf)
        assert torch.equal(a, b)
        _close(b, want, 2e-5)
    for x, y in zip(tree_leaves(c_int), tree_leaves(c_t)):
        assert torch.equal(x, y)
    for part in ("blocks", "tail"):
        assert len(c_t[part]) == len(jc[part])
        for tc, jcd in zip(c_t[part], jc[part]):
            np.testing.assert_array_equal(tc["pos"].numpy(), jcd["pos"])
            _close(tc["k"], jcd["k"], 2e-5)
            _close(tc["v"], jcd["v"], 2e-5)
    with pytest.raises(ValueError, match="0-d int32"):
        decode_step(tp, tok, c_t, torch.tensor([11]), tcfg)


@pytest.mark.parametrize("impl", ["naive", "cuda"])
def test_prefill_into_given_cache(impl):
    """prefill(cache=...) writes into the given cache (the engine's
    persistent one): after a longer group and a decode step left stale
    slots in it, a shorter prefill and the decode after it give the bits
    of a fresh cache, and the reference's prefill within 2e-5."""
    jcfg, jp, tcfg, tp = _slice_weights(impl)
    rng = np.random.default_rng(11)
    long = torch.from_numpy(rng.integers(0, jcfg.vocab, (2, 8))
                            .astype(np.int32))
    toks = rng.integers(0, jcfg.vocab, (2, 5)).astype(np.int32)
    tok = torch.from_numpy(rng.integers(0, jcfg.vocab, (2, 1))
                           .astype(np.int32))
    vf = np.asarray([0, 2], np.int32)
    tvf = torch.from_numpy(vf)
    _, kept = prefill(tp, long, tcfg, 16)
    _, kept = decode_step(tp, tok, kept, 8, tcfg)
    ptrs = [x.data_ptr() for x in tree_leaves(kept)]
    a, c_kept = prefill(tp, torch.from_numpy(toks), tcfg, 16,
                        logits_last_only=True, valid_from=tvf, cache=kept)
    b, c_new = prefill(tp, torch.from_numpy(toks), tcfg, 16,
                       logits_last_only=True, valid_from=tvf)
    assert c_kept is kept
    assert [x.data_ptr() for x in tree_leaves(c_kept)] == ptrs
    assert torch.equal(a, b)
    want, _ = jax_prefill(jp, jnp.asarray(toks), jcfg, 16,
                          logits_last_only=True, valid_from=jnp.asarray(vf))
    _close(a, want, 2e-5)
    for x, y in zip(c_kept["blocks"] + c_kept["tail"],
                    c_new["blocks"] + c_new["tail"]):
        assert torch.equal(x["pos"], y["pos"])
        for key in ("k", "v"):
            assert torch.equal(x[key][..., :5, :, :], y[key][..., :5, :, :])
    a, _ = decode_step(tp, tok, c_kept, 5, tcfg, valid_from=tvf)
    b, _ = decode_step(tp, tok, c_new, 5, tcfg, valid_from=tvf)
    assert torch.equal(a, b)
