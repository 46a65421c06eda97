"""The port's kernel plain versions and model-layout entry points
(`repro_torch.kernels.ref` / `.ops`, CPU tensors) against the JAX
reference (`repro.kernels.ref`, and `repro.kernels.ops` with the Pallas
kernels in interpret mode), on the shape / window / softcap /
valid_from / dtype matrix of tests/test_kernels.py.

Tolerances as tests/test_kernels.py: 2e-5 in fp32, 2e-2 in bf16 (both
sides compute in fp32 and round to the input dtype at the end)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jax

from repro.kernels import ops as jops
from repro.kernels import ref as JR
from repro.quant import quantize_int8
from repro_torch.kernels import ops, ref as R
from repro_torch.kernels.decode_attention import decode_attention as kdecode
from repro_torch.kernels.flash_attention import flash_attention as kflash
from repro_torch.kernels.int8_matmul import int8_matmul as kint8

SHAPES = [
    # (B, Hq, KV, T, hd, window, cap)
    (1, 2, 2, 32, 16, 0, 0.0),
    (2, 4, 2, 64, 16, 0, 0.0),
    (1, 4, 1, 32, 8, 16, 0.0),     # MQA + window
    (2, 8, 2, 48, 32, 0, 50.0),    # softcap
    (1, 2, 2, 40, 64, 24, 30.0),   # window + softcap
]
DTYPES = ["float32", "bfloat16"]
TOL = {"float32": 2e-5, "bfloat16": 2e-2}

# The JAX oracles, compiled once per shape (faster here than eager
# per-op dispatch).
jax_flash_ref = jax.jit(JR.flash_attention_ref,
                        static_argnames=("window", "cap"))
jax_decode_ref = jax.jit(JR.decode_attention_ref,
                         static_argnames=("cap", "window"))


def _pair(a, dtype):
    """Same numbers on both sides: (jax array, torch CPU tensor)."""
    j = jnp.asarray(a, getattr(jnp, dtype))
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(
        getattr(torch, dtype))
    return j, t


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _vf(v):
    return (None, None) if v is None else (
        jnp.asarray(v, jnp.int32), torch.tensor(v, dtype=torch.int32))


@pytest.mark.parametrize("vf", [None, "mixed"])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_ref_matches_jax(shape, dtype, vf, rng):
    B, Hq, KV, T, hd, win, cap = shape
    jq, tq = _pair(rng.normal(size=(B, Hq, T, hd)), dtype)
    jk, tk = _pair(rng.normal(size=(B, KV, T, hd)), dtype)
    jv, tv = _pair(rng.normal(size=(B, KV, T, hd)), dtype)
    jvf, tvf = _vf(None if vf is None else [7, T][:B])
    want = jax_flash_ref(jq, jk, jv, window=win, cap=cap,
                                  valid_from=jvf)
    got = R.flash_attention_ref(tq, tk, tv, window=win, cap=cap,
                                valid_from=tvf)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(_np(got), _np(want), atol=TOL[dtype],
                               rtol=TOL[dtype])


@pytest.mark.parametrize("vf", [None, [0, 7, 16, 41]])
@pytest.mark.parametrize("window", [0, 16])
@pytest.mark.parametrize("ring", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_ref_matches_jax(ring, window, vf, dtype, rng):
    B, Hq, KV, S, hd, cache_pos = 4, 4, 2, 64, 16, 40
    jq, tq = _pair(rng.normal(size=(B, Hq, hd)), dtype)
    jk, tk = _pair(rng.normal(size=(B, KV, S, hd)), dtype)
    jv, tv = _pair(rng.normal(size=(B, KV, S, hd)), dtype)
    pos = (np.arange(S) + 17) % 61 if ring else np.arange(S)
    pos = np.where(pos <= cache_pos, pos, -1).astype(np.int32)
    jvf, tvf = _vf(vf)
    want = jax_decode_ref(jq, jk, jv, jnp.asarray(pos), cache_pos,
                                   cap=30.0, window=window, valid_from=jvf)
    got = R.decode_attention_ref(tq, tk, tv, torch.from_numpy(pos),
                                 cache_pos, cap=30.0, window=window,
                                 valid_from=tvf)
    np.testing.assert_allclose(_np(got), _np(want), atol=TOL[dtype],
                               rtol=TOL[dtype])
    if vf is not None:
        assert not got[3].any()       # vf past cache_pos: exact zeros


@pytest.mark.parametrize("mnk", [(32, 48, 64), (64, 80, 96), (16, 16, 128)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_int8_ref_matches_jax(mnk, dtype, rng):
    M, N, K = mnk
    jx, tx = _pair(rng.normal(size=(M, K)), dtype)
    wq, sc = quantize_int8(jnp.asarray(rng.normal(size=(K, N)), jnp.float32),
                           axis=0)
    want = JR.int8_matmul_ref(jx, wq, sc.reshape(-1))
    got = R.int8_matmul_ref(tx, torch.from_numpy(np.array(wq)),
                            torch.from_numpy(np.array(sc).reshape(-1)))
    tol = 1e-4 if dtype == "float32" else 5e-2
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


# -- the ops entry points against the JAX ops (Pallas, interpret mode) ----

def _btHd(rng, B, T, H, KV, hd):
    q = rng.normal(size=(B, T, H, hd)).astype(np.float32)
    k = rng.normal(size=(B, T, KV, hd)).astype(np.float32)
    v = rng.normal(size=(B, T, KV, hd)).astype(np.float32)
    return q, k, v


def test_ops_flash_offset_rebase_matches_jax(rng):
    """prefill_row's path: absolute valid_from rebased by pos_k[0]."""
    q, k, v = _btHd(rng, 1, 32, 2, 2, 16)
    off = 64
    pos = np.arange(off, off + 32, dtype=np.int32)
    want = jops.flash_attention(*map(jnp.asarray, (q, k, v)),
                                jnp.asarray(pos), jnp.asarray(pos),
                                jnp.asarray([off + 9], jnp.int32))
    got = ops.flash_attention(*map(torch.from_numpy, (q, k, v)),
                              torch.from_numpy(pos), torch.from_numpy(pos),
                              torch.tensor([off + 9], dtype=torch.int32))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def test_ops_flash_nonmultiple_length_gqa_matches_jax(rng):
    """T = 37 is no multiple of the JAX block (16): the JAX wrapper pads,
    the port masks the ragged edge."""
    q, k, v = _btHd(rng, 2, 37, 4, 2, 16)
    vf = np.asarray([0, 20], np.int32)
    want = jops.flash_attention_btHd(*map(jnp.asarray, (q, k, v)),
                                     jnp.asarray(vf), window=8,
                                     softcap=20.0, block_q=16, block_k=16)
    got = ops.flash_attention_btHd(*map(torch.from_numpy, (q, k, v)),
                                   torch.from_numpy(vf), window=8,
                                   softcap=20.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-5,
                               rtol=3e-5)


@pytest.mark.parametrize("ring", [False, True])
def test_ops_decode_unwritten_slots_match_jax(ring, rng):
    """pos = -1 slots (never written) are masked; S = 40 is no multiple
    of the JAX block (16), whose wrapper pads pos with -1."""
    B, Hq, KV, S, hd, cache_pos = 3, 4, 2, 40, 16, 30
    q = rng.normal(size=(B, 1, Hq, hd)).astype(np.float32)
    k = rng.normal(size=(B, S, KV, hd)).astype(np.float32)
    v = rng.normal(size=(B, S, KV, hd)).astype(np.float32)
    pos = (np.arange(S) + 11) % 37 if ring else np.arange(S)
    pos = np.where(pos <= cache_pos, pos, -1).astype(np.int32)
    vf = np.asarray([0, 9, 31], np.int32)
    want = jops.decode_attention(*map(jnp.asarray, (q, k, v, pos)),
                                 jnp.int32(cache_pos), jnp.asarray(vf),
                                 block_s=16, linear=not ring)
    got = ops.decode_attention(*map(torch.from_numpy, (q, k, v, pos)),
                               cache_pos, torch.from_numpy(vf),
                               linear=not ring)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    assert not got[2].any()


def test_ops_int8_nonmultiple_matches_jax(rng):
    x = rng.normal(size=(5, 70)).astype(np.float32)
    wq, sc = quantize_int8(jnp.asarray(rng.normal(size=(70, 33)),
                                       jnp.float32), axis=0)
    want = jops.int8_matmul(jnp.asarray(x), wq, sc.reshape(-1), block_m=16,
                            block_n=16, block_k=32)
    got = ops.int8_matmul(torch.from_numpy(x),
                          torch.from_numpy(np.array(wq)),
                          torch.from_numpy(np.array(sc).reshape(-1)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


# -- the port's own pins and the no-fallback rule ---------------------------

def test_ops_valid_from_zero_bit_identical(rng):
    q, k, v = map(torch.from_numpy, _btHd(rng, 2, 24, 4, 2, 16))
    zeros = torch.zeros(2, dtype=torch.int32)
    assert torch.equal(ops.flash_attention_btHd(q, k, v),
                       ops.flash_attention_btHd(q, k, v, zeros))
    pos = torch.arange(24, dtype=torch.int32)
    assert torch.equal(ops.decode_attention(q[:, :1], k, v, pos, 20),
                       ops.decode_attention(q[:, :1], k, v, pos, 20, zeros))


def test_kernel_wrappers_refuse_cpu_tensors():
    """The CUDA wrappers launch or raise: a CPU tensor never reaches a
    plain version through them (only `ops` dispatches to `ref`)."""
    x = torch.zeros(2, 2, 8, 16)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        kflash(x, x, x)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        kdecode(x[:, :, 0], x, x, torch.zeros(8, dtype=torch.int32), 3)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        kint8(torch.zeros(4, 8), torch.zeros(8, 3, dtype=torch.int8),
              torch.ones(3))
    assert ops.launch_counts() == {"flash_attention": 0,
                                   "decode_attention": 0, "int8_matmul": 0}


def test_ops_reject_mixed_devices():
    x = torch.zeros(1, 4, 2, 8)
    with pytest.raises(ValueError, match="mixed devices"):
        ops._on_cpu(x, torch.empty(0, device="meta"))
