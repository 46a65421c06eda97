"""The port's kernel plain versions and model-layout entry points
(`repro_torch.kernels.ref` / `.ops`, CPU tensors) against the JAX
reference (`repro.kernels.ref`, and `repro.kernels.ops` with the Pallas
kernels in interpret mode), on the shape / window / softcap /
valid_from / dtype matrix of tests/test_kernels.py.

Tolerances as tests/test_kernels.py: 2e-5 in fp32, 2e-2 in bf16 (both
sides compute in fp32 and round to the input dtype at the end)."""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jax

from repro.kernels import ops as jops
from repro.kernels import ref as JR
from repro.quant import quantize_int8
from repro_torch.kernels import ops, ref as R
from repro_torch.kernels.decode_attention import _check_args as decode_check
from repro_torch.kernels.decode_attention import decode_attention as kdecode
from repro_torch.kernels.flash_attention import _check_args as flash_check
from repro_torch.kernels.flash_attention import flash_attention as kflash
from repro_torch.kernels.int8_matmul import int8_matmul as kint8

SHAPES = [
    # (B, Hq, KV, T, hd, window, cap)
    (1, 2, 2, 32, 16, 0, 0.0),
    (2, 4, 2, 64, 16, 0, 0.0),
    (1, 4, 1, 32, 8, 16, 0.0),     # MQA + window
    (2, 8, 2, 48, 32, 0, 50.0),    # softcap
    (1, 2, 2, 40, 64, 24, 30.0),   # window + softcap
    (2, 4, 2, 32, 128, 0, 0.0),    # hd 128, GQA
    (1, 4, 2, 24, 256, 8, 50.0),   # hd 256, GQA + window + softcap 50
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


@pytest.mark.parametrize("hd, window", [(128, 0), (256, 16)])
def test_ops_flash_wide_head_dims_match_jax(hd, window, rng):
    """The head dims of yi_9b (128) and gemma2_9b (256), beyond the old
    cap of 64: GQA, softcap and a ragged valid_from (one row starts past
    its block's first key), T = 40 no multiple of the JAX block."""
    q, k, v = _btHd(rng, 2, 40, 4, 2, hd)
    vf = np.asarray([0, 13], np.int32)
    want = jops.flash_attention_btHd(*map(jnp.asarray, (q, k, v)),
                                     jnp.asarray(vf), window=window,
                                     softcap=50.0, block_q=16, block_k=16)
    got = ops.flash_attention_btHd(*map(torch.from_numpy, (q, k, v)),
                                   torch.from_numpy(vf), window=window,
                                   softcap=50.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=TOL["float32"], rtol=TOL["float32"])


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


@pytest.mark.parametrize("form", ["0-d", "1-element"])
@pytest.mark.parametrize("ring", [False, True])
@pytest.mark.parametrize("entry", ["ops", "ref"])
def test_decode_tensor_cache_pos_matches_jax(entry, ring, form, rng):
    """cache_pos as an int32 tensor (the form a captured decode step
    reads from device memory): `ops.decode_attention` against the JAX
    ops (Pallas, interpret mode) and `decode_attention_ref` against the
    JAX plain version given jnp.int32(cache_pos), within 2e-5."""
    B, Hq, KV, S, hd, cache_pos = 3, 4, 2, 48, 16, 37
    q = rng.normal(size=(B, 1, Hq, hd)).astype(np.float32)
    k = rng.normal(size=(B, S, KV, hd)).astype(np.float32)
    v = rng.normal(size=(B, S, KV, hd)).astype(np.float32)
    pos = (np.arange(S) + 11) % 45 if ring else np.arange(S)
    pos = np.where(pos <= cache_pos, pos, -1).astype(np.int32)
    vf = np.asarray([0, 9, 38], np.int32)
    tpos = torch.tensor(cache_pos, dtype=torch.int32)
    if form == "1-element":
        tpos = tpos.reshape(1)
    jq, jk, jv, jp, jvf = map(jnp.asarray, (q, k, v, pos, vf))
    tq, tk, tv, tp, tvf = map(torch.from_numpy, (q, k, v, pos, vf))
    if entry == "ops":
        want = jops.decode_attention(jq, jk, jv, jp, jnp.int32(cache_pos),
                                     jvf, block_s=16, linear=not ring)
        got = ops.decode_attention(tq, tk, tv, tp, tpos, tvf,
                                   linear=not ring)
    else:
        kt, vt = jnp.swapaxes(jk, 1, 2), jnp.swapaxes(jv, 1, 2)
        want = jax_decode_ref(jq[:, 0], kt, vt, jp, jnp.int32(cache_pos),
                              cap=30.0, window=16, valid_from=jvf)
        got = R.decode_attention_ref(tq[:, 0], tk.transpose(1, 2),
                                     tv.transpose(1, 2), tp, tpos, cap=30.0,
                                     window=16, valid_from=tvf)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)
    assert not got[2].any()       # vf past cache_pos: exact zeros


def test_decode_wrapper_cache_pos_forms():
    """The kernel reads cache_pos from one int32 on the device: the
    wrapper passes such a tensor as it is, makes one from an int, and
    refuses any other tensor (no silent copy)."""
    from repro_torch.kernels.decode_attention import _device_cache_pos
    cpu = torch.device("cpu")
    t = torch.tensor(5, dtype=torch.int32)
    assert _device_cache_pos(t, cpu) is t
    one = torch.tensor([5], dtype=torch.int32)
    assert _device_cache_pos(one, cpu) is one
    made = _device_cache_pos(7, cpu)
    assert made.dtype == torch.int32 and made.tolist() == [7]
    for bad in (torch.tensor(5), torch.tensor([5, 6], dtype=torch.int32),
                torch.empty((), dtype=torch.int32, device="meta")):
        with pytest.raises(ValueError, match="one int32"):
            _device_cache_pos(bad, cpu)


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


def _bf16_parts(x, parts):
    """fp32 x as `parts` bf16 terms, each the bf16 rounding of what the
    terms before it left (the kernel's hi and lo for parts=2)."""
    out, rest = [], x
    for _ in range(parts):
        out.append(rest.to(torch.bfloat16).float())
        rest = rest - out[-1]
    return out


def _tf32(x):
    """fp32 x rounded to tf32 (10 stored mantissa bits), to nearest with
    ties away from zero, as the kernel's cvt.rna.tf32.f32 rounds."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _mm_3xtf32(a, b):
    """a @ b as the flash kernel computes it for fp32 inputs: each operand
    split into hi = tf32(x) and lo = tf32(x - hi), three products."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def _mm_bf16(a, b):
    """a @ b as one bf16 pass computes it: operands rounded to bf16."""
    return a.to(torch.bfloat16).float() @ b.to(torch.bfloat16).float()


def _flash_emulated(q, k, v, vf, bk, qk, pv):
    """The flash kernel's arithmetic on the CPU, causal: an online
    softmax over key tiles of bk, the scaled s of a tile from
    `qk(q, k_tile)`, each tile's P V computed fresh by `pv(p, v_tile)`
    and then added to the rescaled accumulator; rows that see no key
    give zeros."""
    B, H, T, hd = q.shape
    acc = torch.zeros_like(q)
    m = torch.full((B, H, T), R.NEG_INF)
    l = torch.zeros((B, H, T))
    pos_q = torch.arange(T)[:, None]
    for k0 in range(0, T, bk):
        kt, vt = k[:, :, k0:k0 + bk], v[:, :, k0:k0 + bk]
        pos_k = torch.arange(k0, k0 + kt.shape[2])[None]
        mask = (pos_k <= pos_q)[None] & (pos_k[None] >= vf[:, None, None])
        s = torch.where(mask[:, None], qk(q, kt), R.NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + pv(p, vt)
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]
    return torch.where((m > R.NEG_INF / 2)[..., None], out, 0.0)


# The key tile that csrc/flash_attention.cu ships at each head dim
# (FlashSmem::BK: 32 keys up to hd 128, 16 at hd 256).
FLASH_TILES = [(64, 32), (128, 32), (256, 16)]
FLASH_CU = Path(R.__file__).resolve().parents[1] / "csrc" / "flash_attention.cu"


def _shipped_bk(hd):
    """FlashSmem::BK at head dim hd, read from the kernel's source."""
    m = re.search(r"int BK = HD <= (\d+) \? (\d+) : (\d+);",
                  FLASH_CU.read_text())
    assert m, "FlashSmem::BK not found in flash_attention.cu"
    return int(m[2]) if hd <= int(m[1]) else int(m[3])


def _flash_split_case(rng, hd, dtype):
    """q, k, v (B=2, H=2, T=512; bf16 values for dtype bfloat16) and a
    ragged valid_from as torch CPU tensors, and the JAX reference's fp32
    output on them (no rounding to the input dtype)."""
    B, H, T = 2, 2, 512
    q, k, v = (np.array(jnp.asarray(rng.normal(size=(B, H, T, hd)),
                                    getattr(jnp, dtype)).astype(jnp.float32))
               for _ in range(3))
    vf = np.asarray([0, 211], np.int32)
    want = np.asarray(jax_flash_ref(*map(jnp.asarray, (q, k, v)), window=0,
                                    cap=0.0, valid_from=jnp.asarray(vf)))
    return tuple(map(torch.from_numpy, (q, k, v, vf))), want


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("hd, bk", FLASH_TILES)
def test_flash_split_arithmetic_matches_jax(hd, bk, dtype, rng):
    """The flash kernel's arithmetic, emulated on the CPU at T = 512,
    causal, ragged valid_from, with the key tile the kernel ships for
    this head dim (32 keys at hd 64 and 128, 16 at hd 256): an online
    softmax whose P V is summed a tile at a time into fresh fragments and
    added to the rescaled accumulator.

    fp32 inputs: 3xTF32 products for Q K^T and P V. They agree with the
    JAX reference within 2e-5 + 2e-5 |ref|; one bf16 pass does not,
    which is why fp32 inputs take three TF32 passes.

    bf16 inputs: Q K^T of the bf16 values (exact products, fp32 sums),
    scaled after; P V with fp32 p split into bf16 hi + lo parts, each
    times the exact bf16 v. Before the output's rounding that agrees with
    the reference (fp32 p times fp32 v) within the fp32 tolerance, and
    after it within the bf16 one, 2e-2. p rounded to bf16 once misses the
    fp32 tolerance: that error is what the second P V pass removes."""
    assert _shipped_bk(hd) == bk
    (q, k, v, vf), want = _flash_split_case(rng, hd, dtype)
    tol = TOL["float32"] * (1 + np.abs(want))
    if dtype == "float32":
        qk = lambda q, kt: _mm_3xtf32(q * hd ** -0.5, kt.transpose(-1, -2))
        one = lambda q, kt: _mm_bf16(q * hd ** -0.5, kt.transpose(-1, -2))
        arith = {"kernel": (qk, _mm_3xtf32), "one bf16 pass": (one, _mm_bf16)}
    else:
        qk = lambda q, kt: (q @ kt.transpose(-1, -2)) * hd ** -0.5
        arith = {name: (qk, lambda p, vt, parts=parts: sum(
                     x @ vt for x in reversed(_bf16_parts(p, parts))))
                 for name, parts in (("kernel", 2), ("p rounded", 1))}
    got = {name: _flash_emulated(q, k, v, vf, bk, *fns).numpy()
           for name, fns in arith.items()}
    worst = {name: float((np.abs(g - want) / tol).max())
             for name, g in got.items()}
    assert worst["kernel"] <= 1.0, worst
    assert min(w for n, w in worst.items() if n != "kernel") > 1.0, worst
    if dtype == "bfloat16":
        out = torch.from_numpy(got["kernel"]).to(torch.bfloat16).float()
        np.testing.assert_allclose(out.numpy(), want, atol=TOL[dtype],
                                   rtol=TOL[dtype])


def _mm_3xtf32_chained(a, b, toward_zero):
    """a @ b as the kernel chains its 3xTF32 mma.sync calls: for each 8
    columns of a, lo*hi, hi*lo and hi*hi into one fp32 accumulator. Each
    mma's products are exact; its sum is rounded to fp32 toward zero
    (`toward_zero`, a model of the tensor cores' accumulation, which
    does not round to nearest) or to nearest (IEEE)."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    c = torch.zeros(a.shape[:-1] + b.shape[-1:])
    for k0 in range(0, a.shape[-1], 8):
        cols = slice(k0, k0 + 8)
        for x, y in ((al, bh), (ah, bl), (ah, bh)):
            exact = c.double() + x[..., cols].double() @ y[..., cols, :].double()
            c = exact.float()
            if toward_zero:
                c = torch.where(c.double().abs() > exact.abs(),
                                torch.nextafter(c, torch.zeros_like(c)), c)
    return c


@pytest.mark.parametrize("hd, bk", FLASH_TILES)
def test_flash_3xtf32_sums_toward_zero(hd, bk, rng):
    """Where the fp32 kernel's error beyond the IEEE emulation above comes
    from. With each mma's sum rounded toward zero, Q K^T, a chain of
    3 hd / 8 mma into one accumulator, at least doubles the error of the
    same chain rounded to nearest, and the error still meets 2e-5; P V,
    whose fresh fragments a key tile chain only 3 bk / 8 mma, moves it
    less than Q K^T does."""
    assert _shipped_bk(hd) == bk
    (q, k, v, vf), want = _flash_split_case(rng, hd, "float32")
    tol = TOL["float32"] * (1 + np.abs(want))
    qk = lambda rz: lambda q, kt: _mm_3xtf32_chained(
        q * hd ** -0.5, kt.transpose(-1, -2), rz)
    pv = lambda rz: lambda p, vt: _mm_3xtf32_chained(p, vt, rz)
    outs = {name: _flash_emulated(q, k, v, vf, bk, qk(a), pv(b)).numpy()
            for name, a, b in (("nearest", False, False),
                               ("toward zero in Q K^T", True, False),
                               ("toward zero in P V", False, True),
                               ("toward zero", True, True))}
    err = {name: float(np.abs(o - want).max()) for name, o in outs.items()}
    worst = float((np.abs(outs["toward zero"] - want) / tol).max())
    assert worst <= 1.0, (worst, err)
    assert err["toward zero in Q K^T"] >= 2 * err["nearest"], err
    assert err["toward zero in P V"] < err["toward zero in Q K^T"], err


def test_flash_wrapper_head_dim_limit():
    """The wrapper takes every head_dim up to 256 (the reference configs
    need 64, 128 and 256) and refuses more, before any launch."""
    for hd in (20, 64, 128, 256):
        q = torch.empty(1, 4, 8, hd, device="meta")
        kv = torch.empty(1, 2, 8, hd, device="meta")
        flash_check(q, kv, kv)
    q = torch.empty(1, 4, 8, 257, device="meta")
    with pytest.raises(ValueError, match="head_dim 257 > 256"):
        flash_check(q, q, q)


@pytest.mark.parametrize("K", [2048, 5632])
def test_int8_prefill_split_arithmetic_matches_jax(K, rng):
    """The prefill kernel's arithmetic, emulated on the CPU: the int8
    weights exact in bf16, fp32 x as two bf16 parts (hi, lo), bf16 x bf16
    products summed in fp32, the scale after the sum. It agrees with the
    JAX reference within 1e-4 of max|ref| at the model's K; one part
    alone does not, which is why the kernel splits x."""
    M, N = 64, 256
    x = rng.normal(size=(M, K)).astype(np.float32)
    wq, sc = quantize_int8(jnp.asarray(rng.normal(size=(K, N)), jnp.float32),
                           axis=0)
    want = np.asarray(JR.int8_matmul_ref(jnp.asarray(x), wq, sc.reshape(-1)))
    wq = torch.from_numpy(np.array(wq))
    w = wq.to(torch.bfloat16).float()
    assert torch.equal(w, wq.float())              # int8 -> bf16 is exact
    scale = torch.from_numpy(np.array(sc).reshape(-1))
    tol = 1e-4 * np.abs(want).max()
    err = {}
    for parts in (1, 2):
        acc = sum(p @ w for p in _bf16_parts(torch.from_numpy(x), parts))
        err[parts] = float(np.abs((acc * scale).numpy() - want).max())
    assert err[2] <= tol, err
    assert err[1] > tol, err


@pytest.mark.parametrize("case", [
    # (M, N, K, x_pad): the decode path's shapes in small; x_pad > 0 reads
    # x as a column slice of a wider array (row stride K + x_pad).
    (1, 70, 33, 0),
    (2, 64, 96, 0),
    (4, 96, 160, 0),
    (4, 96, 160, 37),
    (5, 160, 300, 0),
    (8, 33, 70, 0),
    (8, 48, 130, 5),
])
def test_ops_int8_small_m_matches_jax(case, rng):
    """The int8 op at decode-sized M, on the CPU, against the JAX kernel."""
    M, N, K, x_pad = case
    xw = rng.normal(size=(M, K + x_pad)).astype(np.float32)
    wq, sc = quantize_int8(jnp.asarray(rng.normal(size=(K, N)),
                                       jnp.float32), axis=0)
    want = jops.int8_matmul(jnp.asarray(xw[:, :K]), wq, sc.reshape(-1),
                            block_m=8, block_n=32, block_k=32)
    got = ops.int8_matmul(torch.from_numpy(xw)[:, :K],
                          torch.from_numpy(np.array(wq)),
                          torch.from_numpy(np.array(sc).reshape(-1)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


def _decode_split_emulated(q, k, v, pos, cache_pos, vf, *, splits, tile,
                           rows=1, warps=4, window=0, cap=0.0, linear=False):
    """The decode kernel's split-and-combine arithmetic on the CPU, with
    its statistics kept per warp: the cache axis in chunks of `warps`
    warp tiles of `tile` slots; block c of `splits` takes chunks c,
    c + splits, ..., and warp w of it warp tile w of each, in order. Each
    warp runs an online softmax from a running max of -1e30, with p = 0
    exactly for a masked slot, and keeps `rows` accumulators (row group
    g takes slots g, g + rows, ... of each tile), rescaled alike and
    summed in group order when its block folds it. A block folds its
    warps in warp order, then the blocks fold in rank order; in both
    folds a partial whose max is <= -0.5e30 (nothing valid) is left
    out. With `linear`, a block
    none of whose chunks reaches into [valid_from, cache_pos] of a row,
    or a warp tile wholly outside it, is not computed for that row (its
    state is kept as it was). q: (B, Hq, hd) and k, v: (B, KV, S, hd)
    float32; vf: (B,) int. Returns (float32 output (B, Hq, hd), tiles
    skipped)."""
    B, Hq, hd = q.shape
    KV, S = k.shape[1], k.shape[2]
    rep = Hq // KV
    chunk = warps * tile
    neg, half = R.NEG_INF, R.NEG_INF * 0.5
    qg = q.reshape(B, KV, rep, hd) * hd ** -0.5
    p_ = pos.long()
    valid = (p_ >= 0) & (p_ <= cache_pos)
    if window:
        valid &= p_ > cache_pos - window
    valid = valid[None] & (p_[None] >= vf.long()[:, None])       # (B, S)
    vfb = vf.long()[:, None, None]

    def runs(lo, hi):   # (B, 1, 1): the rows that read slots [lo, hi)
        if not linear:
            return torch.ones_like(vfb, dtype=torch.bool)
        return (hi - 1 >= vfb) & torch.tensor(lo <= cache_pos)

    def fold(parts):    # [(m, l, acc)] in order -> (m, l, acc)
        seen = [m > half for m, _, _ in parts]
        M = torch.full_like(parts[0][0], neg)
        for (m, _, _), ok in zip(parts, seen):
            M = torch.where(ok, torch.maximum(M, m), M)
        L = torch.zeros_like(M)
        A = torch.zeros_like(parts[0][2])
        for (m, l, a), ok in zip(parts, seen):
            f = torch.exp(m - M)
            L = torch.where(ok, L + l * f, L)
            A = torch.where(ok[..., None], A + a * f[..., None], A)
        return M, L, A

    skipped = 0
    blocks = []
    for c in range(splits):
        mine = range(c, -(-S // chunk), splits)
        brun = torch.zeros_like(vfb, dtype=torch.bool)
        for j in mine:
            brun |= runs(j * chunk, min(S, (j + 1) * chunk))
        wparts = []
        for w in range(warps):
            m = torch.full((B, KV, rep), neg)
            l = torch.zeros((B, KV, rep))
            acc = torch.zeros((B, KV, rep, rows, hd))
            for j in mine:
                t0 = j * chunk + w * tile
                if t0 >= S:
                    continue
                t1 = min(t0 + tile, S)
                run = brun & runs(t0, t1)
                skipped += int((~run).sum())
                s = torch.einsum("bgrh,bgsh->bgrs", qg, k[:, :, t0:t1])
                s = R.softcap(s, cap)
                ok = valid[:, None, None, t0:t1]
                s = torch.where(ok, s, neg)
                m_new = torch.maximum(m, s.amax(-1))
                corr = torch.exp(m - m_new)
                p = torch.where(ok, torch.exp(s - m_new[..., None]), 0.0)
                l_new = l * corr + p.sum(-1)
                acc_new = acc * corr[..., None, None] + torch.stack(
                    [torch.einsum("bgrs,bgsh->bgrh", p[..., g::rows],
                                  v[:, :, t0 + g:t1:rows])
                     for g in range(rows)], -2)
                m = torch.where(run, m_new, m)
                l = torch.where(run, l_new, l)
                acc = torch.where(run[..., None, None], acc_new, acc)
            wparts.append((m, l, sum(acc[..., g, :] for g in range(rows))))
        m, l, acc = fold(wparts)
        blocks.append((torch.where(brun, m, neg), l, acc))
    M, L, A = fold(blocks)
    out = torch.where((M > half)[..., None], A / L.clamp_min(1e-30)[..., None],
                      0.0)
    return out.reshape(B, Hq, hd), skipped


# (blocks a group, warp tile, cache_pos, valid_from, window) at S = 100,
# chunks of 4 warp tiles: cache_pos on a chunk's last slot and on the
# next chunk's first, valid_from on chunk starts, at cache_pos and past
# it (a row with nothing valid), the window's first valid position on a
# chunk start, S no multiple of the chunk, one block, 16 blocks (one
# non-portable cluster), odd sizes.
DECODE_SPLITS = [
    (3, 6, 47, [0, 24, 48], 0),
    (3, 6, 48, [24, 47, 0], 25),
    (2, 4, 79, [0, 33, 64], 16),
    (4, 2, 99, [0, 1, 99], 0),
    (1, 16, 60, [0, 30, 61], 0),
    (16, 1, 90, [0, 40, 91], 0),
    (5, 1, 55, [0, 13, 56], 20),
]


def _decode_split_case(rng, dtype, cache_pos, ring, chunk, Hq=8, KV=2,
                       S=100, hd=32):
    """q (B=3, Hq), k and v (KV, S, hd) with values of dtype, as float32
    numpy arrays (model layout for k and v), and the stored positions:
    linear, or a ring whose second chunk was never written."""
    B = 3
    q, k, v = (np.array(jnp.asarray(rng.normal(size=shape), getattr(
                   jnp, dtype)).astype(jnp.float32))
               for shape in ((B, 1, Hq, hd), (B, S, KV, hd), (B, S, KV, hd)))
    pos = (np.arange(S) + 11) % (S - 3) if ring else np.arange(S)
    pos = np.where(pos <= cache_pos, pos, -1)
    if ring:
        pos[chunk:2 * chunk] = -1
    return q, k, v, pos.astype(np.int32)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("ring", [False, True])
@pytest.mark.parametrize("case", DECODE_SPLITS)
def test_decode_split_arithmetic_matches_jax(case, ring, dtype, rng):
    """The decode kernel's split over blocks and warps, emulated on the
    CPU, against the JAX kernel (Pallas, interpret mode) on the same
    inputs: within 2e-5 in fp32 and, rounded to bf16, 2e-2 in bf16.
    Rows with nothing valid give exact zeros on both sides."""
    splits, tile, cpos, vf, window = case
    q, k, v, pos = _decode_split_case(rng, dtype, cpos, ring, 4 * tile)
    _decode_split_check(q, k, v, pos, cpos, vf, dtype, ring, window,
                        splits=splits, tile=tile)


def _decode_split_check(q, k, v, pos, cpos, vf, dtype, ring, window, **kw):
    """The emulated split (`kw`: its splits, tile and row groups) against
    the JAX kernel on q, k, v and pos of `_decode_split_case`, softcap 30:
    2e-5 in fp32 and, rounded to bf16, 2e-2 in bf16; exact zeros on both
    sides for rows with nothing valid. Returns the emulation's fp32
    output."""
    want = jops.decode_attention(
        *(jnp.asarray(x, getattr(jnp, dtype)) for x in (q, k, v)),
        jnp.asarray(pos), jnp.int32(cpos), jnp.asarray(vf, jnp.int32),
        window=window, softcap=30.0, block_s=16, linear=not ring)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    out, _ = _decode_split_emulated(
        tq[:, 0], tk.transpose(1, 2), tv.transpose(1, 2),
        torch.from_numpy(pos), cpos, torch.tensor(vf), window=window,
        cap=30.0, linear=not ring, **kw)
    got = out.to(getattr(torch, dtype))
    np.testing.assert_allclose(_np(got), _np(want)[:, 0], atol=TOL[dtype],
                               rtol=TOL[dtype])
    for row, x in enumerate(vf):
        if x > cpos:
            assert not got[row].any() and not _np(want)[row].any()
    return out


# The decode kernel's warp tile and row groups (Lanes::TW, Lanes::RW) at
# each dtype and head dim it is instantiated at, and the q heads per kv
# head each case runs (those of stablelm-1.6b, qwen3_moe_235b and
# recurrentgemma_2b).
DECODE_TILES = [("float32", 64, 8, 2), ("float32", 128, 4, 1),
                ("float32", 256, 2, 1), ("bfloat16", 64, 16, 4),
                ("bfloat16", 128, 8, 2), ("bfloat16", 256, 4, 1)]
DECODE_REP = {64: 1, 128: 16, 256: 10}
DECODE_CU = FLASH_CU.with_name("decode_attention.cu")


def _shipped_decode_lanes(dtype, hd):
    """(warps a block, blocks a cluster at most, warp tile, row groups)
    of the decode kernel at this dtype and head dim, worked out by the
    formulas of `Lanes` in the kernel's source."""
    src = DECODE_CU.read_text()
    num = lambda pat: int(re.search(pat, src)[1])
    vecn = num(r"VECN = (\d+) / sizeof\(T\);") // (4 if dtype == "float32"
                                                  else 2)
    cpr = hd // vecn
    lpr = min(cpr, num(r"LPR = CPR < (\d+) \? CPR : \d+;"))
    rw = num(r"RW = (\d+) / LPR;") // lpr
    nr = num(r"NR = (\d+) / NV;") // (cpr // lpr)
    return (num(r"THREADS = (\d+);") // 32, num(r"MAX_SPLITS = (\d+);"),
            rw * nr, rw)


@pytest.mark.parametrize("ring", [False, True])
@pytest.mark.parametrize("edge", [1, 2])
@pytest.mark.parametrize("dtype, hd, tile, rows", DECODE_TILES)
def test_decode_split_shipped_tiles_match_jax(dtype, hd, tile, rows, edge,
                                              ring, rng):
    """The emulated split at the warp tile and row groups the kernel ships
    for each dtype and head dim (read from its source), with the blocks a
    group its launcher takes when the card holds every cluster (as many
    as S has chunks, at most 16), against the JAX kernel. S is three
    chunks and 5 slots; cache_pos on a chunk's last slot (edge 1) or the
    next chunk's first (edge 2, with the window's first valid position on
    a chunk start); valid_from on chunk starts, at cache_pos and past it.
    On a linear cache the skip gives the bits of the full scan."""
    warps, max_splits, shipped_tile, shipped_rows = _shipped_decode_lanes(
        dtype, hd)
    assert (shipped_tile, shipped_rows, warps) == (tile, rows, 4)
    chunk = warps * tile
    S = 3 * chunk + 5
    kw = dict(splits=min(max_splits, -(-S // chunk)), tile=tile, rows=rows)
    e = 2 * chunk
    cpos, vf, window = ((e - 1, [0, chunk, e], 0) if edge == 1 else
                        (e, [chunk, e, 0], chunk + 1))
    rep = DECODE_REP[hd]
    Hq, KV = (2 * rep, 2) if rep < 10 else (rep, 1)
    q, k, v, pos = _decode_split_case(rng, dtype, cpos, ring, chunk, Hq=Hq,
                                      KV=KV, S=S, hd=hd)
    got = _decode_split_check(q, k, v, pos, cpos, vf, dtype, ring, window,
                              **kw)
    if not ring:
        args = (torch.from_numpy(q)[:, 0],
                torch.from_numpy(k).transpose(1, 2),
                torch.from_numpy(v).transpose(1, 2), torch.from_numpy(pos),
                cpos, torch.tensor(vf))
        scan, _ = _decode_split_emulated(*args, window=window, cap=30.0,
                                         linear=False, **kw)
        assert torch.equal(got, scan)


@pytest.mark.parametrize("case", DECODE_SPLITS)
def test_decode_split_linear_skip_bit_identical(case, rng):
    """On a linear cache the emulated split gives the same bits whether it
    skips the blocks and tiles outside [valid_from, cache_pos] or scans
    them: a tile with no valid slot leaves (m, l, acc) as they were, and a
    partial with nothing valid is left out of the folds."""
    splits, tile, cpos, vf, window = case
    q, k, v, pos = _decode_split_case(rng, "float32", cpos, False, 4 * tile)
    args = (torch.from_numpy(q)[:, 0], torch.from_numpy(k).transpose(1, 2),
            torch.from_numpy(v).transpose(1, 2), torch.from_numpy(pos), cpos,
            torch.tensor(vf))
    kw = dict(splits=splits, tile=tile, window=window, cap=30.0)
    skip, n_skipped = _decode_split_emulated(*args, linear=True, **kw)
    scan, none = _decode_split_emulated(*args, linear=False, **kw)
    assert n_skipped > 0 and none == 0
    assert torch.equal(skip, scan)


def test_decode_wrapper_limits():
    """The wrapper takes head_dim up to 256 and up to 16 q heads per kv
    head (the reference configs: hd 64-256, rep 1-16) and refuses more,
    before any launch."""
    pos = torch.empty(8, dtype=torch.int32, device="meta")
    for Hq, KV, hd in ((32, 32, 64), (32, 4, 128), (16, 8, 256),
                       (64, 4, 128), (10, 1, 256), (3, 3, 20)):
        q = torch.empty(1, Hq, hd, device="meta")
        kv = torch.empty(1, KV, 8, hd, device="meta")
        decode_check(q, kv, kv, pos)
    q = torch.empty(1, 4, 257, device="meta")
    kv = torch.empty(1, 2, 8, 257, device="meta")
    with pytest.raises(ValueError, match="head_dim 257 > 256"):
        decode_check(q, kv, kv, pos)
    q = torch.empty(1, 17, 64, device="meta")
    kv = torch.empty(1, 1, 8, 64, device="meta")
    with pytest.raises(ValueError, match="17 q heads per kv head > 16"):
        decode_check(q, kv, kv, pos)


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


def test_replay_counts_add_to_launch_counts():
    """A graph replay runs its kernels without calling the wrappers:
    count_replay adds the launches it recorded, which launch_counts and
    int8_prefill_launches include and replayed_counts reports apart."""
    ops.reset_launch_counts()
    graph = {"flash_attention": 0, "decode_attention": 2, "int8_matmul": 14,
             "int8_matmul_prefill": 0}
    ops.count_replay(graph)
    ops.count_replay(graph)
    assert ops.replayed_counts() == {n: 2 * c for n, c in graph.items()}
    assert ops.launch_counts() == {"flash_attention": 0,
                                   "decode_attention": 4, "int8_matmul": 28}
    assert ops.int8_prefill_launches() == 0
    ops.reset_launch_counts()
    assert set(ops.replayed_counts().values()) == {0}
    assert set(ops.launch_counts().values()) == {0}
