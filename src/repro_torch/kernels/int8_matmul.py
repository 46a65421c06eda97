"""Weight-only int8 matmul: wrapper of the CUDA kernel
`csrc/int8_matmul.cu` (the port of the TPU kernel
`repro/kernels/int8_matmul.py`).

Two paths behind one launch. M > 8 (prefill) runs on the tensor cores:
bf16 `mma.sync` tiles with fp32 sums, the int8 weights converted to
bf16 exactly and fp32 x split into two bf16 parts, fed by a `cp.async`
ring; the kernel's launcher picks the tile (`prefill_plan` reports it).
M <= 8 (decode) streams the weights split over column tiles and K
slices; the launcher sizes that grid from the card's SM count
(`small_m_plan` reports it), and the K slices of a column tile, one
thread-block cluster, add their sums in a fixed order inside the same
launch. Every call is one launch, and two calls on the same inputs give
the same bits.

This wrapper only launches the kernel: it takes CUDA tensors and raises
on anything else. The plain version is `kernels.ref.int8_matmul_ref`;
`kernels.ops` sends CPU tensors there. `int8_matmul.launches` counts
every launch, `int8_matmul.prefill_launches` those with M > 8.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_C = ctypes
_ARGTYPES = ([_C.c_void_p] * 4 + [_C.c_int] * 3 + [_C.c_longlong, _C.c_int,
                                                   _C.c_void_p])


@functools.cache
def _fn():
    fn = _build.load("int8_matmul").int8_matmul_fwd
    fn.argtypes = _ARGTYPES
    fn.restype = _C.c_int
    return fn


@functools.cache
def _small_m_rows() -> int:
    fn = _build.load("int8_matmul").int8_matmul_small_m_rows
    fn.argtypes = []
    fn.restype = _C.c_int
    return fn()


def prefill_plan(x, w_q) -> dict:
    """The prefill path's variant for these operands (M > 8), as the
    kernel's launcher picks it: block rows and columns of its tile, and
    whether its stages load by 16-byte copies."""
    fn = _build.load("int8_matmul").int8_matmul_prefill_plan
    fn.argtypes = [_C.c_void_p, _C.c_void_p, _C.c_int, _C.c_int,
                   _C.c_longlong, _C.c_int, _C.POINTER(_C.c_int)]
    fn.restype = _C.c_int
    out = (_C.c_int * 3)()
    _build.check(fn(x.data_ptr(), w_q.data_ptr(), x.shape[0], w_q.shape[1],
                    x.stride(0), _DTYPES[x.dtype], out),
                 "int8_matmul_prefill_plan")
    return {"bm": out[0], "bn": out[1], "vec": bool(out[2])}


def small_m_plan(N: int, K: int) -> dict:
    """The decode path's grid for an (K, N) weight on the current CUDA
    device, as the kernel's launcher works it out: column tiles, K slices
    (one cluster a tile), rows of K per slice, and the clusters the card
    runs at once."""
    fn = _build.load("int8_matmul").int8_matmul_small_m_plan
    fn.argtypes = [_C.c_int, _C.c_int, _C.POINTER(_C.c_int)]
    fn.restype = _C.c_int
    out = (_C.c_int * 4)()
    _build.check(fn(N, K, out), "int8_matmul_small_m_plan")
    return dict(zip(("tiles", "splits", "k_split", "resident_clusters"),
                    out))


def _check_args(x, w_q, w_scale):
    if x.dtype not in _DTYPES:
        raise TypeError(f"int8_matmul takes float32 or bfloat16 x, got "
                        f"{x.dtype}")
    if w_q.dtype != torch.int8:
        raise TypeError(f"int8_matmul takes int8 weights, got {w_q.dtype}")
    if x.ndim != 2 or w_q.ndim != 2 or x.shape[1] != w_q.shape[0]:
        raise ValueError(f"shape mismatch x {tuple(x.shape)} w "
                         f"{tuple(w_q.shape)}")
    if w_scale.numel() != w_q.shape[1]:
        raise ValueError(f"scale has {w_scale.numel()} entries for "
                         f"{w_q.shape[1]} output channels")


def int8_matmul(x, w_q, w_scale):
    """x: (M, K) float32/bfloat16 (rows may be strided, last axis
    contiguous); w_q: (K, N) int8; w_scale: (N,) or (1, N) float32
    -> (M, N) in x's dtype. The scale is applied after the fp32 sum."""
    for name, t in (("x", x), ("w_q", w_q), ("w_scale", w_scale)):
        if t.device.type != "cuda":
            raise ValueError(f"int8_matmul kernel needs CUDA tensors; "
                             f"{name} is on {t.device}")
    _check_args(x, w_q, w_scale)
    if x.stride(-1) != 1:
        x = x.contiguous()
    w_q = w_q.contiguous()
    scale = w_scale.to(torch.float32).reshape(-1).contiguous()
    M, K = x.shape
    N = w_q.shape[1]
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _fn()(x.data_ptr(), w_q.data_ptr(), scale.data_ptr(),
                out.data_ptr(), M, N, K, x.stride(0), _DTYPES[x.dtype],
                stream)
    _build.check(err, "int8_matmul")
    int8_matmul.launches += 1
    if M > _small_m_rows():
        int8_matmul.prefill_launches += 1
    return out


int8_matmul.launches = 0
int8_matmul.prefill_launches = 0
