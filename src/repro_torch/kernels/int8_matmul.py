"""Weight-only int8 matmul: wrapper of the CUDA kernel
`csrc/int8_matmul.cu` (the port of the TPU kernel
`repro/kernels/int8_matmul.py`).

This wrapper only launches the kernel: it takes CUDA tensors and raises
on anything else. The plain version is `kernels.ref.int8_matmul_ref`;
`kernels.ops` sends CPU tensors there.
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
    return out


int8_matmul.launches = 0
