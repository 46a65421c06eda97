"""Causal prefill attention: wrapper of the CUDA kernel
`csrc/flash_attention.cu` (the port of the TPU kernel
`repro/kernels/flash_attention.py`).

Both products run on the tensor cores through `mma.sync`: 3xTF32 for
fp32 inputs (hi and lo tf32 parts of q * scale, k, p and v, three
products each); bf16 mma for bf16 inputs (one pass for Q K^T, two for
P V, whose fp32 p is split into bf16 hi and lo parts). Key and value
tiles come through a `cp.async` ring. Any head_dim up to
`MAX_HEAD_DIM`. Rows that are not 16-byte aligned take an element-load
variant. No atomics: two calls give the same bits.

This wrapper only launches the kernel: it takes CUDA tensors and raises
on anything else. The plain version is `kernels.ref.flash_attention_ref`;
`kernels.ops` sends CPU tensors there.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_C = ctypes
_ARGTYPES = ([_C.c_void_p] * 5 + [_C.c_int] * 6 + [_C.c_longlong] * 9
             + [_C.c_float] * 2 + [_C.c_int] * 2 + [_C.c_void_p])
MAX_HEAD_DIM = 256


@functools.cache
def _fn():
    lib = _build.load("flash_attention")
    fn = lib.flash_attention_fwd
    fn.argtypes = _ARGTYPES
    fn.restype = _C.c_int
    return fn


def _check_args(q, k, v):
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes float32 or bfloat16 q/k/v "
                        f"of one dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    B, Hq, T, hd = q.shape
    if k.shape[0] != B or k.shape[3] != hd or v.shape != k.shape:
        raise ValueError(f"shape mismatch q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)}")
    if Hq % k.shape[1]:
        raise ValueError(f"q heads {Hq} not a multiple of kv heads "
                         f"{k.shape[1]}")
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"head_dim {hd} > {MAX_HEAD_DIM} is not supported")


def flash_attention(q, k, v, valid_from=None, *, window: int = 0,
                    softcap: float = 0.0, scale: float | None = None):
    """Always causal. q: (B, Hq, T, hd); k, v: (B, KV, S, hd), any strides with a
    contiguous last axis (a transposed view of the model layout costs no
    copy) -> (B, Hq, T, hd), a view of a contiguous (B, T, Hq, hd) buffer.

    valid_from: optional (B,) int — per row, the first key index that may
    be attended, on the kernel's 0-based axis. None == zeros == unmasked
    (bit-identical: the masking terms are value-level no-ops)."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda":
            raise ValueError(f"flash_attention kernel needs CUDA tensors; "
                             f"{name} is on {t.device}")
    _check_args(q, k, v)
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    B, Hq, T, hd = q.shape
    KV, S = k.shape[1], k.shape[2]
    scale = hd ** -0.5 if scale is None else scale
    if valid_from is None:
        vf = torch.zeros((B,), dtype=torch.int32, device=q.device)
    else:
        vf = valid_from.to(device=q.device, dtype=torch.int32).reshape(B)
        vf = vf.contiguous()
    out = torch.empty((B, T, Hq, hd), dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                vf.data_ptr(), B, T, S, Hq, KV, hd,
                q.stride(0), q.stride(2), q.stride(1),
                k.stride(0), k.stride(2), k.stride(1),
                v.stride(0), v.stride(2), v.stride(1),
                float(scale), float(softcap), int(window), _DTYPES[q.dtype],
                stream)
    _build.check(err, "flash_attention")
    flash_attention.launches += 1
    return out.transpose(1, 2)


flash_attention.launches = 0
