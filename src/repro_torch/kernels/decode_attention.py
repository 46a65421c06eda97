"""One-token decode attention: wrapper of the CUDA kernel
`csrc/decode_attention.cu` (the port of the TPU kernel
`repro/kernels/decode_attention.py`).

This wrapper only launches the kernel: it takes CUDA tensors and raises
on anything else. The plain version is `kernels.ref.decode_attention_ref`;
`kernels.ops` sends CPU tensors there.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_C = ctypes
_ARGTYPES = ([_C.c_void_p] * 6 + [_C.c_int] * 5 + [_C.c_longlong] * 8
             + [_C.c_int] + [_C.c_float] * 2 + [_C.c_int] * 3
             + [_C.c_void_p])


@functools.cache
def _fn():
    fn = _build.load("decode_attention").decode_attention_fwd
    fn.argtypes = _ARGTYPES
    fn.restype = _C.c_int
    return fn


def _check_args(q, k, v, pos):
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"decode_attention takes float32 or bfloat16 q/k/v "
                        f"of one dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    B, Hq, hd = q.shape
    if k.shape[0] != B or k.shape[3] != hd or v.shape != k.shape:
        raise ValueError(f"shape mismatch q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)}")
    if Hq % k.shape[1]:
        raise ValueError(f"q heads {Hq} not a multiple of kv heads "
                         f"{k.shape[1]}")
    if pos.shape != (k.shape[2],):
        raise ValueError(f"pos must be (S,) = ({k.shape[2]},), got "
                         f"{tuple(pos.shape)}")


def decode_attention(q, k, v, pos, cache_pos: int, valid_from=None, *,
                     window: int = 0, softcap: float = 0.0,
                     scale: float | None = None, linear: bool = False):
    """q: (B, Hq, hd); k, v: (B, KV, S, hd), any strides with a contiguous
    last axis; pos: (S,) int stored positions (-1 = unwritten);
    cache_pos: the current position, a Python int (no device read-back).
    valid_from: optional (B,) first attendable stored position per row
    (None == zeros == unmasked). linear: slot index == stored position,
    which enables the tile skip. Returns (B, Hq, hd)."""
    for name, t in (("q", q), ("k", k), ("v", v), ("pos", pos)):
        if t.device.type != "cuda":
            raise ValueError(f"decode_attention kernel needs CUDA tensors; "
                             f"{name} is on {t.device}")
    _check_args(q, k, v, pos)
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    B, Hq, hd = q.shape
    KV, S = k.shape[1], k.shape[2]
    scale = hd ** -0.5 if scale is None else scale
    pos = pos.to(torch.int32).contiguous()
    if valid_from is None:
        vf = torch.zeros((B,), dtype=torch.int32, device=q.device)
    else:
        vf = valid_from.to(device=q.device, dtype=torch.int32).reshape(B)
        vf = vf.contiguous()
    out = torch.empty((B, Hq, hd), dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(),
                vf.data_ptr(), out.data_ptr(), B, S, Hq, KV, hd,
                q.stride(0), q.stride(1),
                k.stride(0), k.stride(2), k.stride(1),
                v.stride(0), v.stride(2), v.stride(1),
                int(cache_pos), float(scale), float(softcap), int(window),
                int(bool(linear)), _DTYPES[q.dtype], stream)
    _build.check(err, "decode_attention")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
