"""One-token decode attention: wrapper of the CUDA kernel
`csrc/decode_attention.cu` (the port of the TPU kernel
`repro/kernels/decode_attention.py`).

Flash decoding: the blocks of one (batch row, KV group) are one
thread-block cluster; the cache axis is cut into chunks, block c of the
cluster takes chunks c, c + splits, ..., and the blocks fold their
partials in rank order inside the same launch. The launcher picks the
split from the shapes and the card, never from `cache_pos` or
`valid_from` (`decode_plan` reports it). K and V stream through a
per-warp `cp.async` ring of 16-byte copies (element loads for rows that
are not 16-byte aligned) and are read once for all query heads of their
group. `cache_pos` is one int32 on the device, which the kernel loads
as the TPU kernel loads its scalar-prefetch `cpos_ref`, so a captured
call serves every position. Any head_dim up to `MAX_HEAD_DIM` and any
`Hq / KV` up to `MAX_REP`. Two calls give the same bits, and the linear
skip gives the bits of the full scan.

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
# The arguments of decode_attention_fwd and of decode_attention_plan.
_ARGTYPES = {
    "decode_attention_fwd": [_C.c_void_p] * 6 + [_C.c_int] * 5
    + [_C.c_longlong] * 8 + [_C.c_void_p] + [_C.c_float] * 2
    + [_C.c_int] * 3 + [_C.c_void_p],
    "decode_attention_plan": [_C.c_void_p] * 2 + [_C.c_int] * 5
    + [_C.c_longlong] * 6 + [_C.c_int, _C.c_void_p],
}
MAX_HEAD_DIM = 256
MAX_REP = 16
_PLAN_KEYS = ("splits", "chunk", "warp_tile", "vec", "resident_clusters",
              "smem_bytes")


@functools.cache
def _fn(name="decode_attention_fwd"):
    fn = getattr(_build.load("decode_attention"), name)
    fn.argtypes = _ARGTYPES[name]
    fn.restype = _C.c_int
    return fn


def _on_cuda(**tensors):
    for name, t in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"decode_attention kernel needs CUDA tensors; "
                             f"{name} is on {t.device}")


def _check_shapes(q, k, v):
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
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"head_dim {hd} > {MAX_HEAD_DIM} is not supported")
    if Hq // k.shape[1] > MAX_REP:
        raise ValueError(f"{Hq // k.shape[1]} q heads per kv head > "
                         f"{MAX_REP} is not supported")


def _check_args(q, k, v, pos):
    _check_shapes(q, k, v)
    if pos.shape != (k.shape[2],):
        raise ValueError(f"pos must be (S,) = ({k.shape[2]},), got "
                         f"{tuple(pos.shape)}")


def _last_axis_contiguous(*ts):
    return tuple(t if t.stride(-1) == 1 else t.contiguous() for t in ts)


def _device_cache_pos(cache_pos, device):
    """The one int32 on the device that the kernel reads cache_pos from:
    a 0-d or 1-element int32 tensor on `device` as it is (no copy), an
    int as a new one (a fill on the device, no copy from the host)."""
    if not isinstance(cache_pos, torch.Tensor):
        return torch.full((1,), int(cache_pos), dtype=torch.int32,
                          device=device)
    if (cache_pos.dtype != torch.int32 or cache_pos.numel() != 1
            or cache_pos.device != device):
        raise ValueError(f"cache_pos must be an int or one int32 on "
                         f"{device}, got {cache_pos.dtype} "
                         f"{tuple(cache_pos.shape)} on {cache_pos.device}")
    return cache_pos


def decode_attention(q, k, v, pos, cache_pos, valid_from=None, *,
                     window: int = 0, softcap: float = 0.0,
                     scale: float | None = None, linear: bool = False):
    """q: (B, Hq, hd); k, v: (B, KV, S, hd), any strides with a contiguous
    last axis; pos: (S,) int stored positions (-1 = unwritten);
    cache_pos: the current position, an int or a 0-d / 1-element int32
    tensor on q's device, which the kernel reads when it runs (so a
    captured call serves whatever the tensor then holds).
    valid_from: optional (B,) first attendable stored position per row
    (None == zeros == unmasked). linear: slot index == stored position,
    which lets the kernel skip the slots outside [valid_from, cache_pos].
    Returns (B, Hq, hd)."""
    _on_cuda(q=q, k=k, v=v, pos=pos)
    _check_args(q, k, v, pos)
    cpos = _device_cache_pos(cache_pos, q.device)
    q, k, v = _last_axis_contiguous(q, k, v)
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
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(),
            vf.data_ptr(), out.data_ptr(), B, S, Hq, KV, hd,
            q.stride(0), q.stride(1),
            k.stride(0), k.stride(2), k.stride(1),
            v.stride(0), v.stride(2), v.stride(1),
            cpos.data_ptr(), float(scale), float(softcap), int(window),
            int(bool(linear)), _DTYPES[q.dtype])
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _fn()(*args, stream)
    _build.check(err, "decode_attention")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0


def decode_plan(q, k, v) -> dict:
    """The split plan that `decode_attention` launches on q, k and v (as
    it takes them) on the current CUDA device, as its launcher works it
    out: blocks a (batch row, KV group), which are one cluster
    (`splits`); slots a chunk of the cache axis (block c takes chunks c,
    c + splits, ...); slots a warp tile; 16-byte loads or not; clusters
    the device holds at once; shared memory a block. It reads only
    shapes, dtype, strides and the K/V pointers (their alignment), so it
    is the same at every cache_pos, valid_from and layout. Launches
    nothing."""
    _on_cuda(q=q, k=k, v=v)
    _check_shapes(q, k, v)
    k, v = _last_axis_contiguous(k, v)
    B, Hq, hd = q.shape
    KV, S = k.shape[1], k.shape[2]
    out = (_C.c_int * len(_PLAN_KEYS))()
    err = _fn("decode_attention_plan")(
        k.data_ptr(), v.data_ptr(), B, S, Hq, KV, hd,
        k.stride(0), k.stride(2), k.stride(1),
        v.stride(0), v.stride(2), v.stride(1),
        _DTYPES[q.dtype], _C.cast(out, _C.c_void_p))
    _build.check(err, "decode_attention_plan")
    plan = dict(zip(_PLAN_KEYS, out))
    plan["vec"] = bool(plan["vec"])
    return plan
