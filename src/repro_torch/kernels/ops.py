"""Model-layout entry points of the kernels, used when
`cfg.attn_impl == "cuda"` and for every int8 projection.

Each entry point runs the CUDA kernel on a CUDA tensor and the plain
version from `kernels.ref` on a CPU tensor. There is no fallback: a
CUDA tensor either launches its kernel or raises. The kernels have no
backward (nor have the reference's Pallas kernels), so every entry point
raises when autograd would have to differentiate it, on either device,
rather than return a result cut off from the graph. The kernels read the
model layout (B, T, H, hd) through strides and mask ragged lengths
themselves, so nothing here transposes into a copy or pads."""

from __future__ import annotations

import torch

from repro_torch.kernels import ref as R
from repro_torch.kernels.decode_attention import decode_attention as _decode
from repro_torch.kernels.flash_attention import flash_attention as _flash
from repro_torch.kernels.int8_matmul import int8_matmul as _int8mm

KERNELS = {"flash_attention": _flash, "decode_attention": _decode,
           "int8_matmul": _int8mm}
# Every launch counter: (wrapper, attribute). int8_matmul_prefill counts
# the int8 launches of the M > 8 path.
_COUNTERS = {**{name: (fn, "launches") for name, fn in KERNELS.items()},
             "int8_matmul_prefill": (_int8mm, "prefill_launches")}
# A replayed CUDA graph runs its kernels without calling their wrappers:
# the launches of replays, added by count_replay.
_replayed = dict.fromkeys(_COUNTERS, 0)


def _raw_counts() -> dict:
    return {name: getattr(fn, attr) for name, (fn, attr) in _COUNTERS.items()}


def launch_counts() -> dict:
    """{kernel name: launches since the last reset}, those of graph
    replays included."""
    raw = _raw_counts()
    return {name: raw[name] + _replayed[name] for name in KERNELS}


def int8_prefill_launches() -> int:
    """Launches of int8_matmul's M > 8 path since the last reset, those
    of graph replays included."""
    return _int8mm.prefill_launches + _replayed["int8_matmul_prefill"]


def replayed_counts() -> dict:
    """{counter: launches of graph replays since the last reset}, the
    M > 8 path's int8_matmul_prefill included: the part of the counts
    that no eager call made."""
    return dict(_replayed)


def reset_launch_counts() -> None:
    for fn, attr in _COUNTERS.values():
        setattr(fn, attr, 0)
    for name in _replayed:
        _replayed[name] = 0


def capture_launches(capture):
    """Run capture(), which records kernels into a CUDA graph without
    running them, and return (its result, {counter: launches recorded}).
    The recorded launches are taken back off the counters: they count
    when a replay runs them (count_replay)."""
    before = _raw_counts()
    out = capture()
    after = _raw_counts()
    for name, (fn, attr) in _COUNTERS.items():
        setattr(fn, attr, before[name])
    return out, {name: after[name] - before[name] for name in _COUNTERS}


def count_replay(launches: dict) -> None:
    """Count one replay of a graph that records `launches`."""
    for name, n in launches.items():
        _replayed[name] += n


def _on_cpu(*tensors) -> bool:
    devs = {t.device.type for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"operands on mixed devices: {sorted(devs)}")
    return devs == {"cpu"}


def _no_backward(name, *tensors):
    """Raise where autograd would need the kernel's backward."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} has no backward, and an input requires grad: train "
            f"with attn_impl 'naive', 'chunked' or 'auto' and float "
            f"weights, or call it under torch.no_grad()")


def flash_attention_btHd(q, k, v, valid_from=None, *, window=0, softcap=0.0,
                         scale=None):
    """Model-layout prefill attention: q (B,T,H,hd), k/v (B,S,KV,hd) ->
    (B,T,H,hd). valid_from: optional (B,) first attendable key index
    (0-based, on the same axis as the implicit positions)."""
    _no_backward("flash_attention", q, k, v)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    if _on_cpu(q, k, v):
        out = R.flash_attention_ref(qt, kt, vt, window=window, cap=softcap,
                                    scale=scale, valid_from=valid_from)
    else:
        out = _flash(qt, kt, vt, valid_from, window=window, softcap=softcap,
                     scale=scale)
    return out.transpose(1, 2)


def flash_attention(q, k, v, pos_q, pos_k, valid_from=None, *, window=0,
                    softcap=0.0, scale=None):
    """Entry point matching `models.layers.attention`'s signature
    (prefill path: pos_q == pos_k, contiguous). The kernel's positions
    are implicit 0-based indices; `valid_from` is absolute (engine
    coordinates), so shift it by the window start: prefill_row runs at
    offset..offset+T-1, and causal/window masking is shift-invariant,
    but valid_from is not."""
    if valid_from is not None:
        valid_from = valid_from - pos_k[0]
    return flash_attention_btHd(q, k, v, valid_from, window=window,
                                softcap=softcap, scale=scale)


def decode_attention(q, k, v, pos, cache_pos, valid_from=None, *,
                     window=0, softcap=0.0, scale=None, linear=False):
    """q: (B,1,H,hd) or (B,H,hd); k/v: (B,S,KV,hd) model layout; pos:
    (S,) stored positions, -1 for a slot never written (masked).
    cache_pos: an int or a 0-d int32 tensor on q's device (read by the
    kernel, never by the host). valid_from: optional (B,) first attendable
    stored position; linear declares slot == position (full-seq caches),
    enabling the tile skip."""
    _no_backward("decode_attention", q, k, v)
    squeeze = q.ndim == 4
    if squeeze:
        q = q[:, 0]
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)
    if _on_cpu(q, k, v, pos):
        out = R.decode_attention_ref(q, kt, vt, pos, cache_pos, cap=softcap,
                                     scale=scale, window=window,
                                     valid_from=valid_from)
    else:
        out = _decode(q, kt, vt, pos, cache_pos, valid_from, window=window,
                      softcap=softcap, scale=scale, linear=linear)
    return out[:, None] if squeeze else out


def int8_matmul(x, w_q, w_scale):
    """x: (M, K) float; w_q: (K, N) int8; w_scale: (N,) f32 -> (M, N)."""
    _no_backward("int8_matmul", x, w_q, w_scale)
    if _on_cpu(x, w_q, w_scale):
        return R.int8_matmul_ref(x, w_q, w_scale)
    return _int8mm(x, w_q, w_scale)
