"""int8 weight quantization for serving: symmetric, per output channel.

Projection weights stay resident as {"q" int8, "scale" f32} leaves (no
dequantized copy) and `models.layers._proj` sends them to the int8
matmul kernel. `torch.round` and the reference's `jnp.round` both round
half to even, so `q` and the scales equal the reference's exactly."""

from __future__ import annotations

import torch

from repro_torch.models.params import tree_leaves

# Projection leaves the int8 matmul kernel can consume, with the number
# of trailing *output* axes per key (everything before them — minus a
# leading scan-stack axis — contracts): qkv map d -> (H, hd); wo maps
# (H, hd) -> d; the MLP matmuls are plain 2D.
PROJ_OUT_AXES = {"wq": 2, "wk": 2, "wv": 2, "wo": 1,
                 "w_up": 1, "w_gate": 1, "w_down": 1}


def _quantize_matmul(w, out_axes: int, stacked: bool):
    """Matmul-layout int8: one fp32 scale per output channel (the
    trailing `out_axes` axes), amax over the contraction axes — the
    layout `kernels.int8_matmul` needs after flattening to (K, N)."""
    red = tuple(range(1 if stacked else 0, w.ndim - out_axes))
    xf = w.float()
    amax = torch.amax(torch.abs(xf), dim=red, keepdim=True)
    scale = torch.clamp(amax, min=1e-8) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return {"q": q, "scale": scale}


def quantize_exec_tree(params):
    """Execution-layout quantization for the serving fast path: every
    projection matmul weight becomes a {"q" int8, "scale" f32} dict leaf
    that stays resident and is dispatched to the int8 matmul kernel by
    `models.layers._proj`. Embeddings and norms stay as they are (and are
    shared with the input tree, not copied). Works on the model's
    {"blocks": stacked, "tail": unstacked} param tree and leaves it
    otherwise structurally identical."""
    def walk(d, stacked):
        out = {}
        for key, val in d.items():
            if key in PROJ_OUT_AXES and isinstance(val, torch.Tensor):
                out[key] = _quantize_matmul(val, PROJ_OUT_AXES[key], stacked)
            elif isinstance(val, dict):
                out[key] = walk(val, stacked)
            else:
                out[key] = val
        return out

    out = dict(params)
    out["blocks"] = tuple(walk(b, True) for b in params["blocks"])
    out["tail"] = tuple(walk(b, False) for b in params["tail"])
    return out


def tree_bytes_quantized(tree) -> int:
    """Bytes of every leaf (int8 leaves at one byte per weight)."""
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))
