"""Assigned input shapes and per-(arch x shape) abstract input specs.

Shapes (assignment):
  train_4k     seq=4096   global_batch=256   (training step)
  prefill_32k  seq=32768  global_batch=32    (inference prefill)
  decode_32k   seq=32768  global_batch=128   (one decode token, 32k KV)
  long_500k    seq=524288 global_batch=1     (long-context decode; only
               sub-quadratic archs — SSM/hybrid — run it)
"""

from __future__ import annotations

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.utils import dtype_of

SHAPE_DEFS = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1),
}

SHAPE_NAMES = tuple(SHAPE_DEFS)


def cell_runnable(cfg: ModelConfig, shape_name: str) -> bool:
    """long_500k requires a sub-quadratic arch (no full-attention blocks)."""
    if shape_name == "long_500k":
        return cfg.is_subquadratic
    return True


def skip_reason(cfg: ModelConfig, shape_name: str) -> str:
    return (f"{cfg.name} contains full (unwindowed) attention layers; "
            f"long_500k requires sub-quadratic context handling "
            f"(DESIGN.md long_500k skips)")


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape_name: str) -> dict:
    """Meta-tensor stand-ins (shape and dtype, no storage) for every
    model input of this cell.

    Modality frontends ([audio]/[vlm]) are stubs: inputs are precomputed
    frame/patch embeddings (B, T, d_model) instead of int tokens.
    """
    d = SHAPE_DEFS[shape_name]
    B, S = d["batch"], d["seq"]
    cdt = dtype_of(cfg.compute_dtype)
    tok = torch.int32
    if d["kind"] == "train":
        if cfg.input_mode == "embeddings":
            inputs = _meta((B, S, cfg.d_model), cdt)
        else:
            inputs = _meta((B, S), tok)
        return {"kind": "train",
                "batch": {"inputs": inputs, "labels": _meta((B, S), tok)}}
    if d["kind"] == "prefill":
        if cfg.input_mode == "embeddings":
            inputs = _meta((B, S, cfg.d_model), cdt)
        else:
            inputs = _meta((B, S), tok)
        return {"kind": "prefill", "inputs": inputs, "max_seq": S}
    # decode: one new token with a KV cache of S.
    if cfg.input_mode == "embeddings":
        token = _meta((B, 1, cfg.d_model), cdt)
    else:
        token = _meta((B, 1), tok)
    return {"kind": "decode", "token": token, "batch": B, "max_seq": S,
            "cache_pos": _meta((), torch.int32)}
