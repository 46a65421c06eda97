"""Decoder LM for attention-only block patterns, on torch tensors.

A model is `n_layers` blocks produced by cycling `cfg.pattern`; layers
are grouped as in the reference (one group = one pass through the
pattern, `n_layers % len(pattern)` tail layers). The reference's
`lax.scan` over stacked groups becomes a Python loop that indexes the
stacked leaves: `params["blocks"][i][key][g]` is a view, no copy.

Entry points:
  forward(params, inputs, cfg)                      -> (logits, extras)
  forward(..., cache=init_cache(...), positions)    -> prefill: fills cache
  decode_step(params, token, cache, cache_pos, cfg) -> (logits, cache)

Caches are updated in place: `forward` returns the cache it was given.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.models import params as pmod
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import attn_block, rms_norm, softcap
from repro_torch.utils import dtype_of, resolve_device

init_params = pmod.init_params

_NOT_PORTED = ("moe", "rglru", "ssd")


def _check_kinds(cfg: ModelConfig):
    bad = sorted(set(cfg.pattern) & set(_NOT_PORTED))
    if bad:
        raise NotImplementedError(
            f"block kinds {bad} are not ported yet (MoE / RG-LRU / SSD "
            f"belong to a later slice of the port)")


# --------------------------------------------------------------------------
# Cache construction
# --------------------------------------------------------------------------

def _block_cache(cfg: ModelConfig, kind: str, B: int, max_seq: int,
                 lead: tuple, device):
    S = min(cfg.window, max_seq) if kind == "local" and cfg.window \
        else max_seq
    KV, hd = cfg.n_kv_heads, cfg.head_dim
    dt = dtype_of(cfg.compute_dtype)
    return {
        "k": torch.zeros(lead + (B, S, KV, hd), dtype=dt, device=device),
        "v": torch.zeros(lead + (B, S, KV, hd), dtype=dt, device=device),
        "pos": torch.full(lead + (S,), -1, dtype=torch.int32, device=device),
    }


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, device="cuda"):
    """{"blocks": (stacked per pattern kind,), "tail": (...,)} of k/v
    buffers (zeros) and stored positions (-1 = unwritten)."""
    _check_kinds(cfg)
    device = resolve_device(device)
    G = cfg.n_groups_scan
    return {
        "blocks": tuple(_block_cache(cfg, kind, batch, max_seq, (G,), device)
                        for kind in cfg.pattern),
        "tail": tuple(_block_cache(cfg, kind, batch, max_seq, (), device)
                      for kind in cfg.tail_kinds),
    }


# --------------------------------------------------------------------------
# Forward / decode
# --------------------------------------------------------------------------

def _index(tree, g: int):
    """One group's slice of a stacked tree (views)."""
    if isinstance(tree, dict):
        return {k: _index(v, g) for k, v in tree.items()}
    return tree[g]


def forward(params, inputs, cfg: ModelConfig, *, cache=None,
            cache_pos: Optional[int] = None, positions=None,
            logits_last_only: bool = False, valid_from=None):
    """inputs: (B,T) int tokens or (B,T,d) embeddings.

    cache=None: plain forward. cache given & T>1: prefill (fills cache in
    place). logits_last_only: unembed only the final position (serving
    prefill — avoids materializing the (B,S,V) logits tensor).
    cache_pos: the decode step's position as a Python int.
    valid_from: optional (B,) int32 per-row first attendable position.
    Returns (logits, {"cache": cache})."""
    _check_kinds(cfg)
    compute_dtype = dtype_of(cfg.compute_dtype)
    if cfg.input_mode == "embeddings":
        x = inputs.to(compute_dtype)
    else:
        x = params["embed"][inputs.long()].to(compute_dtype)
    if cfg.embed_scale:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=compute_dtype,
                         device=x.device)
    T = x.shape[1]
    if positions is None:
        positions = torch.arange(T, dtype=torch.int32, device=x.device)
    if cache_pos is None:
        cache_pos = 0

    for g in range(cfg.n_groups_scan):
        for i, kind in enumerate(cfg.pattern):
            c = None if cache is None else _index(cache["blocks"][i], g)
            x, _ = attn_block(_index(params["blocks"][i], g), x, cfg, kind,
                              positions, c, cache_pos, valid_from)
    for i, kind in enumerate(cfg.tail_kinds):
        c = None if cache is None else cache["tail"][i]
        x, _ = attn_block(params["tail"][i], x, cfg, kind, positions, c,
                          cache_pos, valid_from)

    if logits_last_only:
        x = x[:, -1:]
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = torch.einsum("btd,vd->btv", x, params["embed"].to(x.dtype))
    else:
        logits = torch.einsum("btd,dv->btv", x,
                              params["lm_head"].to(x.dtype))
    logits = softcap(logits.float(), cfg.final_softcap)
    return logits, {"cache": cache}


def decode_step(params, token, cache, cache_pos: int, cfg: ModelConfig, *,
                valid_from=None):
    """One decode step. token: (B,1) int (or (B,1,d) embeddings);
    cache_pos: Python int = number of tokens already in context.
    valid_from: optional (B,) per-row first attendable cache position.
    Returns (logits (B,1,V), cache)."""
    cache_pos = int(cache_pos)
    positions = torch.full((1,), cache_pos, dtype=torch.int32,
                           device=token.device)
    logits, extras = forward(params, token, cfg, cache=cache,
                             cache_pos=cache_pos, positions=positions,
                             valid_from=valid_from)
    return logits, extras["cache"]


def prefill(params, inputs, cfg: ModelConfig, max_seq: int, *,
            logits_last_only: bool = False, valid_from=None):
    """Full-sequence prefill: returns (logits, cache ready for decoding).

    valid_from: optional (B,) int32 — with left-padded prompts, row b's
    real tokens start at position valid_from[b]; padding slots are masked
    out of every attention so they cannot contaminate logits or the KV
    cache reads of later decode steps."""
    B, T = inputs.shape[0], inputs.shape[1]
    cache = init_cache(cfg, B, max_seq, device=inputs.device)
    logits, extras = forward(
        params, inputs, cfg, cache=cache,
        positions=torch.arange(T, dtype=torch.int32, device=inputs.device),
        logits_last_only=logits_last_only, valid_from=valid_from)
    return logits, extras["cache"]
