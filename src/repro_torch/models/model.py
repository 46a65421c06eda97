"""Decoder LM for attention-only, recurrent (RG-LRU, SSD) and MoE block
patterns, on torch tensors.

A model is `n_layers` blocks produced by cycling `cfg.pattern`; layers
are grouped as in the reference (one group = one pass through the
pattern, `n_layers % len(pattern)` tail layers). The reference's
`lax.scan` over stacked groups becomes a Python loop over views of the
stacked leaves: each parameter leaf is unbound once into its groups,
each cache leaf indexed (`cache["blocks"][i][key][g]`), no copy.

Entry points:
  forward(params, inputs, cfg)                      -> (logits, {"aux_loss", "cache"})
  forward(..., cache=init_cache(...), positions)    -> prefill: fills cache
  decode_step(params, token, cache, cache_pos, cfg) -> (logits, cache)

Caches are updated in place: `forward` returns the cache it was given.
Attention layers write their k/v/pos buffers, recurrent layers copy
their new state (RG-LRU `h`, SSD `S`, the convolutions' last inputs)
into theirs, so a captured step reads and writes fixed buffers.
"""

from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import params as pmod
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import attn_block, f32_up, rms_norm, softcap
from repro_torch.models.moe import moe_block_ffn
from repro_torch.models.rglru import rglru_block
from repro_torch.models.ssd import ssd_block
from repro_torch.utils import dtype_of, resolve_device

init_params = pmod.init_params

RECURRENT_KINDS = ("rglru", "ssd")


# --------------------------------------------------------------------------
# Cache construction
# --------------------------------------------------------------------------

def _block_cache(cfg: ModelConfig, kind: str, B: int, max_seq: int,
                 lead: tuple, device):
    dt = dtype_of(cfg.compute_dtype)
    f32 = torch.float32

    def zeros(shape, dtype):
        return torch.zeros(lead + shape, dtype=dtype, device=device)
    if kind == "rglru":
        W, K = cfg.lru_width, cfg.rglru.conv_width
        return {"h": zeros((B, W), f32), "conv": zeros((B, K - 1, W), dt)}
    if kind == "ssd":
        s = cfg.ssd
        nh, N, P = cfg.ssd_heads, s.d_state, s.head_dim
        di, gn, K = cfg.d_inner_ssd, s.n_groups * s.d_state, s.conv_width
        return {"S": zeros((B, nh, N, P), f32),
                "conv": {"x": zeros((B, K - 1, di), dt),
                         "B": zeros((B, K - 1, gn), dt),
                         "C": zeros((B, K - 1, gn), dt)}}
    S = min(cfg.window, max_seq) if kind == "local" and cfg.window \
        else max_seq
    KV, hd = cfg.n_kv_heads, cfg.head_dim
    return {
        "k": zeros((B, S, KV, hd), dt),
        "v": zeros((B, S, KV, hd), dt),
        "pos": torch.full(lead + (S,), -1, dtype=torch.int32, device=device),
    }


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, device="cuda"):
    """{"blocks": (stacked per pattern kind,), "tail": (...,)}: attention
    layers' k/v buffers (zeros) and stored positions (-1 = unwritten);
    recurrent layers' state (RG-LRU h, SSD S: fp32) and convolution
    inputs (compute dtype), zeros. MoE layers keep an attention cache."""
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


def _unstack(tree, n: int):
    """A stacked tree's n scan groups, each a tree of views. Every leaf
    is unbound once: its backward stacks the n groups' grads in one pass,
    where indexing it group by group would add n zero-padded full-size
    grads (most of a full-width train step's time)."""
    if isinstance(tree, dict):
        parts = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: parts[k][g] for k in parts} for g in range(n)]
    return torch.unbind(tree, 0)


def _apply_block(kind: str, p, x, cfg: ModelConfig, positions, cache,
                 cache_pos, valid_from):
    """Returns (x, aux): aux the MoE block's load-balance loss, None for
    every other kind."""
    if kind in RECURRENT_KINDS:
        if valid_from is not None:
            # Recurrent state integrates every input step sequentially: a
            # left-padded prompt contaminates h/S/conv in a way no
            # attention mask can undo. Callers must feed unpadded
            # sequences instead.
            raise NotImplementedError(
                f"valid_from masking cannot be applied to recurrent blocks "
                f"({kind}); feed unpadded sequences")
        block = rglru_block if kind == "rglru" else ssd_block
        x, _ = block(p, x, cfg, cache)
        return x, None
    x, _ = attn_block(p, x, cfg, kind, positions, cache, cache_pos,
                      valid_from)
    if kind != "moe":
        return x, None
    out, aux = moe_block_ffn(p, rms_norm(x, p["ln2"], cfg.norm_eps), cfg)
    if cfg.sandwich_norm:
        out = rms_norm(out, p["post_ffn_norm"], cfg.norm_eps)
    return x + out, aux


def _apply_group(cfg: ModelConfig, ps, x, positions, cs, cache_pos,
                 valid_from, aux):
    """One pass through the pattern: the reference's scan body. Returns
    (x, aux plus the group's MoE losses)."""
    for i, kind in enumerate(cfg.pattern):
        c = None if cs is None else cs[i]
        x, a = _apply_block(kind, ps[i], x, cfg, positions, c, cache_pos,
                            valid_from)
        if a is not None:
            aux = aux + a
    return x, aux


def forward(params, inputs, cfg: ModelConfig, *, cache=None,
            cache_pos=None, positions=None,
            logits_last_only: bool = False, valid_from=None):
    """inputs: (B,T) int tokens or (B,T,d) embeddings.

    cache=None: plain forward. cache given & T>1: prefill (fills cache in
    place). logits_last_only: unembed only the final position (serving
    prefill — avoids materializing the (B,S,V) logits tensor).
    cache_pos: the decode step's position, the 0-d int32 tensor on the
    device that `decode_step` builds (default 0, as in the reference).
    valid_from: optional (B,) int32 per-row first attendable position
    (attention-only patterns; recurrent blocks raise).
    cfg.remat == "block": under autograd and without a cache, each scan
    group's blocks run under `torch.utils.checkpoint` (the reference's
    `jax.checkpoint` of its scan body): their activations are computed
    again in the backward instead of kept. A cached forward writes its
    cache in place, which a second run would write again, and gives the
    same values either way, so it runs as it is.
    Returns (logits, {"aux_loss": 0-d fp32, "cache": cache}); aux_loss is
    the MoE blocks' load-balance losses summed (zero without MoE)."""
    if cfg.remat == "moe_save":
        raise NotImplementedError(
            "remat='moe_save' (recompute each group but keep the MoE "
            "outputs) is not ported: a later PR (ROADMAP queue 1, the MoE "
            "follow-ups); use remat='block'")
    compute_dtype = dtype_of(cfg.compute_dtype)
    if cfg.input_mode == "embeddings":
        x = inputs.to(compute_dtype)
    else:
        x = params["embed"][inputs.long()].to(compute_dtype)
    if cfg.embed_scale:
        # A fill on the device (a host tensor would be a copy, which a
        # graph capture refuses), rounded to the compute dtype first as
        # in the reference.
        x = x * torch.full((), math.sqrt(cfg.d_model), dtype=compute_dtype,
                           device=x.device)
    T = x.shape[1]
    if positions is None:
        positions = torch.arange(T, dtype=torch.int32, device=x.device)
    if cache_pos is None:
        cache_pos = torch.zeros((), dtype=torch.int32, device=x.device)

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = (cfg.remat == "block" and cache is None
             and torch.is_grad_enabled())
    G = cfg.n_groups_scan
    groups = [_unstack(b, G) for b in params["blocks"]]
    for g in range(G):
        ps = [b[g] for b in groups]
        cs = None if cache is None else [_index(c, g)
                                         for c in cache["blocks"]]
        if remat:
            x, aux = checkpoint(_apply_group, cfg, ps, x, positions, cs,
                                cache_pos, valid_from, aux,
                                use_reentrant=False,
                                preserve_rng_state=False)
        else:
            x, aux = _apply_group(cfg, ps, x, positions, cs, cache_pos,
                                  valid_from, aux)
    for i, kind in enumerate(cfg.tail_kinds):
        c = None if cache is None else cache["tail"][i]
        x, a = _apply_block(kind, params["tail"][i], x, cfg, positions, c,
                            cache_pos, valid_from)
        if a is not None:
            aux = aux + a

    if logits_last_only:
        x = x[:, -1:]
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = torch.einsum("btd,vd->btv", x, params["embed"].to(x.dtype))
    else:
        logits = torch.einsum("btd,dv->btv", x,
                              params["lm_head"].to(x.dtype))
    logits = softcap(f32_up(logits), cfg.final_softcap)
    return logits, {"aux_loss": aux, "cache": cache}


def decode_step(params, token, cache, cache_pos, cfg: ModelConfig, *,
                valid_from=None):
    """One decode step. token: (B,1) int (or (B,1,d) embeddings);
    cache_pos: number of tokens already in context, an int or a 0-d
    int32 tensor on token's device (the two give the same bits; the
    tensor is read only on the device, so a captured step serves every
    position). valid_from: optional (B,) per-row first attendable cache
    position. Returns (logits (B,1,V), cache)."""
    if isinstance(cache_pos, torch.Tensor):
        if (cache_pos.dtype != torch.int32 or cache_pos.ndim != 0
                or cache_pos.device != token.device):
            raise ValueError(
                f"cache_pos must be an int or a 0-d int32 tensor on "
                f"{token.device}, got {cache_pos.dtype} "
                f"{tuple(cache_pos.shape)} on {cache_pos.device}")
    else:
        cache_pos = torch.full((), cache_pos, dtype=torch.int32,
                               device=token.device)
    positions = cache_pos[None]     # the reference's cache_pos[None]
    logits, extras = forward(params, token, cfg, cache=cache,
                             cache_pos=cache_pos, positions=positions,
                             valid_from=valid_from)
    return logits, extras["cache"]


def prefill(params, inputs, cfg: ModelConfig, max_seq: int, *,
            logits_last_only: bool = False, valid_from=None, cache=None):
    """Full-sequence prefill: returns (logits, cache ready for decoding).

    valid_from: optional (B,) int32 — with left-padded prompts, row b's
    real tokens start at position valid_from[b]; padding slots are masked
    out of every attention so they cannot contaminate logits or the KV
    cache reads of later decode steps.
    cache: optional (B, max_seq) cache from `init_cache` to prefill in
    place (the serving engine's persistent cache): every stored position
    goes back to -1 (unwritten) and every recurrent state to zeros
    first, so it gives the bits of a fresh cache. None: a fresh cache is
    allocated."""
    B, T = inputs.shape[0], inputs.shape[1]
    if cache is None:
        cache = init_cache(cfg, B, max_seq, device=inputs.device)
    else:
        for c in cache["blocks"] + cache["tail"]:
            if "pos" in c:
                c["pos"].fill_(-1)
            else:
                for leaf in pmod.tree_leaves(c):
                    leaf.zero_()
    logits, extras = forward(
        params, inputs, cfg, cache=cache,
        positions=torch.arange(T, dtype=torch.int32, device=inputs.device),
        logits_last_only=logits_last_only, valid_from=valid_from)
    return logits, extras["cache"]
