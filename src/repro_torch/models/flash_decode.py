"""Distributed flash decode over a sequence-sharded KV cache.

Where n_kv_heads does not divide the model axis (yi, gemma2, deepseek,
chameleon at tp = 16; yi and gemma2 reduced at tp = 4), the KV cache
shards its SEQUENCE dim over the model axis (`sharding.make_rules`:
"cache_seq"). One decode step then:

  - writes the new token's k/v/pos into the one shard that owns its
    slot (the others keep what the slot holds; no communication),
  - computes attention over each shard's local S/tp chunk for ALL
    heads (q is one token, so every rank holding every head costs an
    all-gather of (B, H, hd)),
  - merges the partial softmax stats with a max all-reduce and two sum
    all-reduces of (B, KV, rep)- and (B, KV, rep, hd)-sized tensors over
    the model axis.

The reference's body is jnp einsums (its docstring names the Pallas
decode kernel as what a TPU would run per shard); the port's body is
torch, as the reference's is. A `decode_attention` variant that
returns its partial softmax stats would take its place (ROADMAP).
"""

from __future__ import annotations

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import NEG_INF, f32_up
from repro_torch.sharding import all_reduce


def flash_decode_sharded(q, k_new, v_new, ck, cv, cpos, cache_pos,
                         cfg: ModelConfig, parallel, *, window: int,
                         valid_from=None):
    """One decode step over this rank's chunk of a sequence-sharded
    cache, merged over the model axis.

    q: (B,1,H,hd) every q head of this rank's batch rows; k_new/v_new:
    (B,1,KV,hd); ck/cv: (B,S_loc,KV,hd) and cpos (S_loc,): this rank's
    chunk of the cache, global slots [i*S_loc, (i+1)*S_loc) for model
    index i, written in place; cache_pos: the new token's position, a
    0-d int32 tensor on the device (never read by the host, so a
    captured step serves every position); valid_from: optional (B,)
    first attendable stored position per row (masked into each chunk
    before the merge; a row with no attendable slot anywhere gives
    zeros). Returns out (B,1,H,hd)."""
    tp = parallel.tp_axis
    i = parallel.index((tp,))
    B, H, hd = q.shape[0], q.shape[2], q.shape[3]
    S_loc, KV = ck.shape[1], ck.shape[2]
    S = S_loc * parallel.tp_size

    # The slot's owner writes it; elsewhere the clamped index rewrites
    # what the slot holds.
    local = (cache_pos.long() % S - i * S_loc).reshape(1)
    owns = (local >= 0) & (local < S_loc)
    idx = local.clamp(0, S_loc - 1)
    ck.index_copy_(1, idx, torch.where(owns, k_new.to(ck.dtype),
                                       ck.index_select(1, idx)))
    cv.index_copy_(1, idx, torch.where(owns, v_new.to(cv.dtype),
                                       cv.index_select(1, idx)))
    cpos.index_copy_(0, idx, torch.where(owns, cache_pos.reshape(1).to(
        cpos.dtype), cpos.index_select(0, idx)))

    rep = H // KV
    scale = cfg.head_dim ** -0.5
    cap = cfg.attn_softcap
    # Grouped-GQA einsums: repeating KV to H heads would multiply the
    # cache read traffic by rep.
    qg = f32_up(q[:, 0] * scale).reshape(B, KV, rep, hd)
    s = torch.einsum("bgrd,bkgd->bgrk", qg, f32_up(ck))     # (B,KV,rep,S_loc)
    if cap:
        s = cap * torch.tanh(s / cap)
    valid = (cpos >= 0) & (cpos <= cache_pos)
    if window:
        valid &= cpos > cache_pos - window
    mask = valid[None, :]
    if valid_from is not None:
        mask = mask & (cpos[None, :] >= valid_from[:, None])   # (B,S_loc)
    s = torch.where(mask[:, None, None, :], s, NEG_INF)
    m = all_reduce(s.amax(-1), parallel, tp, "max")          # (B,KV,rep)
    p = torch.exp(s - m[..., None])
    l = all_reduce(p.sum(-1), parallel, tp)
    acc = all_reduce(torch.einsum("bgrk,bkgd->bgrd", p, f32_up(cv)),
                     parallel, tp)
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    if valid_from is not None:
        # Rows with no attendable slot anywhere (m still at the -1e30
        # fill after the max) give zeros, the shared masked-attention
        # semantic.
        out = torch.where((m > -5e29)[..., None], out, 0.0)
    return out.to(q.dtype).reshape(B, 1, H, hd)
