"""Plain PyTorch versions of every kernel: what each wrapper runs on a
CPU tensor, and what each CUDA kernel is held against on the card.

Same semantics as the kernels: the finite -1e30 fill for masked
logits, and a query row with no attendable key writes zeros."""

from __future__ import annotations

import torch

NEG_INF = -1e30


def softcap(x, cap: float):
    return cap * torch.tanh(x / cap) if cap else x


def flash_attention_ref(q, k, v, *, window: int = 0, cap: float = 0.0,
                        scale: float | None = None, causal: bool = True,
                        valid_from=None):
    """q: (B, Hq, T, hd); k, v: (B, KV, S, hd). Positions are implicit
    (q position i == kv position i). valid_from: optional (B,) first
    attendable key index per batch row; query rows with no attendable
    key at all produce zeros. Returns (B, Hq, T, hd) in q.dtype."""
    B, Hq, T, hd = q.shape
    KV, S = k.shape[1], k.shape[2]
    rep = Hq // KV
    scale = hd ** -0.5 if scale is None else scale
    dev = q.device
    qg = q.reshape(B, KV, rep, T, hd).float() * scale
    logits = torch.einsum("bgrth,bgsh->bgrts", qg, k.float())
    logits = softcap(logits, cap)
    pos_q = torch.arange(T, device=dev)[:, None]
    pos_k = torch.arange(S, device=dev)[None, :]
    mask = torch.ones((T, S), dtype=torch.bool, device=dev)
    if causal:
        mask &= pos_k <= pos_q
    if window:
        mask &= pos_k > pos_q - window
    mask = mask[None] if valid_from is None else (
        mask[None] & (pos_k[None] >= valid_from.long()[:, None, None]))
    logits = torch.where(mask[:, None, None], logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bgrts,bgsh->bgrth", p, v.float())
    if valid_from is not None:
        any_valid = mask.any(dim=-1)                               # (B,T)
        out = torch.where(any_valid[:, None, None, :, None], out, 0.0)
    return out.reshape(B, Hq, T, hd).to(q.dtype)


def decode_attention_ref(q, k, v, pos, cache_pos, *, cap: float = 0.0,
                         scale: float | None = None, window: int = 0,
                         valid_from=None):
    """q: (B, Hq, hd); k, v: (B, KV, S, hd); pos: (S,) stored positions
    (-1 = unwritten); cache_pos: current position (int or scalar
    tensor). valid_from: optional (B,) first attendable stored position
    per row (rows with no attendable slot produce zeros). (B, Hq, hd)."""
    B, Hq, hd = q.shape
    KV, S = k.shape[1], k.shape[2]
    rep = Hq // KV
    scale = hd ** -0.5 if scale is None else scale
    qg = q.reshape(B, KV, rep, hd).float() * scale
    logits = torch.einsum("bgrh,bgsh->bgrs", qg, k.float())
    logits = softcap(logits, cap)
    pos = pos.long()
    valid = (pos >= 0) & (pos <= cache_pos)
    if window:
        valid &= pos > cache_pos - window
    valid = valid[None] if valid_from is None else (
        valid[None] & (pos[None] >= valid_from.long()[:, None]))  # (B,S)
    logits = torch.where(valid[:, None, None], logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bgrs,bgsh->bgrh", p, v.float())
    if valid_from is not None:
        out = torch.where(valid.any(dim=-1)[:, None, None, None], out, 0.0)
    return out.reshape(B, Hq, hd).to(q.dtype)


def int8_matmul_ref(x, w_q, w_scale):
    """x: (M, K) float; w_q: (K, N) int8; w_scale: (1, N) or (N,) f32.
    Dequantizes before the product (the kernel scales after it)."""
    w = w_q.float() * w_scale.reshape(1, -1).float()
    return (x.float() @ w).to(x.dtype)
