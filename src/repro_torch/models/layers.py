"""Core layer math of the attention-only models, on torch tensors.

Plain functions over parameter trees (nested dicts of tensors). The
attention implementation is selected by `cfg.attn_impl`:

- ``naive``: materializes the (T, S) logit matrix; fine for short context.
- ``cuda``: the hand-written kernels of `repro_torch.kernels` (flash
  attention for prefill, decode attention against the cache); on CPU
  tensors their plain versions.
- ``auto``: ``naive`` wherever the reference's ``auto`` picks naive. Where
  the reference would pick its chunked attention, this raises: chunked
  attention belongs to a later slice of the port.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models.config import ModelConfig

NEG_INF = -1e30

# --------------------------------------------------------------------------
# Norms & activations
# --------------------------------------------------------------------------


def rms_norm(x, weight, eps: float = 1e-6, *, zero_centered: bool = True):
    """RMSNorm with fp32 accumulation. `zero_centered`: gemma-style (1+w)."""
    dt = x.dtype
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    xf = xf * torch.rsqrt(var + eps)
    w = weight.float()
    scale = (1.0 + w) if zero_centered else w
    return (xf * scale).to(dt)


def softcap(x, cap: float):
    if not cap:
        return x
    return cap * torch.tanh(x / cap)


def act_fn(name: str):
    return {"silu": torch.nn.functional.silu,
            "gelu": lambda x: torch.nn.functional.gelu(
                x, approximate="tanh")}[name]


# --------------------------------------------------------------------------
# Rotary position embeddings (partial-rotary supported)
# --------------------------------------------------------------------------

def rope(x, positions, *, theta: float, rotary_pct: float = 1.0):
    """x: (..., T, H, hd); positions: broadcastable to (..., T)."""
    hd = x.shape[-1]
    rot = int(hd * rotary_pct)
    rot -= rot % 2
    if rot == 0:
        return x
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    half = rot // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions[..., None].float() * freqs      # (..., T, half)
    cos = torch.cos(ang)[..., None, :]               # broadcast over heads
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x_rot[..., :half], x_rot[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                    dim=-1).to(x.dtype)
    if x_pass.shape[-1]:
        out = torch.cat([out, x_pass], dim=-1)
    return out


# --------------------------------------------------------------------------
# Attention
# --------------------------------------------------------------------------

def _qk_norm(q, k, p, eps):
    if "q_norm" in p:
        q = rms_norm(q, p["q_norm"], eps)
        k = rms_norm(k, p["k_norm"], eps)
    return q, k


def _attn_mask(pos_q, pos_k, window: int):
    """(Tq, Tk) bool mask: causal + optional sliding window + validity.

    Invalid (unwritten) cache slots carry position -1 and are masked."""
    m = pos_k[None, :] <= pos_q[:, None]
    m &= pos_k[None, :] >= 0
    if window:
        m &= pos_k[None, :] > pos_q[:, None] - window
    return m


def _row_mask(pos_k, valid_from):
    """(B, Tk) bool: per-row first-valid key position.

    Rows in a batched cache can start at different positions (left-padded
    prompts, or a backfilled slot whose previous occupant left stale k/v
    behind): key position p is attendable for row b only if
    p >= valid_from[b]. The shared cache `pos` array stays (S,)."""
    return pos_k[None, :] >= valid_from[:, None]


def _repeat_kv(k, rep: int):
    """(B,S,KV,hd) -> (B,S,KV*rep,hd)."""
    return torch.repeat_interleave(k, rep, dim=2) if rep > 1 else k


def attention_naive(q, k, v, pos_q, pos_k, *, window: int, cap: float,
                    scale: float, valid_from=None):
    """q: (B,Tq,Hq,hd); k,v: (B,Tk,KV,hd). Returns (B,Tq,Hq,hd)."""
    Hq, KV = q.shape[2], k.shape[2]
    k = _repeat_kv(k, Hq // KV)
    v = _repeat_kv(v, Hq // KV)
    logits = torch.einsum("bqhd,bkhd->bhqk", (q * scale).float(), k.float())
    logits = softcap(logits, cap)
    mask = _attn_mask(pos_q, pos_k, window)
    logits = torch.where(mask[None, None], logits, NEG_INF)
    if valid_from is not None:
        rm = _row_mask(pos_k, valid_from)  # (B, Tk)
        logits = torch.where(rm[:, None, None, :], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v)
    if valid_from is not None:
        # Shared masked-attention semantic: a query row with no attendable
        # key produces zeros, not the uniform-softmax average the -1e30
        # fill would otherwise renormalize to.
        any_valid = (mask[None] & rm[:, None, :]).any(-1)  # (B, Tq)
        out = torch.where(any_valid[:, :, None, None], out, 0.0)
    return out


def _impl_naive(q, k, v, pos_q, pos_k, cfg, *, window, cap, scale,
                valid_from, cache_pos):
    return attention_naive(q, k, v, pos_q, pos_k, window=window, cap=cap,
                           scale=scale, valid_from=valid_from)


def _impl_cuda(q, k, v, pos_q, pos_k, cfg, *, window, cap, scale,
               valid_from, cache_pos):
    """The kernel path (the CUDA kernels on the card, their plain
    versions on CPU tensors).

    Tq == 1 against a longer key set is a cache decode: the decode kernel
    reads the stored-position array (correct for ring caches) and, on
    linear caches (window == 0 means every attention cache spans
    max_seq, so slot == position), skips tiles outside
    [valid_from, cache_pos]. cache_pos arrives as a Python int, so the
    step reads nothing back from the device. Anything else is a prefill
    over freshly computed contiguous k/v: the flash kernel's implicit
    positions match pos_q == pos_k, with valid_from shifted to kernel
    coordinates by the ops wrapper."""
    from repro_torch.kernels import ops as kops  # deferred import
    if q.shape[1] == 1 and k.shape[1] > 1:
        if cache_pos is None:
            raise ValueError("decode attention needs cache_pos as an int")
        return kops.decode_attention(q, k, v, pos_k, cache_pos, valid_from,
                                     window=window, softcap=cap, scale=scale,
                                     linear=(window == 0))
    return kops.flash_attention(q, k, v, pos_q, pos_k, valid_from,
                                window=window, softcap=cap, scale=scale)


# Kernel dispatch registry. Every impl accepts the same signature,
# including per-row valid_from and the decode step's cache_pos.
ATTN_IMPLS = {
    "naive": _impl_naive,
    "cuda": _impl_cuda,
}


def attention(q, k, v, pos_q, pos_k, cfg: ModelConfig, *, window: int,
              valid_from=None, cache_pos: Optional[int] = None):
    scale = cfg.head_dim ** -0.5
    cap = cfg.attn_softcap
    impl = cfg.attn_impl
    Tq, Tk = q.shape[1], k.shape[1]
    if impl == "auto":
        if Tq > 1 and Tq * Tk > 4096 * 4096:
            raise NotImplementedError(
                f"attn_impl='auto' picks chunked attention for Tq*Tk = "
                f"{Tq}*{Tk}; chunked attention is not ported yet (a later "
                f"slice of the port). Use attn_impl='cuda' or 'naive'.")
        impl = "naive"
    try:
        fn = ATTN_IMPLS[impl]
    except KeyError:
        raise ValueError(
            f"unknown attn_impl {impl!r}; valid impls: "
            f"{', '.join(sorted(ATTN_IMPLS))} (or 'auto')") from None
    return fn(q, k, v, pos_q, pos_k, cfg, window=window, cap=cap,
              scale=scale, valid_from=valid_from, cache_pos=cache_pos)


def _proj(x, w):
    """Projection: x's leading two axes are (batch, seq) and every
    trailing x axis contracts against w's leading axes, so one flattened
    (B*T, K) @ (K, N) product covers qkv (d -> (H, hd)), the output
    projection ((H, hd) -> d) and both MLP matmuls. int8 execution
    leaves ({"q","scale"} dicts from `quant.int8.quantize_exec_tree`) go
    to the int8 matmul kernel; float leaves to torch.matmul, with mixed
    dtypes promoted as in the reference (bf16 x f32 -> f32)."""
    B, T = x.shape[0], x.shape[1]
    x2 = x.reshape(B * T, -1)
    if isinstance(w, dict):
        from repro_torch.kernels import ops as kops  # deferred import
        out_shape = tuple(w["q"].shape[x.ndim - 2:])
        w2 = w["q"].reshape(x2.shape[1], -1)
        out = kops.int8_matmul(x2, w2, w["scale"].reshape(-1))
    else:
        out_shape = tuple(w.shape[x.ndim - 2:])
        dt = torch.promote_types(x.dtype, w.dtype)
        out = torch.matmul(x2.to(dt), w.reshape(x2.shape[1], -1).to(dt))
    return out.reshape((B, T) + out_shape)


def attn_block(p, x, cfg: ModelConfig, kind: str, positions,
               cache: Optional[dict] = None, cache_pos: Optional[int] = None,
               valid_from=None):
    """Pre-norm attention block. Returns (x_out, cache).

    Train/prefill: cache is None, positions = (T,) absolute positions.
    Decode: cache = {"k","v","pos"} ring/linear buffers of this layer,
    cache_pos = the new token's position as a Python int.
    valid_from: optional (B,) int32 — per row, the first key position this
    row may attend to (masks left-padding and, on backfilled slots, the
    previous occupant's stale cache entries).

    The cache tensors are written IN PLACE (the reference returns new
    arrays): each layer's buffers are views into the stacked cache, so an
    in-place write updates the stacked cache without a copy."""
    window = cfg.window if kind == "local" else 0
    eps = cfg.norm_eps
    h = rms_norm(x, p["ln1"], eps)
    B, T, _ = h.shape
    q = _proj(h, p["wq"])
    k = _proj(h, p["wk"])
    v = _proj(h, p["wv"])
    q, k = _qk_norm(q, k, p, eps)
    q = rope(q, positions, theta=cfg.rope_theta, rotary_pct=cfg.rotary_pct)
    k = rope(k, positions, theta=cfg.rope_theta, rotary_pct=cfg.rotary_pct)

    if cache is not None and T == 1:
        # Decode: ring-buffer write. Windowed layers allocate S == window so
        # the modulo wraps; full layers allocate S == max_seq (identity).
        S = cache["k"].shape[1]
        slot = cache_pos % S
        cache["k"][:, slot] = k[:, 0].to(cache["k"].dtype)
        cache["v"][:, slot] = v[:, 0].to(cache["v"].dtype)
        # Stored positions make masking correct for both ring & linear
        # cases (unwritten slots stay -1 and are masked out).
        cache["pos"][slot] = positions[0].to(cache["pos"].dtype)
        k, v, pos_k = cache["k"], cache["v"], cache["pos"]
        pos_q = positions
    elif cache is not None:
        # Prefill: attend over the freshly computed k/v and write them into
        # slots 0..T-1 (a group prefill starts at position 0, so slot ==
        # position; a backfill's private row cache is merged at its offset
        # by the engine). T >= S keeps the ring invariant slot = p % S.
        S = cache["k"].shape[1]
        kd, vd = k.to(cache["k"].dtype), v.to(cache["v"].dtype)
        pd = positions.to(cache["pos"].dtype)
        if T >= S:
            slots = torch.arange(T - S, T, device=x.device) % S
            cache["k"][:, slots] = kd[:, T - S:]
            cache["v"][:, slots] = vd[:, T - S:]
            cache["pos"][slots] = pd[T - S:]
        else:
            cache["k"][:, :T] = kd
            cache["v"][:, :T] = vd
            cache["pos"][:T] = pd
        pos_q = pos_k = positions
    else:
        pos_q = pos_k = positions

    out = attention(q, k, v, pos_q, pos_k, cfg, window=window,
                    valid_from=valid_from, cache_pos=cache_pos)
    out = _proj(out, p["wo"])
    if cfg.sandwich_norm:
        out = rms_norm(out, p["post_attn_norm"], eps)
    x = x + out

    if "mlp" in p:
        h = rms_norm(x, p["ln2"], eps)
        out = mlp(p["mlp"], h, cfg)
        if cfg.sandwich_norm:
            out = rms_norm(out, p["post_ffn_norm"], eps)
        x = x + out
    return x, cache


def mlp(p, x, cfg: ModelConfig):
    act = act_fn(cfg.mlp_act)
    if cfg.mlp_gated:
        u = _proj(x, p["w_up"])
        g = _proj(x, p["w_gate"])
        h = act(g) * u
    else:
        h = act(_proj(x, p["w_up"]))
    return _proj(h, p["w_down"])
