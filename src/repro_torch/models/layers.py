"""Core layer math of the attention-only models, on torch tensors.

Plain functions over parameter trees (nested dicts of tensors). The
attention implementation is selected by `cfg.attn_impl`:

- ``naive``: materializes the (T, S) logit matrix; fine for short context.
- ``cuda``: the hand-written kernels of `repro_torch.kernels` (flash
  attention for prefill, decode attention against the cache); on CPU
  tensors their plain versions.
- ``chunked``: the reference's pure-JAX flash attention (its
  ``jax_chunked``) in plain torch: query chunks by key chunks with a
  running (max, denom, acc) in fp32. It is what training runs past
  4096² and what autograd differentiates (the kernels have no backward).
- ``auto``: as the reference's ``auto``: ``naive`` for Tq == 1 or Tq*Tk
  <= 4096², ``chunked`` above.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.sharding import (all_gather, all_reduce, copy_to_split,
                                  gather_to_split, scatter_to_split,
                                  sum_to_shared)

NEG_INF = -1e30

# --------------------------------------------------------------------------
# Norms & activations
# --------------------------------------------------------------------------


def f32_up(x):
    """x in fp32, or in float64 if it is float64 already (the float64
    reference runs that hold fp32 gradients): what the reference's
    fp32 accumulations become for each input dtype."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def rms_norm(x, weight, eps: float = 1e-6, *, zero_centered: bool = True):
    """RMSNorm with fp32 accumulation. `zero_centered`: gemma-style (1+w)."""
    dt = x.dtype
    xf = f32_up(x)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    xf = xf * torch.rsqrt(var + eps)
    w = f32_up(weight)
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
    logits = torch.einsum("bqhd,bkhd->bhqk", f32_up(q * scale), f32_up(k))
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


def attention_chunked(q, k, v, pos_q, pos_k, *, window: int, cap: float,
                      scale: float, chunk_q: int, chunk_k: int,
                      valid_from=None):
    """Flash attention in plain torch: a loop over query chunks, an inner
    loop over key chunks, a running (max, denom, acc) in fp32.

    Padded q rows (position -1e9) are dropped; padded k columns carry
    position -1 and are masked. With valid_from, a key chunk that lies
    wholly below every row's valid_from is skipped (it would leave every
    row's running sums as they are), and a row that no key reaches gives
    zeros. The skip is decided on the host, one read a call; inside a
    CUDA graph capture, which refuses that read, every chunk runs, which
    gives the same bits."""
    B, Tq, Hq, hd = q.shape
    Tk, KV = k.shape[1], k.shape[2]
    k = _repeat_kv(k, Hq // KV)
    v = _repeat_kv(v, Hq // KV)
    cq = min(chunk_q, Tq)
    ck = min(chunk_k, Tk)
    pad_q = (-Tq) % cq
    pad_k = (-Tk) % ck
    if pad_q:
        q = F.pad(q, (0, 0, 0, 0, 0, pad_q))
        pos_q = F.pad(pos_q, (0, pad_q), value=-(10 ** 9))
    if pad_k:
        k = F.pad(k, (0, 0, 0, 0, 0, pad_k))
        v = F.pad(v, (0, 0, 0, 0, 0, pad_k))
        pos_k = F.pad(pos_k, (0, pad_k), value=-1)
    nq, nk = q.shape[1] // cq, k.shape[1] // ck
    run = [True] * nk
    if valid_from is not None and not (
            q.is_cuda and torch.cuda.is_current_stream_capturing()):
        run = (pos_k.reshape(nk, ck).amax(1)
               >= valid_from.min()).tolist()

    outs = []
    for i in range(nq):
        qc = f32_up(q[:, i * cq:(i + 1) * cq] * scale)
        pq = pos_q[i * cq:(i + 1) * cq]
        acc_dt = qc.dtype
        m = torch.full((B, Hq, cq), -math.inf, dtype=acc_dt, device=q.device)
        l = torch.zeros((B, Hq, cq), dtype=acc_dt, device=q.device)
        acc = torch.zeros((B, Hq, cq, hd), dtype=acc_dt, device=q.device)
        for j in range(nk):
            if not run[j]:
                continue
            sl = slice(j * ck, (j + 1) * ck)
            pk = pos_k[sl]
            logits = torch.einsum("bqhd,bkhd->bhqk", qc, f32_up(k[:, sl]))
            logits = softcap(logits, cap)
            mask = _attn_mask(pq, pk, window)
            logits = torch.where(mask[None, None], logits, NEG_INF)
            if valid_from is not None:
                rm = _row_mask(pk, valid_from)  # (B, ck)
                logits = torch.where(rm[:, None, None, :], logits, NEG_INF)
            m_new = torch.maximum(m, logits.amax(-1))
            p = torch.exp(logits - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhqk,bkhd->bhqd", p, f32_up(v[:, sl]))
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]
        if valid_from is not None:
            # Fully masked rows (m never rose above the -1e30 fill; the
            # -inf init marks rows whose every chunk was skipped): zeros.
            out = torch.where((m > -5e29)[..., None], out, 0.0)
        outs.append(out.transpose(1, 2).to(v.dtype))  # (B,cq,H,hd)
    return torch.cat(outs, dim=1)[:, :Tq]


def _impl_naive(q, k, v, pos_q, pos_k, cfg, *, window, cap, scale,
                valid_from, cache_pos):
    return attention_naive(q, k, v, pos_q, pos_k, window=window, cap=cap,
                           scale=scale, valid_from=valid_from)


def _impl_chunked(q, k, v, pos_q, pos_k, cfg, *, window, cap, scale,
                  valid_from, cache_pos):
    if q.shape[1] == 1:  # single-token: chunking buys nothing
        return attention_naive(q, k, v, pos_q, pos_k, window=window, cap=cap,
                               scale=scale, valid_from=valid_from)
    return attention_chunked(q, k, v, pos_q, pos_k, window=window, cap=cap,
                             scale=scale, chunk_q=cfg.attn_chunk,
                             chunk_k=cfg.attn_chunk, valid_from=valid_from)


def _impl_cuda(q, k, v, pos_q, pos_k, cfg, *, window, cap, scale,
               valid_from, cache_pos):
    """The kernel path (the CUDA kernels on the card, their plain
    versions on CPU tensors).

    Tq == 1 against a longer key set is a cache decode: the decode kernel
    reads the stored-position array (correct for ring caches) and, on
    linear caches (window == 0 means every attention cache spans
    max_seq, so slot == position), skips tiles outside
    [valid_from, cache_pos]. cache_pos arrives as a 0-d int32 tensor on
    the device, which the kernel reads, so the step reads nothing back
    to the host and a captured step serves every position. Anything
    else is a prefill
    over freshly computed contiguous k/v: the flash kernel's implicit
    positions match pos_q == pos_k, with valid_from shifted to kernel
    coordinates by the ops wrapper."""
    from repro_torch.kernels import ops as kops  # deferred import
    if q.shape[1] == 1 and k.shape[1] > 1:
        if cache_pos is None:
            raise ValueError("decode attention needs cache_pos")
        return kops.decode_attention(q, k, v, pos_k, cache_pos, valid_from,
                                     window=window, softcap=cap, scale=scale,
                                     linear=(window == 0))
    return kops.flash_attention(q, k, v, pos_q, pos_k, valid_from,
                                window=window, softcap=cap, scale=scale)


# Kernel dispatch registry. Every impl accepts the same signature,
# including per-row valid_from and the decode step's cache_pos.
ATTN_IMPLS = {
    "naive": _impl_naive,
    "chunked": _impl_chunked,
    "cuda": _impl_cuda,
}


def attention(q, k, v, pos_q, pos_k, cfg: ModelConfig, *, window: int,
              valid_from=None, cache_pos=None):
    scale = cfg.head_dim ** -0.5
    cap = cfg.attn_softcap
    impl = cfg.attn_impl
    Tq, Tk = q.shape[1], k.shape[1]
    if impl == "auto":
        impl = "naive" if Tq == 1 or Tq * Tk <= 4096 * 4096 else "chunked"
    try:
        fn = ATTN_IMPLS[impl]
    except KeyError:
        raise ValueError(
            f"unknown attn_impl {impl!r}; valid impls: "
            f"{', '.join(sorted(ATTN_IMPLS))} (or 'auto')") from None
    return fn(q, k, v, pos_q, pos_k, cfg, window=window, cap=cap,
              scale=scale, valid_from=valid_from, cache_pos=cache_pos)


def _proj(x, w, parallel=None):
    """Projection: x's leading two axes are (batch, seq) and every
    trailing x axis contracts against w's leading axes, so one flattened
    (B*T, K) @ (K, N) product covers qkv (d -> (H, hd)), the output
    projection ((H, hd) -> d) and both MLP matmuls. int8 execution
    leaves ({"q","scale"} dicts from `quant.int8.quantize_exec_tree`) go
    to the int8 matmul kernel; float leaves to torch.matmul, with mixed
    dtypes promoted as in the reference (bf16 x f32 -> f32).
    parallel: given by the row-parallel projections (wo, w_down), whose
    local w holds this rank's rows of the contraction: the product is a
    partial sum (int8: each output column's scale already applied, as
    it is the same on every rank), summed over the model axis."""
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
    if parallel is not None:
        out = all_reduce(out, parallel, parallel.tp_axis)
    return out.reshape((B, T) + out_shape)


def _autograd_path(parallel) -> bool:
    """Whether a block meets the model axis through the collectives
    with a backward (`sharding.copy_to_split` ...): the train profile,
    or a residual T-sharded over model (`parallel.seq_shard`, as
    `models.model.forward` hands it to the blocks). The serve profile's
    plain path keeps its in-place all_reduce (its CUDA graphs capture
    it)."""
    return parallel is not None and (parallel.profile == "train"
                                     or parallel.seq_shard)


def _fsdp(w, parallel, dim: int):
    """A weight whose `hidden_in` dim (`dim`) the train profile shards
    over the FSDP axes, gathered whole at use (its backward
    reduce-scatters the grad over those axes); w itself otherwise."""
    if parallel is None or parallel.profile != "train":
        return w
    return gather_to_split(w, parallel, parallel.fsdp_axes, dim)


def _col_in(h, parallel):
    """The input of this rank's column-parallel projections (q/k/v, up
    and gate): under seq_shard the T-sharded h gathered over model
    (backward: reduce_scatter); under the train profile h itself whose
    grad sums over model; otherwise h."""
    if not _autograd_path(parallel):
        return h
    if parallel.seq_shard:
        return gather_to_split(h, parallel, parallel.tp_axis, 1)
    return copy_to_split(h, parallel, parallel.tp_axis)


def _row_proj(x, w, parallel, dim: int):
    """A row-parallel projection (wo, w_down; `dim` its hidden_in dim)
    and its sum over model: under seq_shard reduce-scattered into the
    T-sharded residual; under the train profile an out-of-place sum;
    otherwise `_proj`'s in-place all_reduce."""
    if not _autograd_path(parallel):
        return _proj(x, w, parallel)
    out = _proj(x, _fsdp(w, parallel, dim))
    if parallel.seq_shard:
        return scatter_to_split(out, parallel, parallel.tp_axis, 1)
    return sum_to_shared(out, parallel, parallel.tp_axis)


def _kv_heads_for(k, Hq: int, parallel):
    """k or v (B,T,KV,hd) holding every kv head (n_kv_heads does not
    divide the model axis, so every rank computes them all), cut to the
    kv heads this rank's q heads [r*Hq/tp, (r+1)*Hq/tp) read (q head h
    reads kv head h // rep), as a contiguous tensor the kernels take.
    Where the local q heads cover whole kv groups, or sit inside one
    group (several ranks then share that kv head), a slice keeps GQA's
    grouping; otherwise each local q head gets its own copy (rep 1)."""
    KV, tp = k.shape[2], parallel.tp_size
    rep, Hl = Hq // KV, Hq // tp
    lo = parallel.index((parallel.tp_axis,)) * Hl
    if Hl % rep == 0 or rep % Hl == 0:
        return k[:, :, lo // rep:lo // rep + max(1, Hl // rep)].contiguous()
    idx = (lo + torch.arange(Hl, device=k.device)) // rep
    return k.index_select(2, idx)


def _prefill_write(cache, kd, vd, pd, T: int, base: int, S: int):
    """Write a prefill's k/v/pos (T positions from 0, or a backfill's
    private row) into this rank's cache slots [base, base + S_loc) of an
    S-slot cache (base = 0 and S_loc = S unless the sequence is sharded),
    exactly the slots the unsharded write fills: slot s <- position s
    for T < S; for T >= S the ring invariant, slot p % S <- position p
    for the last S positions."""
    S_loc = cache["k"].shape[1]
    if T >= S:
        s = base + torch.arange(S_loc, device=kd.device)
        src = (T - S) + (s - (T - S)) % S
        cache["k"][:] = kd[:, src]
        cache["v"][:] = vd[:, src]
        cache["pos"][:] = pd[src]
        return
    n = min(max(T - base, 0), S_loc)
    cache["k"][:, :n] = kd[:, base:base + n]
    cache["v"][:, :n] = vd[:, base:base + n]
    cache["pos"][:n] = pd[base:base + n]


def attn_block(p, x, cfg: ModelConfig, kind: str, positions,
               cache: Optional[dict] = None, cache_pos=None,
               valid_from=None, parallel=None):
    """Pre-norm attention block. Returns (x_out, cache).

    Train/prefill: cache is None, positions = (T,) absolute positions.
    Decode: cache = {"k","v","pos"} ring/linear buffers of this layer,
    cache_pos = the new token's position, the 0-d int32 tensor on x's
    device that `models.model.decode_step` builds. The cache write goes
    to a slot computed on the device, so nothing is read back to the
    host.
    valid_from: optional (B,) int32 — per row, the first key position this
    row may attend to (masks left-padding and, on backfilled slots, the
    previous occupant's stale cache entries).
    parallel: a `sharding.ParallelConfig` (serve profile): p holds this
    rank's shards (`params.shard_params`), x this rank's batch rows,
    replicated over the model axis. q and wo run this rank's heads, k
    and v its kv heads where n_kv_heads divides the model axis (its
    cache holds those heads) and every kv head otherwise (its cache
    holds its chunk of the sequence, and decode runs
    `flash_decode.flash_decode_sharded`); the row-parallel wo and
    w_down sum over the model axis before the sandwich norms and the
    residual adds.

    The cache tensors are written IN PLACE (the reference returns new
    arrays): each layer's buffers are views into the stacked cache, so an
    in-place write updates the stacked cache without a copy."""
    window = cfg.window if kind == "local" else 0
    eps = cfg.norm_eps
    h = _col_in(rms_norm(x, p["ln1"], eps), parallel)
    B, T, _ = h.shape
    q = _proj(h, _fsdp(p["wq"], parallel, 0))
    k = _proj(h, _fsdp(p["wk"], parallel, 0))
    v = _proj(h, _fsdp(p["wv"], parallel, 0))
    q, k = _qk_norm(q, k, p, eps)
    q = rope(q, positions, theta=cfg.rope_theta, rotary_pct=cfg.rotary_pct)
    k = rope(k, positions, theta=cfg.rope_theta, rotary_pct=cfg.rotary_pct)
    seq_sharded = (parallel is not None
                   and cfg.n_kv_heads % parallel.tp_size != 0)

    out = None
    if cache is not None and T == 1 and seq_sharded:
        # Sequence-sharded cache: masked local write + partial-softmax
        # merge over the model axis, every q head on every rank.
        # (deferred: flash_decode imports this module)
        from repro_torch.models.flash_decode import flash_decode_sharded
        Hl = q.shape[2]
        r = parallel.index((parallel.tp_axis,))
        qa = all_gather(q, parallel, parallel.tp_axis, 2)
        out = flash_decode_sharded(
            qa, k, v, cache["k"], cache["v"], cache["pos"], cache_pos, cfg,
            parallel, window=window, valid_from=valid_from)
        out = out[:, :, r * Hl:(r + 1) * Hl]
    elif cache is not None and T == 1:
        # Decode: ring-buffer write. Windowed layers allocate S == window so
        # the modulo wraps; full layers allocate S == max_seq (identity).
        S = cache["k"].shape[1]
        # The reference's dynamic_update_slice at slot: an index on the
        # device (a 0-d tensor as an index would be read by the host).
        slot = (cache_pos.long() % S).reshape(1)
        cache["k"].index_copy_(1, slot, k.to(cache["k"].dtype))
        cache["v"].index_copy_(1, slot, v.to(cache["v"].dtype))
        # Stored positions make masking correct for both ring & linear
        # cases (unwritten slots stay -1 and are masked out).
        cache["pos"].index_copy_(0, slot, positions.to(cache["pos"].dtype))
        k, v, pos_k = cache["k"], cache["v"], cache["pos"]
        pos_q = positions
    elif cache is not None:
        # Prefill: attend over the freshly computed k/v and write them into
        # slots 0..T-1 (a group prefill starts at position 0, so slot ==
        # position; a backfill's private row cache is merged at its offset
        # by the engine). T >= S keeps the ring invariant slot = p % S. A
        # sequence-sharded cache keeps the slots of its chunk.
        S, base = cache["k"].shape[1], 0
        if seq_sharded:
            base = parallel.index((parallel.tp_axis,)) * S
            S *= parallel.tp_size
        _prefill_write(cache, k.to(cache["k"].dtype),
                       v.to(cache["v"].dtype),
                       positions.to(cache["pos"].dtype), T, base, S)
        pos_q = pos_k = positions
    else:
        pos_q = pos_k = positions

    if out is None:
        if seq_sharded:
            k = _kv_heads_for(k, cfg.q_heads_padded, parallel)
            v = _kv_heads_for(v, cfg.q_heads_padded, parallel)
        out = attention(q, k, v, pos_q, pos_k, cfg, window=window,
                        valid_from=valid_from, cache_pos=cache_pos)
    out = _row_proj(out, p["wo"], parallel, 2)
    if cfg.sandwich_norm:
        out = rms_norm(out, p["post_attn_norm"], eps)
    x = x + out

    if "mlp" in p:
        h = _col_in(rms_norm(x, p["ln2"], eps), parallel)
        out = mlp(p["mlp"], h, cfg, parallel)
        if cfg.sandwich_norm:
            out = rms_norm(out, p["post_ffn_norm"], eps)
        x = x + out
    return x, cache


def mlp(p, x, cfg: ModelConfig, parallel=None):
    """Gated (or plain) MLP. parallel: up and gate hold this rank's
    columns of ff, down its rows, summed over the model axis (x is the
    column-parallel input `_col_in` gives; under seq_shard whole T, the
    output this rank's block of T)."""
    act = act_fn(cfg.mlp_act)
    if cfg.mlp_gated:
        u = _proj(x, _fsdp(p["w_up"], parallel, 0))
        g = _proj(x, _fsdp(p["w_gate"], parallel, 0))
        h = act(g) * u
    else:
        h = act(_proj(x, _fsdp(p["w_up"], parallel, 0)))
    return _row_proj(h, p["w_down"], parallel, 1)
