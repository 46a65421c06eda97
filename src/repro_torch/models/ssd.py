"""Mamba2 SSD (state-space duality) mixer, chunked, on torch tensors
(after `repro/models/ssd.py`).

Recurrence per head h with state S in R^{N x P}:
    S_t = a_t * S_{t-1} + B_t (x_t dt_t)^T        a_t = exp(dt_t * A_h)
    y_t = C_t^T S_t + D_h * x_t

Sequence mode uses the chunked SSD algorithm (arXiv:2405.21060): a loop
over chunks of length Q carrying the running state (the reference's
`lax.scan`; the chunk count is fixed by T, so a CUDA graph captures the
loop); within a chunk the quadratic (Q x Q) form runs as batched
matrix products. Decode mode is the O(1) update.

Shapes: x (B,T,H,P); B,C (B,T,G,N) with H % G == 0; dt (B,T,H).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (_autograd_path, _col_in, _fsdp,
                                       _proj, _row_proj, f32_up, rms_norm)
from repro_torch.models.rglru import causal_conv1d
from repro_torch.sharding import all_reduce, copy_to_split, sum_to_shared

NEG_INF = -1e30


def _expand_groups(t, H):
    """(B,...,G,N) -> (B,...,H,N) by repeating each group H//G times
    (jnp.repeat on axis -2), as a broadcast: no device sync."""
    G, N = t.shape[-2], t.shape[-1]
    lead = t.shape[:-2]
    return t.unsqueeze(-2).expand(lead + (G, H // G, N)).reshape(
        lead + (H, N))


def ssd_chunked(x, dt, A, Bm, Cm, chunk: int, S0=None):
    """Chunked SSD scan. Returns (y, S_last).

    x: (B,T,H,P); dt: (B,T,H) (already softplus'd); A: (H,) negative;
    Bm, Cm: (B,T,G,N). S0: optional (B,H,N,P) initial state.
    """
    B_, T, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    Q = min(chunk, T)
    pad = (-T) % Q
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, 0, 0, pad))
    nc = x.shape[1] // Q

    xdt = (x * dt[..., None]).float()
    log_a = dt.float() * A.float()  # (B,T',H), <= 0

    single_group = (G == 1)
    if single_group:
        # Keep B/C per group: no (B,T,H,N) expansion.
        Bs, Cs = Bm[:, :, 0].float(), Cm[:, :, 0].float()
    else:
        Bs, Cs = (_expand_groups(Bm, H).float(),
                  _expand_groups(Cm, H).float())

    S = S0 if S0 is not None else torch.zeros(
        (B_, H, N, P), dtype=torch.float32, device=x.device)
    causal = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                   device=x.device))
    ys = []
    for c in range(nc):
        sl = slice(c * Q, (c + 1) * Q)
        xc, lac, Bc, Cc = xdt[:, sl], log_a[:, sl], Bs[:, sl], Cs[:, sl]
        # Inclusive within-chunk cumulative log-decay.
        l = torch.cumsum(lac, dim=1)  # (B,Q,H)
        decay_out = torch.exp(l[:, -1, :][:, None] - l)  # (B,Q,H)
        if single_group:
            # Bc/Cc: (B,Q,N) shared across heads.
            y_inter = torch.einsum("bqn,bhnp->bqhp", Cc, S) * \
                torch.exp(l)[..., None]
            scores = torch.einsum("bqn,bkn->bqk", Cc, Bc)
            dec = l[:, :, None, :] - l[:, None, :, :]  # (B,Q,K,H)
            # Mask inside the exp, as the reference does.
            M = torch.exp(torch.where(causal[None, :, :, None], dec,
                                      NEG_INF))
            y_intra = torch.einsum("bqkh,bkhp->bqhp", scores[..., None] * M,
                                   xc)
            S = (torch.exp(l[:, -1])[..., None, None] * S +
                 torch.einsum("bkn,bkhp->bhnp", Bc,
                              xc * decay_out[..., None]))
        else:
            # Bc/Cc: (B,Q,H,N) per head.
            y_inter = torch.einsum("bqhn,bhnp->bqhp", Cc, S) * \
                torch.exp(l)[..., None]
            scores = torch.einsum("bqhn,bkhn->bhqk", Cc, Bc)
            lt = l.permute(0, 2, 1)  # (B,H,Q)
            dec = lt[:, :, :, None] - lt[:, :, None, :]  # (B,H,Q,K)
            M = torch.exp(torch.where(causal[None, None], dec, NEG_INF))
            y_intra = torch.einsum("bhqk,bkhp->bqhp", scores * M, xc)
            S = (torch.exp(l[:, -1])[..., None, None] * S +
                 torch.einsum("bkhn,bkhp->bhnp", Bc * decay_out[..., None],
                              xc))
        ys.append(y_inter + y_intra)
    y = torch.cat(ys, dim=1)[:, :T]
    return y.to(x.dtype), S


def ssd_step(x, dt, A, Bm, Cm, S):
    """Single-token decode. x: (B,1,H,P); Bm/Cm: (B,1,G,N); S: (B,H,N,P)."""
    H = x.shape[2]
    a = torch.exp(dt[:, 0].float() * A.float())  # (B,H)
    Bh = _expand_groups(Bm[:, 0], H).float()  # (B,H,N)
    Ch = _expand_groups(Cm[:, 0], H).float()
    xdt = (x[:, 0] * dt[:, 0, :, None]).float()  # (B,H,P)
    S_new = a[..., None, None] * S + torch.einsum("bhn,bhp->bhnp", Bh, xdt)
    y = torch.einsum("bhn,bhnp->bhp", Ch, S_new)
    return y[:, None].to(x.dtype), S_new


def _gated_norm(y, z, w, eps: float, parallel=None):
    """Mamba2's gated RMSNorm, rms_norm(y * silu(z), w) with a plain
    (not zero-centered) scale, over the whole inner width. parallel: y,
    z and w hold this rank's equal slice of it over the model axis:
    each rank's mean square is averaged over the axis before the rsqrt
    (the mean of equal-sized slices' means is the whole width's; a
    per-slice norm would be wrong and still finite). On one rank the
    average is the rank's own mean, so it gives rms_norm's bits. Under
    the train profile the sum has a backward that sums over model too:
    each rank's normalizer feeds its own slice, so each rank's mean
    square gets every rank's grad of it."""
    g = y * F.silu(z)
    if parallel is None:
        return rms_norm(g, w, eps, zero_centered=False)
    gf = f32_up(g)
    ms = torch.mean(gf * gf, dim=-1, keepdim=True)
    if _autograd_path(parallel):
        ms = copy_to_split(sum_to_shared(ms, parallel, parallel.tp_axis),
                           parallel, parallel.tp_axis)
    else:
        ms = all_reduce(ms, parallel, parallel.tp_axis)
    var = ms / parallel.tp_size
    return (gf * torch.rsqrt(var + eps) * f32_up(w)).to(g.dtype)


def _local_groups(t, H: int, H_all: int, parallel):
    """t (B, T, G, N) of every group, cut to the groups of this rank's
    H of the H_all heads (head h reads group h // (H_all // G)): (B, T,
    G', N) with H % G' == 0, each local head reading its group as
    `_expand_groups` maps it. t itself where the rank holds every head
    or G == 1. No published config has G > 1;
    tests/test_torch_sharded_blocks.py holds the cut at G = 2 and 4."""
    G = t.shape[2]
    if G == 1 or H == H_all:
        return t
    lo = parallel.index((parallel.tp_axis,)) * H
    idx = (lo + torch.arange(H, device=t.device)) // (H_all // G)
    return t.index_select(2, idx)


def ssd_block(p, x, cfg: ModelConfig, cache=None, parallel=None):
    """Full mamba2 residual block. cache: None or {"S": (B,H,N,P) fp32,
    "conv": {"x", "B", "C"}: (B,K-1,channels)}, a layer's views into the
    model's cache. With a cache, T == 1 is a decode step from the cached
    state and T > 1 a prefill whose scan starts from a zero state (the
    reference ignores the incoming S there, and seeds the convolutions
    with the cached inputs, zeros in a prefill's fresh cache); both
    write the new state into the cache tensors in place.
    parallel: a `sharding.ParallelConfig`: p and the cache hold this
    rank's heads over the model axis (`ssd_heads`: w_dt, A_log,
    dt_bias, D, S) and their slice of the inner width (`ssd_inner`:
    w_z, w_x, conv_x, norm_w, w_out's rows, the x conv state); w_B, w_C
    and their convs stay whole (`ssd_gn`), each rank reading its heads'
    groups of them. The gated norm averages its mean square over the
    model axis and w_out sums over it. Under the train profile (and
    seq_shard) the block meets the model axis through the collectives
    with a backward (`layers._col_in`, `_row_proj`, `_fsdp`): the
    projections' input is h whose grad sums over model (under seq_shard
    "full" h gathered over T first: the chunked scan needs every step),
    and w_out's sum goes back into the residual (scattered over T under
    seq_shard "full"). w_B, w_C and their convs get each rank's part of
    their grad (its groups' heads'), which the train step's grad sync
    sums over model. Returns (x_out, cache)."""
    s = cfg.ssd
    eps = cfg.norm_eps
    P = s.head_dim
    G, N = s.n_groups, s.d_state

    h = _col_in(rms_norm(x, p["ln1"], eps), parallel)
    z = _proj(h, _fsdp(p["w_z"], parallel, 0))
    xb = _proj(h, _fsdp(p["w_x"], parallel, 0))
    Bc = _proj(h, _fsdp(p["w_B"], parallel, 0))
    Cc = _proj(h, _fsdp(p["w_C"], parallel, 0))
    dt = _proj(h, _fsdp(p["w_dt"], parallel, 0))
    cs = cache["conv"] if cache is not None else {}
    xb, st_x = causal_conv1d(p["conv_x"], xb, cs.get("x"))
    Bc, st_b = causal_conv1d(p["conv_B"], Bc, cs.get("B"))
    Cc, st_c = causal_conv1d(p["conv_C"], Cc, cs.get("C"))
    xb, Bc, Cc = F.silu(xb), F.silu(Bc), F.silu(Cc)

    Bt, T = xb.shape[0], xb.shape[1]
    di = xb.shape[-1]               # this rank's inner width
    H = di // P                     # and heads
    xh = xb.reshape(Bt, T, H, P)
    Bm = _local_groups(Bc.reshape(Bt, T, G, N), H, cfg.ssd_heads, parallel)
    Cm = _local_groups(Cc.reshape(Bt, T, G, N), H, cfg.ssd_heads, parallel)
    dt = F.softplus(dt.float() + p["dt_bias"])  # (B,T,H)
    A = -torch.exp(p["A_log"].float())  # (H,)

    if cache is not None and T == 1:  # decode
        y, S_last = ssd_step(xh, dt, A, Bm, Cm, cache["S"])
    else:  # sequence mode, or a prefill from zero state
        y, S_last = ssd_chunked(xh, dt, A, Bm, Cm, s.chunk)
    if cache is not None:
        cache["S"].copy_(S_last)
        cs["x"].copy_(st_x)
        cs["B"].copy_(st_b)
        cs["C"].copy_(st_c)

    y = y + p["D"][None, None, :, None] * xh  # skip connection
    y = y.reshape(Bt, T, di)
    y = _gated_norm(y, z, p["norm_w"], eps, parallel)
    out = _row_proj(y, p["w_out"], parallel, 1)
    return x + out, cache
