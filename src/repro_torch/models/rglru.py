"""RecurrentGemma block on torch tensors: temporal conv + RG-LRU linear
recurrence (after `repro/models/rglru.py`).

Recurrence (Griffin, arXiv:2402.19427):
    r_t = sigmoid(x_t W_a + b_a)            (recurrence gate)
    i_t = sigmoid(x_t W_x + b_x)            (input gate)
    log a_t = -c * softplus(Lambda) * r_t   (per-channel decay)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

Sequence mode runs the recurrence as a scan over (a, b) pairs, which
compose associatively: (a2, b2) o (a1, b1) = (a1*a2, a2*b1 + b2). The
reference's `lax.associative_scan` becomes a log-depth doubling scan
(Hillis-Steele): ceil(log2 T) elementwise passes over the whole
sequence, so a prefill is a fixed, short list of launches that a CUDA
graph captures, where a T-step loop would record T steps' launches. A
cumulative product of `a` is no substitute: it underflows as `a`
decays. Decode mode is the O(1) single-step update. The state `h` stays
fp32, as in the reference.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import _proj, act_fn, mlp, rms_norm
from repro_torch.sharding import all_gather


def _gates(p, x, cfg: ModelConfig, x_in=None):
    """The recurrence's (a, b) of x (B, T, W). x_in: the whole width of
    x that the gate projections w_a and w_x read, where x is this rank's
    width slice (their columns are its gates); None: x itself."""
    c = cfg.rglru.c
    x_in = x if x_in is None else x_in
    r = torch.sigmoid(_proj(x_in, p["w_a"]) + p["b_a"])
    i = torch.sigmoid(_proj(x_in, p["w_x"]) + p["b_x"])
    log_a = -c * F.softplus(p["lam"]) * r.float()
    a = torch.exp(log_a)
    gated_x = i * x
    # sqrt(1 - a^2) normalizer, computed stably in fp32.
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    b = beta * gated_x.float()
    return a, b


def _doubling_scan(a, b):
    """h_t = a_t * h_{t-1} + b_t with h_{-1} = 0, along axis 1, in
    ceil(log2 T) passes: after the pass at distance d, (a_t, b_t) holds
    the composition of steps max(0, t-2d+1) .. t."""
    T = a.shape[1]
    d = 1
    while d < T:
        b = torch.cat([b[:, :d], torch.addcmul(b[:, d:], a[:, d:],
                                               b[:, :-d])], dim=1)
        a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return b


def rglru_scan(p, x, cfg: ModelConfig, h0=None, x_in=None):
    """x: (B,T,W). Returns (y, h_last): the linear recurrence over the
    sequence from state h0 (zeros when None). x_in: as in `_gates`."""
    a, b = _gates(p, x, cfg, x_in)
    if h0 is not None:
        # Fold the incoming state into the first step: b_0 += a_0 * h0.
        b = torch.cat([(b[:, 0] + a[:, 0] * h0.float())[:, None], b[:, 1:]],
                      dim=1)
    h = _doubling_scan(a, b)
    return h.to(x.dtype), h[:, -1]


def rglru_step(p, x, cfg: ModelConfig, h, x_in=None):
    """x: (B,1,W); h: (B,W) fp32 state. Returns (y, h_new). x_in: as in
    `_gates`."""
    a, b = _gates(p, x, cfg, x_in)
    h_new = a[:, 0] * h + b[:, 0]
    return h_new[:, None].to(x.dtype), h_new


def causal_conv1d(w, x, state=None):
    """Depthwise causal conv as the reference's shift-and-sum.
    x: (B,T,C); w: (C,K). state: (B,K-1,C) prior inputs for decode.
    Returns (y, new_state)."""
    K = w.shape[1]
    if state is None:
        pad = torch.zeros((x.shape[0], K - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)  # (B, T+K-1, C)
    T = x.shape[1]
    y = sum(xp[:, i:i + T] * w[:, i] for i in range(K))
    new_state = xp[:, -(K - 1):] if K > 1 else pad
    return y, new_state


def rglru_block(p, x, cfg: ModelConfig, cache=None, parallel=None):
    """Full recurrentgemma residual block (mixer + MLP).

    cache: None (sequence mode) or {"h": (B,W) fp32, "conv": (B,K-1,W)},
    a layer's views into the model's cache. With a cache, T == 1 is a
    decode step from the cached state and T > 1 a prefill from a zero
    state (the reference ignores the incoming state there); both write
    the new state into the cache tensors in place.
    parallel: a `sharding.ParallelConfig` (serve profile): p and the
    cache hold this rank's slice of the recurrence width (`rnn_width`
    over the model axis): its columns of w_gate_branch, w_in, w_a, w_x,
    its channels of the conv, the gate biases, Lambda, h, and its rows
    of w_out. The gate projections read the whole width (their rows are
    `rnn_in`, whole), so each rank gathers the conv output over the
    model axis and gates its own slice; w_out and the MLP's w_down sum
    over the model axis. Returns (x_out, cache)."""
    eps = cfg.norm_eps
    h = rms_norm(x, p["ln1"], eps)
    gate = act_fn("gelu")(_proj(h, p["w_gate_branch"]))
    u = _proj(h, p["w_in"])
    decode = cache is not None and x.shape[1] == 1
    u, conv_state = causal_conv1d(p["conv_w"], u,
                                  cache["conv"] if decode else None)
    u_in = None if parallel is None else all_gather(
        u, parallel, parallel.tp_axis, u.ndim - 1)
    if decode:
        y, h_last = rglru_step(p, u, cfg, cache["h"], u_in)
    else:  # a sequence, or a prefill: the scan from a zero state
        y, h_last = rglru_scan(p, u, cfg, x_in=u_in)
    if cache is not None:
        cache["h"].copy_(h_last)
        cache["conv"].copy_(conv_state)
    out = _proj(y * gate, p["w_out"], parallel)
    x = x + out

    h = rms_norm(x, p["ln2"], eps)
    x = x + mlp(p["mlp"], h, cfg, parallel)
    return x, cache
