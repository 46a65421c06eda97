"""Mixture-of-Experts FFN: the reference's two paths.

- **dense** (`moe_ffn_dense`, no mesh): every expert runs on every
  token, and the renormalized top-k router probabilities combine them.
  The shapes are static and nothing is read back to the host: the
  routing is a (T, E) weight tensor, not a dispatch, so no token is
  dropped and a CUDA graph captures the block whatever the router
  picks. The reference builds the (T, E, d) tensor of every expert's
  output and then weights it by the combine weights. Here the weights
  scale each expert's activations before its down projection, one
  expert at a time into one (T, d) sum: the same linear function,
  rounded in another order, with no (T, E, f) or (T, E, d) tensor (at
  2048 tokens of qwen3-moe the reference's (T, E, d) tensor is 4.3 GB
  in fp32).

- **sharded** (`moe_ffn_sharded`, under a `sharding.ParallelConfig`):
  expert parallelism without any all_to_all, on each rank's shards with
  explicit collectives. The activations reach the FFN replicated over
  the model axis, so every model rank holds all of its data shard's
  tokens. It dispatches them to its local experts through a
  capacity-bounded buffer (the Mesh-TF position-in-expert cumsum; a
  pair past an expert's capacity C is dropped), runs a grouped FFN,
  combines, and a closing sum over the model axis adds the ranks'
  contributions. Four weight layouts (`moe_weight_specs`): ep (experts
  over model) and tp (an ff slice of every expert over model) gather
  each layer's weights over the FSDP axes (ZeRO-3); ep2d and tp2d keep
  the weights where they are (ff over the data axes too) and move the
  activations: x is gathered over the data axes and the output summed
  and scattered back over them.

  The combine is deterministic: each (token, choice) pair keeps its
  slot in the buffer (or the dump slot past its end), and each token
  sums its k rows in choice order. The reference's scatter-add of the
  buffer onto the tokens would be atomics on the card, whose order
  varies from run to run.

  A batch axis that holds no ff shard (the pod axis: the FSDP axes are
  data only) gives each rank its block of rows back after ep2d / tp2d,
  where the reference's `psum_scatter` over every batch axis would add
  the pod ranks' copies of the same ff partial sums and count them
  twice; this departs from the reference on purpose, and a pod mesh at
  ample capacity computes the dense FFN.

  A batch that does not divide the data axes stays whole on every rank
  (`models.model.forward` then hands the blocks a ParallelConfig whose
  `data_axes` is empty): ep2d / tp2d gather nothing, sum their ff
  partials over the FSDP axes instead of scattering them, and the aux
  loss is not averaged over data. The reference never meets this case
  (GSPMD pads the batch).

int8 experts do not compute, as in the reference."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import _autograd_path, _fsdp, act_fn
from repro_torch.sharding import (Spec, all_reduce, copy_to_split,
                                  gather_to_shared, gather_to_split,
                                  moe_mode_for, scatter_to_split,
                                  sum_to_shared)


def router_topk(p, x2d, cfg: ModelConfig):
    """x2d: (T, d). Returns (vals (T, k), idx (T, k), probs (T, E) fp32):
    the top-k probabilities renormalized to sum to 1."""
    logits = x2d.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.topk(probs, cfg.moe.top_k, dim=-1)
    vals = vals / torch.clamp(vals.sum(-1, keepdim=True), min=1e-9)
    return vals, idx, probs


def _float_leaf(p, key):
    """The (E, ...) expert leaf `key`; an int8 leaf raises."""
    w = p[key]
    if isinstance(w, dict):
        raise TypeError(
            f"MoE expert leaf {key!r} is an int8 {{'q', 'scale'}} leaf: the "
            f"experts compute in float only. The reference does not compute "
            f"int8 experts either (its moe_ffn_dense feeds the leaf to "
            f"jnp.einsum, which fails); quantize the attention projections "
            f"alone or serve the float tree")
    return w


def _experts(p, key):
    """The E experts' weights of one leaf, each a view (unbound once, so
    the backward stacks their grads in one pass)."""
    return torch.unbind(_float_leaf(p, key), 0)


def moe_ffn_dense(p, x, cfg: ModelConfig):
    """(B, T, d) -> ((B, T, d), aux_loss): every expert for every token,
    combined with the (T, E) weights that a scatter-add of the top-k
    values builds."""
    m = cfg.moe
    B, T, d = x.shape
    x2 = x.reshape(B * T, d)
    vals, idx, probs = router_topk(p, x2, cfg)
    comb = torch.zeros((B * T, m.n_experts), dtype=torch.float32,
                       device=x.device).scatter_add(1, idx, vals)
    act = act_fn(cfg.mlp_act)
    gate, up, down = (_experts(p, k) for k in ("w_gate", "w_up", "w_down"))
    dt = torch.promote_types(x.dtype, gate[0].dtype)
    xd, cw = x2.to(dt), comb.to(dt)
    out = torch.zeros((B * T, d), dtype=dt, device=x.device)
    for e in range(m.n_experts):
        h = act(xd @ gate[e]) * (xd @ up[e])
        out = torch.addmm(out, h * cw[:, e:e + 1], down[e])
    aux = _load_balance_loss(comb, probs, m.n_experts)
    return out.reshape(B, T, d).to(x.dtype), aux


def _load_balance_loss(comb, probs, E):
    """Switch-transformer load-balance loss: E * sum_e f_e * P_e, f_e the
    share of tokens routed to expert e, P_e its mean probability."""
    f = (comb > 0).float().mean(0)
    pbar = probs.mean(0)
    return E * torch.sum(f * pbar)


def _dispatch_slots(idx, E_loc: int, off: int, C: int):
    """(T * k,) int64: each (token, choice) pair's slot in this rank's
    (E_loc * C) dispatch buffer, local expert e's pairs at e * C + their
    position among its pairs (in token-major order), or E_loc * C (the
    dump slot past the end) for a pair routed to another rank's expert
    or past its expert's capacity C. Static shapes, no host read."""
    flat_e = idx.reshape(-1) - off
    valid = (flat_e >= 0) & (flat_e < E_loc)
    one_hot = F.one_hot(torch.where(valid, flat_e, E_loc),
                        E_loc + 1)[:, :E_loc].to(torch.int32)
    # Exclusive count of the pairs before this one at its expert.
    pos = torch.cumsum(one_hot, 0, dtype=torch.int32) - one_hot
    my_pos = (pos * one_hot).sum(1)
    keep = valid & (my_pos < C)
    return torch.where(keep, torch.where(valid, flat_e, 0) * C + my_pos,
                       E_loc * C)


def _dispatch_bufs(slot, vals, T: int, size: int):
    """(idx_buf (size,) int32 token ids, gate_buf (size,) fp32 weights)
    of the slots: an empty slot holds token 0 with weight 0; the dump
    slot's writes land in one extra entry, which is dropped (the
    reference's mode="drop")."""
    k = slot.shape[0] // T
    flat_t = torch.arange(T, dtype=torch.int32, device=slot.device)
    flat_t = flat_t[:, None].expand(T, k).reshape(-1)
    idx_buf = torch.zeros(size + 1, dtype=torch.int32,
                          device=slot.device).scatter_(0, slot, flat_t)
    gate_buf = torch.zeros(size + 1, dtype=torch.float32,
                           device=slot.device).scatter_(
                               0, slot, vals.reshape(-1).float())
    return idx_buf[:size], gate_buf[:size]


def _dispatch_indices(idx, vals, E_loc: int, off: int, C: int):
    """Capacity-bounded dispatch bookkeeping of one rank (the
    reference's, bit for bit). idx / vals: (T, k) global expert ids and
    gate weights; experts [off, off + E_loc) are local. Returns
    (idx_buf (E_loc * C,) int32 token ids, gate_buf (E_loc * C,) fp32
    weights)."""
    slot = _dispatch_slots(idx, E_loc, off, C)
    return _dispatch_bufs(slot, vals, idx.shape[0], E_loc * C)


def moe_weight_specs(mode: str, tp, fsdp):
    """The expert weights' layouts of each mode, as (spec of w_gate and
    w_up (E, d, f), spec of w_down (E, f, d)); `tree_specs` lays the
    stored experts out the same way.

    - ep:   experts/tp, d/fsdp    + a per-layer FSDP gather of the weights
    - tp:   ff/tp, d/fsdp         + a per-layer FSDP gather (E < tp size)
    - ep2d: experts/tp, ff/fsdp   no weight moves; the activations are
            gathered over data instead (decode: x is tiny, weights huge)
    - tp2d: ff/(fsdp x tp)        no weight moves (decode, E < tp size)
    """
    if mode == "ep":
        return Spec(tp, fsdp, None), Spec(tp, None, fsdp)
    if mode == "tp":
        return Spec(None, fsdp, tp), Spec(None, tp, fsdp)
    if mode == "ep2d":
        return Spec(tp, None, fsdp), Spec(tp, fsdp, None)
    if mode == "tp2d":
        both = tuple(fsdp) + (tp,)
        return Spec(None, None, both), Spec(None, both, None)
    raise ValueError(mode)


def capacity(T_tok: int, m) -> int:
    """Slots an expert takes of T_tok tokens: the reference's
    ceil(T_tok * top_k / E * capacity_factor), at least 1, at most
    T_tok."""
    C = max(1, math.ceil(T_tok * m.top_k / m.n_experts * m.capacity_factor))
    return min(C, T_tok)


def moe_ffn_sharded(p, x, cfg: ModelConfig, parallel):
    """(B_loc, T, d) -> ((B_loc, T, d), aux_loss) on this rank's expert
    shards: x holds this rank's batch rows (split over
    `parallel.data_axes`, or the whole batch where that is empty),
    replicated over the model axis (under seq_shard "full" its block of
    T, gathered here: every model rank routes every token, as the
    reference's shard_map takes x whole over model; the output goes
    back as this rank's block of T).

    Every collective has a backward (`sharding.gather_to_split` ...);
    only the serve profile's closing sum is the in-place all_reduce.
    Every model rank runs the router on the same tokens, and its
    probabilities feed two things: the dispatch to this rank's experts (or ff slice), which is
    different work on each rank, and the load-balance loss, which every
    rank repeats. Only the dispatch's inputs (the buffer's token rows,
    the gate values) get a backward that sums over model; the router's
    and the aux loss's grads stay each rank's own (whole on every
    rank), where a sum at the block's entry would scale them by tp.
    The aux loss is each data rank's own under the train profile (the
    train step's mean over the data ranks averages it, and its metric);
    otherwise it is averaged over the batch axes here."""
    m = cfg.moe
    tp, fsdp = parallel.tp_axis, parallel.fsdp_axes
    data = parallel.data_axes
    mode = moe_mode_for(cfg, parallel)
    twod = mode.endswith("2d")
    # The serve profile's engine graphs capture its in-place all_reduce.
    summed = sum_to_shared if _autograd_path(parallel) else all_reduce
    gate, up, down = (_float_leaf(p, k) for k in ("w_gate", "w_up",
                                                  "w_down"))
    router = {"router": _fsdp(p["router"], parallel, 0)}
    if parallel.seq_shard:
        x = gather_to_shared(x, parallel, tp, 1)
    if twod:
        # Move the (small) activations, not the weights.
        x = gather_to_split(x, parallel, data, 0)
    else:
        # This layer's experts whole over the FSDP axes (ZeRO-3).
        gate, up = (gather_to_split(w, parallel, fsdp, 1)
                    for w in (gate, up))
        down = gather_to_split(down, parallel, fsdp, 2)
    B_loc, T, d = x.shape
    T_tok = B_loc * T
    x2 = x.reshape(T_tok, d)
    vals, idx, probs = router_topk(router, x2, cfg)
    # The dispatch's inputs: each model rank's own work.
    xd, vd = (copy_to_split(t, parallel, tp) for t in (x2, vals))
    if mode.startswith("ep"):
        E_loc = m.n_experts // parallel.tp_size
        off = parallel.index((tp,)) * E_loc
    else:
        E_loc, off = m.n_experts, 0
    C = capacity(T_tok, m)
    slot = _dispatch_slots(idx, E_loc, off, C)
    idx_buf, gate_buf = _dispatch_bufs(slot, vd, T_tok, E_loc * C)
    dt = torch.promote_types(x.dtype, gate.dtype)
    buf = xd.to(dt)[idx_buf.long()].reshape(E_loc, C, d)
    act = act_fn(cfg.mlp_act)
    h = act(torch.bmm(buf, gate.to(dt))) * torch.bmm(buf, up.to(dt))
    y = torch.bmm(h, down.to(dt)).reshape(E_loc * C, d)
    y = y * gate_buf[:, None].to(dt)
    # Each token's k rows (a zero row for a pair not here), summed in
    # choice order.
    y = torch.cat([y, y.new_zeros((1, d))])
    rows = y[slot.reshape(T_tok, -1)]             # (T_tok, k, d)
    out = rows[:, 0]
    for j in range(1, rows.shape[1]):
        out = out + rows[:, j]
    out = out.reshape(B_loc, T, d)
    if twod:
        # The ff partial sums: scattered back over the batch axes that
        # hold ff shards, summed over the rest of the FSDP axes; a batch
        # axis without an ff shard gives its rows back (every rank of it
        # computed the same partial sums: each keeps its own rows' grad).
        for a in data:
            if a in fsdp:
                out = scatter_to_split(out, parallel, a, 0)
            else:
                n = out.shape[0] // parallel.sizes[a]
                i = parallel.index((a,))
                out = out[i * n:(i + 1) * n]
        rest = tuple(a for a in fsdp if a not in data)
        if rest:
            out = summed(out, parallel, rest)
    if parallel.seq_shard:
        out = scatter_to_split(out, parallel, tp, 1)
    else:
        out = summed(out, parallel, tp)
    # The aux loss: each shard's tokens' (the same on every model rank).
    comb = torch.zeros((T_tok, m.n_experts), dtype=torch.float32,
                       device=x.device).scatter_add(1, idx, vals)
    aux = _load_balance_loss(comb, probs, m.n_experts)
    if data and parallel.profile != "train":
        n = math.prod(parallel.sizes[a] for a in data)
        aux = all_reduce(aux.reshape(1), parallel, data)[0] / n
    return out.to(x.dtype), aux


def moe_block_ffn(p, x, cfg: ModelConfig, parallel=None):
    """The dense path without a mesh, the sharded path under one."""
    if parallel is None:
        return moe_ffn_dense(p, x, cfg)
    return moe_ffn_sharded(p, x, cfg, parallel)
