"""Mixture-of-Experts FFN: the reference's unsharded (dense) path.

Every expert runs on every token, and the renormalized top-k router
probabilities combine them (the reference's `moe_ffn_dense`). The
shapes are static and nothing is read back to the host: the routing is
a (T, E) weight tensor, not a dispatch, so no token is dropped and a
CUDA graph captures the block whatever the router picks.

The reference builds the (T, E, d) tensor of every expert's output and
then weights it by the combine weights. Here the weights scale each
expert's activations before its down projection, one expert at a time
into one (T, d) sum: the same linear function, rounded in another
order, with no (T, E, f) or (T, E, d) tensor (at 2048 tokens of
qwen3-moe the reference's (T, E, d) tensor is 4.3 GB in fp32).

The sharded path (`moe_ffn_sharded`: expert or ff-slice parallelism
over a mesh) is not ported (ROADMAP queue 1 item 3.1), and int8 experts
do not compute, as in the reference."""

from __future__ import annotations

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import act_fn


def router_topk(p, x2d, cfg: ModelConfig):
    """x2d: (T, d). Returns (vals (T, k), idx (T, k), probs (T, E) fp32):
    the top-k probabilities renormalized to sum to 1."""
    logits = x2d.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.topk(probs, cfg.moe.top_k, dim=-1)
    vals = vals / torch.clamp(vals.sum(-1, keepdim=True), min=1e-9)
    return vals, idx, probs


def _experts(p, key):
    """The E experts' weights of one leaf, each a view (unbound once, so
    the backward stacks their grads in one pass)."""
    w = p[key]
    if isinstance(w, dict):
        raise TypeError(
            f"MoE expert leaf {key!r} is an int8 {{'q', 'scale'}} leaf: the "
            f"experts compute in float only. The reference does not compute "
            f"int8 experts either (its moe_ffn_dense feeds the leaf to "
            f"jnp.einsum, which fails); quantize the attention projections "
            f"alone or serve the float tree")
    return torch.unbind(w, 0)


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


def moe_block_ffn(p, x, cfg: ModelConfig, parallel=None):
    if parallel is not None:
        raise NotImplementedError(
            "the sharded MoE path (moe_ffn_sharded over a mesh) is not "
            "ported (ROADMAP queue 1 item 3.1); call it with parallel=None")
    return moe_ffn_dense(p, x, cfg)
