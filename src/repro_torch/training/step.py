"""Train step: loss, gradients, optimizer update.

The train state is {"params", "opt", "step"} (step a 0-d int32 tensor),
as in the reference. The forward runs in `cfg.compute_dtype`;
gradients come from `torch.autograd.grad` over the parameter leaves.
The step reads nothing back to the host: its metrics stay 0-d tensors
on the device.

The Pallas kernels of the reference have no VJP, and the port's kernels
no backward, so training runs the plain attention (`attn_impl` "auto",
"naive" or "chunked") on float weights; `kernels.ops` raises where a
kernel would be differentiated."""

from __future__ import annotations

import torch

from repro_torch.models import forward
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import tree_leaves, tree_map
from repro_torch.utils import dtype_of


def cast_floating(tree, dtype):
    return tree_map(lambda x: x.to(dtype) if x.is_floating_point() else x,
                    tree)


def cross_entropy(logits, labels, z_weight: float = 0.0):
    """logits: (B,T,V) fp32; labels: (B,T) int. Mean token NLL.

    The gold logit is a gather (the reference contracts a one-hot, which
    gives the same sum, but at a large vocabulary builds a (B,T,V)
    tensor)."""
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    loss = (lse - gold).mean()
    if z_weight:
        loss = loss + z_weight * torch.square(lse).mean()
    return loss


def make_loss_fn(cfg: ModelConfig, aux_weight: float = 0.01,
                 z_weight: float = 0.0):
    compute = dtype_of(cfg.compute_dtype)

    def loss_fn(params, batch):
        cparams = cast_floating(params, compute)
        logits, extras = forward(cparams, batch["inputs"], cfg)
        loss = cross_entropy(logits, batch["labels"], z_weight)
        total = loss + aux_weight * extras["aux_loss"]
        return total, {"loss": loss, "aux_loss": extras["aux_loss"]}

    return loss_fn


def value_and_grad(loss_fn, params, batch):
    """((total, metrics), grads): grads has params' structure, float
    leaves only differentiated (a leaf the loss does not reach gets
    zeros, as in JAX). The caller's tensors are not marked."""
    with torch.enable_grad():
        ps = tree_map(lambda p: p.detach().requires_grad_(
            p.is_floating_point()), params)
        total, metrics = loss_fn(ps, batch)
        leaves = [p for p in tree_leaves(ps) if p.requires_grad]
        got = iter(torch.autograd.grad(total, leaves, allow_unused=True))

    def grad(p):
        if not p.requires_grad:
            return torch.zeros_like(p)
        g = next(got)
        return torch.zeros_like(p) if g is None else g
    grads = tree_map(grad, ps)
    metrics = {k: v.detach() for k, v in metrics.items()}
    return (total.detach(), metrics), grads


def make_train_step(cfg: ModelConfig, optimizer, aux_weight: float = 0.01):
    loss_fn = make_loss_fn(cfg, aux_weight)

    def train_step(state, batch):
        (total, metrics), grads = value_and_grad(loss_fn, state["params"],
                                                 batch)
        new_params, new_opt, om = optimizer.update(
            grads, state["opt"], state["params"], state["step"])
        metrics = dict(metrics, total_loss=total, **om)
        new_state = {"params": new_params, "opt": new_opt,
                     "step": state["step"] + 1}
        return new_state, metrics

    return train_step


def init_train_state(cfg: ModelConfig, optimizer, seed: int = 0,
                     device="cuda"):
    """Params from `init_params(cfg, seed)` on `device` (the card by
    default), the optimizer's state, step 0."""
    from repro_torch.models import init_params
    params = init_params(cfg, seed, device=device)
    return {"params": params, "opt": optimizer.init(params),
            "step": torch.zeros((), dtype=torch.int32,
                                device=params["embed"].device)}
