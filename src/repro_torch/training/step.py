"""Train step: loss, gradients, optimizer update.

The train state is {"params", "opt", "step"} (step a 0-d int32 tensor),
as in the reference. The forward runs in `cfg.compute_dtype`;
gradients come from `torch.autograd.grad` over the parameter leaves.
The step reads nothing back to the host: its metrics stay 0-d tensors
on the device.

The Pallas kernels of the reference have no VJP, and the port's kernels
no backward, so training runs the plain attention (`attn_impl` "auto",
"naive" or "chunked") on float weights; `kernels.ops` raises where a
kernel would be differentiated.

parallel= (a `make_parallel(mesh, "train")` config; every block kind):
the state is this rank's shards (`sharding.shard_tree` by
`tree_specs(train_state_logical_axes(...))`), the batch the whole
batch on every rank. Each data rank's loss is its own rows' mean,
replicated over `model`; autograd differentiates the forward's
collectives, then each grad leaf is summed over the mesh axes on which
ranks computed different parts of it (`models.model.grad_sync_axes`)
and divided by the data ranks' count once, so the grads are those of
the global mean loss. The loss and metrics are the means over the data
ranks. Loss, grads and the updated state equal the unsharded step's up
to the order of the sums, except the MoE's load-balance term: each
data rank adds its own rows' (moe_mode ep / tp), so the step's is their
mean over the data ranks, as in the reference's sharded step (f * P is
not linear in the rows; in ep2d / tp2d each rank's is the whole
batch's)."""

from __future__ import annotations

import torch

from repro_torch.models import forward
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import data_rows, grad_sync_axes
from repro_torch.models.params import (abstract_params, param_logical_axes,
                                       tree_leaves, tree_map)
from repro_torch.sharding import SCALAR_AXES, all_reduce, tree_specs
from repro_torch.training.optim import Layout
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
                 z_weight: float = 0.0, *, parallel=None):
    """(params, batch) -> (total, {"loss", "aux_loss"}). parallel: this
    data rank's rows' loss and its own aux_loss (see the module
    docstring)."""
    compute = dtype_of(cfg.compute_dtype)
    if parallel is not None and parallel.profile != "train":
        raise ValueError(f"profile {parallel.profile!r}: a train step "
                         f"takes make_parallel(mesh, 'train')")

    def loss_fn(params, batch):
        cparams = cast_floating(params, compute)
        logits, extras = forward(cparams, batch["inputs"], cfg,
                                 parallel=parallel)
        labels = batch["labels"]
        if parallel is not None:
            labels = labels[data_rows(parallel, labels.shape[0])]
        loss = cross_entropy(logits, labels, z_weight)
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


def sync_grads(grads, axes_tree, parallel):
    """Each grad leaf summed over its mesh axes (`axes_tree`, a tree of
    axis tuples with grads' structure), in its own memory layout (a
    reduction's bits depend on it). Every rank walks the tree in the
    same order."""
    def summed(g, axes):
        if not axes:
            return g
        s = all_reduce(g.contiguous(), parallel, axes)
        return s if s is g else torch.empty_like(g).copy_(s)
    return tree_map(summed, grads, axes_tree)


def make_grad_fn(cfg: ModelConfig, aux_weight: float = 0.01, *,
                 parallel=None):
    """(params, batch) -> ((total, metrics), grads). parallel: the
    grads synced and scaled to the global mean loss's, the total and
    metrics averaged over the data ranks (outside autograd)."""
    loss_fn = make_loss_fn(cfg, aux_weight, parallel=parallel)

    def grad_fn(params, batch):
        (total, metrics), grads = value_and_grad(loss_fn, params, batch)
        if parallel is None:
            return (total, metrics), grads
        dp = parallel.dp_size
        grads = sync_grads(grads, grad_sync_axes(
            cfg, parallel, batch["inputs"].shape[1]), parallel)
        names = sorted(metrics)
        means = all_reduce(torch.stack([total] + [metrics[k] for k in names]),
                           parallel, parallel.data_axes)
        if dp > 1:
            grads = tree_map(lambda g: g.div_(dp), grads)
            means = means / dp
        return ((means[0], {k: means[i + 1] for i, k in enumerate(names)}),
                grads)

    return grad_fn


def make_train_step(cfg: ModelConfig, optimizer, aux_weight: float = 0.01,
                    *, parallel=None):
    """(state, batch) -> (new_state, metrics). parallel: the state is
    this rank's shards, and the update reduces across them (its
    `Layout`)."""
    grad_fn = make_grad_fn(cfg, aux_weight, parallel=parallel)
    layout = () if parallel is None else (Layout(
        parallel, tree_specs(param_logical_axes(cfg), parallel, cfg)),)

    def train_step(state, batch):
        (total, metrics), grads = grad_fn(state["params"], batch)
        new_params, new_opt, om = optimizer.update(
            grads, state["opt"], state["params"], state["step"], *layout)
        metrics = dict(metrics, total_loss=total, **om)
        new_state = {"params": new_params, "opt": new_opt,
                     "step": state["step"] + 1}
        return new_state, metrics

    return train_step


def init_train_state(cfg: ModelConfig, optimizer, seed: int = 0,
                     device="cuda", parallel=None):
    """Params from `init_params(cfg, seed)` on `device` (the card by
    default), the optimizer's state, step 0. parallel: this rank's
    shards of that state (`shard_tree` of it by
    `train_state_logical_axes`), built without the whole state."""
    from repro_torch.models import init_params
    params = init_params(cfg, seed, device=device, parallel=parallel)
    return {"params": params, "opt": optimizer.init(params),
            "step": torch.zeros((), dtype=torch.int32,
                                device=params["embed"].device)}


def train_state_logical_axes(cfg: ModelConfig, optimizer):
    """The train state's logical sharding axes: the params', the
    optimizer state's (`optimizer.state_logical_axes`), the step's
    SCALAR_AXES."""
    axes = param_logical_axes(cfg)
    return {"params": axes, "opt": optimizer.state_logical_axes(axes),
            "step": SCALAR_AXES}


def abstract_train_state(cfg: ModelConfig, optimizer):
    """The train state as meta tensors (params in cfg.param_dtype, the
    optimizer's state, the step): shapes and dtypes, no storage."""
    params = abstract_params(cfg)
    return {"params": params, "opt": optimizer.init(params),
            "step": torch.empty((), dtype=torch.int32, device="meta")}
