"""Optimizers, functional over parameter trees (no torch.optim).

- `adamw`: AdamW with fp32 m/v, decoupled weight decay, global gradient
  norm clipping, any learning-rate schedule.
- `adafactor`: factored second moments (rows / columns) for leaves of 2
  or more axes, no first moment: the memory-frugal choice.
- `mixed_precision`: live params in their own dtype, an fp32 master copy
  in the optimizer state.

As in the reference, `init(params)` returns a state tree,
`update(grads, state, params, step)` returns (new_params, new_state,
metrics) without touching its inputs, so a checkpoint of the train state
holds the reference's leaves, and `state_logical_axes(param_axes)` the
state's logical axes, so it shards like (or factored from) its
parameters. Schedules and scalars are 0-d fp32 tensors on the step's
device, computed in the reference's order, so nothing is read back to
the host.

Sharded (the train profile): `update(..., layout)` takes this rank's
shards of grads, state and params, and a `Layout` (the mesh and the
params' `sharding.Spec` tree). Every reduction across elements (the
global norm, Adafactor's row / column and whole-leaf means) is then a
local reduction plus an all_reduce over the mesh axes its dims are split
on, and only those; a dim over axes of size 1 is whole, so a one-rank
mesh computes the unsharded update's bits.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from repro_torch.models.params import (Packed, tree_leaves_sorted, tree_map,
                                       unpack)
from repro_torch.sharding import all_reduce, map_axes, split_axes


class Optimizer(NamedTuple):
    init: Callable          # params -> opt_state
    update: Callable        # (grads, opt_state, params, step[, layout]) -> (new_params, new_opt_state, metrics)
    state_logical_axes: Callable  # param_axes_tree -> state_axes_tree


class Layout(NamedTuple):
    """Where a sharded update's leaves live: the mesh (`parallel`, a
    `sharding.ParallelConfig`) and the params' Spec tree (`specs`)."""
    parallel: object
    specs: object


def _mean(x, dim: int, axes, parallel, keepdim: bool = False):
    """torch.mean over x's dim `dim`, that dim split over the mesh axes
    `axes` (each rank's sum, summed over them)."""
    if not axes:
        return torch.mean(x, dim=dim, keepdim=keepdim)
    s = all_reduce(torch.sum(x, dim=dim, keepdim=keepdim), parallel, axes)
    return s / (x.shape[dim] * math.prod(parallel.sizes[a] for a in axes))


def _mean_all(x, axes, parallel):
    """torch.mean over every element of a leaf split over `axes`."""
    if not axes:
        return torch.mean(x)
    s = all_reduce(torch.sum(x), parallel, axes)
    return s / (x.numel() * math.prod(parallel.sizes[a] for a in axes))


def _f32(x, like=None):
    device = like.device if isinstance(like, torch.Tensor) else None
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def cosine_schedule(base_lr: float, warmup: int, total: int,
                    min_frac: float = 0.1):
    def lr(step):
        step = _f32(step, step)
        warm = base_lr * step / max(warmup, 1)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = base_lr * (min_frac + (1 - min_frac) * 0.5
                         * (1 + torch.cos(math.pi * prog)))
        return torch.where(step < warmup, warm, cos)
    return lr


def constant_schedule(base_lr: float):
    return lambda step: _f32(base_lr, step)


def global_norm(tree, layout=None):
    """sqrt of the sum of squares over every leaf, in the reference's
    leaf order. layout: each leaf's sum of squares summed over the axes
    it is split on (one all_reduce for each set of axes)."""
    if layout is None:
        leaves = [torch.sum(torch.square(x.float()))
                  for x in tree_leaves_sorted(tree)]
        return torch.sqrt(torch.sum(torch.stack(leaves)))
    pairs = tree_leaves_sorted(tree_map(Packed, tree, layout.specs))
    leaves = [torch.sum(torch.square(pk.vals[0].float())) for pk in pairs]
    by_axes = {}
    for i, pk in enumerate(pairs):
        axes = split_axes(pk.vals[1], layout.parallel.sizes)
        if axes:
            by_axes.setdefault(axes, []).append(i)
    for axes, idx in by_axes.items():
        sums = all_reduce(torch.stack([leaves[i] for i in idx]),
                          layout.parallel, axes)
        for k, i in enumerate(idx):
            leaves[i] = sums[k]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def clip_by_global_norm(tree, max_norm: float, layout=None):
    gn = global_norm(tree, layout)
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return tree_map(lambda x: x.float() * scale, tree), gn


def mixed_precision(inner: Optimizer) -> Optimizer:
    """Live params in their own dtype (bf16 or fp32) and an fp32 master
    copy in the state, which the inner optimizer updates."""

    def init(params):
        master = tree_map(lambda p: p.float(), params)
        return {"master": master, "inner": inner.init(params)}

    def update(grads, state, params, step, layout=None):
        g32 = tree_map(lambda g: g.float(), grads)
        new_master, new_inner, metrics = inner.update(
            g32, state["inner"], state["master"], step, layout)
        new_params = tree_map(lambda m, p: m.to(p.dtype), new_master, params)
        return new_params, {"master": new_master, "inner": new_inner}, metrics

    def state_logical_axes(param_axes):
        return {"master": param_axes,
                "inner": inner.state_logical_axes(param_axes)}

    return Optimizer(init, update, state_logical_axes)


def adamw(lr_schedule, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1, clip_norm: float = 1.0) -> Optimizer:
    def init(params):
        def zeros(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params)}

    def update(grads, state, params, step, layout=None):
        grads, gn = clip_by_global_norm(grads, clip_norm, layout)
        stepf = _f32(step, step) + 1.0
        lr = lr_schedule(step)
        bc1 = 1.0 - torch.pow(b1, stepf)
        bc2 = 1.0 - torch.pow(b2, stepf)

        def upd(g, m, v, p):
            m = b1 * m + (1 - b1) * g
            v = b2 * v + (1 - b2) * torch.square(g)
            mhat = m / bc1
            vhat = v / bc2
            pf = p.float()
            new_p = pf - lr * (mhat / (torch.sqrt(vhat) + eps)
                               + weight_decay * pf)
            return Packed(new_p.to(p.dtype), m, v)

        flat = tree_map(upd, grads, state["m"], state["v"], params)
        return (unpack(flat, 0),
                {"m": unpack(flat, 1), "v": unpack(flat, 2)},
                {"grad_norm": gn, "lr": lr})

    def state_logical_axes(param_axes):
        return {"m": param_axes, "v": param_axes}

    return Optimizer(init, update, state_logical_axes)


def adafactor(lr_schedule, eps2: float = 1e-30, clip_threshold: float = 1.0,
              decay_pow: float = 0.8, weight_decay: float = 0.0,
              min_dim_factored: int = 2) -> Optimizer:
    """Adafactor (Shazeer & Stern 2018), beta1 = 0."""

    def _factored(p):
        return p.ndim >= min_dim_factored

    def init(params):
        def st(p):
            f32 = dict(dtype=torch.float32, device=p.device)
            if _factored(p):
                return {"vr": torch.zeros(p.shape[:-1], **f32),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                          **f32)}
            return {"v": torch.zeros(p.shape, **f32)}
        return {"v": tree_map(st, params)}

    def update(grads, state, params, step, layout=None):
        stepf = _f32(step, step) + 1.0
        beta2 = 1.0 - torch.pow(stepf, -decay_pow)
        lr = lr_schedule(step)
        par = None if layout is None else layout.parallel

        def upd(g, v, p, spec=None):
            # The mesh axes (of more than one rank) p's dim d is split
            # on; every dim's for the whole-leaf means.
            def on(d=None):
                if spec is None:
                    return ()
                return split_axes(spec, par.sizes,
                                  None if d is None else d % p.ndim)
            g = g.float()
            g2 = torch.square(g) + eps2
            if _factored(p):
                vr = beta2 * v["vr"] + (1 - beta2) * _mean(g2, -1, on(-1),
                                                           par)
                vc = beta2 * v["vc"] + (1 - beta2) * _mean(g2, -2, on(-2),
                                                           par)
                # vr's last dim is p's dim -2.
                denom = torch.clamp(_mean(vr, -1, on(-2), par, keepdim=True),
                                    min=eps2)
                u = (g * torch.rsqrt(vr / denom)[..., None]
                     * torch.rsqrt(vc)[..., None, :])
                new_v = {"vr": vr, "vc": vc}
            else:
                vv = beta2 * v["v"] + (1 - beta2) * g2
                u = g * torch.rsqrt(vv)
                new_v = {"v": vv}
            # RMS clip.
            rms_u = torch.sqrt(_mean_all(torch.square(u), on(), par) + 1e-30)
            u = u / torch.clamp(rms_u / clip_threshold, min=1.0)
            pf = p.float()
            scale = torch.clamp(torch.sqrt(
                _mean_all(torch.square(pf), on(), par) + 1e-30), min=1e-3)
            new_p = pf - lr * scale * u - lr * weight_decay * pf
            return Packed(new_p.to(p.dtype), new_v)

        # grads' structure drives the map; the state subtree ({"vr","vc"}
        # or {"v"}) at each grad leaf is passed whole to upd, and so is
        # its Spec.
        specs = () if layout is None else (layout.specs,)
        flat = tree_map(upd, grads, state["v"], params, *specs)
        return unpack(flat, 0), {"v": unpack(flat, 1)}, {"lr": lr}

    def state_logical_axes(param_axes):
        def st(axes):
            # Mirror the factoring: vr drops the last logical axis, vc the
            # second-to-last.
            if len(axes) >= min_dim_factored:
                return {"vr": axes[:-1], "vc": axes[:-2] + axes[-1:]}
            return {"v": axes}
        return {"v": map_axes(st, param_axes)}

    return Optimizer(init, update, state_logical_axes)
