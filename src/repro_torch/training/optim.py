"""Optimizers, functional over parameter trees (no torch.optim).

- `adamw`: AdamW with fp32 m/v, decoupled weight decay, global gradient
  norm clipping, any learning-rate schedule.
- `adafactor`: factored second moments (rows / columns) for leaves of 2
  or more axes, no first moment: the memory-frugal choice.
- `mixed_precision`: live params in their own dtype, an fp32 master copy
  in the optimizer state.

As in the reference, `init(params)` returns a state tree and
`update(grads, state, params, step)` returns (new_params, new_state,
metrics) without touching its inputs, so a checkpoint of the train state
holds the reference's leaves. Schedules and scalars are 0-d fp32 tensors
on the step's device, computed in the reference's order, so nothing is
read back to the host.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from repro_torch.models.params import (Packed, tree_leaves_sorted, tree_map,
                                       unpack)


class Optimizer(NamedTuple):
    init: Callable          # params -> opt_state
    update: Callable        # (grads, opt_state, params, step) -> (new_params, new_opt_state, metrics)


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


def global_norm(tree):
    leaves = [torch.sum(torch.square(x.float()))
              for x in tree_leaves_sorted(tree)]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def clip_by_global_norm(tree, max_norm: float):
    gn = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return tree_map(lambda x: x.float() * scale, tree), gn


def mixed_precision(inner: Optimizer) -> Optimizer:
    """Live params in their own dtype (bf16 or fp32) and an fp32 master
    copy in the state, which the inner optimizer updates."""

    def init(params):
        master = tree_map(lambda p: p.float(), params)
        return {"master": master, "inner": inner.init(params)}

    def update(grads, state, params, step):
        g32 = tree_map(lambda g: g.float(), grads)
        new_master, new_inner, metrics = inner.update(
            g32, state["inner"], state["master"], step)
        new_params = tree_map(lambda m, p: m.to(p.dtype), new_master, params)
        return new_params, {"master": new_master, "inner": new_inner}, metrics

    return Optimizer(init, update)


def adamw(lr_schedule, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1, clip_norm: float = 1.0) -> Optimizer:
    def init(params):
        def zeros(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params)}

    def update(grads, state, params, step):
        grads, gn = clip_by_global_norm(grads, clip_norm)
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

    return Optimizer(init, update)


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

    def update(grads, state, params, step):
        stepf = _f32(step, step) + 1.0
        beta2 = 1.0 - torch.pow(stepf, -decay_pow)
        lr = lr_schedule(step)

        def upd(g, v, p):
            g = g.float()
            g2 = torch.square(g) + eps2
            if _factored(p):
                vr = beta2 * v["vr"] + (1 - beta2) * torch.mean(g2, dim=-1)
                vc = beta2 * v["vc"] + (1 - beta2) * torch.mean(g2, dim=-2)
                denom = torch.clamp(torch.mean(vr, dim=-1, keepdim=True),
                                    min=eps2)
                u = (g * torch.rsqrt(vr / denom)[..., None]
                     * torch.rsqrt(vc)[..., None, :])
                new_v = {"vr": vr, "vc": vc}
            else:
                vv = beta2 * v["v"] + (1 - beta2) * g2
                u = g * torch.rsqrt(vv)
                new_v = {"v": vv}
            # RMS clip.
            rms_u = torch.sqrt(torch.mean(torch.square(u)) + 1e-30)
            u = u / torch.clamp(rms_u / clip_threshold, min=1.0)
            pf = p.float()
            scale = torch.clamp(
                torch.sqrt(torch.mean(torch.square(pf)) + 1e-30), min=1e-3)
            new_p = pf - lr * scale * u - lr * weight_decay * pf
            return Packed(new_p.to(p.dtype), new_v)

        # grads' structure drives the map; the state subtree ({"vr","vc"}
        # or {"v"}) at each grad leaf is passed whole to upd.
        flat = tree_map(upd, grads, state["v"], params)
        return unpack(flat, 0), {"v": unpack(flat, 1)}, {"lr": lr}

    return Optimizer(init, update)
