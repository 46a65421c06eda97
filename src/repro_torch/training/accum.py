"""Gradient accumulation (microbatching): the batch is split into
`n_micro` microbatches run one after another, their gradients summed in
fp32 and divided by `n_micro`. Loss and grads equal the monolithic
step's up to the order of the sums, so it composes with every
optimizer."""

from __future__ import annotations

import torch

from repro_torch.models.params import tree_map
from repro_torch.training.step import make_loss_fn, value_and_grad


def make_accum_train_step(cfg, optimizer, n_micro: int,
                          aux_weight: float = 0.01):
    loss_fn = make_loss_fn(cfg, aux_weight)

    def train_step(state, batch):
        b = batch["inputs"].shape[0]
        if b % n_micro:
            raise ValueError(f"batch {b} is not a multiple of n_micro "
                             f"{n_micro}")
        mb = b // n_micro
        params = state["params"]
        gsum = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                              device=p.device), params)
        lsum = torch.zeros((), dtype=torch.float32,
                           device=batch["inputs"].device)
        for i in range(n_micro):
            micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
            (_, metrics), grads = value_and_grad(loss_fn, params, micro)
            gsum = tree_map(lambda a, g: a + g.float(), gsum, grads)
            lsum = lsum + metrics["loss"]
        grads = tree_map(lambda g: g / n_micro, gsum)
        new_params, new_opt, om = optimizer.update(
            grads, state["opt"], params, state["step"])
        new_state = {"params": new_params, "opt": new_opt,
                     "step": state["step"] + 1}
        return new_state, dict(loss=lsum / n_micro, **om)

    return train_step
