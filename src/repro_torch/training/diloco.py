"""DiLoCo-style training across pods with an error-feedback int8 outer
sync.

Each pod trains on its own for `inner_steps`, then the pods exchange
parameter deltas quantized to int8 with error feedback
(`quant.int8.ef_compress`) and an outer Nesterov step moves the shared
anchor:

    delta_p   = anchor - params_p                  (per pod)
    q_p       = EF-int8(delta_p)                   (residual carried)
    delta_avg = mean_p dequant(q_p)                (the only cross-pod traffic)
    anchor'   <- outer_opt(anchor, delta_avg)
    params_p  <- anchor'

Leaves of one axis (norms) travel in fp32. The pods here are a list of
parameter trees in one process, as in the reference; `bytes_sent`
counts what the compressed sync would move, `bytes_fp32` what fp32
deltas would."""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import torch

from repro_torch.models.params import Packed, tree_map, unpack
from repro_torch.quant.int8 import dequantize_int8, ef_compress


@dataclass
class OuterState:
    anchor: dict                      # shared fp32 anchor params
    momentum: dict                    # Nesterov momentum on deltas
    residuals: List[dict]             # per-pod EF residuals
    syncs: int = 0
    bytes_sent: int = 0               # cumulative compressed bytes
    bytes_fp32: int = 0               # what fp32 deltas would have cost


def init_outer(params, n_pods: int) -> OuterState:
    f32 = tree_map(lambda p: p.float(), params)
    return OuterState(
        anchor=f32,
        momentum=tree_map(torch.zeros_like, f32),
        residuals=[tree_map(torch.zeros_like, f32) for _ in range(n_pods)],
    )


def outer_sync(state: OuterState, pod_params: List[dict], *,
               outer_lr: float = 0.7, outer_momentum: float = 0.9,
               quantize: bool = True) -> OuterState:
    """One outer step. Returns the new OuterState; callers reset each
    pod's params to `broadcast_anchor` afterwards."""
    n = len(pod_params)
    deltas = []
    comp_bytes = 0
    raw_bytes = 0
    for i, params in enumerate(pod_params):
        delta = tree_map(lambda a, p: a - p.float(), state.anchor, params)
        if quantize:
            def compress(d, r):
                nonlocal comp_bytes, raw_bytes
                raw_bytes += d.numel() * 4
                if d.ndim >= 2:
                    q, s, nr = ef_compress(d, r)
                    comp_bytes += q.numel() + 4 * s.numel()
                    return dequantize_int8(q, s), nr
                # tiny 1-D leaves stay fp32
                comp_bytes += d.numel() * 4
                return d, torch.zeros_like(r)
            pairs = tree_map(lambda d, r: Packed(*compress(d, r)), delta,
                             state.residuals[i])
            delta = unpack(pairs, 0)
            state.residuals[i] = unpack(pairs, 1)
        deltas.append(delta)
    avg = tree_map(lambda *ds: sum(ds) / n, *deltas)
    mom = tree_map(lambda m, d: outer_momentum * m + d, state.momentum, avg)
    anchor = tree_map(lambda a, m, d: a - outer_lr * (outer_momentum * m + d),
                      state.anchor, mom, avg)  # Nesterov
    return OuterState(anchor=anchor, momentum=mom,
                      residuals=state.residuals,
                      syncs=state.syncs + 1,
                      bytes_sent=state.bytes_sent + comp_bytes,
                      bytes_fp32=state.bytes_fp32 + raw_bytes)


def broadcast_anchor(state: OuterState, like_params) -> dict:
    """anchor -> the pods' param dtype (bf16 / fp32)."""
    return tree_map(lambda a, p: a.to(p.dtype), state.anchor, like_params)
