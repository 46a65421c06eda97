"""Measured execution backend: the runnable model zoo behind the Router.

Builds `InferenceEngine`s from `configs.paper_zoo.MEASURED_ZOO` (reduced
attention-only LMs, fp32 + int8 variants as distinct selection
candidates) and turns their `measured_profile` outputs into the
`ModelProfile` list every serving stack consumes — the `ProfileStore`
source selected with ``profiles="measured"``.

Engines run on the card with the CUDA kernels by default
(``device="cuda"``, ``attn_impl="cuda"``); ``device="cpu"`` runs the same
path on the kernels' plain versions."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, List, Optional

from repro_torch.configs import reduced_config
from repro_torch.configs.paper_zoo import MEASURED_ZOO, measured_zoo_names
from repro_torch.core.selection import ModelProfile
from repro_torch.models import init_params
from repro_torch.quant.int8 import quantize_exec_tree
from repro_torch.serving.engine import InferenceEngine


@dataclass
class MeasuredModel:
    """One runnable selection candidate: engine + offline metadata."""
    name: str
    engine: InferenceEngine
    accuracy: float
    size_bytes: int
    quant: Optional[str] = None


def build_model(name: str, *, batch_size: int = 4, max_seq: int = 64,
                seed: int = 0, attn_impl: str = "cuda",
                device="cuda") -> MeasuredModel:
    """Build one zoo engine. attn_impl defaults to the kernel path
    ('naive' keeps the reference path for A/B runs). int8 candidates
    hold their weights as resident (int8, scale) execution trees —
    projection matmuls run the int8 kernel, and size_bytes is the bytes
    this engine actually holds."""
    spec = MEASURED_ZOO[name]
    cfg = reduced_config(spec["arch"])
    cfg = dataclasses.replace(cfg, d_model=spec["d_model"],
                              d_ff=spec["d_ff"], n_layers=spec["n_layers"],
                              attn_impl=attn_impl)
    params = init_params(cfg, seed, device=device)
    if spec["quant"] == "int8":
        params = quantize_exec_tree(params)
    engine = InferenceEngine(cfg, params, batch_size=batch_size,
                             max_seq=max_seq, device=device)
    return MeasuredModel(name=name, engine=engine,
                         accuracy=spec["accuracy"],
                         size_bytes=engine.resident_bytes,
                         quant=spec["quant"])


def build_zoo(names=None, *, batch_size: int = 4, max_seq: int = 64,
              seed: int = 0, attn_impl: str = "cuda", device="cuda"
              ) -> Dict[str, MeasuredModel]:
    """{name: MeasuredModel} for the requested zoo subset, in registry
    order. Engines share batch/seq geometry so one batcher config fits
    all; params are seeded per model (seed + registry index)."""
    out = {}
    for i, n in enumerate(measured_zoo_names(names)):
        out[n] = build_model(n, batch_size=batch_size, max_seq=max_seq,
                             seed=seed + i, attn_impl=attn_impl,
                             device=device)
    return out


def measured_profiles(zoo: Dict[str, MeasuredModel], *,
                      prompt_len: int = 8, n_tokens: int = 4,
                      reps: int = 3, warmup: bool = True,
                      detail: Optional[dict] = None) -> List[ModelProfile]:
    """Profile every engine on THIS device and return the `ModelProfile`
    list the Router/simulator consume — the ``profiles="measured"``
    source. Cold start is the measured warmup time (kernel build and
    first run). `detail`, if given, is filled with each engine's raw
    measured_profile dict (prefill_ms / per_token_ms split)."""
    out = []
    for name, m in zoo.items():
        cold_ms = (m.engine.warmup(prompt_len) * 1000.0) if warmup else 0.0
        p = m.engine.measured_profile(prompt_len, n_tokens, reps)
        if detail is not None:
            detail[name] = dict(p, cold_ms=cold_ms)
        out.append(ModelProfile(
            name=name, accuracy=m.accuracy, mu=p["mu"],
            sigma=max(p["sigma"], 1e-3), cold_mu=cold_ms,
            cold_sigma=0.1 * cold_ms, size_bytes=m.size_bytes))
    return out


def served_models(zoo: Dict[str, MeasuredModel]):
    """Adapt the zoo to `CNNSelectServer`'s ServedModel list."""
    from repro_torch.serving.server import ServedModel
    return [ServedModel(name=m.name, engine=m.engine, accuracy=m.accuracy,
                        size_bytes=m.size_bytes) for m in zoo.values()]
