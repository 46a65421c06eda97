"""The CNNSelect-fronted multi-model server (paper §5 end-to-end system).

Manages a zoo of real engines (small models on CPU here; pod-sharded on
the TPU target) and serves each request batch-of-one through the shared
per-request control step (`serving/control.py`, DESIGN.md §12):
estimate the remaining budget from the observed upload time, select a
model, execute, and record SLA attainment + the measured latency back
through the plane. With a `controller`, the server detects per-device
regime shifts online and switches its operating mode live — a
degraded-mode request whose device can serve locally is answered with
an on-device advisory (the MDInference duality at the prototype layer:
the server instructs the device to run its local model instead of
executing in the cloud)."""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.selection import ModelProfile, Policy
from repro_torch.serving.batching import Request
from repro_torch.serving.control import ControlPlane
from repro_torch.serving.engine import InferenceEngine
from repro_torch.serving.metrics import ServingMetrics
from repro_torch.serving.router import Router
from repro_torch.serving.stack import StackOutcome


@dataclass
class ServedModel:
    name: str
    engine: InferenceEngine
    accuracy: float            # task accuracy measured offline
    size_bytes: int = 0


class ServerMetrics(ServingMetrics):
    """The server's ledger — now the unified `ServingMetrics` schema
    (serving/metrics.py); kept as a named subclass so `ServerMetrics`
    imports and `type(server.metrics)()` reconstruction keep working.
    The pre-unification counter fields live on as deprecated alias
    properties on the base class."""


class CNNSelectServer:
    def __init__(self, models: List[ServedModel], *, t_threshold: float,
                 policy="cnnselect", seed: int = 0,
                 n_tokens: int = 8, stage2_variant: str = "figure",
                 t_estimator=None, controller=None,
                 on_device_ms: Optional[Dict[str, float]] = None):
        self.models = {m.name: m for m in models}
        self.order = [m.name for m in models]
        self.n_tokens = n_tokens
        self.router = Router(policy=policy, t_threshold=t_threshold,
                             stage2_variant=stage2_variant, seed=seed,
                             min_sigma=0.5, t_estimator=t_estimator)
        for m in models:
            # mu=0: latency priors arrive online via profile_models().
            self.router.register(ModelProfile(
                name=m.name, accuracy=m.accuracy, mu=0.0, sigma=0.0,
                size_bytes=m.size_bytes))
        # The shared per-request control step (DESIGN.md §12).
        # `controller` is a CONTROLLER_SCENARIOS name or an
        # AdaptiveController; `on_device_ms` maps device ids to their
        # local-model latency (enables on-device advisories when a
        # degraded-mode device's cloud path cannot meet the SLA).
        self.control = ControlPlane(self.router, controller=controller,
                                    seed=seed, t_threshold=t_threshold,
                                    stage2_variant=stage2_variant)
        self.on_device_ms = dict(on_device_ms or {})
        self.metrics = ServerMetrics()
        # Optional trace capture (serving/trace.py, DESIGN.md §11):
        # `handle` records each served request, outcome included.
        self.recorder = None

    @property
    def store(self):
        return self.router.store

    @property
    def policy(self) -> Policy:
        return self.router.policy

    def profile_models(self, prompt_len: int = 16, reps: int = 5):
        """Measure each engine's hot latency (paper: profiles measured and
        managed by the inference server)."""
        for name, m in self.models.items():
            m.engine.warmup(prompt_len)
            p = m.engine.measured_profile(prompt_len, self.n_tokens, reps)
            # The router's min_sigma floor owns the clamp.
            self.router.set_profile(name, p["mu"], p["sigma"])
        self.router.prewarm()

    def current_profiles(self) -> List[ModelProfile]:
        return self.router.current_profiles()

    def select(self, t_sla: float, t_input: float,
               device_id: Optional[str] = None) -> str:
        """One control step (estimate → maybe adapt → select) through
        the shared plane; the static plane is exactly the pre-plane
        behaviour — budget from the observed upload time via the
        router's estimator, then select."""
        return self.control.step(t_sla, t_input,
                                 device_id=device_id).name

    def handle(self, req: Request, t_sla: float) -> dict:
        """Serve one request batch-of-one style (the prototype evaluation
        path, Fig 12). Returns the per-request record."""
        d = self.control.step(
            t_sla, req.t_input_ms, device_id=req.device_id,
            on_device_ms=self.on_device_ms.get(req.device_id or "", 0.0))
        if d.fallback:
            # On-device advisory: the device serves locally; no upload,
            # no cloud execution. Charged the device's known local
            # latency.
            e2e = self.on_device_ms[req.device_id or ""]
            ok = e2e <= t_sla
            self.metrics.add(req, d.name, mode=d.mode, e2e_ms=e2e,
                             ok=ok, fallback=True)
            if self.recorder is not None:
                self.recorder.record_request(req, model=d.name,
                                             sla_ok=ok)
            return {"model": d.name, "e2e_ms": e2e, "ok": ok,
                    "device": req.device_id, "mode": d.mode,
                    "tokens": []}
        name = d.name
        m = self.models[name]
        t0 = time.perf_counter()
        B = m.engine.batch_size
        prompts = np.tile(req.prompt[None, :], (B, 1)).astype(np.int32)
        toks = m.engine.generate(prompts, self.n_tokens)
        exec_ms = (time.perf_counter() - t0) * 1000.0
        self.control.observe_outcome(name, exec_ms)
        e2e = req.t_input_ms * 2.0 + exec_ms
        ok = e2e <= t_sla
        self.metrics.add(req, name, exec_ms=exec_ms, mode=d.mode,
                         e2e_ms=e2e, ok=ok, accuracy=m.accuracy)
        if self.recorder is not None:
            self.recorder.record_request(req, model=name, sla_ok=ok,
                                         exec_ms=exec_ms)
        return {"model": name, "e2e_ms": e2e, "ok": ok,
                "device": req.device_id, "mode": d.mode,
                "tokens": toks[0].tolist()}

    # -- ServingStack (serving/stack.py, DESIGN.md §16) ---------------

    def submit(self, req: Request, *, now: float = 0.0) -> StackOutcome:
        """Protocol admission: serve inline against the request's own
        SLA (``sla_ms == 0`` means no SLA)."""
        rec = self.handle(req, t_sla=req.sla_ms or 1e9)
        return StackOutcome(
            model=rec["model"], mode=rec["mode"], e2e_ms=rec["e2e_ms"],
            ok=rec["ok"], tenant=req.tenant,
            fallback=rec["model"] == "<on-device>")

    def drain(self) -> None:
        """Batch-of-one execution — nothing queued across submits."""

    def observe_outcome(self, name: str, latency_ms: float, *,
                        cold: bool = False, now: float = 0.0) -> None:
        self.control.observe_outcome(name, latency_ms, cold=cold,
                                     now=now)
