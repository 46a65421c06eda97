"""Continuous-batching serving loop: ContinuousBatcher x InferenceEngine
with per-request SLA accounting and CNNSelect at admission.

The paper's observation that throughput-batching "may increase waiting
time of some requests" becomes measurable here: `ServingLoop.run`
processes an arrival trace and reports queue wait vs execution time per
request. Admission goes through the shared `Router`: the whole trace is
routed in one vectorized `route_batch` call (the jit'd cnnselect_batch
path) and lands in the per-model `ContinuousBatcher`s the router owns
as its queues — batching and selection compose (beyond-paper: the
paper serves batch-of-one). Mid-group, freed slots are backfilled with
queued arrivals via `InferenceEngine.prefill_row` (true continuous
batching), and each measured per-request exec_ms feeds
`ControlPlane.observe_outcome` so the online profiles track this
host's executed latencies."""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Union

import numpy as np

from repro_torch.core.selection import ModelProfile
from repro_torch.serving.batching import ContinuousBatcher, Request
from repro_torch.serving.control import ControlPlane
from repro_torch.serving.engine import InferenceEngine
from repro_torch.serving.metrics import ServingMetrics
from repro_torch.serving.router import Router
from repro_torch.serving.stack import StackOutcome


class LoopMetrics(ServingMetrics):
    """The loop's ledger — now the unified `ServingMetrics` schema
    (serving/metrics.py); kept as a named subclass for imports. The
    pre-unification ``mean_e2e_ms``/``p95_e2e_ms`` summary keys are now
    ``mean_ms``/``p95_ms`` (migration note in CHANGES.md)."""


class ServingLoop:
    """Drives engines through a request trace in virtual time.

    engines: {name: InferenceEngine}. The loop seeds an aligned group
    per model, then runs decode rounds with slot-level joins: a member
    retiring early frees its slot and the next queued arrival prefills
    into it mid-group (`InferenceEngine.prefill_row`) — the scheduler
    half of continuous batching (see DESIGN.md §14).

    profiles: a ModelProfile list, or the string ``"measured"`` to
    profile each engine on this host at construction (requires
    `accuracies={name: score}` for the selection objective)."""

    def __init__(self, engines: Dict[str, InferenceEngine],
                 profiles: Union[List[ModelProfile], str, None] = None,
                 t_threshold: float = 30.0, seed: int = 0,
                 policy="cnnselect", t_estimator=None, controller=None,
                 accuracies: Optional[Dict[str, float]] = None):
        self.engines = engines
        some = next(iter(engines.values()))
        self.batchers = {
            name: ContinuousBatcher(eng.batch_size,
                                    prompt_len=some.max_seq // 4)
            for name, eng in engines.items()}
        if isinstance(profiles, str):
            if profiles != "measured":
                raise ValueError(f"unknown profiles source {profiles!r}; "
                                 f"pass a list or 'measured'")
            if accuracies is None:
                raise ValueError("profiles='measured' needs accuracies="
                                 "{name: score}")
            prompt_len = some.max_seq // 4
            profiles = []
            for name, eng in engines.items():
                cold_s = eng.warmup(prompt_len)
                p = eng.measured_profile(prompt_len, n_tokens=4)
                profiles.append(ModelProfile(
                    name=name, accuracy=accuracies[name], mu=p["mu"],
                    sigma=max(p["sigma"], 1e-3), cold_mu=cold_s * 1000.0,
                    cold_sigma=100.0 * cold_s))
        if profiles is None or len(engines) == 1:
            # Single-engine loop: no selection, everything to one queue.
            self.router = None
            self.control = None
        else:
            # t_estimator: budget-side T_input source (DESIGN.md §9) —
            # None trusts each request's observed upload time; an
            # EstimatorBank keys estimation on each request's
            # `device_id` (fleet traces, DESIGN.md §10).
            self.router = Router(profiles, policy=policy,
                                 t_threshold=t_threshold, seed=seed,
                                 t_estimator=t_estimator)
            for name in self.router.order:
                self.router.attach_queue(name, self.batchers[name])
            # The shared per-request control step (DESIGN.md §12):
            # with a `controller` (CONTROLLER_SCENARIOS name or
            # AdaptiveController) admission adapts per request; without
            # one, admission stays the vectorized submit_many path.
            self.control = ControlPlane(self.router,
                                        controller=controller,
                                        seed=seed,
                                        t_threshold=t_threshold)
        self.metrics = LoopMetrics()
        self._req_modes: Dict[int, str] = {}
        # Optional trace capture (serving/trace.py, DESIGN.md §11):
        # `run` records each drained request with its SLA outcome.
        # Attach here, not to self.router — the router hook would
        # record the same request again at admission.
        self.recorder = None

    def run(self, requests: List[Request]) -> LoopMetrics:
        ordered = sorted(requests, key=lambda r: r.arrival)
        if self.router is not None and self.control.controller is None:
            # Vectorized admission: one chunked jit call for the trace.
            self.router.submit_many(ordered)
        else:
            # Per-request admission (single-engine, or adaptive — the
            # controller's decisions are inherently sequential).
            for req in ordered:
                self.submit(req)
        self.drain()
        return self.metrics

    # -- ServingStack (serving/stack.py, DESIGN.md §16) ---------------

    def submit(self, req: Request, *, now: float = 0.0) -> StackOutcome:
        """Protocol admission: route (through the shared control step
        when a controller is attached) and queue on the chosen model's
        batcher; execution and the metrics row land at `drain`."""
        if self.router is None:
            only = next(iter(self.engines))
            self.batchers[only].submit(req)
            return StackOutcome(model=only, pending=True,
                                tenant=req.tenant)
        if self.control.controller is None:
            d = self.router.submit(req, now=now)
            return StackOutcome(model=d.name, pending=True,
                                tenant=req.tenant)
        # Adaptive: detect -> maybe switch mode -> estimate -> select.
        d = self.control.step(req.sla_ms or 1e9, req.t_input_ms,
                              device_id=req.device_id)
        self._req_modes[req.rid] = d.mode
        self.router.submit(req, name=d.name)
        return StackOutcome(model=d.name, mode=d.mode, pending=True,
                            tenant=req.tenant)

    def drain(self) -> None:
        """Drain each model's queue in arrival order (virtual clock per
        model; engines measure real exec time on this host)."""
        for name, batcher in self.batchers.items():
            self._drain(name, batcher)

    def observe_outcome(self, name: str, latency_ms: float, *,
                        cold: bool = False, now: float = 0.0) -> None:
        if self.control is not None:
            self.control.observe_outcome(name, latency_ms, cold=cold,
                                         now=now)

    def _finish(self, r: Request, name: str, exec_ms: float):
        """Per-request completion: metrics row, online profile feedback,
        trace capture — with the request's OWN measured exec_ms, not a
        group-shared wall time."""
        queue_ms = max(0.0, r.start_exec - r.arrival)
        self.metrics.add(r, name, queue_ms, exec_ms,
                         mode=self._req_modes.get(r.rid))
        if self.control is not None:
            self.control.observe_outcome(name, exec_ms)
        if self.recorder is not None:
            # sla_ms=0 means "no SLA": the outcome is unknown, not met
            # (metrics report ok=True for convenience, but a capture
            # must not fabricate attainment).
            self.recorder.record_request(
                r, model=name, exec_ms=exec_ms,
                sla_ok=(self.metrics.records[-1]["ok"]
                        if r.sla_ms else None))

    def _drain(self, name: str, batcher: ContinuousBatcher):
        eng = self.engines[name]
        now = 0.0
        # rid -> exec ms accumulated while the request occupied a slot.
        # Every engine call's wall time is charged to the requests that
        # were resident during it (aligned decode: they all stall
        # together), so per-request exec_ms is honest under backfill.
        acc: Dict[int, float] = {}
        n_done = len(batcher.done)     # done entries from previous runs
        logits = None
        while batcher.has_work:
            if batcher.n_active == 0:
                # Engine idle: advance the clock to the next arrival and
                # seed a fresh group.
                if not batcher.queue:
                    break
                now = max(now, batcher.queue[0].arrival)
                group = batcher.form_group(now)
                if group is None:
                    break
                t0 = time.perf_counter()
                logits = eng.run_prefill(batcher.pad_prompts(),
                                         lengths=batcher.prompt_lengths())
                dt = (time.perf_counter() - t0) * 1000.0
                now += dt
                for r in group:
                    acc[r.rid] = dt
            # One aligned decode round: sample, record/retire, backfill
            # freed slots, then step the whole group.
            nxt = logits.argmax(-1).astype(np.int32)
            batcher.record_tokens(nxt, now)
            while n_done < len(batcher.done):
                r = batcher.done[n_done]
                self._finish(r, name, acc.pop(r.rid, 0.0))
                n_done += 1
            if batcher.n_active == 0:
                continue            # drained; next iteration reseeds
            if eng._backfillable:
                for slot, r in batcher.backfill(now, eng.free_context):
                    prompt = np.zeros(batcher.prompt_len, np.int32)
                    p = r.prompt[-batcher.prompt_len:]
                    prompt[len(prompt) - len(p):] = p
                    t0 = time.perf_counter()
                    tok = int(eng.prefill_row(prompt, slot, length=len(p))
                              .argmax(-1))
                    dt = (time.perf_counter() - t0) * 1000.0
                    now += dt
                    # The whole group stalls for the row prefill.
                    for rr in batcher.slots:
                        if rr is not None:
                            acc[rr.rid] = acc.get(rr.rid, 0.0) + dt
                    nxt[slot] = tok
                    batcher.record_token(slot, tok, now)
                    while n_done < len(batcher.done):
                        done_r = batcher.done[n_done]
                        self._finish(done_r, name,
                                     acc.pop(done_r.rid, 0.0))
                        n_done += 1
            if batcher.n_active == 0:
                continue
            t0 = time.perf_counter()
            logits = eng.run_decode(nxt[:, None])
            dt = (time.perf_counter() - t0) * 1000.0
            now += dt
            for rr in batcher.slots:
                if rr is not None:
                    acc[rr.rid] = acc.get(rr.rid, 0.0) + dt
