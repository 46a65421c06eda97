"""Admission router: the one front door shared by all serving stacks.

The paper evaluates CNNSelect in three settings — a live prototype
server (batch-of-one), a continuous-batching loop, and 10k-request
simulations. Pre-refactor each reimplemented the same admission logic:
read profiles, dispatch on a policy string, pay cold start, enqueue.
The Router centralizes it (DESIGN.md §3): it owns the online
`ProfileStore`, the cold/warm `ModelZoo` state, and per-model request
queues, and answers selection either per request (`route`) or
vectorized over a whole trace (`route_batch`, which drives the jit'd
`cnnselect_batch` Gumbel-max path in fixed-size chunks).
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

from repro_torch.core.profiles import ProfileStore
from repro_torch.core.selection import ModelProfile, Policy, make_policy
from repro_torch.core.zoo import ModelZoo
from repro_torch.serving.batching import FifoQueue, Request
from repro_torch.serving.fleet import EstimatorBank
from repro_torch.serving.network import TInputEstimator, make_estimator


@dataclass
class RouteDecision:
    index: int                 # position in the router's model order
    name: str
    startup_ms: float = 0.0    # cold-start penalty paid by this request


class Router:
    """Policy-driven admission over a registered model zoo.

    Queues are pluggable: anything with a ``submit(req)`` method can be
    attached per model (the serving loop attaches its
    ``ContinuousBatcher``s); the default is a ``FifoQueue``.
    """

    def __init__(self, profiles: Optional[Sequence[ModelProfile]] = None, *,
                 policy: Union[str, Policy] = "cnnselect",
                 t_threshold: float = 50.0, stage2_variant: str = "figure",
                 seed: int = 0, chunk: int = 2048,
                 memory_budget_bytes: Optional[int] = None,
                 min_sigma: float = 0.0,
                 t_estimator: Union[str, TInputEstimator, EstimatorBank,
                                    None] = None):
        self.policy = make_policy(policy, t_threshold=t_threshold,
                                  stage2_variant=stage2_variant, seed=seed,
                                  chunk=chunk)
        # Optional online T_input estimator (DESIGN.md §9): when set,
        # per-request budgets come from its causal estimate of recent
        # upload times, not from the raw per-request observation. An
        # `EstimatorBank` keys estimation per device (DESIGN.md §10) —
        # pass each request's `device_id` through route/route_batch.
        self.t_estimator = (t_estimator if isinstance(t_estimator,
                                                      EstimatorBank)
                            else make_estimator(t_estimator))
        self.store = ProfileStore()
        self.zoo = ModelZoo(memory_budget_bytes)
        self.order: List[str] = []
        self.queues: Dict[str, object] = {}
        self.min_sigma = min_sigma
        # Optional trace capture (serving/trace.py `TraceRecorder`,
        # DESIGN.md §11): when attached, `submit`/`submit_many` record
        # each admitted request (sla outcome unknown at admission).
        self.recorder = None
        for p in profiles or []:
            self.register(p)

    # -- zoo / profile management -----------------------------------------

    def register(self, profile: ModelProfile, *, queue=None):
        """Add a model. A profile with mu > 0 seeds the store's prior;
        mu == 0 means "profile online later" (via `set_profile`)."""
        self.zoo.register(profile)
        self.order.append(profile.name)
        self.queues[profile.name] = FifoQueue() if queue is None else queue
        if profile.mu > 0:
            self.store.set_prior(profile.name, profile.mu, profile.sigma,
                                 profile.cold_mu, profile.cold_sigma)

    def attach_queue(self, name: str, queue):
        self.queues[name] = queue

    def set_profile(self, name: str, mu: float, sigma: float,
                    cold_mu: float = 0.0, cold_sigma: float = 0.0):
        """(Re)seed a model's latency prior, e.g. from live measurement."""
        self.store.set_prior(name, mu, sigma, cold_mu, cold_sigma)

    def record(self, name: str, latency_ms: float, *, cold: bool = False,
               now: float = 0.0):
        """Feed one measured latency back into the online profile."""
        self.store.record(name, latency_ms, cold=cold, now=now)

    def prewarm(self, names: Optional[Sequence[str]] = None):
        self.zoo.prewarm(list(names) if names is not None else self.order)

    def current_profiles(self) -> List[ModelProfile]:
        """The live view the policy sees: online mu/sigma blended with
        the registered accuracy / cold-start / size metadata."""
        out = []
        for name in self.order:
            p = self.zoo.entries[name].profile
            mu, sg = self.store.mu_sigma(name)
            out.append(ModelProfile(
                name=name, accuracy=p.accuracy, mu=mu,
                sigma=max(sg, self.min_sigma), cold_mu=p.cold_mu,
                cold_sigma=p.cold_sigma, size_bytes=p.size_bytes))
        return out

    # -- admission --------------------------------------------------------

    def observe_t_input(self, t_input: float,
                        device_id: Optional[str] = None) -> float:
        """Feed one observed upload time to the attached estimator and
        return the budget-side T_input for this request (the raw
        observation when no estimator is attached). With an
        `EstimatorBank`, `device_id` selects the device's estimator."""
        if self.t_estimator is None:
            return float(t_input)
        if isinstance(self.t_estimator, EstimatorBank):
            est = self.t_estimator.estimate(device_id, observed=t_input)
            self.t_estimator.observe(device_id, float(t_input))
            return est
        est = self.t_estimator.estimate(observed=t_input)
        self.t_estimator.observe(float(t_input))
        return est

    def estimate_series(self, t_input, *, device_ids=None) -> np.ndarray:
        """Causal budget-side estimates for a whole observed trace
        (identity when no estimator is attached). Mutates estimator
        state — each observation is fed exactly once."""
        t_input = np.asarray(t_input, np.float64)
        if self.t_estimator is None:
            return t_input
        if isinstance(self.t_estimator, EstimatorBank):
            return self.t_estimator.estimate_series(t_input, device_ids)
        return self.t_estimator.estimate_series(t_input)

    def select(self, t_sla: float, t_input: float, *,
               realized: Optional[np.ndarray] = None) -> int:
        """Pure policy decision for one request (no zoo or estimator
        side effects; `t_input` is taken as the budget-side value)."""
        return self.policy.select(self.current_profiles(), t_sla, t_input,
                                  realized=realized)

    def route(self, t_sla: float, t_input: float, *, now: float = 0.0,
              realized: Optional[np.ndarray] = None,
              rng: Optional[np.random.Generator] = None,
              device_id: Optional[str] = None) -> RouteDecision:
        """Select a model and transition it hot, charging this request
        the cold-start penalty if it wasn't. The observed `t_input`
        passes through the estimator (if any) for budgeting; with an
        `EstimatorBank`, keyed by the request's `device_id`."""
        idx = self.select(t_sla,
                          self.observe_t_input(t_input, device_id),
                          realized=realized)
        name = self.order[idx]
        startup = self.zoo.ensure_hot(name, now, rng)
        return RouteDecision(idx, name, startup)

    def route_batch(self, t_sla, t_input, *,
                    realized: Optional[np.ndarray] = None,
                    detail: bool = False, device_ids=None,
                    estimated: bool = False):
        """Vectorized admission over N requests: one `select_batch` call
        (chunked jit for cnnselect), no zoo side effects — callers
        replay cold/warm transitions in event order via `zoo`. With an
        estimator attached, the observed `t_input` trace is replaced by
        its causal `estimate_series` for budgeting (per device when the
        estimator is an `EstimatorBank` and `device_ids` is given).
        `estimated=True` marks `t_input` as already budget-side (the
        caller ran `estimate_series` itself, e.g. to inspect the
        estimates for outage detection) — estimation is skipped so
        observations are never fed twice."""
        t_input = np.asarray(t_input, np.float64)
        if not estimated:
            t_input = self.estimate_series(t_input, device_ids=device_ids)
        return self.policy.select_batch(
            self.current_profiles(), np.asarray(t_sla, np.float64),
            t_input, realized=realized, detail=detail)

    def _admit(self, req: Request, name: str) -> None:
        """Admission bookkeeping for an already-routed request — bind
        the model, queue it, record the admission. One copy shared by
        `submit`/`submit_many`. Requests are the canonical
        `batching.Request` — one dataclass end to end, so device_id/sla
        metadata cannot drift between admission and execution."""
        req.model = name
        self.queues[name].submit(req)
        if self.recorder is not None:
            self.recorder.record_request(req, model=name)

    def enqueue(self, req: Request, name: str) -> None:
        """Deprecated: call ``submit(req, name=name)`` — `submit` is the
        one canonical admission path (pre-decided admissions included),
        so admission bookkeeping cannot fork."""
        warnings.warn(
            "Router.enqueue is deprecated; use Router.submit(req, "
            "name=name)", DeprecationWarning, stacklevel=2)
        self._admit(req, name)

    def submit(self, req: Request, *, now: float = 0.0,
               name: Optional[str] = None) -> RouteDecision:
        """The canonical admission path: route one request and enqueue
        it on its model's queue. A caller that already decided the
        model (e.g. the control plane's adaptive per-request step,
        serving/control.py) passes ``name=`` to skip routing and admit
        directly — same bookkeeping, no second selection."""
        if name is not None:
            self._admit(req, name)
            return RouteDecision(self.order.index(name), name, 0.0)
        d = self.route(req.sla_ms or 1e9, req.t_input_ms, now=now,
                       device_id=req.device_id)
        self._admit(req, d.name)
        return d

    def submit_many(self, requests: Sequence[Request]) -> List[str]:
        """Vectorized admission of a whole trace: one `route_batch` over
        the requests' (sla, t_input) vectors, then enqueue in arrival
        order. Returns the chosen model name per request."""
        if not requests:
            return []
        t_sla = np.array([r.sla_ms or 1e9 for r in requests])
        t_in = np.array([r.t_input_ms for r in requests])
        devs = [r.device_id for r in requests]
        idx = self.route_batch(t_sla, t_in, device_ids=devs)
        names = []
        for r, i in zip(requests, idx):
            name = self.order[int(i)]
            self._admit(r, name)
            names.append(name)
        return names
