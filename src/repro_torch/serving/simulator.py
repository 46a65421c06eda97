"""Event-driven serving simulator (paper §5.2: 10,000-request simulations
seeded with empirical CNN execution-time and network measurements).

Each request: T_input drawn from the network process (stationary,
regime-switching Markov, or trace replay — whole-trace vectorized; see
serving/network.py and DESIGN.md §9) or, with `SimConfig.fleet`, from
the issuing *device's* own process (`serving/fleet.py`, DESIGN.md §10);
the policy sees the budget-side upload time (the observation, or a
`TInputEstimator` / per-device `EstimatorBank` causal estimate) and the
profile store; the selected model's execution time is sampled from its
(mu, sigma); cold starts and queueing at `n_servers` fixed-capacity
replicas are modeled; SLA attainment and effective accuracy are
recorded.

Hedging/fallback (`SimConfig.hedge`):
- ``"p95"`` — legacy straggler mitigation: re-issue to the second
  replica when queueing alone would eat >5% of the SLA.
- ``"outage"`` — outage-aware (MDInference-style): a request whose
  device estimator has entered a degraded regime (estimate >
  `outage_factor` x the device's prior mean) is hedged to the second
  replica; if the device can run a model locally and the estimated
  cloud path cannot meet the SLA at all, it *falls back on-device*
  (`core.selection.on_device_fallback_decision`) and never uploads.

Selection is vectorized (DESIGN.md §3): the whole trace goes through the
Router's `route_batch` — for cnnselect that is the jit'd
`cnnselect_batch` Gumbel-max kernel in fixed-size chunks, not 10k
python-level `cnnselect` calls — and only the cold-start/queueing state
machine replays per request in event order."""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

from repro_torch.core.selection import ModelProfile, Policy
from repro_torch.serving.control import (HEDGE_MODES, AdaptiveController,
                                   ControlPlane, make_controller)
from repro_torch.serving.fleet import EstimatorBank, FleetMixture, make_fleet
from repro_torch.serving.metrics import group_stats
from repro_torch.serving.network import (NetworkProcess, TInputEstimator,
                                   make_estimator, make_network)
from repro_torch.serving.router import Router


@dataclass
class SimConfig:
    t_sla: float
    t_threshold: float = 50.0
    n_requests: int = 10000
    # A NETWORKS name (stationary, paper behaviour), a NETWORK_SCENARIOS
    # name (regime-switching Markov), "trace:<name>", or a prebuilt
    # NetworkProcess. Ignored when `fleet` is set.
    network: Union[str, NetworkProcess] = "campus_wifi"
    # Any registry spec (cnnselect | greedy | greedy_nw | random | oracle
    # | static:<name>) or a prebuilt Policy object.
    policy: Union[str, Policy] = "cnnselect"
    stage2_variant: str = "figure"
    seed: int = 0
    arrival_rate_hz: float = 0.0   # 0 = closed loop (no queueing)
    n_servers: int = 1
    # Hedging/fallback policy: "none" | "p95" | "outage" (see module
    # docstring). The legacy boolean `hedge_at_p95=True` maps to "p95"
    # and is deprecated (pinned DeprecationWarning).
    hedge: str = "none"
    hedge_at_p95: bool = False
    # A device estimate is "degraded" when it exceeds this factor times
    # the device's prior (long-run) mean — the outage-regime detector.
    outage_factor: float = 2.0
    # Allow degraded devices with an on-device profile to serve locally
    # when the estimated cloud path cannot meet the SLA (hedge="outage").
    on_device_fallback: bool = True
    memory_budget_bytes: Optional[int] = None
    prewarm: bool = True
    # Budget-side T_input source: None = the observed per-request upload
    # time (paper behaviour); or "mean" | "ewma[:alpha]" | "pctl[:q]" |
    # a TInputEstimator (online estimation under time-varying networks).
    # With `fleet` set, the spec is instantiated per device in an
    # `EstimatorBank` (each device's estimator sees only its own
    # observations, primed with its own process mean).
    t_estimator: Union[str, TInputEstimator, None] = None
    # Device fleet: a FLEET_SCENARIOS name or a prebuilt FleetMixture.
    # None (default) keeps the single shared network process — the
    # golden-pinned pre-fleet path.
    fleet: Union[str, FleetMixture, None] = None
    # Observation staleness fed to the estimator(s): 0 = server-side
    # view (previous upload already measured); 1 = ModiPick's
    # client-side pre-upload view (one RTT behind).
    estimator_lag: int = 0
    # "device": the bank keys estimation on each request's device
    # (default). "global": one shared estimator over the interleaved
    # fleet trace — the pre-fleet budgeting strawman, kept as an
    # ablation for benchmarks.
    estimator_scope: str = "device"
    # Online adaptation (serving/control.py, DESIGN.md §12): a
    # CONTROLLER_SCENARIOS name or a prebuilt `AdaptiveController` that
    # detects per-device regime shifts (change-point tests over the
    # monitor estimator's residuals) and switches budgeting policy /
    # hedge mode / estimator live from its mode table. None (default)
    # keeps the static configuration above — the golden-pinned path.
    # With a controller, `t_estimator`/`hedge` above configure nothing:
    # the active mode's table entries govern each request.
    controller: Union[str, AdaptiveController, None] = None
    # Simulation engine (DESIGN.md §13). "python": the per-request
    # reference loop (golden-pinned). "scan": the jit-compiled
    # `lax.scan` array program over per-device state columns
    # (serving/scan_engine.py) — same decisions, modes, and events;
    # estimator-derived floats agree to the estimator-series ULP
    # tolerance. Requires registry-spec estimators/detectors (or cold
    # instances) and no memory budget.
    engine: str = "python"
    # Shard the device axis of the scan program across this many jax
    # devices (repro.utils.shard_map; bitwise identical to shards=1).
    # CPU runs get a mesh via repro.utils.config.configure(
    # host_devices=N) before jax initializes.
    shards: int = 1


@dataclass
class SimResult:
    attainment: float            # fraction of requests meeting the SLA
    accuracy: float              # expected accuracy of selections
    mean_latency: float
    p50_latency: float
    p95_latency: float
    selections: np.ndarray       # (N,) model indices; -1 = on-device
    latencies: np.ndarray
    violations: np.ndarray       # bool
    cold_starts: int
    hedges: int = 0              # replica re-issues (max one/request)
    fallbacks: int = 0           # requests served on-device
    regimes: Optional[np.ndarray] = None       # (N,) network regime ids
    regime_names: Optional[Sequence[str]] = None
    accuracies: Optional[np.ndarray] = None    # (N,) selected A(m)
    degraded: Optional[np.ndarray] = None      # (N,) outage-detector bool
    device_index: Optional[np.ndarray] = None  # (N,) fleet device index
    device_ids: Optional[Sequence[str]] = None
    # Workload capture (serving/trace.py `Trace.from_sim`): the drawn
    # upload times and arrival clock of this run.
    t_inputs: Optional[np.ndarray] = None      # (N,) ms
    arrivals: Optional[np.ndarray] = None      # (N,) ms
    # Online control (SimConfig.controller, DESIGN.md §12): the mode
    # governing each request plus the controller's switch events
    # (persisted by `Trace.from_sim` as meta["control_events"]).
    modes: Optional[np.ndarray] = None         # (N,) int64 mode index
    mode_names: Optional[Sequence[str]] = None
    switch_events: Optional[List[dict]] = None
    # Model names in selection-index order (set by `simulate`); lets
    # `summary()` report name-keyed selections like the other stacks.
    model_names: Optional[Sequence[str]] = None

    def summary(self) -> dict:
        """The unified serving summary schema (serving/metrics.py) over
        this run — same keys as `ServingMetrics.summary()`; queueing is
        folded into latency here, so the queue columns report 0."""
        sel: Dict[str, int] = {}
        if self.model_names is not None:
            counts = np.bincount(self.selections[self.selections >= 0],
                                 minlength=len(self.model_names))
            sel = {n: int(c)
                   for n, c in zip(self.model_names, counts) if c}
            n_fb = int((self.selections < 0).sum())
            if n_fb:
                sel["<on-device>"] = n_fb
        out = {
            "served": int(len(self.latencies)),
            "attainment": self.attainment,
            "accuracy": self.accuracy,
            "mean_ms": self.mean_latency,
            "p95_ms": self.p95_latency,
            "mean_queue_ms": 0.0,
            "p95_queue_ms": 0.0,
            "selections": sel,
        }
        if self.device_index is not None:
            out["by_device"] = self.per_device()
        if self.modes is not None:
            out["by_mode"] = self.per_mode()
            out["fallbacks"] = self.fallbacks
        if self.hedges:
            out["hedges"] = self.hedges
        return out

    def per_tenant(self) -> Dict[str, Dict[str, float]]:
        """Schema parity with `ServingMetrics` — the simulator is
        single-tenant, so always empty."""
        return {}

    def selection_histogram(self, names: Sequence[str]) -> Dict[str, float]:
        cloud = self.selections[self.selections >= 0]
        h = np.bincount(cloud, minlength=len(names)) / len(self.selections)
        out = {n: float(f) for n, f in zip(names, h)}
        n_fb = int((self.selections < 0).sum())
        if n_fb:
            out["<on-device>"] = n_fb / len(self.selections)
        return out

    def _group_stats(self, index: np.ndarray, names: Sequence[str],
                     extras: Sequence = ()) -> Dict[str, Dict[str, float]]:
        """Delegates to the shared `serving.metrics.group_stats` — the
        one group-by-attainment aggregation behind `per_regime` /
        `per_device` / `per_mode` here and the record-based
        `ServingMetrics` groupers."""
        return group_stats(index, names, violations=self.violations,
                           latencies=self.latencies,
                           accuracies=self.accuracies, extras=extras)

    def per_regime(self) -> Dict[str, Dict[str, float]]:
        """Attainment / accuracy / latency split by network regime
        (time-varying processes; one bucket for stationary runs; fleet
        runs carry device-prefixed regime names)."""
        if self.regimes is None:
            return {}
        names = self.regime_names or [
            f"regime{k}" for k in range(int(self.regimes.max()) + 1)]
        return self._group_stats(self.regimes, names)

    def per_device(self) -> Dict[str, Dict[str, float]]:
        """Attainment / accuracy / latency / fallback share split by
        device (fleet runs only)."""
        if self.device_index is None:
            return {}
        names = self.device_ids or [
            f"device{d}" for d in range(int(self.device_index.max()) + 1)]
        return self._group_stats(
            self.device_index, names,
            extras=(("fallback_share", self.selections < 0),
                    ("degraded_share", self.degraded)))

    def per_mode(self) -> Dict[str, Dict[str, float]]:
        """Attainment split by governing controller mode (adaptive
        runs — SimConfig.controller; empty for static runs). The
        `share` column is the fraction of the run's requests served
        under each mode, `fallback_share` the on-device share."""
        if self.modes is None:
            return {}
        names = self.mode_names or [
            f"mode{k}" for k in range(int(self.modes.max()) + 1)]
        return self._group_stats(
            self.modes, names,
            extras=(("fallback_share", self.selections < 0),
                    ("degraded_share", self.degraded)))


def _hedge_mode(cfg: SimConfig) -> str:
    mode = cfg.hedge
    if mode not in HEDGE_MODES:
        raise ValueError(f"unknown hedge mode {mode!r}; known: "
                         f"{', '.join(HEDGE_MODES)}")
    if cfg.hedge_at_p95:                 # legacy boolean knob
        import warnings
        warnings.warn(
            "SimConfig.hedge_at_p95 is deprecated; use hedge='p95' "
            "instead (the boolean maps to exactly that mode)",
            DeprecationWarning, stacklevel=3)
        if mode not in ("none", "p95"):
            raise ValueError("hedge_at_p95=True conflicts with "
                             f"hedge={mode!r}; set one of them")
        mode = "p95"
    return mode


def _make_sim_estimator(cfg: SimConfig, fleet: Optional[FleetMixture],
                        net: Optional[NetworkProcess]):
    """Resolve SimConfig.t_estimator for the run: a per-device
    `EstimatorBank` when a fleet (or a lag) is involved, a plain
    deep-copied estimator otherwise. simulate() must never mutate a
    caller's estimator instance (sla_sweep reuses one config)."""
    spec = cfg.t_estimator
    if isinstance(spec, TInputEstimator):
        spec = copy.deepcopy(spec)
    if cfg.estimator_lag < 0:
        raise ValueError(f"estimator_lag must be >= 0, "
                         f"got {cfg.estimator_lag}")
    if fleet is None and cfg.estimator_lag == 0:
        # Pre-fleet path, bit-identical to the golden-pinned behaviour.
        if isinstance(spec, TInputEstimator) and spec.prior is None:
            spec.prior = net.mean        # instances get the same prior
        return make_estimator(spec, prior=net.mean)  # a string spec would
    if spec is None and cfg.estimator_lag > 0:
        # Stale view of raw observations = last *known* upload time.
        spec = "ewma:1.0"
    if spec is None:
        return None
    if fleet is not None:
        # The scan engine reads per-device priors from the fleet's
        # `prior_array` directly; materializing the O(D) dict here
        # would dominate setup at a million devices.
        priors = fleet.priors() if cfg.engine == "python" else {}
        return EstimatorBank(spec, priors=priors,
                             default_prior=fleet.mean,
                             lag=cfg.estimator_lag)
    # Single shared process but a stale (lagged) view: one bank entry.
    return EstimatorBank(spec, default_prior=net.mean,
                         lag=cfg.estimator_lag)


def simulate(profiles: Sequence[ModelProfile], cfg: SimConfig, *,
             exec_override: Optional[np.ndarray] = None) -> SimResult:
    """Run the simulation. `exec_override` replays *measured* execution
    times (trace capture/replay, DESIGN.md §11): an (N, K) array whose
    non-NaN entries replace the sampled execution time of model k for
    request i — a capture knows the measured time of the model it
    actually ran, so its column is filled and the rest stay NaN
    (sampled from the profile as usual)."""
    rng = np.random.default_rng(cfg.seed)
    if cfg.engine not in ("python", "scan"):
        raise ValueError(f"unknown engine {cfg.engine!r}; known: "
                         f"python, scan")
    if cfg.engine == "scan" and cfg.memory_budget_bytes is not None:
        raise ValueError("engine='scan' does not model the zoo memory "
                         "budget (LRU eviction is request-sequential); "
                         "use engine='python'")
    if cfg.shards < 1:
        raise ValueError(f"shards must be >= 1, got {cfg.shards}")
    fleet = make_fleet(cfg.fleet)
    net = make_network(cfg.network) if fleet is None else None
    hedge = _hedge_mode(cfg)
    # Decorrelate the policy's RNG stream from the trace rng above —
    # seeding both with cfg.seed would make e.g. the random baseline's
    # picks depend on the very draws that generated the workload.
    policy_seed = int(np.random.SeedSequence([cfg.seed, 1]).generate_state(1)[0])
    # The estimator's cold-start prior is the process's long-run mean —
    # exactly what a server trusting offline measurements would use.
    estimator = _make_sim_estimator(cfg, fleet, net)
    router = Router(profiles, policy=cfg.policy,
                    t_threshold=cfg.t_threshold,
                    stage2_variant=cfg.stage2_variant, seed=policy_seed,
                    memory_budget_bytes=cfg.memory_budget_bytes,
                    t_estimator=estimator)
    zoo = router.zoo
    if cfg.prewarm:
        router.prewarm()
    # The per-request control step — estimate, (adapt,) select, hedge,
    # fall back — lives in the shared ControlPlane (DESIGN.md §12).
    # A prebuilt controller instance is deep-copied: simulate() must
    # never mutate a caller's controller (plan reuse across runs).
    ctrl = make_controller(cfg.controller)
    if ctrl is not None and ctrl is cfg.controller:
        ctrl = copy.deepcopy(ctrl)
    plane = ControlPlane(
        router, hedge=hedge, outage_factor=cfg.outage_factor,
        on_device_fallback=cfg.on_device_fallback, controller=ctrl,
        priors=(fleet.priors()
                if fleet is not None and cfg.engine == "python"
                else {}),
        default_prior=fleet.mean if fleet is not None else net.mean,
        lag=cfg.estimator_lag, seed=policy_seed,
        t_threshold=cfg.t_threshold, stage2_variant=cfg.stage2_variant)

    N = cfg.n_requests
    if fleet is None:
        t_inputs, regimes = net.sample_trace(rng, N)
        device_index = device_keys = None
        regime_names = net.regime_names()
        device_ids: Optional[List[str]] = None
        prior_vec = None
        prior_mean = np.full(N, net.mean)
    else:
        ftrace = fleet.sample_trace(rng, N)
        t_inputs, regimes = ftrace.t_input, ftrace.regime
        device_index = ftrace.device_index
        device_keys = ftrace.device_keys()
        regime_names = ftrace.regime_names
        device_ids = ftrace.device_ids
        prior_vec = fleet.prior_array()
        prior_mean = prior_vec[device_index]
    # Pre-sample each model's hypothetical execution time per request so
    # the oracle and the actual run see consistent draws.
    exec_samples = np.empty((N, len(profiles)))  # (N, K), column-filled
    for k, p in enumerate(profiles):
        np.maximum(rng.normal(p.mu, p.sigma + 1e-9, N), 0.1 * p.mu,
                   out=exec_samples[:, k])
    if exec_override is not None:
        exec_override = np.asarray(exec_override, np.float64)
        if exec_override.shape != exec_samples.shape:
            raise ValueError(f"exec_override shape {exec_override.shape} "
                             f"does not match (N, K) = "
                             f"{exec_samples.shape}")
        known = ~np.isnan(exec_override)
        exec_samples[known] = exec_override[known]

    # Optional open-loop queueing.
    if cfg.arrival_rate_hz > 0:
        arrivals = np.cumsum(rng.exponential(1000.0 / cfg.arrival_rate_hz, N))
    else:
        arrivals = np.zeros(N)
    server_free = np.zeros(cfg.n_servers)

    # The whole trace's control plan (serving/control.py): vectorized
    # admission — estimates materialized first (router state advances
    # exactly once per observation), then chunked select_batch calls —
    # plus the outage/fallback masks and, with a controller, the
    # per-request modes and switch events. Static configs follow the
    # golden-pinned pre-extraction sequence exactly.
    if cfg.estimator_scope not in ("device", "global"):
        raise ValueError(f"unknown estimator_scope "
                         f"{cfg.estimator_scope!r}; known: device, global")
    on_device = None
    if fleet is not None:
        od_ms, od_sg, od_acc = fleet.on_device_arrays()
        on_device = (od_ms[device_index], od_sg[device_index],
                     od_acc[device_index])
    if cfg.engine == "scan":
        from repro_torch.serving.scan_engine import scan_plan_batch
        plan = scan_plan_batch(
            plane, rng, cfg.t_sla, t_inputs,
            device_index=device_index,
            prior_vec=prior_vec if fleet is not None else None,
            device_names=device_ids,
            estimator_scope=cfg.estimator_scope,
            realized=exec_samples, prior_mean=prior_mean,
            on_device=on_device, shards=cfg.shards)
    else:
        plan = plane.plan_batch(rng, cfg.t_sla, t_inputs,
                                device_keys=device_keys,
                                realized=exec_samples,
                                prior_mean=prior_mean,
                                on_device=on_device,
                                estimator_scope=cfg.estimator_scope)
    sel = plan.sel
    degraded, fb_mask = plan.degraded, plan.fb_mask
    od_latency, od_accuracy = plan.od_latency, plan.od_accuracy

    if cfg.engine == "scan":
        from repro_torch.serving.scan_engine import scan_event_phase
        lat, sel, hedges, fallbacks = scan_event_phase(
            cfg, plan, t_inputs, arrivals, exec_samples, profiles,
            zoo, rng)
        return _assemble_result(cfg, plan, lat, sel, hedges,
                                fallbacks, zoo, profiles, regimes,
                                regime_names, degraded, device_index,
                                device_ids, t_inputs, arrivals)
    lat = np.zeros(N)
    hedges = fallbacks = 0
    now = 0.0
    for i in range(N):
        now = arrivals[i]
        if fb_mask is not None and fb_mask[i]:
            # On-device fallback: no upload, no queue, no cold start.
            lat[i] = od_latency[i]
            sel[i] = -1
            fallbacks += 1
            continue
        ti = t_inputs[i]
        idx = sel[i]
        startup = zoo.ensure_hot(profiles[idx].name, now, rng)
        exec_t = exec_samples[i, idx] + startup
        if cfg.arrival_rate_hz > 0:
            # Open loop: queue at the earliest-free server.
            s = int(np.argmin(server_free))
            start = max(now + ti, server_free[s])
            queue_wait = start - (now + ti)
            do_hedge = cfg.n_servers > 1 and (
                (plan.p95_gate[i] and queue_wait > 0.05 * cfg.t_sla)
                or plan.outage_gate[i])
            if do_hedge:
                # Hedge: re-issue to the next server (straggler
                # mitigation); counted once per request whether or not
                # the second replica wins.
                s2 = int(np.argsort(server_free)[1])
                start2 = max(now + ti, server_free[s2])
                if start2 < start:
                    s, start = s2, start2
                hedges += 1
            server_free[s] = start + exec_t
            queue = start - (now + ti)
        else:
            queue = 0.0  # closed loop: requests are independent
        lat[i] = ti + queue + exec_t + ti  # up + queue + exec + down
    return _assemble_result(cfg, plan, lat, sel, hedges, fallbacks,
                            zoo, profiles, regimes, regime_names,
                            degraded, device_index, device_ids,
                            t_inputs, arrivals)


def _assemble_result(cfg, plan, lat, sel, hedges, fallbacks, zoo,
                     profiles, regimes, regime_names, degraded,
                     device_index, device_ids, t_inputs,
                     arrivals) -> SimResult:
    """Metrics + SimResult from a finished run — shared verbatim by
    the python event loop and the scan engine."""
    viol = lat > cfg.t_sla
    prof_acc = np.array([p.accuracy for p in profiles])
    acc = prof_acc[np.maximum(sel, 0)]
    if plan.od_accuracy is not None:
        acc = np.where(sel < 0, plan.od_accuracy, acc)
    return SimResult(
        attainment=float(1.0 - viol.mean()),
        accuracy=float(acc.mean()),
        mean_latency=float(lat.mean()),
        p50_latency=float(np.percentile(lat, 50)),
        p95_latency=float(np.percentile(lat, 95)),
        selections=sel,
        latencies=lat,
        violations=viol,
        cold_starts=zoo.total_cold_starts,
        hedges=hedges,
        fallbacks=fallbacks,
        regimes=regimes,
        regime_names=regime_names,
        accuracies=acc,
        degraded=degraded,
        device_index=device_index,
        device_ids=device_ids,
        t_inputs=t_inputs,
        arrivals=arrivals,
        modes=plan.modes,
        mode_names=plan.mode_names,
        switch_events=plan.events or None,
        model_names=[p.name for p in profiles],
    )


def sla_sweep(profiles, slas, policy="cnnselect", **kw) -> List[SimResult]:
    out = []
    for s in slas:
        cfg = SimConfig(t_sla=float(s), policy=policy, **kw)
        out.append(simulate(profiles, cfg))
    return out


def attainment_improvement(profiles, slas, *, base_policy="greedy",
                           target=0.95, **kw) -> dict:
    """Paper headline: fraction of SLA points where CNNSelect maintains
    attainment >= target vs. the greedy baseline ("88.5% more cases")."""
    ours = sla_sweep(profiles, slas, "cnnselect", **kw)
    base = sla_sweep(profiles, slas, base_policy, **kw)
    ours_ok = np.array([r.attainment >= target for r in ours])
    base_ok = np.array([r.attainment >= target for r in base])
    more = (ours_ok & ~base_ok).sum()
    return {
        "slas": list(map(float, slas)),
        "ours_attainment": [r.attainment for r in ours],
        "base_attainment": [r.attainment for r in base],
        "ours_accuracy": [r.accuracy for r in ours],
        "base_accuracy": [r.accuracy for r in base],
        "ours_ok_cases": int(ours_ok.sum()),
        "base_ok_cases": int(base_ok.sum()),
        "improvement_cases_pct": float(
            100.0 * more / max(base_ok.sum(), 1)) if base_ok.sum() else
        float(100.0 * more / max(len(slas), 1)),
    }
