"""Multi-tenant cluster control plane (DESIGN.md §16).

The paper adapts one serving stack to one request stream; a mobile
backend serves M device populations (tenants) from a shared cluster of
N replicas. This layer composes the repo's pieces at that scale,
through the `ServingStack` protocol alone:

- **Replicas** are any `ServingStack` (normally `SimReplicaStack`s
  scored by *measured* executed tokens/s when their profiles came from
  `measured_profiles` — PR 7's capacity numbers, not table lookups).
- **Tenants** (`TenantSpec`) pair a device population
  (`FLEET_SCENARIOS` fleet) with an SLA class
  (`TENANT_SLA_CLASSES`) — per-tenant SLA-aware selection after
  ModiPick (arXiv:1909.02053).
- **Placement** (`ClusterPlacer`) generalizes the `ModelZoo` LRU to a
  cluster-wide memory budget: a replica heating a model may evict the
  globally least-recently-used copy on *any* replica.
- **Scaling**: the cluster-level `AdaptiveController` watches every
  tenant-device stream; its switch events drive replica
  scale-up/scale-down, and sustained queueing scales up directly.
- **Load shedding**: when every active replica's queue would blow the
  SLA anyway, a device that can run its model locally is answered with
  an on-device advisory (the MDInference duality) instead of joining a
  doomed queue.
- **Cross-replica hedging**: a degraded-regime request is duplicated
  to the two least-loaded replicas and the first completion wins
  (MDInference, arXiv:2002.06603) — the cross-replica generalization
  of the simulator's ``hedge="outage"`` second-server re-issue.

Every placement / eviction / scale / shed decision lands in
`Cluster.events` in submit order, and `capture_run` persists them as
`Trace.meta["cluster_events"]` — the same switch-event discipline the
adaptive controller established: a fresh identically-configured
cluster replaying the captured workload reproduces the event log
bit-for-bit (pinned by tests/test_cluster.py).

Replica-level metrics double-count hedged requests by design (each
replica ledgers the work it executed, including losing duplicates);
`Cluster.metrics` is the authoritative tenant-facing view — one row
per request, tagged with tenant, winning replica, and hedge flag.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

from repro_torch.configs.paper_zoo import TENANT_MIXES, TENANT_SLA_CLASSES
from repro_torch.serving.batching import Request
from repro_torch.serving.control import AdaptiveController, make_controller
from repro_torch.serving.fleet import ArrayFleet, make_fleet
from repro_torch.serving.metrics import ServingMetrics
from repro_torch.serving.stack import ServingStack, StackOutcome

__all__ = ["TenantSpec", "make_tenants", "make_tenant_workload",
           "TenantColumns", "make_tenant_columns",
           "requests_from_columns", "ClusterPlacer", "Cluster",
           "capture_run", "requests_from_cluster_trace",
           "replay_events"]


# --------------------------------------------------------------------------
# Tenants
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class TenantSpec:
    """One tenant: a device population under an SLA class.

    `weight` is the tenant's share of cluster request volume; `phase`
    places the tenant's traffic peak (fraction of the horizon) and
    `burst` its peak/trough rate ratio — staggered peaks are what a
    shared cluster exploits and static pinning cannot."""

    name: str
    sla_class: str                    # TENANT_SLA_CLASSES key
    fleet: str = "mixed_fleet"        # FLEET_SCENARIOS name
    weight: float = 1.0
    phase: float = 0.0
    burst: float = 1.0

    def __post_init__(self):
        if self.sla_class not in TENANT_SLA_CLASSES:
            raise ValueError(
                f"unknown SLA class {self.sla_class!r}; known: "
                f"{', '.join(sorted(TENANT_SLA_CLASSES))}")
        if self.weight <= 0:
            raise ValueError("tenant weight must be positive")

    @property
    def t_sla(self) -> float:
        return float(TENANT_SLA_CLASSES[self.sla_class]["t_sla"])

    @property
    def shed_priority(self) -> int:
        return int(TENANT_SLA_CLASSES[self.sla_class]["shed_priority"])


def make_tenants(mix: Union[str, Sequence]) -> List[TenantSpec]:
    """Resolve a tenant mix: a `TENANT_MIXES` name, or a sequence of
    `TenantSpec`s / dicts (the registry entry format, ``tenant`` key
    naming the tenant)."""
    if isinstance(mix, str):
        if mix not in TENANT_MIXES:
            raise ValueError(f"unknown tenant mix {mix!r}; known: "
                             f"{', '.join(sorted(TENANT_MIXES))}")
        mix = TENANT_MIXES[mix]
    out = []
    for e in mix:
        if isinstance(e, TenantSpec):
            out.append(e)
        else:
            e = dict(e)
            out.append(TenantSpec(name=e.pop("tenant"), **e))
    names = [t.name for t in out]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate tenant names: {names}")
    return out


@dataclass
class TenantColumns:
    """Columnar multi-tenant workload (the scan cluster engine's view).

    Devices live in one global *column* universe: tenant ``t``'s
    devices occupy columns ``[col_offsets[t], col_offsets[t+1])`` in
    fleet order, so per-column arrays (`col_prior`, `col_od_ms`) line
    up with the controller's device axis. Request rows are sorted by
    ``(arrival, tenant name)`` — exactly `make_tenant_workload`'s
    ordering — with row i playing rid i."""

    tenants: List[TenantSpec]
    arrival: np.ndarray       # (N,) f64, sorted
    t_input: np.ndarray       # (N,) f64
    col: np.ndarray           # (N,) int64 global device column
    tenant_idx: np.ndarray    # (N,) int64 into `tenants`
    sla_ms: np.ndarray        # (N,) f64 per-request deadline
    col_offsets: np.ndarray   # (T+1,) int64
    col_tenant: np.ndarray    # (D,) int64 owning tenant per column
    col_prior: np.ndarray     # (D,) f64 long-run mean T_input
    col_od_ms: np.ndarray     # (D,) f64 on-device latency (0 = none)
    col_local: List           # per-column local device token (str|int)

    def __len__(self) -> int:
        return len(self.arrival)

    def device_name(self, c: int) -> str:
        """The ``"<tenant>/<device>"`` id string for column `c`."""
        c = int(c)
        t = self.tenants[self.col_tenant[c]]
        return f"{t.name}/{self.col_local[c]}"

    def __getitem__(self, c: int) -> str:
        """Index-as-name view, so the columns object itself can serve
        as the scan engine's `device_names` table without materializing
        D id strings."""
        return self.device_name(c)


def _tenant_fleet_columns(fleet):
    """``(local_tokens, prior, od_ms)`` for one tenant's fleet —
    `FleetMixture` devices are keyed by id string, `ArrayFleet`
    devices by integer index (materializing 10^6 id strings would
    dwarf the workload)."""
    if isinstance(fleet, ArrayFleet):
        local = list(range(fleet.n_devices))
    else:
        local = list(fleet.device_ids)
    return local, fleet.prior_array(), fleet.on_device_arrays()[0]


def make_tenant_columns(mix: Union[str, Sequence], *,
                        n_requests: int, rate_hz: float,
                        seed: int = 0) -> TenantColumns:
    """`make_tenant_workload`'s sampler in columnar form: all-array
    arrival/T_input/device generation (no per-request python loop) plus
    the per-column prior / on-device tables. `make_tenant_workload`
    materializes `Request`s from this; the scan cluster engine consumes
    it directly."""
    tenants = make_tenants(mix)
    horizon_ms = n_requests / float(rate_hz) * 1000.0
    total_w = sum(t.weight for t in tenants)
    # Global device-column universe (all tenants, request share or not:
    # the controller priors prime every tenant's devices).
    fleets = [make_fleet(t.fleet) for t in tenants]
    per = [_tenant_fleet_columns(f) for f in fleets]
    col_offsets = np.cumsum([0] + [len(p[0]) for p in per])
    col_tenant = np.repeat(np.arange(len(tenants), dtype=np.int64),
                           [len(p[0]) for p in per])
    col_local = [tok for p in per for tok in p[0]]
    col_prior = np.concatenate([p[1] for p in per])
    col_od = np.concatenate([p[2] for p in per])
    arr_parts, ti_parts, col_parts, tid_parts = [], [], [], []
    root = np.random.SeedSequence(seed)
    for ti, (t, ss) in enumerate(zip(tenants,
                                     root.spawn(len(tenants)))):
        m = int(round(n_requests * t.weight / total_w))
        if m == 0:
            continue
        rng = np.random.default_rng(ss)
        # Arrival times by inverse-CDF over the tenant's intensity:
        # base 1 plus (burst-1) inside a window of width 0.25 around
        # `phase` (wrapped), integrated on a fixed grid.
        grid = np.linspace(0.0, 1.0, 513)
        mid = 0.5 * (grid[:-1] + grid[1:])
        dist = np.abs(((mid - t.phase + 0.5) % 1.0) - 0.5)
        lam = 1.0 + (t.burst - 1.0) * (dist < 0.125)
        cdf = np.concatenate([[0.0], np.cumsum(lam)])
        cdf /= cdf[-1]
        u = np.sort(rng.random(m))
        arrivals = np.interp(u, cdf, grid) * horizon_ms
        tr = fleets[ti].sample_trace(rng, m)
        arr_parts.append(arrivals)
        ti_parts.append(tr.t_input)
        col_parts.append(col_offsets[ti] + tr.device_index)
        tid_parts.append(np.full(m, ti, np.int64))
    arrival = np.concatenate(arr_parts)
    tenant_idx = np.concatenate(tid_parts)
    # Sort by (arrival, tenant name): lexsort is stable, so equal keys
    # keep concatenation (= mix) order, matching the python list sort.
    name_rank = np.argsort(
        np.argsort([t.name for t in tenants])).astype(np.int64)
    order = np.lexsort((name_rank[tenant_idx], arrival))
    t_sla = np.array([t.t_sla for t in tenants], np.float64)
    tenant_idx = tenant_idx[order]
    return TenantColumns(
        tenants=tenants, arrival=arrival[order],
        t_input=np.concatenate(ti_parts)[order],
        col=np.concatenate(col_parts)[order],
        tenant_idx=tenant_idx, sla_ms=t_sla[tenant_idx],
        col_offsets=col_offsets.astype(np.int64),
        col_tenant=col_tenant, col_prior=col_prior,
        col_od_ms=col_od, col_local=col_local)


def make_tenant_workload(mix: Union[str, Sequence], *,
                         n_requests: int, rate_hz: float,
                         seed: int = 0) -> List[Request]:
    """Sample a multi-tenant request trace: each tenant's share of
    `n_requests` arrives as a nonhomogeneous stream over the horizon
    ``n_requests / rate_hz`` (base load plus a `burst`-times peak in a
    window centred at `phase`), with T_input drawn from the tenant's
    own fleet. Requests carry ``device_id = "<tenant>/<device>"`` (so
    per-device estimation and control stay per-tenant-population),
    the tenant tag, and the SLA class's deadline. Deterministic in
    `seed`; returned in arrival order with sequential rids."""
    return requests_from_columns(make_tenant_columns(
        mix, n_requests=n_requests, rate_hz=rate_hz, seed=seed))


def requests_from_columns(cols: TenantColumns) -> List[Request]:
    """Materialize `Request` objects from a columnar workload (arrival
    order, sequential rids — `make_tenant_workload`'s output shape)."""
    reqs: List[Request] = []
    for i in range(len(cols)):
        t = cols.tenants[cols.tenant_idx[i]]
        reqs.append(Request(
            arrival=float(cols.arrival[i]), rid=i,
            prompt=np.zeros(4, np.int32),
            max_new_tokens=4, sla_ms=t.t_sla,
            t_input_ms=float(cols.t_input[i]),
            device_id=cols.device_name(cols.col[i]), tenant=t.name))
    return reqs


def tenant_on_device_ms(tenants: Sequence[TenantSpec]
                        ) -> Dict[str, float]:
    """``"<tenant>/<device>" -> on-device latency`` for every device
    in every tenant's fleet that can serve locally (the shed targets)."""
    out: Dict[str, float] = {}
    for t in tenants:
        fleet = make_fleet(t.fleet)
        if isinstance(fleet, ArrayFleet):
            od = fleet.on_device_arrays()[0]
            for i in np.flatnonzero(od > 0):
                out[f"{t.name}/{i}"] = float(od[i])
            continue
        for d in fleet.devices:
            if d.on_device_ms > 0:
                out[f"{t.name}/{d.device_id}"] = d.on_device_ms
    return out


def tenant_priors(tenants: Sequence[TenantSpec]) -> Dict[str, float]:
    """``"<tenant>/<device>" -> long-run mean T_input`` — the
    cluster controller's cold-start references."""
    out: Dict[str, float] = {}
    for t in tenants:
        for dev, mean in make_fleet(t.fleet).priors().items():
            out[f"{t.name}/{dev}"] = mean
    return out


# --------------------------------------------------------------------------
# Cluster-wide placement
# --------------------------------------------------------------------------

class ClusterPlacer:
    """The `ModelZoo` LRU generalized to a cluster-wide memory budget.

    Each replica's zoo keeps its own hot/cold state; the placer owns
    the *global* budget. Before a replica heats a model, the globally
    least-recently-used hot copy (across all replicas, excluding the
    copy being heated) is evicted until the new copy fits. Every
    place/evict lands in the shared `events` list with the admitting
    request index — the replay-pinned record."""

    def __init__(self, replicas: Sequence, *,
                 memory_budget_bytes: Optional[int] = None,
                 events: Optional[List[dict]] = None):
        self.replicas = list(replicas)
        self.budget = memory_budget_bytes
        self.events = [] if events is None else events
        self.request = -1      # admitting request index (set by Cluster)

    def hot_bytes(self) -> int:
        return sum(r.router.zoo.hot_bytes() for r in self.replicas)

    def _global_lru(self, skip_replica, skip_name):
        best = None
        for i, r in enumerate(self.replicas):
            exclude = (skip_name,) if r is skip_replica else ()
            e = r.router.zoo.lru_hot(exclude=exclude)
            if e is not None and (best is None
                                  or e.last_used < best[2].last_used):
                best = (i, r, e)
        return best

    def ensure_hot(self, replica, name: str, now: float) -> float:
        zoo = replica.router.zoo
        entry = zoo.entries[name]
        if not entry.hot and self.budget is not None:
            size = entry.profile.size_bytes
            while self.hot_bytes() + size > self.budget:
                victim = self._global_lru(replica, name)
                if victim is None:
                    break
                vi, vr, ve = victim
                vr.router.zoo.evict(ve.profile.name)
                self.events.append({
                    "kind": "evict", "request": self.request,
                    "replica": vi, "model": ve.profile.name})
        was_cold = not entry.hot
        startup = zoo.ensure_hot(name, now, replica.rng)
        if was_cold:
            self.events.append({
                "kind": "place", "request": self.request,
                "replica": self.replicas.index(replica),
                "model": name})
        return startup


# --------------------------------------------------------------------------
# The cluster
# --------------------------------------------------------------------------

class Cluster:
    """N replicas, M tenants, one `ServingStack` (module docstring).

    `replicas` are served in index order as a prefix: `n_active` of
    them take traffic, scale events move the boundary. Replica choice
    is least-queue-delay over the active prefix (ties: higher measured
    capacity, then lower index). The cluster itself implements
    `ServingStack`, so clusters nest anywhere a stack goes."""

    def __init__(self, replicas: Sequence, tenants: Union[str, Sequence],
                 *, memory_budget_bytes: Optional[int] = None,
                 controller: Union[str, AdaptiveController,
                                   None] = "reactive",
                 hedge: bool = True, shed_factor: float = 1.0,
                 scale_headroom: float = 0.25, min_active: int = 1,
                 engine: str = "python", shards: int = 1):
        if not replicas:
            raise ValueError("cluster needs at least one replica")
        if engine not in ("python", "scan"):
            raise ValueError(f"unknown cluster engine {engine!r}; "
                             f"known: python, scan")
        self.engine = engine
        self.shards = int(shards)
        self.replicas = list(replicas)
        self.tenants = {t.name: t for t in make_tenants(tenants)}
        self.events: List[dict] = []
        self.placer = ClusterPlacer(
            self.replicas, memory_budget_bytes=memory_budget_bytes,
            events=self.events)
        for r in self.replicas:
            if hasattr(r, "attach_placer"):
                r.attach_placer(self.placer)
        self.controller = make_controller(controller)
        if self.controller is not None:
            self.controller.prime(tenant_priors(self.tenants.values()))
        self.on_device_ms = tenant_on_device_ms(self.tenants.values())
        self.hedge = bool(hedge)
        self.shed_factor = float(shed_factor)
        self.scale_headroom = float(scale_headroom)
        self.min_active = max(1, min(int(min_active),
                                     len(self.replicas)))
        self.n_active = self.min_active
        self.metrics = ServingMetrics()
        self._n = 0               # requests admitted
        self._seen_switches = 0   # controller events already applied
        # Per-replica queue/capacity caches (None = stale). Replica
        # queue state only moves on submit/drain, so `submit` reads
        # cached `free_time` snapshots instead of recomputing O(R)
        # queue delays per request, and invalidates only the replicas
        # it touched. The delay expression is the replica's own
        # (max(0, free - arrive)), so cached decisions are bit-for-bit
        # the uncached ones (pinned by tests/test_cluster_engine.py).
        self._free_cache: List[Optional[float]] = [None] * len(replicas)
        self._cap_cache: List[Optional[float]] = [None] * len(replicas)

    # -- replica surface (lets clusters nest inside clusters) ---------
    @property
    def free_time(self) -> float:
        """Earliest child free-up — the raw queue state a parent
        cluster caches (min is monotone through max(0, .-now), so
        deriving the delay from this matches `queue_delay` bitwise)."""
        return min(r.free_time for r in self.replicas[:self.n_active])

    def queue_delay(self, now: float) -> float:
        """The best delay an arriving request would see here."""
        return min(r.queue_delay(now)
                   for r in self.replicas[:self.n_active])

    def capacity_score(self) -> float:
        return sum(r.capacity_score()
                   for r in self.replicas[:self.n_active])

    def _replica_delay(self, j: int, arrive: float) -> float:
        f = self._free_cache[j]
        if f is None:
            f = getattr(self.replicas[j], "free_time", None)
            if f is None:     # stack without queue-state exposure
                return self.replicas[j].queue_delay(arrive)
            self._free_cache[j] = f
        return max(0.0, f - arrive)

    def _replica_capacity(self, j: int) -> float:
        c = self._cap_cache[j]
        if c is None:
            c = self._cap_cache[j] = self.replicas[j].capacity_score()
        return c

    def _invalidate(self, j: int) -> None:
        self._free_cache[j] = None
        self._cap_cache[j] = None

    # -- scaling ------------------------------------------------------
    def _scale(self, delta: int, reason: str):
        new = min(max(self.n_active + delta, self.min_active),
                  len(self.replicas))
        if new == self.n_active:
            return
        self.events.append({
            "kind": "scale_up" if delta > 0 else "scale_down",
            "request": self._n, "n_active": new, "reason": reason})
        self.n_active = new

    def _apply_switches(self):
        """Controller mode switches drive replica scaling: an
        escalation (up-alarm) adds a replica, a recovery retires one.
        Events are consumed in order, once."""
        # Read the raw event list: the `events` property copies every
        # dict, which is O(total switches) per submit — O(N*S) over a
        # run. The tail is only read here, never mutated.
        ev = self.controller._events
        for e in ev[self._seen_switches:]:
            self._scale(1 if e["alarm"] > 0 else -1,
                        reason=f"switch:{e['device']}")
        self._seen_switches = len(ev)

    # -- ServingStack -------------------------------------------------
    def submit(self, req: Request, *, now: float = 0.0) -> StackOutcome:
        t = self.tenants.get(req.tenant or "")
        t_sla = req.sla_ms or (t.t_sla if t is not None else 1e9)
        self.placer.request = i = self._n
        self._n += 1
        mode = None
        if self.controller is not None:
            mode = self.controller.observe(req.device_id,
                                           req.t_input_ms)
            self._apply_switches()
        mode_name = mode.name if mode is not None else "static"
        degraded = bool(mode.degraded) if mode is not None else False
        arrive = now + req.t_input_ms
        delays = [self._replica_delay(j, arrive)
                  for j in range(self.n_active)]
        # Load-driven scale-up: queueing alone would eat the headroom
        # share of the SLA on every active replica.
        if (min(delays) > self.scale_headroom * t_sla
                and self.n_active < len(self.replicas)):
            self._scale(1, reason="load")
            delays.append(self._replica_delay(self.n_active - 1, arrive))
        # Load shedding: the cluster is saturated past the SLA itself;
        # a device with a local model serves on-device instead of
        # joining a doomed queue. Higher `shed_priority` classes need
        # proportionally deeper saturation before they shed (bronze
        # sheds first, gold last), and a shed whose local latency
        # already misses the SLA is only taken when the queue is
        # hopeless at twice the shed threshold (both paths miss, but
        # shedding protects the rest of the cluster).
        prio = t.shed_priority if t is not None else 0
        thresh = self.shed_factor * t_sla * (1 + prio)
        if min(delays) > thresh:
            od = self.on_device_ms.get(req.device_id or "", 0.0)
            if od > 0 and (od <= t_sla or min(delays) > 2 * thresh):
                self.events.append({
                    "kind": "shed", "request": i,
                    "tenant": req.tenant or "",
                    "device": req.device_id or ""})
                ok = od <= t_sla
                self.metrics.add(req, "<on-device>", mode=mode_name,
                                 e2e_ms=od, ok=ok, fallback=True)
                return StackOutcome("<on-device>", mode=mode_name,
                                    e2e_ms=od, ok=ok,
                                    tenant=req.tenant, fallback=True)
        order = sorted(
            range(self.n_active),
            key=lambda j: (delays[j], -self._replica_capacity(j), j))
        j = order[0]
        out = self.replicas[j].submit(req, now=now)
        self._invalidate(j)
        hedged = False
        if degraded and self.hedge and len(order) > 1:
            # Cross-replica hedge (MDInference): duplicate to the
            # second-least-loaded replica, first completion wins. Both
            # replicas' clocks advance — duplication costs capacity,
            # which is why only degraded-regime requests pay it.
            j2 = order[1]
            out2 = self.replicas[j2].submit(req, now=now)
            self._invalidate(j2)
            hedged = True
            if (out2.e2e_ms is not None and out.e2e_ms is not None
                    and out2.e2e_ms < out.e2e_ms):
                out, j = out2, j2
        win = (self.replicas[j].metrics.records[-1]
               if getattr(self.replicas[j], "metrics", None)
               and self.replicas[j].metrics.records else {})
        self.metrics.add(req, out.model,
                         queue_ms=win.get("queue_ms", 0.0),
                         exec_ms=win.get("exec_ms", 0.0),
                         mode=mode_name, e2e_ms=out.e2e_ms, ok=out.ok,
                         accuracy=win.get("accuracy"), hedged=hedged,
                         replica=j)
        return StackOutcome(out.model, mode=mode_name,
                            e2e_ms=out.e2e_ms, ok=out.ok,
                            tenant=req.tenant, hedged=hedged)

    def drain(self) -> None:
        for i, r in enumerate(self.replicas):
            r.drain()
            self._invalidate(i)

    def observe_outcome(self, name: str, latency_ms: float, *,
                        cold: bool = False, now: float = 0.0) -> None:
        for i, r in enumerate(self.replicas):
            r.observe_outcome(name, latency_ms, cold=cold, now=now)
            self._invalidate(i)

    # -- convenience --------------------------------------------------
    def run(self, requests) -> ServingMetrics:
        """Serve a workload — a `Request` sequence or a
        `TenantColumns` — through the configured engine. The scan
        engine (serving/cluster_engine.py) reproduces the python
        loop's events and metrics bit-for-bit."""
        if self.engine == "scan":
            from repro_torch.serving.cluster_engine import scan_cluster_run
            scan_cluster_run(self, requests, shards=self.shards)
            return self.metrics
        if isinstance(requests, TenantColumns):
            requests = requests_from_columns(requests)
        for req in sorted(requests, key=lambda r: r.arrival):
            self.submit(req, now=req.arrival)
        self.drain()
        return self.metrics


# --------------------------------------------------------------------------
# Capture / replay (the PR 5 switch-event discipline, cluster-wide)
# --------------------------------------------------------------------------

def capture_run(cluster: Cluster, requests: Sequence[Request], *,
                name: str = "cluster"):
    """Run a workload through the cluster and capture it as a `Trace`:
    the per-request workload columns plus
    ``meta["cluster_events"]`` (placement / eviction / scale / shed in
    submit order), ``meta["sla_ms"]`` (per-request deadlines), and
    ``meta["tenants"]`` — everything `requests_from_cluster_trace`
    needs to rebuild the workload and `replay_events` to verify the
    decisions replay bit-for-bit."""
    from repro_torch.serving.trace import TraceRecorder
    rec = TraceRecorder()
    ordered = sorted(requests, key=lambda r: r.arrival)
    for req in ordered:
        cluster.submit(req, now=req.arrival)
        row = cluster.metrics.records[-1]
        rec.record(t_arrival=req.arrival, t_input_ms=req.t_input_ms,
                   device_id=req.device_id, model=row["model"],
                   sla_ok=row["ok"])
    cluster.drain()
    return rec.to_trace(
        name=name, source="cluster",
        meta={"cluster_events": cluster.events,
              "sla_ms": [float(r.sla_ms) for r in ordered],
              "tenants": sorted({r.tenant for r in ordered
                                 if r.tenant})})


def requests_from_cluster_trace(trace) -> List[Request]:
    """Rebuild the captured workload (arrival order; tenant recovered
    from the ``<tenant>/<device>`` id convention)."""
    sla = trace.meta["sla_ms"]
    out = []
    for i in range(len(trace)):
        dev = str(trace.device_id[i])
        tenant = dev.split("/", 1)[0] if "/" in dev else None
        out.append(Request(
            arrival=float(trace.t_arrival[i]), rid=i,
            prompt=np.zeros(4, np.int32), max_new_tokens=4,
            sla_ms=float(sla[i]),
            t_input_ms=float(trace.t_input_ms[i]),
            device_id=dev or None, tenant=tenant))
    return out


def replay_events(trace, make_cluster) -> bool:
    """Replay verification: rebuild the workload from `trace`, run it
    through a fresh cluster from the `make_cluster` factory, and
    compare the event log bit-for-bit against
    ``meta["cluster_events"]``."""
    cluster = make_cluster()
    cluster.run(requests_from_cluster_trace(trace))
    return cluster.events == trace.meta["cluster_events"]
