"""The multi-tenant cluster control plane as a scan over the request
axis, on the card (DESIGN.md §17).

`Cluster.run(engine="scan")` lands here. The python `Cluster` is the
reference implementation; this engine reproduces it **bit-for-bit** —
every integer decision (selection, placement, eviction, scale, shed,
hedge winner) and every float in the metrics ledger — by splitting the
per-request loop into three phases:

1. **Controller columns.** The `AdaptiveController` is per-device
   state with no cross-device coupling, so it runs as the scan
   engine's (L, D) column program — `ctrl_desc_from_controller` +
   `_pack_columns` + `_run_program`, as `shards` column blocks on the
   scan device. Output: each request's governing mode and the
   chronological switch-event list (the scale-up/down triggers).

2. **Selection / RNG precompute (numpy).** Policy decisions depend
   only on the request row, never on queue state, so cnnselect's
   3-stage probs collapse to one vectorized (N, K) mirror (same op
   order as `core.selection.cnnselect`) and each replica's gaussian /
   uniform / integer draws are pre-drawn from **deepcopies** of the
   live generators (`BlockNormals` blocks are bit-for-bit the scalar
   stream). After the scan, the live generators advance by exactly the
   consumed counts, so python and scan paths leave identical RNG
   state.

3. **The cluster scan (the CUDA kernel `kernels.cluster_scan`).** What
   remains coupled across requests is the small cluster state:
   per-replica free time (R,), flat hot/LRU state (R*K,), the global
   hot-byte count, the active-prefix size and the draw counters. One
   thread walks the N arrival-ordered requests and mirrors
   `Cluster.submit` op-for-op: switch-scale, least-delay placement over
   the active prefix (ties: capacity, then index — resolved by exact
   float equality, the same total order as python's tuple sort),
   load-scale, priority shedding, the placer's global-LRU evict loop
   (first-argmin = dict-order first-min), cold-start + exec sampling,
   and degraded-regime two-replica hedging with strict
   first-completion-wins. The products that feed sums round on their
   own, as numpy rounds them. The columns and constants go to the scan
   device as the reference's float64, int64, int32, int8 and bool
   arrays; on a CPU device the scan is the plain loop
   `kernels.ref.cluster_scan_ref`.

**Device.** The column program and the scan run on the card unless the
caller runs them inside ``with scan_engine.scan_device("cpu"):``;
without a card and outside such a block `scan_cluster_run` raises.

Equivalence discipline: events replay through `replay_events`
unchanged, `cluster.metrics.records` match the python engine's floats
bitwise, and replica zoos / rngs / free-times are written back so a
scan run is indistinguishable from a python run — with one documented
exception: per-replica `metrics` ledgers stay empty (the cluster ledger
is authoritative; the python engine's replica rows are a byproduct of
calling `SimReplicaStack.submit`).
"""
from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.selection import (CNNSelectPolicy, GreedyPolicy,
                                        RandomPolicy, StaticPolicy)
from repro_torch.kernels.cluster_scan import cluster_scan
from repro_torch.serving.cluster import Cluster, TenantColumns
from repro_torch.serving.scan_engine import (_assemble_events, _pack_columns,
                                             _run_program, _unfused, _unpack,
                                             ctrl_desc_from_controller)
# A statement of its own: the import above is the reference's, which
# tests/test_torch_package.py holds verbatim.
from repro_torch.serving.scan_engine import _device
from repro_torch.serving.stack import SimReplicaStack

__all__ = ["scan_cluster_run", "ClusterScanResult"]

_EPS = 1e-9


# --------------------------------------------------------------------------
# Validation: the python semantics this engine mirrors
# --------------------------------------------------------------------------

def _validate(cluster: Cluster) -> List[str]:
    """Reject configurations whose python path this engine does not
    mirror, *before* any state is touched. Returns the shared model
    name order."""
    if cluster._n or cluster.events:
        raise ValueError("engine='scan' needs a fresh cluster (no "
                         "requests submitted, no events)")
    names = None
    seen_pol, seen_rng = set(), set()
    for r in cluster.replicas:
        if type(r) is not SimReplicaStack:
            raise ValueError(
                f"engine='scan' supports SimReplicaStack replicas only "
                f"(got {type(r).__name__}); use engine='python'")
        if r.control.controller is not None:
            raise ValueError("engine='scan' cluster replicas must not "
                             "carry their own AdaptiveController (the "
                             "cluster controller is the one modeled)")
        if r.router.t_estimator is not None:
            raise ValueError("engine='scan' cluster replicas must use "
                             "the identity budget estimator "
                             "(t_estimator=None)")
        if r.control.hedge != "none":
            raise ValueError("engine='scan' cluster replicas must not "
                             "hedge internally (cluster-level hedging "
                             "is the modeled mechanism)")
        if r.router.zoo.memory_budget is not None:
            raise ValueError("engine='scan' cluster replicas must not "
                             "carry a per-zoo memory budget (the "
                             "ClusterPlacer owns the global budget)")
        if r._placer is not cluster.placer:
            raise ValueError("replica is not attached to this "
                             "cluster's placer")
        rn = tuple(r.router.order)
        if names is None:
            names = rn
        elif rn != names:
            raise ValueError("engine='scan' needs an identical model "
                             "registration order on every replica")
        pol = r.router.policy
        if type(pol) not in (CNNSelectPolicy, GreedyPolicy,
                             RandomPolicy, StaticPolicy):
            raise ValueError(
                f"engine='scan' cannot mirror policy "
                f"{type(pol).__name__}; use engine='python'")
        if id(pol) in seen_pol or id(r.rng) in seen_rng:
            raise ValueError("replicas must not share policy / rng "
                             "objects (per-replica draw streams)")
        seen_pol.add(id(pol))
        seen_rng.add(id(r.rng))
    ctrl = cluster.controller
    if ctrl is not None and (ctrl._n_seen or ctrl._events):
        raise ValueError("engine='scan' needs a pristine cluster "
                         "controller (no observations yet)")
    return list(names)


# --------------------------------------------------------------------------
# Workload columns: one layout for TenantColumns and Request lists
# --------------------------------------------------------------------------

@dataclass
class _Work:
    n: int
    arrival: np.ndarray       # (N,) f64
    t_input: np.ndarray       # (N,) f64
    dev_col: np.ndarray       # (N,) int64
    priors: np.ndarray        # (D,) f64 per-column controller prior
    device_names: object      # indexable column -> name (str() applied)
    t_sla_c: np.ndarray       # (N,) cluster-level deadline (shed/scale)
    t_sla_r: np.ndarray       # (N,) replica-level deadline (selection)
    has_sla: np.ndarray       # (N,) bool
    prio: np.ndarray          # (N,) f64 shed priority
    od: np.ndarray            # (N,) f64 on-device latency
    cols: Optional[TenantColumns] = None
    reqs: Optional[list] = None

    def dev_str(self, i: int) -> str:
        """The device string python events carry (str(key), "" for
        None) for request i."""
        name = self.device_names[self.dev_col[i]]
        return "" if name is None else str(name)

    def tenant_str(self, i: int) -> str:
        if self.cols is not None:
            return self.cols.tenants[self.cols.tenant_idx[i]].name
        return self.reqs[i].tenant or ""


def _work_from_columns(cluster: Cluster, cols: TenantColumns) -> _Work:
    n = len(cols)
    T = len(cols.tenants)
    tsc = np.empty(T)
    tsr = np.empty(T)
    has = np.empty(T, bool)
    pr = np.empty(T)
    for ti, t in enumerate(cols.tenants):
        ct = cluster.tenants.get(t.name or "")
        sla = t.t_sla          # == req.sla_ms for this tenant's rows
        c = sla or (ct.t_sla if ct is not None else 1e9)
        r = sla or 1e9
        if c is None or r is None:
            raise ValueError(f"tenant {t.name!r} has no SLA")
        tsc[ti], tsr[ti], has[ti] = c, r, bool(sla)
        pr[ti] = ct.shed_priority if ct is not None else 0
    tid = cols.tenant_idx
    return _Work(
        n=n, arrival=np.asarray(cols.arrival, np.float64),
        t_input=np.asarray(cols.t_input, np.float64),
        dev_col=np.asarray(cols.col, np.int64),
        priors=np.asarray(cols.col_prior, np.float64),
        device_names=cols, t_sla_c=tsc[tid], t_sla_r=tsr[tid],
        has_sla=has[tid], prio=pr[tid],
        od=np.asarray(cols.col_od_ms, np.float64)[cols.col],
        cols=cols)


def _work_from_requests(cluster: Cluster, requests) -> _Work:
    reqs = sorted(requests, key=lambda r: r.arrival)
    n = len(reqs)
    ctrl = cluster.controller
    col_of: Dict[object, int] = {}
    names: List[object] = []
    priors: List[float] = []
    arr = np.empty(n)
    ti_ = np.empty(n)
    dev = np.empty(n, np.int64)
    tsc = np.empty(n)
    tsr = np.empty(n)
    has = np.empty(n, bool)
    pr = np.empty(n)
    od = np.empty(n)
    for i, req in enumerate(reqs):
        key = req.device_id
        c = col_of.get(key)
        if c is None:
            c = col_of[key] = len(names)
            # Store the python event string form ("" for None), so
            # `_assemble_events` / `dev_str` emit what the python
            # controller would.
            names.append("" if key is None else str(key))
            if ctrl is not None:
                p = (ctrl._priors or {}).get(key, ctrl._default_prior)
                if p is None:
                    raise ValueError(
                        f"engine='scan' adaptive control needs a "
                        f"prior for every device (missing: {key!r})")
                priors.append(float(p))
            else:
                priors.append(np.nan)
        t = cluster.tenants.get(req.tenant or "")
        sla_c = req.sla_ms or (t.t_sla if t is not None else 1e9)
        if sla_c is None:
            raise ValueError(f"request {req.rid} has no SLA")
        arr[i], ti_[i], dev[i] = req.arrival, req.t_input_ms, c
        tsc[i], tsr[i] = sla_c, req.sla_ms or 1e9
        has[i] = bool(req.sla_ms)
        pr[i] = t.shed_priority if t is not None else 0
        od[i] = cluster.on_device_ms.get(req.device_id or "", 0.0)
    return _Work(n=n, arrival=arr, t_input=ti_, dev_col=dev,
                 priors=np.asarray(priors, np.float64),
                 device_names=names, t_sla_c=tsc, t_sla_r=tsr,
                 has_sla=has, prio=pr, od=od, reqs=reqs)


# --------------------------------------------------------------------------
# Phase 2: vectorized policy mirrors + pre-drawn RNG streams
# --------------------------------------------------------------------------

def _cnn_cdf(profiles, pol: CNNSelectPolicy, t_sla: np.ndarray,
             t_input: np.ndarray) -> np.ndarray:
    """`core.selection.cnnselect` stages 1-3 over N requests at once,
    op-for-op in f64 (same expression order, so the probabilities are
    bitwise the scalar path's), returning the normalized CDF rows that
    `rng.choice(K, p=probs)` searches with one uniform draw."""
    acc = np.array([p.accuracy for p in profiles], np.float64)
    mu = np.array([p.mu for p in profiles], np.float64)
    sg = np.array([p.sigma for p in profiles], np.float64)
    N = len(t_sla)
    t_up = t_sla - 2.0 * t_input                 # network_budget
    t_low = t_up - pol.t_threshold
    musg = mu + sg
    feas = ((musg[None, :] < t_up[:, None])
            & ((mu - sg)[None, :] < t_low[:, None]))
    any_f = feas.any(axis=1)
    masked = np.where(feas, acc[None, :], -np.inf)
    best = masked.max(axis=1)
    cand = masked >= (best - 1e-12)[:, None]
    base = np.where(
        any_f,
        np.argmin(np.where(cand, mu[None, :], np.inf), axis=1),
        int(np.argmin(mu)))
    mu_b, sg_b = mu[base], sg[base]
    if pol.stage2_variant == "figure":
        delta = np.abs(t_low - mu_b) + sg_b
        lo, hi = t_low - delta, t_low + delta
    else:                                        # "text"
        a = mu_b + sg_b
        b = 2.0 * t_low - mu_b + sg_b
        swap = t_low > mu_b
        lo, hi = np.where(swap, a, b), np.where(swap, b, a)
    elig = ((mu[None, :] >= lo[:, None]) & (mu[None, :] <= hi[:, None])
            & (musg[None, :] < t_up[:, None]))
    rows = np.arange(N)
    elig[rows, base] = True
    onehot = np.zeros_like(elig)
    onehot[rows, base] = True
    elig = np.where(any_f[:, None], elig, onehot)
    util = (acc[None, :] * (t_up[:, None] - musg[None, :])
            / np.maximum(np.abs(t_low[:, None] - mu[None, :]), _EPS))
    util = np.where(elig, np.maximum(util, _EPS), 0.0)
    total = util.sum(axis=1)
    pos = total > 0
    probs = np.where(
        pos[:, None],
        util / np.where(pos, total, 1.0)[:, None],
        elig / elig.sum(axis=1, keepdims=True))
    cdf = np.cumsum(probs, axis=1)
    cdf /= cdf[:, -1:]
    return cdf


def _greedy_sel(profiles, pol: GreedyPolicy, t_sla: np.ndarray,
                t_input: np.ndarray) -> np.ndarray:
    acc = np.array([p.accuracy for p in profiles])
    mu = np.array([p.mu for p in profiles])
    budget = (t_sla - 2.0 * t_input) if pol.use_network else t_sla
    ok = mu[None, :] <= budget[:, None]
    masked = np.where(ok, acc[None, :], -np.inf)
    return np.where(ok.any(axis=1), np.argmax(masked, axis=1),
                    int(np.argmin(mu)))


@dataclass
class _Draws:
    kind: np.ndarray          # (R,) 0=deterministic 1=cnn 2=random
    sel: np.ndarray           # (N, R) int32 precomputed det choices
    cdf: np.ndarray           # (N, R, K or 0) f64 cnnselect CDF rows
    u: np.ndarray             # (R, N or 1) f64 choice uniforms
    ri: np.ndarray            # (R, N or 1) int32 random-policy draws
    z: np.ndarray             # (R, 2N) f64 exec/cold standard normals


def _predraw(cluster: Cluster, work: _Work, K: int) -> _Draws:
    R = len(cluster.replicas)
    N = work.n
    kind = np.zeros(R, np.int32)
    sel = np.zeros((N, R), np.int32)
    cdf_rows: List[Optional[np.ndarray]] = [None] * R
    u_rows: List[Optional[np.ndarray]] = [None] * R
    ri_rows: List[Optional[np.ndarray]] = [None] * R
    z = np.empty((R, 2 * N))
    for r, rep in enumerate(cluster.replicas):
        pol = rep.router.policy
        profs = rep.router.current_profiles()
        if type(pol) is CNNSelectPolicy:
            kind[r] = 1
            cdf_rows[r] = _cnn_cdf(profs, pol, work.t_sla_r,
                                   work.t_input)
            u_rows[r] = copy.deepcopy(pol.rng).random(N)
        elif type(pol) is RandomPolicy:
            kind[r] = 2
            ri_rows[r] = copy.deepcopy(pol.rng).integers(
                K, size=N).astype(np.int32)
        elif type(pol) is GreedyPolicy:
            sel[:, r] = _greedy_sel(profs, pol, work.t_sla_r,
                                    work.t_input)
        else:                                    # StaticPolicy
            sel[:, r] = pol._index(profs)
        z[r] = copy.deepcopy(rep.rng).take(2 * N)
    any_cnn = bool((kind == 1).any())
    any_rnd = bool((kind == 2).any())
    cdf = np.zeros((N, R, K if any_cnn else 0))
    u = np.zeros((R, N if any_cnn else 1))
    ri = np.zeros((R, N if any_rnd else 1), np.int32)
    for r in range(R):
        if cdf_rows[r] is not None:
            cdf[:, r, :] = cdf_rows[r]
        if u_rows[r] is not None:
            u[r] = u_rows[r]
        if ri_rows[r] is not None:
            ri[r] = ri_rows[r]
    return _Draws(kind=kind, sel=sel, cdf=cdf, u=u, ri=ri, z=z)


# --------------------------------------------------------------------------
# The engine entry point
# --------------------------------------------------------------------------

@dataclass
class ClusterScanResult:
    """Columnar run summary (`cluster.metrics` / `cluster.events` carry
    the authoritative python-identical records)."""
    n: int
    events: List[dict]
    e2e: np.ndarray           # (N,) winner / on-device latency
    ok: np.ndarray            # (N,) bool
    shed: np.ndarray          # (N,) bool
    hedged: np.ndarray        # (N,) bool
    mode_idx: Optional[np.ndarray] = None
    rows: int = 0


def scan_cluster_run(cluster: Cluster, workload, *, shards: int = 1,
                     collect_rows: bool = True) -> ClusterScanResult:
    """Run a workload (a `TenantColumns` or a `Request` sequence)
    through the scan cluster engine, mutating `cluster` exactly as the
    python engine would (events, metrics rows, zoo/rng/queue state).
    ``collect_rows=False`` skips materializing the N metrics dicts —
    the fleet-scale benchmark path, where the columnar result is the
    product."""
    names = _validate(cluster)
    K = len(names)
    R = len(cluster.replicas)
    work = (_work_from_columns(cluster, workload)
            if isinstance(workload, TenantColumns)
            else _work_from_requests(cluster, workload))
    N = work.n
    ctrl = cluster.controller
    if N == 0:
        cluster.drain()
        return ClusterScanResult(0, [], np.empty(0), np.empty(0, bool),
                                 np.empty(0, bool), np.empty(0, bool))

    # -- phase 1: controller columns (sharded like scan_engine) -------
    alarm = np.zeros(N, np.int8)
    mode_idx = None
    ctrl_events: List[dict] = []
    degr = np.zeros(N, bool)
    if ctrl is not None:
        if np.isnan(work.priors).any():
            raise ValueError("engine='scan' adaptive control needs a "
                             "prior for every device")
        cdesc = ctrl_desc_from_controller(ctrl, table_specs=(None,))
        packed = _pack_columns(work.t_input, work.dev_col,
                               len(work.priors))
        out = _run_program(None, cdesc, packed, work.priors, shards)
        mode_idx = _unpack(packed, out["mode"], np.int64)
        ctrl_events = _assemble_events(out, packed, ctrl.mode_names(),
                                       work.device_names, work.dev_col)
        for e in ctrl_events:
            alarm[e["request"]] = np.int8(np.sign(e["alarm"]))
        degr = np.array([bool(m.degraded)
                         for m in ctrl.modes])[mode_idx]

    # -- phase 2: profiles, policies, pre-drawn streams ---------------
    draws = _predraw(cluster, work, K)
    mu = np.empty(R * K)
    sgp = np.empty(R * K)
    xmu = np.empty(R * K)
    xsgp = np.empty(R * K)
    sizes = np.empty(R * K, np.int64)
    acc_reg: List[float] = []
    hot0 = np.empty(R * K, bool)
    last0 = np.empty(R * K)
    free0 = np.empty(R)
    speed = np.empty(R)
    cap = np.empty(R)
    for r, rep in enumerate(cluster.replicas):
        free0[r] = rep._server_free
        speed[r] = rep.speed
        cap[r] = rep.capacity_score()
        for k, name in enumerate(names):
            e = rep.router.zoo.entries[name]
            p = e.profile
            f = r * K + k
            mu[f], sgp[f] = p.mu, p.sigma + 1e-9
            xmu[f] = max(p.cold_mu - p.mu, 0.0)
            xsgp[f] = max(p.cold_sigma - p.sigma, 0.0) + 1e-9
            sizes[f] = p.size_bytes
            hot0[f], last0[f] = e.hot, e.last_used
            acc_reg.append(p.accuracy)
    budget = cluster.placer.budget
    has_budget = budget is not None

    # -- phase 3: the cluster scan (kernels.cluster_scan) -------------
    dev = _device()
    xs = dict(arr=work.arrival, ti=work.t_input, slac=work.t_sla_c,
              slar=work.t_sla_r, has=work.has_sla, prio=work.prio,
              od=work.od, degr=degr, al=alarm, sel=draws.sel,
              cdf=draws.cdf)
    const = dict(
        mu=mu, sgp=sgp, p1mu=0.1 * mu, xmu=xmu, xsgp=xsgp,
        sizes=sizes, cap=cap, speed=speed,
        kind=draws.kind, u=draws.u, ri=draws.ri, z=draws.z,
        budget=np.int64(budget if has_budget else 0),
        min_active=np.int32(cluster.min_active),
        hedge=np.bool_(cluster.hedge),
        shed_factor=np.float64(cluster.shed_factor),
        headroom=np.float64(cluster.scale_headroom))
    init = (free0, hot0, last0,
            np.int64(cluster.placer.hot_bytes()),
            np.int32(cluster.n_active),
            np.zeros(R, np.int32), np.zeros(R, np.int32))
    on_dev = lambda a: torch.as_tensor(np.asarray(a), device=dev)
    carry, ys = cluster_scan({k: on_dev(v) for k, v in xs.items()},
                             tuple(on_dev(v) for v in init),
                             {k: on_dev(v) for k, v in const.items()},
                             has_budget)
    free_end, hot_end, last_end, _, n_act_end, up_end, zp_end = (
        v.cpu().numpy() for v in carry)
    ys = {k: v.cpu().numpy() for k, v in ys.items()}

    # -- event assembly (chronological within each step) --------------
    events: List[dict] = []
    no_victs = np.empty((N, 0), np.int32)    # budget-free compile path
    have = ((ys["scale1"] >= 0) | (ys["scale2"] >= 0) | ys["shed"]
            | ys["place1"] | (ys["hedged"] & ys["place2"]))
    for i in np.flatnonzero(have):
        i = int(i)
        if ys["scale1"][i] >= 0:
            events.append({
                "kind": "scale_up" if alarm[i] > 0 else "scale_down",
                "request": i + 1, "n_active": int(ys["scale1"][i]),
                "reason": f"switch:{work.dev_str(i)}"})
        if ys["scale2"][i] >= 0:
            events.append({
                "kind": "scale_up", "request": i + 1,
                "n_active": int(ys["scale2"][i]), "reason": "load"})
        if ys["shed"][i]:
            events.append({
                "kind": "shed", "request": i,
                "tenant": work.tenant_str(i),
                "device": work.dev_str(i)})
            continue
        for leg_ in ("1", "2"):
            if leg_ == "2" and not ys["hedged"][i]:
                break
            for v in ys.get("vict" + leg_, no_victs)[i]:
                if v < 0:
                    break
                events.append({
                    "kind": "evict", "request": i,
                    "replica": int(v) // K, "model": names[int(v) % K]})
            if ys["place" + leg_][i]:
                events.append({
                    "kind": "place", "request": i,
                    "replica": int(ys["j" + leg_][i]),
                    "model": names[int(ys["sel" + leg_][i])]})
    cluster.events.extend(events)

    # -- metrics rows (schema-exact vs ServingMetrics.add) ------------
    shed = ys["shed"]
    hedged = ys["hedged"]
    e2e_all = np.where(shed, work.od, ys["e2ew"])
    ok_all = np.where(shed, work.od <= work.t_sla_c, ys["okw"])
    n_rows = 0
    if collect_rows:
        mode_names = (ctrl.mode_names() if ctrl is not None else None)
        if work.cols is not None:
            cols = work.cols
            tnames = [t.name for t in cols.tenants]
            rid = range(N)
            dev_of = [cols.device_name(c) for c in cols.col]
            ten_of = [tnames[t] for t in cols.tenant_idx]
        else:
            rid = [q.rid for q in work.reqs]
            dev_of = [q.device_id for q in work.reqs]
            ten_of = [q.tenant for q in work.reqs]
        recs = cluster.metrics.records
        flatw = ys["flatw"]
        jw = ys["jw"]
        qw, xw = ys["qw"], ys["xw"]
        okw = ys["okw"]
        for i in range(N):
            mode = (mode_names[mode_idx[i]] if mode_names is not None
                    else "static")
            if shed[i]:
                recs.append({
                    "rid": rid[i], "model": "<on-device>",
                    "queue_ms": 0.0, "exec_ms": 0.0,
                    "e2e_ms": float(work.od[i]),
                    "device": dev_of[i], "mode": mode,
                    "ok": bool(ok_all[i]), "tenant": ten_of[i],
                    "accuracy": None, "fallback": True,
                    "hedged": False, "replica": None})
            else:
                f = int(flatw[i])
                recs.append({
                    "rid": rid[i], "model": names[f % K],
                    "queue_ms": float(qw[i]),
                    "exec_ms": float(xw[i]),
                    "e2e_ms": float(ys["e2ew"][i]),
                    "device": dev_of[i], "mode": mode,
                    "ok": bool(okw[i]), "tenant": ten_of[i],
                    "accuracy": acc_reg[f], "fallback": False,
                    "hedged": bool(hedged[i]), "replica": int(jw[i])})
        n_rows = N

    # -- state writeback (scan run == python run afterwards) ----------
    flat1 = (ys["j1"].astype(np.int64) * K
             + ys["sel1"].astype(np.int64))
    flat2 = (ys["j2"].astype(np.int64) * K
             + ys["sel2"].astype(np.int64))
    heat_flat = np.concatenate([flat1[ys["place1"]],
                                flat2[ys["hedged"] & ys["place2"]]])
    load_counts = np.bincount(heat_flat, minlength=R * K)
    if "vict1" in ys:
        victs = np.concatenate([ys["vict1"].ravel(),
                                ys["vict2"].ravel()])
        evict_counts = np.bincount(victs[victs >= 0], minlength=R * K)
    else:
        evict_counts = np.zeros(R * K, np.int64)
    for r, rep in enumerate(cluster.replicas):
        zoo = rep.router.zoo
        for k, name in enumerate(names):
            e = zoo.entries[name]
            f = r * K + k
            e.hot = bool(hot_end[f])
            e.last_used = float(last_end[f])
            e.loads += int(load_counts[f])
            e.evictions += int(evict_counts[f])
        zoo.total_cold_starts += int(
            load_counts[r * K:(r + 1) * K].sum())
        rep._server_free = float(free_end[r])
        rep.rng.take(int(zp_end[r]))             # advance live stream
        pol = rep.router.policy
        nu = int(up_end[r])
        if nu:
            if draws.kind[r] == 1:
                pol.rng.random(nu)
            elif draws.kind[r] == 2:
                pol.rng.integers(K, size=nu)
    if ctrl is not None:
        # Post-run inspection state: the event log and counters match
        # the python run; the bank/detector internals are not replayed
        # (a fresh prime() is required before reusing the controller).
        ctrl._events = [dict(e) for e in ctrl_events]
        ctrl._n_seen = N
        cluster._seen_switches = len(ctrl_events)
    cluster.n_active = int(n_act_end)
    cluster._n = N
    cluster.placer.request = N - 1
    cluster._free_cache = [None] * R
    cluster._cap_cache = [None] * R
    return ClusterScanResult(
        n=N, events=events, e2e=e2e_all, ok=ok_all.astype(bool),
        shed=shed, hedged=hedged, mode_idx=mode_idx, rows=n_rows)
