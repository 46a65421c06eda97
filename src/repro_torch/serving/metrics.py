"""One metrics schema for every serving stack (DESIGN.md §16).

Pre-unification the three entry points grew three incompatible report
surfaces: `CNNSelectServer` counted into `ServerMetrics` fields,
`ServingLoop` appended `LoopMetrics` record dicts, and `simulate()`
returned `SimResult` arrays — same questions (served / attainment /
latency, split by device / mode), three shapes. `ServingMetrics` is the
one record-of-dicts ledger behind the first two (and the `Cluster`),
and `group_stats` is the one group-by-attainment aggregation shared
with `SimResult.per_regime / per_device / per_mode`.

Unified `summary()` schema (every stack, simulator included):

    served, attainment, accuracy, mean_ms, p95_ms,
    mean_queue_ms, p95_queue_ms, selections
    + by_device   (when any request carried a device_id)
    + by_mode, fallbacks (when any mode beyond "static" governed)
    + by_tenant   (when any request carried a tenant tag)
    + hedges      (when any request was duplicated cross-replica)

Unified per-bucket schema (`per_device` / `per_mode` / `per_tenant`,
and `SimResult.per_regime`): share, served, attainment, mean_latency
(+ accuracy when recorded, + extra mean columns).

The pre-unification attribute names (`latencies_ms`, `accuracies`,
`selections`, `by_device`, `by_mode` as raw containers) survive as
deprecated read-only aliases that emit `DeprecationWarning` (pinned by
tests/test_stack.py); the loop's `mean_e2e_ms`/`p95_e2e_ms` summary
keys became `mean_ms`/`p95_ms` (migration note in CHANGES.md).
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.serving.batching import Request

__all__ = ["ServingMetrics", "group_stats"]


def group_stats(index: np.ndarray, names: Sequence[str], *,
                violations: np.ndarray, latencies: np.ndarray,
                accuracies: Optional[np.ndarray] = None,
                extras: Sequence = ()) -> Dict[str, Dict[str, float]]:
    """The one group-by-attainment aggregation behind every
    `per_regime` / `per_device` / `per_mode` / `per_tenant`: bucket
    requests by an (N,) integer index, report share / served /
    attainment / mean latency (+ accuracy when recorded) per named
    bucket. `extras` adds ``(label, (N,) array)`` mean columns; a None
    array is skipped. NaN accuracies (requests with no recorded score)
    are excluded from the bucket mean; an all-NaN bucket omits the key.
    """
    index = np.asarray(index)
    violations = np.asarray(violations)
    latencies = np.asarray(latencies)
    out: Dict[str, Dict[str, float]] = {}
    for k, name in enumerate(names):
        mask = index == k
        if not mask.any():
            continue
        d = {
            "share": float(mask.mean()),
            "served": int(mask.sum()),
            "attainment": float(1.0 - violations[mask].mean()),
            "mean_latency": float(latencies[mask].mean()),
        }
        if accuracies is not None:
            a = np.asarray(accuracies, float)[mask]
            a = a[~np.isnan(a)]
            if a.size:
                d["accuracy"] = float(a.mean())
        for label, arr in extras:
            if arr is not None:
                d[label] = float(np.asarray(arr)[mask].mean())
        out[name] = d
    return out


def _warn(name: str, repl: str):
    warnings.warn(
        f"ServingMetrics.{name} is deprecated; use {repl}",
        DeprecationWarning, stacklevel=3)


@dataclass
class ServingMetrics:
    """Per-request outcome ledger shared by every `ServingStack`.

    One dict per served request: rid, model, queue_ms, exec_ms, e2e_ms,
    device, mode, ok, tenant, accuracy, fallback, hedged, replica.
    """

    records: List[dict] = field(default_factory=list)

    # -- recording ----------------------------------------------------
    def add(self, req: Request, model: str, queue_ms: float = 0.0,
            exec_ms: float = 0.0, mode: Optional[str] = None, *,
            e2e_ms: Optional[float] = None, ok: Optional[bool] = None,
            t_sla: Optional[float] = None,
            accuracy: Optional[float] = None,
            tenant: Optional[str] = None, fallback: bool = False,
            hedged: bool = False, replica: Optional[int] = None):
        """Record one served request. E2E defaults to the paper's
        ``2·T_input + queue + exec`` decomposition; the SLA verdict to
        ``e2e <= t_sla`` against the request's own SLA (``sla_ms == 0``
        means "no SLA": reported met). Explicit `e2e_ms`/`ok` override
        both (on-device advisories skip the upload legs entirely)."""
        if e2e_ms is None:
            e2e_ms = 2 * req.t_input_ms + queue_ms + exec_ms
        if t_sla is None:
            t_sla = req.sla_ms
        if ok is None:
            ok = (e2e_ms <= t_sla) if t_sla else True
        self.records.append({
            "rid": req.rid, "model": model, "queue_ms": queue_ms,
            "exec_ms": exec_ms, "e2e_ms": e2e_ms,
            "device": req.device_id, "mode": mode or "static",
            "ok": bool(ok),
            "tenant": tenant if tenant is not None
            else getattr(req, "tenant", None),
            "accuracy": accuracy, "fallback": bool(fallback),
            "hedged": bool(hedged), "replica": replica,
        })

    # -- scalar views -------------------------------------------------
    @property
    def served(self) -> int:
        return len(self.records)

    @property
    def violations(self) -> int:
        return sum(not r["ok"] for r in self.records)

    @property
    def attainment(self) -> float:
        return 1.0 - self.violations / max(self.served, 1)

    @property
    def fallbacks(self) -> int:
        return sum(r["fallback"] for r in self.records)

    @property
    def hedges(self) -> int:
        return sum(r["hedged"] for r in self.records)

    # -- aggregation --------------------------------------------------
    def _selection_counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for r in self.records:
            out[r["model"]] = out.get(r["model"], 0) + 1
        return out

    def _grouped(self, key: str) -> Dict[str, Dict[str, float]]:
        if not self.records:
            return {}
        names = sorted({r[key] or "<none>" for r in self.records})
        pos = {n: i for i, n in enumerate(names)}
        index = np.array([pos[r[key] or "<none>"] for r in self.records])
        accs = np.array([np.nan if r["accuracy"] is None
                         else r["accuracy"] for r in self.records])
        return group_stats(
            index, names,
            violations=np.array([not r["ok"] for r in self.records],
                                float),
            latencies=np.array([r["e2e_ms"] for r in self.records]),
            accuracies=None if np.isnan(accs).all() else accs,
            extras=(
                ("mean_queue_ms",
                 np.array([r["queue_ms"] for r in self.records])),
                ("fallback_share",
                 np.array([r["fallback"] for r in self.records],
                          float))))

    def per_device(self) -> Dict[str, Dict[str, float]]:
        """Attainment / latency split by issuing device (fleet
        traffic; "<none>" buckets untagged requests)."""
        return self._grouped("device")

    def per_mode(self) -> Dict[str, Dict[str, float]]:
        """Attainment split by governing control mode (adaptive runs;
        one 'static' bucket otherwise)."""
        return self._grouped("mode")

    def per_tenant(self) -> Dict[str, Dict[str, float]]:
        """Attainment split by tenant (multi-tenant cluster runs)."""
        return self._grouped("tenant")

    def summary(self) -> dict:
        """The unified summary schema (module docstring)."""
        n = len(self.records)
        lat = (np.array([r["e2e_ms"] for r in self.records])
               if n else np.zeros(1))
        q = (np.array([r["queue_ms"] for r in self.records])
             if n else np.zeros(1))
        acc = [r["accuracy"] for r in self.records
               if r["accuracy"] is not None]
        out = {
            "served": n,
            "attainment": self.attainment,
            "accuracy": float(np.mean(acc)) if acc else 0.0,
            "mean_ms": float(lat.mean()),
            "p95_ms": float(np.percentile(lat, 95)),
            "mean_queue_ms": float(q.mean()),
            "p95_queue_ms": float(np.percentile(q, 95)),
            "selections": dict(sorted(self._selection_counts().items())),
        }
        if any(r["device"] is not None for r in self.records):
            out["by_device"] = self.per_device()
        if {r["mode"] for r in self.records} - {"static"}:
            out["by_mode"] = self.per_mode()
            out["fallbacks"] = self.fallbacks
        if any(r["tenant"] is not None for r in self.records):
            out["by_tenant"] = self.per_tenant()
        if self.hedges:
            out["hedges"] = self.hedges
        return out

    # -- deprecated pre-unification aliases ---------------------------
    @property
    def latencies_ms(self) -> List[float]:
        _warn("latencies_ms", "records[*]['e2e_ms']")
        return [r["e2e_ms"] for r in self.records]

    @property
    def accuracies(self) -> List[float]:
        _warn("accuracies", "records[*]['accuracy']")
        return [r["accuracy"] for r in self.records
                if r["accuracy"] is not None]

    @property
    def selections(self) -> Dict[str, int]:
        _warn("selections", "summary()['selections']")
        return self._selection_counts()

    @property
    def by_device(self) -> Dict[str, List[int]]:
        _warn("by_device", "per_device()")
        out: Dict[str, List[int]] = {}
        for r in self.records:
            e = out.setdefault(r["device"] or "<none>", [0, 0])
            e[0] += 1
            e[1] += int(not r["ok"])
        return out

    @property
    def by_mode(self) -> Dict[str, int]:
        _warn("by_mode", "per_mode()")
        out: Dict[str, int] = {}
        for r in self.records:
            out[r["mode"]] = out.get(r["mode"], 0) + 1
        return out
