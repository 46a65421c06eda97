"""The `ServingStack` protocol: one API over every serving stack.

The paper evaluates CNNSelect in three settings — a live prototype
server (`CNNSelectServer`, batch-of-one), a continuous-batching loop
(`ServingLoop`), and event-driven simulation (`simulate`). Each grew
its own entry points, so nothing could compose them. The protocol is
the enabling redesign for the multi-tenant cluster (serving/cluster.py,
DESIGN.md §16): a stack is anything that can

- ``submit(req, *, now=0.0) -> StackOutcome``  — admit one request
  (executing it inline, or queueing it with ``pending=True``),
- ``drain()``                                   — run queued work,
- ``observe_outcome(name, latency_ms, ...)``    — feed a measured
  latency back into its online profiles,
- expose ``metrics``                            — the unified
  `ServingMetrics` ledger (serving/metrics.py).

`Cluster` composes replicas through exactly this surface without
caring which kind they are. `SimReplicaStack` is the third
implementation: the simulator's sampled-execution semantics (profile
lognormals, cold starts, a single-server virtual clock) behind the
same API, cheap enough to run 10-100x today's request rates in the
multi-tenant benchmark.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Protocol, Sequence, runtime_checkable

import numpy as np

from repro_torch.core.selection import ModelProfile
from repro_torch.serving.batching import Request
from repro_torch.serving.control import ControlPlane
from repro_torch.serving.metrics import ServingMetrics
from repro_torch.serving.router import Router

__all__ = ["ServingStack", "StackOutcome", "SimReplicaStack",
           "BlockNormals"]


class BlockNormals:
    """Blocked gaussian sampling with the scalar draw order preserved.

    `SimReplicaStack` consumes one gaussian per exec sample (plus one
    per cold start), through ``Generator.normal(loc, scale)``. numpy
    computes that as ``loc + scale * standard_normal()``, and a block
    ``standard_normal(n)`` consumes the ziggurat stream exactly like n
    scalar calls — so refilling from ``standard_normal(block)`` and
    affine-transforming per draw is bit-for-bit the scalar sequence
    while paying the generator call overhead once per `block` draws
    (pinned by tests/test_cluster_engine.py).

    `take(n)` hands the next n standard normals out as an array —
    the scan cluster engine (serving/cluster_engine.py) pre-draws each
    replica's whole stream from a deepcopy of this object, then calls
    `take` on the live one to advance it by exactly the count the scan
    consumed, so python and scan paths leave identical RNG state.
    """

    def __init__(self, seed, *, block: int = 256):
        self.gen = (seed if isinstance(seed, np.random.Generator)
                    else np.random.default_rng(seed))
        self.block = int(block)
        self._z = np.empty(0, np.float64)
        self._i = 0

    def normal(self, loc: float = 0.0, scale: float = 1.0) -> float:
        if self._i >= len(self._z):
            self._z = self.gen.standard_normal(self.block)
            self._i = 0
        z = self._z[self._i]
        self._i += 1
        return float(loc + scale * z)

    def take(self, n: int) -> np.ndarray:
        """Consume the next `n` standard normals, leaving the state
        exactly where n scalar `normal` calls would."""
        out = np.empty(int(n), np.float64)
        filled = 0
        while filled < len(out):
            if self._i >= len(self._z):
                self._z = self.gen.standard_normal(self.block)
                self._i = 0
            k = min(len(self._z) - self._i, len(out) - filled)
            out[filled:filled + k] = self._z[self._i:self._i + k]
            self._i += k
            filled += k
        return out


@dataclass
class StackOutcome:
    """What a stack can say about a request at submission time.

    Inline stacks (server, sim replica) know the outcome immediately;
    queueing stacks (the loop) return ``pending=True`` and the outcome
    lands in `metrics.records` at `drain`."""
    model: str
    mode: str = "static"
    e2e_ms: Optional[float] = None
    ok: Optional[bool] = None
    pending: bool = False
    tenant: Optional[str] = None
    hedged: bool = False
    fallback: bool = False


@runtime_checkable
class ServingStack(Protocol):
    """Structural type for a serving stack (module docstring). Checked
    with ``isinstance`` (``issubclass`` rejects protocols with data
    members); the conformance suite in tests/test_stack.py runs the
    same behavioural contract against all implementations."""

    metrics: ServingMetrics

    def submit(self, req: Request, *, now: float = 0.0) -> StackOutcome:
        ...

    def drain(self) -> None:
        ...

    def observe_outcome(self, name: str, latency_ms: float, *,
                        cold: bool = False, now: float = 0.0) -> None:
        ...


class SimReplicaStack:
    """A simulated single-server replica behind the `ServingStack` API.

    Execution is sampled from the registered profiles (the simulator's
    semantics: gaussian exec via `ModelZoo.sample_exec`, cold-start
    penalty via `ensure_hot`, FIFO queueing at one virtual server) —
    no engines, so a `Cluster` of these runs 10-100x today's request
    rates. `speed` scales execution (a replica on faster silicon);
    `tokens_per_s` carries the *measured* capacity score when the
    profiles came from `measured_profiles` (PR 7's executed tokens/s,
    not table lookups) and backs `capacity_score`.
    """

    def __init__(self, profiles: Sequence[ModelProfile], *,
                 policy: str = "cnnselect", t_threshold: float = 50.0,
                 seed: int = 0, controller=None, t_estimator=None,
                 speed: float = 1.0,
                 memory_budget_bytes: Optional[int] = None,
                 tokens_per_s: Optional[float] = None,
                 name: str = "replica"):
        self.name = name
        self.router = Router(profiles, policy=policy,
                             t_threshold=t_threshold, seed=seed,
                             t_estimator=t_estimator,
                             memory_budget_bytes=memory_budget_bytes)
        self.control = ControlPlane(self.router, controller=controller,
                                    seed=seed, t_threshold=t_threshold)
        self.speed = float(speed)
        self.tokens_per_s = tokens_per_s
        self.metrics = ServingMetrics()
        self.rng = BlockNormals(
            np.random.default_rng(np.random.SeedSequence(seed)))
        self._server_free = 0.0
        # Cluster-wide placement hook (serving/cluster.py): when set,
        # hot transitions route through the placer's global budget
        # instead of this replica's own zoo LRU.
        self._placer = None

    # -- capacity -----------------------------------------------------
    def capacity_score(self) -> float:
        """Requests/s this replica can execute, used for scale-up
        ordering and hedge targets: the measured executed tokens/s when
        available, else 1000/mu of the fastest profile (a pure-profile
        proxy with the same ordering semantics)."""
        if self.tokens_per_s is not None:
            return float(self.tokens_per_s)
        mus = [p.mu for p in self.router.current_profiles() if p.mu > 0]
        return 1000.0 / min(mus) if mus else 0.0

    @property
    def free_time(self) -> float:
        """When the virtual server frees up — the raw queue state.
        `Cluster` caches this per replica and derives `queue_delay`
        itself (same ``max(0, free - arrive)`` expression, so the
        cached path is bit-for-bit the uncached one)."""
        return self._server_free

    def queue_delay(self, now: float) -> float:
        """How long a request arriving `now` waits before executing."""
        return max(0.0, self._server_free - now)

    # -- placement ----------------------------------------------------
    def attach_placer(self, placer) -> None:
        self._placer = placer

    def _ensure_hot(self, name: str, now: float) -> float:
        if self._placer is not None:
            return self._placer.ensure_hot(self, name, now)
        return self.router.zoo.ensure_hot(name, now, self.rng)

    # -- ServingStack -------------------------------------------------
    def submit(self, req: Request, *, now: float = 0.0) -> StackOutcome:
        t_sla = req.sla_ms or 1e9
        d = self.control.step(t_sla, req.t_input_ms,
                              device_id=req.device_id)
        startup = self._ensure_hot(d.name, now)
        exec_ms = (self.router.zoo.sample_exec(d.name, self.rng)
                   / self.speed + startup)
        arrive = now + req.t_input_ms
        start = max(arrive, self._server_free)
        queue = start - arrive
        self._server_free = start + exec_ms
        e2e = 2 * req.t_input_ms + queue + exec_ms
        ok = (e2e <= t_sla) if req.sla_ms else True
        acc = self.router.zoo.entries[d.name].profile.accuracy
        self.metrics.add(req, d.name, queue_ms=queue, exec_ms=exec_ms,
                         mode=d.mode, e2e_ms=e2e, ok=ok, accuracy=acc)
        return StackOutcome(model=d.name, mode=d.mode, e2e_ms=e2e,
                            ok=ok, tenant=req.tenant)

    def drain(self) -> None:
        """Inline execution — nothing queued across submits."""

    def observe_outcome(self, name: str, latency_ms: float, *,
                        cold: bool = False, now: float = 0.0) -> None:
        self.control.observe_outcome(name, latency_ms, cold=cold,
                                     now=now)
