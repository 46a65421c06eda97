"""Model zoo with cold/hot lifecycle management.

Paper §4.1 ("Impact of model startup latency"): cold-start inference is
one to two orders of magnitude slower than hot-start, so "it is critical
to keep important and often used CNN models in the memory". The zoo
models exactly that: an accelerator-memory budget, LRU eviction, and a
cold-start penalty charged when a request lands on a cold model."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.selection import ModelProfile


@dataclass
class ZooEntry:
    profile: ModelProfile
    hot: bool = False
    last_used: float = 0.0
    loads: int = 0
    evictions: int = 0
    runner: object = None  # optional real engine (repro.serving.engine)


class ModelZoo:
    def __init__(self, memory_budget_bytes: Optional[int] = None):
        self.entries: Dict[str, ZooEntry] = {}
        self.memory_budget = memory_budget_bytes
        self.total_cold_starts = 0

    def register(self, profile: ModelProfile, *, hot: bool = False,
                 runner=None):
        self.entries[profile.name] = ZooEntry(profile, hot=hot,
                                              runner=runner)

    @property
    def names(self) -> List[str]:
        return list(self.entries)

    def profiles(self) -> List[ModelProfile]:
        return [e.profile for e in self.entries.values()]

    def hot_bytes(self) -> int:
        return sum(e.profile.size_bytes for e in self.entries.values()
                   if e.hot)

    def ensure_hot(self, name: str, now: float,
                   rng: Optional[np.random.Generator] = None) -> float:
        """Returns the startup delay paid by this request (0 if hot).
        Evicts LRU entries if the memory budget would be exceeded."""
        e = self.entries[name]
        e.last_used = now
        if e.hot:
            return 0.0
        # Evict until it fits.
        if self.memory_budget is not None:
            while (self.hot_bytes() + e.profile.size_bytes
                   > self.memory_budget):
                victims = [x for x in self.entries.values()
                           if x.hot and x.profile.name != name]
                if not victims:
                    break
                v = min(victims, key=lambda x: x.last_used)
                v.hot = False
                v.evictions += 1
        e.hot = True
        e.loads += 1
        self.total_cold_starts += 1
        p = e.profile
        # Cold start adds (cold - hot) extra latency on top of execution.
        extra_mu = max(p.cold_mu - p.mu, 0.0)
        extra_sg = max(p.cold_sigma - p.sigma, 0.0)
        if rng is None or extra_mu == 0.0:
            return extra_mu
        return float(max(rng.normal(extra_mu, extra_sg + 1e-9), 0.0))

    def evict(self, name: str) -> None:
        """Force-evict one entry (cluster-wide placement,
        serving/cluster.py: the placer's global budget decides victims
        across zoos, then evicts here)."""
        e = self.entries[name]
        if e.hot:
            e.hot = False
            e.evictions += 1

    def lru_hot(self, exclude=()) -> Optional[ZooEntry]:
        """The least-recently-used hot entry (eviction candidate),
        skipping `exclude` names; None when nothing is evictable."""
        victims = [e for e in self.entries.values()
                   if e.hot and e.profile.name not in exclude]
        return min(victims, key=lambda e: e.last_used) if victims else None

    def sample_exec(self, name: str, rng: np.random.Generator) -> float:
        p = self.entries[name].profile
        return float(max(rng.normal(p.mu, p.sigma + 1e-9), 0.1 * p.mu))

    def prewarm(self, names, now: float = 0.0):
        for n in names:
            self.ensure_hot(n, now)
        self.total_cold_starts = 0
