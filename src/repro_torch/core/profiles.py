"""Online model performance profiles (paper: "CNN model performance
profiles are measured and managed by individual inference servers").
One `ProfileStore` per admission `Router` (serving/router.py) — the
stacks feed measured latencies back through `Router.record` and every
policy decision reads the blended view via `Router.current_profiles`.

Welford's algorithm for numerically stable streaming mean/std, plus a
staleness clock: `T_threshold` grows with profile staleness when the
optional `threshold_mode="staleness"` extension is enabled (the paper
defers dynamic adjustment to future work — flagged in DESIGN.md §8)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np


@dataclass
class OnlineProfile:
    n: int = 0
    mean: float = 0.0
    m2: float = 0.0
    last_update: float = 0.0   # wall-ish clock supplied by caller

    def update(self, x: float, now: float = 0.0):
        self.n += 1
        delta = x - self.mean
        self.mean += delta / self.n
        self.m2 += delta * (x - self.mean)
        self.last_update = now

    @property
    def var(self) -> float:
        return self.m2 / (self.n - 1) if self.n > 1 else 0.0

    @property
    def std(self) -> float:
        return float(np.sqrt(self.var))

    def staleness(self, now: float) -> float:
        return max(0.0, now - self.last_update)


class ProfileStore:
    """Per-model hot/cold latency profiles with priors.

    Priors let the store answer before any measurement (seeded from the
    dry-run roofline estimates for the LM zoo, or from paper Table 5 for
    the CNN zoo)."""

    def __init__(self):
        self._hot: Dict[str, OnlineProfile] = {}
        self._cold: Dict[str, OnlineProfile] = {}
        self._prior: Dict[str, tuple] = {}

    def set_prior(self, name: str, mu: float, sigma: float,
                  cold_mu: float = 0.0, cold_sigma: float = 0.0):
        self._prior[name] = (mu, sigma, cold_mu, cold_sigma)

    def record(self, name: str, latency: float, *, cold: bool = False,
               now: float = 0.0):
        store = self._cold if cold else self._hot
        store.setdefault(name, OnlineProfile()).update(latency, now)

    def mu_sigma(self, name: str, *, cold: bool = False,
                 min_obs: int = 5) -> tuple:
        """Blend prior with observations until min_obs measurements."""
        store = self._cold if cold else self._hot
        prior = self._prior.get(name)
        obs = store.get(name)
        if obs is None or obs.n == 0:
            if prior is None:
                raise KeyError(f"no profile or prior for {name!r}")
            return (prior[2], prior[3]) if cold else (prior[0], prior[1])
        if obs.n >= min_obs or prior is None:
            return obs.mean, obs.std
        w = obs.n / min_obs
        pm, ps = (prior[2], prior[3]) if cold else (prior[0], prior[1])
        return (w * obs.mean + (1 - w) * pm, w * obs.std + (1 - w) * ps)

    def staleness(self, name: str, now: float) -> float:
        obs = self._hot.get(name)
        return obs.staleness(now) if obs else float("inf")

    def dynamic_threshold(self, names, now: float, *, base: float,
                          t_device: float, rate: float = 0.01) -> float:
        """Optional extension: grow T_threshold with the max staleness of
        the managed profiles, bounded by [0, T_D] per the paper."""
        stale = max((min(self.staleness(n, now), 1e6) for n in names),
                    default=0.0)
        return float(np.clip(base + rate * stale, 0.0, t_device))
