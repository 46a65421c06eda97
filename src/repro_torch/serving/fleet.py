"""Device fleet layer: per-device network processes, device-keyed
T_input estimation, and on-device fallback profiles.

The paper's measurement study (§4, Table 4) shows that *which device*
issues a request dominates end-to-end time: different radios (WiFi vs
LTE vs hotspot tails) and very different on-device capabilities (a
Pixel 2 runs MobileNetV1 in ~350 ms; a Nexus 5 takes ~9 s). The
pre-fleet simulator drew every request from one shared
`NetworkProcess`; here a `FleetMixture` tags each request with a
`device_id` and draws its T_input from *that device's* process, so the
serving stack can key estimation and budgeting per device:

- `DeviceProfile` — a device tier: its radio (a `NetworkProcess` spec,
  stationary or regime-switching) plus an optional on-device execution
  profile (mean/σ/accuracy of the model the device can run locally,
  paper Table 4) used for MDInference-style fallback.
- `FleetMixture` — weighted mixture over `DeviceProfile`s. Traces are
  drawn per device from independent child RNG streams (seeded up front
  from the caller's generator), so one device's draw sequence does not
  depend on another device's process — the per-device determinism the
  fleet tests pin.
- `EstimatorBank` — the `TInputEstimator` keyed per device: each
  device gets its own estimator instance (one device's outage cannot
  move another device's estimate), with an optional observation `lag`
  that feeds each device only its own stale observations. `lag=1` is
  ModiPick's (arXiv:1909.02053) client-side view: the budget is
  estimated on the device *before* upload, so the server-side estimate
  is one RTT behind — the freshest upload measurement has not arrived
  back yet.

Named fleets live in `configs/paper_zoo.DEVICE_TIERS` /
`FLEET_SCENARIOS` and resolve through `make_fleet`. See DESIGN.md §10.
"""

from __future__ import annotations

import copy
import dataclasses
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

from repro_torch.configs.paper_zoo import (DEVICE_TIERS, DEVICES, FLEET_SCENARIOS,
                                     TABLE5, lognormal_params)
from repro_torch.serving.network import (MIN_T_INPUT_MS, NetworkProcess,
                                   TInputEstimator, estimator_factory,
                                   make_network)

# Table 4 reports on-device means without spread; mobile execution jitter
# is modeled as a fixed coefficient of variation around them.
ON_DEVICE_SIGMA_FRACTION = 0.08


@dataclass(frozen=True)
class DeviceProfile:
    """One device tier of the fleet.

    `network` is any `make_network` spec — a NETWORKS name, a
    NETWORK_SCENARIOS name, ``trace:<name>``, or a prebuilt process —
    so a tier can sit on a stationary radio or walk through outages.
    `on_device_ms == 0` means the device cannot run the model locally
    (no fallback; e.g. the paper's Nexus 5 at ~9 s is never viable).
    """

    device_id: str
    network: Union[str, NetworkProcess]
    weight: float = 1.0
    on_device_ms: float = 0.0          # 0 = no on-device capability
    on_device_sigma: float = 0.0
    on_device_accuracy: float = 0.0
    tier: str = ""                     # optional tier label for reporting


@dataclass
class FleetTrace:
    """One sampled fleet workload: per-request upload time, global
    regime id (device-prefixed names), and device index."""

    t_input: np.ndarray                # (N,) ms
    regime: np.ndarray                 # (N,) int64, global regime ids
    device_index: np.ndarray           # (N,) int64, index into the fleet
    regime_names: List[str]
    # Per-device id strings, or None when devices are identified by
    # their integer index alone (ArrayFleet populations — materializing
    # a million id strings would dwarf the trace itself).
    device_ids: Optional[List[str]] = None

    def device_keys(self) -> np.ndarray:
        """(N,) estimator-bank keys: device_id strings when the fleet
        names its devices, the integer device indices otherwise."""
        if self.device_ids is None:
            return self.device_index
        return np.asarray(self.device_ids, object)[self.device_index]


class FleetMixture:
    """Weighted mixture of devices, each with its own network process.

    `sample_trace` first draws one child seed per device (plus one for
    the assignment stream) from the caller's generator, then assigns
    each request a device i.i.d. by weight and fills that device's
    positions from its own process under its own child generator.
    Consequence: with a fixed seed, changing device B's *process* never
    changes device A's draw sequence (only the weights shift the
    request assignment) — pinned by tests/test_fleet.py.
    """

    def __init__(self, devices: Sequence[DeviceProfile], *,
                 name: str = "fleet"):
        devices = list(devices)
        if not devices:
            raise ValueError("fleet needs at least one device")
        ids = [d.device_id for d in devices]
        if len(set(ids)) != len(ids):
            raise ValueError(f"duplicate device ids in fleet: {ids}")
        if any(d.weight <= 0 for d in devices):
            raise ValueError("device weights must be positive")
        self.name = name
        self.devices = devices
        self.device_ids = ids
        self.processes = [make_network(d.network) for d in devices]
        w = np.array([d.weight for d in devices], np.float64)
        self.weights = w / w.sum()
        # Global regime ids: each device's local regimes occupy a
        # contiguous block, names prefixed with the device id.
        self._regime_offsets = np.cumsum(
            [0] + [len(p.regime_names()) for p in self.processes[:-1]])

    @property
    def mean(self) -> float:
        """Fleet-wide long-run mean T_input (weight-averaged)."""
        return float(sum(w * p.mean
                         for w, p in zip(self.weights, self.processes)))

    def priors(self) -> Dict[str, float]:
        """Per-device long-run mean T_input — the estimator-bank
        cold-start priors (what offline measurement would give)."""
        return {d.device_id: p.mean
                for d, p in zip(self.devices, self.processes)}

    def prior_array(self) -> np.ndarray:
        """`priors()` in device-index order — the (D,) array form the
        scan engine (and the simulator's per-request gather) consume."""
        return np.array([p.mean for p in self.processes], np.float64)

    def on_device_arrays(self):
        """``(od_ms, od_sigma, od_accuracy)`` each (D,) in device-index
        order — the fallback profiles as arrays."""
        return (np.array([d.on_device_ms for d in self.devices],
                         np.float64),
                np.array([d.on_device_sigma for d in self.devices],
                         np.float64),
                np.array([d.on_device_accuracy for d in self.devices],
                         np.float64))

    def regime_names(self) -> List[str]:
        return [f"{d.device_id}:{rn}"
                for d, p in zip(self.devices, self.processes)
                for rn in p.regime_names()]

    @classmethod
    def from_capture(cls, trace, *, mode: str = "loop",
                     name: Optional[str] = None,
                     profiles: Optional[Dict[str, DeviceProfile]] = None
                     ) -> "FleetMixture":
        """Reconstruct a fleet from a multi-device capture
        (`serving.trace.Trace`): each recorded device becomes a
        `DeviceProfile` whose radio replays that device's own captured
        T_input subsequence (a `CapturedTraceProcess`, regime ids
        preserved) and whose weight is its empirical request share — so
        recorded fleets replay through the device-keyed `EstimatorBank`
        path. Non-radio fields come from `profiles[device_id]` when
        given, else from `DEVICE_TIERS` when the device id names a
        tier (the `FLEET_SCENARIOS` default), else radio-only."""
        from repro_torch.serving.trace import CapturedTraceProcess
        profiles = dict(profiles or {})
        devices = []
        for dev, idx in trace.per_device().items():
            sub_reg = trace.regime_id[idx]
            # Compact this device's regimes to a local numbering; the
            # mixture re-prefixes names, so strip an existing "dev:"
            # prefix (fleet-sourced captures) to avoid "mid:mid:lte".
            gids, local = np.unique(sub_reg, return_inverse=True)
            lnames = [trace.regime_names[g].removeprefix(f"{dev}:")
                      for g in gids]
            dev_id = dev or "<untagged>"
            proc = CapturedTraceProcess(
                trace.t_input_ms[idx], mode=mode, regimes=local,
                regime_names=lnames, name=f"capture:{dev_id}")
            weight = len(idx) / len(trace)
            # Overrides may be keyed by the raw captured id or the
            # visible one ("" is exposed as "<untagged>").
            base = profiles.get(dev) or profiles.get(dev_id)
            if base is not None:
                devices.append(dataclasses.replace(
                    base, device_id=dev_id, network=proc, weight=weight))
            elif dev in DEVICE_TIERS:
                devices.append(device_tier_profile(
                    dev, network=proc, weight=weight))
            else:
                devices.append(DeviceProfile(dev_id, proc, weight=weight))
        return cls(devices, name=name or f"capture:{trace.name}")

    def sample_trace(self, rng: np.random.Generator,
                     n: int = 1) -> FleetTrace:
        n = int(n)
        # Child seeds first: device d's stream is fixed by (caller rng
        # state, d) alone, independent of the other devices' processes.
        seeds = rng.integers(0, 2 ** 63 - 1, size=len(self.devices) + 1)
        assign = np.random.default_rng(seeds[-1]).choice(
            len(self.devices), size=n, p=self.weights)
        t = np.empty(n, np.float64)
        reg = np.empty(n, np.int64)
        for d, proc in enumerate(self.processes):
            mask = assign == d
            m = int(mask.sum())
            if m == 0:
                continue
            td, rd = proc.sample_trace(np.random.default_rng(seeds[d]), m)
            t[mask] = td
            reg[mask] = rd + self._regime_offsets[d]
        return FleetTrace(t, reg, assign.astype(np.int64),
                          self.regime_names(), list(self.device_ids))


class ArrayFleet:
    """Vectorized fleet for million-device populations (DESIGN.md §13).

    `FleetMixture` models a handful of *tiers* faithfully (independent
    child RNG streams, regime-switching radios) but draws each device's
    subsequence in a python loop — O(D) overhead that dominates at
    10^5+ devices. `ArrayFleet` trades radio fidelity for scale: every
    device sits on a *stationary* lognormal radio whose mean is its
    tier's long-run mean perturbed by a per-device lognormal jitter
    (devices within a tier are heterogeneous, so per-device estimation
    stays meaningful), and a whole trace is one vectorized lognormal
    draw. Devices are identified by their integer index; the fleet
    protocol (`prior_array` / `on_device_arrays` / `sample_trace` /
    `priors` / `mean`) matches `FleetMixture`, so both engines accept
    either class. Tier membership is deterministic (contiguous blocks
    proportional to `tier_weights`); the per-device jitter is fixed by
    `seed` at construction, so two fleets built with the same arguments
    are identical."""

    def __init__(self, n_devices: int, *,
                 tiers: Sequence[str] = ("flagship", "midrange",
                                         "budget"),
                 tier_weights: Optional[Sequence[float]] = None,
                 cv: float = 0.4, mean_jitter: float = 0.15,
                 seed: int = 0, name: str = "array_fleet"):
        if n_devices < 1:
            raise ValueError(f"n_devices must be >= 1, got {n_devices}")
        if cv <= 0 or mean_jitter < 0:
            raise ValueError("cv must be > 0 and mean_jitter >= 0")
        self.name = name
        self.n_devices = D = int(n_devices)
        self.tier_names = [str(t) for t in tiers]
        profs = [device_tier_profile(t) for t in self.tier_names]
        tier_mean = np.array([make_network(p.network).mean for p in profs])
        w = np.ones(len(profs)) if tier_weights is None else np.asarray(
            tier_weights, np.float64)
        if len(w) != len(profs) or (w <= 0).any():
            raise ValueError("tier_weights must be positive, one per tier")
        # Deterministic contiguous tier blocks, sized proportionally
        # (every tier gets at least one device when D allows).
        bounds = np.round(np.cumsum(w) / w.sum() * D).astype(np.int64)
        counts = np.diff(np.concatenate([[0], bounds]))
        self.tier_of = np.repeat(np.arange(len(profs)), counts)
        # Per-device radio: the tier mean times a unit-median lognormal
        # jitter, with the tier-level coefficient of variation.
        jit = np.random.default_rng(seed).lognormal(
            0.0, mean_jitter, D) if mean_jitter > 0 else np.ones(D)
        self.device_mean = tier_mean[self.tier_of] * jit
        self._mu, self._sigma = lognormal_params(
            self.device_mean, cv * self.device_mean)
        self._od = (
            np.array([p.on_device_ms for p in profs])[self.tier_of],
            np.array([p.on_device_sigma for p in profs])[self.tier_of],
            np.array([p.on_device_accuracy for p in profs])[self.tier_of])

    @property
    def mean(self) -> float:
        """Fleet-wide long-run mean T_input (devices equally likely)."""
        return float(self.device_mean.mean())

    def prior_array(self) -> np.ndarray:
        return self.device_mean.copy()

    def on_device_arrays(self):
        return self._od

    def priors(self) -> Dict[int, float]:
        """Dict form of `prior_array` (python-engine bank priors).
        O(D) — the scan engine uses `prior_array` directly."""
        return dict(enumerate(self.device_mean))

    def regime_names(self) -> List[str]:
        return list(self.tier_names)

    def sample_trace(self, rng: np.random.Generator,
                     n: int = 1) -> FleetTrace:
        n = int(n)
        dev = rng.integers(0, self.n_devices, size=n)
        t = np.maximum(rng.lognormal(self._mu[dev], self._sigma[dev]),
                       MIN_T_INPUT_MS)
        return FleetTrace(t, self.tier_of[dev], dev.astype(np.int64),
                          self.regime_names(), device_ids=None)


# --------------------------------------------------------------------------
# Per-device keyed estimation (the TInputEstimator bank)
# --------------------------------------------------------------------------

class EstimatorBank:
    """A keyed bank of `TInputEstimator`s: one independent estimator
    per device, created on first use from a shared spec (string spec or
    a prototype instance that is deep-copied per device).

    `lag` delays observation delivery: each device's estimator sees its
    own upload measurements only `lag` requests late. ``lag=0`` is the
    server-side view (the previous upload has been measured by the time
    the next request is admitted); ``lag=1`` is ModiPick's client-side
    (pre-upload) view — the device estimated its budget before
    uploading, so the freshest measurement is one RTT stale.

    The streaming protocol mirrors `TInputEstimator`:
    ``estimate(key, observed=...)`` then ``observe(key, t)`` per
    request, or the vectorized ``estimate_series(t_input, keys)`` over
    a whole trace — the two are agreement-tested. Under ``lag > 0`` the
    current observation is never consulted (it has not arrived), so
    cold estimators answer their prior; a prior is therefore required
    when ``lag > 0``.
    """

    def __init__(self, spec: Union[str, TInputEstimator] = "ewma:0.2", *,
                 priors: Optional[Dict] = None,
                 default_prior: Optional[float] = None, lag: int = 0):
        if isinstance(spec, EstimatorBank):
            raise ValueError("cannot nest EstimatorBanks")
        if isinstance(spec, str):
            # Parse ONCE: the bank instantiates estimators lazily (one
            # per device, on first use), and routing each cold start
            # back through the spec-string parser costs real time at
            # fleet scale. The factory closes over the parsed spec and
            # also front-loads the registry-style ValueError a bad spec
            # would otherwise raise mid-run.
            self._factory = estimator_factory(spec)
        elif not isinstance(spec, TInputEstimator):
            raise ValueError(f"EstimatorBank spec must be a "
                             f"TInputEstimator or a str, got "
                             f"{type(spec).__name__}")
        else:
            self._factory = None
        if lag < 0:
            raise ValueError(f"lag must be >= 0, got {lag}")
        if lag > 0 and (spec == "observed"
                        or getattr(spec, "name", None) == "observed"):
            # "observed" budgets from the *current* upload, which by
            # definition has not arrived under a stale view. The
            # last-known-observation equivalent is ewma:1.0.
            raise ValueError("'observed' estimator is undefined under "
                             "lag > 0; use 'ewma:1.0' (last known "
                             "observation) instead")
        self.spec = spec
        self.priors = dict(priors or {})
        self.default_prior = default_prior
        self.lag = int(lag)
        self._estimators: Dict[object, TInputEstimator] = {}
        self._pending: Dict[object, deque] = {}

    def keys(self):
        return list(self._estimators)

    def prior_for(self, key) -> Optional[float]:
        """The cold-start prior `key`'s estimator is (or would be)
        primed with — the device's long-run mean, the control plane's
        degradation reference."""
        return self.priors.get(key, self.default_prior)

    def estimator_for(self, key) -> TInputEstimator:
        est = self._estimators.get(key)
        if est is None:
            prior = self.priors.get(key, self.default_prior)
            if self._factory is not None:
                est = self._factory(prior=prior)
            else:
                est = copy.deepcopy(self.spec)
                if est.prior is None:
                    est.prior = prior
            if self.lag > 0 and est.prior is None:
                raise ValueError(
                    f"EstimatorBank(lag={self.lag}) needs a prior for "
                    f"device {key!r}: under a stale view a cold "
                    f"estimator has nothing else to answer")
            self._estimators[key] = est
            self._pending[key] = deque()
        return est

    def estimate(self, key, observed: Optional[float] = None) -> float:
        """Budget-side T_input for `key`'s current request. Under
        ``lag > 0`` the current observation is not consulted."""
        est = self.estimator_for(key)
        if self.lag > 0:
            return est.estimate()
        return est.estimate(observed=observed)

    def observe(self, key, t_input: float) -> None:
        """Record `key`'s measured upload; it reaches the estimator
        after `lag` further observations."""
        est = self.estimator_for(key)
        pend = self._pending[key]
        pend.append(float(t_input))
        while len(pend) > self.lag:
            est.observe(pend.popleft())

    def estimate_series(self, t_input, keys=None) -> np.ndarray:
        """Vectorized causal estimation over a whole trace: positions
        are grouped per key (order-preserving) and each device's
        subsequence runs through its own estimator's `estimate_series`,
        shifted by `lag`. Continues any streaming state (pending
        observations carry across calls)."""
        t_input = np.asarray(t_input, np.float64)
        n = len(t_input)
        if keys is None:
            keys = [None] * n
        if len(keys) != n:
            raise ValueError(f"{n} observations but {len(keys)} keys")
        groups: Dict[object, list] = {}
        for i, k in enumerate(keys):
            groups.setdefault(k, []).append(i)
        out = np.empty(n, np.float64)
        for k, pos_list in groups.items():
            pos = np.asarray(pos_list, np.intp)
            out[pos] = self._series_for(k, t_input[pos])
        return out

    def _series_for(self, key, xs: np.ndarray) -> np.ndarray:
        est = self.estimator_for(key)
        if self.lag == 0:
            return est.estimate_series(xs)
        pend = self._pending[key]
        p0, m = len(pend), len(xs)
        combined = np.concatenate([np.asarray(pend, np.float64), xs])
        # At request i the device has pushed p0+i observations, of
        # which max(0, p0+i-lag) have arrived at the estimator.
        feed_n = max(0, p0 + m - self.lag)
        if feed_n == 0:
            out = np.full(m, est.estimate())
        else:
            # vals[k] = estimate from the state after k arrivals within
            # this call (the k=0 cold start answers the required
            # prior); request i has seen max(0, p0+i-lag) of them,
            # which is always < feed_n.
            vals = est.estimate_series(combined[:feed_n])
            out = vals[np.maximum(0, p0 + np.arange(m) - self.lag)]
        self._pending[key] = deque(combined[feed_n:])
        return out


# --------------------------------------------------------------------------
# Named fleets (paper Table 4 tiers; configs/paper_zoo data)
# --------------------------------------------------------------------------

def device_tier_profile(tier: str, *, device_id: Optional[str] = None,
                        weight: float = 1.0,
                        network: Union[str, NetworkProcess, None] = None
                        ) -> DeviceProfile:
    """Build a `DeviceProfile` from a `configs/paper_zoo.DEVICE_TIERS`
    entry: the tier's radio (overridable, e.g. to put the midrange tier
    on the `lte_outages` scenario) and its on-device profile resolved
    from the paper's Table 4 measurements + Table 5 accuracy."""
    if tier not in DEVICE_TIERS:
        raise ValueError(f"unknown device tier {tier!r}; known: "
                         f"{sorted(DEVICE_TIERS)}")
    d = DEVICE_TIERS[tier]
    od_ms = od_sigma = od_acc = 0.0
    if d.get("on_device") is not None:
        dev_name, model = d["on_device"]
        od_ms = float(DEVICES[dev_name][model])
        od_sigma = ON_DEVICE_SIGMA_FRACTION * od_ms
        od_acc = TABLE5[model][0] / 100.0
    return DeviceProfile(
        device_id=device_id or tier,
        network=network if network is not None else d["network"],
        weight=weight, on_device_ms=od_ms, on_device_sigma=od_sigma,
        on_device_accuracy=od_acc, tier=tier)


# `array:<n>[:<seed>]` fleets are cached per spec string: tenant
# helpers (workload gen, priors, on-device tables) each re-resolve the
# spec, and rebuilding a million-device ArrayFleet per call would
# dominate. Safe to share — ArrayFleet is immutable after construction
# (sampling uses the caller's generator).
_ARRAY_FLEET_CACHE: Dict[str, "ArrayFleet"] = {}


def make_fleet(spec: Union[str, FleetMixture, "ArrayFleet", None]
               ) -> Union[FleetMixture, "ArrayFleet", None]:
    """Resolve a fleet spec: a `FleetMixture` or `ArrayFleet` passes
    through, ``"array:<n>[:<seed>]"`` builds (and caches) an
    `ArrayFleet` of n devices, any other string names a
    `configs/paper_zoo.FLEET_SCENARIOS` entry, None -> None (single
    shared process — the pre-fleet default path)."""
    if spec is None or isinstance(spec, (FleetMixture, ArrayFleet)):
        return spec
    if not isinstance(spec, str):
        raise ValueError(f"fleet spec must be a FleetMixture or a str, "
                         f"got {type(spec).__name__}")
    if spec.startswith("array:"):
        fleet = _ARRAY_FLEET_CACHE.get(spec)
        if fleet is None:
            parts = spec.split(":")
            if len(parts) not in (2, 3):
                raise ValueError(f"bad array fleet spec {spec!r}; "
                                 f"expected 'array:<n>[:<seed>]'")
            seed = int(parts[2]) if len(parts) == 3 else 0
            fleet = ArrayFleet(int(parts[1]), seed=seed, name=spec)
            _ARRAY_FLEET_CACHE[spec] = fleet
        return fleet
    if spec not in FLEET_SCENARIOS:
        raise ValueError(f"unknown fleet {spec!r}; known: "
                         f"{sorted(FLEET_SCENARIOS)}")
    devices = [device_tier_profile(e["tier"],
                                   device_id=e.get("device_id"),
                                   weight=e.get("weight", 1.0),
                                   network=e.get("network"))
               for e in FLEET_SCENARIOS[spec]]
    return FleetMixture(devices, name=spec)
