"""Online control plane: the per-request serving step, shared by all
three stacks, plus live regime-shift adaptation (DESIGN.md §12).

The per-request control step — estimate the budget-side T_input, select
a model, decide hedging/fallback, observe the outcome — was previously
re-implemented three times: inline in `simulate()`'s event loop, in
`ServingLoop.run`, and in `CNNSelectServer.handle`. `ControlPlane`
extracts it once:

- **scalar** — `step()` answers one request (`ControlDecision`), and
  `observe_outcome()` feeds the measured latency back; the prototype
  server and the continuous-batching loop drive this path.
- **vectorized** — `plan_batch()` answers a whole trace (`BatchPlan`)
  for the simulator; with no controller attached it performs *exactly*
  the pre-refactor estimate→route_batch→outage-mask sequence (same
  operations, same RNG consumption order), so the PR 2/PR 3 golden
  regression pins stay bit-for-bit.

On top of the shared step sits *online adaptation* — the regime
MDInference (arXiv:2002.06603) and ModiPick (arXiv:1909.02053) argue
for: the server must react to shifting network conditions per request,
not be configured once offline.

- **Change-point detectors** (`CusumDetector`, `PageHinkleyDetector`)
  watch the per-device residual stream of a *monitor* estimator
  (observed upload − causal estimate, the `EstimatorBank` residuals):
  pure numpy, causal, self-normalizing (EWMA of |residual|) unless a
  fixed scale is given. A positive-side alarm signals degradation, a
  negative-side alarm signals recovery.
- **`AdaptiveController`** maps alarms to an *ordered mode table*
  (`core.selection.ControlMode`, least → most conservative): an
  up-alarm escalates the device one mode, a down-alarm de-escalates;
  each mode fixes the budgeting estimator, the hedge behaviour,
  on-device fallback, and optionally the selection policy. Every
  switch is recorded as an event `{request, device, from, to, alarm}`
  — `simulate()` stores them on `SimResult.switch_events` and
  `Trace.from_sim` persists them as ``meta["control_events"]``, so
  adaptations replay with the capture.

Named controller presets live in
`configs/paper_zoo.CONTROLLER_SCENARIOS` and resolve through
`make_controller`; `benchmarks/adaptive_control.py` scores the
adaptive controller against every static (policy, hedge, estimator)
configuration.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

from repro_torch.core.registry import parse_spec
from repro_torch.core.selection import (ControlMode, Policy, make_mode,
                                  make_policy, on_device_fallback_decision)
from repro_torch.serving.fleet import EstimatorBank
from repro_torch.serving.network import validate_estimator_spec

HEDGE_MODES = ("none", "p95", "outage")


# --------------------------------------------------------------------------
# Change-point detection (per-device, over estimator residuals)
# --------------------------------------------------------------------------

class ChangePointDetector:
    """Causal online detector over a residual stream.

    `update(residual)` consumes one residual (observed − predicted
    upload time) and returns ``+1`` (upward mean shift — degradation),
    ``-1`` (downward shift — recovery), or ``0``. The statistic resets
    itself after an alarm. With ``scale=None`` residuals are
    self-normalized by an EWMA of |residual| (primed on the first
    residual); a fixed ``scale`` makes the statistic exactly the
    textbook form — the calibration property tests pin false-positive
    rate and detection delay through that path.
    """

    name = "detector"

    def __init__(self, *, scale: Optional[float] = None,
                 scale_beta: float = 0.05, min_scale: float = 1e-3):
        if scale is not None and scale <= 0:
            raise ValueError(f"scale must be positive, got {scale}")
        if not 0.0 < scale_beta <= 1.0:
            raise ValueError(f"scale_beta must be in (0, 1], "
                             f"got {scale_beta}")
        self.fixed_scale = scale
        self.scale_beta = float(scale_beta)
        self.min_scale = float(min_scale)
        self._scale: Optional[float] = scale

    def prime_scale(self, scale: float) -> None:
        """Seed the self-normalizing scale (e.g. from the device's
        prior dispersion) so early residuals are not standardized by
        one arbitrary first draw. No-op with a fixed scale."""
        if self.fixed_scale is None and scale > 0:
            self._scale = max(float(scale), self.min_scale)

    def _standardize(self, residual: float,
                     scale_sample: Optional[float] = None) -> float:
        """z-score the residual against the current scale, then let the
        scale track the noise (slowly; after standardization, so a
        shift burst is measured against the pre-shift scale).
        `scale_sample` is the magnitude the scale should learn from —
        the controller passes the *tracker* residual |obs − tracker|,
        which measures process noise; the detection residual
        (obs − reference) would inflate the scale with the very offset
        being detected and bury the recovery signal. Defaults to
        |residual| for standalone use."""
        r = float(residual)
        if self.fixed_scale is not None:
            return r / self.fixed_scale
        s_obs = abs(r) if scale_sample is None else abs(
            float(scale_sample))
        if self._scale is None:
            self._scale = max(s_obs, self.min_scale)
        z = r / self._scale
        self._scale = max((1.0 - self.scale_beta) * self._scale
                          + self.scale_beta * s_obs, self.min_scale)
        return z

    def update(self, residual: float,
               scale_sample: Optional[float] = None) -> int:
        raise NotImplementedError

    def reset(self) -> None:
        """Clear the decision statistic (the scale survives)."""
        raise NotImplementedError


class CusumDetector(ChangePointDetector):
    """Two-sided CUSUM (Page's test): ``S+ = max(0, S+ + z - k)``,
    ``S- = max(0, S- - z - k)``; alarm when either exceeds the
    threshold ``h``. With standardized residuals, `drift` ``k`` is in
    sigma units (detects shifts larger than ~2k) and `threshold` ``h``
    trades detection delay against false-positive rate (for N(0,1)
    residuals with k=0.5, h=8 the in-control ARL is astronomically
    large; out of control, delay ≈ h / (shift/sigma - k))."""

    name = "cusum"

    def __init__(self, threshold: float = 8.0, drift: float = 0.5, **kw):
        super().__init__(**kw)
        if threshold <= 0:
            raise ValueError(f"threshold must be positive, "
                             f"got {threshold}")
        if drift < 0:
            raise ValueError(f"drift must be >= 0, got {drift}")
        self.threshold = float(threshold)
        self.drift = float(drift)
        self._pos = 0.0
        self._neg = 0.0

    @property
    def statistic(self) -> float:
        return max(self._pos, self._neg)

    def update(self, residual: float,
               scale_sample: Optional[float] = None) -> int:
        z = self._standardize(residual, scale_sample)
        self._pos = max(0.0, self._pos + z - self.drift)
        self._neg = max(0.0, self._neg - z - self.drift)
        if self._pos > self.threshold:
            self.reset()
            return 1
        if self._neg > self.threshold:
            self.reset()
            return -1
        return 0

    def reset(self) -> None:
        self._pos = self._neg = 0.0


class PageHinkleyDetector(ChangePointDetector):
    """Two-sided Page–Hinkley test, one drift-corrected cumulative sum
    per side (a single shared sum would false-alarm on zero-mean
    streams — its own drift term walks it away from the extremum):
    upward, ``mU = sum(z - delta)`` alarms when it rises `threshold`
    above its running minimum; downward, ``mD = sum(z + delta)`` alarms
    when it falls `threshold` below its running maximum."""

    name = "ph"

    def __init__(self, threshold: float = 8.0, delta: float = 0.25, **kw):
        super().__init__(**kw)
        if threshold <= 0:
            raise ValueError(f"threshold must be positive, "
                             f"got {threshold}")
        if delta < 0:
            raise ValueError(f"delta must be >= 0, got {delta}")
        self.threshold = float(threshold)
        self.delta = float(delta)
        self._up = 0.0
        self._up_min = 0.0
        self._dn = 0.0
        self._dn_max = 0.0

    @property
    def statistic(self) -> float:
        return max(self._up - self._up_min, self._dn_max - self._dn)

    def update(self, residual: float,
               scale_sample: Optional[float] = None) -> int:
        z = self._standardize(residual, scale_sample)
        self._up += z - self.delta
        self._up_min = min(self._up_min, self._up)
        self._dn += z + self.delta
        self._dn_max = max(self._dn_max, self._dn)
        if self._up - self._up_min > self.threshold:
            self.reset()
            return 1
        if self._dn_max - self._dn > self.threshold:
            self.reset()
            return -1
        return 0

    def reset(self) -> None:
        self._up = self._up_min = 0.0
        self._dn = self._dn_max = 0.0


DETECTOR_REGISTRY = {
    "cusum": lambda arg: CusumDetector(
        threshold=float(arg) if arg else 8.0),
    "ph": lambda arg: PageHinkleyDetector(
        threshold=float(arg) if arg else 8.0),
}


def detector_names() -> List[str]:
    return ["cusum[:threshold]", "ph[:threshold]"]


def make_detector(spec: Union[str, ChangePointDetector]
                  ) -> ChangePointDetector:
    """Resolve a detector spec ("cusum[:threshold]", "ph[:threshold]",
    or a prebuilt instance — used as a per-device template)."""
    if isinstance(spec, ChangePointDetector):
        return spec
    if not isinstance(spec, str):
        raise ValueError(f"detector spec must be a ChangePointDetector "
                         f"or a str, got {type(spec).__name__}")
    head, arg = parse_spec(spec, kind="change-point detector",
                           heads=DETECTOR_REGISTRY,
                           known=detector_names(),
                           arg_heads=tuple(DETECTOR_REGISTRY),
                           numeric_arg_heads=tuple(DETECTOR_REGISTRY))
    return DETECTOR_REGISTRY[head](arg)


# --------------------------------------------------------------------------
# Adaptive controller: detector alarms -> mode-table walks
# --------------------------------------------------------------------------

class AdaptiveController:
    """Per-device regime-shift detection driving live mode switches.

    `modes` is an *ordered* table (least → most conservative) of
    `core.selection.ControlMode`s / registry names; every device starts
    at position `start`. Each device carries a **reference level** (its
    long-run prior mean initially) and a *tracker* estimator (spec
    `monitor`, one per device via an `EstimatorBank`) following the
    current level; every observed upload time feeds the residual
    ``observed − reference`` to the device's own change-point detector.
    An up-alarm escalates the device one mode, a down-alarm
    de-escalates, and on every accepted alarm the reference
    *re-anchors* to the tracker's current level — so a sustained shift
    fires exactly once and the detector is re-armed against the new
    level (the return shift shows up as a sustained residual of the
    opposite sign; a fast-adapting monitor alone would wash it out).
    `cooldown` further observations must pass before the device may
    switch again (anti-thrash). Switches are recorded in `events` with
    the global observation index, so captures can replay the
    adaptation sequence.
    """

    def __init__(self, modes: Sequence[Union[str, ControlMode]] =
                 ("stationary", "degraded"), *,
                 detector: Union[str, ChangePointDetector] = "cusum",
                 monitor: str = "ewma:0.2", cooldown: int = 8,
                 start: int = 0, scale_frac: float = 0.25,
                 name: str = "adaptive"):
        self.modes = [make_mode(m) for m in modes]
        if len(self.modes) < 2:
            raise ValueError("AdaptiveController needs at least two "
                             "modes (nothing to switch between)")
        names = [m.name for m in self.modes]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate mode names in table: {names}")
        for m in self.modes:
            if m.hedge not in HEDGE_MODES:
                raise ValueError(f"mode {m.name!r} has unknown hedge "
                                 f"{m.hedge!r}; known: "
                                 f"{', '.join(HEDGE_MODES)}")
            if m.t_estimator is not None:
                validate_estimator_spec(m.t_estimator)
        if not 0 <= start < len(self.modes):
            raise ValueError(f"start mode {start} out of range")
        if cooldown < 0:
            raise ValueError(f"cooldown must be >= 0, got {cooldown}")
        self._detector_template = make_detector(detector)
        validate_estimator_spec(monitor)
        self.monitor = monitor
        self.cooldown = int(cooldown)
        self.start = int(start)
        if scale_frac <= 0:
            raise ValueError(f"scale_frac must be positive, "
                             f"got {scale_frac}")
        self.scale_frac = float(scale_frac)
        self.name = name
        self._priors: Optional[Dict] = None
        self._default_prior: Optional[float] = None
        self._bank: Optional[EstimatorBank] = None
        self._state: Dict[object, dict] = {}
        self._events: List[dict] = []
        self._n_seen = 0

    # -- lifecycle ---------------------------------------------------------

    def prime(self, priors: Optional[Dict] = None,
              default_prior: Optional[float] = None) -> None:
        """Install cold-start priors (device long-run means) for the
        monitor estimator and reset all per-device state — the start of
        a fresh run."""
        self._priors = dict(priors or {})
        self._default_prior = default_prior
        self.reset()

    def reset(self) -> None:
        self._bank = EstimatorBank(self.monitor, priors=self._priors,
                                   default_prior=self._default_prior)
        self._state.clear()
        self._events = []
        self._n_seen = 0

    @property
    def events(self) -> List[dict]:
        """Mode-switch events so far (copies; chronological)."""
        return [dict(e) for e in self._events]

    def mode_names(self) -> List[str]:
        return [m.name for m in self.modes]

    def mode_of(self, key) -> ControlMode:
        """The mode currently governing `key` (no state advance)."""
        st = self._state.get(key)
        return self.modes[self.start if st is None else st["mode"]]

    # -- the control step --------------------------------------------------

    def observe(self, key, t_input: float) -> ControlMode:
        """One scalar control step: residual against the device's
        reference level, detector update, possible switch (with
        re-anchoring), tracker update. Returns the mode governing the
        request that carried this observation (the measured upload time
        of the arriving request is available at admission, exactly like
        the 'observed' estimator's input)."""
        if self._bank is None:
            self.reset()
        x = float(t_input)
        pred = self._bank.estimate(key, observed=x)
        self._bank.observe(key, x)
        post = self._bank.estimate(key, observed=x)  # post-obs level
        return self._step(key, x, pred, post)

    def run_series(self, t_inputs, keys=None) -> np.ndarray:
        """Vectorized control steps over a whole trace: tracker
        estimates per device via the bank's `estimate_series`
        (identical to the interleaved scalar protocol — each device's
        estimator sees only its own stream), then the detectors walked
        causally in arrival order. Returns the (N,) per-request mode
        indices."""
        if self._bank is None:
            self.reset()
        t_inputs = np.asarray(t_inputs, np.float64)
        n = len(t_inputs)
        key_list = [None] * n if keys is None else list(keys)
        preds = self._bank.estimate_series(t_inputs, keys)
        # Post-observation tracker levels (the re-anchor targets):
        # within a device's positions the post-level after observation
        # j is the pre-estimate at its next position; the final
        # position reads the bank's current state.
        post = np.empty(n, np.float64)
        groups: Dict[object, list] = {}
        for i, k in enumerate(key_list):
            groups.setdefault(k, []).append(i)
        for k, pos_list in groups.items():
            pos = np.asarray(pos_list, np.intp)
            if len(pos) > 1:
                post[pos[:-1]] = preds[pos[1:]]
            post[pos[-1]] = self._bank.estimate(
                k, observed=float(t_inputs[pos[-1]]))
        out = np.empty(n, np.int64)
        for i in range(n):
            mode = self._step(key_list[i], float(t_inputs[i]),
                              float(preds[i]), float(post[i]))
            out[i] = self.modes.index(mode)
        return out

    def _init_state(self, key, pred: float) -> dict:
        det = copy.deepcopy(self._detector_template)
        prior = (self._priors or {}).get(key, self._default_prior)
        ref = float(prior) if prior is not None else float(pred)
        # Seed the detector's self-normalizing scale from the
        # reference level (mobile T_input dispersion is roughly
        # proportional to the mean) so one arbitrary first residual
        # does not define the unit.
        det.prime_scale(self.scale_frac * abs(ref))
        st = {"mode": self.start, "det": det, "cool": 0, "ref": ref}
        self._state[key] = st
        return st

    def _step(self, key, x: float, pred: float,
              post: float) -> ControlMode:
        st = self._state.get(key)
        if st is None:
            st = self._init_state(key, pred)
        i = self._n_seen
        self._n_seen += 1
        # Detect on the residual against the reference level; learn the
        # noise scale from the residual against the *tracker* (which
        # follows the current level, so its residuals measure process
        # noise even while the reference is offset by a shift).
        alarm = st["det"].update(x - st["ref"],
                                 scale_sample=abs(x - pred))
        if st["cool"] > 0:
            st["cool"] -= 1
        elif alarm:
            new = min(max(st["mode"] + (1 if alarm > 0 else -1), 0),
                      len(self.modes) - 1)
            if new != st["mode"]:
                # Switch: walk the mode table and re-anchor the
                # reference to the tracker's current level, so the
                # detector re-arms against the *new* regime (the return
                # shift is detected from here).
                self._events.append({
                    "request": i, "device": "" if key is None else
                    str(key), "from": self.modes[st["mode"]].name,
                    "to": self.modes[new].name, "alarm": int(alarm),
                    "ref": float(st["ref"]), "level": float(post)})
                st["mode"] = new
                st["cool"] = self.cooldown
                st["ref"] = float(post)
            elif alarm < 0:
                # Down-alarm at the bottom mode: conditions improved
                # below the reference (e.g. a prior that overstated the
                # radio) — track the better level. The symmetric case
                # (up-alarm at the top mode) deliberately does NOT
                # re-anchor: the alarm-conditioned tracker level is
                # spike-biased upward under heavy-tailed traffic, and
                # anchoring to it makes normal traffic look like a
                # recovery — the de-escalation thrash the cooldown
                # alone cannot prevent.
                st["ref"] = float(post)
        return self.modes[st["mode"]]


def controller_names() -> List[str]:
    from repro_torch.configs.paper_zoo import CONTROLLER_SCENARIOS
    return sorted(CONTROLLER_SCENARIOS)


def make_controller(spec: Union[str, AdaptiveController, None]
                    ) -> Optional[AdaptiveController]:
    """Resolve a controller spec: None -> None, an instance passes
    through, a string names a `configs/paper_zoo.CONTROLLER_SCENARIOS`
    preset."""
    if spec is None or isinstance(spec, AdaptiveController):
        return spec
    if not isinstance(spec, str):
        raise ValueError(f"controller spec must be an "
                         f"AdaptiveController, a str, or None, got "
                         f"{type(spec).__name__}")
    from repro_torch.configs.paper_zoo import CONTROLLER_SCENARIOS
    if spec not in CONTROLLER_SCENARIOS:
        raise ValueError(f"unknown controller {spec!r}; known: "
                         f"{', '.join(controller_names())}")
    d = CONTROLLER_SCENARIOS[spec]
    return AdaptiveController(
        modes=d.get("modes", ("stationary", "degraded")),
        detector=d.get("detector", "cusum"),
        monitor=d.get("monitor", "ewma:0.2"),
        cooldown=d.get("cooldown", 8), start=d.get("start", 0),
        name=spec)


# --------------------------------------------------------------------------
# The control plane (the shared per-request serving step)
# --------------------------------------------------------------------------

@dataclass
class ControlDecision:
    """One request's control-step outcome (scalar path)."""

    index: int                 # model index; meaningless when fallback
    name: str                  # model name ("<on-device>" on fallback)
    t_est: float               # budget-side T_input used for selection
    mode: str = "static"       # governing mode name
    degraded: bool = False     # degraded-regime flag
    hedge: bool = False        # replica hedge recommended (outage mode)
    fallback: bool = False     # serve on-device, do not upload


@dataclass
class BatchPlan:
    """A whole trace's control plan (the simulator path): budget
    estimates, selections, hedging gates, fallback masks, and — with a
    controller — per-request modes plus the switch events."""

    t_est: np.ndarray                       # (N,) budget-side estimates
    sel: np.ndarray                         # (N,) int64 model indices
    p95_gate: np.ndarray                    # (N,) bool: p95 hedging armed
    outage_gate: np.ndarray                 # (N,) bool: hedge this request
    degraded: Optional[np.ndarray] = None   # (N,) bool
    fb_mask: Optional[np.ndarray] = None    # (N,) bool: serve on-device
    od_latency: Optional[np.ndarray] = None
    od_accuracy: Optional[np.ndarray] = None
    modes: Optional[np.ndarray] = None      # (N,) int64 mode indices
    mode_names: Optional[List[str]] = None
    events: List[dict] = field(default_factory=list)


class ControlPlane:
    """The per-request serving step, extracted once for all stacks.

    Wraps a `Router` (which owns profiles, policy, zoo, queues, and the
    base estimator) with the hedging/fallback decision logic and an
    optional `AdaptiveController`. Scalar drivers (`CNNSelectServer`,
    `ServingLoop`) call `step` / `observe_outcome` per request; the
    simulator calls `plan_batch` over the whole trace. With
    ``controller=None`` both paths reproduce the pre-refactor behaviour
    exactly (the static `plan_batch` is RNG-flow-identical to the old
    inline simulator sequence — the golden pins depend on it).
    """

    def __init__(self, router, *, hedge: str = "none",
                 outage_factor: float = 2.0,
                 on_device_fallback: bool = True,
                 controller: Union[str, AdaptiveController, None] = None,
                 priors: Optional[Dict] = None,
                 default_prior: Optional[float] = None,
                 lag: int = 0, seed: int = 0,
                 t_threshold: float = 50.0,
                 stage2_variant: str = "figure", chunk: int = 2048):
        if hedge not in HEDGE_MODES:
            raise ValueError(f"unknown hedge mode {hedge!r}; known: "
                             f"{', '.join(HEDGE_MODES)}")
        self.router = router
        self.hedge = hedge
        self.outage_factor = float(outage_factor)
        self.on_device_fallback = bool(on_device_fallback)
        self.controller = make_controller(controller)
        self.priors = dict(priors or {})
        self.default_prior = default_prior
        self.lag = int(lag)
        self._policy_kw = dict(t_threshold=t_threshold,
                               stage2_variant=stage2_variant, chunk=chunk)
        self._seed = int(seed)
        self._banks: Dict[Optional[str], Optional[EstimatorBank]] = {}
        self._mode_policies: Dict[str, Policy] = {}
        if self.controller is not None:
            # Prime (reset) the controller with this run's priors —
            # unless the plane has none to give and the caller already
            # primed it (e.g. AdaptiveController.prime({...}) passed to
            # a CNNSelectServer/ServingLoop, which carry no fleet
            # priors themselves): re-priming would wipe those.
            if (self.priors or self.default_prior is not None
                    or self.controller._priors is None):
                self.controller.prime(self.priors, self.default_prior)
            # One bank per estimator spec in the mode table, all fed
            # every observation, so a switch lands on a warm estimator.
            for m in self.controller.modes:
                self._bank_for(m.t_estimator)

    # -- shared helpers ----------------------------------------------------

    def _bank_for(self, spec: Optional[str]) -> Optional[EstimatorBank]:
        if spec not in self._banks:
            self._banks[spec] = None if spec is None else EstimatorBank(
                spec, priors=self.priors,
                default_prior=self.default_prior, lag=self.lag)
        return self._banks[spec]

    def _policy_for(self, mode: ControlMode) -> Policy:
        """The mode's policy override instance (base policy when the
        mode does not override), seeded per mode so runs are
        deterministic."""
        if mode.policy is None:
            return self.router.policy
        pol = self._mode_policies.get(mode.name)
        if pol is None:
            idx = self.controller.modes.index(mode)
            seed = int(np.random.SeedSequence(
                [self._seed, 3, idx]).generate_state(1)[0])
            pol = make_policy(mode.policy, seed=seed, **self._policy_kw)
            self._mode_policies[mode.name] = pol
        return pol

    def _static_prior(self, device_id) -> Optional[float]:
        """The degradation reference for the static outage detector:
        the device's estimator prior (its long-run mean)."""
        est = self.router.t_estimator
        if isinstance(est, EstimatorBank):
            return est.prior_for(device_id)
        if est is not None and est.prior is not None:
            return float(est.prior)
        return self.priors.get(device_id, self.default_prior)

    def _spike_prior(self, device_id) -> Optional[float]:
        """The reference for the per-request outage spike rule in
        adaptive modes: the controller's priors, the plane's/router's,
        or — when no offline prior exists at all (server/loop without
        fleet info) — the controller's current per-device reference
        level, which tracks the device's normal operating level."""
        if self.controller is not None:
            prior = (self.controller._priors or {}).get(
                device_id, self.controller._default_prior)
            if prior is not None:
                return float(prior)
        prior = self._static_prior(device_id)
        if prior is not None:
            return prior
        if self.controller is not None:
            st = self.controller._state.get(device_id)
            if st is not None:
                return float(st["ref"])
        return None

    def _fastest_mu(self) -> float:
        return min(p.mu for p in self.router.current_profiles())

    # -- scalar path (server / loop) ---------------------------------------

    def step(self, t_sla: float, t_input: float, *,
             device_id: Optional[str] = None,
             realized: Optional[np.ndarray] = None,
             on_device_ms: float = 0.0) -> ControlDecision:
        """One request's control step: estimate, (maybe) adapt, select,
        gate hedging/fallback. No zoo side effects — scalar drivers pay
        cold starts themselves, exactly as before the extraction."""
        if self.controller is None:
            est = self.router.observe_t_input(t_input, device_id)
            mode_name, degraded, fb_allowed = "static", False, \
                self.on_device_fallback
            hedge_mode = self.hedge
            if hedge_mode == "outage":
                prior = self._static_prior(device_id)
                degraded = (prior is not None
                            and est > self.outage_factor * prior)
            idx = self.router.select(t_sla, est, realized=realized)
        else:
            mode = self.controller.observe(device_id, t_input)
            mode_name = mode.name
            hedge_mode, fb_allowed = mode.hedge, mode.on_device_fallback
            bank = self._bank_for(mode.t_estimator)
            est = (float(t_input) if bank is None
                   else bank.estimate(device_id, observed=t_input))
            for b in self._banks.values():      # keep every bank warm
                if b is not None:
                    b.observe(device_id, float(t_input))
            # A mode with degraded=True treats the whole regime as
            # degraded (detection is the signal); a non-degraded mode
            # with the outage valve armed gates per request on the
            # outage_factor spike rule — exactly the static behaviour.
            degraded = mode.degraded
            if not degraded and hedge_mode == "outage":
                prior = self._spike_prior(device_id)
                degraded = (prior is not None
                            and est > self.outage_factor * prior)
            pol = self._policy_for(mode)
            idx = (self.router.select(t_sla, est, realized=realized)
                   if mode.policy is None else
                   pol.select(self.router.current_profiles(), t_sla,
                              est, realized=realized))
        fallback = bool(
            fb_allowed and degraded and hedge_mode == "outage"
            and on_device_ms > 0.0
            and on_device_fallback_decision(t_sla, est,
                                            self._fastest_mu(),
                                            on_device_ms))
        if fallback:
            return ControlDecision(index=-1, name="<on-device>",
                                   t_est=float(est), mode=mode_name,
                                   degraded=True, fallback=True)
        return ControlDecision(
            index=int(idx), name=self.router.order[int(idx)],
            t_est=float(est), mode=mode_name, degraded=bool(degraded),
            hedge=bool(hedge_mode == "outage" and degraded))

    def observe_outcome(self, name: str, latency_ms: float, *,
                        cold: bool = False, now: float = 0.0) -> None:
        """Feed one measured model latency back into the online
        profiles (the outcome half of the control step)."""
        self.router.record(name, latency_ms, cold=cold, now=now)

    # -- vectorized path (simulator) ---------------------------------------

    def plan_batch(self, rng: np.random.Generator, t_sla: float,
                   t_inputs: np.ndarray, *, device_keys=None,
                   realized: Optional[np.ndarray] = None,
                   prior_mean: Optional[np.ndarray] = None,
                   on_device=None,
                   estimator_scope: str = "device") -> BatchPlan:
        """The whole trace's control plan. `on_device` is the
        per-request ``(od_ms, od_sigma, od_accuracy)`` array triple of
        the issuing devices (None = no on-device capability anywhere);
        `prior_mean` is the per-request device long-run mean (the
        static outage detector's reference). Static path: identical
        operations in identical order to the pre-extraction simulator
        (RNG-flow compatible — golden-pinned)."""
        t_inputs = np.asarray(t_inputs, np.float64)
        n = len(t_inputs)
        est_keys = device_keys if estimator_scope == "device" else None
        if self.controller is None:
            return self._plan_static(rng, t_sla, t_inputs, est_keys,
                                     realized, prior_mean, on_device, n)
        return self._plan_adaptive(rng, t_sla, t_inputs, est_keys,
                                   realized, prior_mean, on_device, n)

    def _plan_static(self, rng, t_sla, t_inputs, est_keys, realized,
                     prior_mean, on_device, n) -> BatchPlan:
        t_est = self.router.estimate_series(t_inputs,
                                            device_ids=est_keys)
        return self.finish_static(rng, t_sla, t_est, realized,
                                  prior_mean, on_device, n)

    def finish_static(self, rng, t_sla, t_est, realized, prior_mean,
                      on_device, n) -> BatchPlan:
        """Phase 2 of the static plan — selection, outage masks, and
        the fallback-latency draws — over already-materialized budget
        estimates. Split from the estimation phase so the scan engine
        (serving/scan_engine.py) can compute `t_est` with its array
        program and then share this exact selection/masking code (and
        its RNG consumption order) with the python path."""
        sel = np.asarray(self.router.route_batch(
            np.full(n, t_sla), t_est, realized=realized,
            estimated=True), np.int64)
        degraded = fb_mask = od_latency = od_accuracy = None
        if self.hedge == "outage":
            degraded = t_est > self.outage_factor * prior_mean
            if on_device is not None and self.on_device_fallback:
                od_ms, od_sg, od_acc = on_device
                fb_mask = degraded & on_device_fallback_decision(
                    t_sla, t_est, self._fastest_mu(), od_ms)
                od_latency = np.maximum(
                    rng.normal(od_ms, od_sg + 1e-9),
                    0.1 * np.maximum(od_ms, 1e-9))
                od_accuracy = od_acc
        return BatchPlan(
            t_est=t_est, sel=sel,
            p95_gate=np.full(n, self.hedge == "p95"),
            outage_gate=(degraded if degraded is not None
                         else np.zeros(n, bool)),
            degraded=degraded, fb_mask=fb_mask, od_latency=od_latency,
            od_accuracy=od_accuracy)

    def _plan_adaptive(self, rng, t_sla, t_inputs, est_keys, realized,
                       prior_mean, on_device, n) -> BatchPlan:
        ctrl = self.controller
        modes_idx = ctrl.run_series(t_inputs, keys=est_keys)
        # Budget estimates: every estimator spec in the table runs over
        # the full trace (causal, per device), so a switched-to
        # estimator is already warm; each request reads the series of
        # its governing mode.
        series: Dict[Optional[str], np.ndarray] = {}
        for spec in {m.t_estimator for m in ctrl.modes}:
            bank = self._bank_for(spec)
            series[spec] = (t_inputs.copy() if bank is None else
                            bank.estimate_series(t_inputs, est_keys))
        t_est = self.compose_adaptive_estimates(series, modes_idx, n)
        return self.finish_adaptive(rng, t_sla, t_est, modes_idx,
                                    ctrl.events, realized, prior_mean,
                                    on_device, n)

    def compose_adaptive_estimates(self, series: Dict, modes_idx,
                                   n: int) -> np.ndarray:
        """Each request's budget estimate read from the series of its
        governing mode's estimator spec (shared by both engines)."""
        t_est = np.empty(n, np.float64)
        for k, m in enumerate(self.controller.modes):
            mask = modes_idx == k
            if mask.any():
                t_est[mask] = series[m.t_estimator][mask]
        return t_est

    def finish_adaptive(self, rng, t_sla, t_est, modes_idx, events,
                        realized, prior_mean, on_device,
                        n) -> BatchPlan:
        """Phase 2 of the adaptive plan — per-mode selection, hedging
        gates, fallback masks/draws — over already-materialized budget
        estimates and per-request mode indices. The scan engine feeds
        this with its array-program outputs; the RNG consumption order
        (the one `rng.normal` fallback-latency draw) is identical to
        the python path's."""
        ctrl = self.controller
        mode_list = ctrl.modes
        # Selection: requests grouped by governing policy (base policy
        # for modes that do not override it).
        sel = np.empty(n, np.int64)
        t_sla_vec = np.full(n, t_sla)
        base_mask = np.zeros(n, bool)
        for k, m in enumerate(mode_list):
            mask = modes_idx == k
            if not mask.any():
                continue
            if m.policy is None:
                base_mask |= mask
                continue
            pol = self._policy_for(m)
            sel[mask] = np.asarray(pol.select_batch(
                self.router.current_profiles(), t_sla_vec[mask],
                t_est[mask],
                realized=None if realized is None else realized[mask]),
                np.int64)
        if base_mask.any():
            sel[base_mask] = np.asarray(self.router.route_batch(
                t_sla_vec[base_mask], t_est[base_mask],
                realized=None if realized is None else
                realized[base_mask], estimated=True), np.int64)
        # Hedging gates / fallback. A degraded=True mode treats its
        # whole regime as degraded (detection is the signal); a
        # non-degraded mode with hedge="outage" keeps the per-request
        # outage_factor spike rule armed — the static safety valve for
        # individual hopeless uploads that are not a regime shift.
        hedge_kind = np.array([HEDGE_MODES.index(m.hedge)
                               for m in mode_list])[modes_idx]
        outage_armed = hedge_kind == HEDGE_MODES.index("outage")
        degraded = np.array([m.degraded for m in mode_list])[modes_idx]
        if prior_mean is not None:
            degraded = degraded | (
                outage_armed
                & (t_est > self.outage_factor * prior_mean))
        p95_gate = hedge_kind == HEDGE_MODES.index("p95")
        outage_gate = outage_armed & degraded
        fb_mask = od_latency = od_accuracy = None
        fb_allowed = np.array([m.on_device_fallback
                               for m in mode_list])[modes_idx]
        if on_device is not None and any(m.on_device_fallback
                                         for m in mode_list):
            od_ms, od_sg, od_acc = on_device
            fb_mask = (fb_allowed & outage_gate
                       & on_device_fallback_decision(
                           t_sla, t_est, self._fastest_mu(), od_ms))
            od_latency = np.maximum(
                rng.normal(od_ms, od_sg + 1e-9),
                0.1 * np.maximum(od_ms, 1e-9))
            od_accuracy = od_acc
        return BatchPlan(
            t_est=t_est, sel=sel, p95_gate=p95_gate,
            outage_gate=outage_gate, degraded=degraded,
            fb_mask=fb_mask, od_latency=od_latency,
            od_accuracy=od_accuracy, modes=np.asarray(modes_idx,
                                                      np.int64),
            mode_names=ctrl.mode_names(), events=list(events))
