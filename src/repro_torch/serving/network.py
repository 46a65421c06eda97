"""Mobile network processes (paper §4.1 "Impact of mobile network
conditions", extended beyond the paper's stationary measurements).

T_input is the request upload time; the paper estimates T_nw
conservatively as 2 * T_input (responses are small text labels). The
paper samples each network i.i.d.; real mobile networks are *time-
varying* (handoffs, congestion bursts, outages — the regime MDInference
arXiv:2002.06603 and ModiPick arXiv:1909.02053 target), so the
simulator draws whole traces from a `NetworkProcess`:

- `StationaryProcess` — i.i.d. draws, backward compatible with the
  named networks of `configs/paper_zoo.NETWORKS`.
- `MarkovProcess` — regime-switching between stationary states under a
  row-stochastic transition matrix (e.g. campus_wifi -> lte handoff,
  congestion bursts, outages).
- `TraceReplayProcess` — replay a recorded/synthetic mean-T_input
  trace cyclically, with optional lognormal jitter around it.

All processes generate whole-trace arrays vectorized (the Markov chain
is sampled per *dwell segment*, not per request), so 10k-request
simulations keep their chunked-admission speed, and every process
clamps at `MIN_T_INPUT_MS` — no process can emit a non-positive upload
time (pre-refactor only the legacy fallback path clamped).

Server-side budgeting under time variation is the `TInputEstimator`
family (ModiPick's online estimation): the admission `Router` consults
an estimator to turn observed upload times into per-request budget
estimates instead of trusting a distribution mean. See DESIGN.md §9.
"""

from __future__ import annotations

from collections import deque
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.configs.paper_zoo import (CAPTURE_SCENARIOS, NETWORK_SCENARIOS,
                                     NETWORK_STATES, NETWORKS,
                                     SYNTHETIC_TRACES, lognormal_params,
                                     synthetic_trace)
from repro_torch.core.registry import parse_spec

# No network can deliver a request in non-positive time; every process
# clamps here (unified — previously only the legacy fallback did).
MIN_T_INPUT_MS = 1.0


def _resolve_state(spec) -> Tuple[str, float, float]:
    """A Markov/trace state: a named network, a named synthetic state
    (NETWORK_STATES), or an explicit (name, mean, std) triple / dict."""
    if isinstance(spec, str):
        d = NETWORKS.get(spec) or NETWORK_STATES.get(spec)
        if d is None:
            raise ValueError(f"unknown network state {spec!r}; known: "
                             f"{sorted(NETWORKS) + sorted(NETWORK_STATES)}")
        return spec, float(d["mean"]), float(d["std"])
    if isinstance(spec, dict):
        name, mean, std = spec["name"], spec["mean"], spec["std"]
    else:
        name, mean, std = spec
    name, mean, std = str(name), float(mean), float(std)
    # Lognormal matching takes log(mean): a non-positive mean would
    # yield NaN draws that sail through the clamp unnoticed.
    if mean <= 0 or std < 0:
        raise ValueError(f"state {name!r} needs mean > 0 and std >= 0, "
                         f"got ({mean}, {std})")
    return name, mean, std


class NetworkProcess:
    """Base of the T_input trace generators.

    Subclasses implement `_raw_trace`; the public `sample_trace` /
    `sample_t_input` apply the unified `MIN_T_INPUT_MS` clamp so no
    process can emit non-positive upload times.
    """

    name: str = "network"

    @property
    def mean(self) -> float:
        """Long-run mean T_input (the stationary budget a non-adaptive
        server would trust)."""
        raise NotImplementedError

    def regime_names(self) -> List[str]:
        """Labels for the regime indices emitted by `sample_trace`."""
        return [self.name]

    def _raw_trace(self, rng: np.random.Generator,
                   n: int) -> Tuple[np.ndarray, np.ndarray]:
        """(t_input (n,), regime (n,) int64) before clamping."""
        raise NotImplementedError

    def sample_trace(self, rng: np.random.Generator,
                     n: int = 1) -> Tuple[np.ndarray, np.ndarray]:
        t, regimes = self._raw_trace(rng, int(n))
        return np.maximum(t, MIN_T_INPUT_MS), regimes

    def sample_t_input(self, rng: np.random.Generator, n: int = 1):
        return self.sample_trace(rng, n)[0]


class StationaryProcess(NetworkProcess):
    """i.i.d. draws: lognormal matched to (mean, std) for the paper's
    named networks (positive heavy tail), or plain normal for ad-hoc
    (mean, std) models — both behind the base clamp."""

    def __init__(self, name: str, mean_ms: float, std_ms: float,
                 dist: str = "lognormal"):     # "lognormal" | "normal"
        if dist not in ("lognormal", "normal"):
            raise ValueError(f"unknown distribution {dist!r}")
        if dist == "lognormal" and mean_ms <= 0:
            # log(mean) of a non-positive mean -> NaN draws that the
            # clamp cannot catch (np.maximum(nan, x) is nan).
            raise ValueError(f"lognormal network {name!r} needs a "
                             f"positive mean, got {mean_ms}")
        if std_ms < 0:
            raise ValueError(f"network {name!r} needs std >= 0, "
                             f"got {std_ms}")
        self.name = name
        self.mean_ms = float(mean_ms)
        self.std_ms = float(std_ms)
        self.dist = dist

    @classmethod
    def named(cls, name: str) -> "StationaryProcess":
        d = NETWORKS[name]
        return cls(name, d["mean"], d["std"])

    @property
    def mean(self) -> float:
        return self.mean_ms

    def _raw_trace(self, rng, n):
        if self.dist == "lognormal":
            mu, sg = lognormal_params(self.mean_ms, self.std_ms)
            t = rng.lognormal(mu, sg, size=n)
        else:
            t = rng.normal(self.mean_ms, self.std_ms, n)
        return t, np.zeros(n, np.int64)


class MarkovProcess(NetworkProcess):
    """Regime-switching network: a Markov chain over stationary states
    (one lognormal T_input distribution each), advanced per request.

    The chain is sampled per dwell *segment* (geometric dwell in the
    current state, then one conditional transition), so generating a
    sticky 10k-request trace costs a handful of numpy draws, not 10k
    python steps; the per-request T_input draw is one vectorized
    `rng.lognormal` over per-request (mu, sigma) arrays.
    """

    def __init__(self, states: Sequence, transition, *, start: int = 0,
                 name: str = "markov"):
        self.name = name
        resolved = [_resolve_state(s) for s in states]
        self.state_names = [r[0] for r in resolved]
        self._means = np.array([r[1] for r in resolved], np.float64)
        self._stds = np.array([r[2] for r in resolved], np.float64)
        self.P = np.asarray(transition, np.float64)
        K = len(resolved)
        if self.P.shape != (K, K):
            raise ValueError(f"transition matrix shape {self.P.shape} "
                             f"does not match {K} states")
        if (self.P < 0).any() or not np.allclose(self.P.sum(axis=1), 1.0):
            raise ValueError("transition matrix rows must be "
                             "non-negative and sum to 1")
        if not 0 <= start < K:
            raise ValueError(f"start state {start} out of range")
        self.start = int(start)

    @classmethod
    def from_scenario(cls, name: str) -> "MarkovProcess":
        d = NETWORK_SCENARIOS[name]
        return cls(d["states"], d["transition"],
                   start=d.get("start", 0), name=name)

    def regime_names(self) -> List[str]:
        return list(self.state_names)

    def stationary_distribution(self) -> np.ndarray:
        """pi with pi @ P = pi, sum(pi) = 1 (least-squares solve)."""
        K = self.P.shape[0]
        a = np.vstack([self.P.T - np.eye(K), np.ones(K)])
        b = np.concatenate([np.zeros(K), [1.0]])
        pi, *_ = np.linalg.lstsq(a, b, rcond=None)
        return np.maximum(pi, 0.0) / np.maximum(pi, 0.0).sum()

    @property
    def mean(self) -> float:
        return float(self.stationary_distribution() @ self._means)

    def _sample_regimes(self, rng, n):
        out = np.empty(n, np.int64)
        s, i = self.start, 0
        while i < n:
            p_stay = self.P[s, s]
            if p_stay >= 1.0:
                out[i:] = s
                break
            dwell = int(rng.geometric(1.0 - p_stay))
            j = min(n, i + dwell)
            out[i:j] = s
            i = j
            if i >= n:
                break
            cond = self.P[s].copy()
            cond[s] = 0.0
            s = int(rng.choice(len(cond), p=cond / cond.sum()))
        return out

    def _raw_trace(self, rng, n):
        regimes = self._sample_regimes(rng, n)
        mu, sg = lognormal_params(self._means[regimes],
                                   self._stds[regimes])
        return rng.lognormal(mu, sg), regimes


class TraceReplayProcess(NetworkProcess):
    """Replay a recorded/synthetic mean-T_input trace (ms per request,
    cycled over the run), with lognormal jitter of coefficient of
    variation `jitter_cv` around each point. `regime_labels` optionally
    buckets trace positions for per-regime reporting (same length as
    the trace; defaults to one regime)."""

    def __init__(self, trace, *, jitter_cv: float = 0.15,
                 name: str = "trace",
                 regime_labels: Optional[Sequence[int]] = None,
                 regime_names: Optional[Sequence[str]] = None):
        self.name = name
        self.trace = np.asarray(trace, np.float64)
        if self.trace.ndim != 1 or len(self.trace) == 0:
            raise ValueError("trace must be a non-empty 1-D array")
        if (self.trace <= 0).any():
            raise ValueError("trace means must be positive")
        self.jitter_cv = float(jitter_cv)
        if regime_labels is not None and len(regime_labels) != len(
                self.trace):
            raise ValueError("regime_labels must align with the trace")
        self._labels = (np.zeros(len(self.trace), np.int64)
                        if regime_labels is None
                        else np.asarray(regime_labels, np.int64))
        if (self._labels < 0).any():
            raise ValueError("regime_labels must be non-negative")
        n_regimes = int(self._labels.max()) + 1
        if regime_names is not None:
            self._names = list(regime_names)
            if len(self._names) < n_regimes:
                raise ValueError("regime_names must cover every label")
        else:
            # Default names must cover every label or per-regime
            # reporting would silently drop regimes >= 1.
            self._names = ([name] if n_regimes == 1 else
                           [f"{name}:{k}" for k in range(n_regimes)])

    @property
    def mean(self) -> float:
        return float(self.trace.mean())

    def regime_names(self) -> List[str]:
        return list(self._names)

    def _raw_trace(self, rng, n):
        pos = np.arange(n) % len(self.trace)
        means = self.trace[pos]
        if self.jitter_cv <= 0:
            return means.copy(), self._labels[pos]
        mu, sg = lognormal_params(means, self.jitter_cv * means)
        return rng.lognormal(mu, sg), self._labels[pos]


class NetworkModel(StationaryProcess):
    """Legacy shim (pre-NetworkProcess API): named networks draw the
    matched lognormal, ad-hoc (mean, std) models draw a clamped normal.
    Prefer `make_network` / `StationaryProcess` in new code."""

    def __init__(self, name: str, mean: float, std: float):
        super().__init__(name, mean, std,
                         dist="lognormal" if name in NETWORKS else "normal")

    @classmethod
    def named(cls, name: str) -> "NetworkModel":
        d = NETWORKS[name]
        return cls(name, d["mean"], d["std"])

    def estimate_t_input(self, observed: float | None = None) -> float:
        """Deprecated pre-estimator shim: budget from the observed
        upload time, falling back to the distribution mean. The
        estimator API subsumes it — ``make_estimator("observed")`` for
        the observation path, ``make_estimator("mean", prior=...)`` for
        the mean fallback."""
        import warnings
        warnings.warn(
            "NetworkModel.estimate_t_input is deprecated; use "
            "make_estimator('observed') / make_estimator('mean', "
            "prior=net.mean) and the Router's t_estimator instead",
            DeprecationWarning, stacklevel=2)
        return observed if observed is not None else self.mean_ms


def _captured_process(name: str, spec: str) -> NetworkProcess:
    # Lazy import: serving.trace imports NetworkProcess from here.
    from repro_torch.serving.trace import CapturedTraceProcess, load_capture
    d = CAPTURE_SCENARIOS[name]
    return CapturedTraceProcess(load_capture(name),
                                mode=d.get("mode", "loop"), name=spec)


def trace_names() -> List[str]:
    """Every name ``trace:<name>`` resolves: the synthetic traces plus
    the registered captures."""
    return sorted(SYNTHETIC_TRACES) + sorted(CAPTURE_SCENARIOS)


def make_network(spec: Union[str, NetworkProcess]) -> NetworkProcess:
    """Resolve a network spec to a process:

    - a `NetworkProcess` instance passes through;
    - a `NETWORKS` name -> `StationaryProcess` (paper behaviour);
    - a `NETWORK_SCENARIOS` name -> `MarkovProcess`;
    - ``trace:<name>`` -> `TraceReplayProcess` over the synthetic trace,
      or a recorded capture when `<name>` is a `CAPTURE_SCENARIOS` entry;
    - ``capture:<name>`` -> `CapturedTraceProcess` over the registered
      recorded capture only.
    """
    if isinstance(spec, NetworkProcess):
        return spec
    if not isinstance(spec, str):
        raise ValueError(f"network spec must be a NetworkProcess or a "
                         f"str, got {type(spec).__name__}")
    if spec in NETWORKS:
        return StationaryProcess.named(spec)
    if spec in NETWORK_SCENARIOS:
        return MarkovProcess.from_scenario(spec)
    # The shared registry grammar (core.registry.parse_spec): the same
    # unknown/takes-no-arg/needs-arg errors every other factory raises.
    head, arg = parse_spec(
        spec, kind="network",
        heads=list(NETWORKS) + list(NETWORK_SCENARIOS)
        + ["trace", "capture"],
        known=sorted(NETWORKS) + sorted(NETWORK_SCENARIOS)
        + ["trace:<name>", "capture:<name>"],
        arg_heads=("trace", "capture"),
        required_arg_heads=("trace", "capture"),
        arg_desc={"trace": ("trace name", "name"),
                  "capture": ("capture name", "name")})
    if head == "trace":
        # Sub-registry resolution: one ValueError naming every
        # resolvable trace (synthetic + recorded captures).
        if arg in SYNTHETIC_TRACES:
            return TraceReplayProcess(synthetic_trace(arg), name=spec)
        if arg in CAPTURE_SCENARIOS:
            return _captured_process(arg, spec)
        raise ValueError(f"unknown trace {arg!r}; "
                         f"known: {', '.join(trace_names())}")
    if arg not in CAPTURE_SCENARIOS:
        raise ValueError(f"unknown capture {arg!r}; known: "
                         f"{', '.join(sorted(CAPTURE_SCENARIOS))}")
    return _captured_process(arg, spec)


# --------------------------------------------------------------------------
# Online T_input estimation (server-side budgeting, ModiPick-style)
# --------------------------------------------------------------------------

class TInputEstimator:
    """Causal online estimate of the network's T_input, consulted by the
    `Router` to set per-request budgets.

    Protocol: `estimate(observed=...)` returns the budget-side T_input
    for the *current* request using only past observations (plus the
    prior / the current observation as cold-start fallbacks), then
    `observe(t)` feeds the request's measured upload time back.
    `estimate_series` runs the same protocol over a whole trace and is
    the vectorized hook the batched admission path uses.
    """

    name = "estimator"

    def __init__(self, prior: Optional[float] = None):
        self.prior = prior

    def observe(self, t_input: float) -> None:
        raise NotImplementedError

    def _state_estimate(self) -> Optional[float]:
        """Current estimate from past observations, None if cold."""
        raise NotImplementedError

    def estimate(self, observed: Optional[float] = None) -> float:
        est = self._state_estimate()
        if est is not None:
            return float(est)
        # Cold start: prior if configured, else the observation itself.
        if self.prior is not None:
            return float(self.prior)
        if observed is not None:
            return float(observed)
        raise ValueError(f"{self.name}: cold estimator with no prior "
                         f"and no observation")

    def estimate_series(self, observed) -> np.ndarray:
        observed = np.asarray(observed, np.float64)
        out = np.empty_like(observed)
        for i, x in enumerate(observed):
            out[i] = self.estimate(observed=float(x))
            self.observe(float(x))
        return out


class ObservedEstimator(TInputEstimator):
    """The paper's behaviour: budget from the actual measured upload
    time of the arriving request (identity on the observation)."""

    name = "observed"

    def observe(self, t_input: float) -> None:
        pass                          # stateless

    def _state_estimate(self):
        return None                   # always defer to the observation

    def estimate(self, observed: Optional[float] = None) -> float:
        if observed is not None:
            return float(observed)
        return super().estimate()

    def estimate_series(self, observed) -> np.ndarray:
        return np.asarray(observed, np.float64).copy()


class MeanEstimator(TInputEstimator):
    """The non-adaptive strawman: always the stationary prior mean (what
    a server trusting offline network measurements does)."""

    name = "mean"

    def observe(self, t_input: float) -> None:
        pass

    def _state_estimate(self):
        if self.prior is None:
            # Fail loudly rather than silently degrading to the
            # observation (which would be the *adaptive* behaviour).
            raise ValueError("mean estimator needs a prior")
        return self.prior

    def estimate_series(self, observed) -> np.ndarray:
        observed = np.asarray(observed, np.float64)
        if self.prior is None:
            raise ValueError("mean estimator needs a prior")
        return np.full_like(observed, float(self.prior))


class EWMAEstimator(TInputEstimator):
    """Exponentially-weighted moving average of observed upload times
    (ModiPick's estimator family): est <- (1-alpha)*est + alpha*obs."""

    name = "ewma"

    def __init__(self, alpha: float = 0.2, prior: Optional[float] = None):
        super().__init__(prior)
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"ewma alpha must be in (0, 1], got {alpha}")
        self.alpha = float(alpha)
        self._est: Optional[float] = None

    def observe(self, t_input: float) -> None:
        self._est = (float(t_input) if self._est is None else
                     (1.0 - self.alpha) * self._est
                     + self.alpha * float(t_input))

    def _state_estimate(self):
        return self._est

    def estimate_series(self, observed) -> np.ndarray:
        """Vectorized causal EWMA via the blocked closed form
        ``out[k] = r^k e + alpha r^{k-1} C[k-1]`` with ``r = 1-alpha``
        and ``C = cumsum(x[l] / r^l)`` — one numpy pass per block
        instead of a python step per request. Blocks are capped so
        ``r^{-l}`` stays inside float64 range; agreement with the
        sequential protocol is pinned by the estimator series test."""
        x = np.asarray(observed, np.float64)
        n = len(x)
        if n == 0:
            return x.copy()
        out = np.empty(n)
        r = 1.0 - self.alpha
        e = self._est
        i = 0
        if e is None:
            # Cold start answers the prior (or the observation itself),
            # and the first observe() *resets* the state to x[0].
            out[0] = (float(self.prior) if self.prior is not None
                      else float(x[0]))
            e = float(x[0])
            i = 1
        if r == 0.0:                   # alpha == 1: track the last obs
            if i == 0:
                out[0] = e
                i = 1
            out[i:] = x[i - 1:n - 1]
            self._est = float(x[-1])
            return out
        block = int(min(8192.0, max(1.0, -600.0 / np.log(r))))
        while i < n:
            m = min(block, n - i)
            xs = x[i:i + m]
            rk = r ** np.arange(m)
            c = np.cumsum(xs / rk)
            out[i] = e
            if m > 1:
                out[i + 1:i + m] = (rk[1:] * e
                                    + self.alpha * rk[:-1] * c[:-1])
            e = r ** m * e + self.alpha * r ** (m - 1) * c[-1]
            i += m
        self._est = float(e)
        return out


class PercentileEstimator(TInputEstimator):
    """Rolling-window percentile of observed upload times: a q>50
    percentile budgets conservatively against the heavy mobile tail."""

    name = "pctl"

    def __init__(self, q: float = 90.0, window: int = 64,
                 prior: Optional[float] = None):
        super().__init__(prior)
        if not 0.0 <= q <= 100.0:
            raise ValueError(f"percentile q must be in [0, 100], got {q}")
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        self.q = float(q)
        self.window = int(window)
        self._buf: deque = deque(maxlen=self.window)

    def observe(self, t_input: float) -> None:
        self._buf.append(float(t_input))

    def _state_estimate(self):
        if not self._buf:
            return None
        return float(np.percentile(np.asarray(self._buf), self.q))

    def estimate_series(self, observed) -> np.ndarray:
        """Vectorized causal rolling percentile: one strided
        `np.percentile` over all full windows, a short python loop only
        for the warm-up prefix."""
        x = np.asarray(observed, np.float64)
        n, w = len(x), self.window
        out = np.empty(n)
        pre = np.asarray(self._buf, np.float64)
        for i in range(min(n, w)):
            hist = np.concatenate([pre, x[:i]])[-w:]
            out[i] = (float(np.percentile(hist, self.q)) if len(hist)
                      else self.estimate(observed=float(x[i])))
        if n > w:
            wins = np.lib.stride_tricks.sliding_window_view(x, w)
            out[w:] = np.percentile(wins[:n - w], self.q, axis=1)
        for v in x[max(0, n - w):]:
            self.observe(float(v))
        return out


ESTIMATOR_REGISTRY = {
    "observed": lambda arg, prior: ObservedEstimator(prior=prior),
    "mean": lambda arg, prior: MeanEstimator(prior=prior),
    "ewma": lambda arg, prior: EWMAEstimator(
        alpha=float(arg) if arg else 0.2, prior=prior),
    "pctl": lambda arg, prior: PercentileEstimator(
        q=float(arg) if arg else 90.0, prior=prior),
}

# The ":<arg>"-taking estimator heads (numeric argument).
_ESTIMATOR_ARG_HEADS = ("ewma", "pctl")


def estimator_names() -> List[str]:
    """The spec forms `make_estimator` resolves (registry-error text)."""
    return ["observed", "mean", "ewma[:alpha]", "pctl[:q]"]


def validate_estimator_spec(spec: str) -> str:
    """Parse-check a string estimator spec, raising the registry-style
    `ValueError` (naming every valid spec form) on an unknown head, a
    stray ':<arg>', or a non-numeric argument — previously a bad
    argument surfaced as whatever the builder raised (an opaque
    `float()` conversion error), and `EstimatorBank` deferred even that
    to the first per-device use mid-run. Returns the head."""
    head, _ = parse_spec(spec, kind="t_input estimator",
                         heads=ESTIMATOR_REGISTRY,
                         known=estimator_names(),
                         arg_heads=_ESTIMATOR_ARG_HEADS,
                         numeric_arg_heads=_ESTIMATOR_ARG_HEADS)
    return head


def estimator_factory(spec: str):
    """Parse a string estimator spec ONCE and return a
    ``factory(prior=...) -> TInputEstimator`` closure. `EstimatorBank`
    instantiates one estimator per unseen device; routing every cold
    start through `make_estimator` re-partitioned and re-validated the
    spec string per device — noise at ten devices, real work at a
    million. The factory keeps the parsed (head, arg, builder) triple
    closed over instead."""
    head, _, arg = spec.partition(":")
    validate_estimator_spec(spec)
    builder = ESTIMATOR_REGISTRY[head]

    def factory(prior: Optional[float] = None) -> TInputEstimator:
        if head == "mean" and prior is None:
            raise ValueError("t_estimator 'mean' needs a prior; pass a "
                             "MeanEstimator(prior=...) instance instead")
        return builder(arg, prior)

    return factory


def make_estimator(spec: Union[str, TInputEstimator, None], *,
                   prior: Optional[float] = None
                   ) -> Optional[TInputEstimator]:
    """Resolve an estimator spec ("observed", "mean", "ewma[:alpha]",
    "pctl[:q]", an instance, or None -> None)."""
    if spec is None or isinstance(spec, TInputEstimator):
        return spec
    if not isinstance(spec, str):
        raise ValueError(f"t_input estimator spec must be a "
                         f"TInputEstimator, a str, or None, got "
                         f"{type(spec).__name__}")
    head, _, arg = spec.partition(":")
    validate_estimator_spec(spec)
    if head == "mean" and prior is None:
        # Fail at construction: a prior-less "mean" spec can never
        # answer. Callers without a network mean (Router, ServingLoop,
        # CNNSelectServer) must pass a MeanEstimator(prior=...) instance.
        raise ValueError("t_estimator 'mean' needs a prior; pass a "
                         "MeanEstimator(prior=...) instance instead")
    return ESTIMATOR_REGISTRY[head](arg, prior)


def resize_decision(size_kb: float, *, scale_ms_per_kb: float = 0.165,
                    upload_ms_per_kb: float = 0.214) -> bool:
    """Paper §3.1 'Impact of Image Size': downscale an input of size x1
    to x2 iff T_d(x1,x2) + T_n(x2) <= T_n(x1). Linear cost model fitted
    to the paper's measurements (36.83 ms per 172 KB upload; up to 38 ms
    to resize <=226 KB). Returns True if resizing before upload wins."""
    target_kb = 110.0  # post-resize size used in the paper's experiments
    if size_kb <= target_kb:
        return False
    t_resize = scale_ms_per_kb * size_kb
    t_up_full = upload_ms_per_kb * size_kb
    t_up_resized = upload_ms_per_kb * target_kb
    return t_resize + t_up_resized <= t_up_full
