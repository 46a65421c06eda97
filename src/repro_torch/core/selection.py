"""CNNSelect (paper §5) and baseline selection policies.

Per request: budget ``T_budget = T_sla - 2*T_input`` and limits
``T_U = T_budget``, ``T_L = T_U - T_threshold``.

Stage 1 (greedy base): maximize A(m) s.t. mu+sigma < T_U and
mu-sigma < T_L; infeasible -> fastest model (best-effort fallback).

Stage 2 (exploration set): T_E = T_L +- (|T_L - mu*| + sigma*)
(the symmetric interval from Fig 11; ``stage2_variant="text"`` gives the
paper's printed-equation variant — see DESIGN.md §8 fidelity notes);
M_E = {m : mu(m) in T_E and mu(m)+sigma(m) < T_U} plus the base model.

Stage 3 (probabilistic pick): U(m) = A(m) * (T_U - (mu+sigma)) / |T_L - mu|,
Pr(m) proportional to U(m) over M_E (clamped to eps > 0; the guards are
exercised by the hypothesis property tests).

Two implementations, tested for agreement:
  - `cnnselect`: numpy reference, one request.
  - `cnnselect_batch`: vectorized torch over N requests (on the CPU,
    with Gumbel noise from an explicit `torch.Generator`).

Both are wrapped by the `Policy` layer (DESIGN.md §2): every selection
strategy — cnnselect, greedy, greedy_nw, random, static:<name>, oracle —
is a `Policy` object with scalar `select` and vectorized `select_batch`
entry points, resolved by name through `make_policy`. The serving stacks
(server, loop, simulator) all dispatch through this one registry.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Union

import numpy as np

from repro_torch.core.registry import parse_spec

_EPS = 1e-9

# Paper's conservative network-time estimate: responses are small text
# labels, so T_nw = 2 * T_input (upload + equal-cost download).
T_NW_FACTOR = 2.0


def network_budget(t_sla, t_input, factor: float = T_NW_FACTOR):
    """Execution-time budget left after network time:
    ``T_budget = T_sla - factor * T_input``. `t_input` is whatever the
    serving stack budgets with — the observed upload time (paper) or an
    online `TInputEstimator` output (time-varying networks, DESIGN.md
    §9). Works on scalars, numpy, and jnp arrays."""
    return t_sla - factor * t_input


def on_device_fallback_decision(t_sla, t_input_est, fastest_mu,
                                on_device_ms, factor: float = T_NW_FACTOR):
    """MDInference's (arXiv:2002.06603) on-device-vs-cloud duality,
    evaluated with the *device's* estimated budget: serve locally iff
    the device can meet the SLA on its own while the estimated cloud
    path cannot even with the fastest model in the zoo —

        ``on_device_ms <= T_sla < factor * t_input_est + fastest_mu``.

    ``on_device_ms == 0`` means the device has no on-device capability
    and never falls back (paper §4: a Nexus 5 at ~9 s is never viable).
    Vectorized over per-request arrays of estimates / device profiles."""
    od = np.asarray(on_device_ms, np.float64)
    cloud_est = factor * np.asarray(t_input_est, np.float64) + fastest_mu
    return (od > 0.0) & (od <= t_sla) & (cloud_est > t_sla)


@dataclass(frozen=True)
class ModelProfile:
    name: str
    accuracy: float            # A(m), in [0, 1]
    mu: float                  # mean inference time (ms)
    sigma: float               # std of inference time (ms)
    cold_mu: float = 0.0       # cold-start mean (ms), Table 5
    cold_sigma: float = 0.0
    size_bytes: int = 0


@dataclass
class SelectionResult:
    index: int                 # selected model
    base_index: int            # stage-1 base model
    eligible: np.ndarray       # bool (K,), the exploration set M_E
    probs: np.ndarray          # (K,), zero outside M_E
    fallback: bool             # stage-1 infeasible -> fastest model
    t_budget: float
    t_low: float
    t_up: float


def _limits(t_sla: float, t_input: float, t_threshold: float):
    t_budget = network_budget(t_sla, t_input)
    t_up = t_budget
    t_low = t_up - t_threshold
    return t_budget, t_low, t_up


def cnnselect(profiles: Sequence[ModelProfile], t_sla: float, t_input: float,
              t_threshold: float, rng: np.random.Generator,
              stage2_variant: str = "figure") -> SelectionResult:
    acc = np.array([p.accuracy for p in profiles], dtype=np.float64)
    mu = np.array([p.mu for p in profiles], dtype=np.float64)
    sg = np.array([p.sigma for p in profiles], dtype=np.float64)
    K = len(profiles)
    t_budget, t_low, t_up = _limits(t_sla, t_input, t_threshold)

    # Stage 1: greedy base model.
    feasible = (mu + sg < t_up) & (mu - sg < t_low)
    fallback = not feasible.any()
    if fallback:
        base = int(np.argmin(mu))
    else:
        # max accuracy; ties -> smaller mu.
        masked = np.where(feasible, acc, -np.inf)
        best_acc = masked.max()
        cands = np.where(masked >= best_acc - 1e-12)[0]
        base = int(cands[np.argmin(mu[cands])])

    # Stage 2: exploration set.
    if fallback:
        eligible = np.zeros(K, dtype=bool)
        eligible[base] = True
    else:
        if stage2_variant == "figure":
            delta = abs(t_low - mu[base]) + sg[base]
            lo, hi = t_low - delta, t_low + delta
        else:  # "text": the paper's printed equation
            if t_low > mu[base]:
                lo, hi = mu[base] + sg[base], 2 * t_low - mu[base] + sg[base]
            else:
                lo, hi = 2 * t_low - mu[base] + sg[base], mu[base] + sg[base]
        eligible = (mu >= lo) & (mu <= hi) & (mu + sg < t_up)
        eligible[base] = True

    # Stage 3: probabilistic pick by utility.
    util = acc * (t_up - (mu + sg)) / np.maximum(np.abs(t_low - mu), _EPS)
    util = np.where(eligible, np.maximum(util, _EPS), 0.0)
    total = util.sum()
    probs = util / total if total > 0 else eligible / eligible.sum()
    idx = int(rng.choice(K, p=probs))
    return SelectionResult(idx, base, eligible, probs, fallback,
                           t_budget, t_low, t_up)


# --------------------------------------------------------------------------
# Vectorized torch implementation (N requests at once)
# --------------------------------------------------------------------------

def cnnselect_batch(mu, sigma, acc, t_sla, t_input, t_threshold, generator,
                    stage2_variant: str = "figure"):
    """mu/sigma/acc: (K,); t_sla/t_input: (N,); generator: a CPU
    `torch.Generator` for the Gumbel noise.
    Returns (selected (N,) int32, probs (N,K), base (N,) int32).

    Admission math, not device work: it runs in float32 on the CPU."""
    import torch

    f32 = torch.float32
    mu = torch.tensor(np.asarray(mu, np.float32))
    sg = torch.tensor(np.asarray(sigma, np.float32))
    acc = torch.tensor(np.asarray(acc, np.float32))
    t_sla = torch.tensor(np.asarray(t_sla, np.float32))
    t_input = torch.tensor(np.asarray(t_input, np.float32))
    K = mu.shape[0]

    t_up = network_budget(t_sla, t_input)[:, None]   # (N,1)
    t_low = t_up - t_threshold

    feasible = (mu + sg < t_up) & (mu - sg < t_low)  # (N,K)
    any_feas = feasible.any(dim=1)
    masked_acc = torch.where(feasible, acc, -torch.inf)
    # max accuracy, ties -> smaller mu: lexicographic score.
    score = masked_acc - 1e-9 * mu
    base_feas = torch.argmax(score, dim=1)
    base_fall = torch.argmin(mu)
    base = torch.where(any_feas, base_feas, base_fall).to(torch.int32)

    mu_b = mu[base.long()][:, None]
    sg_b = sg[base.long()][:, None]
    if stage2_variant == "figure":
        delta = torch.abs(t_low - mu_b) + sg_b
        lo, hi = t_low - delta, t_low + delta
    else:
        hi0 = 2 * t_low - mu_b + sg_b
        lo0 = mu_b + sg_b
        swap = t_low <= mu_b
        lo = torch.where(swap, hi0, lo0)
        hi = torch.where(swap, lo0, hi0)
    one_hot = torch.nn.functional.one_hot(base.long(), K).bool()
    eligible = (mu >= lo) & (mu <= hi) & (mu + sg < t_up)
    eligible = eligible | one_hot
    eligible = torch.where(any_feas[:, None], eligible, one_hot)

    util = acc * (t_up - (mu + sg)) / torch.clamp(torch.abs(t_low - mu),
                                                 min=_EPS)
    util = torch.where(eligible, torch.clamp(util, min=_EPS), 0.0)
    probs = util / torch.clamp(util.sum(dim=1, keepdim=True), min=_EPS)
    # Gumbel-max categorical sampling.
    u = torch.rand(probs.shape, generator=generator, dtype=f32)
    g = -torch.log(-torch.log(torch.clamp(u, min=torch.finfo(f32).tiny)))
    logp = torch.where(probs > 0, torch.log(torch.clamp(probs, min=1e-30)),
                       -torch.inf)
    selected = torch.argmax(logp + g, dim=1).to(torch.int32)
    return selected, probs, base


# --------------------------------------------------------------------------
# Baselines (paper §5.2.2 and standard references)
# --------------------------------------------------------------------------

def greedy_select(profiles: Sequence[ModelProfile], t_sla: float,
                  *, t_input: float = 0.0, use_network: bool = False) -> int:
    """Paper's greedy: the most accurate model whose mean time fits the
    SLA. It ignores network-time variability (use_network=False) — the
    key weakness CNNSelect addresses."""
    budget = network_budget(t_sla, t_input) if use_network else t_sla
    acc = np.array([p.accuracy for p in profiles])
    mu = np.array([p.mu for p in profiles])
    ok = mu <= budget
    if not ok.any():
        return int(np.argmin(mu))
    masked = np.where(ok, acc, -np.inf)
    return int(np.argmax(masked))


def static_select(profiles: Sequence[ModelProfile], index: int) -> int:
    return index


def random_select(profiles: Sequence[ModelProfile],
                  rng: np.random.Generator) -> int:
    return int(rng.integers(len(profiles)))


def oracle_select(profiles: Sequence[ModelProfile], t_sla: float,
                  t_input: float, realized_times: np.ndarray) -> int:
    """Upper bound: knows each model's realized execution time for this
    request; picks the most accurate that meets the SLA end-to-end."""
    acc = np.array([p.accuracy for p in profiles])
    ok = realized_times <= network_budget(t_sla, t_input)
    if not ok.any():
        return int(np.argmin(realized_times))
    masked = np.where(ok, acc, -np.inf)
    return int(np.argmax(masked))


# --------------------------------------------------------------------------
# Policy layer: one object per strategy, one registry for all stacks
# --------------------------------------------------------------------------

@dataclass
class BatchSelection:
    """Vectorized selection over N requests (DESIGN.md §3).

    `probs`/`base`/`eligible` are populated only by probabilistic
    policies (cnnselect); deterministic baselines fill `indices` alone.
    """
    indices: np.ndarray                  # (N,) int
    probs: Optional[np.ndarray] = None   # (N, K)
    base: Optional[np.ndarray] = None    # (N,) stage-1 base models

    @property
    def eligible(self) -> Optional[np.ndarray]:
        """Exploration sets M_E as a bool (N, K) mask. Utilities are
        clamped to eps > 0 inside M_E, so the support of probs IS the
        exploration set — in both the numpy and the jnp implementation."""
        return None if self.probs is None else self.probs > 0.0


class Policy:
    """A model-selection strategy over a profile zoo.

    `select` answers one request; `select_batch` answers N at once (the
    simulator's hot path). The default `select_batch` is a python loop
    over `select`; policies with a vectorized form override it.
    """

    name: str = "policy"

    def select(self, profiles: Sequence[ModelProfile], t_sla: float,
               t_input: float, *, realized: Optional[np.ndarray] = None
               ) -> int:
        raise NotImplementedError

    def select_batch(self, profiles: Sequence[ModelProfile],
                     t_sla: np.ndarray, t_input: np.ndarray, *,
                     realized: Optional[np.ndarray] = None,
                     detail: bool = False
                     ) -> Union[np.ndarray, BatchSelection]:
        t_sla = np.broadcast_to(np.asarray(t_sla, np.float64),
                                np.shape(t_input))
        idx = np.array([
            self.select(profiles, float(t_sla[i]), float(t_input[i]),
                        realized=None if realized is None else realized[i])
            for i in range(len(t_input))], dtype=np.int64)
        return BatchSelection(idx) if detail else idx


class CNNSelectPolicy(Policy):
    """The paper's policy. Scalar path: numpy `cnnselect`. Batch path:
    the `cnnselect_batch` Gumbel-max selection, called on fixed-size
    chunks with noise from the policy's own seeded `torch.Generator`."""

    name = "cnnselect"

    def __init__(self, *, t_threshold: float = 50.0,
                 stage2_variant: str = "figure", seed: int = 0,
                 chunk: int = 2048):
        self.t_threshold = t_threshold
        self.stage2_variant = stage2_variant
        self.seed = seed
        self.chunk = chunk
        self.rng = np.random.default_rng(seed)
        self._key = None                     # lazy torch.Generator

    def select(self, profiles, t_sla, t_input, *, realized=None) -> int:
        r = cnnselect(profiles, t_sla, t_input, self.t_threshold, self.rng,
                      self.stage2_variant)
        return r.index

    def select_batch(self, profiles, t_sla, t_input, *, realized=None,
                     detail: bool = False):
        import torch

        if self._key is None:
            self._key = torch.Generator().manual_seed(self.seed)
        mu = np.array([p.mu for p in profiles], np.float32)
        sg = np.array([p.sigma for p in profiles], np.float32)
        acc = np.array([p.accuracy for p in profiles], np.float32)
        t_input = np.asarray(t_input, np.float32)
        t_sla = np.broadcast_to(np.asarray(t_sla, np.float32),
                                t_input.shape)
        N, K = t_input.shape[0], mu.shape[0]
        idx = np.empty(N, np.int64)
        probs = np.empty((N, K), np.float64) if detail else None
        base = np.empty(N, np.int64) if detail else None
        for lo in range(0, N, self.chunk):
            hi = min(lo + self.chunk, N)
            sel_c, probs_c, base_c = cnnselect_batch(
                mu, sg, acc, t_sla[lo:hi], t_input[lo:hi], self.t_threshold,
                self._key, stage2_variant=self.stage2_variant)
            idx[lo:hi] = sel_c.numpy()
            if detail:
                probs[lo:hi] = probs_c.numpy()
                base[lo:hi] = base_c.numpy()
        return BatchSelection(idx, probs, base) if detail else idx


class GreedyPolicy(Policy):
    """Paper baseline; `use_network=True` is the greedy_nw variant that
    subtracts the observed 2*T_input from the budget."""

    def __init__(self, *, use_network: bool = False):
        self.use_network = use_network
        self.name = "greedy_nw" if use_network else "greedy"

    def select(self, profiles, t_sla, t_input, *, realized=None) -> int:
        return greedy_select(profiles, t_sla, t_input=t_input,
                             use_network=self.use_network)

    def select_batch(self, profiles, t_sla, t_input, *, realized=None,
                     detail: bool = False):
        acc = np.array([p.accuracy for p in profiles])
        mu = np.array([p.mu for p in profiles])
        t_input = np.asarray(t_input, np.float64)
        t_sla = np.broadcast_to(np.asarray(t_sla, np.float64),
                                t_input.shape)
        budget = network_budget(t_sla, t_input) if self.use_network \
            else t_sla
        ok = mu[None, :] <= budget[:, None]
        masked = np.where(ok, acc[None, :], -np.inf)
        idx = np.where(ok.any(axis=1), np.argmax(masked, axis=1),
                       np.argmin(mu))
        return BatchSelection(idx) if detail else idx


class RandomPolicy(Policy):
    name = "random"

    def __init__(self, *, seed: int = 0):
        self.rng = np.random.default_rng(seed)

    def select(self, profiles, t_sla, t_input, *, realized=None) -> int:
        return random_select(profiles, self.rng)

    def select_batch(self, profiles, t_sla, t_input, *, realized=None,
                     detail: bool = False):
        idx = self.rng.integers(len(profiles), size=len(t_input))
        return BatchSelection(idx) if detail else idx


class StaticPolicy(Policy):
    """Always the named model (the paper's per-model static baselines)."""

    def __init__(self, model_name: str):
        self.model_name = model_name
        self.name = f"static:{model_name}"

    def _index(self, profiles) -> int:
        names = [p.name for p in profiles]
        if self.model_name not in names:
            raise ValueError(f"static policy: model {self.model_name!r} "
                             f"not in zoo {names}")
        return names.index(self.model_name)

    def select(self, profiles, t_sla, t_input, *, realized=None) -> int:
        return self._index(profiles)

    def select_batch(self, profiles, t_sla, t_input, *, realized=None,
                     detail: bool = False):
        idx = np.full(len(t_input), self._index(profiles), np.int64)
        return BatchSelection(idx) if detail else idx


class OraclePolicy(Policy):
    """Upper bound: sees each request's realized execution times."""

    name = "oracle"

    def select(self, profiles, t_sla, t_input, *, realized=None) -> int:
        if realized is None:
            raise ValueError("oracle policy needs realized times")
        return oracle_select(profiles, t_sla, t_input, realized)

    def select_batch(self, profiles, t_sla, t_input, *, realized=None,
                     detail: bool = False):
        if realized is None:
            raise ValueError("oracle policy needs realized times")
        acc = np.array([p.accuracy for p in profiles])
        realized = np.asarray(realized, np.float64)           # (N, K)
        t_input = np.asarray(t_input, np.float64)
        t_sla = np.broadcast_to(np.asarray(t_sla, np.float64),
                                t_input.shape)
        ok = realized <= network_budget(t_sla, t_input)[:, None]
        masked = np.where(ok, acc[None, :], -np.inf)
        idx = np.where(ok.any(axis=1), np.argmax(masked, axis=1),
                       np.argmin(realized, axis=1))
        return BatchSelection(idx) if detail else idx


# --------------------------------------------------------------------------
# Control modes: the (policy, hedge, estimator) operating points the
# online control plane switches between (serving/control.py)
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class ControlMode:
    """One operating point of the serving control plane: which policy
    budgets, which estimator feeds the budget, and how aggressively the
    stack hedges/falls back. The `AdaptiveController`
    (serving/control.py) escalates through an *ordered* list of modes
    on detected network degradation and de-escalates on recovery.

    `policy=None` keeps the stack's base policy (only the budgeting
    side changes); `degraded=True` marks the mode as a degraded-regime
    operating point — requests served under it count as degraded for
    hedging/fallback purposes (the detector, not the crude
    `outage_factor` threshold, is the degradation signal)."""

    name: str
    policy: Optional[str] = None       # None = keep the base policy
    t_estimator: Optional[str] = None  # None = budget from observations
    hedge: str = "none"                # "none" | "p95" | "outage"
    degraded: bool = False
    on_device_fallback: bool = False


# Named modes the adaptive controller's tables reference. Ordered
# tables (configs/paper_zoo.CONTROLLER_SCENARIOS) list them least ->
# most conservative; the controller walks the list on alarms.
CONTROL_MODES: Dict[str, ControlMode] = {
    # Stationary operation: the paper's behaviour — budget from each
    # request's observed upload time — with the per-request outage
    # safety valve armed (spike-gated hedging/fallback for the
    # individual uploads whose estimated cloud path cannot meet the
    # SLA; `degraded=False`, so the gate is the outage_factor rule, not
    # the whole regime).
    "stationary": ControlMode(name="stationary", t_estimator=None,
                              hedge="outage", on_device_fallback=True),
    # Detected degradation: budget from a conservative rolling
    # percentile, hedge degraded requests, allow on-device fallback.
    "degraded": ControlMode(name="degraded", t_estimator="pctl:90",
                            hedge="outage", degraded=True,
                            on_device_fallback=True),
    # Conservative stationary variant (slow-reacting estimator).
    "cautious": ControlMode(name="cautious", t_estimator="pctl:75",
                            degraded=False),
}


def mode_names() -> List[str]:
    return sorted(CONTROL_MODES)


def make_mode(spec: Union[str, ControlMode]) -> ControlMode:
    """Resolve a control-mode spec (a `CONTROL_MODES` name or an
    already-built `ControlMode`)."""
    if isinstance(spec, ControlMode):
        return spec
    if not isinstance(spec, str):
        raise ValueError(f"unknown control mode {spec!r}; known: "
                         f"{', '.join(mode_names())}")
    head, _ = parse_spec(spec, kind="control mode", heads=CONTROL_MODES,
                         known=mode_names())
    return CONTROL_MODES[head]


# Name -> factory(arg, **options). `arg` is the text after ":" in specs
# like "static:<model>"; options are the shared policy knobs.
POLICY_REGISTRY: Dict[str, Callable[..., Policy]] = {
    "cnnselect": lambda arg, **kw: CNNSelectPolicy(
        t_threshold=kw["t_threshold"], stage2_variant=kw["stage2_variant"],
        seed=kw["seed"], chunk=kw["chunk"]),
    "greedy": lambda arg, **kw: GreedyPolicy(use_network=False),
    "greedy_nw": lambda arg, **kw: GreedyPolicy(use_network=True),
    "random": lambda arg, **kw: RandomPolicy(seed=kw["seed"]),
    "static": lambda arg, **kw: StaticPolicy(arg),
    "oracle": lambda arg, **kw: OraclePolicy(),
}


def policy_names() -> List[str]:
    return list(POLICY_REGISTRY)


def make_policy(spec: Union[str, Policy], *, t_threshold: float = 50.0,
                stage2_variant: str = "figure", seed: int = 0,
                chunk: int = 2048) -> Policy:
    """Resolve a policy spec ("cnnselect", "greedy", "static:<name>", or
    an already-built Policy) to a Policy instance."""
    if isinstance(spec, Policy):
        return spec
    head, arg = parse_spec(spec, kind="policy", heads=POLICY_REGISTRY,
                           known=policy_names(),
                           arg_heads=("static",),
                           required_arg_heads=("static",),
                           arg_desc={"static": ("model name", "name")})
    return POLICY_REGISTRY[head](arg, t_threshold=t_threshold,
                                 stage2_variant=stage2_variant, seed=seed,
                                 chunk=chunk)
