"""Trace capture & replay: record real T_input sequences from the
serving stacks and replay them through the simulator (the sim-to-real
loop, ROADMAP "Trace capture").

The paper's core claim is that *variable* mobile network conditions
dominate cloud-based inference end-to-end time; ModiPick
(arXiv:1909.02053) and MDInference (arXiv:2002.06603) both evaluate
against *recorded* mobile network traces, not stationary assumptions.
Until now our `TraceReplayProcess` only ever replayed synthetic traces —
this module closes the gap:

- **`Trace`** — a versioned on-disk capture format: per-request
  ``(t_arrival, device_id, t_input_ms, regime_id, model, sla_ok)``
  columns plus a metadata header (schema version, source, regime
  names, free-form ``meta``). `save`/`load` round-trip bit-exact
  through two codecs, JSONL (line-oriented, diff-able, the committed
  reference format) and npz (binary, compact).
- **`TraceRecorder`** — hooks the live serving layers
  (`CNNSelectServer.handle`, `ServingLoop.run`, `Router.submit`) via
  their ``recorder`` attribute and accumulates records; `to_trace()`
  snapshots a `Trace`.
- **`CapturedTraceProcess`** — a `NetworkProcess` that replays a
  capture bit-for-bit (``mode="exact"``, including regime ids so
  `per_regime` attainment composes), or resampled: ``loop`` (cycle),
  ``bootstrap`` (block bootstrap, preserving local autocorrelation),
  ``timewarp:<factor>`` (stretch/compress regime dwell times).
- **`FleetMixture.from_capture`** (serving/fleet.py) — reconstructs
  per-device `DeviceProfile`s from a multi-device capture so recorded
  fleets replay through the device-keyed `EstimatorBank` path.

Named captures live in `configs/paper_zoo.CAPTURE_SCENARIOS` (files
under ``src/repro/configs/traces/``) and resolve through
``make_network("capture:<name>")`` / ``trace:<name>``. The
capture→persist→replay round trip is pinned in CI
(`benchmarks/trace_replay.py --check`). See DESIGN.md §11.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

from repro_torch.serving.network import NetworkProcess

# Bump when the on-disk column set / header layout changes; `load`
# fails fast on any other version so old builds never misread captures.
TRACE_SCHEMA_VERSION = 1
_TRACE_KIND = "repro.trace"

# sla_ok is tri-state: admission-time hooks (Router.submit) cannot know
# the outcome yet.
SLA_UNKNOWN, SLA_MISS, SLA_MET = -1, 0, 1

CAPTURE_MODES = ("exact", "loop", "bootstrap", "timewarp")


@dataclass
class Trace:
    """One captured serving run: parallel per-request columns plus the
    header metadata that makes the capture self-describing."""

    t_arrival: np.ndarray              # (N,) float64 ms
    device_id: np.ndarray              # (N,) str ("" = untagged)
    t_input_ms: np.ndarray             # (N,) float64 ms
    regime_id: np.ndarray              # (N,) int64
    model: np.ndarray                  # (N,) str ("" = not yet routed)
    sla_ok: np.ndarray                 # (N,) int8, SLA_UNKNOWN/MISS/MET
    regime_names: List[str] = field(default_factory=lambda: ["live"])
    name: str = "capture"
    source: str = "unknown"            # server | loop | router | simulator
    meta: Dict = field(default_factory=dict)
    schema_version: int = TRACE_SCHEMA_VERSION

    # Fixed-width numpy unicode columns (npz-friendly); longer strings
    # must be rejected, never silently truncated — truncation could
    # merge distinct device keys.
    MAX_STR = 64

    @classmethod
    def _str_col(cls, values, col: str) -> np.ndarray:
        arr = np.asarray(values, dtype=np.str_)
        if arr.dtype.itemsize // 4 > cls.MAX_STR:
            raise ValueError(f"trace {col} strings must be <= "
                             f"{cls.MAX_STR} chars (truncating could "
                             f"merge distinct keys)")
        return arr.astype(f"U{cls.MAX_STR}")

    def __post_init__(self):
        self.t_arrival = np.asarray(self.t_arrival, np.float64)
        self.device_id = self._str_col(self.device_id, "device_id")
        self.t_input_ms = np.asarray(self.t_input_ms, np.float64)
        self.regime_id = np.asarray(self.regime_id, np.int64)
        self.model = self._str_col(self.model, "model")
        self.sla_ok = np.asarray(self.sla_ok, np.int8)
        self.validate()

    def validate(self):
        n = len(self.t_input_ms)
        for col in ("t_arrival", "device_id", "regime_id", "model",
                    "sla_ok"):
            if len(getattr(self, col)) != n:
                raise ValueError(f"trace column {col!r} has "
                                 f"{len(getattr(self, col))} rows, "
                                 f"expected {n}")
        if n == 0:
            raise ValueError("trace must hold at least one request")
        # NaN passes a `<= 0` test and would replay as an always-met
        # SLA (NaN latency compares False) — reject non-finite values
        # at the load/construction boundary.
        if not np.isfinite(self.t_input_ms).all() or (
                self.t_input_ms <= 0).any():
            raise ValueError("trace t_input_ms must be positive and "
                             "finite")
        if not np.isfinite(self.t_arrival).all():
            raise ValueError("trace t_arrival must be finite")
        if (self.regime_id < 0).any():
            raise ValueError("trace regime ids must be non-negative")
        if int(self.regime_id.max()) >= len(self.regime_names):
            raise ValueError(
                f"trace regime id {int(self.regime_id.max())} has no "
                f"name; regime_names covers {len(self.regime_names)}")
        bad = set(np.unique(self.sla_ok)) - {SLA_UNKNOWN, SLA_MISS,
                                             SLA_MET}
        if bad:
            raise ValueError(f"trace sla_ok values must be -1/0/1, "
                             f"got {sorted(bad)}")

    def __len__(self) -> int:
        return len(self.t_input_ms)

    # -- derived views ------------------------------------------------------

    @property
    def attainment(self) -> float:
        """SLA attainment over the requests whose outcome is known."""
        known = self.sla_ok != SLA_UNKNOWN
        if not known.any():
            return float("nan")
        return float((self.sla_ok[known] == SLA_MET).mean())

    def device_ids(self) -> List[str]:
        """Distinct issuing devices, in first-appearance order."""
        _, first = np.unique(self.device_id, return_index=True)
        return [str(self.device_id[i]) for i in sorted(first)]

    def per_device(self) -> Dict[str, np.ndarray]:
        """device_id -> row indices (order preserved)."""
        return {d: np.flatnonzero(self.device_id == d)
                for d in self.device_ids()}

    def header(self) -> Dict:
        return {
            "kind": _TRACE_KIND,
            "schema": int(self.schema_version),
            "name": self.name,
            "source": self.source,
            "n": len(self),
            "regime_names": list(self.regime_names),
            "meta": self.meta,
        }

    # -- constructors -------------------------------------------------------

    @classmethod
    def from_sim(cls, result, *, name: str = "simulated",
                 meta: Optional[Dict] = None) -> "Trace":
        """Capture a `SimResult` (the simulator records its workload —
        `t_inputs`/`arrivals` — exactly for this). Model names are the
        selection indices' names when the caller stored them in
        `meta["models"]`; otherwise the raw index as text."""
        if result.t_inputs is None or result.arrivals is None:
            raise ValueError("SimResult carries no workload capture "
                             "(t_inputs/arrivals); re-run simulate()")
        n = len(result.t_inputs)
        models = (meta or {}).get("models")
        sel = np.asarray(result.selections, np.int64)
        if models is not None:
            name_of = np.asarray(list(models) + ["<on-device>"],
                                 np.str_)
            model_col = name_of[np.where(sel < 0, len(models), sel)]
        else:
            model_col = np.array([str(int(s)) for s in sel], np.str_)
        if result.device_index is not None and result.device_ids:
            dev = np.asarray(result.device_ids,
                             np.str_)[result.device_index]
        else:
            dev = np.full(n, "", np.str_)
        regimes = (result.regimes if result.regimes is not None
                   else np.zeros(n, np.int64))
        rnames = (list(result.regime_names) if result.regime_names
                  else ["live"])
        meta = dict(meta or {})
        if getattr(result, "switch_events", None):
            # Online-control adaptations (DESIGN.md §12): the
            # controller's mode-switch events ride in the capture, so a
            # replay can verify it reproduces the same adaptation
            # sequence (and analysis can line switches up with the
            # recorded regimes).
            meta.setdefault("control_events",
                            [dict(e) for e in result.switch_events])
            if result.mode_names is not None:
                meta.setdefault("control_modes",
                                list(result.mode_names))
        return cls(
            t_arrival=result.arrivals, device_id=dev,
            t_input_ms=result.t_inputs, regime_id=regimes,
            model=model_col,
            sla_ok=np.where(result.violations, SLA_MISS, SLA_MET).astype(
                np.int8),
            regime_names=rnames, name=name, source="simulator",
            meta=meta)

    # -- codecs -------------------------------------------------------------

    def save(self, path: Union[str, os.PathLike]) -> None:
        """Write the capture; the codec is chosen by extension
        (``.jsonl`` line-oriented text, ``.npz`` binary). Both
        round-trip bit-exact (json float text is shortest-repr, which
        python parses back to the identical double)."""
        path = os.fspath(path)
        if path.endswith(".jsonl"):
            self._save_jsonl(path)
        elif path.endswith(".npz"):
            self._save_npz(path)
        else:
            raise ValueError(f"unknown trace extension for {path!r}; "
                             f"use .jsonl or .npz")

    @classmethod
    def load(cls, path: Union[str, os.PathLike]) -> "Trace":
        path = os.fspath(path)
        if path.endswith(".jsonl"):
            return cls._load_jsonl(path)
        if path.endswith(".npz"):
            return cls._load_npz(path)
        raise ValueError(f"unknown trace extension for {path!r}; "
                         f"use .jsonl or .npz")

    def _save_jsonl(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(json.dumps(self.header(), sort_keys=True) + "\n")
            for i in range(len(self)):
                f.write(json.dumps({
                    "t": float(self.t_arrival[i]),
                    "d": str(self.device_id[i]),
                    "ti": float(self.t_input_ms[i]),
                    "r": int(self.regime_id[i]),
                    "m": str(self.model[i]),
                    "ok": int(self.sla_ok[i]),
                }, sort_keys=True) + "\n")

    @classmethod
    def _load_jsonl(cls, path: str) -> "Trace":
        with open(path) as f:
            header = cls._check_header(json.loads(f.readline()), path)
            rows = [json.loads(line) for line in f if line.strip()]
        if len(rows) != header["n"]:
            raise ValueError(f"trace {path!r} declares {header['n']} "
                             f"requests but holds {len(rows)}")
        return cls(
            t_arrival=np.array([r["t"] for r in rows], np.float64),
            device_id=np.array([r["d"] for r in rows], np.str_),
            t_input_ms=np.array([r["ti"] for r in rows], np.float64),
            regime_id=np.array([r["r"] for r in rows], np.int64),
            model=np.array([r["m"] for r in rows], np.str_),
            sla_ok=np.array([r["ok"] for r in rows], np.int8),
            regime_names=list(header["regime_names"]),
            name=header["name"], source=header["source"],
            meta=header["meta"], schema_version=header["schema"])

    def _save_npz(self, path: str) -> None:
        np.savez(path, header=np.array(
            json.dumps(self.header(), sort_keys=True)),
            t_arrival=self.t_arrival, device_id=self.device_id,
            t_input_ms=self.t_input_ms, regime_id=self.regime_id,
            model=self.model, sla_ok=self.sla_ok)

    @classmethod
    def _load_npz(cls, path: str) -> "Trace":
        with np.load(path) as z:
            header = cls._check_header(json.loads(str(z["header"])), path)
            return cls(
                t_arrival=z["t_arrival"], device_id=z["device_id"],
                t_input_ms=z["t_input_ms"], regime_id=z["regime_id"],
                model=z["model"], sla_ok=z["sla_ok"],
                regime_names=list(header["regime_names"]),
                name=header["name"], source=header["source"],
                meta=header["meta"], schema_version=header["schema"])

    @staticmethod
    def _check_header(header: Dict, path: str) -> Dict:
        if header.get("kind") != _TRACE_KIND:
            raise ValueError(f"{path!r} is not a {_TRACE_KIND} capture "
                             f"(kind={header.get('kind')!r})")
        if header.get("schema") != TRACE_SCHEMA_VERSION:
            raise ValueError(
                f"trace {path!r} has schema version "
                f"{header.get('schema')!r}; this build reads version "
                f"{TRACE_SCHEMA_VERSION} — re-capture it or load with "
                f"a matching build")
        return header


# --------------------------------------------------------------------------
# Live capture (the serving-layer hooks)
# --------------------------------------------------------------------------

class TraceRecorder:
    """Accumulates per-request records from the live serving layers.

    Attach with `attach(target)` — `CNNSelectServer`, `ServingLoop`,
    and `Router` all expose a ``recorder`` attribute their hot path
    consults — or feed records directly via `record(...)`. Layers that
    only see admission (`Router.submit`) record ``sla_ok=None``
    (stored as `SLA_UNKNOWN`); outcome-aware layers record the bool.
    """

    def __init__(self, *, name: str = "capture"):
        self.name = name
        self._rows: List[tuple] = []
        self._exec: List[Optional[float]] = []
        self._attached: List[object] = []

    def __len__(self) -> int:
        return len(self._rows)

    def record(self, *, t_arrival: float, t_input_ms: float,
               device_id: Optional[str] = None, regime_id: int = 0,
               model: str = "", sla_ok: Optional[bool] = None,
               exec_ms: Optional[float] = None) -> None:
        if not t_input_ms > 0:
            # Fail at the offending request, not at to_trace() after the
            # whole run is captured and unrecoverable. (Request defaults
            # t_input_ms to 0.0 — a capture needs it set.)
            raise ValueError(f"capture needs a positive t_input_ms, got "
                             f"{t_input_ms!r} (set Request.t_input_ms)")
        for col, v in (("device_id", device_id or ""), ("model", model)):
            if len(str(v)) > Trace.MAX_STR:
                raise ValueError(f"capture {col} {str(v)[:20]!r}... "
                                 f"exceeds {Trace.MAX_STR} chars")
        ok = SLA_UNKNOWN if sla_ok is None else (
            SLA_MET if sla_ok else SLA_MISS)
        self._rows.append((float(t_arrival), str(device_id or ""),
                           float(t_input_ms), int(regime_id),
                           str(model), ok))
        # Measured execution time is a side channel (outcome-aware
        # layers only): when every row has one, `to_trace` exports it
        # as meta["exec_ms"] so replays can inject the measured times.
        self._exec.append(None if exec_ms is None else float(exec_ms))

    def record_request(self, req, *, model: str = "",
                       sla_ok: Optional[bool] = None,
                       exec_ms: Optional[float] = None) -> None:
        """Record a `serving.batching.Request` (the shape every layer
        hook holds when it fires)."""
        self.record(t_arrival=req.arrival, t_input_ms=req.t_input_ms,
                    device_id=req.device_id, model=model, sla_ok=sla_ok,
                    exec_ms=exec_ms)

    def attach(self, target) -> "TraceRecorder":
        """Hook a serving layer: sets ``target.recorder = self``
        (`CNNSelectServer`, `ServingLoop`, `Router` all consult it).
        A `ServingLoop`/`CNNSelectServer` also covers its own router —
        attaching both would double-record admissions."""
        if not hasattr(target, "recorder"):
            raise ValueError(f"{type(target).__name__} exposes no "
                             f"recorder hook")
        target.recorder = self
        self._attached.append(target)
        return self

    def detach(self) -> None:
        for t in self._attached:
            t.recorder = None
        self._attached.clear()

    def __enter__(self) -> "TraceRecorder":
        return self

    def __exit__(self, *exc) -> None:
        self.detach()

    def clear(self) -> None:
        self._rows.clear()
        self._exec.clear()

    def to_trace(self, *, name: Optional[str] = None,
                 source: str = "server",
                 regime_names: Optional[Sequence[str]] = None,
                 meta: Optional[Dict] = None) -> Trace:
        if not self._rows:
            raise ValueError("recorder holds no requests yet")
        cols = list(zip(*self._rows))
        n_regimes = max(cols[3]) + 1
        names = (list(regime_names) if regime_names is not None
                 else ["live"] if n_regimes == 1
                 else [f"live:{k}" for k in range(n_regimes)])
        meta = dict(meta or {})
        if all(e is not None for e in self._exec):
            meta.setdefault("exec_ms", list(self._exec))
        return Trace(
            t_arrival=np.array(cols[0], np.float64),
            device_id=np.array(cols[1], "U64"),
            t_input_ms=np.array(cols[2], np.float64),
            regime_id=np.array(cols[3], np.int64),
            model=np.array(cols[4], "U64"),
            sla_ok=np.array(cols[5], np.int8),
            regime_names=names, name=name or self.name, source=source,
            meta=meta)


# --------------------------------------------------------------------------
# Replay (captures as NetworkProcesses)
# --------------------------------------------------------------------------

class CapturedTraceProcess(NetworkProcess):
    """Replay a captured T_input sequence as a `NetworkProcess`.

    Modes:
    - ``exact`` — bit-for-bit: position i replays the capture's request
      i (t_input *and* regime id, so `per_regime` attainment composes);
      asking for more requests than the capture holds fails fast.
    - ``loop`` — cycle the capture (the `TraceReplayProcess` behaviour,
      but over measured samples, jitter-free).
    - ``bootstrap`` — block bootstrap: concatenate random blocks of
      `block` consecutive captured requests, preserving the local
      autocorrelation (regime dwells) stationary resampling would lose.
    - ``timewarp:<factor>`` — stretch (>1) or compress (<1) dwell
      times: replay position i reads capture position ``i/factor``,
      cycling — the same dynamics, slower or faster.
    """

    def __init__(self, trace: Union[Trace, Sequence[float], np.ndarray],
                 *, mode: str = "exact", block: int = 64,
                 name: Optional[str] = None,
                 regimes: Optional[np.ndarray] = None,
                 regime_names: Optional[Sequence[str]] = None):
        head, _, arg = str(mode).partition(":")
        if head not in CAPTURE_MODES:
            raise ValueError(f"unknown capture replay mode {mode!r}; "
                             f"known: {', '.join(CAPTURE_MODES)} "
                             f"(timewarp takes ':<factor>')")
        if head == "timewarp":
            self.factor = float(arg) if arg else 1.0
            if self.factor <= 0:
                raise ValueError(f"timewarp factor must be positive, "
                                 f"got {self.factor}")
        elif arg:
            raise ValueError(f"mode {head!r} takes no ':{arg}' argument "
                             f"(only timewarp:<factor> does)")
        if isinstance(trace, Trace):
            if regimes is not None or regime_names is not None:
                raise ValueError("a Trace carries its own regimes; "
                                 "pass regimes only with a raw array")
            self._t = trace.t_input_ms.copy()
            self._regimes = trace.regime_id.copy()
            self._names = list(trace.regime_names)
            default_name = f"capture:{trace.name}"
        else:
            self._t = np.asarray(trace, np.float64)
            if self._t.ndim != 1 or len(self._t) == 0:
                raise ValueError("trace must be a non-empty 1-D array")
            if not np.isfinite(self._t).all() or (self._t <= 0).any():
                raise ValueError("trace t_input values must be positive "
                                 "and finite")
            if regimes is None:
                self._regimes = np.zeros(len(self._t), np.int64)
                self._names = (list(regime_names) if regime_names
                               else ["capture"])
            else:
                self._regimes = np.asarray(regimes, np.int64)
                if len(self._regimes) != len(self._t):
                    raise ValueError("regimes must align with the trace")
                if (self._regimes < 0).any():
                    raise ValueError("regime ids must be non-negative")
                n_reg = int(self._regimes.max()) + 1
                self._names = (list(regime_names) if regime_names
                               else [f"capture:{k}" for k in range(n_reg)])
                if len(self._names) < n_reg:
                    raise ValueError("regime_names must cover every "
                                     "regime id")
            default_name = "capture"
        self.mode = head
        self.block = int(block)
        if self.block < 1:
            raise ValueError(f"block must be >= 1, got {block}")
        self.name = name or default_name

    def __len__(self) -> int:
        return len(self._t)

    def sample_trace(self, rng: np.random.Generator, n: int = 1):
        # Skip the base-class MIN_T_INPUT_MS clamp: captured values are
        # validated positive at construction, and clamping would
        # silently rewrite sub-1ms measurements — breaking the
        # bit-for-bit exact-replay contract.
        return self._raw_trace(rng, int(n))

    @property
    def mean(self) -> float:
        return float(self._t.mean())

    def regime_names(self) -> List[str]:
        return list(self._names)

    def _positions(self, rng: np.random.Generator, n: int) -> np.ndarray:
        L = len(self._t)
        if self.mode == "exact":
            if n > L:
                raise ValueError(
                    f"exact replay of {self.name!r} holds {L} requests "
                    f"but {n} were asked; use mode='loop' or "
                    f"'bootstrap' to extend it")
            return np.arange(n)
        if self.mode == "loop":
            return np.arange(n) % L
        if self.mode == "timewarp":
            return (np.arange(n) / self.factor).astype(np.int64) % L
        # bootstrap: random block starts, wrapped, until n covered.
        b = min(self.block, L)
        starts = rng.integers(0, L, size=n // b + 1)
        pos = (starts[:, None] + np.arange(b)[None, :]).ravel() % L
        return pos[:n]

    def _raw_trace(self, rng, n):
        pos = self._positions(rng, n)
        return self._t[pos].copy(), self._regimes[pos].copy()


def load_capture(name_or_path: Union[str, os.PathLike]) -> Trace:
    """Load a capture: a registered `CAPTURE_SCENARIOS` name or a
    direct ``.jsonl``/``.npz`` path."""
    from repro_torch.configs.paper_zoo import capture_path
    p = os.fspath(name_or_path)
    if not (p.endswith(".jsonl") or p.endswith(".npz")):
        p = capture_path(p)
    return Trace.load(p)


def requests_from_trace(trace: Trace, *, prompt_len: int = 8,
                        max_new_tokens: int = 4, sla_ms: float = 0.0,
                        vocab: int = 50, seed: int = 0) -> List:
    """Materialize a capture as `serving.batching.Request`s (synthetic
    prompts; arrival/device/t_input from the capture) so recorded
    workloads replay through the *real* stacks (`ServingLoop.run`,
    `CNNSelectServer.handle`) too, not just the simulator."""
    from repro_torch.serving.batching import Request
    rng = np.random.default_rng(seed)
    return [Request(
        arrival=float(trace.t_arrival[i]), rid=i,
        prompt=rng.integers(0, vocab, prompt_len).astype(np.int32),
        max_new_tokens=max_new_tokens, sla_ms=sla_ms,
        t_input_ms=float(trace.t_input_ms[i]),
        device_id=str(trace.device_id[i]) or None)
        for i in range(len(trace))]
