"""Vectorized simulation engine: the whole control plane as one column
program over float64 per-device state on the card (DESIGN.md §13).

The python engine replays the control plane per request — estimator
banks as dicts of objects, detectors as scalar accumulators, a python
loop over the trace. That is faithful but O(N) python-interpreter work;
at a million devices x ten million requests it is hours. This module
re-expresses the *same* math as a fixed-size array program:

**Column layout.** Requests are packed into an ``(L, D)`` matrix — one
column per device, row ``k`` holding each device's k-th request
(``L = max requests per device``; absent cells masked by ``valid``).
A loop over the L rows carries ``(D,)`` float64 state tensors
(estimator state, change-point statistics, controller mode / cooldown /
reference level) updated **elementwise** under the row's valid mask:
each row is a few dozen ``(D,)`` tensor ops on the program's device.
No per-device gather/scatter across rows ever happens; the program is
O(L*D) = O(N) with pure vector ops. Per-device state evolution is
independent across devices, so row-major processing is equivalent to
arrival order; event records carry the original request index and are
re-sorted afterwards. The ``(L, D)`` outputs are allocated once on the
device, written a row a step, and copied to the host once.

**Exactness.** Every update mirrors the python classes op-for-op in
float64 (EWMA recurrence, numpy-interpolation percentile over a ring
buffer, CUSUM / Page-Hinkley with the shared self-normalizing scale,
the controller's cooldown/re-anchor walk), so selections, modes, and
switch events reproduce the python engine exactly; budget estimates
agree to the ULP-level tolerance the estimator-series tests already
grant the blocked closed forms. Eager torch rounds every op on its own,
so no product is contracted into a sum (no `torch.compile`, and no
fused op such as ``addcmul`` or ``lerp``); divisions by a constant
divide by a device tensor, since CUDA torch turns a division by a
Python number into a product with its reciprocal. Selection, hedging
masks, fallback draws, and the RNG consumption order are *shared* with
the python engine (`ControlPlane.finish_static` / `finish_adaptive`),
not re-implemented. The open-loop queue recurrence runs as the CUDA
kernel `kernels.queue_scan`.

**Device.** The program runs on the card (``resolve_device("cuda")``,
which raises without one) unless the caller runs it inside
``with scan_device("cpu"):``. The identity-estimator closed-loop path
runs no program and stays on the host.

**Shards.** All ops are elementwise across the device axis, so the
fleet splits trivially: `shards=S` pads D to a multiple of S and runs
the program as S column blocks whose outputs are concatenated — bitwise
identical to the unsharded run. With one card the blocks run one after
another on it; placing them on S cards waits for the port's
`torch.distributed` paths.
"""

from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.kernels.queue_scan import queue_scan
from repro_torch.serving.control import (CusumDetector, PageHinkleyDetector)
from repro_torch.serving.fleet import EstimatorBank
from repro_torch.serving.network import (EWMAEstimator, MeanEstimator,
                                         ObservedEstimator,
                                         PercentileEstimator)
from repro_torch.utils import resolve_device

F64 = torch.float64
_DEFAULT_PARAM = {"ewma": 0.2, "pctl": 90.0}


class BankDesc(NamedTuple):
    """Static description of one estimator bank — everything the array
    program needs, hashable for the compile cache."""

    kind: str                # observed | mean | ewma | pctl
    param: float             # ewma alpha / pctl q (0.0 otherwise)
    window: int              # pctl ring size (0 otherwise)
    lag: int
    prior_override: Optional[float] = None   # instance-level prior


class CtrlDesc(NamedTuple):
    """Static description of an `AdaptiveController` for the array
    program: monitor bank, detector parameters, mode-walk constants."""

    monitor: BankDesc
    det_kind: str            # cusum | ph
    threshold: float
    drift: float             # cusum drift / ph delta
    fixed_scale: Optional[float]
    scale_beta: float
    min_scale: float
    n_modes: int
    start: int
    cooldown: int
    scale_frac: float
    table: tuple             # per-mode-spec BankDescs (None = identity)


# --------------------------------------------------------------------------
# Descriptor extraction (python objects -> static descs)
# --------------------------------------------------------------------------

def _desc_from_spec(spec: str, lag: int) -> BankDesc:
    head, _, arg = spec.partition(":")
    param = float(arg) if arg else _DEFAULT_PARAM.get(head, 0.0)
    window = 64 if head == "pctl" else 0
    return BankDesc(head, param, window, int(lag))


def _desc_from_instance(est, lag: int) -> BankDesc:
    """Translate a prebuilt estimator instance. Only cold instances
    translate — a warm one carries python-side state the array program
    does not ingest."""
    if type(est) is ObservedEstimator:
        kind, param, window, cold = "observed", 0.0, 0, True
    elif type(est) is MeanEstimator:
        kind, param, window, cold = "mean", 0.0, 0, True
    elif type(est) is EWMAEstimator:
        kind, param, window = "ewma", est.alpha, 0
        cold = est._est is None
    elif type(est) is PercentileEstimator:
        kind, param, window = "pctl", est.q, est.window
        cold = not est._buf
    else:
        raise ValueError(
            f"engine='scan' cannot translate a custom estimator "
            f"({type(est).__name__}); use a registry spec string or "
            f"engine='python'")
    if not cold:
        raise ValueError(
            f"engine='scan' needs a cold estimator instance; this "
            f"{kind} estimator already holds observations")
    prior = None if est.prior is None else float(est.prior)
    return BankDesc(kind, param, window, int(lag), prior_override=prior)


def _static_desc(plane) -> Optional[BankDesc]:
    """The static path's budget estimator as a BankDesc (None =
    identity: budget from the observed upload time)."""
    est = plane.router.t_estimator
    if est is None:
        return None
    if isinstance(est, EstimatorBank):
        if isinstance(est.spec, str):
            return _desc_from_spec(est.spec, est.lag)
        return _desc_from_instance(est.spec, est.lag)
    return _desc_from_instance(est, 0)


def ctrl_desc_from_controller(ctrl, *, lag: int = 0,
                              table_specs=None) -> CtrlDesc:
    """Translate an `AdaptiveController` into the column program's
    `CtrlDesc`. Shared with the cluster engine
    (serving/cluster_engine.py), which runs the same controller kernel
    without a `ControlPlane` around it: the cluster only consumes the
    mode / switch-event outputs, so it passes ``table_specs=(None,)``
    to keep the per-mode estimator lanes trivial."""
    det = ctrl._detector_template
    if type(det) is CusumDetector:
        kind, drift = "cusum", det.drift
    elif type(det) is PageHinkleyDetector:
        kind, drift = "ph", det.delta
    else:
        raise ValueError(
            f"engine='scan' cannot translate a custom detector "
            f"({type(det).__name__}); use 'cusum'/'ph' or "
            f"engine='python'")
    if det.statistic != 0.0:
        raise ValueError("engine='scan' needs a pristine detector "
                         "template (statistic != 0)")
    specs = (tuple(table_specs) if table_specs is not None else
             tuple(dict.fromkeys(m.t_estimator for m in ctrl.modes)))
    table = tuple(
        None if spec is None else _desc_from_spec(spec, lag)
        for spec in specs)
    return CtrlDesc(
        monitor=_desc_from_spec(ctrl.monitor, 0), det_kind=kind,
        threshold=det.threshold, drift=drift,
        fixed_scale=det.fixed_scale, scale_beta=det.scale_beta,
        min_scale=det.min_scale, n_modes=len(ctrl.modes),
        start=ctrl.start, cooldown=ctrl.cooldown,
        scale_frac=ctrl.scale_frac, table=table)


def _ctrl_desc(plane) -> CtrlDesc:
    return ctrl_desc_from_controller(plane.controller, lag=plane.lag)


# --------------------------------------------------------------------------
# Column packing: (N,) request stream -> (L, D) per-device columns
# --------------------------------------------------------------------------

class _Packed(NamedTuple):
    t_mat: np.ndarray        # (L, D) f64, 0 in absent cells
    valid: np.ndarray        # (L, D) bool
    order: np.ndarray        # (N,) request indices in (device, k) order
    k_s: np.ndarray          # (N,) row of request order[j]
    dev_s: np.ndarray        # (N,) column of request order[j]
    r_idx: np.ndarray        # (L, D) original request index (-1 absent)


def _pack_columns(t: np.ndarray, dev: np.ndarray, D: int) -> _Packed:
    n = len(t)
    counts = np.bincount(dev, minlength=D)
    L = int(counts.max()) if n else 0
    order = np.argsort(dev, kind="stable")    # device-major, arrival-
    dev_s = dev[order]                        # ordered within device
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    k_s = np.arange(n) - starts[dev_s]
    t_mat = np.zeros((L, D))
    valid = np.zeros((L, D), bool)
    r_idx = np.full((L, D), -1, np.int64)
    t_mat[k_s, dev_s] = t[order]
    valid[k_s, dev_s] = True
    r_idx[k_s, dev_s] = order
    return _Packed(t_mat, valid, order, k_s, dev_s, r_idx)


def _unpack(p: _Packed, mat, dtype=np.float64) -> np.ndarray:
    out = np.empty(len(p.order), dtype)
    out[p.order] = np.asarray(mat)[p.k_s, p.dev_s]
    return out


def _unfused(prod, xp=None):
    """A product that feeds a sum, rounded on its own. The reference
    guards such products against XLA's fused multiply-add; eager torch
    rounds every op on its own, so here it is the product itself. (The
    cluster engine imports it as the reference does; its CUDA kernel
    rounds those products with __dmul_rn.)"""
    return prod



# --------------------------------------------------------------------------
# The array program's percentile depth
# --------------------------------------------------------------------------

def _topm_size(q: float, n_rows: int, cap: int = 8):
    """How deep below the maximum a q-th percentile read can reach when
    at most `n_rows` values are ever seen: ranks lo/hi stay within the
    top `(n_rows-1) - floor(q/100*(n_rows-1)) + 1` order statistics.
    Returns that depth when it is small enough to keep as explicit
    (D,)-vector state, else None."""
    if q < 50.0:
        return None
    m = (n_rows - 1) - math.floor((q / 100.0) * (n_rows - 1)) + 1
    return m if m <= cap else None



# --------------------------------------------------------------------------
# The device
# --------------------------------------------------------------------------

_DEVICE: contextvars.ContextVar = contextvars.ContextVar(
    "scan_device", default=None)


@contextlib.contextmanager
def scan_device(device):
    """Run the scan engine's programs (the column program and the
    open-loop queue recurrence) on `device` inside the block; outside
    any block they run on the card."""
    token = _DEVICE.set(torch.device(device))
    try:
        yield
    finally:
        _DEVICE.reset(token)


def _device() -> torch.device:
    dev = _DEVICE.get()
    return resolve_device("cuda") if dev is None else resolve_device(dev)


# --------------------------------------------------------------------------
# The column program, one (D,) row at a time
# --------------------------------------------------------------------------

def _core_init(desc: BankDesc, D: int, dev, n_rows=None):
    if desc.kind == "ewma":
        return {"est": torch.zeros(D, dtype=F64, device=dev),
                "seen": torch.zeros(D, dtype=torch.bool, device=dev)}
    if desc.kind == "pctl":
        # Three layouts, chosen from the row count (n_rows = L):
        #  - `top`: at most `n_rows` <= window values ever arrive AND
        #    the percentile only reads the top few order statistics —
        #    keep just those, maintained by an O(m) min/max chain of
        #    (D,) ops.
        #  - `sbuf` alone: ring never rolls (n_rows <= window) — the
        #    sorted multiset, pure insertion, no eviction bookkeeping.
        #  - `sbuf` + `buf`: general rolling window; `buf` keeps
        #    insertion order so the evicted value can be found.
        # +inf padding sorts last, so the first `cnt` entries are real.
        # Counters are int64 (the gathers' index type); "j" is the slot
        # index row of the sorted layouts, made once.
        cnt = torch.zeros(D, dtype=torch.int64, device=dev)
        if n_rows is not None and n_rows <= desc.window:
            m = _topm_size(desc.param, n_rows)
            if m is not None:
                return {"top": torch.full((D, m), -math.inf, dtype=F64,
                                          device=dev), "cnt": cnt}
            return {"sbuf": torch.full((D, desc.window), math.inf,
                                       dtype=F64, device=dev), "cnt": cnt,
                    "j": torch.arange(desc.window, device=dev)[None, :]}
        return {"buf": torch.full((D, desc.window), math.inf, dtype=F64,
                                  device=dev),
                "sbuf": torch.full((D, desc.window), math.inf, dtype=F64,
                                   device=dev),
                "cnt": cnt,
                "j": torch.arange(desc.window, device=dev)[None, :]}
    return {}                                 # observed / mean: stateless


def _layout(st) -> Optional[str]:
    """The percentile layout a bank state holds (None: no ring)."""
    return ("top" if "top" in st else "buf" if "buf" in st
            else "sbuf" if "sbuf" in st else None)


def _take(mat, idx):
    """mat[d, idx[d]] for each row d (idx int64)."""
    return torch.gather(mat, 1, idx[:, None])[:, 0]


def _core_estimate(desc: BankDesc, st, priors, x):
    """The warm-state estimate with the cold-start chain
    state -> prior -> observation (`x=None` drops the last link — the
    lag>0 view, where the current upload has not arrived)."""
    fallback = priors if x is None else torch.where(
        torch.isnan(priors), x, priors)
    if desc.kind == "observed":
        return fallback if x is None else x
    if desc.kind == "mean":
        return priors
    if desc.kind == "ewma":
        return torch.where(st["seen"], st["est"], fallback)
    # pctl: numpy-interpolation percentile read off the incrementally
    # maintained sorted state (no per-row sort).
    cnt = torch.clamp(st["cnt"], max=desc.window)
    c = cnt.to(F64)
    v = (desc.param / 100.0) * (c - 1.0)
    lo = torch.clamp(torch.floor(v), min=0.0).long()
    hi = torch.clamp(torch.ceil(v), min=0.0).long()
    g = v - torch.floor(v)
    if "top" in st:
        # `top` is sorted descending: ascending rank k reads top[c-1-k].
        ci = cnt - 1
        a = _take(st["top"], torch.clamp(ci - lo, min=0))
        b = _take(st["top"], torch.clamp(ci - hi, min=0))
    else:
        a = _take(st["sbuf"], lo)
        b = _take(st["sbuf"], hi)
    warm = torch.where(g >= 0.5, b - (b - a) * (1.0 - g),
                       a + (b - a) * g)
    return torch.where(st["cnt"] > 0, warm, fallback)


def _core_observe(desc: BankDesc, st, x, mask):
    if desc.kind == "ewma":
        upd = torch.where(
            st["seen"],
            (1.0 - desc.param) * st["est"] + desc.param * x,
            x)
        return {"est": torch.where(mask, upd, st["est"]),
                "seen": st["seen"] | mask}
    if desc.kind == "pctl":
        if "top" in st:
            # Bubble x down the descending top-m chain: 2m (D,) ops.
            cur = x
            cols = []
            for t in range(st["top"].shape[1]):
                col = st["top"][:, t]
                cols.append(torch.maximum(col, cur))
                cur = torch.minimum(col, cur)
            new_top = torch.stack(cols, dim=1)
            return {"top": torch.where(mask[:, None], new_top, st["top"]),
                    "cnt": st["cnt"] + mask}
        W, j = desc.window, st["j"]
        s = st["sbuf"]
        i = (s < x[:, None]).sum(dim=1)[:, None]
        left = torch.cat([s[:, :1], s[:, :-1]], dim=1)
        if "buf" not in st:
            # Insert-only layout (ring never rolls): shift [i, W) right
            # by one and drop x in at its rank — the slot falling off
            # the end is still the +inf pad.
            new_s = torch.where(j == i, x[:, None],
                                torch.where(j > i, left, s))
            return {"sbuf": torch.where(mask[:, None], new_s, s),
                    "cnt": st["cnt"] + mask, "j": j}
        pos = st["cnt"] % W
        old = _take(st["buf"], pos)
        hit = (j == pos[:, None]) & mask[:, None]
        # Sorted-buffer maintenance: drop the first occurrence of the
        # evicted value (index r — unfilled lanes evict the +inf pad),
        # insert x at its rank (i2, post-removal).  Every slot moves by
        # at most one position, so the update is selects over the two
        # shifted views — elementwise rank arithmetic, no comparator
        # sort and no gather. argmax takes the first of equal maxima
        # (on an integer tensor: not every backend takes bool).
        r = torch.argmax((s == old[:, None]).to(torch.int32),
                         dim=1)[:, None]
        i2 = i - (r < i).long()
        right = torch.cat([s[:, 1:], s[:, -1:]], dim=1)
        new_s = torch.where(
            j == i2, x[:, None],
            torch.where((r <= j) & (j < i2), right,
                        torch.where((i2 < j) & (j <= r), left, s)))
        return {"buf": torch.where(hit, x[:, None], st["buf"]),
                "sbuf": torch.where(mask[:, None], new_s, s),
                "cnt": st["cnt"] + mask, "j": j}
    return st


def _bank_init(desc: BankDesc, D: int, dev, n_rows=None):
    st = {"core": _core_init(desc, D, dev, n_rows)}
    if desc.lag > 0:
        st["pend"] = torch.zeros((D, desc.lag), dtype=F64, device=dev)
        st["pcnt"] = torch.zeros(D, dtype=torch.int64, device=dev)
        st["slots"] = torch.arange(desc.lag, device=dev)[None, :]
    return st


def _bank_step(desc: BankDesc, st, x, valid, priors):
    """One request row through one bank: estimate (before this row's
    observation lands), then observe — through the lag ring when the
    bank serves a stale view."""
    if desc.lag == 0:
        est = _core_estimate(desc, st["core"], priors, x)
        return est, {"core": _core_observe(desc, st["core"], x, valid)}
    est = _core_estimate(desc, st["core"], priors, None)
    slot = st["pcnt"] % desc.lag
    old = _take(st["pend"], slot)
    feed = valid & (st["pcnt"] >= desc.lag)
    core = _core_observe(desc, st["core"], old, feed)
    hit = (st["slots"] == slot[:, None]) & valid[:, None]
    return est, {"core": core,
                 "pend": torch.where(hit, x[:, None], st["pend"]),
                 "pcnt": st["pcnt"] + valid, "slots": st["slots"]}


def _det_init(c: CtrlDesc, D: int, priors):
    zeros = lambda: torch.zeros(D, dtype=F64, device=priors.device)
    st = {}
    if c.det_kind == "cusum":
        st["pos"] = zeros()
        st["neg"] = zeros()
    else:
        st["up"] = zeros()
        st["up_min"] = zeros()
        st["dn"] = zeros()
        st["dn_max"] = zeros()
    if c.fixed_scale is not None:
        # A device tensor divisor: a true division, not a product with
        # the reciprocal (see the module docstring).
        st["fixed_scale"] = torch.tensor(c.fixed_scale, dtype=F64,
                                         device=priors.device)
    else:
        pre = c.scale_frac * torch.abs(priors)
        st["sset"] = pre > 0
        st["scale"] = torch.where(pre > 0,
                                  torch.clamp(pre, min=c.min_scale), 0.0)
    return st


def _det_step(c: CtrlDesc, st, r, s_obs, valid):
    """Standardize the residual, advance the two-sided statistic,
    return the (D,) alarm in {-1, 0, +1}. The statistic resets where it
    fires regardless of the controller's cooldown — exactly the python
    detectors, whose `update` self-resets."""
    st = dict(st)
    if c.fixed_scale is not None:
        z = r / st["fixed_scale"]
    else:
        cur = torch.where(st["sset"], st["scale"],
                          torch.clamp(s_obs, min=c.min_scale))
        z = r / cur
        new = torch.clamp(
            (1.0 - c.scale_beta) * cur + c.scale_beta * s_obs,
            min=c.min_scale)
        st["scale"] = torch.where(valid, new, st["scale"])
        st["sset"] = st["sset"] | valid
    if c.det_kind == "cusum":
        pos = torch.clamp(st["pos"] + z - c.drift, min=0.0)
        neg = torch.clamp(st["neg"] - z - c.drift, min=0.0)
        alarm = torch.where(pos > c.threshold, 1,
                            torch.where(neg > c.threshold, -1, 0))
        fired = valid & (alarm != 0)
        st["pos"] = torch.where(valid, torch.where(fired, 0.0, pos),
                                st["pos"])
        st["neg"] = torch.where(valid, torch.where(fired, 0.0, neg),
                                st["neg"])
    else:
        up = st["up"] + z - c.drift
        up_min = torch.minimum(st["up_min"], up)
        dn = st["dn"] + z + c.drift
        dn_max = torch.maximum(st["dn_max"], dn)
        alarm = torch.where(up - up_min > c.threshold, 1,
                            torch.where(dn_max - dn > c.threshold, -1, 0))
        fired = valid & (alarm != 0)
        for k, v in (("up", up), ("up_min", up_min), ("dn", dn),
                     ("dn_max", dn_max)):
            st[k] = torch.where(valid, torch.where(fired, 0.0, v), st[k])
    return torch.where(valid, alarm, 0), st


def _program(static_desc, ctrl_desc, t_mat, valid, priors):
    """The column program on (L, D) tensors `t_mat` (float64) and
    `valid` (bool) and (D,) float64 `priors`, all on one device: a loop
    over the L rows, each a step of (D,) tensor ops. Returns the
    reference program's outputs as (L, D) tensors on that device: "est"
    (static estimator), or the controller's "switched", "ev_from",
    "ev_to", "ev_alarm", "ev_ref", "ev_level", "mode" and "est{i}" (one
    a mode-table spec), each allocated once and written a row a step."""
    L, D = t_mat.shape
    dev = t_mat.device
    empty = lambda dtype: torch.empty((L, D), dtype=dtype, device=dev)
    if ctrl_desc is None:
        st = _bank_init(static_desc, D, dev, L)
        out = {"est": empty(F64)}
        for k in range(L):
            out["est"][k], st = _bank_step(static_desc, st, t_mat[k],
                                           valid[k], priors)
        return out

    c = ctrl_desc
    mon = _bank_init(c.monitor, D, dev, L)
    det = _det_init(c, D, priors)
    mode = torch.full((D,), c.start, dtype=torch.int64, device=dev)
    cool = torch.zeros(D, dtype=torch.int64, device=dev)
    ref = priors.clone()
    banks = [None if d is None else _bank_init(d, D, dev, L)
             for d in c.table]
    # int8 event outputs: mode indices and the alarm sign fit, and the
    # (L, D) outputs are copy-bound at scale.
    out = {"switched": empty(torch.bool), "ev_from": empty(torch.int8),
           "ev_to": empty(torch.int8), "ev_alarm": empty(torch.int8),
           "ev_ref": empty(F64), "ev_level": empty(F64),
           "mode": empty(torch.int8),
           **{f"est{i}": empty(F64) for i in range(len(c.table))}}
    for k in range(L):
        x, v = t_mat[k], valid[k]
        # Tracker: pre-observation prediction, observe, post level.
        pred, mon = _bank_step(c.monitor, mon, x, v, priors)
        post = _core_estimate(c.monitor, mon["core"], priors, x)
        # Detect on (obs - reference); learn scale from the tracker
        # residual (process noise, not the offset being detected).
        alarm, det = _det_step(c, det, x - ref, torch.abs(x - pred), v)
        in_cool = cool > 0
        cool = torch.where(v & in_cool, cool - 1, cool)
        eff = torch.where(v & ~in_cool, alarm, 0)
        new_mode = torch.clamp(mode + torch.sign(eff), 0, c.n_modes - 1)
        switched = (eff != 0) & (new_mode != mode)
        down_bottom = (eff < 0) & ~switched
        out["switched"][k] = switched
        out["ev_from"][k] = mode
        out["ev_to"][k] = new_mode
        out["ev_alarm"][k] = eff
        out["ev_ref"][k] = ref
        out["ev_level"][k] = post
        mode = torch.where(switched, new_mode, mode)
        out["mode"][k] = mode
        for i, d in enumerate(c.table):
            if d is None:
                out[f"est{i}"][k] = x
            else:
                out[f"est{i}"][k], banks[i] = _bank_step(
                    d, banks[i], x, v, priors)
        cool = torch.where(switched, c.cooldown, cool)
        ref = torch.where(switched | down_bottom, post, ref)
    return out


def _run_program(static_desc, ctrl_desc, packed: _Packed,
                 priors_vec: np.ndarray, shards: int):
    """Pad to the shard grid, run the program on the scan device as
    `shards` column blocks (one after another), strip the padding, and
    hand back numpy arrays."""
    t_mat, valid = packed.t_mat, packed.valid
    D = t_mat.shape[1]
    pad = (-D) % shards
    if pad:
        t_mat = np.pad(t_mat, ((0, 0), (0, pad)))
        valid = np.pad(valid, ((0, 0), (0, pad)))
        priors_vec = np.pad(priors_vec, (0, pad), constant_values=1.0)
    for desc in ([static_desc] if ctrl_desc is None else
                 [ctrl_desc.monitor, *ctrl_desc.table]):
        if desc is not None and desc.kind == "mean" and np.isnan(
                priors_vec).any():
            raise ValueError("mean estimator needs a prior")
    dev = _device()
    t_dev = torch.from_numpy(np.ascontiguousarray(t_mat, np.float64)).to(dev)
    v_dev = torch.from_numpy(np.ascontiguousarray(valid, bool)).to(dev)
    p_dev = torch.from_numpy(np.ascontiguousarray(priors_vec,
                                                  np.float64)).to(dev)
    width = (D + pad) // shards
    blocks = [_program(static_desc, ctrl_desc,
                       t_dev[:, s * width:(s + 1) * width],
                       v_dev[:, s * width:(s + 1) * width],
                       p_dev[s * width:(s + 1) * width])
              for s in range(shards)]
    return {k: torch.cat([b[k] for b in blocks], dim=1)[:, :D].cpu().numpy()
            for k in blocks[0]}


# --------------------------------------------------------------------------
# Engine entry points (called from simulate())
# --------------------------------------------------------------------------

def _assemble_events(out, packed: _Packed, mode_names: List[str],
                     device_names, dev) -> List[dict]:
    """The (L, D) switch masks back into the python engine's
    chronological event-dict list."""
    ks, ds = np.nonzero(out["switched"] & packed.valid)
    if not len(ks):
        return []
    req = packed.r_idx[ks, ds]
    o = np.argsort(req, kind="stable")
    ks, ds, req = ks[o], ds[o], req[o]
    events = []
    for k, d, r in zip(ks, ds, req):
        if dev is None:
            name = ""
        elif device_names is not None:
            name = str(device_names[d])
        else:
            name = str(d)
        events.append({
            "request": int(r), "device": name,
            "from": mode_names[int(out["ev_from"][k, d])],
            "to": mode_names[int(out["ev_to"][k, d])],
            "alarm": int(out["ev_alarm"][k, d]),
            "ref": float(out["ev_ref"][k, d]),
            "level": float(out["ev_level"][k, d])})
    return events


def scan_plan_batch(plane, rng: np.random.Generator, t_sla: float,
                    t_inputs: np.ndarray, *,
                    device_index: Optional[np.ndarray] = None,
                    prior_vec: Optional[np.ndarray] = None,
                    device_names=None, estimator_scope: str = "device",
                    realized: Optional[np.ndarray] = None,
                    prior_mean: Optional[np.ndarray] = None,
                    on_device=None, shards: int = 1):
    """`ControlPlane.plan_batch`, scan-engine edition: budget
    estimation and the adaptive controller run as the (L, D) array
    program; selection, hedging gates, fallback masks, and the RNG
    draws then go through the *shared* `finish_static` /
    `finish_adaptive` — op-for-op and draw-for-draw the python path.

    `device_index` / `prior_vec` are the fleet's integer device axis
    and per-device long-run means; None collapses to one shared column
    (no fleet, or ``estimator_scope="global"``)."""
    t_inputs = np.asarray(t_inputs, np.float64)
    n = len(t_inputs)
    dev = device_index if estimator_scope == "device" else None
    if dev is None:
        D = 1
        dev_cols = np.zeros(n, np.int64)
        priors_vec = np.array([np.nan if plane.default_prior is None
                               else float(plane.default_prior)])
    else:
        dev_cols = np.asarray(dev, np.int64)
        priors_vec = np.asarray(prior_vec, np.float64)
        D = len(priors_vec)

    if plane.controller is None:
        desc = _static_desc(plane)
        if desc is None:                      # identity: budget = obs
            t_est = t_inputs.copy()
        else:
            if desc.prior_override is not None:
                priors_vec = np.full(D, desc.prior_override)
            packed = _pack_columns(t_inputs, dev_cols, D)
            out = _run_program(desc, None, packed, priors_vec, shards)
            t_est = _unpack(packed, out["est"])
        return plane.finish_static(rng, t_sla, t_est, realized,
                                   prior_mean, on_device, n)

    cdesc = _ctrl_desc(plane)
    if dev is not None and np.isnan(priors_vec).any():
        raise ValueError("engine='scan' adaptive control needs a prior "
                         "for every device")
    packed = _pack_columns(t_inputs, dev_cols, D)
    out = _run_program(None, cdesc, packed, priors_vec, shards)
    modes_idx = _unpack(packed, out["mode"], np.int64)
    spec_order = list(dict.fromkeys(
        m.t_estimator for m in plane.controller.modes))
    series = {spec: _unpack(packed, out[f"est{i}"])
              for i, spec in enumerate(spec_order)}
    t_est = plane.compose_adaptive_estimates(series, modes_idx, n)
    events = _assemble_events(out, packed,
                              plane.controller.mode_names(),
                              device_names, dev)
    return plane.finish_adaptive(rng, t_sla, t_est, modes_idx, events,
                                 realized, prior_mean, on_device, n)



def scan_event_phase(cfg, plan, t_inputs, arrivals, exec_samples,
                     profiles, zoo, rng):
    """The request event loop, vectorized: cold starts charged at each
    model's first (non-fallback) use in request order — the same
    `zoo.ensure_hot` calls, in the same order, drawing from the same
    rng as the python loop — then closed-loop latencies as one numpy
    expression or open-loop queueing as the `queue_scan` kernel over the
    arrival sequence on the scan device. Returns
    ``(lat, sel, hedges, fallbacks)``."""
    n = len(t_inputs)
    sel = plan.sel
    fb = (plan.fb_mask if plan.fb_mask is not None
          else np.zeros(n, bool))
    fallbacks = int(fb.sum())
    startup = np.zeros(n)
    live = np.flatnonzero(~fb)
    if live.size:
        # First use per model, in request order (= python's rng order).
        _, first = np.unique(sel[live], return_index=True)
        firsts = np.sort(live[first])
        for i in firsts:
            startup[i] = zoo.ensure_hot(profiles[sel[i]].name,
                                        arrivals[i], rng)
    exec_t = exec_samples[np.arange(n), np.maximum(sel, 0)] + startup
    if cfg.arrival_rate_hz <= 0:
        lat = (t_inputs + exec_t) + t_inputs   # python's add order
        queue = None
    else:
        dev = _device()
        cols = [torch.from_numpy(np.ascontiguousarray(c, dtype)).to(dev)
                for c, dtype in ((arrivals + t_inputs, np.float64),
                                 (exec_t, np.float64),
                                 (plan.p95_gate, bool),
                                 (plan.outage_gate, bool), (~fb, bool))]
        queue, hedges = queue_scan(*cols, cfg.n_servers, 0.05 * cfg.t_sla)
        queue = queue.cpu().numpy()
        lat = ((t_inputs + queue) + exec_t) + t_inputs
    hedges = 0 if queue is None else int(hedges)
    if fallbacks:
        lat = np.where(fb, plan.od_latency, lat)
        sel = np.where(fb, -1, sel)
    return lat, sel, hedges, fallbacks
