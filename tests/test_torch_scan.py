"""The port's scan engine (`repro_torch/serving/scan_engine.py`) on the
CPU, under `scan_device("cpu")`, against the reference's scan engine
and against the port's python engine.

The reference's scan programs import `enable_x64` from
`jax.experimental`, which this jax moved to `jax.enable_x64`; the
`x64_shim` fixture sets that one attribute on `jax.experimental` for the
test that asks for it and takes it away after, so the reference runs
unchanged and nothing outside these tests sees the shim.

(a) the column program against the reference's own jitted program on
the same numpy inputs, every output bit for bit, in every percentile
layout; (b) `simulate(engine="scan")` against the reference's scan
engine, deterministic policies (cnnselect draws its noise from
jax.random there); (c) the port's scan against the port's python engine
on the matrix of tests/test_engine.py, cnnselect included (both engines
share `finish_static` / `finish_adaptive`); (d) shards against one block
bit for bit; (e) the queue recurrence's plain version against the python
event loop and the reference's `lax.scan`, with ties."""

import types

import jax
import jax.experimental
import numpy as np
import pytest
import torch

import repro.configs.paper_zoo as rzoo
import repro.serving.control as rcontrol
import repro.serving.scan_engine as rse
import repro.serving.simulator as rsim
import repro_torch.configs.paper_zoo as tzoo
import repro_torch.serving.control as tcontrol
import repro_torch.serving.fleet as tfleet
import repro_torch.serving.scan_engine as tse
import repro_torch.serving.simulator as tsim
from repro_torch.core.selection import policy_names
from repro_torch.kernels import ref as R
from repro_torch.kernels.queue_scan import queue_scan

N = 900
T_SLA = 350.0
DETERMINISTIC = ("greedy", "greedy_nw", "oracle", "random", "static")
FLEETS = [None, "mixed_fleet", "lte_outage_fleet"]
FLEET_IDS = ["nofleet", "mixed", "lte_outage"]


@pytest.fixture
def x64_shim(monkeypatch):
    """`from jax.experimental import enable_x64` as the reference's scan
    engine writes it, for this test only."""
    monkeypatch.setattr(jax.experimental, "enable_x64", jax.enable_x64,
                        raising=False)


@pytest.fixture(autouse=True)
def on_cpu():
    with tse.scan_device("cpu"):
        yield


# -- (a) the column program ------------------------------------------------

# Columns of the program checks. The reference's jitted Page-Hinkley
# program corrupts the heap on this jax's CPU backend at D = 9 (and runs
# at 8, 16, 24 and 200), so the checks hold D at 16.
D_PROGRAM = 16

def _inputs(L, D, seed, *, integers=False, nan_priors=False):
    """(L, D) uploads with a level shift up and back in half the
    columns (so detectors fire both ways), ragged column lengths (one
    column empty, one full), and (D,) priors."""
    rng = np.random.default_rng(seed)
    mean = rng.uniform(40.0, 200.0, D)
    t = rng.lognormal(np.log(mean), 0.3, (L, D))
    shift = np.zeros((L, D), bool)
    shift[L // 3:2 * L // 3, ::2] = True
    t = np.where(shift, 3.0 * t, t)
    if integers:                          # many equal values in a ring
        t = rng.integers(1, 6, (L, D)).astype(np.float64)
    n = rng.integers(L // 2, L + 1, D)
    n[0], n[-1] = L, 0
    valid = np.arange(L)[:, None] < n[None, :]
    t = np.where(valid, t, 0.0)
    priors = mean * rng.uniform(0.8, 1.2, D)
    if nan_priors:
        priors[1::3] = np.nan
    return t, valid, priors


def _ref_program(sdesc, cdesc, t, valid, priors):
    fn = rse._compile(sdesc, cdesc, 1)
    with jax.enable_x64(True):
        return {k: np.asarray(v) for k, v in fn(t, valid, priors).items()}


def _port_program(sdesc, cdesc, t, valid, priors):
    out = tse._program(sdesc, cdesc, torch.from_numpy(t),
                       torch.from_numpy(valid), torch.from_numpy(priors))
    return {k: v.numpy() for k, v in out.items()}


def _assert_outputs_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# (spec, lag, L, expected percentile layout)
STATIC = [
    ("observed", 0, 40, None), ("observed", 2, 40, None),
    ("mean", 0, 40, None), ("mean", 2, 40, None),
    ("ewma:0.35", 0, 40, None), ("ewma:0.35", 2, 40, None),
    ("pctl:90", 0, 12, "top"), ("pctl:90", 2, 12, "top"),
    ("pctl:50", 0, 30, "sbuf"), ("pctl:75", 2, 30, "sbuf"),
    ("pctl:90", 0, 80, "buf"), ("pctl:90", 2, 80, "buf"),
    ("pctl:25", 0, 20, "sbuf"),
]


@pytest.mark.parametrize("nan_priors", [False, True],
                         ids=["priors", "nan_priors"])
@pytest.mark.parametrize("spec, lag, L, layout", STATIC,
                         ids=[f"{s}-lag{g}-L{n}" for s, g, n, _ in STATIC])
def test_static_program_matches_reference(spec, lag, L, layout,
                                          nan_priors, x64_shim):
    t, valid, priors = _inputs(L, D_PROGRAM, seed=L + lag,
                               nan_priors=nan_priors)
    want_desc = rse._desc_from_spec(spec, lag)
    desc = tse._desc_from_spec(spec, lag)
    assert tuple(desc) == tuple(want_desc)
    core = tse._core_init(desc, 1, "cpu", L)
    assert tse._layout(core) == layout
    if spec == "mean" and nan_priors:
        packed = tse._pack_columns(t[valid], np.nonzero(valid)[1],
                                   D_PROGRAM)
        for mod in (rse, tse):
            with pytest.raises(ValueError, match="mean estimator needs"):
                mod._run_program(mod._desc_from_spec(spec, lag), None,
                                 packed, priors, 1)
        return
    _assert_outputs_equal(_port_program(desc, None, t, valid, priors),
                          _ref_program(want_desc, None, t, valid, priors))


def test_rolling_ring_evicts_first_of_equal_values(x64_shim):
    """pctl in the rolling layout over small integers: the evicted value
    has equal copies in the sorted ring, and the first is dropped (the
    argmax over an integer mask)."""
    t, valid, priors = _inputs(150, D_PROGRAM, seed=3, integers=True)
    for spec in ("pctl:90", "pctl:50"):
        rd, td = rse._desc_from_spec(spec, 0), tse._desc_from_spec(spec, 0)
        assert tse._layout(tse._core_init(td, 1, "cpu", 150)) == "buf"
        got = _port_program(td, None, t, valid, priors)
        _assert_outputs_equal(got, _ref_program(rd, None, t, valid, priors))
    s = torch.tensor([[1.0, 2.0, 2.0, 2.0, 3.0]])
    assert torch.argmax((s == 2.0).to(torch.int32), dim=1).item() == 1


def _controllers(mod, detector, monitor):
    modes = ("stationary", "cautious", "degraded")
    det = {"cusum": mod.CusumDetector(threshold=4.0, drift=0.5),
           "cusum_fixed": mod.CusumDetector(threshold=4.0, drift=0.5,
                                            scale=20.0),
           "ph": mod.PageHinkleyDetector(threshold=6.0, delta=0.25),
           "ph_fixed": mod.PageHinkleyDetector(threshold=6.0, delta=0.25,
                                               scale=20.0)}[detector]
    return mod.AdaptiveController(modes=modes, detector=det,
                                  monitor=monitor, cooldown=3, start=1)


CTRL = [("cusum", "ewma:0.2", 0, 40), ("cusum_fixed", "ewma:0.2", 2, 40),
        ("ph", "ewma:0.3", 2, 40), ("ph_fixed", "pctl:50", 0, 40),
        ("cusum", "pctl:90", 2, 80), ("ph", "observed", 0, 12)]


@pytest.mark.parametrize("nan_priors", [False, True],
                         ids=["priors", "nan_priors"])
@pytest.mark.parametrize("detector, monitor, lag, L", CTRL,
                         ids=[f"{d}-{m}-lag{g}-L{n}"
                              for d, m, g, n in CTRL])
def test_controller_program_matches_reference(detector, monitor, lag, L,
                                              nan_priors, x64_shim):
    """The controller's mode walk (cooldown, re-anchor, the int8 event
    outputs) over a mode table with an identity lane, an EWMA and a
    percentile, each through the lag ring."""
    t, valid, priors = _inputs(L, D_PROGRAM, seed=L + lag,
                               nan_priors=nan_priors)
    specs = (None, "ewma:0.3", "pctl:90")
    want_desc = rse.ctrl_desc_from_controller(
        _controllers(rcontrol, detector, monitor), lag=lag,
        table_specs=specs)
    desc = tse.ctrl_desc_from_controller(
        _controllers(tcontrol, detector, monitor), lag=lag,
        table_specs=specs)
    assert repr(desc) == repr(want_desc)
    got = _port_program(None, desc, t, valid, priors)
    _assert_outputs_equal(got, _ref_program(None, want_desc, t, valid,
                                            priors))
    if not nan_priors:
        assert got["switched"].any()       # the walk did switch


# -- (b) simulate: the port's scan against the reference's scan ---------

def assert_equivalent(a, b):
    """tests/test_engine.py's fields and tolerances."""
    assert list(a.selections) == list(b.selections)
    np.testing.assert_allclose(np.asarray(a.latencies),
                               np.asarray(b.latencies), rtol=1e-9)
    assert a.hedges == b.hedges
    assert a.fallbacks == b.fallbacks
    assert a.cold_starts == b.cold_starts
    assert a.attainment == pytest.approx(b.attainment, rel=1e-12)
    assert a.accuracy == pytest.approx(b.accuracy, rel=1e-9)
    ma = [] if a.modes is None else list(a.modes)
    mb = [] if b.modes is None else list(b.modes)
    assert ma == mb
    ea = a.switch_events or []
    eb = b.switch_events or []
    assert len(ea) == len(eb)
    for x, y in zip(ea, eb):
        for k in ("request", "device", "from", "to", "alarm"):
            assert x[k] == y[k]
        for k in ("ref", "level"):
            assert x[k] == pytest.approx(y[k], rel=1e-6)


def _run(sim, zoo, engine, **kw):
    """`simulate` at N requests, seed 5; policy "static" takes the first
    profile, as tests/test_engine.py does."""
    profiles = zoo.paper_profiles()
    if kw.get("policy") == "static":
        kw["policy"] = f"static:{profiles[0].name}"
    cfg = sim.SimConfig(t_sla=T_SLA, n_requests=N, seed=5, engine=engine,
                        **kw)
    return sim.simulate(profiles, cfg)


@pytest.mark.parametrize("plane", ["static", "controller"])
@pytest.mark.parametrize("fleet", FLEETS, ids=FLEET_IDS)
@pytest.mark.parametrize("policy", DETERMINISTIC)
def test_scan_matches_reference_scan(policy, fleet, plane, x64_shim):
    kw = dict(policy=policy, fleet=fleet,
              **({"t_estimator": "ewma:0.2"} if plane == "static"
                 else {"controller": "reactive"}))
    want = _run(rsim, rzoo, "scan", **kw)
    got = _run(tsim, tzoo, "scan", **kw)
    assert_equivalent(got, want)
    np.testing.assert_array_equal(got.latencies, want.latencies)


def test_open_loop_matches_reference_scan(x64_shim):
    """Open-loop queueing with hedges, greedy_nw (the queue recurrence
    through `queue_scan` against the reference's `lax.scan`)."""
    kw = dict(fleet="lte_outage_fleet", controller="reactive",
              policy="greedy_nw", arrival_rate_hz=500.0, n_servers=2)
    want = _run(rsim, rzoo, "scan", **kw)
    got = _run(tsim, tzoo, "scan", **kw)
    assert_equivalent(got, want)
    np.testing.assert_array_equal(got.latencies, want.latencies)
    assert got.hedges > 0


# -- (c) the port's scan against the port's python engine ---------------

def run_both(**kw):
    return (_run(tsim, tzoo, "python", **kw), _run(tsim, tzoo, "scan", **kw))


@pytest.mark.parametrize("fleet", FLEETS, ids=FLEET_IDS)
@pytest.mark.parametrize("policy", policy_names())
def test_static_plan_matches(policy, fleet):
    assert_equivalent(*run_both(policy=policy, fleet=fleet,
                                t_estimator="ewma:0.2"))


@pytest.mark.parametrize("fleet", FLEETS, ids=FLEET_IDS)
@pytest.mark.parametrize("policy", policy_names())
def test_controller_plan_matches(policy, fleet):
    assert_equivalent(*run_both(policy=policy, fleet=fleet,
                                controller="reactive"))


@pytest.mark.parametrize("spec", ["observed", "mean", "ewma:0.35",
                                  "pctl:90", "pctl:50"])
def test_estimator_kinds_match(spec):
    assert_equivalent(*run_both(fleet=tfleet.ArrayFleet(150, seed=2),
                                policy="greedy_nw", t_estimator=spec))


def test_rolling_percentile_matches():
    """No fleet: one column of N rows, more than the 64-slot window, so
    the percentile takes the rolling ring."""
    assert tse._layout(tse._core_init(tse._desc_from_spec("pctl:90", 0),
                                      1, "cpu", N)) == "buf"
    assert_equivalent(*run_both(policy="greedy_nw", t_estimator="pctl:90"))


def test_estimator_lag_and_global_scope_match():
    assert_equivalent(*run_both(fleet="lte_outage_fleet",
                                policy="cnnselect", t_estimator="pctl:75",
                                estimator_lag=2))
    assert_equivalent(*run_both(fleet="mixed_fleet", policy="greedy_nw",
                                t_estimator="ewma:0.2",
                                estimator_scope="global"))


def test_open_loop_hedging_matches():
    a, b = run_both(fleet="lte_outage_fleet", controller="reactive",
                    policy="cnnselect", arrival_rate_hz=500.0, n_servers=2)
    assert_equivalent(a, b)
    assert b.hedges > 0


def test_array_fleet_controller_matches():
    a, b = run_both(fleet=tfleet.ArrayFleet(200, seed=9),
                    controller="ph_reactive", policy="greedy_nw")
    assert_equivalent(a, b)
    assert (b.switch_events or []) != []      # regime shifts do fire


def test_scan_rejects_memory_budget():
    cfg = tsim.SimConfig(t_sla=T_SLA, n_requests=10, engine="scan",
                         memory_budget_bytes=1 << 30)
    with pytest.raises(ValueError, match="memory budget"):
        tsim.simulate(tzoo.paper_profiles(), cfg)


def test_unknown_engine_rejected():
    cfg = tsim.SimConfig(t_sla=T_SLA, n_requests=10, engine="fortran")
    with pytest.raises(ValueError, match="engine"):
        tsim.simulate(tzoo.paper_profiles(), cfg)


# -- (d) shards -------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(controller="reactive"), dict(t_estimator="pctl:90"),
    dict(t_estimator="ewma:0.2", estimator_lag=2)],
    ids=["reactive", "pctl90", "ewma-lag2"])
def test_shards_bitwise_identical(kw):
    """151 devices: neither 2 nor 3 divides D, so both pad."""
    out = {}
    for shards in (1, 2, 3):
        cfg = tsim.SimConfig(t_sla=T_SLA, n_requests=N, seed=5,
                             engine="scan",
                             fleet=tfleet.ArrayFleet(151, seed=2),
                             policy="greedy_nw", shards=shards, **kw)
        out[shards] = tsim.simulate(tzoo.paper_profiles(), cfg)
    a = out[1]
    for b in (out[2], out[3]):
        assert list(a.selections) == list(b.selections)
        np.testing.assert_array_equal(a.latencies, b.latencies)
        assert (a.modes is None) == (b.modes is None)
        if a.modes is not None:
            assert list(a.modes) == list(b.modes)
        assert (a.switch_events or []) == (b.switch_events or [])


# -- (e) the queue recurrence -----------------------------------------------

def _queue_inputs(n, seed, ties):
    rng = np.random.default_rng(seed)
    arrive = np.cumsum(rng.exponential(2.0, n))
    exec_t = rng.lognormal(2.0, 0.5, n)
    if ties:
        # Bursts at one instant and equal service times: free times tie.
        arrive = np.repeat(arrive[:n // 4], 4)[:n]
        exec_t = np.full(n, 8.0)
    return (arrive, exec_t, rng.random(n) < 0.5, rng.random(n) < 0.1,
            rng.random(n) < 0.9)


def _python_loop(arrive, exec_t, p95, outage, active, n_servers, thr):
    """The python engine's queue, as serving/simulator.py runs it."""
    server_free = np.zeros(n_servers)
    queue = np.zeros(len(arrive))
    hedges = 0
    for i in range(len(arrive)):
        if not active[i]:
            continue
        s = int(np.argmin(server_free))
        start = max(arrive[i], server_free[s])
        queue_wait = start - arrive[i]
        if n_servers > 1 and ((p95[i] and queue_wait > thr) or outage[i]):
            s2 = int(np.argsort(server_free)[1])
            start2 = max(arrive[i], server_free[s2])
            if start2 < start:
                s, start = s2, start2
            hedges += 1
        server_free[s] = start + exec_t[i]
        queue[i] = start - arrive[i]
    return queue, hedges


@pytest.mark.parametrize("ties", [False, True], ids=["random", "ties"])
@pytest.mark.parametrize("n_servers", [1, 2, 3, 9])
def test_queue_plain_matches_python_loop(n_servers, ties):
    cols = _queue_inputs(700, n_servers, ties)
    thr = 0.05 * T_SLA
    want_q, want_h = _python_loop(*cols, n_servers, thr)
    q, h = queue_scan(*(torch.from_numpy(c) for c in cols), n_servers, thr)
    np.testing.assert_array_equal(q.numpy(), want_q)
    assert int(h) == want_h
    assert queue_scan.launches == 0          # CPU tensors: the plain version
    q2, h2 = R.queue_scan_ref(*(torch.from_numpy(c) for c in cols),
                              n_servers, thr)
    assert torch.equal(q2, q) and int(h2) == want_h
    if n_servers > 1 and ties:
        assert want_h > 0 and (want_q > 0).any()


@pytest.mark.parametrize("ties", [False, True], ids=["random", "ties"])
@pytest.mark.parametrize("n_servers", [1, 2, 5])
def test_event_phase_matches_reference_lax_scan(n_servers, ties, x64_shim):
    """Both packages' `scan_event_phase` on one open-loop plan: the port's
    queue recurrence against the reference's `lax.scan`, with fallbacks
    and cold starts."""
    arrive, exec_t, p95, outage, active = _queue_inputs(600, 7, ties)
    rng = np.random.default_rng(1)
    t_inputs = (np.full(600, 20.0) if ties
                else rng.lognormal(3.0, 0.5, 600))
    K = 3
    plan = types.SimpleNamespace(
        sel=rng.integers(0, K, 600), fb_mask=~active, p95_gate=p95,
        outage_gate=outage, od_latency=rng.uniform(50.0, 90.0, 600))
    exec_samples = np.tile(exec_t[:, None], (1, K)) + np.arange(K)
    cfg = types.SimpleNamespace(arrival_rate_hz=500.0, n_servers=n_servers,
                                t_sla=T_SLA)
    outs = []
    for zoo_mod, mod in ((rzoo, rse), (tzoo, tse)):
        profiles = zoo_mod.paper_profiles()[:K]
        zoo = types.SimpleNamespace(
            ensure_hot=lambda name, now, r: float(r.uniform(1.0, 2.0)))
        outs.append(mod.scan_event_phase(
            cfg, plan, t_inputs, arrive, exec_samples, profiles, zoo,
            np.random.default_rng(4)))
    (lat_r, sel_r, h_r, fb_r), (lat_t, sel_t, h_t, fb_t) = outs
    np.testing.assert_array_equal(lat_t, lat_r)
    np.testing.assert_array_equal(sel_t, sel_r)
    assert (h_t, fb_t) == (h_r, fb_r)
    assert fb_t > 0
