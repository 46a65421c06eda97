"""The port's simulation plane against the reference on the CPU: trace
capture (`serving/trace.py`: the JSONL and npz codecs, across both
packages, and `CapturedTraceProcess`), the committed capture and what
resolves through it (`capture:` network specs, `FleetMixture.
from_capture`), `simulate` / `attainment_improvement`
(`serving/simulator.py`) and the multi-tenant `Cluster`
(`serving/cluster.py`). Deterministic policies are held bit for bit;
`cnnselect`, whose batched path draws its Gumbel noise from
`jax.random` in the reference and from a `torch.Generator` in the port,
as a distribution. Last, the sim-to-real loop of chip_smoke's sim phase
on the port's own CPU server: capture, disk, replay."""

import dataclasses
import importlib.util
import pathlib

import numpy as np
import pytest

import repro.configs.paper_zoo as rzoo
import repro.serving.cluster as rcluster
import repro.serving.fleet as rfleet
import repro.serving.network as rnetwork
import repro.serving.simulator as rsim
import repro.serving.stack as rstack
import repro.serving.trace as rtrace
import repro_torch.configs.paper_zoo as tzoo
import repro_torch.serving.cluster as tcluster
import repro_torch.serving.fleet as tfleet
import repro_torch.serving.network as tnetwork
import repro_torch.serving.simulator as tsim
import repro_torch.serving.stack as tstack
import repro_torch.serving.trace as ttrace

ROOT = pathlib.Path(__file__).resolve().parents[1]
COLUMNS = ("t_arrival", "device_id", "t_input_ms", "regime_id", "model",
           "sla_ok")
DETERMINISTIC = ("greedy", "greedy_nw", "oracle", "random",
                 "static:mobilenetv1_10")
# One of each network kind: stationary (with open-loop queueing and p95
# hedging), a regime-switching NETWORK_SCENARIOS entry, a device fleet,
# and an online controller.
SCENARIOS = {
    "stationary": dict(network="lte", arrival_rate_hz=8.0, n_servers=2,
                       hedge="p95"),
    "regimes": dict(network="lte_outages", t_estimator="ewma:0.2"),
    "fleet": dict(fleet="mixed_fleet", t_estimator="ewma:0.2",
                  hedge="outage"),
    "controller": dict(fleet="lte_outage_fleet", controller="reactive"),
}
CLUSTER_MODELS = ["mobilenetv1_025", "mobilenetv1_10", "inceptionv3"]


def random_trace(mod, n=64, seed=0):
    """A capture of `mod.Trace` from numpy seeds: awkward floats, two
    devices, three regimes, all three SLA outcomes, exec_ms in meta."""
    rng = np.random.default_rng(seed)
    t_in = rng.lognormal(3.0, 0.8, n)
    t_in[0] = 1.0 / 3.0
    t_in[1] = np.nextafter(63.0, 64.0)
    return mod.Trace(
        t_arrival=np.cumsum(rng.exponential(25.0, n)),
        device_id=rng.choice(["pixel7", "budget/a13"], n),
        t_input_ms=t_in, regime_id=rng.integers(0, 3, n),
        model=rng.choice(["mobilenetv1_10", "inceptionv3", ""], n),
        sla_ok=rng.integers(-1, 2, n).astype(np.int8),
        regime_names=["wifi", "lte", "outage"], name="rand",
        source="test",
        meta={"exec_ms": [float(v) for v in rng.gamma(4.0, 20.0, n)],
              "t_sla": 300.0})


def assert_traces_equal(a, b):
    for col in COLUMNS:
        x, y = getattr(a, col), getattr(b, col)
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), col
    assert a.header() == b.header()


# -- Trace codecs -----------------------------------------------------------

@pytest.mark.parametrize("ext", ["jsonl", "npz"])
def test_trace_roundtrip_bit_exact(tmp_path, ext):
    tr = random_trace(ttrace)
    tr.save(tmp_path / f"t.{ext}")
    assert_traces_equal(tr, ttrace.Trace.load(tmp_path / f"t.{ext}"))


@pytest.mark.parametrize("ext", ["jsonl", "npz"])
@pytest.mark.parametrize("writer,reader", [(rtrace, ttrace),
                                           (ttrace, rtrace)],
                         ids=["reference-to-port", "port-to-reference"])
def test_trace_crosses_packages(tmp_path, ext, writer, reader):
    """A capture written by one package loads in the other with equal
    columns and header; the two files are byte for byte the same."""
    paths = {}
    for mod in (writer, reader):
        paths[mod] = tmp_path / f"{mod.__name__}.{ext}"
        random_trace(mod, seed=3).save(paths[mod])
    got = reader.Trace.load(paths[writer])
    assert_traces_equal(got, random_trace(reader, seed=3))
    if ext == "jsonl":
        assert paths[writer].read_bytes() == paths[reader].read_bytes()


# -- CapturedTraceProcess ---------------------------------------------------

@pytest.mark.parametrize("mode", ["exact", "loop", "bootstrap",
                                  "timewarp:2.5", "timewarp:0.4"])
def test_captured_process_draws_as_reference(mode):
    n = 64 if mode == "exact" else 500
    out = []
    for mod in (rtrace, ttrace):
        proc = mod.CapturedTraceProcess(random_trace(mod), mode=mode)
        rng = np.random.default_rng(7)
        t, reg = proc.sample_trace(rng, n)
        out.append((t, reg, proc.sample_t_input(rng, 50 if mode != "exact"
                                                else 64),
                    rng.random(), proc.mean, proc.regime_names()))
    (t, reg, t2, u, mean, names), (pt, preg, pt2, pu, pmean, pnames) = out
    np.testing.assert_array_equal(pt, t)
    np.testing.assert_array_equal(preg, reg)
    np.testing.assert_array_equal(pt2, t2)
    assert (pu, pmean, pnames) == (u, mean, names)


# -- the committed capture --------------------------------------------------

def test_committed_capture_resolves_as_reference():
    """load_capture, `capture:` specs and FleetMixture.from_capture
    compute in the port (they raised ModuleNotFoundError before the
    trace module) and equal the reference's."""
    ref, got = (m.load_capture("reference_fleet") for m in (rtrace, ttrace))
    assert_traces_equal(got, ref)
    assert len(got) == 256 and got.meta["policy"] == "greedy_nw"
    for spec in ("capture:reference_fleet", "trace:reference_fleet"):
        draws = []
        for net in (rnetwork, tnetwork):
            proc = net.make_network(spec)
            draws.append(proc.sample_trace(np.random.default_rng(5), 700))
        for a, b in zip(*draws):
            np.testing.assert_array_equal(b, a)
    fleets = [f.FleetMixture.from_capture(t)
              for f, t in ((rfleet, ref), (tfleet, got))]
    assert fleets[1].device_ids == fleets[0].device_ids
    np.testing.assert_array_equal(fleets[1].weights, fleets[0].weights)
    assert fleets[1].regime_names() == fleets[0].regime_names()
    assert fleets[1].priors() == fleets[0].priors()
    a, b = (fl.sample_trace(np.random.default_rng(9), 900) for fl in fleets)
    for field in ("t_input", "regime", "device_index"):
        np.testing.assert_array_equal(getattr(b, field), getattr(a, field))
    # The recorded fleet replays through the simulator as the reference's.
    r, t = (s.simulate(z.paper_profiles(), s.SimConfig(
        t_sla=350.0, n_requests=900, seed=2, fleet=fl, policy="greedy_nw",
        t_estimator="ewma:0.2"))
        for s, z, fl in ((rsim, rzoo, fleets[0]), (tsim, tzoo, fleets[1])))
    assert t.summary() == r.summary()
    assert t.per_device() == r.per_device()


# -- simulate ---------------------------------------------------------------

def _both(policy, n=1500, **kw):
    """The same SimConfig through the reference and the port."""
    return [s.simulate(z.paper_profiles(), s.SimConfig(
        t_sla=300.0, n_requests=n, seed=4, policy=policy, **kw))
        for s, z in ((rsim, rzoo), (tsim, tzoo))]


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
@pytest.mark.parametrize("policy", DETERMINISTIC)
def test_simulate_deterministic_policies_bit_for_bit(policy, scenario):
    ref, got = _both(policy, **SCENARIOS[scenario])
    assert got.summary() == ref.summary()
    assert got.per_regime() == ref.per_regime()
    assert got.per_device() == ref.per_device()
    assert got.per_mode() == ref.per_mode()
    for field in ("latencies", "selections", "violations", "t_inputs",
                  "arrivals", "accuracies"):
        a, b = getattr(ref, field), getattr(got, field)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), field
    assert (got.hedges, got.fallbacks, got.cold_starts) == (
        ref.hedges, ref.fallbacks, ref.cold_starts)
    assert got.switch_events == ref.switch_events


def _within_se(got, want, n, k=5.0):
    """|got - want| of two independent frequencies over n draws each,
    within k standard errors of their difference (and 1e-12)."""
    p = (np.asarray(got) + np.asarray(want)) / 2.0
    se = np.sqrt(2.0 * p * (1.0 - p) / n)
    return np.abs(np.asarray(got) - np.asarray(want)) <= k * se + 1e-12


@pytest.mark.parametrize("network", ["campus_wifi", "lte_outages"])
def test_simulate_cnnselect_within_tolerance(network):
    """The batched cnnselect draws its Gumbel noise from jax.random in
    the reference and from a torch.Generator in the port: attainment
    and each model's selection share within 5 standard errors of their
    difference at N = 10000; two port runs of one seed bit for bit."""
    n = 10000
    ref, got = _both("cnnselect", n=n, network=network)
    again = tsim.simulate(tzoo.paper_profiles(), tsim.SimConfig(
        t_sla=300.0, n_requests=n, seed=4, policy="cnnselect",
        network=network))
    assert again.summary() == got.summary()
    np.testing.assert_array_equal(again.selections, got.selections)
    names = [p.name for p in tzoo.paper_profiles()]
    assert _within_se(got.attainment, ref.attainment, n)
    h_ref, h_got = (r.selection_histogram(names) for r in (ref, got))
    assert _within_se([h_got[m] for m in names],
                      [h_ref[m] for m in names], n).all()
    # The workload and its realized uploads do not depend on the policy.
    np.testing.assert_array_equal(got.t_inputs, ref.t_inputs)


def test_attainment_improvement_greedy_curve_bit_for_bit():
    slas = np.linspace(120.0, 600.0, 6)
    ref, got = (s.attainment_improvement(
        z.paper_profiles(), slas, n_requests=2000, network="lte")
        for s, z in ((rsim, rzoo), (tsim, tzoo)))
    assert got["slas"] == ref["slas"]
    assert got["base_attainment"] == ref["base_attainment"]
    assert got["base_accuracy"] == ref["base_accuracy"]
    assert got["base_ok_cases"] == ref["base_ok_cases"]
    assert _within_se(got["ours_attainment"], ref["ours_attainment"],
                      2000).all()
    for key in ("ours_attainment", "base_attainment", "ours_accuracy",
                "base_accuracy"):
        assert all(0.0 <= v <= 1.0 for v in got[key])
    assert np.isfinite(got["improvement_cases_pct"])


@pytest.mark.parametrize("policy", ["greedy", "greedy_nw", "random",
                                    "static:mobilenetv1_10", "cnnselect"])
def test_from_sim_exact_replay_reproduces_attainment(tmp_path, policy):
    """Trace.from_sim -> disk -> exact replay with the captured exec
    times injected reproduces the captured attainment to the request
    (benchmarks/trace_replay.py section 2), as the reference's does."""
    out = []
    for s, t, z in ((rsim, rtrace, rzoo), (tsim, ttrace, tzoo)):
        profs = z.paper_profiles()
        names = [p.name for p in profs]
        kw = dict(t_sla=300.0, seed=11, policy=policy,
                  t_estimator="ewma:0.2")
        cap = s.simulate(profs, s.SimConfig(n_requests=2000,
                                            network="lte_outages", **kw))
        tr = t.Trace.from_sim(cap, name="cap", meta={"models": names})
        tr.meta["exec_ms"] = [float(v)
                              for v in cap.latencies - 2.0 * cap.t_inputs]
        path = tmp_path / f"{t.__name__}.npz"
        tr.save(path)
        tr = t.Trace.load(path)
        over = np.full((len(tr), len(names)), np.nan)
        for i, m in enumerate(tr.model):
            over[i, names.index(str(m))] = tr.meta["exec_ms"][i]
        rep = s.simulate(profs, s.SimConfig(
            n_requests=len(tr), network=t.CapturedTraceProcess(
                tr, mode="exact"), **kw), exec_override=over)
        out.append((tr, rep))
    (rtr, rrep), (ttr, trep) = out
    if policy != "cnnselect":     # jax.random against torch noise
        assert_traces_equal(ttr, rtr)
        assert trep.summary() == rrep.summary()
    assert abs(trep.attainment - ttr.attainment) <= 1.0 / len(ttr)


def test_shards_is_inert_on_the_python_engine():
    one, two = (tsim.simulate(tzoo.paper_profiles(), tsim.SimConfig(
        t_sla=300.0, n_requests=800, seed=1, policy="greedy_nw",
        network="lte_outages", shards=k)) for k in (1, 2))
    assert one.summary() == two.summary()
    np.testing.assert_array_equal(one.latencies, two.latencies)


# -- Cluster ----------------------------------------------------------------

def _cluster(c, st, z, policy, mix):
    reps = [st.SimReplicaStack(z.paper_profiles(CLUSTER_MODELS),
                               seed=100 + i, name=f"r{i}", policy=policy)
            for i in range(3)]
    return c.Cluster(reps, mix, memory_budget_bytes=int(250e6))


@pytest.mark.parametrize("mix", ["consumer_burst", "enterprise_degraded"])
@pytest.mark.parametrize("policy", ["greedy_nw", "cnnselect"])
def test_cluster_capture_bit_for_bit(policy, mix):
    """Over SimReplicaStack replicas (whose cnnselect is the scalar
    numpy path: no Gumbel draw), capture_run gives the reference's
    events, metrics and capture, and replay_events holds."""
    out = []
    for c, st, z in ((rcluster, rstack, rzoo), (tcluster, tstack, tzoo)):
        reqs = c.make_tenant_workload(mix, n_requests=500, rate_hz=40.0,
                                      seed=0)
        cl = _cluster(c, st, z, policy, mix)
        out.append((cl, c.capture_run(cl, reqs)))
    (rcl, rtr), (tcl, ttr) = out
    assert tcl.events == rcl.events and tcl.events
    assert tcl.metrics.records == rcl.metrics.records
    assert tcl.metrics.summary() == rcl.metrics.summary()
    assert_traces_equal(ttr, rtr)
    assert tcluster.replay_events(
        ttr, lambda: _cluster(tcluster, tstack, tzoo, policy, mix)) is True
    back = tcluster.requests_from_cluster_trace(ttr)
    assert [(r.device_id, r.tenant, r.sla_ms) for r in back] == [
        (r.device_id, r.tenant, r.sla_ms)
        for r in rcluster.requests_from_cluster_trace(rtr)]


def test_tenant_columns_as_reference():
    for mix in tzoo.TENANT_MIXES:
        a, b = (c.make_tenant_columns(mix, n_requests=300, rate_hz=30.0,
                                      seed=2)
                for c in (rcluster, tcluster))
        assert len(a) == len(b)
        assert [vars(t) for t in b.tenants] == [vars(t) for t in a.tenants]
        for name in vars(a):
            x, y = getattr(a, name), getattr(b, name)
            if isinstance(x, np.ndarray):
                assert x.dtype == y.dtype, name
                np.testing.assert_array_equal(y, x)
            elif name != "tenants":
                assert y == x, name
        assert [b.device_name(c) for c in range(len(b.col_tenant))] == [
            a.device_name(c) for c in range(len(a.col_tenant))]


# -- engine="scan" ----------------------------------------------------------

@pytest.mark.parametrize("pkg", ["reference", "port"])
def test_engine_scan_raises_import_error(pkg):
    """The reference's scan engines raise ImportError on this tree
    wherever they run their jax program (an estimator here:
    `enable_x64` is gone from jax.experimental). The port's computes
    with both (on the CPU here, under `scan_device("cpu")`):
    `simulate(engine="scan")` (tests/test_torch_scan.py holds it against
    the reference's) and `Cluster(engine="scan")`, which equals the
    python `Cluster` (tests/test_torch_cluster_engine.py holds it
    against the reference's)."""
    s, z, c, st = ((rsim, rzoo, rcluster, rstack) if pkg == "reference"
                   else (tsim, tzoo, tcluster, tstack))
    cfg = s.SimConfig(t_sla=300.0, n_requests=50, network="lte_outages",
                      t_estimator="ewma:0.2", engine="scan")
    if pkg == "reference":
        with pytest.raises(ImportError):
            s.simulate(z.paper_profiles(), cfg)
    else:
        from repro_torch.serving.scan_engine import scan_device
        with scan_device("cpu"):
            got = s.simulate(z.paper_profiles(), cfg)
        want = s.simulate(z.paper_profiles(),
                          dataclasses.replace(cfg, engine="python"))
        assert list(got.selections) == list(want.selections)
        np.testing.assert_allclose(got.latencies, want.latencies,
                                   rtol=1e-9)
    wl = c.make_tenant_workload("consumer_burst", n_requests=40,
                                rate_hz=40.0, seed=0)
    reps = lambda: [st.SimReplicaStack(z.paper_profiles(CLUSTER_MODELS),
                                       seed=1)]
    cl = c.Cluster(reps(), "consumer_burst", engine="scan")
    if pkg == "reference":
        with pytest.raises(ImportError):
            cl.run(wl)
        return
    with scan_device("cpu"):
        cl.run(wl)
    py = c.Cluster(reps(), "consumer_burst", engine="python")
    py.run(wl)
    assert cl.events == py.events and cl.events
    assert cl.metrics.records == py.metrics.records
    assert cl.n_active == py.n_active


# -- the sim-to-real loop on the port's CPU server --------------------------

def _chip_smoke():
    path = ROOT / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_recorder_on_port_server_replays_its_outcomes(tmp_path):
    """chip_smoke's sim phase on a CPU CNNSelectServer over a small
    stablelm engine pair (fp32 and int8): the serve capture checked, 16
    requests a policy captured, round-tripped through JSONL and npz bit
    for bit, and replayed through simulate with the measured exec_ms
    injected. Wherever the replay ran the served model it reproduces
    the served outcome, so the attainment gap is at most the share of
    requests it sent elsewhere, and 0 where it sent none. (The card's
    0.02 at 200 requests is not held here: these two engines' CPU
    times differ by less than their noise under a parallel test run,
    so greedy_nw's online profiles and cnnselect's numpy-vs-torch draws
    send a few of 16 requests elsewhere.)"""
    from repro_torch.core.selection import make_policy
    from repro_torch.serving.batching import Request
    from repro_torch.serving.measured import build_zoo, served_models
    from repro_torch.serving.server import CNNSelectServer
    from repro_torch.serving.trace import TraceRecorder
    cs = _chip_smoke()
    zoo = build_zoo(["lm_small", "lm_small_int8"], batch_size=2,
                    max_seq=32, device="cpu")
    srv = CNNSelectServer(served_models(zoo), t_threshold=30.0,
                          policy=make_policy("cnnselect", t_threshold=30.0),
                          n_tokens=8)
    srv.profile_models(prompt_len=8, reps=3)
    rec = TraceRecorder(name="serve").attach(srv)
    rng = np.random.default_rng(0)
    for i in range(4):
        srv.handle(Request(arrival=0.0, rid=i,
                           prompt=rng.integers(0, 50, 8).astype(np.int32),
                           t_input_ms=5.0), t_sla=1e4)
    rec.detach()
    cs.check_capture(rec.to_trace(), srv.metrics.summary()["served"],
                     "serve")
    rows = cs.replay_policies(srv, "lm_small", 16, tmp_path,
                              vocab=50, prompt_len=8)
    assert set(rows) == set(cs.SIM_POLICIES)
    for spec, r in rows.items():
        assert r["n"] == 16 and abs(sum(r["share"].values()) - 1) < 1e-12
        assert r["flips_where_agreed"] == 0, (spec, r)
        assert abs(r["gap"]) <= r["other_model"] / r["n"], (spec, r)
        if r["other_model"] == 0:
            assert r["gap"] == 0.0, (spec, r)
    assert {p.suffix for p in tmp_path.iterdir()} == {".jsonl", ".npz"}
