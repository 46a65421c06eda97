"""The port's scan cluster engine (`repro_torch/serving/cluster_engine.py`
and its request-axis scan `kernels.cluster_scan`) on the CPU, under
`scan_device("cpu")`, where the scan runs as its plain loop
`kernels.ref.cluster_scan_ref`.

(a) `Cluster(engine="scan")` against the port's python `Cluster` on the
matrix of tests/test_cluster_engine.py (each tenant mix, hedge-off,
controller-off, shed-off, scale-params, heavy shed, no budget, the
columnar workload, shards=2): events, metrics rows, n_active, replica
zoo / queue / RNG state and the controller's events, bit for bit.
(b) The port's scan against the reference's scan on the same workload.
The reference imports `enable_x64` from `jax.experimental`, which this
jax moved to `jax.enable_x64`: the `x64_shim` fixture sets that one
attribute for the test that asks for it, as tests/test_torch_scan.py
does. (c) `cluster_scan_ref` against the reference's jitted program
(`_compile(R, K, has_budget)`) on the same inputs, every column and
every carry bit for bit: drawn inputs with equal free times, equal
capacities, equal arrivals, tight budgets (several victims a request)
and degraded hedges, at several R x K. Tolerance 0 throughout."""

import importlib.util
import pathlib

import jax
import jax.experimental
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import repro.configs.paper_zoo as rzoo
import repro.serving.cluster as rcluster
import repro.serving.cluster_engine as rce
import repro.serving.stack as rstack
import repro_torch.configs.paper_zoo as tzoo
import repro_torch.serving.cluster as tcluster
import repro_torch.serving.cluster_engine as tce
import repro_torch.serving.stack as tstack
from repro_torch.kernels import ref as R
from repro_torch.kernels.cluster_scan import cluster_scan
from repro_torch.serving.scan_engine import scan_device

MODELS = ["mobilenetv1_025", "mobilenetv1_10", "inceptionv3"]
BUDGET = int(250e6)          # ~2 of 3 hot sets: eviction is exercised
N = 600
RATE = 40.0


def _chip_smoke():
    """chip_smoke.py as a module: its `cluster_inputs` (the inputs its
    kernels phase and the GPU tests draw) and `cluster_state`."""
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_CS = _chip_smoke()
_inputs, _state = _CS.cluster_inputs, _CS.cluster_state


@pytest.fixture
def x64_shim(monkeypatch):
    """`from jax.experimental import enable_x64` as the reference's
    cluster engine writes it, for this test only."""
    monkeypatch.setattr(jax.experimental, "enable_x64", jax.enable_x64,
                        raising=False)


def _replicas(stack, profiles, n=3, seed=100):
    return [stack.SimReplicaStack(profiles(MODELS), seed=seed + i,
                                  name=f"r{i}") for i in range(n)]


def _run(engine, mix, wl, *, pkg="port", shards=1, budget=BUDGET, **kw):
    cl_mod, stack, zoo = ((tcluster, tstack, tzoo) if pkg == "port"
                          else (rcluster, rstack, rzoo))
    cl = cl_mod.Cluster(_replicas(stack, zoo.paper_profiles), mix,
                        memory_budget_bytes=budget, engine=engine,
                        shards=shards, **kw)
    if engine == "scan" and pkg == "port":
        with scan_device("cpu"):
            cl.run(wl)
    else:
        cl.run(wl)
    return cl


def _pair(mix, *, n=N, rate=RATE, seed=7, **kw):
    wl = tcluster.make_tenant_workload(mix, n_requests=n, rate_hz=rate,
                                       seed=seed)
    return (_run("python", mix, list(wl), **kw),
            _run("scan", mix, list(wl), **kw))


def _assert_bitwise(cp, cs):
    assert cs.events == cp.events
    assert cs.metrics.records == cp.metrics.records
    assert cs.n_active == cp.n_active
    assert _state(cs) == _state(cp)
    if cp.controller is not None:
        assert cs.controller.events == cp.controller.events


def _kinds(cl):
    return {e["kind"] for e in cl.events}


# -- (a) the port's scan against the port's python Cluster -------------------

@pytest.mark.parametrize("mix", sorted(tzoo.TENANT_MIXES))
def test_tenant_mixes_bitwise(mix):
    cp, cs = _pair(mix)
    assert {"place", "evict", "shed"} <= _kinds(cp)
    _assert_bitwise(cp, cs)


@pytest.mark.parametrize("kw", [
    dict(hedge=False),
    dict(controller=None),
    dict(shed_factor=1e9),
    dict(min_active=2, scale_headroom=0.05),
], ids=["hedge-off", "controller-off", "shed-off", "scale-params"])
def test_feature_toggles_bitwise(kw):
    _assert_bitwise(*_pair("enterprise_degraded", **kw))


def test_heavy_shed_bitwise():
    """Saturating rate: most requests shed to on-device fallback."""
    cp, cs = _pair("consumer_burst", rate=300.0)
    assert any(e["kind"] == "shed" for e in cp.events)
    _assert_bitwise(cp, cs)


@pytest.mark.parametrize("mix", sorted(tzoo.TENANT_MIXES))
def test_no_budget_bitwise(mix):
    """budget=None: no victims (no vict outputs), and the hedge leg
    fires."""
    cp, cs = _pair(mix, budget=None)
    assert "evict" not in _kinds(cp)
    assert any(r["hedged"] for r in cp.metrics.records)
    _assert_bitwise(cp, cs)


def test_columnar_workload_bitwise():
    """`TenantColumns` straight into both engines (the fleet-scale path:
    array fleets, no Request materialization on the scan side)."""
    mix = tzoo.scale_tenant_mix(1_000)
    wl = tcluster.make_tenant_columns(mix, n_requests=N, rate_hz=12.0,
                                      seed=7)
    _assert_bitwise(_run("python", mix, wl, budget=None),
                    _run("scan", mix, wl, budget=None))


def test_sharded_bitwise():
    """shards=2 runs the controller program as two column blocks: the
    same bits as one block and as the python Cluster."""
    cp, cs2 = _pair("consumer_burst", shards=2)
    _assert_bitwise(cp, cs2)
    _assert_bitwise(cp, _pair("consumer_burst", shards=1)[1])


def test_scan_cluster_run_without_rows():
    """collect_rows=False (the fleet-scale path) leaves the metrics
    ledger empty and returns the same columns and events."""
    mix = "enterprise_degraded"
    wl = tcluster.make_tenant_workload(mix, n_requests=N, rate_hz=RATE,
                                       seed=3)
    res = {}
    for rows in (True, False):
        cl = tcluster.Cluster(_replicas(tstack, tzoo.paper_profiles), mix,
                              memory_budget_bytes=BUDGET, engine="scan")
        with scan_device("cpu"):
            res[rows] = (tce.scan_cluster_run(cl, list(wl),
                                              collect_rows=rows), cl)
    (a, ca), (b, cb) = res[True], res[False]
    assert (a.rows, b.rows) == (N, 0) and not cb.metrics.records
    assert a.events == b.events == ca.events == cb.events
    for k in ("e2e", "ok", "shed", "hedged", "mode_idx"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
    assert _state(ca) == _state(cb)
    np.testing.assert_array_equal(
        a.e2e, [r["e2e_ms"] for r in ca.metrics.records])


# -- (b) the port's scan against the reference's scan ------------------------

@pytest.mark.parametrize("mix,budget", [("enterprise_degraded", BUDGET),
                                        ("consumer_burst", None)])
def test_scan_equals_reference_scan(x64_shim, mix, budget):
    want, got = (
        _run("scan", mix, cl.make_tenant_workload(mix, n_requests=N,
                                                  rate_hz=RATE, seed=11),
             pkg=pkg, budget=budget)
        for cl, pkg in ((rcluster, "reference"), (tcluster, "port")))
    assert got.events == want.events
    assert got.metrics.records == want.metrics.records
    assert got.n_active == want.n_active
    assert _state(got) == _state(want)
    assert got.controller.events == want.controller.events


# -- (c) the plain scan against the reference's jitted program ---------------

def _reference_program(xs, init, const, has_budget):
    R_, K = init[0].shape[0], init[1].shape[0] // init[0].shape[0]
    fn = rce._compile(R_, K, has_budget)
    with jax.enable_x64():
        carry, ys = fn(xs, init, const)
        return ([np.asarray(v) for v in carry],
                {k: np.asarray(v) for k, v in ys.items()})


def _same_bits(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    if want.dtype.kind == "f":
        assert got.dtype == want.dtype, what
        np.testing.assert_array_equal(got.view(np.int64),
                                      want.view(np.int64), err_msg=what)
    else:
        np.testing.assert_array_equal(got, want, err_msg=what)


def _check_plain_against_reference(xs, init, const, has_budget):
    t = lambda a: torch.from_numpy(np.asarray(a).copy())
    got_carry, got = cluster_scan({k: t(v) for k, v in xs.items()},
                                  tuple(t(v) for v in init),
                                  {k: t(v) for k, v in const.items()},
                                  has_budget)
    want_carry, want = _reference_program(xs, init, const, has_budget)
    assert set(got) == set(want)
    for k in want:
        _same_bits(got[k].numpy(), want[k], k)
    for name, g, w in zip(("free", "hot", "last", "hb", "n_act", "up", "zp"),
                          got_carry, want_carry):
        _same_bits(g.numpy(), w, name)
    return want


# (R, K, has_budget, kinds): the compile cache holds one program each.
SHAPES = [(3, 3, True, "mixed"), (3, 3, False, "mixed"),
          (3, 3, False, "cnn"), (2, 4, True, "mixed"), (5, 2, True, "det"),
          (1, 1, True, "mixed")]
N_PROGRAM = 96


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "ties"])
def test_plain_scan_equals_reference_program(shape, ties):
    """Each shape with tight budgets and mostly degraded requests: the
    runs evict several models for one request, hedge, and (with ties)
    place among equal delays and capacities."""
    R_, K, has_budget, kinds = shape
    xs, init, const = _inputs(R_ * 10 + K, R_, K, N_PROGRAM,
                              has_budget=has_budget, kinds=kinds, ties=ties,
                              tight=True, degr_p=0.8)
    want = _check_plain_against_reference(xs, init, const, has_budget)
    if R_ > 1:
        assert want["hedged"].any()
    if has_budget and K > 1:
        assert ((want["vict1"] >= 0).sum(axis=1) >= 2).any()


@settings(max_examples=30, deadline=None, database=None)
@given(shape=st.sampled_from(SHAPES), seed=st.integers(0, 2**32 - 1),
       ties=st.booleans(), tight=st.booleans(),
       degr_p=st.sampled_from([0.0, 0.5, 1.0]))
def test_plain_scan_equals_reference_program_drawn(shape, seed, ties, tight,
                                                   degr_p):
    R_, K, has_budget, kinds = shape
    xs, init, const = _inputs(seed, R_, K, N_PROGRAM, has_budget=has_budget,
                              kinds=kinds, ties=ties, tight=tight,
                              degr_p=degr_p)
    _check_plain_against_reference(xs, init, const, has_budget)


def test_captured_inputs_equal_reference_program(monkeypatch, x64_shim):
    """The inputs the reference's scan_cluster_run builds for a real
    workload (through its own `_compile`), through the plain scan."""
    seen = []
    compile_ = rce._compile

    def spy(R_, K, has_budget):
        fn = compile_(R_, K, has_budget)

        def run(xs, init, const):
            seen.append((xs, init, const, has_budget))
            return fn(xs, init, const)
        return run

    monkeypatch.setattr(rce, "_compile", spy)
    mix = "enterprise_degraded"
    wl = rcluster.make_tenant_workload(mix, n_requests=300, rate_hz=RATE,
                                       seed=5)
    _run("scan", mix, list(wl), pkg="reference")
    (xs, init, const, has_budget), = seen
    want = _check_plain_against_reference(xs, init, const, has_budget)
    assert want["shed"].any() and (want["vict1"] >= 0).any()


# -- the wrapper on the CPU ---------------------------------------------------

def test_wrapper_runs_plain_on_cpu_and_checks_operands():
    xs, init, const = _inputs(0, 3, 3, 40, has_budget=True, kinds="mixed",
                              ties=False, tight=True, degr_p=0.5)
    t = lambda a: torch.from_numpy(np.asarray(a).copy())
    txs = {k: t(v) for k, v in xs.items()}
    tinit = tuple(t(v) for v in init)
    tconst = {k: t(v) for k, v in const.items()}
    before = cluster_scan.launches
    carry, ys = cluster_scan(txs, tinit, tconst, True)
    want_carry, want = R.cluster_scan_ref(txs, tinit, tconst, True)
    assert cluster_scan.launches == before
    for k in want:
        assert torch.equal(ys[k], want[k]), k
    for g, w in zip(carry, want_carry):
        assert torch.equal(g, w)
    with pytest.raises(ValueError, match="float64 arr"):
        cluster_scan(dict(txs, arr=txs["arr"].float()), tinit, tconst, True)
    with pytest.raises(ValueError, match="sel"):
        cluster_scan(dict(txs, sel=txs["sel"][:, :2]), tinit, tconst, True)
    with pytest.raises(ValueError, match=r"\(3,\) torch.int32 zp"):
        cluster_scan(txs, tinit[:6] + (tinit[6].long(),), tconst, True)
    with pytest.raises(ValueError, match="R >= 1"):
        cluster_scan(txs, (tinit[0][:0],) + tinit[1:], tconst, True)
    with pytest.raises(ValueError, match="meta"):
        cluster_scan(dict(txs, od=txs["od"].to("meta")), tinit, tconst, True)
