"""The paper's own measured data, used to seed simulations & benchmarks.

- TABLE5: CNN model statistics (top-1/top-5 accuracy, hot/cold start
  inference time on an EC2 p2.xlarge GPU server), paper Table 5.
- NETWORKS: mobile network conditions (paper §3 Fig 7/10: campus WiFi
  mean input-transfer 63 ms per ~330KB request, 36.83 ms per 172 KB
  upload; cellular hotspot transfer ~2x WiFi; LTE between, heavier tail).
- DEVICES: on-device inference times (Fig 5/6, Table 4) for the
  on-device-vs-cloud comparisons and the T_D bound on T_threshold.
- MODEL_SIZES: approximate serialized sizes (MB) from the public model
  zoo files, for the cold/hot memory-budget experiments.
"""

from __future__ import annotations

import os

import numpy as np

from repro_torch.core.selection import ModelProfile

# name: (top1, top5, hot_mu, hot_sigma, cold_mu, cold_sigma) [ms]
TABLE5 = {
    "squeezenet":          (49.0, 72.9, 28.61, 1.13, 173.38, 25.73),
    "mobilenetv1_025":     (49.7, 74.1, 25.73, 1.22, 272.81, 45.00),
    "mobilenetv1_05":      (63.2, 84.9, 26.34, 1.19, 302.77, 45.50),
    "densenet":            (64.2, 85.6, 49.55, 3.21, 1149.04, 108.00),
    "mobilenetv1_075":     (68.3, 88.1, 28.02, 1.14, 351.92, 47.38),
    "mobilenetv1_10":      (71.8, 90.6, 28.15, 1.22, 421.23, 47.14),
    "nasnet_mobile":       (73.9, 91.5, 55.31, 4.09, 2817.25, 123.73),
    "inception_resnet_v2": (77.5, 94.0, 76.30, 5.74, 2844.29, 106.49),
    "inceptionv3":         (77.9, 93.8, 55.75, 1.20, 1950.71, 101.21),
    "inceptionv4":         (80.1, 95.1, 82.78, 0.89, 3162.24, 133.99),
    "nasnet_large":        (82.6, 96.1, 112.61, 6.09, 7054.52, 238.36),
}

MODEL_SIZES_MB = {
    "squeezenet": 5.0, "mobilenetv1_025": 1.9, "mobilenetv1_05": 5.2,
    "densenet": 32.6, "mobilenetv1_075": 10.3, "mobilenetv1_10": 16.9,
    "nasnet_mobile": 21.4, "inception_resnet_v2": 121.0,
    "inceptionv3": 95.3, "inceptionv4": 170.7, "nasnet_large": 355.3,
}

# T_input distributions (ms for a ~330KB preprocessed image). Lognormal
# keeps the positive heavy tail the paper attributes to mobile networks.
NETWORKS = {
    "campus_wifi": dict(mean=63.0, std=18.0),
    "lte": dict(mean=95.0, std=35.0),
    "cellular_hotspot": dict(mean=126.0, std=60.0),
    "edge_wired": dict(mean=20.0, std=5.0),
}

# Extra regime states for the time-varying processes (beyond the paper's
# stationary measurements): degraded/congested variants of the measured
# networks and a near-outage state (MDInference's "variable mobile
# network" regime).
NETWORK_STATES = {
    "congested_wifi": dict(mean=190.0, std=85.0),
    "degraded_lte": dict(mean=260.0, std=110.0),
    "outage": dict(mean=900.0, std=250.0),
}

# Named regime-switching scenarios for `serving.network.MarkovProcess`:
# states are NETWORKS/NETWORK_STATES names, `transition` is the
# per-request row-stochastic matrix. Diagonals near 1 give realistic
# multi-hundred-request dwells at the simulator's request granularity.
NETWORK_SCENARIOS = {
    # Device walks out of WiFi coverage and hands off to LTE (and back).
    "wifi_lte_handoff": dict(
        states=("campus_wifi", "lte"),
        transition=((0.998, 0.002),
                    (0.002, 0.998)),
        start=0),
    # Mostly-good WiFi with short heavy congestion bursts.
    "wifi_congestion_bursts": dict(
        states=("campus_wifi", "congested_wifi"),
        transition=((0.99, 0.01),
                    (0.08, 0.92)),
        start=0),
    # LTE that occasionally collapses toward an outage and recovers
    # through a degraded state.
    "lte_outages": dict(
        states=("lte", "degraded_lte", "outage"),
        transition=((0.995, 0.004, 0.001),
                    (0.050, 0.930, 0.020),
                    (0.020, 0.180, 0.800)),
        start=0),
}


# The synthetic mean-T_input traces `synthetic_trace` can build — the
# `trace:<name>` half of the trace registry (`capture_names()` is the
# recorded half).
SYNTHETIC_TRACES = ("wifi_lte_step", "diurnal", "sawtooth_congestion")


def synthetic_trace(name: str, n: int = 2048):
    """Synthetic mean-T_input traces (ms per request position) for
    `serving.network.TraceReplayProcess`:

    - ``wifi_lte_step``: abrupt campus_wifi -> lte handoff mid-trace.
    - ``diurnal``: smooth sinusoidal load swing between WiFi-like and
      hotspot-like conditions (a day of varying congestion).
    - ``sawtooth_congestion``: repeated build-up/clear congestion ramps.
    """
    i = np.arange(n)
    wifi, lte = NETWORKS["campus_wifi"]["mean"], NETWORKS["lte"]["mean"]
    hotspot = NETWORKS["cellular_hotspot"]["mean"]
    if name == "wifi_lte_step":
        return np.where(i < n // 2, wifi, lte).astype(np.float64)
    if name == "diurnal":
        mid, amp = (hotspot + wifi) / 2.0, (hotspot - wifi) / 2.0
        return mid + amp * np.sin(2.0 * np.pi * i / n)
    if name == "sawtooth_congestion":
        period = max(n // 8, 1)
        ramp = (i % period) / period
        return wifi + (hotspot - wifi) * ramp
    raise ValueError(f"unknown synthetic trace {name!r}; known: "
                     f"{', '.join(SYNTHETIC_TRACES)}")


# --------------------------------------------------------------------------
# Recorded captures (serving.trace.Trace files committed under traces/)
# --------------------------------------------------------------------------

_TRACES_DIR = os.path.join(os.path.dirname(__file__), "traces")

# Registered capture scenarios for `make_network("capture:<name>")` /
# `serving.trace.load_capture`: each entry names a committed capture
# file and the default replay mode (`serving.trace.CapturedTraceProcess`).
# `reference_fleet` is the ground-truth workload the sim-to-real CI loop
# pins: a mixed_fleet greedy_nw simulator run captured by
# `benchmarks/trace_replay.py --write-reference` (numpy-only policy, so
# regeneration is bit-for-bit reproducible across jax versions).
CAPTURE_SCENARIOS = {
    "reference_fleet": dict(file="reference_fleet.jsonl", mode="loop"),
}


def capture_names():
    return sorted(CAPTURE_SCENARIOS)


def capture_path(name: str) -> str:
    """Path of a registered capture file (see `CAPTURE_SCENARIOS`)."""
    if name not in CAPTURE_SCENARIOS:
        raise ValueError(f"unknown capture {name!r}; known: "
                         f"{', '.join(capture_names())}")
    return os.path.join(_TRACES_DIR, CAPTURE_SCENARIOS[name]["file"])

# On-device end-to-end inference (ms), Fig 5/6 & Table 4 (hot model).
DEVICES = {
    "pixel2": {"mobilenetv1_025": 133.0, "mobilenetv1_10": 352.0,
               "inceptionv3": 1910.0},
    "motox": {"mobilenetv1_025": 210.0},
    "nexus5_caffe": {"alexnet_equiv": 8910.0},
}

# Device tiers for `serving.fleet`: each tier pairs a radio (any
# make_network spec) with the on-device profile the paper measured for
# that class of phone — (DEVICES key, model) resolved against DEVICES
# for the mean and TABLE5 for the accuracy. `on_device=None` models a
# device that cannot run the CNN locally (the paper's Nexus 5 at ~9 s
# is never SLA-viable, so "legacy" simply has no fallback).
DEVICE_TIERS = {
    "flagship": dict(network="campus_wifi",
                     on_device=("pixel2", "mobilenetv1_10")),
    "midrange": dict(network="lte",
                     on_device=("pixel2", "mobilenetv1_025")),
    "budget": dict(network="cellular_hotspot",
                   on_device=("motox", "mobilenetv1_025")),
    "legacy": dict(network="cellular_hotspot", on_device=None),
}

# Named fleets for `serving.fleet.make_fleet`: tuples of tier entries
# (tier, weight, optional per-entry `network` override / `device_id`).
# `lte_outage_fleet` puts the midrange tier on the `lte_outages`
# regime-switching scenario — the degraded-regime tier the outage-aware
# hedging/fallback benchmark reports on.
FLEET_SCENARIOS = {
    "mixed_fleet": (
        dict(tier="flagship", weight=0.3),
        dict(tier="midrange", weight=0.5),
        dict(tier="budget", weight=0.2),
    ),
    "lte_outage_fleet": (
        dict(tier="flagship", weight=0.4),
        dict(tier="midrange", weight=0.4, network="lte_outages"),
        dict(tier="legacy", weight=0.2),
    ),
}


# SLA classes for multi-tenant cluster serving (serving/cluster.py,
# DESIGN.md §16; per-tenant SLA-aware selection after ModiPick,
# arXiv:1909.02053). `t_sla` is the class's end-to-end deadline;
# `shed_priority` orders load-shedding when the cluster saturates
# (lower sheds first — bronze traffic falls back on-device before any
# gold request does).
TENANT_SLA_CLASSES = {
    "gold":   dict(t_sla=250.0, shed_priority=2),
    "silver": dict(t_sla=500.0, shed_priority=1),
    "bronze": dict(t_sla=1200.0, shed_priority=0),
}

# Named tenant mixes for `serving.cluster.make_tenants`: each entry is
# one tenant — a device population (FLEET_SCENARIOS name) under an SLA
# class, with its share of the cluster's request volume and a staggered
# burst window (`phase` offsets the tenant's traffic peak as a fraction
# of the horizon; `burst` is the peak/trough rate ratio). Staggered
# peaks are what make the shared cluster beat static per-tenant
# replicas: pinned capacity must cover every tenant's own peak, the
# cluster reuses idle capacity across peaks.
TENANT_MIXES = {
    "consumer_burst": (
        dict(tenant="gold-flagship", sla_class="gold",
             fleet="mixed_fleet", weight=0.3, phase=0.0, burst=4.0),
        dict(tenant="silver-mid", sla_class="silver",
             fleet="mixed_fleet", weight=0.4, phase=0.4, burst=4.0),
        dict(tenant="bronze-budget", sla_class="bronze",
             fleet="lte_outage_fleet", weight=0.3, phase=0.7,
             burst=4.0),
    ),
    "enterprise_degraded": (
        dict(tenant="gold-field", sla_class="gold",
             fleet="lte_outage_fleet", weight=0.5, phase=0.0,
             burst=3.0),
        dict(tenant="bronze-bulk", sla_class="bronze",
             fleet="mixed_fleet", weight=0.5, phase=0.5, burst=3.0),
    ),
}


def scale_tenant_mix(n_devices: int, *, seed: int = 0):
    """A three-class tenant mix whose fleets total `n_devices`
    devices, for the cluster-scale sweep (benchmarks/cluster_scale.py:
    1k -> 1M tenant-devices). ``"array:<n>:<seed>"`` fleet specs keep
    per-device state columnar at any size — the FLEET_SCENARIOS
    mixtures enumerate device-id strings, which a 10^6-device
    population would pay for in memory and workload-generation time.
    Shares/phases mirror ``consumer_burst`` (staggered burst peaks per
    SLA class). Deliberately NOT a `TENANT_MIXES` entry: the registry
    names fixed paper-figure scenarios, this one is parameterized by
    scale. Returns the tenant-spec list `make_tenants` (and every
    workload/cluster constructor) accepts."""
    if n_devices < 3:
        raise ValueError(f"scale mix needs >= 3 devices (one per SLA "
                         f"class), got {n_devices}")
    classes = (("gold", 0.3, 0.0), ("silver", 0.4, 0.4),
               ("bronze", 0.3, 0.7))
    base = n_devices // len(classes)
    counts = [base, base, n_devices - 2 * base]
    return [
        dict(tenant=f"{cls}-scale", sla_class=cls,
             fleet=f"array:{n}:{seed + k}", weight=w, phase=ph,
             burst=4.0)
        for k, ((cls, w, ph), n) in enumerate(zip(classes, counts))]


# Named adaptive-controller presets for `serving.control.make_controller`
# (`SimConfig.controller`, CNNSelectServer/ServingLoop `controller=`):
# an ordered mode table (core.selection.CONTROL_MODES names, least ->
# most conservative), the change-point detector watching each device's
# monitor-estimator residuals, and the anti-thrash cooldown. "reactive"
# is the benchmark default; "conservative" needs a stronger/longer
# shift before it escalates (fewer false switches on heavy-tailed
# stationary traffic).
CONTROLLER_SCENARIOS = {
    "reactive": dict(modes=("stationary", "degraded"),
                     detector="cusum:8", monitor="ewma:0.2",
                     cooldown=8),
    "conservative": dict(modes=("stationary", "degraded"),
                         detector="cusum:16", monitor="ewma:0.1",
                         cooldown=32),
    "ph_reactive": dict(modes=("stationary", "degraded"),
                        detector="ph:8", monitor="ewma:0.2",
                        cooldown=8),
}


# --------------------------------------------------------------------------
# Measured zoo (DESIGN.md §14): models the repo actually RUNS behind the
# Router, replacing Table 5 lookups with this host's latencies.
# --------------------------------------------------------------------------

# Reduced attention-only LM variants (stablelm family — maskable KV-cache
# pattern, so padded prompts and mid-group slot backfill work) sized to
# run on CPU CI. d_model/d_ff/n_layers stratify latency the way Table 5's
# CNN depth does; `accuracy` is the offline task score attached to each
# candidate. int8 variants are *distinct selection candidates*: they pay
# a small accuracy penalty but ~75% storage, so under a memory budget a
# quantized larger model can sit on the frontier where its fp32 parent
# cannot fit — the "Smart at what cost?" trade-off. `lm_base_int8`'s
# fp32 parent is deliberately absent for exactly that reason.
MEASURED_ZOO = {
    "lm_tiny":       dict(arch="stablelm_1_6b", d_model=48, d_ff=96,
                          n_layers=2, quant=None, accuracy=0.58),
    "lm_small":      dict(arch="stablelm_1_6b", d_model=96, d_ff=192,
                          n_layers=2, quant=None, accuracy=0.66),
    "lm_small_int8": dict(arch="stablelm_1_6b", d_model=96, d_ff=192,
                          n_layers=2, quant="int8", accuracy=0.652),
    "lm_base_int8":  dict(arch="stablelm_1_6b", d_model=160, d_ff=320,
                          n_layers=4, quant="int8", accuracy=0.72),
}


def measured_zoo_names(subset=None):
    names = list(subset) if subset else list(MEASURED_ZOO)
    for n in names:
        if n not in MEASURED_ZOO:
            raise ValueError(f"unknown measured-zoo model {n!r}; known: "
                             f"{', '.join(MEASURED_ZOO)}")
    return names


def paper_profiles(subset=None):
    """ModelProfile list from Table 5 (top-1 accuracy as A(m))."""
    names = subset or list(TABLE5)
    out = []
    for n in names:
        t1, t5, mu, sg, cmu, csg = TABLE5[n]
        out.append(ModelProfile(
            name=n, accuracy=t1 / 100.0, mu=mu, sigma=sg,
            cold_mu=cmu, cold_sigma=csg,
            size_bytes=int(MODEL_SIZES_MB[n] * 1e6)))
    return out


def lognormal_params(mean, std):
    """(mu, sigma) of the lognormal matched to the given mean/std.
    Accepts scalars or arrays (per-request regime parameters); the one
    implementation shared by `sample_network` and every
    `serving.network.NetworkProcess` — the bit-for-bit legacy-draw
    guarantee depends on there being exactly one copy of this math."""
    mean = np.asarray(mean, np.float64)
    var = np.asarray(std, np.float64) ** 2
    sigma2 = np.log(1.0 + var / mean ** 2)
    return np.log(mean) - sigma2 / 2.0, np.sqrt(sigma2)


def sample_network(name: str, rng: np.random.Generator, n: int = 1):
    """Sample T_input (ms): lognormal matched to (mean, std)."""
    d = NETWORKS[name]
    mu, sigma = lognormal_params(d["mean"], d["std"])
    return rng.lognormal(mu, sigma, size=n)
