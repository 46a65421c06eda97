"""Serving substrate of the port: the inference engine with KV-cache
management and slot backfill, the measured model zoo, the continuous-
batching loop and the CNNSelect-fronted server, over the numpy control
plane (router, batching, network, fleet, control, metrics, stack), and
the simulation plane: the event-driven request simulator (paper §5.2
simulations), the multi-tenant cluster and trace capture and replay.

`simulate(..., engine="scan")` runs the scan engine
(`serving/scan_engine.py`) and `Cluster(..., engine="scan")` the scan
cluster engine (`serving/cluster_engine.py`): the control plane as a
column program on the card, or on the CPU inside
`scan_engine.scan_device("cpu")`."""

from repro_torch.serving.cluster import (Cluster, ClusterPlacer,
                                         TenantColumns, TenantSpec,
                                         capture_run, make_tenant_columns,
                                         make_tenant_workload, make_tenants,
                                         replay_events,
                                         requests_from_cluster_trace)
from repro_torch.serving.simulator import (SimConfig, SimResult,
                                           attainment_improvement,
                                           simulate, sla_sweep)
from repro_torch.serving.trace import (CapturedTraceProcess, Trace,
                                       TraceRecorder, load_capture,
                                       requests_from_trace)

__all__ = ["SimConfig", "SimResult", "simulate", "sla_sweep",
           "attainment_improvement", "Trace", "TraceRecorder",
           "CapturedTraceProcess", "load_capture", "requests_from_trace",
           "Cluster", "ClusterPlacer", "TenantSpec", "TenantColumns",
           "make_tenants", "make_tenant_columns", "make_tenant_workload",
           "capture_run", "requests_from_cluster_trace", "replay_events"]
