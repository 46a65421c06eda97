"""Serving substrate of the port: the inference engine with KV-cache
management and slot backfill, the measured model zoo, the continuous-
batching loop and the CNNSelect-fronted server, over the numpy control
plane (router, batching, network, fleet, control, metrics, stack).

The simulator, the multi-tenant cluster, the scan engines and trace
capture belong to later slices of the port."""
