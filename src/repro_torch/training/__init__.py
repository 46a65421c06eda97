"""Training substrate: optimizers, train step, gradient accumulation,
checkpoints and DiLoCo's outer sync, on one device. The elastic
re-mesh path and the sharded train state belong to the sharding slice
of the port."""
