"""Training launcher: the card by default, the CPU with ``--device
cpu``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-1.6b \\
        --reduced --steps 100 --ckpt /tmp/ckpt --device cpu

Real optimizer steps (AdamW or Adafactor under `mixed_precision`, a
cosine schedule), Markov or byte data, a checkpoint every
``--save-interval`` steps and resume from the latest committed one.

``--mesh-shape`` trains sharded (the train profile, any ``--arch``) on
the ranks of a torch.distributed world: the launcher's own
process group where one is initialized, else one built from torchrun's
``env://`` variables (nccl on the card, each rank on its LOCAL_RANK's
device; gloo with ``--device cpu``), e.g. on four CPU ranks:

    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
        --reduced --device cpu --mesh-shape 2,2 --batch 4 --ckpt /tmp/ck

The mesh is ("data", "model") or ("pod", "data", "model"), the parallel
config `make_parallel(mesh, "train", seq_shard=False)` as the
reference's launcher builds it, and each rank keeps its shards of the
state (`tree_specs(train_state_logical_axes(...))`). Every rank reads
the whole batch. A checkpoint holds the whole state (gathered; rank 0
writes it), in the one-device format, so either package restores it;
on resume each rank cuts its shards from it.
"""

from __future__ import annotations

import argparse
import os
import time

import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.data import ByteCorpus, DataIterator, MarkovLMTask
from repro_torch.sharding import gather_tree, make_parallel, tree_specs
from repro_torch.training.checkpoint import CheckpointManager
from repro_torch.training.optim import (adafactor, adamw, cosine_schedule,
                                        mixed_precision)
from repro_torch.training.step import (abstract_train_state,
                                       init_train_state, make_train_step,
                                       train_state_logical_axes)
from repro_torch.utils import resolve_device

TORCHRUN_VARS = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def make_optimizer(name: str, lr: float, steps: int):
    """The launcher's optimizer: `name` ("adamw" or "adafactor") on a
    cosine schedule warming up over min(20, steps // 5) steps, under
    `mixed_precision`."""
    sched = cosine_schedule(lr, min(20, steps // 5), steps)
    opt = adamw(sched) if name == "adamw" else adafactor(sched)
    return mixed_precision(opt)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-1.6b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--optimizer", default="adamw",
                    choices=["adamw", "adafactor"])
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--save-interval", type=int, default=50)
    ap.add_argument("--data", default="markov", choices=["markov", "bytes"])
    ap.add_argument("--mesh-shape", default=None, help="e.g. 2,4")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    return ap.parse_args(argv)


def build(args, parallel=None):
    """(cfg, optimizer, train step) as the launcher trains them: the
    arch's config (reduced with --reduced) with fp32 params, the
    optimizer of `make_optimizer`, the step under `parallel` (None: one
    device)."""
    cfg = (reduced_config(args.arch) if args.reduced
           else get_config(args.arch))
    opt = make_optimizer(args.optimizer, args.lr, args.steps)
    cfg = cfg.with_runtime(param_dtype="float32")
    return cfg, opt, make_train_step(cfg, opt, parallel=parallel)


def _world(device):
    """The process group --mesh-shape trains on: the initialized one,
    else one from torchrun's env:// variables (nccl for the card, each
    rank on its LOCAL_RANK's device; gloo for the CPU). Returns (device,
    whether this call initialized it)."""
    import torch.distributed as dist
    if dist.is_initialized():
        return device, False
    missing = [v for v in TORCHRUN_VARS if v not in os.environ]
    if missing:
        raise RuntimeError(
            f"--mesh-shape needs a torch.distributed world: run under "
            f"torchrun (its env:// variables {', '.join(missing)} are not "
            f"set) or initialize a process group first")
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            init_method="env://")
    return device, True


def _mesh_parallel(mesh_shape: str):
    """`make_parallel(mesh, "train", seq_shard=False)` over a mesh of
    `mesh_shape` ("2,4": ("data", "model"); "2,2,2": ("pod", "data",
    "model")) on the initialized process group."""
    from repro_torch.launch.mesh import make_mesh
    shape = tuple(int(x) for x in mesh_shape.split(","))
    axes = ("data", "model") if len(shape) == 2 else (
        "pod", "data", "model")
    return make_parallel(make_mesh(shape, axes), "train", seq_shard=False)


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    if not args.mesh_shape:
        return _train(args, device, None)
    import torch.distributed as dist
    device, owned = _world(device)
    try:
        return _train(args, device, _mesh_parallel(args.mesh_shape))
    finally:
        if owned:
            dist.destroy_process_group()


def _train(args, device, parallel):
    """The launcher's loop on one device (parallel None) or on this
    rank's shards. Returns the final state (this rank's shards)."""
    cfg, opt, step_fn = build(args, parallel)
    lead = True
    specs = None
    if parallel is not None:
        import torch.distributed as dist
        lead = dist.get_rank() == 0
        specs = tree_specs(train_state_logical_axes(cfg, opt), parallel,
                           cfg)
    mgr = CheckpointManager(args.ckpt, save_interval=args.save_interval) \
        if args.ckpt else None
    start = 0
    # Under a mesh, each rank builds or reads only its shards: the whole
    # state is cut one leaf at a time, as it is drawn or read.
    if mgr and mgr.latest_step() is not None:
        # Restore into a "meta" copy of the state's structure, so no
        # fresh state is built first.
        state, manifest = mgr.restore_latest(
            abstract_train_state(cfg, opt), device=device, specs=specs,
            parallel=parallel)
        start = manifest["step"]
        if lead:
            print(f"resumed from step {start}")
    else:
        state = init_train_state(cfg, opt, seed=0, device=device,
                                 parallel=parallel)

    source = (MarkovLMTask(vocab=cfg.vocab) if args.data == "markov"
              else ByteCorpus("src"))
    it = DataIterator(source, batch=args.batch, seq=args.seq, step=start)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    where = "" if parallel is None else (
        f", mesh {args.mesh_shape} over {parallel.num_devices} ranks")
    t0 = time.perf_counter()
    for d in it:
        state, m = step_fn(state, {
            "inputs": torch.as_tensor(d["inputs"], device=device),
            "labels": torch.as_tensor(d["labels"], device=device)})
        s = int(state["step"])
        if mgr and s % mgr.save_interval == 0:
            # Rank 0 writes the whole state, gathered a leaf at a time
            # to the host.
            whole = state if parallel is None else gather_tree(
                state, specs, parallel, device="cpu", keep=lead)
            if lead:
                mgr.save(whole, s)
            del whole
            if parallel is not None:
                dist.barrier()
        if lead and (s % 20 == 0 or s >= args.steps):
            dt = (time.perf_counter() - t0) * 1000 / max(s - start, 1)
            print(f"step {s:5d} loss {float(m['loss']):.4f} "
                  f"({dt:.0f} ms/step, device={name}{where})", flush=True)
        if s >= args.steps:
            break
    if lead:
        print("done")
    return state


if __name__ == "__main__":
    main()
