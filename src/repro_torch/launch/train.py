"""Training launcher, on one device: the card by default, the CPU with
``--device cpu``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-1.6b \\
        --reduced --steps 100 --ckpt /tmp/ckpt --device cpu

Real optimizer steps (AdamW or Adafactor under `mixed_precision`, a
cosine schedule), Markov or byte data, a checkpoint every
``--save-interval`` steps and resume from the latest committed one.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.data import ByteCorpus, DataIterator, MarkovLMTask
from repro_torch.models.params import tree_map
from repro_torch.training.checkpoint import CheckpointManager
from repro_torch.training.optim import (adafactor, adamw, cosine_schedule,
                                        mixed_precision)
from repro_torch.training.step import init_train_state, make_train_step
from repro_torch.utils import resolve_device


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


def build(args):
    """(cfg, optimizer, train step) as the launcher trains them: the
    arch's config (reduced with --reduced) with fp32 params, the
    optimizer of `make_optimizer`."""
    if args.mesh_shape:
        raise NotImplementedError(
            "--mesh-shape: sharded training (the train profile: FSDP, "
            "seq_shard) is not ported yet (ROADMAP queue 1 item 3.3); "
            "this launcher trains on one device")
    cfg = (reduced_config(args.arch) if args.reduced
           else get_config(args.arch))
    opt = make_optimizer(args.optimizer, args.lr, args.steps)
    cfg = cfg.with_runtime(param_dtype="float32")
    return cfg, opt, make_train_step(cfg, opt)


def main(argv=None):
    args = parse_args(argv)
    cfg, opt, step_fn = build(args)
    device = resolve_device(args.device)
    state = init_train_state(cfg, opt, seed=0, device=device)
    mgr = CheckpointManager(args.ckpt, save_interval=args.save_interval) \
        if args.ckpt else None
    start = 0
    if mgr and mgr.latest_step() is not None:
        # Restore into a "meta" copy of the state's structure, so the
        # fresh state is freed before the checkpoint's is loaded.
        target = tree_map(lambda t: t.to("meta"), state)
        del state
        state, manifest = mgr.restore_latest(target, device=device)
        start = manifest["step"]
        print(f"resumed from step {start}")

    source = (MarkovLMTask(vocab=cfg.vocab) if args.data == "markov"
              else ByteCorpus("src"))
    it = DataIterator(source, batch=args.batch, seq=args.seq, step=start)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    t0 = time.perf_counter()
    for d in it:
        state, m = step_fn(state, {
            "inputs": torch.as_tensor(d["inputs"], device=device),
            "labels": torch.as_tensor(d["labels"], device=device)})
        s = int(state["step"])
        if mgr:
            mgr.maybe_save(state, s)
        if s % 20 == 0 or s >= args.steps:
            dt = (time.perf_counter() - t0) * 1000 / max(s - start, 1)
            print(f"step {s:5d} loss {float(m['loss']):.4f} "
                  f"({dt:.0f} ms/step, device={name})", flush=True)
        if s >= args.steps:
            break
    print("done")
    return state


if __name__ == "__main__":
    main()
