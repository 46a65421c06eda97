"""Fault-tolerant checkpoints, in the reference's on-disk format, so a
checkpoint written by either package restores in the other.

Layout per step:  <dir>/step_<N>/
    manifest.json      step, leaf count, structure fingerprint, extra
    shard_<host>.npz   this host's arrays as leaf_<i>, the leaves in
                       `jax.tree.flatten`'s order (dict keys sorted)
    _COMMITTED         sentinel written LAST (after an atomic rename):
                       restore ignores a step without it, so a crash
                       mid-write is never restored from.

The fingerprint hashes each leaf's shape and numpy dtype name
("float32", not "torch.float32"). bfloat16 leaves are stored as the
reference's numpy stores them: two raw bytes an element ("V2").

CheckpointManager: retention (keep_n), save interval, the latest
committed step, resume."""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import tempfile
from typing import Optional

import numpy as np
import torch

from repro_torch.models.params import (Packed, tree_leaves_sorted, tree_map,
                                       tree_unflatten_sorted)
from repro_torch.sharding import shard_leaf
from repro_torch.utils import resolve_device


def _dtype_name(t) -> str:
    return str(t.dtype).removeprefix("torch.")


def tree_fingerprint(tree) -> str:
    spec = [(list(x.shape), _dtype_name(x)) for x in tree_leaves_sorted(tree)]
    return hashlib.sha256(json.dumps(spec).encode()).hexdigest()[:16]


def _to_numpy(t):
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def _to_torch(arr, ref, device):
    if ref.dtype == torch.bfloat16 and arr.dtype == np.dtype("V2"):
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device=device, dtype=ref.dtype)


def save_checkpoint(path: str, state, *, step: int, host: int = 0,
                    extra: Optional[dict] = None):
    """Atomic: write into a temp dir, rename it into place, then commit
    marker."""
    os.makedirs(path, exist_ok=True)
    step_dir = os.path.join(path, f"step_{step:08d}")
    tmp = tempfile.mkdtemp(prefix=".ckpt_tmp_", dir=path)
    try:
        leaves = tree_leaves_sorted(state)
        arrs = {f"leaf_{i}": _to_numpy(x) for i, x in enumerate(leaves)}
        np.savez(os.path.join(tmp, f"shard_{host}.npz"), **arrs)
        del arrs
        manifest = {
            "step": step,
            "n_leaves": len(leaves),
            "fingerprint": tree_fingerprint(state),
            "extra": extra or {},
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(step_dir):
            shutil.rmtree(step_dir)
        os.rename(tmp, step_dir)
        # Commit marker written last: restore treats its absence as a
        # torn write and skips the checkpoint.
        with open(os.path.join(step_dir, "_COMMITTED"), "w") as f:
            f.write("ok")
    finally:
        if os.path.exists(tmp):
            shutil.rmtree(tmp, ignore_errors=True)
    return step_dir


def committed_steps(path: str):
    if not os.path.isdir(path):
        return []
    out = []
    for d in sorted(os.listdir(path)):
        if d.startswith("step_") and os.path.exists(
                os.path.join(path, d, "_COMMITTED")):
            out.append(int(d.split("_")[1]))
    return out


def restore_checkpoint(path: str, target_state, *, step: Optional[int] = None,
                       host: int = 0, device=None, specs=None, parallel=None):
    """Restore into the structure, shapes and dtypes of `target_state`,
    concrete or on the "meta" device. Each leaf lands on `device` if
    given, else on its target leaf's device; a meta target's leaves on
    the card. specs (the target's Spec tree) and parallel: this rank's
    shards, each leaf read whole to the host, one at a time, and only
    its shard moved to the device."""
    steps = committed_steps(path)
    if not steps:
        raise FileNotFoundError(f"no committed checkpoints under {path}")
    step = steps[-1] if step is None else step
    step_dir = os.path.join(path, f"step_{step:08d}")
    with open(os.path.join(step_dir, "manifest.json")) as f:
        manifest = json.load(f)
    if manifest["fingerprint"] != tree_fingerprint(target_state):
        raise ValueError(
            "checkpoint/model structure mismatch: "
            f"{manifest['fingerprint']} vs {tree_fingerprint(target_state)}")
    refs = tree_leaves_sorted(target_state)
    cuts = [None] * len(refs) if specs is None else [
        pk.vals[1] for pk in tree_leaves_sorted(
            tree_map(Packed, target_state, specs))]
    leaves = []
    with np.load(os.path.join(step_dir, f"shard_{host}.npz")) as data:
        for i, (ref, spec) in enumerate(zip(refs, cuts, strict=True)):
            dev = resolve_device(device if device is not None else (
                "cuda" if ref.device.type == "meta" else ref.device))
            if spec is None:
                leaves.append(_to_torch(data[f"leaf_{i}"], ref, dev))
                continue
            whole = _to_torch(data[f"leaf_{i}"], ref, torch.device("cpu"))
            leaves.append(shard_leaf(whole, spec, parallel.sizes,
                                     parallel.coords()).to(dev))
    return tree_unflatten_sorted(target_state, leaves), manifest


class CheckpointManager:
    def __init__(self, path: str, *, keep_n: int = 3, save_interval: int = 50):
        self.path = path
        self.keep_n = keep_n
        self.save_interval = save_interval
        os.makedirs(path, exist_ok=True)

    def maybe_save(self, state, step: int, **kw) -> Optional[str]:
        if step % self.save_interval != 0:
            return None
        return self.save(state, step, **kw)

    def save(self, state, step: int, **kw) -> str:
        out = save_checkpoint(self.path, state, step=step, **kw)
        self._gc()
        return out

    def _gc(self):
        steps = committed_steps(self.path)
        for s in steps[:-self.keep_n]:
            shutil.rmtree(os.path.join(self.path, f"step_{s:08d}"),
                          ignore_errors=True)

    def latest_step(self) -> Optional[int]:
        steps = committed_steps(self.path)
        return steps[-1] if steps else None

    def restore_latest(self, target_state, **kw):
        return restore_checkpoint(self.path, target_state, **kw)
