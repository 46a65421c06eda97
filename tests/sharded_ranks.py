"""The rank side of tests/test_torch_sharded_exec.py,
tests/test_torch_sharded_blocks.py and tests/test_torch_sharded_train.py:
what each gloo rank runs, in a module that imports no jax (each spawned
rank imports it by name, and the reference's outputs reach it as numpy
arrays).

Every rank writes its results (each check's largest error relative to
max|reference|, and counters) to rank<r>.json in the run's directory."""

import json
import os
import pickle
import shutil
import time

import numpy as np
import torch
import torch.multiprocessing as mp

from repro_torch.models import from_jax
from repro_torch.serving.engine import InferenceEngine

B, T, STEPS, MAX_SEQ = 4, 12, 16, 32
LENGTHS = np.array([12, 9, 5, 12])          # left-padded rows
SPAWN_TIMEOUT = 120
# The train cases' optimizers: mixed_precision over a constant lr.
TRAIN_LR = {"adamw": 1e-3, "adafactor": 1e-2}
TRAIN_STEPS = 3


def train_optimizer(M, name):
    """The same optimizer from either package's optim module M."""
    sched = M.constant_schedule(TRAIN_LR[name])
    return M.mixed_precision(M.adamw(sched) if name == "adamw"
                             else M.adafactor(sched))


def drive_engine(eng, prompts, row, toks):
    """A left-padded group prefill, 3 decode steps, a backfill into slot
    1, 3 more decode steps. row None (a recurrent pattern, which takes
    no padding and no backfill): an unpadded prefill and the 6 decode
    steps."""
    if row is None:
        out = {"prefill": eng.run_prefill(prompts)}
        out["decode"] = np.stack([eng.run_decode(t) for t in toks])
        return out
    out = {"prefill": eng.run_prefill(prompts, lengths=LENGTHS)}
    dec = [eng.run_decode(toks[i]) for i in range(3)]
    out["backfill"] = eng.prefill_row(row, 1, length=6)
    dec += [eng.run_decode(toks[i]) for i in range(3, 6)]
    out["decode"] = np.stack(dec)
    return out


def all_gather_leaf(shard, spec, par):
    """The full tensor on every rank from each rank's `shard_leaf` shard
    (one all-gather over the world)."""
    import torch.distributed as dist
    from repro_torch.sharding import gather_leaf
    parts = [torch.empty_like(shard) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, shard.contiguous())
    # parts[r] is global rank r's shard; mesh.mesh holds the rank at each
    # coordinate.
    shape = tuple(par.mesh.shape)
    shards = {tuple(int(c) for c in np.unravel_index(i, shape)): parts[r]
              for i, r in enumerate(par.mesh.mesh.reshape(-1).tolist())}
    return gather_leaf(shards, spec, par.sizes)


def _err(got, want):
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    return float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))


def _rank_model_case(case, par, out):
    from repro_torch.models import flash_decode
    from repro_torch.models.model import cache_specs, decode_step, forward
    from repro_torch.models.model import prefill
    from repro_torch.models.params import shard_params
    cfg = case["cfg"]
    params = shard_params(from_jax(case["params"], device="cpu"), cfg, par)
    x = torch.from_numpy(case["tokens"])
    vf = None if case["vf"] is None else torch.from_numpy(case["vf"])
    calls = [0]
    real = flash_decode.flash_decode_sharded

    def counted(*a, **k):
        calls[0] += 1
        return real(*a, **k)
    flash_decode.flash_decode_sharded = counted
    try:
        res = {}
        with torch.no_grad():
            fwd, _ = forward(params, x[:, :T], cfg, parallel=par)
            res["forward"] = _err(fwd, case["forward"])
            pre, cache = prefill(params, x[:, :T], cfg, MAX_SEQ,
                                 parallel=par, valid_from=vf)
            res["prefill"] = _err(pre, case["prefill"])
            specs = cache_specs(cfg, B, MAX_SEQ, par)
            cerr, pos_equal = 0.0, True
            for got, spec, want in zip(_leaves(cache), _leaves(specs),
                                       _leaves(case["cache"]), strict=True):
                full = all_gather_leaf(got, spec, par).numpy()
                assert full.shape == want.shape, (full.shape, want.shape)
                if full.dtype == np.int32:
                    pos_equal &= bool(np.array_equal(full, want))
                else:
                    cerr = max(cerr, _err(full, want))
            res["cache"] = cerr
            res["cache_pos_equal"] = pos_equal
            dec = []
            for i in range(STEPS):
                lg, cache = decode_step(params, x[:, T + i:T + i + 1], cache,
                                        T + i, cfg, parallel=par,
                                        valid_from=vf)
                dec.append(lg[:, 0].numpy())
            res["decode"] = _err(np.stack(dec, 1), case["decode"])
    finally:
        flash_decode.flash_decode_sharded = real
    res["flash_decode_calls"] = calls[0]
    res["n_layers"] = cfg.n_layers
    out[case["name"]] = res


def _leaves(tree):
    """Leaves with dict keys sorted; a Spec (a tuple) is one leaf."""
    from repro_torch.sharding import Spec
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)) and not isinstance(tree, Spec):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def _rank_ffn_case(case, par, out):
    """`moe_ffn_sharded` alone on this rank's expert shards (cut by
    `moe_weight_specs`) and its batch rows (the whole batch where it
    does not divide the data axes), its output gathered over data,
    against the case's oracle: the largest error relative to
    max|oracle|, and the aux loss's absolute error."""
    import dataclasses
    from repro_torch.models.moe import moe_ffn_sharded, moe_weight_specs
    from repro_torch.sharding import all_gather, shard_leaf
    cfg = case["cfg"]
    w_in, w_out = moe_weight_specs(case["moe_mode"], par.tp_axis,
                                   par.fsdp_axes)
    spec = {"w_gate": w_in, "w_up": w_in, "w_down": w_out}
    p = {k: shard_leaf(torch.from_numpy(v), spec[k], par.sizes,
                       par.coords()) if k in spec else torch.from_numpy(v)
         for k, v in case["params"].items()}
    x = torch.from_numpy(case["x"])
    B = x.shape[0]
    if par.data_ok(B):
        Bl = B // par.dp_size
        d = par.index(par.data_axes)
        x = x[d * Bl:(d + 1) * Bl]
    else:
        par = dataclasses.replace(par, data_axes=())
    with torch.no_grad():
        y, aux = moe_ffn_sharded(p, x, cfg, par)
        if par.data_axes:
            y = all_gather(y, par, par.data_axes, 0)
    out[case["name"]] = {"out": _err(y, case["want"]),
                         "aux": abs(float(aux) - case["aux"])}


def _rank_engine_case(case, par, out):
    from repro_torch.models.params import shard_params
    cfg = case["cfg"]
    params = shard_params(from_jax(case["params"], device="cpu"), cfg, par)
    eng = InferenceEngine(cfg, params, batch_size=B, max_seq=MAX_SEQ,
                          device="cpu", parallel=par)
    got = drive_engine(eng, case["prompts"], case["row"], case["toks"])
    out[case["name"]] = {k: _err(got[k], case["want"][k]) for k in got}
    out[case["name"]]["embed_whole"] = (eng.params["embed"].shape[1]
                                        == cfg.d_model)


def _leaf_errs(got_tree, want_tree, scale):
    """Per leaf pair (the torch tree's leaves against the numpy tree's,
    both in sorted-key order), max|got - want| / scale(want)."""
    from repro_torch.models.params import tree_leaves_sorted
    got, want = tree_leaves_sorted(got_tree), tree_leaves_sorted(want_tree)
    assert len(got) == len(want), (len(got), len(want))
    out = []
    for g, w in zip(got, want):
        g = g.detach().double().numpy()
        w = np.asarray(w, np.float64)
        assert g.shape == w.shape, (g.shape, w.shape)
        out.append(float(np.abs(g - w).max() / scale(w)))
    return out


def _rank_train_case(case, par, out):
    """The train profile on this rank's shards of the reference's
    weights: the synced grads of the first batch gathered against the
    reference's (each leaf's error relative to its max|grad|), then
    TRAIN_STEPS steps of `make_train_step(parallel=)`: each step's loss
    and grad_norm (relative errors), the state's local shapes and step,
    and the gathered params against the reference's (in units of lr)."""
    from repro_torch.models.params import tree_leaves_sorted
    from repro_torch.sharding import (gather_tree, local_shape, shard_tree,
                                      tree_specs)
    from repro_torch.training import optim as TO
    from repro_torch.training.step import (abstract_train_state,
                                           make_grad_fn, make_train_step,
                                           train_state_logical_axes)
    cfg, want = case["cfg"], case["want"]
    opt = train_optimizer(TO, case["opt"])
    params = from_jax(case["params"], device="cpu")
    specs = tree_specs(train_state_logical_axes(cfg, opt), par, cfg)
    state = shard_tree({"params": params, "opt": opt.init(params),
                        "step": torch.zeros((), dtype=torch.int32)},
                       specs, par)
    del params
    batches = [{k: torch.from_numpy(v) for k, v in b.items()}
               for b in case["batches"]]
    res = {}
    aux_weight = case["aux_weight"]
    _, grads = make_grad_fn(cfg, aux_weight, parallel=par)(
        state["params"], batches[0])
    res["grad"] = max(_leaf_errs(gather_tree(grads, specs["params"], par),
                                 want["grads"],
                                 lambda w: max(np.abs(w).max(), 1e-30)))
    step = make_train_step(cfg, opt, aux_weight, parallel=par)
    losses, norms = [], []
    for b in batches:
        state, m = step(state, b)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]) if "grad_norm" in m else None)
    res["loss"] = max(abs(a / b - 1) for a, b in zip(losses,
                                                      want["losses"]))
    if want["grad_norms"] is not None:
        res["grad_norm"] = max(abs(a / b - 1) for a, b in zip(
            norms, want["grad_norms"]))
    full = tree_leaves_sorted(abstract_train_state(cfg, opt))
    res["local_shapes"] = all(
        tuple(x.shape) == local_shape(tuple(f.shape), spec, par.sizes)
        for x, f, spec in zip(tree_leaves_sorted(state), full,
                              _leaves(specs), strict=True))
    res["step"] = int(state["step"])
    lr = TRAIN_LR[case["opt"]]
    whole = gather_tree(state["params"], specs["params"], par)
    res["param_lr"] = max(_leaf_errs(whole, want["params"], lambda w: lr))
    res["port_lr"] = case["port_lr"]
    out[case["name"]] = res


def _rank_levers_case(case, mesh, out):
    """forward under ParallelConfigs of the train profile and its levers
    (case["levers"]: ParallelConfig fields), on this rank's shards,
    against the case's unsharded forward: the serve profile's logits
    are the whole batch's, the train profile's this data rank's rows."""
    from repro_torch.models.model import data_rows, forward
    from repro_torch.models.params import shard_params
    from repro_torch.sharding import ParallelConfig
    cfg = case["cfg"]
    full = from_jax(case["params"], device="cpu")
    x = torch.from_numpy(case["tokens"])[:, :T]
    res = {}
    for i, kw in enumerate(case["levers"]):
        par = ParallelConfig(mesh=mesh, data_axes=("data",), **kw)
        want = case["forward"]
        if par.profile == "train":
            want = want[data_rows(par, B)]
        with torch.no_grad():
            got, _ = forward(shard_params(full, cfg, par), x, cfg,
                             parallel=par)
        res[str(i)] = _err(got, want)
    out[case["name"]] = res


def _rank_launcher(case, rank, world, out_dir):
    """The launcher under torchrun's env:// variables on this rank (the
    test's own process group destroyed first): `--mesh-shape` for the
    whole run with a checkpoint every few steps; with c["resume"], the
    last checkpoint removed and the same command again (it resumes from
    the one before). Writes to <name>_rank<r>.pkl: whether the two
    runs' final shards are equal bit for bit (True without a resume),
    the last step, the last loss the run printed (rank 0; None on the
    others), whether every float shard is finite, and this rank's
    coordinates and final shards (numpy, for the test to hold against
    the checkpoint restored unsharded)."""
    import contextlib
    import io
    from repro_torch.launch import train as launcher
    from repro_torch.models.params import tree_leaves_sorted, tree_map
    c = case["launcher"]
    os.environ.update(MASTER_ADDR="localhost", WORLD_SIZE=str(world),
                      RANK=str(rank), LOCAL_RANK=str(rank))
    os.environ["MASTER_PORT"] = str(c["ports"][0])
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        straight = launcher.main(c["args"])
    resumed = straight
    if c.get("resume", True):
        if rank == 0:
            shutil.rmtree(os.path.join(c["ckpt"], f"step_{c['last']:08d}"))
        # The next run's rendezvous waits for rank 0, so no rank looks
        # for the latest checkpoint before it is gone.
        os.environ["MASTER_PORT"] = str(c["ports"][1])
        resumed = launcher.main(c["args"])
    losses = [float(w[w.index("loss") + 1]) for w in (
        line.split() for line in printed.getvalue().splitlines())
        if "loss" in w]
    coords = np.unravel_index(rank, c["shape"])
    leaves = tree_leaves_sorted(resumed)
    name = case.get("name", "launcher")
    with open(os.path.join(out_dir, f"{name}_rank{rank}.pkl"), "wb") as f:
        pickle.dump({
            "equal": all(torch.equal(a, b) for a, b in zip(
                tree_leaves_sorted(straight), leaves, strict=True)),
            "step": int(resumed["step"]),
            "loss": losses[-1] if losses else None,
            "finite": all(bool(torch.isfinite(t).all()) for t in leaves
                          if t.is_floating_point()),
            "coords": dict(zip(c["axes"], (int(i) for i in coords))),
            "state": tree_map(lambda t: t.numpy(), resumed)}, f)


def _rank_main(rank, world, init_file, out_dir, shape):
    torch.set_num_threads(1)
    with open(os.path.join(out_dir, "cases.pkl"), "rb") as f:
        cases = pickle.load(f)
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.sharding import make_parallel
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    try:
        out = {}
        try:
            make_mesh((world, 2), ("data", "model"))
            out["make_mesh_raises"] = False
        except ValueError:
            out["make_mesh_raises"] = True
        # A case may name another mesh over the same ranks: (pod, data,
        # model) of the same world.
        meshes = {shape: make_mesh(shape, ("data", "model"))}
        for case in cases:
            if "launcher" in case:
                continue
            cs = tuple(case.get("mesh", shape))
            if cs not in meshes:
                meshes[cs] = make_mesh(cs, ("pod", "data", "model"))
            if "train" in case:
                _rank_train_case(case, make_parallel(
                    meshes[cs], "train", **case["train"]), out)
                continue
            if "levers" in case:
                _rank_levers_case(case, meshes[cs], out)
                continue
            par = make_parallel(meshes[cs], "serve",
                                moe_mode=case.get("moe_mode", "auto"))
            if "prompts" in case:
                _rank_engine_case(case, par, out)
            elif "x" in case:
                _rank_ffn_case(case, par, out)
            else:
                _rank_model_case(case, par, out)
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()
    for case in cases:
        if "launcher" in case:
            _rank_launcher(case, rank, world, out_dir)


class Ranks:
    """prod(shape) gloo ranks started on every case (they run while the
    caller goes on); `results()` waits for them (at most SPAWN_TIMEOUT
    seconds, then they are terminated) and returns each rank's
    results."""

    def __init__(self, tmp_path, shape, cases):
        self.tmp_path, self.shape = tmp_path, shape
        self.world = int(np.prod(shape))
        # The cases go through a file: as spawn arguments they would be
        # written down each rank's pipe, and each start would wait for
        # its rank to import torch and read them.
        with open(tmp_path / "cases.pkl", "wb") as f:
            pickle.dump(cases, f)
        self.ctx = mp.start_processes(
            _rank_main, args=(self.world, str(tmp_path / "pg_init"),
                              str(tmp_path), shape),
            nprocs=self.world, join=False, start_method="spawn")
        self.deadline = time.monotonic() + SPAWN_TIMEOUT

    def results(self):
        try:
            while not self.ctx.join(timeout=1.0):
                if time.monotonic() > self.deadline:
                    raise TimeoutError(f"ranks of mesh {self.shape} still "
                                       f"running after {SPAWN_TIMEOUT} s")
        finally:
            for p in self.ctx.processes:
                if p.is_alive():
                    p.terminate()
                    p.join(5)
        results = []
        for r in range(self.world):
            with open(self.tmp_path / f"rank{r}.json") as f:
                results.append(json.load(f))
        return results
