"""The rank side of tests/test_torch_sharded_exec.py and
tests/test_torch_sharded_blocks.py: what each gloo rank runs, in a
module that imports no jax (each spawned rank imports it by name, and
the reference's outputs reach it as numpy arrays).

Every rank writes its results (each check's largest error relative to
max|reference|, and counters) to rank<r>.json in the run's directory."""

import json
import os
import pickle
import time

import numpy as np
import torch
import torch.multiprocessing as mp

from repro_torch.models import from_jax
from repro_torch.serving.engine import InferenceEngine

B, T, STEPS, MAX_SEQ = 4, 12, 16, 32
LENGTHS = np.array([12, 9, 5, 12])          # left-padded rows
SPAWN_TIMEOUT = 120


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
            cs = tuple(case.get("mesh", shape))
            if cs not in meshes:
                meshes[cs] = make_mesh(cs, ("pod", "data", "model"))
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
