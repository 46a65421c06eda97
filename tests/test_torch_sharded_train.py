"""The port's train profile on gloo ranks on the CPU, held against the
reference's UNSHARDED jitted train step (the reference's own sharded
train step, its tests/test_sharded_exec.py `TRAIN_OK`, cannot be the
oracle: under jax 0.9.0 that program fails before it gets there).

Two spawns of ranks (tests/sharded_ranks.py, which imports no jax), one
module-scoped fixture: 8 ranks run meshes (2, 4) and (2, 2, 2) while
this process computes the (2, 2) cases' references; 4 ranks run mesh
(2, 2) and then the launcher.

- Each train case: fp32 weights through `from_jax`, the whole train
  state cut by
  `tree_specs(train_state_logical_axes(...))` (`sharding.shard_tree`);
  Markov batches of B = 8 (musicgen and chameleon take embeddings:
  normal draws); `make_grad_fn(parallel=)`'s synced grads of the first
  batch gathered back; then 3 steps of `make_train_step(parallel=)`
  under mixed_precision(adamw(1e-3)) or mixed_precision(adafactor(
  1e-2)): each step's loss and grad_norm, the state's local shard
  shapes, its step, and its gathered params.
- Mesh (2, 2) ("data", "model"): stablelm-1.6b reduced (untied, partial
  rotary) with seq_shard off, "full" and "carry", attn_pin, T = 15
  (the residual stays whole), remat="block", Adafactor; the other
  attention-only configs (deepseek-coder-33b, musicgen-large,
  chameleon-34b: qk norm) at the defaults (seq_shard "full").
- Mesh (2, 4): yi-9b reduced, where its 2 kv heads do not divide the
  model axis (wk / wv replicated over model, each rank's q group's kv
  heads), AdamW and Adafactor.
- Mesh (2, 2, 2) ("pod", "data", "model"): gemma2-9b reduced (tied
  table, softcaps, local / global, sandwich norms, embed scale) with
  the reference's `TRAIN_OK` settings: B = 8, T = 16, the default
  seq_shard.
- The launcher: `--mesh-shape 2,2 --reduced --device cpu` on the 4
  ranks through torchrun's env:// variables, 6 steps with a checkpoint
  every 3; then with step 6's checkpoint removed, the same command
  again: it resumes at 3 and ends on the straight run's shards bit for
  bit, and the checkpoint it writes restores in the unsharded port
  with every rank's shards in it.
- No mesh: `train_state_logical_axes`, `abstract_train_state`'s shapes
  and dtypes and each optimizer's `state_logical_axes` against the
  reference's trees.

Weights: the port's `init_params`, handed to the reference as numpy
arrays and to the ranks through `from_jax`, as in
tests/test_torch_training.py, whose tolerances were set on them. The
reference's own init scales a stacked leaf by the group count (its fan
is the stacked axis), which saturates units of the reduced models: on
those weights the UNSHARDED port itself is off the reference by up to
1.24e-4 of max|grad| (deepseek-coder) and 0.30 lr in the params after 3
AdamW steps (stablelm, T = 15), elements whose gradients sit near Adam's
eps; measured when this file was written.

Tolerances (tests/test_torch_training.py's): the loss within 2e-5
relative at each step, grad_norm within 1e-5 relative, every gathered
grad leaf within 1e-4 of its max|reference grad|, AdamW's params after
3 steps within 0.05 lr (Adam's m / sqrt(v) moves an element by about
lr whatever its gradient's size, so an element whose gradient is near
its rounding moves by another fraction of lr). Adafactor's params
within 0.005 lr, derived the same way: its update lr * scale * u has u
= g / sqrt(v_row v_col / mean v_row), linear in g with v from means
over whole rows and columns, clipped to RMS 1; so a grad error of 1e-4
of max|g| moves an element by about 1e-4 * lr * scale * max|u| a step,
with scale (the leaf's RMS, at least 1e-3) under 1.5 and max|u| under
10 here: 3 steps stay under 0.005 lr.
The 0.05 lr of AdamW rests on no element's gradient sitting within a
few bits of eps (1e-8). On three of these cases it does, and the port's
UNSHARDED steps on the same weights and batches are themselves further
from the reference (measured when this file was written: gemma2 0.1214
lr, stablelm at T = 15 0.0703, deepseek 0.0661; the sharded steps
0.0886, 0.0244, 0.0485). Each case's unsharded distance is computed
here (`port_lr`), and the sharded params are held within the tolerance
or, where that distance exceeds it, within twice the distance: both
runs round independently of the reference, each landing on either side
of it, so the sharded run can be as far again as the unsharded one.
"""

import contextlib
import pickle
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jax_reduced_config
from repro.training import optim as JO
from repro.training import step as JS
from repro_torch.configs import reduced_config
from repro_torch.data import MarkovLMTask
from repro_torch.launch.train import make_optimizer, parse_args
from repro_torch.models import init_params
from repro_torch.models.params import tree_leaves_sorted, tree_map
from repro_torch.models import model as TM
from repro_torch.sharding import (entry_axes, is_axes_leaf, make_parallel,
                                  make_rules, shard_leaf, shard_tree,
                                  tree_specs)
from repro_torch.training import checkpoint as TC
from repro_torch.training import optim as TO
from repro_torch.training import step as TS
from sharded_ranks import (TRAIN_LR, TRAIN_STEPS, Ranks, _leaf_errs,
                           _leaves, train_optimizer)

LOSS_RTOL = 2e-5
GN_RTOL = 1e-5
GRAD_TOL = 1e-4
PARAM_LR_TOL = {"adamw": 0.05, "adafactor": 0.005}
B, T = 8, 16
LAUNCH_ARGS = ["--reduced", "--device", "cpu", "--mesh-shape", "2,2",
               "--batch", "4", "--seq", "8", "--steps", "6",
               "--save-interval", "3", "--lr", "3e-3"]


def _batches(cfg, seed, T):
    """TRAIN_STEPS Markov batches (B, T); embeddings inputs for the
    embedding-input configs (normal draws, the Markov labels)."""
    out = []
    for i in range(TRAIN_STEPS):
        b = MarkovLMTask(vocab=cfg.vocab, seed=seed).batch(i, B, T)
        if cfg.input_mode == "embeddings":
            rng = np.random.default_rng(seed * 100 + i)
            b["inputs"] = rng.standard_normal(
                (B, T, cfg.d_model)).astype(np.float32)
        out.append(b)
    return out


def _reference(arch, seed, opt="adamw", T=T, tweak=None, aux_weight=0.01,
               aux_shards=1):
    """The weights (the port's `init_params`, numpy), batches and the
    reference's unsharded jitted train step on them: the first batch's
    grads, each step's loss and grad_norm, the params after TRAIN_STEPS
    steps (numpy). tweak: a function of a config applied to both
    packages' reduced configs; aux_weight: the MoE load-balance term's
    weight; aux_shards > 1: that term is the mean over that many row
    blocks of the batch of each block's loss (`_shard_aux`)."""
    jcfg = _tweaked(jax_reduced_config(arch), tweak).with_runtime(
        param_dtype="float32")
    tcfg = _tweaked(reduced_config(arch), tweak).with_runtime(
        param_dtype="float32")
    jopt = train_optimizer(JO, opt)
    params = tree_map(lambda t: t.numpy(), init_params(tcfg, seed,
                                                       device="cpu"))
    jp = jax.tree.map(jnp.asarray, params)
    batches = _batches(jcfg, seed, T)
    with _shard_aux(aux_shards):
        train_step = JS.make_train_step(jcfg, jopt, aux_weight=aux_weight)
        loss_fn = JS.make_loss_fn(jcfg, aux_weight=aux_weight)

        @jax.jit
        def run(state, b):
            grads = jax.grad(lambda p: loss_fn(p, b)[0])(state["params"])
            state, m = train_step(state, b)
            return grads, state, m
        state = {"params": jp, "opt": jopt.init(jp),
                 "step": jnp.zeros((), jnp.int32)}
        losses, norms = [], []
        for i, b in enumerate(batches):
            g, state, m = run(state, {k: jnp.asarray(v)
                                      for k, v in b.items()})
            if i == 0:
                grads = jax.tree.map(np.asarray, g)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]) if "grad_norm" in m
                         else None)
        want = jax.tree.map(np.asarray, state["params"])
        port = _unsharded_port(tcfg, opt, params, batches, aux_weight)
    return dict(params=params, batches=batches,
                want=dict(grads=grads, losses=losses,
                          grad_norms=None if opt != "adamw" else norms,
                          params=want),
                port_lr=max(_leaf_errs(
                    tree_map(torch.from_numpy, port), want,
                    lambda w: TRAIN_LR[opt])))


def _tweaked(cfg, tweak):
    return cfg if tweak is None else tweak(cfg)


@contextlib.contextmanager
def _shard_aux(n):
    """Both packages' `models.model.moe_block_ffn` (in this process
    only) as the dense FFN whose load-balance loss is the mean over n
    equal row blocks of the batch of each block's loss: the sharded
    train step's term over n data shards (moe_mode ep / tp), which no
    unsharded model computes (f * P is not linear in the rows). n == 1:
    as they are."""
    if n == 1:
        yield
        return
    from repro.models import model as JM
    from repro.models import moe as JMoE
    from repro_torch.models import moe as TMoE

    def jax_ffn(p, x, cfg, parallel=None):
        out, _ = JMoE.moe_ffn_dense(p, x, cfg)
        aux = 0.0
        for xb in jnp.split(x, n, axis=0):
            x2 = xb.reshape(-1, xb.shape[-1])
            vals, idx, probs = JMoE.router_topk(p, x2, cfg)
            comb = jnp.zeros((x2.shape[0], cfg.moe.n_experts),
                             jnp.float32).at[
                jnp.arange(x2.shape[0])[:, None], idx].add(vals)
            aux = aux + JMoE._load_balance_loss(comb, probs,
                                                cfg.moe.n_experts)
        return out, aux / n

    def port_ffn(p, x, cfg, parallel=None):
        out, _ = TMoE.moe_ffn_dense(p, x, cfg)
        aux = 0.0
        for xb in torch.chunk(x, n, dim=0):
            x2 = xb.reshape(-1, xb.shape[-1])
            vals, idx, probs = TMoE.router_topk(p, x2, cfg)
            comb = torch.zeros((x2.shape[0], cfg.moe.n_experts),
                               dtype=torch.float32).scatter_add(1, idx, vals)
            aux = aux + TMoE._load_balance_loss(comb, probs,
                                                cfg.moe.n_experts)
        return out, aux / n
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JM, "moe_block_ffn", jax_ffn)
        mp.setattr(TM, "moe_block_ffn", port_ffn)
        yield


def _unsharded_port(cfg, opt, params, batches, aux_weight=0.01):
    """The port's unsharded TRAIN_STEPS steps of cfg on the same weights
    and batches: its params (numpy)."""
    topt = train_optimizer(TO, opt)
    p = tree_map(torch.from_numpy, params)
    state = {"params": p, "opt": topt.init(p),
             "step": torch.zeros((), dtype=torch.int32)}
    step = TS.make_train_step(cfg, topt, aux_weight=aux_weight)
    for b in batches:
        state, _ = step(state, {k: torch.from_numpy(v)
                                for k, v in b.items()})
    return tree_map(lambda t: t.numpy(), state["params"])


def _case(name, ref, arch, opt="adamw", mesh=None, port_kw=(), tweak=None,
          aux_weight=0.01, **train):
    """A rank case: the port's reduced config (fp32, `tweak` and
    `port_kw` on top), the reference's outputs `ref`, the MoE aux
    term's weight, the train profile's levers `train`."""
    cfg = _tweaked(reduced_config(arch), tweak).with_runtime(
        param_dtype="float32", **dict(port_kw))
    case = dict(name=name, cfg=cfg, opt=opt, train=train,
                aux_weight=aux_weight, **ref)
    if mesh is not None:
        case["mesh"] = mesh
    return case


# name -> (mesh, optimizer)
CASES = {
    "stablelm_off": ((2, 2), "adamw"),
    "stablelm_full": ((2, 2), "adamw"),
    "stablelm_carry": ((2, 2), "adamw"),
    "stablelm_pin": ((2, 2), "adamw"),
    "stablelm_t15": ((2, 2), "adamw"),
    "stablelm_remat": ((2, 2), "adamw"),
    "stablelm_adafactor": ((2, 2), "adafactor"),
    "deepseek": ((2, 2), "adamw"),
    "musicgen": ((2, 2), "adamw"),
    "chameleon": ((2, 2), "adamw"),
    "yi": ((2, 4), "adamw"),
    "yi_adafactor": ((2, 4), "adafactor"),
    "gemma2": ((2, 2, 2), "adamw"),
}


class _FakeMesh:
    """A ("data", "model") mesh's names and shape, no ranks: what the
    rule tables and specs read."""
    mesh_dim_names = ("data", "model")

    def __init__(self, shape, coords=None):
        self.shape = shape
        self._coords = coords

    def get_local_rank(self, axis):
        return self._coords[axis]


def _free_port():
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every rank's results, and the launcher's directory. The 8 ranks
    start as soon as their references are computed."""
    yi = _reference("yi_9b", 1)
    ranks8 = Ranks(tmp_path_factory.mktemp("ranks8"), (2, 4), [
        _case("yi", yi, "yi_9b"),
        _case("yi_adafactor", _reference("yi_9b", 1, "adafactor"), "yi_9b",
              "adafactor"),
        _case("gemma2", _reference("gemma2_9b", 2), "gemma2_9b",
              mesh=(2, 2, 2))])
    launch_dir = tmp_path_factory.mktemp("launcher")
    ckpt = str(launch_dir / "ck")
    stablelm = _reference("stablelm_1_6b", 0)
    ranks4 = Ranks(launch_dir, (2, 2), [
        _case("stablelm_off", stablelm, "stablelm_1_6b", seq_shard=False),
        _case("stablelm_full", stablelm, "stablelm_1_6b", seq_shard=True),
        _case("stablelm_carry", stablelm, "stablelm_1_6b", seq_shard=True,
              seq_mode="carry"),
        _case("stablelm_pin", stablelm, "stablelm_1_6b", attn_pin=True),
        _case("stablelm_t15", _reference("stablelm_1_6b", 0, T=15),
              "stablelm_1_6b", seq_shard=True),
        _case("stablelm_remat", stablelm, "stablelm_1_6b",
              port_kw={"remat": "block"}),
        _case("stablelm_adafactor", _reference("stablelm_1_6b", 0,
                                               "adafactor"),
              "stablelm_1_6b", "adafactor"),
        _case("deepseek", _reference("deepseek_coder_33b", 3),
              "deepseek_coder_33b"),
        _case("musicgen", _reference("musicgen_large", 4),
              "musicgen_large"),
        _case("chameleon", _reference("chameleon_34b", 5), "chameleon_34b"),
        {"launcher": dict(args=LAUNCH_ARGS + ["--ckpt", ckpt], ckpt=ckpt,
                          last=6, shape=(2, 2), axes=("data", "model"),
                          ports=[_free_port(), _free_port()])}])
    out = {}
    for r in (ranks8, ranks4):
        res = r.results()
        for name in res[0]:
            out[name] = [x[name] for x in res]
    return {"cases": out, "launcher": launch_dir}


@pytest.fixture(scope="module")
def cases(runs):
    return runs["cases"]


@pytest.mark.parametrize("name", list(CASES))
def test_loss_matches_unsharded_reference(cases, name):
    """Each of the 3 steps' loss (the mean over the data ranks) within
    2e-5 relative of the reference's, on every rank."""
    for r in cases[name]:
        assert r["loss"] <= LOSS_RTOL, (name, r["loss"])


@pytest.mark.parametrize("name", [n for n, (_, o) in CASES.items()
                                  if o == "adamw"])
def test_grad_norm_matches_unsharded_reference(cases, name):
    """AdamW's grad_norm (its clip's global norm, each leaf's sum of
    squares summed over the axes it is split on) at each step."""
    for r in cases[name]:
        assert r["grad_norm"] <= GN_RTOL, (name, r["grad_norm"])


@pytest.mark.parametrize("name", list(CASES))
def test_grads_match_unsharded_reference(cases, name):
    """The first batch's synced grads, gathered: every leaf within 1e-4
    of its max|reference grad| (a grad summed over a wrong axis, or
    scaled by tp or dp, is off by its whole size)."""
    for r in cases[name]:
        assert r["grad"] <= GRAD_TOL, (name, r["grad"])


@pytest.mark.parametrize("name", list(CASES))
def test_params_after_three_steps_match_unsharded_reference(cases, name):
    """The gathered params after 3 steps against the reference's, in
    units of lr: within the optimizer's tolerance, or, where the port's
    own unsharded 3 steps on the same weights and batches land further
    from the reference than that (`port_lr`), within twice their
    distance (see the module docstring)."""
    tol = PARAM_LR_TOL[CASES[name][1]]
    for r in cases[name]:
        limit = max(tol, 2 * r["port_lr"])
        assert r["param_lr"] <= limit, (name, r["param_lr"], r["port_lr"])


@pytest.mark.parametrize("name", list(CASES))
def test_state_keeps_its_local_shards(cases, name):
    """After 3 steps every leaf of params and optimizer state still has
    its shard's shape (`local_shape` of its spec), and step == 3."""
    for r in cases[name]:
        assert r["local_shapes"], name
        assert r["step"] == TRAIN_STEPS


@pytest.fixture(scope="module")
def launcher(runs):
    d = runs["launcher"]
    out = []
    for r in range(4):
        with open(d / f"launcher_rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return d, out


def test_launcher_resumes_to_the_straight_run(launcher):
    """--mesh-shape 2,2 under torchrun's variables: 6 steps straight
    against 3, a checkpoint, and a resume to 6: every rank's shards
    bit for bit."""
    _, ranks = launcher
    for r in ranks:
        assert r["equal"] and r["step"] == 6


def test_launcher_checkpoint_restores_unsharded(launcher):
    """The sharded launcher's last checkpoint restores in the unsharded
    port (the one-device format, either package's), and every rank's
    final shards are its cut of the restored state, bit for bit."""
    d, ranks = launcher
    args = parse_args(LAUNCH_ARGS)
    cfg = reduced_config(args.arch).with_runtime(param_dtype="float32")
    opt = make_optimizer(args.optimizer, args.lr, args.steps)
    state, manifest = TC.restore_checkpoint(
        str(d / "ck"), TS.abstract_train_state(cfg, opt), device="cpu")
    assert manifest["step"] == 6 and int(state["step"]) == 6
    par = make_parallel(_FakeMesh((2, 2)), "train", seq_shard=False)
    specs = _leaves(tree_specs(TS.train_state_logical_axes(cfg, opt), par,
                               cfg))
    for r in ranks:
        for whole, shard, spec in zip(tree_leaves_sorted(state),
                                      tree_leaves_sorted(r["state"]), specs,
                                      strict=True):
            cut = shard_leaf(whole, spec, par.sizes, r["coords"])
            np.testing.assert_array_equal(cut.numpy(), shard)


# --------------------------------------------------------------------------
# Trees (no mesh)
# --------------------------------------------------------------------------

OPTIMIZERS = {
    "adamw": lambda M: M.adamw(M.constant_schedule(1e-3)),
    "adafactor": lambda M: M.adafactor(M.constant_schedule(1e-2)),
    "mixed-adamw": lambda M: M.mixed_precision(
        M.adamw(M.constant_schedule(1e-3))),
    "mixed-adafactor": lambda M: M.mixed_precision(
        M.adafactor(M.constant_schedule(1e-2))),
}
ATTN_ARCHS = ["stablelm_1_6b", "gemma2_9b", "yi_9b", "deepseek_coder_33b",
              "musicgen_large", "chameleon_34b"]
ALL_ARCHS = ATTN_ARCHS + ["qwen3_moe_235b", "grok_1_314b",
                         "recurrentgemma_2b", "mamba2_2_7b"]
TREE_ARCHS = ["stablelm_1_6b", "gemma2_9b", "chameleon_34b",
              "qwen3_moe_235b", "recurrentgemma_2b", "mamba2_2_7b"]


@pytest.mark.parametrize("arch", TREE_ARCHS)
@pytest.mark.parametrize("opt", list(OPTIMIZERS))
def test_state_logical_axes_match_reference(arch, opt):
    """Each optimizer's state_logical_axes, and the train state's
    logical axes, equal the reference's trees."""
    jaxes = JS.train_state_logical_axes(jax_reduced_config(arch),
                                        OPTIMIZERS[opt](JO))
    taxes = TS.train_state_logical_axes(reduced_config(arch),
                                        OPTIMIZERS[opt](TO))
    assert taxes == jaxes


@pytest.mark.parametrize("arch", TREE_ARCHS)
@pytest.mark.parametrize("opt", ["mixed-adamw", "mixed-adafactor"])
def test_abstract_train_state_matches_reference(arch, opt):
    """abstract_train_state: meta tensors with the reference's
    ShapeDtypeStructs' shapes and dtypes, leaf for leaf."""
    want = jax.tree.leaves(JS.abstract_train_state(jax_reduced_config(arch),
                                                   OPTIMIZERS[opt](JO)))
    got = tree_leaves_sorted(TS.abstract_train_state(reduced_config(arch),
                                                     OPTIMIZERS[opt](TO)))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.device.type == "meta"
        assert tuple(g.shape) == tuple(w.shape)
        assert str(g.dtype).removeprefix("torch.") == str(w.dtype)


def test_sharded_state_specs_split_every_leaf_evenly():
    """The train state's specs on mesh (2, 4) cut every reduced config's
    state evenly (no dim that a split does not divide)."""
    par = make_parallel(_FakeMesh((2, 4)), "train")
    for arch in ALL_ARCHS:
        cfg = reduced_config(arch)
        for name in ("mixed-adamw", "mixed-adafactor"):
            opt = OPTIMIZERS[name](TO)
            specs = tree_specs(TS.train_state_logical_axes(cfg, opt), par,
                               cfg)
            for leaf, spec in zip(tree_leaves_sorted(
                    TS.abstract_train_state(cfg, opt)), _leaves(specs),
                    strict=True):
                for dim, entry in enumerate(spec):
                    n = int(np.prod([par.sizes[a]
                                     for a in entry_axes(entry)]))
                    assert leaf.shape[dim] % n == 0, (arch, spec, leaf.shape)


@pytest.mark.parametrize("seq_shard", [False, True])
@pytest.mark.parametrize("shape", [(2, 2), (2, 4)])
def test_grad_sync_classifies_every_model_replicated_leaf(shape, seq_shard):
    """grad_sync_axes names the sync of every leaf of every config (the
    attention-only ones, the MoE in each moe_mode, RG-LRU and SSD) that
    is replicated over model (it raises on one it cannot classify), and
    sums over model exactly the leaves each model rank uses on its own
    part (the SSD's B / C projections and convs among them; not the
    MoE router, whose grad every model rank holds whole)."""
    for arch in ALL_ARCHS:
        cfg = reduced_config(arch)
        modes = ("ep", "tp", "ep2d", "tp2d") if cfg.moe else ("auto",)
        for mode in modes:
            par = make_parallel(_FakeMesh(shape), "train",
                                seq_shard=seq_shard, moe_mode=mode)
            sync = TM.grad_sync_axes(cfg, par, T)
            kv_split = make_rules(par, cfg)["kv_heads"] is not None
            for key, axes in _keyed(sync["blocks"]):
                partial = (key in ("q_norm", "k_norm", "w_B", "w_C",
                                   "conv_B", "conv_C")
                           or (key in ("wk", "wv") and not kv_split)
                           or (seq_shard and key in TM._SEQ_NORMS))
                assert ("model" in axes) == partial, (arch, mode, key, axes)
            for key, axes in _keyed(sync["tail"]):
                assert "model" not in axes or key in (
                    "wk", "wv", "q_norm", "k_norm", "w_B", "w_C", "conv_B",
                    "conv_C"), (arch, key, axes)
            assert "model" not in sync["final_norm"]


def _keyed(tree, key=None):
    """(dict key, leaf) pairs of a tree of axes tuples."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _keyed(v, k)
    elif is_axes_leaf(tree):
        yield key, tree
    else:
        for v in tree:
            yield from _keyed(v, key)


def test_grad_sync_refuses_an_unclassified_leaf(monkeypatch):
    """A new leaf replicated over model (a q bias here) cannot be synced
    by a guess: grad_sync_axes raises."""
    def with_bias(cfg):
        axes = TM.pmod.param_logical_axes(cfg)
        return dict(axes, blocks=type(axes["blocks"])(
            dict(g, bq=("layers", "norm")) for g in axes["blocks"]))
    monkeypatch.setattr(TM, "param_logical_axes", with_bias)
    par = make_parallel(_FakeMesh((2, 2)), "train")
    with pytest.raises(ValueError, match="'bq' is replicated"):
        TM.grad_sync_axes(reduced_config("stablelm_1_6b"), par, T)


@pytest.mark.parametrize("opt", ["mixed-adamw", "mixed-adafactor"])
def test_sharded_init_and_restore_cut_the_whole_state(tmp_path, opt):
    """init_train_state(parallel=) and restore_checkpoint(specs=,
    parallel=), which never hold the whole state, give this rank's
    shards of the whole state bit for bit (the rank at data 1, model 2
    of mesh (2, 4))."""
    cfg, topt = reduced_config("gemma2_9b"), OPTIMIZERS[opt](TO)
    par = make_parallel(_FakeMesh((2, 4), {"data": 1, "model": 2}),
                        "train")
    specs = tree_specs(TS.train_state_logical_axes(cfg, topt), par, cfg)
    whole = TS.init_train_state(cfg, topt, 0, "cpu")
    want = tree_leaves_sorted(shard_tree(whole, specs, par))
    TC.save_checkpoint(str(tmp_path), whole, step=3)
    restored, _ = TC.restore_checkpoint(
        str(tmp_path), TS.abstract_train_state(cfg, topt), device="cpu",
        specs=specs, parallel=par)
    for got in (TS.init_train_state(cfg, topt, 0, "cpu", parallel=par),
                restored):
        got = tree_leaves_sorted(got)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.shape == w.shape and torch.equal(g, w)


def test_train_step_refuses_the_serve_profile():
    par = make_parallel(_FakeMesh((2, 2)), "serve")
    cfg = reduced_config("stablelm_1_6b")
    with pytest.raises(ValueError, match="make_parallel"):
        TS.make_train_step(cfg, OPTIMIZERS["adamw"](TO), parallel=par)
