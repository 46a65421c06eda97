"""The port's train profile for the MoE, RG-LRU and SSD blocks on gloo
ranks on the CPU, held against the reference's UNSHARDED jitted train
step, as tests/test_torch_sharded_train.py holds the attention-only
models (its helpers, tolerances and weights: the port's `init_params`,
see that file's docstring).

Two spawns of ranks (tests/sharded_ranks.py, which imports no jax), one
module-scoped fixture: 8 ranks run meshes (2, 4) and (2, 2, 2) while
this process computes the (2, 2) cases' references; 4 ranks run mesh
(2, 2), the levers' forwards and then the launcher.

- MoE cases run at capacity_factor = n_experts, so no (token, choice)
  pair is dropped and the sharded FFN computes the dense one, with an
  aux_weight of 1.0 (a load-balance grad scaled by tp or 1/dp is then
  far outside the tolerances). Their oracle for dp > 1 in moe_mode ep /
  tp is the reference's unsharded step with its `moe_block_ffn`
  patched in this process (`_shard_aux`): the dense FFN, and as the aux
  term the mean over the data shards' row blocks of
  `_load_balance_loss`, which is what the reference's own sharded step
  computes (f * P is not linear in the rows). In ep2d / tp2d every
  rank routes the whole batch, so the oracle's term is the whole
  batch's, unpatched.
- Mesh (2, 2) ("data", "model"): qwen3-moe ep with seq_shard off,
  "full" and "carry", remat="moe_save" (under seq_shard "full"), ep2d;
  grok-1 tp (with attn_pin) and tp2d; recurrentgemma with seq_shard
  "full" and "carry"; mamba2 with seq_shard off and "full", and
  Adafactor under "full".
- Mesh (2, 4): recurrentgemma (its one kv head; the RG-LRU width over
  4) and mamba2 at n_groups 2 (a rank's 4 of 16 heads are half of a
  B / C group), seq_shard "full".
- Mesh (2, 2, 2) ("pod", "data", "model"): qwen3-moe ep, the grad sync
  over pod, the aux term over 4 data shards; and ep2d, where the pod
  axis holds no ff shard: each pod rank computes the same ff partial
  sums of the whole batch and keeps its own rows, whose grad alone it
  back-propagates (a plain slice: an all_gather backward there would
  count each row's grad once a pod rank, twice here).
- The levers (serve profile with seq_shard "full" / "carry" or
  attn_pin; train profile with attn_pin): each family's forward on mesh
  (2, 2) against the reference's unsharded forward.
- The launcher: `--arch qwen3-moe-235b-a22b` and `--arch mamba2-2.7b`,
  `--reduced --mesh-shape 2,2 --device cpu --steps 2` on the 4 ranks
  under torchrun's env:// variables: a finite loss, and its checkpoint
  restores in the unsharded port with every rank's shards in it.

Tolerances: tests/test_torch_sharded_train.py's (loss 2e-5 relative,
grad_norm 1e-5, every gathered grad leaf 1e-4 of max|grad|, params after
3 steps 0.05 lr under AdamW and 0.005 lr under Adafactor or twice the
unsharded port's own distance from the reference).
"""

import dataclasses
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import reduced_config as jax_reduced_config
from repro.models.model import forward as jax_forward
from repro_torch.configs import reduced_config
from repro_torch.launch.train import make_optimizer, parse_args
from repro_torch.models import init_params
from repro_torch.models.params import tree_leaves_sorted, tree_map
from repro_torch.sharding import make_parallel, shard_leaf, tree_specs
from repro_torch.training import checkpoint as TC
from repro_torch.training import step as TS
from sharded_ranks import B as LEVER_B
from sharded_ranks import T as LEVER_T
from sharded_ranks import TRAIN_STEPS, Ranks, _leaves
from test_torch_sharded_train import (GN_RTOL, GRAD_TOL, LOSS_RTOL,
                                      PARAM_LR_TOL, _case, _FakeMesh,
                                      _free_port, _reference)

LEVER_TOL = 1e-4            # tests/test_torch_sharded_exec.py's forwards'
AUX_WEIGHT = 1.0
LAUNCH = ["--reduced", "--device", "cpu", "--mesh-shape", "2,2",
          "--batch", "4", "--seq", "8", "--steps", "2",
          "--save-interval", "2"]
LAUNCH_ARCHS = {"launch_qwen3": "qwen3-moe-235b-a22b",
                "launch_mamba2": "mamba2-2.7b"}


def _ample(cfg):
    """capacity_factor = n_experts: no pair dropped."""
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=float(cfg.moe.n_experts)))


def _groups2(cfg):
    return dataclasses.replace(cfg, ssd=dataclasses.replace(cfg.ssd,
                                                            n_groups=2))


def _moe(arch, seed, aux_shards):
    return _reference(arch, seed, tweak=_ample, aux_weight=AUX_WEIGHT,
                      aux_shards=aux_shards)


def _moe_case(name, ref, arch, **kw):
    return _case(name, ref, arch, tweak=_ample, aux_weight=AUX_WEIGHT, **kw)


# name -> optimizer
CASES = {
    "qwen3_ep": "adamw", "qwen3_ep_full": "adamw",
    "qwen3_ep_carry": "adamw", "qwen3_moe_save": "adamw",
    "qwen3_ep2d": "adamw", "grok_tp_pin": "adamw", "grok_tp2d": "adamw",
    "recurrentgemma_full": "adamw", "recurrentgemma_carry": "adamw",
    "mamba2_off": "adamw", "mamba2_full": "adamw",
    "mamba2_adafactor": "adafactor",
    "recurrentgemma_24": "adamw", "mamba2_groups2_24": "adamw",
    "qwen3_pod": "adamw", "qwen3_pod_ep2d": "adamw",
}
LEVERS = [{"profile": "serve", "seq_shard": True},
          {"profile": "serve", "seq_shard": True, "seq_mode": "carry"},
          {"profile": "serve", "attn_pin": True},
          {"profile": "train", "attn_pin": True}]
LEVER_ARCHS = {"levers_qwen3": "qwen3_moe_235b",
               "levers_recurrentgemma": "recurrentgemma_2b",
               "levers_mamba2": "mamba2_2_7b"}


def _levers_case(name, arch, seed):
    """The reference's unsharded forward of the port's weights on a
    (LEVER_B, LEVER_T) batch, for `sharded_ranks._rank_levers_case`."""
    tcfg = reduced_config(arch).with_runtime(param_dtype="float32")
    jcfg = jax_reduced_config(arch).with_runtime(param_dtype="float32",
                                                 attn_impl="naive")
    params = tree_map(lambda t: t.numpy(), init_params(tcfg, seed,
                                                       device="cpu"))
    x = np.random.default_rng(seed).integers(
        0, tcfg.vocab, (LEVER_B, LEVER_T)).astype(np.int32)
    fwd, _ = jax.jit(lambda p, x: jax_forward(p, x, jcfg))(
        jax.tree.map(jnp.asarray, params), jnp.asarray(x))
    return dict(name=name, cfg=tcfg, params=params, tokens=x,
                forward=np.asarray(fwd), levers=LEVERS)


def _launch_case(name, arch, tmp):
    ckpt = str(tmp / name)
    return {"name": name, "launcher": dict(
        args=LAUNCH + ["--arch", arch, "--ckpt", ckpt], ckpt=ckpt, last=2,
        shape=(2, 2), axes=("data", "model"), resume=False,
        ports=[_free_port()])}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every rank's results, and the launcher's directory. The 8 ranks
    start as soon as their references are computed."""
    rg = _reference("recurrentgemma_2b", 6)
    ranks8 = Ranks(tmp_path_factory.mktemp("ranks8"), (2, 4), [
        _case("recurrentgemma_24", rg, "recurrentgemma_2b"),
        _case("mamba2_groups2_24", _reference(
            "mamba2_2_7b", 7, tweak=_groups2), "mamba2_2_7b",
            tweak=_groups2),
        _moe_case("qwen3_pod", _moe("qwen3_moe_235b", 8, 4),
                  "qwen3_moe_235b", mesh=(2, 2, 2)),
        _moe_case("qwen3_pod_ep2d", _moe("qwen3_moe_235b", 8, 1),
                  "qwen3_moe_235b", mesh=(2, 2, 2), moe_mode="ep2d")])
    launch_dir = tmp_path_factory.mktemp("launcher")
    qwen3 = _moe("qwen3_moe_235b", 9, 2)
    grok = _moe("grok_1_314b", 10, 2)
    mamba2 = _reference("mamba2_2_7b", 11)
    cases = [
        _moe_case("qwen3_ep", qwen3, "qwen3_moe_235b", seq_shard=False),
        _moe_case("qwen3_ep_full", qwen3, "qwen3_moe_235b", seq_shard=True),
        _moe_case("qwen3_ep_carry", qwen3, "qwen3_moe_235b",
                  seq_shard=True, seq_mode="carry"),
        _moe_case("qwen3_moe_save", qwen3, "qwen3_moe_235b",
                  port_kw={"remat": "moe_save"}, seq_shard=True),
        _moe_case("qwen3_ep2d", _moe("qwen3_moe_235b", 9, 1),
                  "qwen3_moe_235b", moe_mode="ep2d"),
        _moe_case("grok_tp_pin", grok, "grok_1_314b", moe_mode="tp",
                  attn_pin=True),
        _moe_case("grok_tp2d", _moe("grok_1_314b", 10, 1), "grok_1_314b",
                  moe_mode="tp2d"),
        _case("recurrentgemma_full", rg, "recurrentgemma_2b",
              seq_shard=True),
        _case("recurrentgemma_carry", rg, "recurrentgemma_2b",
              seq_shard=True, seq_mode="carry"),
        _case("mamba2_off", mamba2, "mamba2_2_7b", seq_shard=False),
        _case("mamba2_full", mamba2, "mamba2_2_7b", seq_shard=True),
        _case("mamba2_adafactor", _reference("mamba2_2_7b", 11,
                                             "adafactor"),
              "mamba2_2_7b", "adafactor", seq_shard=True)]
    cases += [_levers_case(n, a, 12 + i)
              for i, (n, a) in enumerate(LEVER_ARCHS.items())]
    cases += [_launch_case(n, a, launch_dir)
              for n, a in LAUNCH_ARCHS.items()]
    ranks4 = Ranks(launch_dir, (2, 2), cases)
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
    """Each of the 3 steps' loss (the mean over the data ranks, the aux
    term's included) within 2e-5 relative of the reference's."""
    for r in cases[name]:
        assert r["loss"] <= LOSS_RTOL, (name, r["loss"])


@pytest.mark.parametrize("name", [n for n, o in CASES.items()
                                  if o == "adamw"])
def test_grad_norm_matches_unsharded_reference(cases, name):
    """AdamW's grad_norm at each step."""
    for r in cases[name]:
        assert r["grad_norm"] <= GN_RTOL, (name, r["grad_norm"])


@pytest.mark.parametrize("name", list(CASES))
def test_grads_match_unsharded_reference(cases, name):
    """The first batch's synced grads, gathered: every leaf within 1e-4
    of its max|reference grad| (the router's and the aux term's scaled
    by tp or 1/dp, an SSD B / C grad left partial, or the gated norm's
    sum without its backward are off by their whole size)."""
    for r in cases[name]:
        assert r["grad"] <= GRAD_TOL, (name, r["grad"])


@pytest.mark.parametrize("name", list(CASES))
def test_params_after_three_steps_match_unsharded_reference(cases, name):
    """The gathered params after 3 steps against the reference's, in
    units of lr (test_torch_sharded_train.py's rule)."""
    tol = PARAM_LR_TOL[CASES[name]]
    for r in cases[name]:
        limit = max(tol, 2 * r["port_lr"])
        assert r["param_lr"] <= limit, (name, r["param_lr"], r["port_lr"])


@pytest.mark.parametrize("name", list(CASES))
def test_state_keeps_its_local_shards(cases, name):
    """After 3 steps every leaf of params and optimizer state still has
    its shard's shape, and step == 3."""
    for r in cases[name]:
        assert r["local_shapes"], name
        assert r["step"] == TRAIN_STEPS


@pytest.mark.parametrize("lever", range(len(LEVERS)))
@pytest.mark.parametrize("name", list(LEVER_ARCHS))
def test_levers_compute_for_every_block(cases, name, lever):
    """seq_shard ("full", "carry") and attn_pin under the serve profile,
    and attn_pin under the train profile, compute the MoE, RG-LRU and
    SSD models: forward on every rank of mesh (2, 2) within 1e-4 of the
    reference's unsharded logits (this data rank's rows under the train
    profile)."""
    for r in cases[name]:
        assert r[str(lever)] <= LEVER_TOL, (LEVERS[lever], r)


@pytest.fixture(scope="module")
def launched(runs):
    d = runs["launcher"]
    out = {}
    for name in LAUNCH_ARCHS:
        out[name] = []
        for r in range(4):
            with open(d / f"{name}_rank{r}.pkl", "rb") as f:
                out[name].append(pickle.load(f))
    return d, out


@pytest.mark.parametrize("name", list(LAUNCH_ARCHS))
def test_launcher_trains_the_block(launched, name):
    """--arch <MoE or SSD> --mesh-shape 2,2 under torchrun's variables:
    2 steps, rank 0's last printed loss finite, every shard finite."""
    ranks = launched[1][name]
    assert ranks[0]["loss"] is not None and np.isfinite(ranks[0]["loss"])
    for r in ranks:
        assert r["step"] == 2 and r["finite"]


@pytest.mark.parametrize("name", list(LAUNCH_ARCHS))
def test_launcher_checkpoint_restores_unsharded(launched, name):
    """The sharded launcher's checkpoint restores in the unsharded port,
    and every rank's final shards are its cut of it, bit for bit."""
    d, ranks = launched
    args = parse_args(LAUNCH + ["--arch", LAUNCH_ARCHS[name]])
    cfg = reduced_config(args.arch).with_runtime(param_dtype="float32")
    opt = make_optimizer(args.optimizer, args.lr, args.steps)
    state, manifest = TC.restore_checkpoint(
        str(d / name), TS.abstract_train_state(cfg, opt), device="cpu")
    assert manifest["step"] == 2 and int(state["step"]) == 2
    par = make_parallel(_FakeMesh((2, 2)), "train", seq_shard=False)
    specs = _leaves(tree_specs(TS.train_state_logical_axes(cfg, opt), par,
                               cfg))
    for r in ranks[name]:
        for whole, shard, spec in zip(tree_leaves_sorted(state),
                                      tree_leaves_sorted(r["state"]), specs,
                                      strict=True):
            cut = shard_leaf(whole, spec, par.sizes, r["coords"])
            np.testing.assert_array_equal(cut.numpy(), shard)

