"""The port's training path (`repro_torch.training`, `repro_torch.data`,
`repro_torch.quant.int8`'s delta quantization, `repro_torch.launch.
train`) against the JAX reference on the CPU, at the reduced configs.

Weights: the port's `init_params`, handed to the reference as numpy
arrays (the reference's own init scales a stacked leaf by the group
count, which saturates RG-LRU's gates; tests/test_torch_recurrent.py).
Batches: the Markov task's, the same numpy arrays on both sides.

Tolerances: the loss within 2e-5 relative of `jax.value_and_grad`'s,
each gradient leaf within 1e-4 of its max|JAX grad|; optimizer updates
fed the same gradients within 1e-6 of each leaf's max|reference|; whole
train steps and DiLoCo's anchors (see each test); int8 values, scales
and checkpoint leaves bit for bit."""

import dataclasses
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jax_reduced_config
from repro.quant import int8 as JQ
from repro.training import checkpoint as JC
from repro.training import diloco as JD
from repro.training import optim as JO
from repro.training import step as JS
from repro_torch.configs import reduced_config
from repro_torch.data import ByteCorpus, MarkovLMTask
from repro_torch.kernels import ops
from repro_torch.launch import train as launcher
from repro_torch.models import forward, from_jax, init_params
from repro_torch.models.params import tree_leaves_sorted, tree_map
from repro_torch.quant import int8 as TQ
from repro_torch.quant.int8 import quantize_exec_tree
from repro_torch.training import checkpoint as TC
from repro_torch.training import diloco as TD
from repro_torch.training import optim as TO
from repro_torch.training import step as TS
from repro_torch.training.accum import make_accum_train_step

LOSS_RTOL = 2e-5
GRAD_TOL = 1e-4
OPT_TOL = 1e-6


def _np(tree):
    return tree_map(lambda t: t.detach().numpy(), tree)


def _to_jax(tree):
    return jax.tree.map(jnp.asarray, _np(tree))


def _weights(arch, seed=0, jax_kw=(), port_kw=(), **kw):
    """(reference cfg, port cfg, reference params, port params); kw
    changes both configs, jax_kw / port_kw one side's."""
    jcfg = dataclasses.replace(jax_reduced_config(arch), **kw, **dict(jax_kw))
    tcfg = dataclasses.replace(reduced_config(arch), **kw, **dict(port_kw))
    tp = init_params(tcfg, seed, device="cpu")
    return jcfg, tcfg, _to_jax(tp), tp


def _batch(cfg, step=0, B=4, T=16, host=0, seed=0):
    b = MarkovLMTask(vocab=cfg.vocab, seed=seed).batch(step, B, T, host)
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(v) for k, v in b.items()})


def _pairs(port_tree, jax_tree):
    got, want = tree_leaves_sorted(port_tree), jax.tree.leaves(jax_tree)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        yield g.detach().float().numpy(), np.asarray(w, np.float32)


def _close_leaves(port_tree, jax_tree, tol):
    for g, w in _pairs(port_tree, jax_tree):
        np.testing.assert_allclose(
            g, w, rtol=0, atol=tol * max(np.abs(w).max(), 1e-30))


def _equal_leaves(port_tree, jax_tree):
    got, want = tree_leaves_sorted(port_tree), jax.tree.leaves(jax_tree)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        if g.dtype == torch.bfloat16:
            g, w = g.view(torch.int16).numpy(), w.view(np.int16)
        else:
            g = g.numpy()
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


# --------------------------------------------------------------------------
# Loss and gradients
# --------------------------------------------------------------------------

LOSS_CASES = [
    # (arch, config changes of each side, seq)
    ("stablelm_1_6b", {}, 16),
    ("stablelm_1_6b", {"jax_kw": {"attn_impl": "jax_chunked"},
                       "port_kw": {"attn_impl": "chunked"}}, 37),
    ("mamba2_2_7b", {}, 16),
    ("recurrentgemma_2b", {}, 16),
    ("yi_9b", {"remat": "block"}, 16),
]


@pytest.mark.parametrize("arch, kw, T", LOSS_CASES,
                         ids=["stablelm", "stablelm-chunked", "mamba2",
                              "recurrentgemma", "yi-remat"])
def test_loss_and_grads_match_reference(arch, kw, T):
    jcfg, tcfg, jp, tp = _weights(arch, **kw)
    jb, tb = _batch(tcfg, T=T)
    (jtot, jm), jg = jax.value_and_grad(JS.make_loss_fn(jcfg),
                                        has_aux=True)(jp, jb)
    (ttot, tm), tg = TS.value_and_grad(TS.make_loss_fn(tcfg), tp, tb)
    np.testing.assert_allclose(float(ttot), float(jtot), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=LOSS_RTOL)
    assert float(tm["aux_loss"]) == float(jm["aux_loss"]) == 0.0
    _close_leaves(tg, jg, GRAD_TOL)
    # The caller's params are left as they were.
    assert not any(p.requires_grad for p in tree_leaves_sorted(tp))


@pytest.mark.parametrize("z", [0.0, 1e-3])
def test_cross_entropy_matches_reference(z):
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((2, 5, 11)).astype(np.float32) * 3
    labels = rng.integers(0, 11, (2, 5)).astype(np.int32)
    want = JS.cross_entropy(jnp.asarray(logits), jnp.asarray(labels), z)
    got = TS.cross_entropy(torch.from_numpy(logits),
                           torch.from_numpy(labels), z)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_remat_block_gives_the_same_loss_and_grads():
    """remat="block" (each scan group under torch.utils.checkpoint)
    against "none" in the port: the backward recomputes the same ops."""
    _, tcfg, _, tp = _weights("yi_9b")
    _, tb = _batch(tcfg)
    out = {}
    for remat in ("none", "block"):
        loss_fn = TS.make_loss_fn(dataclasses.replace(tcfg, remat=remat))
        out[remat] = TS.value_and_grad(loss_fn, tp, tb)
    (a, _), ga = out["none"]
    (b, _), gb = out["block"]
    assert torch.equal(a, b)
    for x, y in zip(tree_leaves_sorted(ga), tree_leaves_sorted(gb)):
        torch.testing.assert_close(x, y, rtol=0, atol=1e-7)


def test_forward_aux_loss_and_remat_modes():
    """forward's aux loss and cache on a model without MoE, and
    remat="moe_save" (each group recomputed, the MoE blocks' outputs
    kept) giving the reference's loss and every grad at this file's
    tolerances, on reduced qwen3-moe-235b (with its load-balance loss)
    and on stablelm, which has no MoE block and computes as "block"."""
    _, tcfg, _, tp = _weights("stablelm_1_6b")
    _, tb = _batch(tcfg)
    logits, extras = forward(tp, tb["inputs"], tcfg)
    aux = extras["aux_loss"]
    assert aux.shape == () and aux.dtype == torch.float32 and aux == 0
    assert extras["cache"] is None
    for arch in ("qwen3_moe_235b", "stablelm_1_6b"):
        jcfg, tcfg, jp, tp = _weights(arch, remat="moe_save")
        jb, tb = _batch(tcfg)
        (jtot, jm), jg = jax.value_and_grad(
            JS.make_loss_fn(jcfg, aux_weight=0.01), has_aux=True)(jp, jb)
        (ttot, tm), tg = TS.value_and_grad(TS.make_loss_fn(tcfg, 0.01),
                                           tp, tb)
        np.testing.assert_allclose(float(ttot), float(jtot), rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(tm["aux_loss"]),
                                   float(jm["aux_loss"]), rtol=LOSS_RTOL)
        assert (float(tm["aux_loss"]) > 0) == (arch == "qwen3_moe_235b")
        _close_leaves(tg, jg, GRAD_TOL)


# --------------------------------------------------------------------------
# The kernels have no backward: the wrappers raise, never detach
# --------------------------------------------------------------------------

def _kernel_calls(requires_grad):
    g = torch.Generator().manual_seed(0)

    def rnd(*shape):
        return torch.randn(shape, generator=g).requires_grad_(requires_grad)
    q, k, v = rnd(2, 8, 4, 16), rnd(2, 8, 2, 16), rnd(2, 8, 2, 16)
    pos = torch.arange(8)
    w = torch.randint(-127, 128, (16, 12), generator=g, dtype=torch.int8)
    return {
        "flash_attention": lambda: ops.flash_attention(q, k, v, pos, pos),
        "decode_attention": lambda: ops.decode_attention(
            q[:, :1], k, v, pos, torch.tensor(7, dtype=torch.int32)),
        "int8_matmul": lambda: ops.int8_matmul(rnd(3, 16), w,
                                               torch.rand(12, generator=g)),
    }


@pytest.mark.parametrize("name", ["flash_attention", "decode_attention",
                                  "int8_matmul"])
def test_kernel_wrappers_raise_under_autograd(name):
    with pytest.raises(RuntimeError, match="no backward"):
        _kernel_calls(True)[name]()
    with torch.no_grad():
        assert not _kernel_calls(True)[name]().requires_grad
    assert not _kernel_calls(False)[name]().requires_grad


@pytest.mark.parametrize("tree", ["cuda-attention", "int8"])
def test_training_through_a_kernel_raises(tree):
    _, tcfg, _, tp = _weights("stablelm_1_6b")
    if tree == "int8":
        tp = quantize_exec_tree(tp)
    else:
        tcfg = dataclasses.replace(tcfg, attn_impl="cuda")
    _, tb = _batch(tcfg)
    with pytest.raises(RuntimeError, match="no backward"):
        TS.value_and_grad(TS.make_loss_fn(tcfg), tp, tb)


# --------------------------------------------------------------------------
# Optimizers, fed the same gradients
# --------------------------------------------------------------------------

def _opt_tree(rng, bf16=False):
    def r(*shape):
        return rng.standard_normal(shape).astype(np.float32)
    tree = {"embed": r(12, 8), "final_norm": r(8),
            "blocks": ({"wq": r(2, 8, 3, 4), "ln1": r(2, 8),
                        "mlp": {"w_up": r(2, 8, 16)}},),
            "tail": ()}
    jt = jax.tree.map(jnp.asarray, tree)
    if bf16:
        jt = jax.tree.map(lambda x: x.astype(jnp.bfloat16), jt)
    return jt, from_jax(jt, device="cpu")


OPTIMIZERS = {
    "adamw-constant": lambda M: M.adamw(M.constant_schedule(0.1),
                                        0.9, 0.95, 1e-8, 0.01, clip_norm=1e9),
    "adamw-cosine-clip": lambda M: M.adamw(M.cosine_schedule(1e-2, 2, 10),
                                           clip_norm=0.5),
    "adafactor-constant": lambda M: M.adafactor(M.constant_schedule(1e-2)),
    "adafactor-cosine-wd": lambda M: M.adafactor(
        M.cosine_schedule(1e-2, 2, 10), weight_decay=0.1),
    "mixed-adamw-bf16": lambda M: M.mixed_precision(
        M.adamw(M.cosine_schedule(3e-3, 1, 6))),
    "mixed-adafactor": lambda M: M.mixed_precision(
        M.adafactor(M.constant_schedule(1e-2))),
}


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_optimizer_updates_match_reference(name):
    rng = np.random.default_rng(1)
    jp, tp = _opt_tree(rng, bf16=name.endswith("bf16"))
    jopt, topt = OPTIMIZERS[name](JO), OPTIMIZERS[name](TO)
    js, ts = jopt.init(jp), topt.init(tp)
    _equal_leaves(ts, js)
    for i in range(4):
        jg, tg = _opt_tree(rng)
        jp, js, jm = jopt.update(jg, js, jp, jnp.int32(i))
        tp, ts, tm = topt.update(tg, ts, tp, torch.tensor(i, dtype=torch.int32))
        _close_leaves(tp, jp, OPT_TOL)
        _close_leaves(ts, js, OPT_TOL)
        assert set(tm) == set(jm)
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=OPT_TOL)
    if name.startswith("adafactor"):
        assert ts["v"]["embed"]["vr"].shape == (12,)
        assert ts["v"]["embed"]["vc"].shape == (8,)
        assert set(ts["v"]["final_norm"]) == {"v"}


@pytest.mark.parametrize("sched", ["cosine", "constant"])
def test_schedules_match_reference(sched):
    make = {"cosine": lambda M: M.cosine_schedule(1.0, 10, 100, 0.1),
            "constant": lambda M: M.constant_schedule(3e-3)}[sched]
    j, t = make(JO), make(TO)
    for s in (0, 1, 5, 10, 11, 55, 99, 100, 140):
        np.testing.assert_allclose(float(t(torch.tensor(s, dtype=torch.int32))),
                                   float(j(jnp.int32(s))), rtol=OPT_TOL)


def test_clip_by_global_norm_matches_reference():
    rng = np.random.default_rng(2)
    jt, tt = _opt_tree(rng)
    jc, jn = JO.clip_by_global_norm(jt, 1.5)
    tc, tn = TO.clip_by_global_norm(tt, 1.5)
    np.testing.assert_allclose(float(tn), float(jn), rtol=OPT_TOL)
    _close_leaves(tc, jc, OPT_TOL)
    g = {"w": torch.tensor([3.0, 4.0])}
    clipped, gn = TO.clip_by_global_norm(g, 1.0)
    assert abs(float(gn) - 5.0) < 1e-6
    torch.testing.assert_close(clipped["w"], torch.tensor([0.6, 0.8]))


# --------------------------------------------------------------------------
# Whole steps, accumulation
# --------------------------------------------------------------------------

def test_train_steps_match_reference():
    """Three AdamW steps on the same weights and batches. Losses within
    2e-5 relative; params within 0.05 lr of the reference's: Adam's
    m / sqrt(v) moves each element by up to about lr whatever its
    gradient's size, so an element whose gradient is near its rounding
    (the last bits differ, above) moves by another fraction of lr
    (0.0146 lr at most here)."""
    jcfg, tcfg, jp, tp = _weights("stablelm_1_6b")
    jopt = JO.adamw(JO.constant_schedule(1e-3))
    topt = TO.adamw(TO.constant_schedule(1e-3))
    jstate = {"params": jp, "opt": jopt.init(jp),
              "step": jnp.zeros((), jnp.int32)}
    tstate = {"params": tp, "opt": topt.init(tp),
              "step": torch.zeros((), dtype=torch.int32)}
    jstep = jax.jit(JS.make_train_step(jcfg, jopt))
    tstep = TS.make_train_step(tcfg, topt)
    for i in range(3):
        jb, tb = _batch(tcfg, step=i)
        jstate, jm = jstep(jstate, jb)
        tstate, tm = tstep(tstate, tb)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-5)
    assert int(tstate["step"]) == int(jstate["step"]) == 3
    for g, w in _pairs(tstate["params"], jstate["params"]):
        np.testing.assert_allclose(g, w, rtol=0, atol=0.05 * 1e-3)


def test_accumulation_matches_monolithic_step():
    """n_micro microbatches give the monolithic step's update
    (tests/test_advanced_training.py:16)."""
    _, tcfg, _, tp = _weights("stablelm_1_6b")
    opt = TO.adamw(TO.constant_schedule(1e-3))
    _, tb = _batch(tcfg, B=8)
    state0 = {"params": tp, "opt": opt.init(tp),
              "step": torch.zeros((), dtype=torch.int32)}
    s1, m1 = TS.make_train_step(tcfg, opt)(state0, tb)
    s2, m2 = make_accum_train_step(tcfg, opt, n_micro=4)(state0, tb)
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]),
                               rtol=1e-5)
    for a, b in zip(tree_leaves_sorted(s1["params"]),
                    tree_leaves_sorted(s2["params"])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-4,
                                   atol=2e-6)
    with pytest.raises(ValueError, match="multiple"):
        make_accum_train_step(tcfg, opt, n_micro=3)(state0, tb)


def test_loss_decreases():
    """A few dozen steps on the Markov task cut the loss clearly
    (tests/test_training.py:84)."""
    cfg = reduced_config("stablelm_1_6b")
    opt = TO.adamw(TO.constant_schedule(3e-3))
    step = TS.make_train_step(cfg, opt)
    state = TS.init_train_state(cfg, opt, 0, device="cpu")
    losses = []
    for i in range(30):
        _, b = _batch(cfg, step=i, B=8, T=32)
        state, m = step(state, b)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.5, losses[:3] + losses[-3:]


# --------------------------------------------------------------------------
# Checkpoints (tests/test_checkpoint.py's cases, and across packages)
# --------------------------------------------------------------------------

def _mk_state():
    cfg = reduced_config("stablelm_1_6b")
    opt = TO.adamw(TO.constant_schedule(1e-3))
    return cfg, opt, TS.init_train_state(cfg, opt, 0, device="cpu")


def test_save_restore_bitwise(tmp_path):
    _, _, state = _mk_state()
    TC.save_checkpoint(str(tmp_path), state, step=7)
    restored, manifest = TC.restore_checkpoint(str(tmp_path), state)
    assert manifest["step"] == 7
    for a, b in zip(tree_leaves_sorted(state), tree_leaves_sorted(restored)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    meta = tree_map(lambda t: t.to("meta"), state)
    restored, _ = TC.restore_checkpoint(str(tmp_path), meta, device="cpu")
    for a, b in zip(tree_leaves_sorted(state), tree_leaves_sorted(restored)):
        assert b.device.type == "cpu" and torch.equal(a, b)


def test_structure_mismatch_rejected(tmp_path):
    _, opt, state = _mk_state()
    TC.save_checkpoint(str(tmp_path), state, step=1)
    other = TS.init_train_state(reduced_config("yi_9b"), opt, 0,
                                device="cpu")
    with pytest.raises(ValueError, match="mismatch"):
        TC.restore_checkpoint(str(tmp_path), other)


def test_torn_write_is_ignored(tmp_path):
    _, _, state = _mk_state()
    TC.save_checkpoint(str(tmp_path), state, step=1)
    torn = tmp_path / "step_00000002"
    torn.mkdir()
    (torn / "manifest.json").write_text("{}")
    assert TC.committed_steps(str(tmp_path)) == [1]
    _, manifest = TC.restore_checkpoint(str(tmp_path), state)
    assert manifest["step"] == 1


def test_manager_retention(tmp_path):
    _, _, state = _mk_state()
    mgr = TC.CheckpointManager(str(tmp_path), keep_n=2, save_interval=10)
    for s in (10, 20, 30, 40):
        assert mgr.maybe_save(state, s) is not None
    assert mgr.maybe_save(state, 41) is None
    assert TC.committed_steps(str(tmp_path)) == [30, 40]
    assert mgr.latest_step() == 40


def test_resume_equivalence(tmp_path):
    """6 steps straight against 3 steps, a checkpoint, a restore and 3
    more: the same params bit for bit."""
    cfg, opt, state = _mk_state()
    step_fn = TS.make_train_step(cfg, opt)

    def run(state, start, n):
        for i in range(start, start + n):
            _, b = _batch(cfg, step=i, seed=3)
            state, _ = step_fn(state, b)
        return state

    straight = run(state, 0, 6)
    half = run(state, 0, 3)
    TC.save_checkpoint(str(tmp_path), half, step=3)
    restored, manifest = TC.restore_checkpoint(str(tmp_path), half)
    resumed = run(restored, manifest["step"], 3)
    for a, b in zip(tree_leaves_sorted(straight["params"]),
                    tree_leaves_sorted(resumed["params"])):
        assert torch.equal(a, b)


def _both_states():
    """The reference's mixed-precision AdamW train state and the port's
    of the same structure (values differ: each package's own init)."""
    jcfg = jax_reduced_config("stablelm_1_6b")
    jopt = JO.mixed_precision(JO.adamw(JO.constant_schedule(1e-3)))
    jstate = JS.init_train_state(jcfg, jopt, jax.random.PRNGKey(0))
    jstate = dict(jstate, step=jnp.int32(5))
    _, opt, _ = _mk_state()
    topt = TO.mixed_precision(TO.adamw(TO.constant_schedule(1e-3)))
    tstate = TS.init_train_state(reduced_config("stablelm_1_6b"), topt, 1,
                                 device="cpu")
    return jstate, tstate


def test_reference_checkpoint_restores_in_port(tmp_path):
    jstate, tstate = _both_states()
    JC.save_checkpoint(str(tmp_path), jstate, step=5, extra={"who": "jax"})
    assert TC.tree_fingerprint(tstate) == JC.tree_fingerprint(jstate)
    restored, manifest = TC.restore_checkpoint(str(tmp_path), tstate)
    assert manifest["step"] == 5 and manifest["extra"] == {"who": "jax"}
    _equal_leaves(restored, jstate)


def test_port_checkpoint_restores_in_reference(tmp_path):
    jstate, tstate = _both_states()
    TC.save_checkpoint(str(tmp_path), tstate, step=9)
    assert set(os.listdir(tmp_path / "step_00000009")) == {
        "manifest.json", "shard_0.npz", "_COMMITTED"}
    restored, manifest = JC.restore_checkpoint(str(tmp_path), jstate)
    assert manifest["step"] == 9
    _equal_leaves(tstate, restored)


def test_bf16_leaves_restore_from_reference(tmp_path):
    w = jnp.asarray(np.random.default_rng(4).standard_normal((3, 5)),
                    jnp.bfloat16)
    JC.save_checkpoint(str(tmp_path), {"w": w, "n": jnp.int32(2)}, step=1)
    target = {"w": torch.zeros(3, 5, dtype=torch.bfloat16),
              "n": torch.zeros((), dtype=torch.int32)}
    restored, _ = TC.restore_checkpoint(str(tmp_path), target)
    _equal_leaves(restored, {"w": w, "n": jnp.int32(2)})
    TC.save_checkpoint(str(tmp_path / "port"), restored, step=1)
    again, _ = TC.restore_checkpoint(str(tmp_path / "port"), target)
    assert torch.equal(again["w"].view(torch.int16),
                       restored["w"].view(torch.int16))


# --------------------------------------------------------------------------
# int8 quantization, error feedback, DiLoCo
# --------------------------------------------------------------------------

@pytest.mark.parametrize("axis", [-1, 0])
def test_quantize_int8_and_ef_compress_match_reference(axis):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((6, 40)).astype(np.float32) * 3
    r = rng.standard_normal((6, 40)).astype(np.float32) * 1e-2
    jq, js = JQ.quantize_int8(jnp.asarray(x), axis)
    tq, ts = TQ.quantize_int8(torch.from_numpy(x), axis)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        TQ.dequantize_int8(tq, ts).numpy(),
        np.asarray(JQ.dequantize_int8(jq, js)))
    jout = JQ.ef_compress(jnp.asarray(x), jnp.asarray(r), axis)
    tout = TQ.ef_compress(torch.from_numpy(x), torch.from_numpy(r), axis)
    for g, w in zip(tout, jout):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_quantize_tree_matches_reference():
    jp, tp = _opt_tree(np.random.default_rng(6))
    jq, tq = JQ.quantize_tree(jp, min_size=64), TQ.quantize_tree(tp,
                                                                  min_size=64)
    assert set(tq["blocks"][0]["wq"]) == {"q", "scale"}
    assert isinstance(tq["final_norm"], torch.Tensor)
    _equal_leaves(tq, jq)
    like = tree_map(lambda t: t.to(torch.bfloat16), tp)
    jlike = jax.tree.map(lambda x: x.astype(jnp.bfloat16), jp)
    _equal_leaves(TQ.dequantize_tree(tq, like), JQ.dequantize_tree(jq, jlike))
    _equal_leaves(TQ.dequantize_tree(tq), JQ.dequantize_tree(jq))


@pytest.mark.parametrize("quantize", [True, False])
def test_outer_sync_matches_reference(quantize):
    """Two outer rounds of two pods (pod params: the anchor plus a
    seeded perturbation, the same numbers on both sides): anchors,
    momenta and error-feedback residuals within 1e-6 of each leaf's
    max|reference|, byte counts equal."""
    _, _, jp, tp = _weights("stablelm_1_6b")
    jo, to = JD.init_outer(jp, 2), TD.init_outer(tp, 2)
    rng = np.random.default_rng(7)
    for _ in range(2):
        jpods, tpods = [], []
        for _pod in range(2):
            noise = tree_map(lambda t: rng.standard_normal(t.shape).astype(
                np.float32) * 1e-2, tp)
            jpods.append(jax.tree.map(lambda a, n: a + n,
                                      JD.broadcast_anchor(jo, jp), noise))
            tpods.append(tree_map(lambda a, n: a + torch.from_numpy(n),
                                  TD.broadcast_anchor(to, tp), noise))
        jo = JD.outer_sync(jo, jpods, quantize=quantize)
        to = TD.outer_sync(to, tpods, quantize=quantize)
        _close_leaves(to.anchor, jo.anchor, OPT_TOL)
        _close_leaves(to.momentum, jo.momentum, OPT_TOL)
        for tr, jr in zip(to.residuals, jo.residuals):
            _close_leaves(tr, jr, OPT_TOL)
        assert (to.syncs, to.bytes_sent, to.bytes_fp32) == (
            jo.syncs, jo.bytes_sent, jo.bytes_fp32)


def test_diloco_outer_sync_converges_and_compresses():
    """tests/test_advanced_training.py:50 on the port: loss falls across
    outer rounds, and the sync moves under 0.30 of fp32's bytes."""
    cfg = reduced_config("stablelm_1_6b")
    opt = TO.adamw(TO.constant_schedule(2e-3))
    params = TS.init_train_state(cfg, opt, 0, device="cpu")["params"]
    outer = TD.init_outer(params, n_pods=2)
    step = TS.make_train_step(cfg, opt)
    losses, step0 = [], 0
    for _ in range(3):
        pods, round_losses = [], []
        for pod in range(2):
            p = TD.broadcast_anchor(outer, params)
            state = {"params": p, "opt": opt.init(p),
                     "step": torch.tensor(step0, dtype=torch.int32)}
            for i in range(step0, step0 + 5):
                _, b = _batch(cfg, step=i, host=pod, seed=1)
                state, m = step(state, b)
            pods.append(state["params"])
            round_losses.append(float(m["loss"]))
        outer = TD.outer_sync(outer, pods)
        losses.append(np.mean(round_losses))
        step0 += 5
    assert losses[-1] < losses[0], losses
    assert outer.bytes_sent < 0.30 * outer.bytes_fp32
    assert outer.syncs == 3


def test_diloco_quantization_error_bounded():
    """tests/test_advanced_training.py:77 on the port: one outer sync
    with and without int8 agrees within the int8 scale."""
    cfg = reduced_config("yi_9b")
    opt = TO.adamw(TO.constant_schedule(1e-3))
    params = TS.init_train_state(cfg, opt, 0, device="cpu")["params"]
    step = TS.make_train_step(cfg, opt)
    pods = []
    for pod in range(2):
        state = {"params": params, "opt": opt.init(params),
                 "step": torch.zeros((), dtype=torch.int32)}
        for i in range(3):
            _, b = _batch(cfg, step=i, host=pod, seed=2)
            state, _ = step(state, b)
        pods.append(state["params"])
    exact = TD.outer_sync(TD.init_outer(params, 2), pods, quantize=False)
    quant = TD.outer_sync(TD.init_outer(params, 2), pods, quantize=True)
    for a, b in zip(tree_leaves_sorted(exact.anchor),
                    tree_leaves_sorted(quant.anchor)):
        assert float((a - b).abs().max()) < 2e-2


# --------------------------------------------------------------------------
# Data and the launcher
# --------------------------------------------------------------------------

def test_data_sources_are_pure_functions_of_step():
    task = MarkovLMTask(vocab=64, seed=0)
    a, b = task.batch(3, 2, 8), task.batch(3, 2, 8)
    np.testing.assert_array_equal(a["inputs"], b["inputs"])
    np.testing.assert_array_equal(a["inputs"][:, 1:], a["labels"][:, :-1])
    root = os.path.join(os.path.dirname(__file__), "..", "src",
                        "repro_torch", "data")
    corpus = ByteCorpus(root)
    assert corpus.batch(0, 2, 16)["inputs"].shape == (2, 16)


def test_launcher_trains_and_resumes(tmp_path, capsys, monkeypatch):
    """--reduced --device cpu: real steps, a checkpoint every 3, and a
    resume from step 3 that ends on the straight run's params bit for
    bit. --mesh-shape in a process with no process group and none of
    torchrun's variables raises a clear error (the sharded launcher's
    runs are in tests/test_torch_sharded_train.py)."""
    ck = str(tmp_path / "ck")
    args = ["--reduced", "--device", "cpu", "--steps", "6", "--batch", "2",
            "--seq", "8", "--lr", "3e-3"]
    straight = launcher.main(args + ["--ckpt", ck, "--save-interval", "3"])
    out = capsys.readouterr().out
    assert "step     6 loss" in out and out.strip().endswith("done")
    assert TC.committed_steps(ck) == [3, 6]
    shutil.rmtree(os.path.join(ck, "step_00000006"))
    resumed = launcher.main(args + ["--ckpt", ck, "--save-interval", "3"])
    assert "resumed from step 3" in capsys.readouterr().out
    assert int(resumed["step"]) == 6
    for a, b in zip(tree_leaves_sorted(straight), tree_leaves_sorted(resumed)):
        assert torch.equal(a, b)
    ada = launcher.main(["--reduced", "--device", "cpu", "--steps", "2",
                         "--batch", "2", "--seq", "8",
                         "--optimizer", "adafactor"])
    assert set(ada["opt"]["inner"]) == {"v"}
    for var in launcher.TORCHRUN_VARS:
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        launcher.main(args + ["--mesh-shape", "2,4"])
