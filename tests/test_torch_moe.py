"""The port's MoE block (`repro_torch.models.moe`, the `moe` branch of
`models.model`) and its two architectures, qwen3-moe-235b-a22b (silu
experts, 8 of 128) and grok-1-314b (tanh-GELU experts, 2 of 8, softcaps,
tied and scaled embedding), against the JAX reference on the CPU at the
reduced configs: configs and trees, the router, the MoE FFN, `forward`,
the serving engine, the loss and its gradients, and int8 experts, which
neither side computes.

Weights: the reference's `init_params`, carried across with `from_jax`;
inputs drawn from a numpy seed. Tolerance: fp32 results within 2e-5 of
max|reference| (at least 2e-5 absolute), the fp32 tolerance of
tests/test_kernels.py; the router's indices, and the engine's greedy
tokens, equal. Two exceptions, both in grok-1-314b, whose reduced config
saturates its attention softcap (raw logits up to 135 against a cap of
30), where the two sides' fp32 tanh round apart: its engine steps, and
the gradients of the leaves that the softcap's derivative feeds (wq and
wk, and their inputs ln1 and the embedding), are held at 1e-4, the
tolerance of the other whole-model comparisons (tests/test_torch_dense.py's
logits, tests/test_torch_training.py's grads). Measured: 2.1e-5 at one
engine step and up to 2.9e-5 in those leaves; with the softcap in
float64 that step's port error against a float64 run falls from 1.6e-5
to 5.2e-6. Every other grok leaf (ln2, router, experts, wv, wo, the
final norm), its loss and its aux loss hold 2e-5."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced_config as jax_reduced_config
from repro.models import init_params as jax_init_params
from repro.models import moe as JM
from repro.models.model import forward as jax_forward
from repro.models.model import init_cache as jax_init_cache
from repro.quant.int8 import quantize_exec_tree as jax_quantize
from repro.serving.engine import InferenceEngine as JaxEngine
from repro.training import step as JS
from repro_torch.configs import get_config, reduced_config
from repro_torch.models import forward, from_jax, init_cache, init_params
from repro_torch.models import moe as TM
from repro_torch.models.params import tree_leaves, tree_leaves_sorted, \
    tree_map
from repro_torch.quant.int8 import quantize_exec_tree
from repro_torch.serving.engine import InferenceEngine
from repro_torch.training import step as TS

TOL = 2e-5
# Whole-model comparisons (engine steps, gradients), per architecture.
MODEL_TOL = {"qwen3_moe_235b": TOL, "grok_1_314b": 1e-4}
# The leaves whose gradient enters through the attention softcap's
# derivative: the q and k projections and their inputs.
SOFTCAP_LEAVES = ("wq", "wk", "ln1", "embed")
ARCHS = ["qwen3_moe_235b", "grok_1_314b"]
jax_forward = jax.jit(jax_forward, static_argnums=2)


def _close(got, want, tol=TOL):
    want = np.asarray(want, np.float32)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(1.0, np.abs(want).max()))


def _cfgs(arch, impl="naive", **kw):
    """(reference config, port config), reduced; kw replaces fields on
    both sides."""
    return (dataclasses.replace(jax_reduced_config(arch), attn_impl="naive",
                                **kw),
            dataclasses.replace(reduced_config(arch), attn_impl=impl, **kw))


def _weights(jcfg, seed=0):
    jp = jax_init_params(jcfg, jax.random.PRNGKey(seed))
    return jp, from_jax(jp, device="cpu")


def _block(tree, g=0):
    """Scan group g of the first stacked block, as each side's scan body
    sees it."""
    return {k: v[g] for k, v in tree["blocks"][0].items()}


def _shapes(tree):
    return jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), tree)


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_and_trees_match_reference(arch):
    """The published and reduced configs equal the reference's field by
    field (attn_impl aside); the port's parameter and cache trees have
    the reference's structure, shapes and dtypes, and from_jax carries
    every leaf across."""
    for full in (True, False):
        j = jax_get_config(arch) if full else jax_reduced_config(arch)
        t = get_config(arch) if full else reduced_config(arch)
        ja, ta = dataclasses.asdict(j), dataclasses.asdict(t)
        ja.pop("attn_impl"), ta.pop("attn_impl")
        assert ja == ta
        assert j.param_count() == t.param_count()
    jcfg, tcfg = _cfgs(arch)
    jp, carried = _weights(jcfg, 3)
    tp = init_params(tcfg, 3, device="cpu")
    assert _shapes(jp) == _shapes(tree_map(lambda t: t.numpy(), tp)) == \
        _shapes(tree_map(lambda t: t.numpy(), carried))
    for a, b in zip(jax.tree.leaves(jp), tree_leaves_sorted(carried)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert sum(t.numel() for t in tree_leaves(tp)) == tcfg.param_count()
    assert _shapes(jax_init_cache(jcfg, 2, 16)) == _shapes(
        tree_map(lambda t: t.numpy(), init_cache(tcfg, 2, 16, device="cpu")))


@pytest.mark.parametrize("arch", ARCHS)
def test_router_topk_matches_reference(arch):
    """The router's renormalized top-k values, their experts and the
    (T, E) probabilities on 64 tokens."""
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _weights(jcfg, 1)
    x = np.random.default_rng(1).normal(size=(64, jcfg.d_model)) \
        .astype(np.float32)
    jv, ji, jpr = JM.router_topk(_block(jp), jnp.asarray(x), jcfg)
    tv, ti, tpr = TM.router_topk(_block(tp), torch.from_numpy(x), tcfg)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    _close(tv, jv)
    _close(tpr, jpr)
    np.testing.assert_allclose(tv.sum(-1).numpy(), 1.0, rtol=0, atol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_dense_matches_reference(arch):
    """moe_ffn_dense's output and load-balance loss on (2, 24, d) inputs:
    every expert on every token, combined by the router's weights (silu
    experts for qwen3, tanh-GELU for grok)."""
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _weights(jcfg, 2)
    x = np.random.default_rng(2).normal(size=(2, 24, jcfg.d_model)) \
        .astype(np.float32)
    for g in range(jcfg.n_groups_scan):
        jo, ja = JM.moe_ffn_dense(_block(jp, g), jnp.asarray(x), jcfg)
        to, ta = TM.moe_ffn_dense(_block(tp, g), torch.from_numpy(x), tcfg)
        assert to.shape == x.shape and to.dtype == torch.float32
        _close(to, jo)
        _close(ta, ja)


class _OneRankMesh:
    """What the sharded MoE reads of a mesh (names, shape, this rank's
    coordinates): one rank, and no process group (the int8 check below
    raises before any collective)."""
    mesh_dim_names = ("data", "model")
    shape = (1, 1)

    def get_local_rank(self, axis):
        return 0


def test_moe_block_ffn_sharded_path_raises():
    """moe_block_ffn takes the dense path without a mesh and the sharded
    one under a mesh (tests/test_torch_sharded_blocks.py), which, like
    the dense one, raises for int8 experts before any collective."""
    from repro_torch.sharding import make_parallel
    jcfg, tcfg = _cfgs("qwen3_moe_235b")
    _, tp = _weights(jcfg)
    x = torch.zeros((1, 2, tcfg.d_model))
    out, _ = TM.moe_block_ffn(_block(tp), x, tcfg)
    assert out.shape == x.shape
    par = make_parallel(_OneRankMesh(), "serve", moe_mode="ep")
    with pytest.raises(TypeError, match="reference does not compute int8"):
        TM.moe_block_ffn(tree_map(lambda t: t[0], quantize_exec_tree(tp)[
            "blocks"][0]), x, tcfg, parallel=par)


@pytest.mark.parametrize("impl", ["naive", "cuda"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch, impl):
    """forward's logits and aux_loss (each MoE layer's load-balance loss
    summed) on (2, 20) tokens, under the naive and the kernel path (the
    kernels' plain versions on the CPU)."""
    jcfg, tcfg = _cfgs(arch, impl)
    jp, tp = _weights(jcfg, 3)
    toks = np.random.default_rng(3).integers(0, jcfg.vocab, (2, 20)) \
        .astype(np.int32)
    jl, je = jax_forward(jp, jnp.asarray(toks), jcfg)
    tl, te = forward(tp, torch.from_numpy(toks), tcfg)
    _close(tl, jl)
    _close(te["aux_loss"], je["aux_loss"])
    assert float(te["aux_loss"]) > 0


def _engine_run(eng, rng, vocab):
    """A ragged group prefill, 4 decode steps, a backfill into slot 0 and
    2 more steps. Returns the logits of every step."""
    out = []

    def greedy():
        return out[-1].argmax(-1).astype(np.int32)[:, None]
    prompts = rng.integers(0, vocab, (2, 8), dtype=np.int32)
    out.append(eng.run_prefill(prompts, lengths=[8, 5]))
    for _ in range(4):
        out.append(eng.run_decode(greedy()))
    nxt = greedy()
    row = np.zeros(6, np.int32)
    row[2:] = rng.integers(0, vocab, 4, dtype=np.int32)
    out.append(eng.prefill_row(row, 0, length=4))
    nxt[0, 0] = out[-1].argmax(-1)
    out.append(eng.run_decode(nxt))
    out.append(eng.run_decode(greedy()))
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_matches_reference_engine(arch):
    """The port's InferenceEngine (kernel path) against the reference's
    on the same weights: a ragged run_prefill, 4 run_decode steps and a
    prefill_row backfill, then decode steps over the backfilled slot;
    each step's logits within MODEL_TOL and its greedy tokens equal."""
    jcfg, tcfg = _cfgs(arch, "cuda")
    jp, tp = _weights(jcfg, 4)
    je = JaxEngine(jcfg, jp, batch_size=2, max_seq=32)
    te = InferenceEngine(tcfg, tp, batch_size=2, max_seq=32, device="cpu")
    te.warmup(prompt_len=8)
    assert te._maskable and te._backfillable
    assert je._maskable and je._backfillable
    want = _engine_run(je, np.random.default_rng(4), jcfg.vocab)
    got = _engine_run(te, np.random.default_rng(4), jcfg.vocab)
    assert len(got) == len(want) == 8
    for g, w in zip(got, want):
        _close(g, w, MODEL_TOL[arch])
        np.testing.assert_array_equal(g.argmax(-1), w.argmax(-1))


@pytest.mark.parametrize("remat", ["none", "block"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch, remat):
    """make_loss_fn (cross-entropy plus 0.01 x the aux loss) and its
    gradient through every leaf, router and experts included, against
    jax.value_and_grad of the reference's (grok's SOFTCAP_LEAVES within
    MODEL_TOL, every other leaf within TOL); with remat="block" each
    group's aux loss passes through the recompute too."""
    jcfg, tcfg = _cfgs(arch, remat=remat)
    jp, tp = _weights(jcfg, 5)
    rng = np.random.default_rng(5)
    toks = rng.integers(0, jcfg.vocab, (2, 17)).astype(np.int32)
    batch = {"inputs": toks[:, :-1], "labels": toks[:, 1:]}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    (jtot, jm), jg = jax.value_and_grad(JS.make_loss_fn(jcfg, aux_weight=0.01),
                                        has_aux=True)(jp, jb)
    (ttot, tm), tg = TS.value_and_grad(TS.make_loss_fn(tcfg, 0.01), tp, tb)
    _close(ttot, jtot)
    _close(tm["aux_loss"], jm["aux_loss"])
    assert float(tm["aux_loss"]) > 0
    got, want = tree_leaves_sorted(tg), jax.tree_util.tree_leaves_with_path(jg)
    assert len(got) == len(want)
    for g, (path, w) in zip(got, want):
        w = np.asarray(w, np.float32)
        tol = MODEL_TOL[arch] if path[-1].key in SOFTCAP_LEAVES else TOL
        np.testing.assert_allclose(
            g.numpy(), w, rtol=0, atol=tol * max(np.abs(w).max(), 1e-30),
            err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("arch", ARCHS)
def test_int8_experts_raise_on_both_sides(arch):
    """quantize_exec_tree turns the expert leaves into {"q", "scale"}
    leaves on both sides; neither forward computes them (the reference's
    einsum cannot take the dict, the port raises a TypeError that says
    so) and the port does not dequantize them in silence."""
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _weights(jcfg, 6)
    jq, tq = jax_quantize(jp), quantize_exec_tree(tp)
    assert set(tq["blocks"][0]["w_up"]) == {"q", "scale"}
    toks = np.zeros((1, 4), np.int32)
    with pytest.raises(Exception):
        jax_forward(jq, jnp.asarray(toks), jcfg)
    with pytest.raises(TypeError, match="reference does not compute int8"):
        forward(tq, torch.from_numpy(toks), tcfg)


def test_fan_in3_scales_by_input_width():
    """init_params draws each expert weight with std 1/sqrt(its input
    width): d for the up and gate weights, f for the down weights (the
    fan_in3 init)."""
    cfg = dataclasses.replace(reduced_config("qwen3_moe_235b"), d_model=256,
                              moe=dataclasses.replace(
                                  reduced_config("qwen3_moe_235b").moe,
                                  d_ff_expert=64))
    p = init_params(cfg, 0, device="cpu")["blocks"][0]
    for key, fan in (("w_up", 256), ("w_gate", 256), ("w_down", 64)):
        std = float(p[key].std())
        assert abs(std * np.sqrt(fan) - 1.0) < 0.02, (key, std)
