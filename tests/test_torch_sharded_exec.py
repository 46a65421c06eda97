"""The port's sharded serving path on gloo ranks on the CPU, held against
the reference's UNSHARDED outputs (the equivalence the reference's own
tests/test_sharded_exec.py asserts; its sharded decode cannot serve as
an oracle under jax 0.9.0, whose cache write refuses the flash-decode
layout).

Two spawns of ranks (`torch.multiprocessing`, `file://` init under
tmp_path, one thread a rank; their code is tests/sharded_ranks.py, which
imports no jax) from one module-scoped fixture: the (2, 4) ranks run
while this process computes the (2, 2) cases' references. The tests
read their results.

- Mesh (2, 2) ("data", "model"): the heads-sharded path (n_kv_heads
  divides the model axis). stablelm, yi-9b, gemma2-9b (tied embedding,
  sandwich norms, softcaps, its window-8 ring wrapped) and deepseek's
  padded heads (8 q heads on 2 kv heads; against the port's unsharded
  path, see Reference): forward, a prefill with
  left-padded `valid_from` and a row that attends no slot, 16 decode
  steps, and the prefill cache gathered back; stablelm with int8
  projections; the engine's `run_prefill`, `run_decode` and
  `prefill_row` against the unsharded port engine, for stablelm and for
  gemma2's tied table (its window widened to max_seq so a row
  backfills; the engine gathers the table's d over data once);
  `make_mesh` at the wrong world size raises.
- Mesh (2, 4): flash decode engaged (n_kv_heads does not divide 4; the
  tests assert `flash_decode_sharded` ran once a layer a step). yi-9b
  (4 q heads on 2 kv heads: two ranks share a kv head), gemma2-9b (its
  ring wraps in prefill and in decode) and 12 q heads on 3 kv heads
  (local q heads that straddle kv groups; against the port's unsharded
  path), at max_seq 32; the engine
  over a sequence-sharded cache (the backfilled row gathered over the
  model axis before its merge).

Reference: the reference's `init_params`, its `forward`,
`prefill` and `decode_step` on the naive attention (int8: its
`quantize_exec_tree`, whose projections run its int8 kernel in
interpret mode), computed in this process; the ranks import no jax.
deepseek's padded heads and the 12-on-3 head layout are held against
the port's unsharded path instead (the same inputs through the port's
`forward` / `prefill` / `decode_step`, which tests/test_torch_dense.py
holds against the reference, padded heads included): the reference's
compiles cost this file more time than its 60 s allow.

Tolerances: logits within 1e-4 of max|logit| in fp32 and with int8
projections (tests/test_kernels.py's fp32 kernel tolerances are 2e-5
for attention and 1e-4 for int8_matmul; the row-parallel sums add in
another order than one matmul). The reference's own sharded test
allows 2e-3 (MoE layouts) and 5e-3 (flash decode); these are tighter.
Stored positions bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jax_reduced_config
from repro.models import init_params as jax_init_params
from repro.models.model import decode_step as jax_decode_step
from repro.models.model import forward as jax_forward
from repro.models.model import prefill as jax_prefill
from repro.quant.int8 import quantize_exec_tree as jax_quantize
from repro_torch.configs import reduced_config
from repro_torch.models import (decode_step, forward, from_jax, init_params,
                                prefill)
from repro_torch.models.params import tree_map
from repro_torch.serving.engine import InferenceEngine
from repro_torch.sharding import ParallelConfig
from sharded_ranks import (B, LENGTHS, MAX_SEQ, STEPS, T, Ranks,
                           drive_engine)

TOL = 1e-4
# valid_from of every model case: rows 1 and 2 left-padded, row 3
# attends no slot (zeros from every attention).
VF = np.array([0, 3, 7, 100], np.int32)



def _cfgs(arch, **kw):
    """(reference config, port config): reduced, kw on both sides; the
    port runs its kernel path (plain versions on the CPU)."""
    return (dataclasses.replace(jax_reduced_config(arch), attn_impl="naive",
                                **kw),
            dataclasses.replace(reduced_config(arch), attn_impl="cuda", **kw))


def _reference_case(name, arch, seed, quant=False, **kw):
    """One model case: the reference's weights (numpy), inputs, and its
    unsharded forward, prefill (logits and cache) and decode logits, from
    one jitted function (one compile a case)."""
    jcfg, tcfg = _cfgs(arch, **kw)
    jp = jax_init_params(jcfg, jax.random.PRNGKey(seed))
    if quant:
        jp = jax_quantize(jp)
    rng = np.random.default_rng(seed)
    x = rng.integers(0, tcfg.vocab, (B, T + STEPS)).astype(np.int32)

    def run(p, x, vf):
        fwd, _ = jax_forward(p, x[:, :T], jcfg)
        pre, cache = jax_prefill(p, x[:, :T], jcfg, MAX_SEQ, valid_from=vf)

        def step(c, i):
            tok = jax.lax.dynamic_slice_in_dim(x, T + i, 1, axis=1)
            lg, c = jax_decode_step(p, tok, c, (T + i).astype(jnp.int32),
                                    jcfg, valid_from=vf)
            return c, lg[:, 0]
        _, dec = jax.lax.scan(step, cache, jnp.arange(STEPS))
        return fwd, pre, cache, dec.transpose(1, 0, 2)
    fwd, pre, cache, dec = jax.jit(run)(jp, jnp.asarray(x), jnp.asarray(VF))
    return dict(name=name, cfg=tcfg, params=jax.tree.map(np.asarray, jp),
                tokens=x, vf=VF, forward=np.asarray(fwd),
                prefill=np.asarray(pre), cache=jax.tree.map(np.asarray, cache),
                decode=np.asarray(dec))


def _port_case(name, arch, seed, **kw):
    """A model case held against the port's own unsharded path (for
    head layouts no reference config has; tests/test_torch_dense.py
    holds that path against the reference): the same dict as
    `_reference_case`'s, from the port's `init_params`."""
    _, tcfg = _cfgs(arch, **kw)
    params = init_params(tcfg, seed, device="cpu")
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(
        rng.integers(0, tcfg.vocab, (B, T + STEPS)).astype(np.int32))
    vf = torch.from_numpy(VF)
    with torch.no_grad():
        fwd, _ = forward(params, x[:, :T], tcfg)
        pre, cache = prefill(params, x[:, :T], tcfg, MAX_SEQ, valid_from=vf)
        pre_cache = tree_map(lambda t: t.numpy().copy(), cache)
        dec = [decode_step(params, x[:, T + i:T + i + 1], cache, T + i, tcfg,
                           valid_from=vf)[0][:, 0].numpy()
               for i in range(STEPS)]
    return dict(name=name, cfg=tcfg,
                params=tree_map(lambda t: t.numpy(), params),
                tokens=x.numpy(), vf=VF, forward=fwd.numpy(),
                prefill=pre.numpy(), cache=pre_cache, decode=np.stack(dec, 1))


def _engine_case(name, arch, seed, **kw):
    """The unsharded port engine's outputs: a left-padded group prefill,
    3 decode steps, a backfill into slot 1, 3 more decode steps."""
    jcfg, tcfg = _cfgs(arch, **kw)
    params = jax.tree.map(np.asarray,
                          jax_init_params(jcfg, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    prompts = rng.integers(0, tcfg.vocab, (B, T)).astype(np.int32)
    row = rng.integers(0, tcfg.vocab, (8,)).astype(np.int32)
    toks = rng.integers(0, tcfg.vocab, (6, B, 1)).astype(np.int32)
    eng = InferenceEngine(tcfg, from_jax(params, device="cpu"),
                          batch_size=B, max_seq=MAX_SEQ, device="cpu")
    out = drive_engine(eng, prompts, row, toks)
    return dict(name=name, cfg=tcfg, params=params, prompts=prompts,
                row=row, toks=toks, want=out)


@pytest.fixture(scope="module")
def meshes(tmp_path_factory):
    """Both meshes' rank results. The (2, 4) ranks start as soon as
    their references are computed and run while this process computes
    the rest."""
    yi = _reference_case("yi", "yi_9b", 1)
    gemma2 = _reference_case("gemma2", "gemma2_9b", 2)
    mesh24 = Ranks(tmp_path_factory.mktemp("mesh24"), (2, 4), [
        yi, gemma2,
        _port_case("yi_12q_3kv", "yi_9b", 5, n_heads=12, n_kv_heads=3),
        _engine_case("engine_yi", "yi_9b", 7)])
    mesh22 = Ranks(tmp_path_factory.mktemp("mesh22"), (2, 2), [
        _reference_case("stablelm", "stablelm_1_6b", 0), yi, gemma2,
        _reference_case("stablelm_int8", "stablelm_1_6b", 3, quant=True),
        _port_case("deepseek_padded", "deepseek_coder_33b", 4,
                   tp_pad_heads=8),
        _engine_case("engine_stablelm", "stablelm_1_6b", 6),
        # Tied table; a window of max_seq lets a row backfill.
        _engine_case("engine_gemma2", "gemma2_9b", 8, window=MAX_SEQ)])
    return {"mesh22": mesh22.results(), "mesh24": mesh24.results()}


@pytest.fixture(scope="module")
def mesh22(meshes):
    return meshes["mesh22"]


@pytest.fixture(scope="module")
def mesh24(meshes):
    return meshes["mesh24"]


MODEL_CHECKS = ("forward", "prefill", "cache", "decode")


@pytest.mark.parametrize("check", MODEL_CHECKS)
@pytest.mark.parametrize("name", ["stablelm", "yi", "gemma2",
                                  "stablelm_int8", "deepseek_padded"])
def test_heads_sharded_matches_unsharded_reference(mesh22, name, check):
    """Mesh (2, 2): every rank's logits (all-gathered) and gathered
    prefill cache against the reference's unsharded ones; stored
    positions bit for bit; no flash decode (kv heads shard)."""
    for r in mesh22:
        assert r[name][check] <= TOL, (name, check, r[name][check])
        assert r[name]["cache_pos_equal"]
        assert r[name]["flash_decode_calls"] == 0


@pytest.mark.parametrize("check", MODEL_CHECKS)
@pytest.mark.parametrize("name", ["yi", "gemma2", "yi_12q_3kv"])
def test_flash_decode_matches_unsharded_reference(mesh24, name, check):
    """Mesh (2, 4): the sequence-sharded cache and flash decode (engaged:
    one call a layer a step) against the reference's unsharded outputs,
    with a row that attends no slot."""
    for r in mesh24:
        assert r[name][check] <= TOL, (name, check, r[name][check])
        assert r[name]["cache_pos_equal"]
        assert r[name]["flash_decode_calls"] == STEPS * r[name]["n_layers"]


@pytest.mark.parametrize("mesh", ["mesh22", "mesh24"])
@pytest.mark.parametrize("check", ["prefill", "decode", "backfill"])
def test_engine_matches_unsharded_engine(request, mesh, check):
    """The engine's run_prefill, run_decode and prefill_row on every rank
    against the unsharded port engine (mesh (2, 4): the backfilled row
    merged into a sequence-sharded cache)."""
    name = "engine_stablelm" if mesh == "mesh22" else "engine_yi"
    for r in request.getfixturevalue(mesh):
        assert r[name][check] <= TOL, (name, check, r[name][check])
        assert not r[name]["embed_whole"]     # untied: the table stays cut


@pytest.mark.parametrize("check", ["prefill", "decode", "backfill"])
def test_engine_tied_table_matches_unsharded_engine(mesh22, check):
    """gemma2's tied table on mesh (2, 2): the engine gathers its d over
    data once, when it is built, and its steps against the unsharded
    port engine."""
    for r in mesh22:
        assert r["engine_gemma2"][check] <= TOL, (check, r["engine_gemma2"])
        assert r["engine_gemma2"]["embed_whole"]


def test_make_mesh_raises_at_wrong_world_size(mesh22):
    assert all(r["make_mesh_raises"] for r in mesh22)


class _FakeMesh:
    mesh_dim_names = ("data", "model")
    shape = (2, 2)


@pytest.mark.parametrize("arch", ["qwen3_moe_235b", "recurrentgemma_2b",
                                  "mamba2_2_7b"])
def test_unsupported_blocks_raise_under_parallel(arch):
    """The MoE, RG-LRU and SSD blocks compute under the serve profile
    (tests/test_torch_sharded_blocks.py); under the train profile they
    raise (before any collective), from forward, prefill and the
    engine."""
    cfg = reduced_config(arch)
    par = ParallelConfig(mesh=_FakeMesh(), data_axes=("data",),
                         profile="train")
    params = init_params(cfg, 0, device="cpu")
    x = torch.zeros((B, 4), dtype=torch.int32)
    for call in (lambda: forward(params, x, cfg, parallel=par),
                 lambda: prefill(params, x, cfg, 8, parallel=par),
                 lambda: InferenceEngine(cfg, params, batch_size=B,
                                         max_seq=8, device="cpu",
                                         parallel=par)):
        with pytest.raises(NotImplementedError,
                           match="queue 1 item 3.3"):
            call()


@pytest.mark.parametrize("kw", [{"profile": "train"},
                                {"profile": "serve", "seq_shard": True},
                                {"profile": "serve", "attn_pin": True}])
def test_train_profile_levers_raise_under_parallel(kw):
    cfg = reduced_config("stablelm_1_6b")
    par = ParallelConfig(mesh=_FakeMesh(), data_axes=("data",), **kw)
    params = init_params(cfg, 0, device="cpu")
    with pytest.raises(NotImplementedError, match="queue 1 item 3.3"):
        forward(params, torch.zeros((B, 4), dtype=torch.int32), cfg,
                parallel=par)
