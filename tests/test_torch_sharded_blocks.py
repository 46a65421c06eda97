"""The port's sharded MoE, RG-LRU and SSD blocks on gloo ranks on the CPU,
held against the reference's UNSHARDED outputs (the reference's own
sharded programs fail under jax 0.9.0, so they cannot be the oracle).

Two spawns of ranks (tests/sharded_ranks.py, which imports no jax), one
module-scoped fixture: the (2, 4) ranks run while this process computes
the (2, 2) cases' references.

- Mesh (2, 2), the reference's MoE matrix (its tests/test_sharded_exec.py
  `MOE_OK`): qwen3-moe reduced in moe_mode ep and ep2d, grok-1 reduced
  in tp and tp2d, at capacity_factor = n_experts (no pair drops, so the
  sharded FFN computes the dense one): forward, a prefill with
  left-padded `valid_from` and a row that attends no slot, 16 decode
  steps, the prefill cache gathered back; and the engine's
  `run_prefill`, `run_decode` and `prefill_row` against the unsharded
  port engine (its B = 1 backfill row does not divide the data axis:
  every rank holds it whole, and ep2d / tp2d sum their ff partials over
  data instead of scattering them).
- Meshes (2, 2) and (2, 2, 2) (pod, data, model; the (2, 4) ranks),
  tight capacity: `moe_ffn_sharded` alone at capacity_factor 0.5 (C =
  T_tok / 4 at E = 4, k = 2; pairs drop), in every mode, at B = 4
  (split over the batch axes) and B = 3 (whole on every rank), against
  an oracle composed here from the reference's own
  `router_topk` and `_dispatch_indices` and jnp einsums: each rank's
  shard_map body computed without shard_map, summed over the ranks. The
  aux loss against the mean over data of each shard's
  `_load_balance_loss` (not the dense loss over the whole batch: f * P
  is not linear).
- Mesh (2, 2, 2), ample capacity: `moe_ffn_sharded` in ep2d and tp2d at
  capacity_factor = n_experts (nothing drops) at B = 4 and 3, against
  the reference's `moe_ffn_dense` on the same weights, and the aux loss
  against its loss (the 2d modes route the gathered batch). The
  pod axis holds no ff shard: the port gives each rank its rows back
  where the reference's `psum_scatter` over pod would count the pod
  replicas' partial sums twice.
- Meshes (2, 4) and (2, 2), the recurrent models (the reference's
  `DECODE_OK` runs recurrentgemma-2b at (2, 4)): recurrentgemma reduced
  (RG-LRU width and MLP over the model axis, its one kv head's local
  ring sequence-sharded, wrapping under flash decode) and mamba2 reduced
  (SSD heads over the model axis): forward, an unpadded prefill, 16
  decode steps and the cache gathered back; at (2, 4) also the engine
  (prefill and 6 decode steps; recurrent patterns take no padding and
  no backfill) against the unsharded port engine. mamba2 reduced also
  with n_groups 4 at (2, 2) (a rank's heads span two B/C groups) and 2
  at (2, 4) (half a group a rank).
- No mesh: `_dispatch_indices` bit for bit the reference's, drops
  included; `moe_weight_specs` equal to the reference's in every mode,
  and to the stored experts' `tree_specs`.

Weights: MoE, the reference's `init_params` (numpy); recurrent, the
port's `init_params` carried to the reference (see
tests/test_torch_recurrent.py: the reference's init drives the reduced
RG-LRU gates where fp32 loses accuracy on both sides alike).

Tolerances: logits within 1e-4 of max|logit| (as
tests/test_torch_sharded_exec.py; the row-parallel sums and the
capacity buffer add in another order than the dense path); the
tight-capacity FFN within 2e-5 of max|oracle| (the fp32 kernel
tolerance of tests/test_kernels.py), its aux loss within 1e-6; stored
positions and `_dispatch_indices` bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import reduced_config as jax_reduced_config
from repro.models import init_params as jax_init_params
from repro.models import moe as JM
from repro.models.layers import act_fn as jax_act_fn
from repro.models.model import decode_step as jax_decode_step
from repro.models.model import forward as jax_forward
from repro.models.model import prefill as jax_prefill
from repro_torch import sharding as S
from repro_torch.configs import reduced_config
from repro_torch.models import from_jax, init_params
from repro_torch.models import moe as TM
from repro_torch.models.config import ATTN_KINDS
from repro_torch.models.params import param_logical_axes, tree_map
from repro_torch.serving.engine import InferenceEngine
from sharded_ranks import B, MAX_SEQ, STEPS, T, Ranks, drive_engine

TOL = 1e-4
FFN_TOL, AUX_TOL = 2e-5, 1e-6
# valid_from of the MoE model cases: rows 1 and 2 left-padded, row 3
# attends no slot (zeros from every attention).
VF = np.array([0, 3, 7, 100], np.int32)
MOE_MATRIX = [("qwen3_moe_235b", "ep"), ("qwen3_moe_235b", "ep2d"),
              ("grok_1_314b", "tp"), ("grok_1_314b", "tp2d")]
RECURRENT = ["recurrentgemma_2b", "mamba2_2_7b"]
TIGHT_CF, FFN_T = 0.5, 8
# mamba2's B/C groups in the n_groups > 1 cases: a rank's 8 of 16 heads
# span two groups at (2, 2); its 4 are half a group at (2, 4).
SSD_GROUPS = {"mesh22": 4, "mesh24": 2}
MESH, POD_MESH = (2, 2), (2, 2, 2)


def _cfgs(arch):
    """(reference config, port config), reduced; the port runs its
    kernel path (plain versions on the CPU). MoE configs take
    capacity_factor = n_experts."""
    jcfg, tcfg = jax_reduced_config(arch), reduced_config(arch)
    if tcfg.moe is not None:
        cf = float(tcfg.moe.n_experts)
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
            jcfg.moe, capacity_factor=cf))
        tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(
            tcfg.moe, capacity_factor=cf))
    return (dataclasses.replace(jcfg, attn_impl="naive"),
            dataclasses.replace(tcfg, attn_impl="cuda"))


def _reference_run(jcfg, jp, x, vf):
    """The reference's unsharded forward, prefill (logits, cache) and 16
    decode steps, one jitted function."""
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
    vf = None if vf is None else jnp.asarray(vf)
    return jax.jit(run)(jp, jnp.asarray(x), vf)


def _model_case(name, arch, seed, moe_mode="auto", ssd_groups=None):
    """One model case: weights (numpy), inputs and the reference's
    unsharded outputs. MoE: the reference's weights, left-padded rows;
    recurrent: the port's weights, unpadded rows. ssd_groups: the SSD's
    n_groups on both sides."""
    jcfg, tcfg = _cfgs(arch)
    if ssd_groups is not None:
        jcfg, tcfg = (dataclasses.replace(c, ssd=dataclasses.replace(
            c.ssd, n_groups=ssd_groups)) for c in (jcfg, tcfg))
    rng = np.random.default_rng(seed)
    x = rng.integers(0, tcfg.vocab, (B, T + STEPS)).astype(np.int32)
    if tcfg.moe is not None:
        params = jax.tree.map(np.asarray,
                              jax_init_params(jcfg, jax.random.PRNGKey(seed)))
        vf = VF
    else:
        params = tree_map(lambda t: t.numpy(),
                          init_params(tcfg, seed, device="cpu"))
        vf = None
    fwd, pre, cache, dec = _reference_run(
        jcfg, jax.tree.map(jnp.asarray, params), x, vf)
    return dict(name=name, cfg=tcfg, moe_mode=moe_mode, params=params,
                tokens=x, vf=vf, forward=np.asarray(fwd),
                prefill=np.asarray(pre), cache=jax.tree.map(np.asarray, cache),
                decode=np.asarray(dec))


def _engine_case(name, arch, seed, moe_mode="auto"):
    """The unsharded port engine's outputs (tests/test_torch_moe.py and
    tests/test_torch_recurrent.py hold it against the reference's
    engine): MoE, a left-padded group, 3 decode steps, a backfill into
    slot 1, 3 more; recurrent, an unpadded group and 6 decode steps."""
    jcfg, tcfg = _cfgs(arch)
    rng = np.random.default_rng(seed)
    if tcfg.moe is not None:
        params = jax.tree.map(np.asarray,
                              jax_init_params(jcfg, jax.random.PRNGKey(seed)))
        row = rng.integers(0, tcfg.vocab, (8,)).astype(np.int32)
    else:
        params = tree_map(lambda t: t.numpy(),
                          init_params(tcfg, seed, device="cpu"))
        row = None
    prompts = rng.integers(0, tcfg.vocab, (B, T)).astype(np.int32)
    toks = rng.integers(0, tcfg.vocab, (6, B, 1)).astype(np.int32)
    eng = InferenceEngine(tcfg, from_jax(params, device="cpu"),
                          batch_size=B, max_seq=MAX_SEQ, device="cpu")
    with torch.no_grad():
        want = drive_engine(eng, prompts, row, toks)
    return dict(name=name, cfg=tcfg, moe_mode=moe_mode, params=params,
                prompts=prompts, row=row, toks=toks, want=want)


# -- the tight-capacity oracle ---------------------------------------------

def _jax_capacity(T_tok, m):
    C = max(1, int(np.ceil(T_tok * m.top_k / m.n_experts
                           * m.capacity_factor)))
    return min(C, T_tok)


def _rank_ffn(jcfg, p, xb, E_loc, off):
    """The reference's shard_map body on one rank's tokens xb (B', T, d)
    and (already gathered) weights, without shard_map: its output before
    the collectives, its aux loss, and the pairs it dropped."""
    m = jcfg.moe
    Bl, Tl, d = xb.shape
    x2 = xb.reshape(Bl * Tl, d)
    vals, idx, probs = JM.router_topk(p, x2, jcfg)
    C = _jax_capacity(Bl * Tl, m)
    idx_buf, gate_buf = JM._dispatch_indices(idx, vals, E_loc, off, C)
    bufe = x2[idx_buf].reshape(E_loc, C, d)
    act = jax_act_fn(jcfg.mlp_act)
    g = jnp.einsum("ecd,edf->ecf", bufe, p["w_gate"])
    u = jnp.einsum("ecd,edf->ecf", bufe, p["w_up"])
    y = jnp.einsum("ecf,efd->ecd", act(g) * u, p["w_down"])
    y = y.reshape(E_loc * C, d) * gate_buf[:, None]
    out = jnp.zeros((Bl * Tl, d), y.dtype).at[idx_buf].add(y)
    comb = jnp.zeros((Bl * Tl, m.n_experts), jnp.float32).at[
        jnp.arange(Bl * Tl)[:, None], idx].add(vals)
    aux = JM._load_balance_loss(comb, probs, m.n_experts)
    local = (idx >= off) & (idx < off + E_loc)
    dropped = int(local.sum()) - int((gate_buf > 0).sum())
    return np.asarray(out).reshape(Bl, Tl, d), float(aux), dropped


def _ffn_oracle(jcfg, params, x, mode, shape=MESH):
    """The sharded FFN's output (B, T, d) on every rank after its
    collectives (gathered over data), its aux loss, and the pairs the
    ranks dropped: each rank's body summed over the ranks as its mode's
    collectives sum it. shape: (data, model) or (pod, data, model); the
    batch splits over pod and data, the weights' FSDP axis is data, and
    pod ranks hold the same weights (their copies of an ff partial sum
    count once)."""
    pods, dp, tp = (1,) + tuple(shape) if len(shape) == 2 else shape
    E, f = jcfg.moe.n_experts, jcfg.moe.d_ff_expert
    Bn = x.shape[0]
    nb = pods * dp
    split = Bn % nb == 0
    twod = mode.endswith("2d")
    out = np.zeros(x.shape, np.float64)
    auxes, dropped = [], 0
    for pr, dr in np.ndindex(pods, dp):
        bi = pr * dp + dr
        rows = slice(bi * Bn // nb, (bi + 1) * Bn // nb) if split \
            else slice(0, Bn)
        xb = x if twod else x[rows]
        for mr in range(tp):
            es, fs = slice(None), slice(None)
            E_loc, off = E, 0
            if mode.startswith("ep"):
                E_loc, off = E // tp, mr * (E // tp)
                es = slice(off, off + E_loc)
            if mode == "tp":
                fs = slice(mr * f // tp, (mr + 1) * f // tp)
            elif mode == "ep2d":
                fs = slice(dr * f // dp, (dr + 1) * f // dp)
            elif mode == "tp2d":
                i, n = dr * tp + mr, dp * tp
                fs = slice(i * f // n, (i + 1) * f // n)
            p = {"router": params["router"],
                 "w_gate": params["w_gate"][es][:, :, fs],
                 "w_up": params["w_up"][es][:, :, fs],
                 "w_down": params["w_down"][es][:, fs]}
            y, aux, dr_dropped = _rank_ffn(jcfg, jax.tree.map(jnp.asarray, p),
                                           jnp.asarray(xb), E_loc, off)
            dropped += dr_dropped
            if twod:
                if pr == 0:
                    out += y        # every row's ff partials
            elif split:
                out[rows] += y
            elif bi == 0:
                out += y            # each data rank computes every row
            if mr == 0:
                auxes.append(aux)
    aux = float(np.mean(auxes)) if split else auxes[0]
    return out.astype(np.float32), aux, dropped


def _dense_oracle(jcfg, params, x):
    """The reference's dense FFN on the whole batch (at capacity_factor
    = n_experts nothing drops, so the sharded FFN computes it) and its
    aux loss (ep2d / tp2d route the whole batch, gathered over the batch
    axes, on every rank)."""
    out, aux = JM.moe_ffn_dense(jax.tree.map(jnp.asarray, params),
                                jnp.asarray(x), jcfg)
    return np.asarray(out), float(aux), 0


def _ffn_case(arch, mode, Bn, seed, mesh=MESH, ample=False):
    """moe_ffn_sharded alone: at capacity_factor 0.5 against
    `_ffn_oracle`, or (ample; ep2d / tp2d) at n_experts against
    `_dense_oracle`."""
    jcfg, tcfg = _cfgs(arch)
    if not ample:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
            jcfg.moe, capacity_factor=TIGHT_CF))
        tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(
            tcfg.moe, capacity_factor=TIGHT_CF))
    jp = jax_init_params(jcfg, jax.random.PRNGKey(seed))
    params = {k: np.asarray(jp["blocks"][0][k][0])
              for k in ("router", "w_gate", "w_up", "w_down")}
    x = np.random.default_rng(seed).standard_normal(
        (Bn, FFN_T, tcfg.d_model)).astype(np.float32)
    if ample:
        want, aux, dropped = _dense_oracle(jcfg, params, x)
    else:
        want, aux, dropped = _ffn_oracle(jcfg, params, x, mode, mesh)
    name = f"ffn_{mode}_B{Bn}_{len(mesh)}d" + ("_ample" if ample else "")
    return dict(name=name, cfg=tcfg, moe_mode=mode, mesh=mesh,
                params=params, x=x, want=want, aux=aux, dropped=dropped)


@pytest.fixture(scope="module")
def meshes(tmp_path_factory):
    """Both meshes' rank results, and the tight-capacity cases' dropped
    pair counts."""
    rg = _model_case("recurrentgemma", "recurrentgemma_2b", 11)
    mamba = _model_case("mamba2", "mamba2_2_7b", 12)
    pod = [_ffn_case(arch, mode, Bn, 50 + i, POD_MESH)
           for i, (arch, mode) in enumerate(MOE_MATRIX) for Bn in (4, 3)]
    pod += [_ffn_case(arch, mode, Bn, 60 + i, POD_MESH, ample=True)
            for i, (arch, mode) in enumerate(MOE_MATRIX)
            if mode.endswith("2d") for Bn in (4, 3)]
    mesh24 = Ranks(tmp_path_factory.mktemp("blocks24"), (2, 4), [
        rg, mamba,
        _model_case("mamba2_groups", "mamba2_2_7b", 15,
                    ssd_groups=SSD_GROUPS["mesh24"]),
        _engine_case("engine_recurrentgemma", "recurrentgemma_2b", 13),
        _engine_case("engine_mamba2", "mamba2_2_7b", 14)] + pod)
    cases = [rg, mamba, _model_case("mamba2_groups", "mamba2_2_7b", 16,
                                    ssd_groups=SSD_GROUPS["mesh22"])]
    for i, (arch, mode) in enumerate(MOE_MATRIX):
        cases.append(_model_case(f"{arch}_{mode}", arch, 20 + i // 2, mode))
        cases.append(_engine_case(f"engine_{arch}_{mode}", arch,
                                  30 + i // 2, mode))
    ffn = [_ffn_case(arch, mode, Bn, 40 + i)
           for i, (arch, mode) in enumerate(MOE_MATRIX) for Bn in (4, 3)]
    mesh22 = Ranks(tmp_path_factory.mktemp("blocks22"), MESH, cases + ffn)
    return {"mesh22": mesh22.results(), "mesh24": mesh24.results(),
            "dropped": {c["name"]: c["dropped"] for c in ffn + pod}}


MODEL_CHECKS = ("forward", "prefill", "cache", "decode")


@pytest.mark.parametrize("check", MODEL_CHECKS)
@pytest.mark.parametrize("arch, mode", MOE_MATRIX)
def test_moe_matrix_matches_unsharded_reference(meshes, arch, mode, check):
    """Mesh (2, 2), capacity_factor = n_experts: every rank's logits and
    gathered prefill cache against the reference's unsharded ones;
    stored positions bit for bit; heads-sharded attention (no flash
    decode)."""
    name = f"{arch}_{mode}"
    for r in meshes["mesh22"]:
        assert r[name][check] <= TOL, (name, check, r[name][check])
        assert r[name]["cache_pos_equal"]
        assert r[name]["flash_decode_calls"] == 0


@pytest.mark.parametrize("check", ["prefill", "decode", "backfill"])
@pytest.mark.parametrize("arch, mode", MOE_MATRIX)
def test_moe_engine_matches_unsharded_engine(meshes, arch, mode, check):
    """The engine over the sharded MoE (the backfill's B = 1 row whole on
    every rank) against the unsharded port engine."""
    name = f"engine_{arch}_{mode}"
    for r in meshes["mesh22"]:
        assert r[name][check] <= TOL, (name, check, r[name][check])


@pytest.mark.parametrize("mesh", ["mesh22", "mesh24"])
@pytest.mark.parametrize("Bn", [4, 3])
@pytest.mark.parametrize("arch, mode", MOE_MATRIX)
def test_moe_ffn_tight_capacity_matches_oracle(meshes, arch, mode, Bn, mesh):
    """capacity_factor 0.5, pairs dropped: the sharded FFN within 2e-5 of
    max|oracle| on every rank, its aux loss within 1e-6 of the mean of
    the shards' load-balance losses. B = 3 does not divide the data
    axes: every rank holds the whole batch. mesh24's ranks run it on
    mesh (2, 2, 2) (pod, data, model): the batch over pod and data, the
    ff shards of ep2d / tp2d over data only."""
    name = f"ffn_{mode}_B{Bn}_{2 if mesh == 'mesh22' else 3}d"
    assert meshes["dropped"][name] > 0
    for r in meshes[mesh]:
        assert r[name]["out"] <= FFN_TOL, (name, r[name])
        assert r[name]["aux"] <= AUX_TOL, (name, r[name])


@pytest.mark.parametrize("Bn", [4, 3])
@pytest.mark.parametrize("mode", ["ep2d", "tp2d"])
def test_moe_ffn_pod_mesh_ample_matches_dense(meshes, mode, Bn):
    """Mesh (2, 2, 2) (pod, data, model), capacity_factor = n_experts:
    the sharded FFN within 2e-5 of max|out| of the reference's
    moe_ffn_dense on every rank (each pod replica's ff partial sums
    count once), its aux loss within 1e-6 of the dense loss (every rank
    routes the whole batch)."""
    name = f"ffn_{mode}_B{Bn}_3d_ample"
    for r in meshes["mesh24"]:
        assert r[name]["out"] <= FFN_TOL, (name, r[name])
        assert r[name]["aux"] <= AUX_TOL, (name, r[name])


def _attn_layers(cfg):
    return (cfg.n_groups_scan * sum(k in ATTN_KINDS for k in cfg.pattern)
            + sum(k in ATTN_KINDS for k in cfg.tail_kinds))


@pytest.mark.parametrize("check", MODEL_CHECKS)
@pytest.mark.parametrize("mesh", ["mesh22", "mesh24"])
@pytest.mark.parametrize("arch", RECURRENT + ["mamba2_groups"])
def test_recurrent_matches_unsharded_reference(meshes, arch, mesh, check):
    """RG-LRU width and SSD heads over the model axis: every rank's
    logits and gathered cache against the reference's unsharded ones;
    recurrentgemma's local layers (one kv head) decode through flash
    decode, once a layer a step. mamba2_groups: mamba2 with n_groups 4
    (mesh (2, 2)) and 2 (mesh (2, 4)), each rank cutting the B/C groups
    to its heads' groups."""
    name = {"recurrentgemma_2b": "recurrentgemma",
            "mamba2_2_7b": "mamba2"}.get(arch, arch)
    cfg = reduced_config("mamba2_2_7b" if arch == "mamba2_groups" else arch)
    for r in meshes[mesh]:
        assert r[name][check] <= TOL, (name, check, r[name][check])
        assert r[name]["cache_pos_equal"]
        assert r[name]["flash_decode_calls"] == STEPS * _attn_layers(cfg)


@pytest.mark.parametrize("check", ["prefill", "decode"])
@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_engine_matches_unsharded_engine(meshes, arch, check):
    name = ("engine_recurrentgemma" if arch == "recurrentgemma_2b"
            else "engine_mamba2")
    for r in meshes["mesh24"]:
        assert r[name][check] <= TOL, (name, check, r[name][check])


# -- pure functions, no mesh ---------------------------------------------------

@pytest.mark.parametrize("T, k, E, E_loc, off, C, drops", [
    (16, 2, 4, 4, 0, 4, True),        # tp modes: every expert local
    (16, 2, 4, 2, 2, 3, True),        # ep: the upper half
    (16, 2, 4, 2, 0, 16, False),      # ep: ample capacity
    (9, 3, 8, 2, 4, 1, True),         # one slot an expert
    (33, 8, 128, 32, 96, 2, True),    # qwen3's top 8 of 128, a quarter
    (5, 1, 3, 3, 0, 1, True),
])
def test_dispatch_indices_bit_for_bit(T, k, E, E_loc, off, C, drops):
    rng = np.random.default_rng(T * 100 + C)
    idx = np.stack([rng.permutation(E)[:k] for _ in range(T)]).astype(
        np.int32)
    vals = rng.random((T, k)).astype(np.float32)
    want = JM._dispatch_indices(jnp.asarray(idx), jnp.asarray(vals), E_loc,
                                off, C)
    got = TM._dispatch_indices(torch.from_numpy(idx).long(),
                               torch.from_numpy(vals), E_loc, off, C)
    for g, w in zip(got, want):
        assert g.numpy().dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    local = int(((idx >= off) & (idx < off + E_loc)).sum())
    kept = int((np.asarray(want[1]) > 0).sum())
    assert (kept < local) == drops


class _FakeMesh:
    mesh_dim_names = ("data", "model")
    shape = (2, 2)


@pytest.mark.parametrize("mode", ["ep", "tp", "ep2d", "tp2d"])
def test_moe_weight_specs_match_reference(mode):
    """The port's specs equal the reference's (as PartitionSpecs), and
    tree_specs lays the stored experts (behind their layers axis) out
    by them."""
    got = TM.moe_weight_specs(mode, "model", ("data",))
    want = JM.moe_weight_specs(mode, "model", ("data",))
    for g, w in zip(got, want, strict=True):
        assert isinstance(g, S.Spec) and P(*g) == w, (g, w)
    arch = "qwen3_moe_235b" if mode.startswith("ep") else "grok_1_314b"
    cfg = reduced_config(arch)
    par = S.ParallelConfig(mesh=_FakeMesh(), data_axes=("data",),
                           profile="serve", moe_mode=mode)
    blk = S.tree_specs(param_logical_axes(cfg), par, cfg)["blocks"][0]
    for key, spec in (("w_gate", got[0]), ("w_up", got[0]),
                      ("w_down", got[1])):
        assert blk[key] == S.Spec(None, *spec), (key, blk[key], spec)


# -- one rank: a one-rank gloo group in this process ------------------------

@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    """make_parallel over a mesh (1, 1) of a one-rank gloo group, for
    the module's tests (the group is destroyed after them)."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    init = tmp_path_factory.mktemp("one_rank") / "init"
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=0,
                            world_size=1)
    mesh = make_mesh((1, 1), ("data", "model"))
    try:
        yield lambda moe_mode="auto": S.make_parallel(mesh, "serve",
                                                      moe_mode=moe_mode)
    finally:
        dist.destroy_process_group()


def test_collectives_over_one_rank_return_their_input(one_rank):
    """all_gather and reduce_scatter over axes of size 1 return x
    itself, the same storage (on the card's one-rank mesh a layer's
    expert weights are not copied); all_reduce makes its call, in place
    (on the card's one-rank NCCL mesh the engine's graphs capture it)."""
    par = one_rank()
    x = torch.randn(4, 3, 2)
    assert S.all_gather(x, par, ("data",), 1) is x
    assert S.all_gather(x, par, ("data", "model"), 0) is x
    assert S.all_reduce(x, par, "model") is x
    assert S.reduce_scatter(x, par, ("data",), 0) is x


@pytest.mark.parametrize("mode", ["ep", "tp", "ep2d", "tp2d"])
def test_moe_ffn_one_rank_matches_dense(one_rank, mode):
    """At capacity_factor = n_experts (no drops) the sharded FFN on one
    rank computes the dense FFN, and its aux loss is the dense one (one
    shard holds the whole batch)."""
    _, cfg = _cfgs("qwen3_moe_235b")
    p = {k: v[0] for k, v in
         init_params(cfg, 3, device="cpu")["blocks"][0].items()}
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (3, 5, cfg.d_model)).astype(np.float32))
    want, want_aux = TM.moe_ffn_dense(p, x, cfg)
    got, aux = TM.moe_block_ffn(p, x, cfg, one_rank(mode))
    torch.testing.assert_close(got, want, rtol=0,
                               atol=FFN_TOL * float(want.abs().max()))
    torch.testing.assert_close(aux, want_aux, rtol=0, atol=AUX_TOL)


@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_one_rank_bit_for_bit(one_rank, arch):
    """On a one-rank mesh the sharded recurrent path runs the unsharded
    path's operations (the gathered conv output is u itself, the gated
    norm's averaged mean square its own): forward, prefill and decode
    give the unsharded bits."""
    from repro_torch.models import decode_step, forward, prefill
    from repro_torch.models.params import shard_params
    _, cfg = _cfgs(arch)
    par = one_rank()
    params = init_params(cfg, 4, device="cpu")
    shards = shard_params(params, cfg, par)
    x = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab, (B, T + 3)).astype(np.int32))

    def run(p, parallel):
        with torch.no_grad():
            out = [forward(p, x[:, :T], cfg, parallel=parallel)[0]]
            lg, cache = prefill(p, x[:, :T], cfg, MAX_SEQ, parallel=parallel)
            out.append(lg)
            for i in range(3):
                lg, cache = decode_step(p, x[:, T + i:T + i + 1], cache,
                                        T + i, cfg, parallel=parallel)
                out.append(lg)
        return out
    for g, w in zip(run(shards, par), run(params, None), strict=True):
        assert torch.equal(g, w)
