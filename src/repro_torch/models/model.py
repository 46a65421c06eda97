"""Decoder LM for attention-only, recurrent (RG-LRU, SSD) and MoE block
patterns, on torch tensors.

A model is `n_layers` blocks produced by cycling `cfg.pattern`; layers
are grouped as in the reference (one group = one pass through the
pattern, `n_layers % len(pattern)` tail layers). The reference's
`lax.scan` over stacked groups becomes a Python loop over views of the
stacked leaves: each parameter leaf is unbound once into its groups,
each cache leaf indexed (`cache["blocks"][i][key][g]`), no copy.

Entry points:
  forward(params, inputs, cfg)                      -> (logits, {"aux_loss", "cache"})
  forward(..., cache=init_cache(...), positions)    -> prefill: fills cache
  decode_step(params, token, cache, cache_pos, cfg) -> (logits, cache)

Caches are updated in place: `forward` returns the cache it was given.
Attention layers write their k/v/pos buffers, recurrent layers copy
their new state (RG-LRU `h`, SSD `S`, the convolutions' last inputs)
into theirs, so a captured step reads and writes fixed buffers.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts,
                                    noop_context_fn)

from repro_torch.models import params as pmod
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import attn_block, f32_up, rms_norm, softcap
from repro_torch.models.moe import moe_block_ffn
from repro_torch.models.rglru import rglru_block
from repro_torch.models.ssd import ssd_block
from repro_torch.sharding import (all_gather, all_reduce, local_shape,
                                  make_rules, spec_for)
from repro_torch.utils import dtype_of, resolve_device

init_params = pmod.init_params
param_logical_axes = pmod.param_logical_axes
abstract_params = pmod.abstract_params

RECURRENT_KINDS = ("rglru", "ssd")


# --------------------------------------------------------------------------
# Cache construction
# --------------------------------------------------------------------------

def _block_cache_tree(cfg: ModelConfig, kind: str, B: int, max_seq: int,
                      mk):
    """One block's cache via mk(shape, logical axes, dtype name, init)."""
    dt = cfg.compute_dtype
    if kind == "rglru":
        W, K = cfg.lru_width, cfg.rglru.conv_width
        return {
            "h": mk((B, W), ("cache_batch", "rnn_width"), "float32", "zeros"),
            "conv": mk((B, K - 1, W), ("cache_batch", "conv_k", "rnn_width"),
                       dt, "zeros"),
        }
    if kind == "ssd":
        s = cfg.ssd
        nh, N, P = cfg.ssd_heads, s.d_state, s.head_dim
        di, gn, K = cfg.d_inner_ssd, s.n_groups * s.d_state, s.conv_width
        return {
            "S": mk((B, nh, N, P),
                    ("cache_batch", "ssd_heads", "ssd_state", "ssd_hd"),
                    "float32", "zeros"),
            "conv": {
                "x": mk((B, K - 1, di), ("cache_batch", "conv_k", "ssd_inner"),
                        dt, "zeros"),
                "B": mk((B, K - 1, gn), ("cache_batch", "conv_k", "ssd_gn"),
                        dt, "zeros"),
                "C": mk((B, K - 1, gn), ("cache_batch", "conv_k", "ssd_gn"),
                        dt, "zeros"),
            },
        }
    S = min(cfg.window, max_seq) if kind == "local" and cfg.window \
        else max_seq
    KV, hd = cfg.n_kv_heads, cfg.head_dim
    axes = ("cache_batch", "cache_seq", "kv_heads", "head_dim")
    return {
        "k": mk((B, S, KV, hd), axes, dt, "zeros"),
        "v": mk((B, S, KV, hd), axes, dt, "zeros"),
        "pos": mk((S,), ("cache_seq",), "int32", "neg_ones"),
    }


def _cache_tree(cfg: ModelConfig, B: int, max_seq: int, mk):
    """{"blocks": (stacked per pattern kind,), "tail": (...,)}; stacked
    leaves lead with the scan-group axis ("layers")."""
    G = cfg.n_groups_scan

    def mk_stacked(shape, axes, dt, init):
        return mk((G,) + shape, ("layers",) + axes, dt, init)
    return {
        "blocks": tuple(_block_cache_tree(cfg, kind, B, max_seq, mk_stacked)
                        for kind in cfg.pattern),
        "tail": tuple(_block_cache_tree(cfg, kind, B, max_seq, mk)
                      for kind in cfg.tail_kinds),
    }


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, device="cuda",
               parallel=None):
    """Attention layers' k/v buffers (zeros) and stored positions (-1 =
    unwritten); recurrent layers' state (RG-LRU h, SSD S: fp32) and
    convolution inputs (compute dtype), zeros. MoE layers keep an
    attention cache. parallel: this rank's shard of each leaf, laid out
    by `cache_specs`."""
    device = resolve_device(device)
    if parallel is not None:
        rules = _cache_rules(cfg, batch, parallel)

    def mk(shape, axes, dt, init):
        if parallel is not None:
            shape = local_shape(shape, spec_for(axes, rules), parallel.sizes)
        if init == "neg_ones":
            return torch.full(shape, -1, dtype=torch.int32, device=device)
        return torch.zeros(shape, dtype=dtype_of(dt), device=device)
    return _cache_tree(cfg, batch, max_seq, mk)


def _cache_rules(cfg: ModelConfig, batch: int, parallel) -> dict:
    rules = make_rules(parallel, cfg)
    rules["cache_batch"] = parallel.batch_axes(batch)
    return rules


def cache_specs(cfg: ModelConfig, batch: int, max_seq: int, parallel):
    """Each cache leaf's `sharding.Spec` under parallel: the reference's
    `tree_specs(cache_logical_axes(...))`, except that a batch which
    does not divide the data axes stays whole on every rank (as the
    sharded forward computes it)."""
    rules = _cache_rules(cfg, batch, parallel)
    return _cache_tree(cfg, batch, max_seq, lambda shape, axes, dt, init:
                       spec_for(axes, rules))


def abstract_cache(cfg: ModelConfig, batch: int, max_seq: int):
    """The cache tree as meta tensors: shapes and dtypes, no storage."""
    return _cache_tree(cfg, batch, max_seq, lambda shape, axes, dt, init:
                       torch.empty(shape, dtype=dtype_of(dt), device="meta"))


def cache_logical_axes(cfg: ModelConfig, batch: int = 1, max_seq: int = 8):
    """The cache tree's logical sharding axes, one tuple a leaf."""
    return _cache_tree(cfg, batch, max_seq,
                       lambda shape, axes, dt, init: axes)


# --------------------------------------------------------------------------
# Forward / decode
# --------------------------------------------------------------------------

def _index(tree, g: int):
    """One group's slice of a stacked tree (views)."""
    if isinstance(tree, dict):
        return {k: _index(v, g) for k, v in tree.items()}
    return tree[g]


def _unstack(tree, n: int):
    """A stacked tree's n scan groups, each a tree of views. Every leaf
    is unbound once: its backward stacks the n groups' grads in one pass,
    where indexing it group by group would add n zero-padded full-size
    grads (most of a full-width train step's time)."""
    if isinstance(tree, dict):
        parts = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: parts[k][g] for k in parts} for g in range(n)]
    return torch.unbind(tree, 0)


# remat="moe_save": the MoE block's output passes through this identity
# op, which the selective-checkpoint policy saves (the reference's
# checkpoint_name(out, "moe_out") under save_only_these_names).
@torch.library.custom_op("repro_torch::moe_out", mutates_args=())
def _moe_out(x: torch.Tensor) -> torch.Tensor:
    return x.clone()


_moe_out.register_autograd(lambda ctx, grad: grad)


def _moe_save_policy(ctx, op, *args, **kwargs):
    if op is torch.ops.repro_torch.moe_out.default:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _apply_block(kind: str, p, x, cfg: ModelConfig, positions, cache,
                 cache_pos, valid_from, parallel=None):
    """Returns (x, aux): aux the MoE block's load-balance loss, None for
    every other kind."""
    if kind in RECURRENT_KINDS:
        if valid_from is not None:
            # Recurrent state integrates every input step sequentially: a
            # left-padded prompt contaminates h/S/conv in a way no
            # attention mask can undo. Callers must feed unpadded
            # sequences instead.
            raise NotImplementedError(
                f"valid_from masking cannot be applied to recurrent blocks "
                f"({kind}); feed unpadded sequences")
        block = rglru_block if kind == "rglru" else ssd_block
        x, _ = block(p, x, cfg, cache, parallel)
        return x, None
    x, _ = attn_block(p, x, cfg, kind, positions, cache, cache_pos,
                      valid_from, parallel)
    if kind != "moe":
        return x, None
    out, aux = moe_block_ffn(p, rms_norm(x, p["ln2"], cfg.norm_eps), cfg,
                             parallel)
    if cfg.sandwich_norm:
        out = rms_norm(out, p["post_ffn_norm"], cfg.norm_eps)
    if cfg.remat == "moe_save":
        out = _moe_out(out)
    return x + out, aux


def _apply_group(cfg: ModelConfig, ps, x, positions, cs, cache_pos,
                 valid_from, aux, parallel=None):
    """One pass through the pattern: the reference's scan body. Returns
    (x, aux plus the group's MoE losses)."""
    for i, kind in enumerate(cfg.pattern):
        c = None if cs is None else cs[i]
        x, a = _apply_block(kind, ps[i], x, cfg, positions, c, cache_pos,
                            valid_from, parallel)
        if a is not None:
            aux = aux + a
    return x, aux


def check_parallel(cfg: ModelConfig, parallel):
    """Raise for what the sharded path does not compute yet: the train
    profile and its layout levers. The serve profile computes every
    block kind (attention, MoE, RG-LRU, SSD)."""
    if parallel.profile != "serve" or parallel.seq_shard or \
            parallel.attn_pin:
        raise NotImplementedError(
            f"profile={parallel.profile!r} seq_shard={parallel.seq_shard} "
            f"attn_pin={parallel.attn_pin}: the sharded path runs the serve "
            f"profile only; the train profile (FSDP, seq_shard / seq_mode / "
            f"attn_pin) is ROADMAP queue 1 item 3.3")


def whole_embed_table(params, cfg: ModelConfig, parallel):
    """params with a tied embedding table gathered over the data axes
    its `embed` dim shards over (serve profile): the logits read the
    table's whole d at every step, so an engine gathers it once, when
    it is built, and `forward` finds it whole. Otherwise params as they
    are."""
    if parallel is None or not cfg.tie_embeddings:
        return params
    return dict(params, embed=_whole_d(params["embed"], cfg, parallel))


def _whole_d(t, cfg: ModelConfig, parallel):
    """t (..., d/dp), its last dim the `embed` axis's data shard,
    gathered over the data axes into (..., d); t itself where its d is
    already whole."""
    if t.shape[-1] == cfg.d_model:
        return t
    axes = spec_for(("vocab", "embed"), make_rules(parallel, cfg))[1]
    return all_gather(t, parallel, axes, t.ndim - 1)


def _embed(table, inputs, cfg: ModelConfig, parallel, rows):
    """Token embedding rows of this rank's batch rows (`rows`, a slice;
    None: every row). Under parallel the table is this rank's (V/tp,
    d/dp) shard, or (V/tp, d) when gathered (`whole_embed_table`): its
    vocab rows over the model axis where they divide. Each rank looks
    up the whole batch's tokens in the rows it holds (zero rows for the
    rest) and sums them over the model axis: each row is one rank's row
    plus zeros, so it equals the unsharded lookup. A d shard's rows are
    then gathered over the data axes, so (B, T, d) moves and the table
    stays where it is."""
    if parallel is None:
        return table[inputs.long()]
    vocab_axis = make_rules(parallel, cfg)["vocab"]
    if vocab_axis is None:
        x = table[inputs.long()]
    else:
        V_loc = table.shape[0]
        idx = inputs.long() - parallel.index((vocab_axis,)) * V_loc
        inside = (idx >= 0) & (idx < V_loc)
        x = all_reduce(torch.where(inside[..., None],
                                   table[idx.clamp(0, V_loc - 1)], 0.0),
                       parallel, vocab_axis)
    x = _whole_d(x, cfg, parallel)
    return x if rows is None else x[rows]


def forward(params, inputs, cfg: ModelConfig, *, parallel=None, cache=None,
            cache_pos=None, positions=None,
            logits_last_only: bool = False, valid_from=None):
    """inputs: (B,T) int tokens or (B,T,d) embeddings.

    cache=None: plain forward. cache given & T>1: prefill (fills cache in
    place). logits_last_only: unembed only the final position (serving
    prefill — avoids materializing the (B,S,V) logits tensor).
    cache_pos: the decode step's position, the 0-d int32 tensor on the
    device that `decode_step` builds (default 0, as in the reference).
    valid_from: optional (B,) int32 per-row first attendable position
    (attention-only patterns; recurrent blocks raise).
    parallel: a `sharding.ParallelConfig` (serve profile; the train
    profile raises): params are this rank's shards
    (`params.shard_params`), cache this rank's (`init_cache(...,
    parallel=)`); inputs, positions and valid_from are the whole batch's
    on every rank, and each data rank takes its own rows where B divides
    the data axes; otherwise every rank computes every row, and the
    blocks get a ParallelConfig whose `data_axes` is empty (the axes the
    activations' batch is split over: the sharded MoE reads them).
    Every rank returns the whole batch's logits (all-gathered over the
    model and data axes).
    cfg.remat == "block": under autograd and without a cache, each scan
    group's blocks run under `torch.utils.checkpoint` (the reference's
    `jax.checkpoint` of its scan body): their activations are computed
    again in the backward instead of kept. "moe_save": the same, but a
    selective-checkpoint policy keeps each MoE block's output (the
    reference's save_only_these_names("moe_out")); without MoE blocks it
    computes as "block". A cached forward writes its cache in place,
    which a second run would write again, and gives the same values
    either way, so it runs as it is.
    Returns (logits, {"aux_loss": 0-d fp32, "cache": cache}); aux_loss is
    the MoE blocks' load-balance losses summed (zero without MoE)."""
    rows = bpar = None
    if parallel is not None:
        check_parallel(cfg, parallel)
        B = inputs.shape[0]
        bpar = parallel
        if parallel.data_ok(B):
            Bl = B // parallel.dp_size
            d = parallel.index(parallel.data_axes)
            rows = slice(d * Bl, (d + 1) * Bl)
            if valid_from is not None:
                valid_from = valid_from[rows]
        else:
            bpar = dataclasses.replace(parallel, data_axes=())
    compute_dtype = dtype_of(cfg.compute_dtype)
    table = params["embed"]
    if parallel is not None and cfg.tie_embeddings:
        table = _whole_d(table, cfg, parallel)     # the logits read it
    if cfg.input_mode == "embeddings":
        x = (inputs if rows is None else inputs[rows]).to(compute_dtype)
    else:
        x = _embed(table, inputs, cfg, parallel, rows).to(compute_dtype)
    if cfg.embed_scale:
        # A fill on the device (a host tensor would be a copy, which a
        # graph capture refuses), rounded to the compute dtype first as
        # in the reference.
        x = x * torch.full((), math.sqrt(cfg.d_model), dtype=compute_dtype,
                           device=x.device)
    T = x.shape[1]
    if positions is None:
        positions = torch.arange(T, dtype=torch.int32, device=x.device)
    if cache_pos is None:
        cache_pos = torch.zeros((), dtype=torch.int32, device=x.device)

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = (cfg.remat in ("block", "moe_save") and cache is None
             and torch.is_grad_enabled())
    context_fn = noop_context_fn
    if cfg.remat == "moe_save":
        context_fn = functools.partial(create_selective_checkpoint_contexts,
                                       _moe_save_policy)
    G = cfg.n_groups_scan
    groups = [_unstack(b, G) for b in params["blocks"]]
    for g in range(G):
        ps = [b[g] for b in groups]
        cs = None if cache is None else [_index(c, g)
                                         for c in cache["blocks"]]
        if remat:
            x, aux = checkpoint(_apply_group, cfg, ps, x, positions, cs,
                                cache_pos, valid_from, aux, bpar,
                                use_reentrant=False,
                                preserve_rng_state=False,
                                context_fn=context_fn)
        else:
            x, aux = _apply_group(cfg, ps, x, positions, cs, cache_pos,
                                  valid_from, aux, bpar)
    for i, kind in enumerate(cfg.tail_kinds):
        c = None if cache is None else cache["tail"][i]
        x, a = _apply_block(kind, params["tail"][i], x, cfg, positions, c,
                            cache_pos, valid_from, bpar)
        if a is not None:
            aux = aux + a

    if logits_last_only:
        x = x[:, -1:]
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = torch.einsum("btd,vd->btv", x, table.to(x.dtype))
    else:
        logits = torch.einsum("btd,dv->btv", x,
                              params["lm_head"].to(x.dtype))
    logits = softcap(f32_up(logits), cfg.final_softcap)
    if parallel is not None:
        vocab_axis = make_rules(parallel, cfg)["vocab"]
        if vocab_axis is not None:
            logits = all_gather(logits, parallel, vocab_axis, 2)
        if rows is not None:
            logits = all_gather(logits, parallel, parallel.data_axes, 0)
    return logits, {"aux_loss": aux, "cache": cache}


def decode_step(params, token, cache, cache_pos, cfg: ModelConfig, *,
                parallel=None, valid_from=None):
    """One decode step. token: (B,1) int (or (B,1,d) embeddings);
    cache_pos: number of tokens already in context, an int or a 0-d
    int32 tensor on token's device (the two give the same bits; the
    tensor is read only on the device, so a captured step serves every
    position). valid_from: optional (B,) per-row first attendable cache
    position. parallel: as in `forward`. Returns (logits (B,1,V),
    cache)."""
    if isinstance(cache_pos, torch.Tensor):
        if (cache_pos.dtype != torch.int32 or cache_pos.ndim != 0
                or cache_pos.device != token.device):
            raise ValueError(
                f"cache_pos must be an int or a 0-d int32 tensor on "
                f"{token.device}, got {cache_pos.dtype} "
                f"{tuple(cache_pos.shape)} on {cache_pos.device}")
    else:
        cache_pos = torch.full((), cache_pos, dtype=torch.int32,
                               device=token.device)
    positions = cache_pos[None]     # the reference's cache_pos[None]
    logits, extras = forward(params, token, cfg, parallel=parallel,
                             cache=cache, cache_pos=cache_pos,
                             positions=positions, valid_from=valid_from)
    return logits, extras["cache"]


def prefill(params, inputs, cfg: ModelConfig, max_seq: int, *,
            parallel=None, logits_last_only: bool = False, valid_from=None,
            cache=None):
    """Full-sequence prefill: returns (logits, cache ready for decoding).

    valid_from: optional (B,) int32 — with left-padded prompts, row b's
    real tokens start at position valid_from[b]; padding slots are masked
    out of every attention so they cannot contaminate logits or the KV
    cache reads of later decode steps.
    cache: optional (B, max_seq) cache from `init_cache` to prefill in
    place (the serving engine's persistent cache): every stored position
    goes back to -1 (unwritten) and every recurrent state to zeros
    first, so it gives the bits of a fresh cache. None: a fresh cache is
    allocated. parallel: as in `forward` (a given cache is this rank's
    shard)."""
    B, T = inputs.shape[0], inputs.shape[1]
    if cache is None:
        if parallel is not None:
            check_parallel(cfg, parallel)
        cache = init_cache(cfg, B, max_seq, device=inputs.device,
                           parallel=parallel)
    else:
        for c in cache["blocks"] + cache["tail"]:
            if "pos" in c:
                c["pos"].fill_(-1)
            else:
                for leaf in pmod.tree_leaves(c):
                    leaf.zero_()
    logits, extras = forward(
        params, inputs, cfg, parallel=parallel, cache=cache,
        positions=torch.arange(T, dtype=torch.int32, device=inputs.device),
        logits_last_only=logits_last_only, valid_from=valid_from)
    return logits, extras["cache"]
