"""Parameter trees of the attention-only, recurrent and MoE models.

The tree has the reference's structure — {"embed", "final_norm",
"lm_head", "blocks": (stacked dict per pattern kind,), "tail": (dict,)}
with a leading scan-group axis on every "blocks" leaf — so weights carry
across from the reference with a tree walk (`from_jax`).

`init_params` draws from a `torch.Generator` on the target device, so a
full-width model never passes through host memory. Its numbers differ
from the reference's `jax.random` draws for the same seed; tests that
compare the two carry the reference's weights across instead.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.models.config import ATTN_KINDS, ModelConfig
from repro_torch.sharding import Spec, shard_leaf, tree_specs
from repro_torch.utils import dtype_of, resolve_device


def block_tree(cfg: ModelConfig, kind: str, mk):
    """One block's parameter tree via the mk(shape, axes, init) callback
    (axes: the leaf's logical sharding axes, `repro_torch.sharding`)."""
    d = cfg.d_model
    if kind in ATTN_KINDS:
        Hq, KV, hd = cfg.q_heads_padded, cfg.n_kv_heads, cfg.head_dim
        p = {"ln1": mk((d,), ("norm",), "zeros"),
             "wq": mk((d, Hq, hd), ("hidden_in", "heads", "head_dim"),
                      "fan_in"),
             "wk": mk((d, KV, hd), ("hidden_in", "kv_heads", "head_dim"),
                      "fan_in"),
             "wv": mk((d, KV, hd), ("hidden_in", "kv_heads", "head_dim"),
                      "fan_in"),
             "wo": mk((Hq, hd, d), ("heads", "head_dim", "hidden_in"),
                      "fan_io")}
        if cfg.qk_norm:
            p["q_norm"] = mk((hd,), ("norm",), "zeros")
            p["k_norm"] = mk((hd,), ("norm",), "zeros")
        if cfg.sandwich_norm:
            p["post_attn_norm"] = mk((d,), ("norm",), "zeros")
            p["post_ffn_norm"] = mk((d,), ("norm",), "zeros")
        p["ln2"] = mk((d,), ("norm",), "zeros")
        if kind == "moe":
            p.update(_moe_tree(cfg, mk))
        else:
            p["mlp"] = _mlp_tree(cfg, mk)
        return p
    if kind == "rglru":
        w, K = cfg.lru_width, cfg.rglru.conv_width
        return {"ln1": mk((d,), ("norm",), "zeros"),
                "w_gate_branch": mk((d, w), ("hidden_in", "rnn_width"),
                                    "fan_in"),
                "w_in": mk((d, w), ("hidden_in", "rnn_width"), "fan_in"),
                "conv_w": mk((w, K), ("rnn_width", "conv_k"), "conv"),
                "w_a": mk((w, w), ("rnn_in", "rnn_width"), "fan_in"),
                "w_x": mk((w, w), ("rnn_in", "rnn_width"), "fan_in"),
                "b_a": mk((w,), ("rnn_width",), "zeros"),
                "b_x": mk((w,), ("rnn_width",), "zeros"),
                "lam": mk((w,), ("rnn_width",), "lambda"),
                "w_out": mk((w, d), ("rnn_width", "hidden_in"), "fan_in"),
                "ln2": mk((d,), ("norm",), "zeros"),
                "mlp": _mlp_tree(cfg, mk)}
    if kind == "ssd":
        s = cfg.ssd
        di, nh = cfg.d_inner_ssd, cfg.ssd_heads
        gn, K = s.n_groups * s.d_state, s.conv_width
        return {"ln1": mk((d,), ("norm",), "zeros"),
                "w_z": mk((d, di), ("hidden_in", "ssd_inner"), "fan_in"),
                "w_x": mk((d, di), ("hidden_in", "ssd_inner"), "fan_in"),
                "w_B": mk((d, gn), ("hidden_in", "ssd_gn"), "fan_in"),
                "w_C": mk((d, gn), ("hidden_in", "ssd_gn"), "fan_in"),
                "w_dt": mk((d, nh), ("hidden_in", "ssd_heads"), "fan_in"),
                "conv_x": mk((di, K), ("ssd_inner", "conv_k"), "conv"),
                "conv_B": mk((gn, K), ("ssd_gn", "conv_k"), "conv"),
                "conv_C": mk((gn, K), ("ssd_gn", "conv_k"), "conv"),
                "A_log": mk((nh,), ("ssd_heads",), "a_log"),
                "dt_bias": mk((nh,), ("ssd_heads",), "dt_bias"),
                "D": mk((nh,), ("ssd_heads",), "ones"),
                "norm_w": mk((di,), ("ssd_inner",), "ones"),
                "w_out": mk((di, d), ("ssd_inner", "hidden_in"), "fan_in")}
    raise ValueError(f"unknown block kind {kind!r}")


def _moe_tree(cfg: ModelConfig, mk):
    """The router (d, E) and the experts' stacked FFN weights: up and
    gate (E, d, f), down (E, f, d)."""
    d, m = cfg.d_model, cfg.moe
    E, f = m.n_experts, m.d_ff_expert
    p = {"router": mk((d, E), ("hidden_in", "router"), "fan_in"),
         "w_up": mk((E, d, f), ("experts", "expert_in", "expert_ff"),
                    "fan_in3")}
    if cfg.mlp_gated:
        p["w_gate"] = mk((E, d, f), ("experts", "expert_in", "expert_ff"),
                         "fan_in3")
    p["w_down"] = mk((E, f, d), ("experts", "expert_ff", "expert_in"),
                     "fan_in3")
    return p


def _mlp_tree(cfg: ModelConfig, mk):
    d, f = cfg.d_model, cfg.d_ff
    p = {"w_up": mk((d, f), ("hidden_in", "ff"), "fan_in"),
         "w_down": mk((f, d), ("ff", "hidden_in"), "fan_in")}
    if cfg.mlp_gated:
        p["w_gate"] = mk((d, f), ("hidden_in", "ff"), "fan_in")
    return p


def model_tree(cfg: ModelConfig, mk, mk_stacked):
    """Full model parameter tree; mk_stacked(shape, axes, init, n)
    creates a leaf with a leading scan-group axis of size n."""
    d = cfg.d_model
    params = {
        "embed": mk((cfg.padded_vocab, d), ("vocab", "embed"), "embed"),
        "final_norm": mk((d,), ("norm",), "zeros"),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = mk((d, cfg.padded_vocab), ("hidden_in", "vocab"),
                               "fan_in")
    G = cfg.n_groups_scan
    params["blocks"] = tuple(
        block_tree(cfg, kind,
                   lambda shape, axes, init: mk_stacked(shape, axes, init, G))
        for kind in cfg.pattern)
    params["tail"] = tuple(block_tree(cfg, kind, mk)
                           for kind in cfg.tail_kinds)
    return params


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda",
                parallel=None) -> dict:
    """Random weights from a seeded generator on `device` (the card by
    default; pass device="cpu" to build on the host). parallel: this
    rank's shards of the same weights, each leaf drawn whole and cut at
    once (by the specs of `param_logical_axes`), so one whole leaf at a
    time lives on the device, never the whole tree."""
    device = resolve_device(device)
    dtype = dtype_of(cfg.param_dtype)
    gen = torch.Generator(device=device).manual_seed(seed)

    def cut(x, axes):
        if parallel is None:
            return x
        return shard_leaf(x, tree_specs(axes, parallel, cfg),
                          parallel.sizes, parallel.coords())

    def mk(shape, axes, init):
        return cut(_draw(gen, shape, init, dtype, device), axes)

    def mk_stacked(shape, axes, init, n):
        return cut(_draw(gen, (n,) + shape, init, dtype, device,
                         stacked=True), ("layers",) + axes)

    return model_tree(cfg, mk, mk_stacked)


def param_logical_axes(cfg: ModelConfig) -> dict:
    """The parameter tree's logical sharding axes, one tuple a leaf
    (stacked leaves lead with "layers")."""
    return model_tree(cfg, lambda shape, axes, init: axes,
                      lambda shape, axes, init, n: ("layers",) + axes)


def abstract_params(cfg: ModelConfig) -> dict:
    """The parameter tree as meta tensors: shapes and dtypes, no
    storage."""
    dtype = dtype_of(cfg.param_dtype)

    def meta(shape):
        return torch.empty(shape, dtype=dtype, device="meta")
    return model_tree(cfg, lambda shape, axes, init: meta(shape),
                      lambda shape, axes, init, n: meta((n,) + shape))


def _uniform(gen, shape, lo, hi, device):
    u = torch.rand(shape, generator=gen, dtype=torch.float32, device=device)
    return lo + (hi - lo) * u


def _draw(gen, shape, init, dtype, device, stacked: bool = False):
    """One leaf. fan_in scales by 1/sqrt(the layer's first axis), fan_in3
    (the experts' (E, in, out) weights) by 1/sqrt(its second), fan_io
    by 1/sqrt(the product of its first two). The reference takes a
    stacked leaf's fan from the stacked shape (the group count); here it
    comes from the layer's own input width, which keeps full-width
    activations at unit scale. The recurrent inits follow the
    reference's ranges: RG-LRU's Lambda puts a = exp(-8 softplus(lam))
    in [0.9, 0.999], mamba2's A = exp(A_log) in [1, 16) and
    softplus(dt_bias) in [1e-3, 1e-1]; conv taps scale by
    1/sqrt(the conv width)."""
    if init == "zeros":
        return torch.zeros(shape, dtype=dtype, device=device)
    if init == "ones":
        return torch.ones(shape, dtype=dtype, device=device)
    if init == "lambda":
        sp = -torch.log(_uniform(gen, shape, 0.9, 0.999, device)) / 8.0
        return torch.log(torch.expm1(torch.clamp(sp, min=1e-8))).to(dtype)
    if init == "a_log":
        return torch.log(_uniform(gen, shape, 1.0, 16.0, device)).to(dtype)
    if init == "dt_bias":
        u = _uniform(gen, shape, 1e-3, 1e-1, device)
        return torch.log(torch.expm1(u)).to(dtype)
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    lead = shape[1:] if stacked else shape
    if init == "fan_in":
        x /= math.sqrt(lead[0])
    elif init == "fan_in3":
        x /= math.sqrt(lead[1])
    elif init == "fan_io":
        x /= math.sqrt(lead[0] * lead[1])
    elif init == "conv":
        x /= math.sqrt(shape[-1])
    # "embed": unit normal.
    return x.to(dtype)


def tree_leaves(tree):
    if isinstance(tree, dict):
        for k in tree:
            yield from tree_leaves(tree[k])
    elif isinstance(tree, (tuple, list)):
        for x in tree:
            yield from tree_leaves(x)
    elif tree is not None:
        yield tree


def tree_map(fn, tree, *rest):
    """Apply fn to every leaf of tree, keeping dict/tuple structure. Each
    tree of `rest` has tree's structure down to tree's leaves; fn gets
    the matching subtree of each (a leaf, or a whole subtree where tree
    has a leaf: an optimizer's per-parameter state)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, x, *(r[i] for r in rest))
                          for i, x in enumerate(tree))
    return fn(tree, *rest)


class Packed:
    """Several per-leaf results as one leaf of `tree_map`, so they can be
    split apart (`unpack`) after one pass over the tree."""
    __slots__ = ("vals",)

    def __init__(self, *vals):
        self.vals = vals


def unpack(tree, i):
    """The tree of each Packed leaf's i-th value."""
    return tree_map(lambda t: t.vals[i], tree)


def tree_leaves_sorted(tree):
    """Leaves in `jax.tree.flatten`'s order: dict keys sorted, sequences
    in order, None no leaf. The order of the reference's checkpoints and
    of its sums over a tree."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves_sorted(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in tree_leaves_sorted(t)]
    return [] if tree is None else [tree]


def tree_unflatten_sorted(tree, leaves):
    """tree's structure with `leaves` (in `tree_leaves_sorted`'s order)
    in place of its own."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            done = {k: build(t[k]) for k in sorted(t)}
            return {k: done[k] for k in t}
        if isinstance(t, (tuple, list)):
            return type(t)(build(x) for x in t)
        return None if t is None else next(it)
    out = build(tree)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def _to_torch(a, device):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        # ml_dtypes bfloat16: carry the bits across as int16.
        t = torch.from_numpy(np.array(a).view(np.int16))
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def from_jax(tree, device="cuda"):
    """Carry a reference (JAX) param or cache tree across: every leaf is
    converted with np.asarray (no jax import needed) and moved to
    `device`. The {"blocks": stacked, "tail": ...} structure and int8
    {"q", "scale"} leaves are kept as they are."""
    device = resolve_device(device)
    return tree_map(lambda a: _to_torch(a, device), tree)


def shard_params(full_tree, cfg: ModelConfig, parallel):
    """This rank's shards of a full parameter tree, cut once by the
    specs of `param_logical_axes` (`repro_torch.sharding.tree_specs`)
    into contiguous tensors that share no storage with the full tree (so
    it can be freed, and no strided slice reaches a kernel). An int8
    {"q", "scale"} leaf: q follows the weight's spec, scale (one per
    output channel, size 1 on the contracted axes) its output axes."""
    sizes, coords = parallel.sizes, parallel.coords()
    specs = tree_specs(param_logical_axes(cfg), parallel, cfg)

    def cut(leaf, spec):
        if isinstance(leaf, dict):
            q = leaf["q"]
            s = leaf["scale"]
            sspec = Spec(*(e if s.shape[i] == q.shape[i] else None
                           for i, e in enumerate(spec)))
            return {"q": shard_leaf(q, spec, sizes, coords),
                    "scale": shard_leaf(s, sspec, sizes, coords)}
        return shard_leaf(leaf, spec, sizes, coords)
    return _map_spec(cut, full_tree, specs)


def _map_spec(fn, tree, specs):
    """fn(leaf, spec) over a param tree and its spec tree (an int8
    {"q", "scale"} dict is one leaf)."""
    if isinstance(tree, dict) and set(tree) != {"q", "scale"}:
        return {k: _map_spec(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_spec(fn, v, s) for v, s in zip(tree, specs))
    return fn(tree, specs)
