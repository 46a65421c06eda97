"""Parameter trees of the attention-only models.

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

from repro_torch.models.config import ModelConfig
from repro_torch.utils import dtype_of, resolve_device


def block_tree(cfg: ModelConfig, kind: str, mk):
    """One block's parameter tree via the mk(shape, init) callback."""
    if kind not in ("attn", "global", "local"):
        raise NotImplementedError(
            f"block kind {kind!r} is not ported yet: MoE, SSD and RG-LRU "
            f"blocks belong to a later slice of the port")
    d = cfg.d_model
    Hq, KV, hd = cfg.q_heads_padded, cfg.n_kv_heads, cfg.head_dim
    p = {"ln1": mk((d,), "zeros"),
         "wq": mk((d, Hq, hd), "fan_in"),
         "wk": mk((d, KV, hd), "fan_in"),
         "wv": mk((d, KV, hd), "fan_in"),
         "wo": mk((Hq, hd, d), "fan_io")}
    if cfg.qk_norm:
        p["q_norm"] = mk((hd,), "zeros")
        p["k_norm"] = mk((hd,), "zeros")
    if cfg.sandwich_norm:
        p["post_attn_norm"] = mk((d,), "zeros")
        p["post_ffn_norm"] = mk((d,), "zeros")
    p["ln2"] = mk((d,), "zeros")
    p["mlp"] = _mlp_tree(cfg, mk)
    return p


def _mlp_tree(cfg: ModelConfig, mk):
    d, f = cfg.d_model, cfg.d_ff
    p = {"w_up": mk((d, f), "fan_in"),
         "w_down": mk((f, d), "fan_in")}
    if cfg.mlp_gated:
        p["w_gate"] = mk((d, f), "fan_in")
    return p


def model_tree(cfg: ModelConfig, mk, mk_stacked):
    """Full model parameter tree; mk_stacked(shape, init, n) creates a
    leaf with a leading scan-group axis of size n."""
    d = cfg.d_model
    params = {
        "embed": mk((cfg.padded_vocab, d), "embed"),
        "final_norm": mk((d,), "zeros"),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = mk((d, cfg.padded_vocab), "fan_in")
    G = cfg.n_groups_scan
    params["blocks"] = tuple(
        block_tree(cfg, kind, lambda shape, init: mk_stacked(shape, init, G))
        for kind in cfg.pattern)
    params["tail"] = tuple(block_tree(cfg, kind, mk)
                           for kind in cfg.tail_kinds)
    return params


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda") -> dict:
    """Random weights from a seeded generator on `device` (the card by
    default; pass device="cpu" to build on the host)."""
    device = resolve_device(device)
    dtype = dtype_of(cfg.param_dtype)
    gen = torch.Generator(device=device).manual_seed(seed)

    def mk(shape, init):
        return _draw(gen, shape, init, dtype, device)

    def mk_stacked(shape, init, n):
        return _draw(gen, (n,) + shape, init, dtype, device, stacked=True)

    return model_tree(cfg, mk, mk_stacked)


def _draw(gen, shape, init, dtype, device, stacked: bool = False):
    """One leaf. fan_in scales by 1/sqrt(the layer's first axis), fan_io
    by 1/sqrt(the product of its first two). The reference takes a
    stacked leaf's fan from the stacked shape (the group count); here it
    comes from the layer's own input width, which keeps full-width
    activations at unit scale."""
    if init == "zeros":
        return torch.zeros(shape, dtype=dtype, device=device)
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    lead = shape[1:] if stacked else shape
    if init == "fan_in":
        x /= math.sqrt(lead[0])
    elif init == "fan_io":
        x /= math.sqrt(lead[0] * lead[1])
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


def tree_map(fn, tree):
    """Apply fn to every tensor leaf, keeping dict/tuple structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, x) for x in tree)
    return fn(tree)


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
