"""Logical-axis -> mesh-axis rule tables, shard layouts and the
collectives of the sharded serving path, on torch.distributed.

The rule tables are the reference's (`make_rules`, `moe_mode_for`,
`spec_for`, `tree_specs`): the same logical axes map to the same mesh
axes, entry by entry. Two profiles:

- **train**: FSDP(ZeRO-3) + TP. Weight matmul-input dims (`hidden_in`,
  `embed`, `expert_in`) shard over the data axis; TP dims (`heads`,
  `ff`, `vocab`, `experts`|`expert_ff`, `rnn_width`, `ssd_inner`...)
  over the model axis. The port does not run it yet (ROADMAP queue 1).
- **serve**: heads and `ff` over model, no FSDP for dense weights, the
  embedding table's `embed` dim over data; KV caches: batch over (pod,
  data), kv-heads over model where n_kv_heads divides the model axis,
  else the cache's sequence dim over model (flash decode).

The reference lets GSPMD lay tensors out from these specs. The port
does tensor parallelism by hand: `shard_leaf` cuts a full tensor into
this rank's contiguous shard by its spec once, at load, and the model
runs each rank's local shards with explicit collectives over the mesh's
process groups (`all_reduce`, `all_gather`, `reduce_scatter`; see
`models/layers.py` and `models/moe.py`).
A spec is a `Spec`, a tuple whose entries are what the reference's
`PartitionSpec` holds: None, an axis name, or a tuple of axis names.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch


class Spec(tuple):
    """The port's PartitionSpec: one entry per tensor dim, each None
    (replicated), a mesh axis name, or a tuple of axis names (the dim
    split over their product, the first axis major)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"Spec{tuple.__repr__(self)}"


def entry_axes(entry) -> Tuple[str, ...]:
    """The mesh axes a spec entry splits its dim over, major first."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


@dataclass(frozen=True)
class ParallelConfig:
    """A mesh and how the model lays itself out on it. `mesh` is a
    `torch.distributed.device_mesh.DeviceMesh` with `mesh_dim_names`
    ("data", "model") or ("pod", "data", "model") (the rule tables read
    only its names and shape)."""
    mesh: object
    data_axes: Tuple[str, ...]          # activation batch axes, e.g. ("pod","data")
    fsdp_axes: Tuple[str, ...] = ("data",)
    tp_axis: str = "model"
    moe_mode: str = "auto"              # ep | tp | auto
    profile: str = "train"              # train | serve
    seq_shard: bool = False             # Megatron-style SP between blocks
    seq_mode: str = "full"
    attn_pin: bool = False              # pin q/k/v head-sharded (per-arch lever)

    @property
    def sizes(self) -> dict:
        """Mesh axis name -> its size."""
        return dict(zip(self.mesh.mesh_dim_names, tuple(self.mesh.shape)))

    @property
    def num_devices(self) -> int:
        return int(np.prod(tuple(self.mesh.shape)))

    @property
    def tp_size(self) -> int:
        return self.sizes[self.tp_axis]

    @property
    def dp_size(self) -> int:
        return int(np.prod([self.sizes[a] for a in self.data_axes]))

    def coords(self) -> dict:
        """This rank's mesh coordinate on each axis."""
        return {a: self.mesh.get_local_rank(a)
                for a in self.mesh.mesh_dim_names}

    def index(self, axes) -> int:
        """This rank's index along the product of `axes` (first major)."""
        c, idx = self.coords(), 0
        for a in axes:
            idx = idx * self.sizes[a] + c[a]
        return idx

    def data_ok(self, batch: int) -> bool:
        """Whether a batch of `batch` rows splits evenly over the data
        axes; otherwise every data rank computes every row."""
        return batch % self.dp_size == 0

    def batch_axes(self, batch: int) -> Tuple[str, ...]:
        return self.data_axes if self.data_ok(batch) else ()


# Sentinel for 0-d state leaves (e.g. the train step counter): maps to Spec().
SCALAR_AXES = ("@scalar",)


def make_rules(parallel: ParallelConfig, cfg=None) -> dict:
    """The reference's rule table. Rules are config-conditional:

    - kv_heads shard over model only when n_kv_heads % tp == 0; otherwise
      the KV *cache* shards its sequence dim over model instead (decode
      then runs `models.flash_decode.flash_decode_sharded`).
    - vocab shards only when divisible (mamba2's 50280 is not).
    """
    fsdp = parallel.fsdp_axes
    tp = parallel.tp_axis
    tp_size = parallel.tp_size
    train = parallel.profile == "train"
    kv_div = cfg is None or cfg.n_kv_heads % tp_size == 0
    vocab_div = cfg is None or cfg.padded_vocab % tp_size == 0
    return {
        # embedding / unembedding
        "vocab": tp if vocab_div else None,
        "embed": fsdp,
        # dense weights
        "hidden_in": fsdp if train else None,
        "heads": tp,
        "kv_heads": tp if kv_div else None,
        "head_dim": None,
        "ff": tp,
        # MoE
        "router": None,
        "experts": tp,       # remapped to None at spec time for moe_mode=tp
        "expert_in": fsdp,
        "expert_ff": None,   # remapped to tp for moe_mode=tp
        # RG-LRU / SSD
        "rnn_in": None,
        "rnn_width": tp,
        "ssd_inner": tp,
        "ssd_heads": tp,
        "ssd_gn": None,
        "ssd_state": None,
        "ssd_hd": None,
        # caches
        "cache_batch": parallel.data_axes,
        "cache_seq": None if kv_div else tp,
        # misc
        "norm": None,
        "conv_k": None,
        "layers": None,
    }


def moe_mode_for(cfg, parallel: ParallelConfig) -> str:
    """auto   -> ep/tp   (weight-gather layouts: train/prefill)
       auto2d -> ep2d/tp2d (weight-resident layouts: decode)."""
    mode = parallel.moe_mode
    ep_ok = cfg.moe is not None and cfg.moe.n_experts % parallel.tp_size == 0
    if mode == "auto":
        return "ep" if ep_ok else "tp"
    if mode == "auto2d":
        return "ep2d" if ep_ok else "tp2d"
    return mode


def spec_for(axes: Tuple[str, ...], rules: dict) -> Spec:
    if tuple(axes) == SCALAR_AXES:
        return Spec()
    entries = []
    used = set()
    for ax in axes:
        m = rules.get(ax)
        if m is None:
            entries.append(None)
            continue
        if isinstance(m, str):
            entries.append(None if m in used else m)
            used.add(m)
            continue
        # Tuple rules stay tuples even when deduped down to one axis, as
        # in the reference (its P(('data',)) is distinct from P('data')).
        ms = tuple(a for a in m if a not in used)
        used.update(ms)
        entries.append(ms if ms else None)
    return Spec(*entries)


def _is_axes_leaf(x) -> bool:
    # Non-empty tuples of axis names; empty tuples are STRUCTURAL (e.g. an
    # arch with no tail layers) and must stay part of the tree shape.
    return (isinstance(x, tuple) and len(x) > 0 and all(
        isinstance(a, (str, type(None))) for a in x))


def _map_axes(fn, tree):
    if _is_axes_leaf(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_axes(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_axes(fn, v) for v in tree)
    return tree


def tree_specs(logical_tree, parallel: ParallelConfig, cfg=None):
    """Map a tree of logical-axis tuples to Specs."""
    rules = dict(make_rules(parallel, cfg))
    if cfg is not None and cfg.moe is not None:
        # Keep stored expert-weight layouts in lockstep with the sharded
        # MoE's layouts (the reference's moe_weight_specs).
        mode = moe_mode_for(cfg, parallel)
        tp, fsdp = parallel.tp_axis, parallel.fsdp_axes
        remap = {
            "ep": {"experts": tp, "expert_in": fsdp, "expert_ff": None},
            "tp": {"experts": None, "expert_in": fsdp, "expert_ff": tp},
            "ep2d": {"experts": tp, "expert_in": None, "expert_ff": fsdp},
            "tp2d": {"experts": None, "expert_in": None,
                     "expert_ff": tuple(fsdp) + (tp,)},
        }[mode]
        rules.update(remap)
    return _map_axes(lambda axes: spec_for(axes, rules), logical_tree)


def batch_spec(parallel: ParallelConfig, ndim: int) -> Spec:
    """Batch-leading activation spec: (B, ...) -> batch over data axes."""
    return Spec(parallel.data_axes, *([None] * (ndim - 1)))


def make_parallel(mesh, profile: str, *, seq_shard: Optional[bool] = None,
                  moe_mode: str = "auto", attn_pin: bool = False,
                  seq_mode: str = "full") -> ParallelConfig:
    axes = tuple(mesh.mesh_dim_names)
    data_axes = tuple(a for a in axes if a in ("pod", "data"))
    if seq_shard is None:
        seq_shard = profile == "train"
    return ParallelConfig(
        mesh=mesh,
        data_axes=data_axes,
        fsdp_axes=("data",),
        tp_axis="model",
        moe_mode=moe_mode,
        profile=profile,
        seq_shard=seq_shard,
        seq_mode=seq_mode,
        attn_pin=attn_pin,
    )


# --------------------------------------------------------------------------
# Shard layouts
# --------------------------------------------------------------------------

def _dim_slices(shape, spec, sizes: dict, coords: dict):
    """Per dim, the slice of it a rank at `coords` holds."""
    if len(spec) > len(shape):
        raise ValueError(f"spec {spec} has more entries than shape {shape}")
    out = []
    for dim, n in enumerate(shape):
        axes = entry_axes(spec[dim]) if dim < len(spec) else ()
        parts, idx = 1, 0
        for a in axes:
            parts *= sizes[a]
            idx = idx * sizes[a] + coords[a]
        if n % parts:
            raise ValueError(
                f"dim {dim} of size {n} does not split over {axes} "
                f"({parts} shards; spec {spec})")
        step = n // parts
        out.append(slice(idx * step, (idx + 1) * step))
    return tuple(out)


def local_shape(shape, spec, sizes: dict) -> tuple:
    """The shape of one rank's shard of a tensor of `shape`."""
    zero = {a: 0 for a in sizes}
    return tuple(s.stop - s.start
                 for s in _dim_slices(shape, spec, sizes, zero))


def shard_leaf(x: torch.Tensor, spec, sizes: dict, coords: dict):
    """This rank's shard of the full tensor x: on each dim the
    contiguous block its coordinates pick (a dim split over several axes
    is indexed with the first axis major), as a contiguous tensor that
    shares no storage with x unless it is all of x."""
    out = x[_dim_slices(x.shape, spec, sizes, coords)]
    if out.numel() == x.numel():
        return out.contiguous()
    return out.clone(memory_format=torch.contiguous_format)


def gather_leaf(shards: dict, spec, sizes: dict) -> torch.Tensor:
    """Inverse of `shard_leaf`: the full tensor from every rank's shard,
    `shards` mapping each rank's coordinates (a tuple over the mesh
    axes in `sizes`' order) to its shard."""
    names = tuple(sizes)
    first = next(iter(shards.values()))
    full = tuple(n * int(np.prod([sizes[a] for a in entry_axes(
        spec[d] if d < len(spec) else None)])) for d, n in enumerate(
            first.shape))
    out = torch.empty(full, dtype=first.dtype, device=first.device)
    for coord, shard in shards.items():
        out[_dim_slices(full, spec, sizes, dict(zip(names, coord)))] = shard
    return out


# --------------------------------------------------------------------------
# Collectives
# --------------------------------------------------------------------------

def _all_gather_into(out: torch.Tensor, x: torch.Tensor, group):
    """Fill `out` (n, *x.shape) with every rank's x over `group` (None:
    the world), in group-rank order. nccl groups and gloo groups both
    take CUDA tensors as they are (gloo's on the card: one process per
    rank on one device, where nccl refuses a second rank)."""
    import torch.distributed as dist
    # torch 2.13 renamed all_gather_into_tensor to all_gather_single.
    gather = getattr(dist, "all_gather_single", None)
    if gather is None:
        gather = dist.all_gather_into_tensor
    # (n * x.shape[0], ...): the layout gloo takes (nccl takes both).
    gather(out.view((-1,) + tuple(x.shape[1:])), x, group=group)


def all_reduce(x: torch.Tensor, parallel: ParallelConfig, axes,
               op: str = "sum") -> torch.Tensor:
    """x summed (op="sum") or maxed (op="max") over the mesh axes `axes`
    (a name or a tuple of names), in place; returns x. An axis of size
    1 makes its call too (in place, it copies nothing): on the card's
    one-rank NCCL mesh the engine's graphs capture it."""
    import torch.distributed as dist
    for a in entry_axes(axes):
        dist.all_reduce(x, op={"sum": dist.ReduceOp.SUM,
                               "max": dist.ReduceOp.MAX}[op],
                        group=parallel.mesh.get_group(a))
    return x


def all_gather(x: torch.Tensor, parallel: ParallelConfig, axes,
               dim: int) -> torch.Tensor:
    """Concatenate every rank's x along `dim` over the mesh axes `axes`
    (a name or a tuple of names, the first major): the inverse of
    splitting dim over them. Over axes of size 1 it returns x itself
    (the same storage: on a one-rank mesh a layer's expert weights are
    not copied)."""
    axes = entry_axes(axes)
    for a in reversed(axes):      # minor axis first
        n = parallel.sizes[a]
        if n == 1:
            continue
        out = torch.empty((n,) + tuple(x.shape), dtype=x.dtype,
                          device=x.device)
        _all_gather_into(out, x.contiguous(), parallel.mesh.get_group(a))
        x = torch.cat(out.unbind(0), dim=dim)
    return x


def _reduce_scatter_into(out: torch.Tensor, x: torch.Tensor, group):
    """Sum x over `group` and fill `out` with this rank's block of its
    leading dim (x's leading dim is n * out's, blocks in group-rank
    order)."""
    import torch.distributed as dist
    # torch 2.13 renamed reduce_scatter_tensor to reduce_scatter_single.
    scatter = getattr(dist, "reduce_scatter_single", None)
    if scatter is None:
        scatter = dist.reduce_scatter_tensor
    scatter(out, x, group=group)


def reduce_scatter(x: torch.Tensor, parallel: ParallelConfig, axes,
                   dim: int = 0) -> torch.Tensor:
    """x summed over the mesh axes `axes` (a name or a tuple of names),
    of which each rank keeps its block of `dim`, split over the axes
    with the first major: the reference's `psum_scatter(...,
    tiled=True)` over each axis in turn. Axes of size 1 sum nothing and
    split nothing (x itself)."""
    for a in entry_axes(axes):    # major axis first
        n = parallel.sizes[a]
        if n == 1:
            continue
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of size {x.shape[dim]} does not "
                             f"split over {a!r} ({n} ranks)")
        xt = x.movedim(dim, 0).contiguous()
        out = torch.empty((xt.shape[0] // n,) + tuple(xt.shape[1:]),
                          dtype=x.dtype, device=x.device)
        _reduce_scatter_into(out, xt, parallel.mesh.get_group(a))
        x = out.movedim(0, dim)
    return x
