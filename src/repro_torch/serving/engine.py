"""Inference engine: prefill + decode with KV-cache slots, on torch.

The execution backend behind the CNNSelect server and the continuous-
batching loop. Decode steps are *aligned* within a batch group; the
scheduler (batching.py) regroups requests between steps and backfills
freed slots via `prefill_row` mid-group.

The engine allocates its (batch_size, max_seq) cache once (attention
layers' KV buffers, recurrent layers' state), and every step writes
into it in place (the reference donates its cache to the jit'd
decode). The steps read static input tensors: the prompt tokens (one
tensor per prompt length), the decode tokens, `valid_from` (B,) (on
attention-only patterns; recurrent ones take none), and the decode
position, a 0-d int32 on the device that the engine
sets before each decode from its Python `cache_pos`. On the card the
reference's jit'd steps become CUDA graphs over those tensors: `warmup`
runs each step once eagerly before its capture (kernel builds, launch
attributes, cuBLAS handles and workspaces), then captures the decode
step, which serves every position, and the prefill at its prompt
length; a prefill at another length is run once and captured before its
first call (jit's per-shape cache). The graphs share one memory pool, as they replay in turn on one
stream; the cache lies outside it. A capture that fails raises: on the
card a step runs eagerly only to warm up. The backfill pair
(`prefill_row`) runs eagerly into the same cache. On CPU tensors the
same step functions run eagerly.

With `parallel` (a `sharding.ParallelConfig`, serve profile; every
block kind) the engine serves one rank's shards
(`models.params.shard_params`) over a sequence- or head-sharded cache
(recurrent layers: their state's width or heads over the model axis):
every rank makes the same host calls with the whole batch, each data
rank computes its own rows, and `run_prefill` / `run_decode` /
`prefill_row` return the all-gathered logits, so every rank returns
what the unsharded engine returns. On the card the graphs capture the
NCCL collectives; a gloo group cannot be captured, so graphs with a
gloo group on CUDA raise and the caller passes graphs=False (the steps
then run eagerly; nothing switches graphs off by itself).

Timed sections end with a device synchronise when the engine runs on
CUDA, so they measure execution, not enqueue.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.models.config import ATTN_KINDS, ModelConfig
from repro_torch.models.model import (decode_step, forward, init_cache,
                                      prefill, whole_embed_table)
from repro_torch.models.params import tree_leaves
from repro_torch.sharding import all_gather
from repro_torch.utils import resolve_device


@dataclass
class EngineStats:
    prefill_calls: int = 0
    decode_calls: int = 0
    backfill_calls: int = 0
    prefill_time_s: float = 0.0
    decode_time_s: float = 0.0
    backfill_time_s: float = 0.0
    compile_time_s: float = 0.0     # warm-up and graph captures
    graph_captures: int = 0
    graph_replays: int = 0


@dataclass
class _Graph:
    """A captured step: a replay rewrites `out`; `launches` are the
    kernel launches it records, a replay."""
    graph: torch.cuda.CUDAGraph
    out: torch.Tensor
    launches: dict


class InferenceEngine:
    """One model's runnable engine with a fixed batch capacity.

    params must already live on `device` (the card by default); with
    `parallel`, they are this rank's shards. graphs: on the card, capture
    the steps as CUDA graphs (the default); False runs them eagerly,
    which a gloo group on the card needs."""

    def __init__(self, cfg: ModelConfig, params, *, batch_size: int,
                 max_seq: int, device="cuda", parallel=None,
                 graphs: bool = True):
        self.cfg = cfg
        self.batch_size = batch_size
        self.max_seq = max_seq
        self.parallel = parallel
        self.device = resolve_device(device)
        self._graphs_on = graphs and self.device.type == "cuda"
        if parallel is not None:
            if parallel.profile != "serve":
                raise ValueError(
                    f"profile {parallel.profile!r}: the engine serves "
                    f"(make_parallel(mesh, 'serve'))")
            if self._graphs_on and _has_gloo_group(parallel):
                raise ValueError(
                    "CUDA graphs cannot capture gloo collectives: pass "
                    "graphs=False for a gloo mesh on the card")
        for leaf in tree_leaves(params):
            if leaf.device.type != self.device.type:
                raise ValueError(
                    f"params live on {leaf.device}, engine device is "
                    f"{self.device}; move them first (no implicit copy)")
        # A tied table's d, sharded over data, is gathered here once
        # rather than in every step.
        self.params = whole_embed_table(params, cfg, parallel)
        self.stats = EngineStats()
        # Attention layers keep a KV cache, recurrent layers (RG-LRU,
        # SSD) a fixed-size state; both live here for the engine's life.
        self.cache = init_cache(cfg, batch_size, max_seq, device=self.device,
                                parallel=parallel)
        self.cache_pos = 0       # tokens in context; 0: no group prefilled
        # The steps' static inputs.
        i32 = dict(dtype=torch.int32, device=self.device)
        self.valid_from = torch.zeros((batch_size,), **i32)
        self._token = torch.zeros((batch_size, 1), **i32)
        self._pos = torch.zeros((), **i32)
        self._prompts = {}       # prompt length -> (B, T) tokens
        self._graphs = {}        # "decode" or a prompt length -> _Graph
        self._backfill_warm = False
        if self._graphs_on:
            self._stream = torch.cuda.Stream(self.device)
            self._pool = torch.cuda.graph_pool_handle()
        kinds = set(cfg.pattern) | set(cfg.tail_kinds)
        # Per-row masking (left-padded prompts / slot backfill) only works
        # on attention caches; recurrent state integrates pads irrevocably.
        # Recurrent patterns' steps take valid_from=None.
        self._maskable = kinds <= set(ATTN_KINDS)
        # Slot backfill additionally needs every layer's cache to span
        # max_seq (a windowed ring smaller than max_seq wraps slots).
        self._backfillable = self._maskable and not (
            "local" in kinds and cfg.window and cfg.window < max_seq)

    # -- step functions (the reference's jit entry points) -------------

    def _prefill(self, tokens, valid_from):
        """Group prefill into the persistent cache. Returns the last
        position's logits (B, 1, V)."""
        logits, _ = prefill(self.params, tokens, self.cfg, self.max_seq,
                            parallel=self.parallel, logits_last_only=True,
                            valid_from=valid_from, cache=self.cache)
        return logits

    def _decode(self, token, cache_pos, valid_from):
        logits, _ = decode_step(self.params, token, self.cache, cache_pos,
                                self.cfg, parallel=self.parallel,
                                valid_from=valid_from)
        return logits

    def _prefill_row(self, tokens, offset: int, valid_from):
        # Single-row prefill at absolute positions offset..offset+T-1
        # into a fresh (B=1) cache, merged into the live batch cache by
        # `_merge`. RoPE is applied at the true absolute positions so the
        # merged keys are indistinguishable from ones written by a
        # from-scratch group prefill.
        T = tokens.shape[1]
        positions = offset + torch.arange(T, dtype=torch.int32,
                                          device=tokens.device)
        cache = init_cache(self.cfg, 1, self.max_seq, device=tokens.device,
                           parallel=self.parallel)
        logits, extras = forward(self.params, tokens, self.cfg,
                                 parallel=self.parallel, cache=cache,
                                 positions=positions, logits_last_only=True,
                                 valid_from=valid_from)
        return logits, extras["cache"]

    @staticmethod
    def _merge(bcache, rcache, row: int, offset: int, T: int,
               seq_parallel=None, write: bool = True):
        # Copy the row cache's first T seq slots into batch slot `row` at
        # seq offset `offset`, in place. The shared (S,) pos array needs
        # no update: group prefill + aligned decode already maintain
        # pos[s] == s for every slot below cache_pos.
        # seq_parallel: the caches are this rank's chunks of a sequence
        # sharded over its model axis: the row cache is gathered over it
        # first (row slot j lands in slot offset + j, in another rank's
        # chunk in general), and this rank copies what lands in its
        # chunk. write=False: take part in the gathers only.
        base = 0
        for bd, rd in zip(bcache["blocks"] + bcache["tail"],
                          rcache["blocks"] + rcache["tail"]):
            for key in ("k", "v"):
                b, r = bd[key], rd[key]
                S_loc = b.shape[b.ndim - 3]
                if seq_parallel is not None:
                    tp = seq_parallel.tp_axis
                    r = all_gather(r, seq_parallel, tp, b.ndim - 3)
                    base = seq_parallel.index((tp,)) * S_loc
                lo, hi = max(offset, base), min(offset + T, base + S_loc)
                if not write or lo >= hi:
                    continue
                src, dst = slice(lo - offset, hi - offset), \
                    slice(lo - base, hi - base)
                if b.ndim == 5:     # stacked blocks: (G, B, S, KV, hd)
                    b[:, row, dst] = r[:, 0, src].to(b.dtype)
                else:               # tail: (B, S, KV, hd)
                    b[row, dst] = r[0, src].to(b.dtype)
        return bcache

    def _merge_row(self, rcache, row: int, offset: int, T: int):
        """`_merge` of a backfilled row into the engine's cache. Sharded:
        the row (computed on every data rank) goes to the data rank that
        holds batch row `row`, at its local index."""
        par = self.parallel
        if par is None:
            return self._merge(self.cache, rcache, row, offset, T)
        write = True
        if par.data_ok(self.batch_size):
            Bl = self.batch_size // par.dp_size
            write = par.index(par.data_axes) == row // Bl
            row %= Bl
        seq = par if self.cfg.n_kv_heads % par.tp_size else None
        return self._merge(self.cache, rcache, row, offset, T, seq, write)

    # -- the steps over their static inputs ------------------------------

    def _prompt(self, T: int):
        """The static (B, T) prompt tokens of prompt length T."""
        if T not in self._prompts:
            self._prompts[T] = torch.zeros((self.batch_size, T),
                                           dtype=torch.int32,
                                           device=self.device)
        return self._prompts[T]

    def _step(self, key):
        """The step a graph key names, over its static inputs: "decode",
        or the prefill at a prompt length."""
        vf = self.valid_from if self._maskable else None
        if key == "decode":
            return lambda: self._decode(self._token, self._pos, vf)
        prompt = self._prompt(key)
        return lambda: self._prefill(prompt, vf)

    @contextlib.contextmanager
    def _on_capture_stream(self):
        """On the card: run on the stream the graphs are captured on
        (so what a first call sets up per stream is ready for capture),
        after the current stream's work and before its later work."""
        if not self._graphs_on:
            yield
            return
        main = torch.cuda.current_stream(self.device)
        self._stream.wait_stream(main)
        with torch.cuda.stream(self._stream):
            yield
        main.wait_stream(self._stream)

    def _capture(self, key):
        """Capture the step `key` into a CUDA graph over the static
        inputs it reads, in the engine's pool. Its launches count at
        each replay, not at capture."""
        graph, step = torch.cuda.CUDAGraph(), self._step(key)

        def record():
            with torch.cuda.graph(graph, pool=self._pool,
                                  stream=self._stream):
                return step()
        out, launches = ops.capture_launches(record)
        self._graphs[key] = _Graph(graph, out, launches)
        self.stats.graph_captures += 1

    def _run(self, key):
        """The step `key` on the static inputs: on the card a replay of
        its graph, on the CPU (or with graphs=False) an eager call.
        Returns its logits."""
        if not self._graphs_on:
            return self._step(key)()
        g = self._graphs[key]
        g.graph.replay()
        ops.count_replay(g.launches)
        self.stats.graph_replays += 1
        return g.out

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @staticmethod
    def _host(a):
        """A host int32 tensor of a (copied), to copy onto the device."""
        return torch.tensor(np.asarray(a, np.int32))

    def warmup(self, prompt_len: int = 8):
        """Cold-start work (the serving analogue of the paper's
        model-load phase): runs each step that has no graph yet once
        eagerly (prefill at prompt_len, decode), which builds the
        kernels on first use, and the backfill pair on the engine's
        first warm-up where it can backfill; on the card it then
        captures those steps. Leaves
        no group in the cache. Returns seconds."""
        self._sync()
        t0 = time.perf_counter()
        keys = [k for k in (prompt_len, "decode") if k not in self._graphs]
        prompt = self._prompt(prompt_len)
        prompt.zero_()
        self._token.zero_()
        self.valid_from.zero_()
        self._pos.fill_(prompt_len)
        with self._on_capture_stream():
            for key in keys:
                self._step(key)()
            if self._backfillable and not self._backfill_warm:
                # Run the backfill pair too: a first mid-group join must
                # not charge the cold start to a measured request.
                _, rc = self._prefill_row(prompt[:1], 0, self.valid_from[:1])
                self._merge_row(rc, 0, 0, prompt_len)
                self._backfill_warm = True
        if self._graphs_on:
            for key in keys:
                self._capture(key)
        self.cache_pos = 0
        self._sync()
        dt = time.perf_counter() - t0
        self.stats.compile_time_s += dt
        return dt

    def _valid_from_for(self, tokens, lengths):
        """(B,) first attendable absolute position per row (numpy), or
        None for a recurrent pattern, which takes no mask."""
        B, T = tokens.shape
        if lengths is None:
            return np.zeros(B, np.int32) if self._maskable else None
        if not self._maskable:
            raise NotImplementedError(
                f"padded prompts need per-row masking, which recurrent "
                f"blocks in pattern {self.cfg.pattern} do not support")
        lengths = np.asarray(lengths, np.int64)
        if lengths.shape != (B,) or np.any(lengths < 1) or np.any(lengths > T):
            raise ValueError(f"lengths must be (B,) in [1, {T}]")
        return T - lengths

    def run_prefill(self, tokens: np.ndarray, lengths=None):
        """tokens: (B, T) int32, left-padded; lengths: optional (B,) count
        of real (right-aligned) tokens per row — padding positions are
        masked out of attention so they cannot contaminate logits or
        later cache reads. Returns next-token logits; fills the cache.
        On the card, a first prefill at length T runs once eagerly and
        captures its graph first (booked as compile time)."""
        if tokens.shape[0] != self.batch_size:
            raise ValueError(f"tokens has {tokens.shape[0]} rows, engine "
                             f"batch_size is {self.batch_size}")
        T = tokens.shape[1]
        vf = self._valid_from_for(tokens, lengths)
        if self._graphs_on and T not in self._graphs:
            self.warmup(T)
        self._sync()
        t0 = time.perf_counter()
        self._prompt(T).copy_(self._host(tokens))
        if vf is not None:
            self.valid_from.copy_(self._host(vf))
        logits = self._run(T)
        out = logits[:, 0].cpu().numpy()
        self.stats.prefill_calls += 1
        self.stats.prefill_time_s += time.perf_counter() - t0
        self.cache_pos = T
        return out

    def run_decode(self, tokens: np.ndarray):
        """tokens: (B, 1) int32 next tokens. Returns logits (B, V)."""
        if self.cache_pos == 0:
            raise RuntimeError(
                "no KV cache — call run_prefill first (run_decode on a "
                "fresh engine has nothing to decode against)")
        if self.cache_pos >= self.max_seq:
            raise RuntimeError(
                f"KV cache full (cache_pos={self.cache_pos}, "
                f"max_seq={self.max_seq})")
        self._sync()
        t0 = time.perf_counter()
        self._token.copy_(self._host(tokens).reshape(self.batch_size, 1))
        self._pos.fill_(self.cache_pos)
        logits = self._run("decode")
        out = logits[:, 0].cpu().numpy()
        self.cache_pos += 1
        self.stats.decode_calls += 1
        self.stats.decode_time_s += time.perf_counter() - t0
        return out

    def prefill_row(self, prompt: np.ndarray, slot: int, length=None):
        """Backfill: prefill one request into batch slot `slot` mid-group.

        prompt: (T,) int32, left-padded to the group prompt length;
        length: real token count (right-aligned; default: all T). The row
        is prefilled at absolute positions cache_pos-T .. cache_pos-1 in
        a private cache, then merged into the live batch cache; its
        valid_from masks both the padding and whatever the slot's retired
        previous occupant left behind. Runs eagerly, also on the card.
        Returns next-token logits (V,)."""
        if self.cache_pos == 0:
            raise RuntimeError("no KV cache — call run_prefill first")
        if not self._backfillable:
            raise NotImplementedError(
                "slot backfill needs full-seq attention caches "
                f"(pattern {self.cfg.pattern}, window {self.cfg.window})")
        if not 0 <= slot < self.batch_size:
            raise ValueError(f"slot {slot} out of range")
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        T = prompt.shape[0]
        offset = self.cache_pos - T
        if offset < 0:
            raise ValueError(
                f"prompt ({T} tokens) longer than current context "
                f"({self.cache_pos})")
        length = T if length is None else int(length)
        if not 1 <= length <= T:
            raise ValueError(f"length must be in [1, {T}]")
        vf_row = self.cache_pos - length
        self._sync()
        t0 = time.perf_counter()
        logits, rcache = self._prefill_row(
            self._host(prompt[None]).to(self.device), offset,
            self._host([vf_row]).to(self.device))
        self._merge_row(rcache, slot, offset, T)
        self.valid_from[slot] = vf_row
        out = logits[0, 0].cpu().numpy()
        self._sync()
        self.stats.backfill_calls += 1
        self.stats.backfill_time_s += time.perf_counter() - t0
        return out

    @property
    def free_context(self) -> int:
        """Decode steps left before the cache fills."""
        return max(0, self.max_seq - self.cache_pos)

    @property
    def resident_bytes(self) -> int:
        """Bytes of the LIVE parameter tree — int8 execution leaves
        count at one byte per weight (plus their fp32 scales), so the
        memory budget the ModelZoo enforces reflects what this engine
        actually holds, not a notional quantized copy."""
        from repro_torch.quant.int8 import tree_bytes_quantized
        return tree_bytes_quantized(self.params)

    def generate(self, prompts: np.ndarray, n_tokens: int,
                 greedy: bool = True, rng: Optional[np.random.Generator] = None,
                 lengths=None):
        """Prefill + n_tokens decode steps. Returns (B, n_tokens) ints."""
        out = np.zeros((self.batch_size, n_tokens), np.int32)
        logits = self.run_prefill(prompts, lengths=lengths)
        for t in range(n_tokens):
            if greedy:
                nxt = logits.argmax(-1).astype(np.int32)
            else:
                e = rng.gumbel(size=logits.shape)
                nxt = (logits + e).argmax(-1).astype(np.int32)
            out[:, t] = nxt
            logits = self.run_decode(nxt[:, None])
        return out

    def measured_profile(self, prompt_len: int, n_tokens: int,
                         reps: int = 3) -> dict:
        """Measure hot latency (mu, sigma) of a full request on this
        engine — the on-line analogue of paper Table 5. The first rep is
        discarded (dispatch warmup) and the center is a trimmed mean, so
        a loaded host doesn't corrupt the profile. Prefill and decode are
        timed separately: per_token_ms is decode-only (the prefill is one
        batched pass, not n_tokens+1 of anything)."""
        tot, pre, dec = [], [], []
        for r in range(reps + 1):
            toks = np.random.default_rng(r).integers(
                0, self.cfg.vocab, (self.batch_size, prompt_len),
                dtype=np.int32)
            t0 = time.perf_counter()
            logits = self.run_prefill(toks)
            t1 = time.perf_counter()
            for _ in range(n_tokens):
                nxt = logits.argmax(-1).astype(np.int32)
                logits = self.run_decode(nxt[:, None])
            t2 = time.perf_counter()
            tot.append((t2 - t0) * 1000.0)
            pre.append((t1 - t0) * 1000.0)
            dec.append((t2 - t1) * 1000.0)
        # Drop the warmup rep; trim the slowest remaining rep (by total
        # latency) from every series so the three stats stay aligned.
        order = np.argsort(tot[1:])[:max(1, reps - 1)] + 1
        tot_c = np.array(tot)[order]
        pre_c = np.array(pre)[order]
        dec_c = np.array(dec)[order]
        return {"mu": float(np.mean(tot_c)),
                "sigma": float(np.std(tot_c)),
                "prefill_ms": float(np.mean(pre_c)),
                "per_token_ms": float(np.mean(dec_c) / max(1, n_tokens)),
                "resident_bytes": self.resident_bytes}


def _has_gloo_group(parallel) -> bool:
    import torch.distributed as dist
    return any(dist.get_backend(parallel.mesh.get_group(a)) == "gloo"
               for a in parallel.mesh.mesh_dim_names)
