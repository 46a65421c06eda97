"""Inference engine: prefill + decode with KV-cache slots, on torch.

The execution backend behind the CNNSelect server and the continuous-
batching loop. Decode steps are *aligned* within a batch group; the
scheduler (batching.py) regroups requests between steps and backfills
freed slots via `prefill_row` mid-group.

The engine runs on the card unless it is given CPU parameters. Its
cache position is a Python int, so a decode step hands it to the
kernel as an argument and reads nothing back from the device except
the logits it returns. Timed sections end with a device synchronise
when the engine runs on CUDA, so they measure execution, not enqueue.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from repro_torch.models.config import ATTN_KINDS, ModelConfig
from repro_torch.models.model import decode_step, forward, init_cache, prefill
from repro_torch.models.params import tree_leaves
from repro_torch.utils import resolve_device


@dataclass
class EngineStats:
    prefill_calls: int = 0
    decode_calls: int = 0
    backfill_calls: int = 0
    prefill_time_s: float = 0.0
    decode_time_s: float = 0.0
    backfill_time_s: float = 0.0
    compile_time_s: float = 0.0


class InferenceEngine:
    """One model's runnable engine with a fixed batch capacity.

    params must already live on `device` (the card by default)."""

    def __init__(self, cfg: ModelConfig, params, *, batch_size: int,
                 max_seq: int, device="cuda"):
        self.cfg = cfg
        self.params = params
        self.batch_size = batch_size
        self.max_seq = max_seq
        self.device = resolve_device(device)
        for leaf in tree_leaves(params):
            if leaf.device.type != self.device.type:
                raise ValueError(
                    f"params live on {leaf.device}, engine device is "
                    f"{self.device}; move them first (no implicit copy)")
        self.stats = EngineStats()
        self.cache = None
        self.cache_pos = 0
        self.valid_from = None
        kinds = set(cfg.pattern) | set(cfg.tail_kinds)
        # Per-row masking (left-padded prompts / slot backfill) only works
        # on attention caches; recurrent state integrates pads irrevocably.
        self._maskable = kinds <= set(ATTN_KINDS)
        # Slot backfill additionally needs every layer's cache to span
        # max_seq (a windowed ring smaller than max_seq wraps slots).
        self._backfillable = self._maskable and not (
            "local" in kinds and cfg.window and cfg.window < max_seq)

    # -- step functions (the reference's jit entry points) -------------

    def _prefill(self, params, tokens, valid_from=None):
        return prefill(params, tokens, self.cfg, max_seq=self.max_seq,
                       logits_last_only=True, valid_from=valid_from)

    def _decode(self, params, token, cache, pos: int, valid_from=None):
        return decode_step(params, token, cache, pos, self.cfg,
                           valid_from=valid_from)

    def _prefill_row(self, params, tokens, offset: int, valid_from):
        # Single-row prefill at absolute positions offset..offset+T-1
        # into a fresh (B=1) cache, merged into the live batch cache by
        # `_merge`. RoPE is applied at the true absolute positions so the
        # merged keys are indistinguishable from ones written by a
        # from-scratch group prefill.
        T = tokens.shape[1]
        positions = offset + torch.arange(T, dtype=torch.int32,
                                          device=tokens.device)
        cache = init_cache(self.cfg, 1, self.max_seq, device=tokens.device)
        logits, extras = forward(params, tokens, self.cfg, cache=cache,
                                 positions=positions, logits_last_only=True,
                                 valid_from=valid_from)
        return logits, extras["cache"]

    @staticmethod
    def _merge(bcache, rcache, row: int, offset: int, T: int):
        # Copy the row cache's first T seq slots into batch slot `row` at
        # seq offset `offset`, in place. The shared (S,) pos array needs
        # no update: group prefill + aligned decode already maintain
        # pos[s] == s for every slot below cache_pos.
        for bd, rd in zip(bcache["blocks"] + bcache["tail"],
                          rcache["blocks"] + rcache["tail"]):
            for key in ("k", "v"):
                b, r = bd[key], rd[key]
                if b.ndim == 5:     # stacked blocks: (G, B, S, KV, hd)
                    b[:, row, offset:offset + T] = r[:, 0, :T].to(b.dtype)
                else:               # tail: (B, S, KV, hd)
                    b[row, offset:offset + T] = r[0, :T].to(b.dtype)
        return bcache

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _tensor(self, a, dtype=torch.int32):
        return torch.as_tensor(np.asarray(a), dtype=dtype,
                               device=self.device)

    def warmup(self, prompt_len: int = 8):
        """Cold-start work: builds the kernels on first use and runs each
        step once (the serving analogue of the paper's model-load phase).
        Returns seconds."""
        self._sync()
        t0 = time.perf_counter()
        toks = torch.zeros((self.batch_size, prompt_len), dtype=torch.int32,
                           device=self.device)
        vf = torch.zeros((self.batch_size,), dtype=torch.int32,
                         device=self.device) if self._maskable else None
        _, cache = self._prefill(self.params, toks, vf)
        self._decode(self.params, toks[:, :1], cache, prompt_len, vf)
        if self._backfillable:
            # Run the backfill pair too: a first mid-group join must not
            # charge the cold start to a measured request.
            _, rc = self._prefill_row(self.params, toks[:1], 0,
                                      torch.zeros((1,), dtype=torch.int32,
                                                  device=self.device))
            self._merge(cache, rc, 0, 0, prompt_len)
        self._sync()
        dt = time.perf_counter() - t0
        self.stats.compile_time_s += dt
        return dt

    def _valid_from_for(self, tokens, lengths):
        """(B,) first attendable absolute position per row, or None."""
        B, T = tokens.shape
        if lengths is None:
            if not self._maskable:
                return None
            return torch.zeros((B,), dtype=torch.int32, device=self.device)
        if not self._maskable:
            raise NotImplementedError(
                f"padded prompts need per-row masking, which recurrent "
                f"blocks in pattern {self.cfg.pattern} do not support")
        lengths = np.asarray(lengths, np.int64)
        if lengths.shape != (B,) or np.any(lengths < 1) or np.any(lengths > T):
            raise ValueError(f"lengths must be (B,) in [1, {T}]")
        return self._tensor(T - lengths)

    def run_prefill(self, tokens: np.ndarray, lengths=None):
        """tokens: (B, T) int32, left-padded; lengths: optional (B,) count
        of real (right-aligned) tokens per row — padding positions are
        masked out of attention so they cannot contaminate logits or
        later cache reads. Returns next-token logits; stores cache."""
        if tokens.shape[0] != self.batch_size:
            raise ValueError(f"tokens has {tokens.shape[0]} rows, engine "
                             f"batch_size is {self.batch_size}")
        vf = self._valid_from_for(tokens, lengths)
        self._sync()
        t0 = time.perf_counter()
        logits, cache = self._prefill(self.params, self._tensor(tokens), vf)
        out = logits[:, 0].cpu().numpy()
        self.stats.prefill_calls += 1
        self.stats.prefill_time_s += time.perf_counter() - t0
        self.cache = cache
        self.cache_pos = tokens.shape[1]
        self.valid_from = vf
        return out

    def run_decode(self, tokens: np.ndarray):
        """tokens: (B, 1) int32 next tokens. Returns logits (B, V)."""
        if self.cache is None:
            raise RuntimeError(
                "no KV cache — call run_prefill first (run_decode on a "
                "fresh engine has nothing to decode against)")
        if self.cache_pos >= self.max_seq:
            raise RuntimeError(
                f"KV cache full (cache_pos={self.cache_pos}, "
                f"max_seq={self.max_seq})")
        self._sync()
        t0 = time.perf_counter()
        logits, self.cache = self._decode(
            self.params, self._tensor(tokens), self.cache, self.cache_pos,
            self.valid_from)
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
        previous occupant left behind. Returns next-token logits (V,)."""
        if self.cache is None:
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
            self.params, self._tensor(prompt[None]), offset,
            self._tensor([vf_row]))
        self.cache = self._merge(self.cache, rcache, slot, offset, T)
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
