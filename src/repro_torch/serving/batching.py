"""Continuous batching scheduler.

The paper notes that throughput-batching serving systems "may increase
waiting time of some requests" — this scheduler bounds that: requests
join the next decode group as slots free, instead of waiting for a whole
batch to drain. Decode steps are aligned per group (engine constraint);
the scheduler's job is slot assignment, padding, and retirement."""

from __future__ import annotations

import heapq
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, List, Optional

import numpy as np


@dataclass(order=True)
class Request:
    arrival: float
    rid: int = field(compare=False)
    prompt: np.ndarray = field(compare=False, repr=False)
    max_new_tokens: int = field(compare=False, default=16)
    sla_ms: float = field(compare=False, default=0.0)
    t_input_ms: float = field(compare=False, default=0.0)
    # Issuing device (fleet serving, DESIGN.md §10): keys the Router's
    # per-device EstimatorBank; None = single shared estimator.
    device_id: Optional[str] = field(compare=False, default=None)
    # Tenant tag (multi-tenant cluster serving, DESIGN.md §16): names
    # the device population / SLA class this request bills to; None =
    # single-tenant stack.
    tenant: Optional[str] = field(compare=False, default=None)
    # outputs
    tokens: list = field(compare=False, default_factory=list)
    start_exec: float = field(compare=False, default=0.0)
    finish: float = field(compare=False, default=0.0)
    model: str = field(compare=False, default="")


class FifoQueue:
    """Minimal per-model queue with the same `submit` protocol as
    `ContinuousBatcher` — the Router's default when a stack doesn't
    attach its own batcher."""

    def __init__(self):
        self.items: Deque[Request] = deque()

    def submit(self, req: Request):
        self.items.append(req)

    def pop(self) -> Request:
        return self.items.popleft()

    def __len__(self) -> int:
        return len(self.items)


class ContinuousBatcher:
    """Groups requests into aligned decode batches of size `batch_size`.

    `form_group(now)` seeds a fresh group when the engine is idle;
    `backfill(now, ...)` joins queued arrivals into slots freed by
    early-retiring members *mid-group* (true continuous batching — the
    engine prefills the newcomer's row into the live cache via
    `InferenceEngine.prefill_row`). Decode steps stay aligned across the
    group (engine constraint); the scheduler's job is slot assignment,
    padding, and retirement."""

    def __init__(self, batch_size: int, prompt_len: int):
        self.batch_size = batch_size
        self.prompt_len = prompt_len
        self.queue: List[Request] = []
        # slots[i] is the request bound to engine batch slot i (or None).
        self.slots: List[Optional[Request]] = [None] * batch_size
        self.done: List[Request] = []

    def submit(self, req: Request):
        heapq.heappush(self.queue, req)

    @property
    def n_active(self) -> int:
        return sum(1 for s in self.slots if s is not None)

    @property
    def has_work(self) -> bool:
        return bool(self.queue) or self.n_active > 0

    def form_group(self, now: float) -> Optional[List[Request]]:
        """Take up to batch_size arrived requests into a fresh group.
        (The aligned-decode engine prefills a whole group at once, so new
        groups form only when the previous group has fully drained.)"""
        if self.n_active > 0:
            return None
        ready = []
        while self.queue and len(ready) < self.batch_size:
            if self.queue[0].arrival <= now:
                ready.append(heapq.heappop(self.queue))
            else:
                break
        if not ready:
            return None
        self.slots = [None] * self.batch_size
        for i, r in enumerate(ready):
            self.slots[i] = r
            r.start_exec = now
        return ready

    def backfill(self, now: float, budget: Optional[int] = None):
        """Join queued arrivals into freed slots mid-group.

        Returns [(slot_index, request)] for the engine to `prefill_row`.
        budget: optional cap on decode steps the group can still take
        (engine free context) — a joiner needing more tokens than the
        cache has room for must wait for the next fresh group."""
        if self.n_active == 0:
            return []        # nothing live to join; use form_group
        joins = []
        deferred = []
        for i, slot in enumerate(self.slots):
            if slot is not None:
                continue
            while self.queue and self.queue[0].arrival <= now:
                r = heapq.heappop(self.queue)
                if budget is not None and r.max_new_tokens > budget:
                    deferred.append(r)
                    continue
                self.slots[i] = r
                r.start_exec = now
                joins.append((i, r))
                break
            if self.slots[i] is None:
                break        # queue exhausted (or all remaining deferred)
        for r in deferred:
            heapq.heappush(self.queue, r)
        return joins

    def pad_prompts(self) -> np.ndarray:
        """Left-pad live prompts to (batch_size, prompt_len). Pad token is
        0 — harmless only because the engine masks positions below each
        row's real length (see `prompt_lengths`)."""
        out = np.zeros((self.batch_size, self.prompt_len), np.int32)
        for i, r in enumerate(self.slots):
            if r is not None:
                p = r.prompt[-self.prompt_len:]
                out[i, -len(p):] = p
        return out

    def prompt_lengths(self) -> np.ndarray:
        """(batch_size,) real token count per row of `pad_prompts` output
        (1 for empty slots — a full-mask row would NaN the softmax)."""
        out = np.ones(self.batch_size, np.int64)
        for i, r in enumerate(self.slots):
            if r is not None:
                out[i] = min(len(r.prompt), self.prompt_len)
        return out

    def record_token(self, slot: int, tok: int, now: float):
        """Append one token to the request in `slot`; retire it (freeing
        the slot) once it has max_new_tokens."""
        r = self.slots[slot]
        if r is None:
            return
        r.tokens.append(int(tok))
        if len(r.tokens) >= r.max_new_tokens:
            r.finish = now
            self.done.append(r)
            self.slots[slot] = None

    def record_tokens(self, toks: np.ndarray, now: float):
        """toks: (batch_size,) — append per slot; retire finished slots."""
        for i in range(self.batch_size):
            self.record_token(i, toks[i], now)
