"""Synthetic + file-backed LM data sources.

All sources are *stateless generators*: batch(step) is a pure function of
(seed, step, host_id), so restart-after-failure resumes bit-identically
from the step counter alone — no iterator state to snapshot (checkpoint
resume tests rely on this).

- MarkovLMTask: tokens from a random sparse Markov chain — learnable
  structure with tunable difficulty (entropy), good for loss-goes-down
  tests.
- CopyTask: `prompt # prompt` — exact-match accuracy is measurable, so
  differently-sized models get genuinely different accuracies for the
  serving demos (the LM analogue of the paper's ImageNet accuracy axis).
- ByteCorpus: byte-level LM over a real file tree (this repo's own
  sources by default).
"""

from __future__ import annotations

import hashlib
import os
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np


def _rng_for(seed: int, step: int, host: int) -> np.random.Generator:
    mix = hashlib.blake2b(f"{seed}:{step}:{host}".encode(),
                          digest_size=8).digest()
    return np.random.default_rng(int.from_bytes(mix, "little"))


@dataclass
class MarkovLMTask:
    vocab: int = 256
    branching: int = 4      # out-degree of each state
    seed: int = 0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        self.next_tokens = rng.integers(0, self.vocab,
                                        (self.vocab, self.branching))
        probs = rng.dirichlet(np.ones(self.branching) * 0.5, self.vocab)
        self.probs = probs

    def batch(self, step: int, batch: int, seq: int, host: int = 0) -> dict:
        rng = _rng_for(self.seed, step, host)
        toks = np.zeros((batch, seq + 1), np.int32)
        toks[:, 0] = rng.integers(0, self.vocab, batch)
        for t in range(seq):
            cur = toks[:, t]
            choice = np.array([rng.choice(self.branching, p=self.probs[c])
                               for c in cur])
            toks[:, t + 1] = self.next_tokens[cur, choice]
        return {"inputs": toks[:, :-1], "labels": toks[:, 1:]}


@dataclass
class CopyTask:
    vocab: int = 64          # data tokens; vocab-1 is the separator
    prompt_len: int = 12
    seed: int = 0

    @property
    def sep(self) -> int:
        return self.vocab - 1

    def batch(self, step: int, batch: int, host: int = 0) -> dict:
        rng = _rng_for(self.seed, step, host)
        p = rng.integers(0, self.vocab - 1,
                         (batch, self.prompt_len)).astype(np.int32)
        sep = np.full((batch, 1), self.sep, np.int32)
        seq = np.concatenate([p, sep, p], axis=1)
        return {"inputs": seq[:, :-1], "labels": seq[:, 1:],
                "prompt": np.concatenate([p, sep], axis=1)}

    def exact_match(self, engine, n_batches: int = 4, start_step: int = 10_000):
        """Fraction of positions correctly copied by greedy decoding."""
        correct = total = 0
        for b in range(n_batches):
            d = self.batch(start_step + b, engine.batch_size)
            out = engine.generate(d["prompt"], self.prompt_len)
            correct += (out == d["prompt"][:, :self.prompt_len]).sum()
            total += out.size
        return correct / total


class ByteCorpus:
    """Byte-level LM over a directory of text files."""

    def __init__(self, root: str, exts=(".py", ".md"), seed: int = 0,
                 max_bytes: int = 4_000_000):
        blobs = []
        root = os.path.abspath(root)  # ".." segments would trip the
        # hidden-directory filter below
        for dirpath, _, files in sorted(os.walk(root)):
            if any(part.startswith(".") for part in dirpath.split(os.sep)):
                continue
            for f in sorted(files):
                if f.endswith(tuple(exts)):
                    with open(os.path.join(dirpath, f), "rb") as fh:
                        blobs.append(fh.read())
            if sum(map(len, blobs)) > max_bytes:
                break
        self.data = np.frombuffer(b"\n".join(blobs), dtype=np.uint8)
        self.seed = seed
        self.vocab = 256

    def batch(self, step: int, batch: int, seq: int, host: int = 0) -> dict:
        rng = _rng_for(self.seed, step, host)
        starts = rng.integers(0, len(self.data) - seq - 1, batch)
        rows = np.stack([self.data[s:s + seq + 1] for s in starts])
        rows = rows.astype(np.int32)
        return {"inputs": rows[:, :-1], "labels": rows[:, 1:]}


class DataIterator:
    """Host-sharded step iterator: each host draws its own sub-batch via
    its host id; global batch = per_host_batch * n_hosts. Resume = set
    .step (stored in the train checkpoint)."""

    def __init__(self, source, batch: int, seq: Optional[int] = None,
                 host: int = 0, n_hosts: int = 1, step: int = 0):
        self.source = source
        self.batch = batch
        self.seq = seq
        self.host = host
        self.n_hosts = n_hosts
        self.step = step

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        if self.seq is not None:
            d = self.source.batch(self.step, self.batch, self.seq, self.host)
        else:
            d = self.source.batch(self.step, self.batch, self.host)
        self.step += 1
        return d
