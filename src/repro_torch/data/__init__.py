"""Data pipeline: synthetic LM tasks + file-corpus byte LM, with
deterministic, resumable, host-sharded iterators (fault tolerance:
an iterator's state is just (seed, step) — checkpointable as two ints)."""

from repro_torch.data.pipeline import (
    MarkovLMTask,
    CopyTask,
    ByteCorpus,
    DataIterator,
)

__all__ = ["MarkovLMTask", "CopyTask", "ByteCorpus", "DataIterator"]
