"""Deterministic, shardable synthetic token pipeline: the port of
``repro/data/pipeline.py`` (numpy only, the same Philox draws).

Batches are a pure function of (seed, shard, step), so any host can
regenerate any range — restart never needs data movement, only the
DATA_CONSUME changelog records to know where to resume.  The pipeline
emits one record per consumed range through the host's ActivityTracker
(the journal IS the replay log)."""

from __future__ import annotations

from typing import Dict, Iterator, Optional, Tuple

import numpy as np

from ..track.tracker import ActivityTracker


class ShardedTokenPipeline:
    def __init__(self, vocab_size: int, seq_len: int, global_batch: int,
                 n_shards: int, shard_id: int, seed: int = 0,
                 tracker: Optional[ActivityTracker] = None):
        assert global_batch % n_shards == 0
        self.vocab = vocab_size
        self.seq_len = seq_len
        self.local_batch = global_batch // n_shards
        self.n_shards = n_shards
        self.shard_id = shard_id
        self.seed = seed
        self.tracker = tracker
        self.step = 0

    # -- deterministic generation -------------------------------------------
    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """Batch for (shard, step) — stateless; used for replay too."""
        rng = np.random.Generator(np.random.Philox(
            key=self.seed, counter=[0, 0, self.shard_id, step]))
        tokens = rng.integers(0, self.vocab,
                              (self.local_batch, self.seq_len + 1),
                              dtype=np.int64).astype(np.int32)
        return {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        batch = self.batch_at(self.step)
        if self.tracker is not None:
            lo = self.step * self.local_batch
            self.tracker.data_consume(self.step, self.shard_id, lo,
                                      lo + self.local_batch)
        self.step += 1
        return batch

    # -- restart -------------------------------------------------------------
    def seek(self, step: int) -> None:
        self.step = step

    @staticmethod
    def resume_step_from_records(records) -> int:
        """Highest consumed step + 1, from replayed DATA_CONSUME records."""
        hi = -1
        for rec in records:
            hi = max(hi, rec.tfid.ver)
        return hi + 1
