"""The one traffic generator: reads a mix's parameters
(``perfbench/traffic/<mix>.json``) and draws its requests from the seed.

Two kinds of mix:

- ``prefill``: closed-loop batches of ``batch`` prompts of one length (a
  server that groups requests by length).  The lengths are ``count``
  values spaced evenly in log from ``min`` to ``max``, rounded to
  ``round_to``; every block of ``count`` batches takes each length
  once, in an order drawn from the seed, so every seed offers the same
  work in another order.
- ``decode``: closed-loop session batches of ``batch`` sessions, each a
  ``prompt_len``-token prompt and ``gen_tokens`` greedy tokens; the next
  batch is prefilled once the last has returned its last token.

Token ids are uniform over the vocabulary, drawn on the device from a
generator seeded by (seed, batch index), so any batch can be drawn
again after the window for the check.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch


def derive(seed: int, *index: int) -> int:
    """A 63-bit seed for one stream of ``seed``'s draws."""
    words = [seed % (1 << 64)] + [int(i) for i in index]
    state = np.random.SeedSequence(words).generate_state(2, dtype=np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def lengths(spec: Dict) -> List[int]:
    """The prefill mix's prompt lengths, shortest first."""
    lo, hi, n = spec["min"], spec["max"], spec["count"]
    r = spec.get("round_to", 1)
    raw = [lo * (hi / lo) ** (i / (n - 1)) for i in range(n)]
    return [max(r, int(round(x / r)) * r) for x in raw]


class Traffic:
    """One mix under one seed."""

    def __init__(self, spec: Dict, seed: int, vocab: int):
        self.spec, self.seed, self.vocab = spec, seed, vocab
        self.kind = spec["kind"]
        if self.kind not in ("prefill", "decode"):
            raise ValueError(f"unknown traffic kind {self.kind!r}")
        self.batch = spec["batch"]
        self._orders: Dict[int, List[int]] = {}
        if self.kind == "prefill":
            self.lengths = lengths(spec["lengths"])

    def prompt_len(self, j: int) -> int:
        """Prompt length of batch ``j``."""
        if self.kind == "decode":
            return self.spec["prompt_len"]
        n = len(self.lengths)
        block = j // n
        if block not in self._orders:
            rng = np.random.default_rng(derive(self.seed, 0, block))
            self._orders[block] = list(rng.permutation(n))
        return self.lengths[self._orders[block][j % n]]

    def tokens(self, j: int, device) -> torch.Tensor:
        """Batch ``j``'s prompts, (batch, prompt_len(j)) int64."""
        gen = torch.Generator(device=device).manual_seed(
            derive(self.seed, 1, j))
        return torch.randint(0, self.vocab, (self.batch, self.prompt_len(j)),
                             generator=gen, device=device)

    def warmup_tokens(self, length: int, device) -> torch.Tensor:
        """A warm-up batch of ``length``-token prompts (not served)."""
        gen = torch.Generator(device=device).manual_seed(
            derive(self.seed, 4, length))
        return torch.randint(0, self.vocab, (self.batch, length),
                             generator=gen, device=device)

    def check_sample(self, done: List[int], check: Dict) -> List[tuple]:
        """The (batch, row) prompts the check compares, drawn from the
        seed among the ``done`` batches: every row of the longest batches
        (``longest_batches``, the earliest first among equals) and
        ``other_prompts`` more rows of other batches; for a decode mix,
        ``sessions`` rows of the first session batch."""
        if self.kind == "decode":
            rng = np.random.default_rng(derive(self.seed, 2))
            rows = rng.choice(self.batch, size=min(check["sessions"],
                                                   self.batch), replace=False)
            return [(0, int(r)) for r in sorted(rows)]
        by_len = sorted(done, key=lambda j: (-self.prompt_len(j), j))
        longest = by_len[:check.get("longest_batches", 1)]
        out = [(j, r) for j in longest for r in range(self.batch)]
        rest = [(j, r) for j in done if j not in longest
                for r in range(self.batch)]
        rng = np.random.default_rng(derive(self.seed, 2))
        k = min(check.get("other_prompts", 0), len(rest))
        if k:
            for i in sorted(rng.choice(len(rest), size=k, replace=False)):
                out.append(rest[int(i)])
        return out


def p95(values: List[float]) -> float:
    """The 95th percentile by linear interpolation between order
    statistics (numpy's default), of every value given."""
    if not values:
        return math.nan
    return float(np.percentile(np.asarray(values, dtype=np.float64), 95))
