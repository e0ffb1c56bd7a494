"""Step builders for serving: ``build_prefill_step`` (prompt ingestion
returning a KV cache) and ``build_decode_step`` (one token, updating
it).  The port of the serving half of ``repro/runtime/steps.py``; the
training step comes with the training slice (ROADMAP.md).

Steps run eagerly on the parameters' device.  ``build_prefill_step``
defaults to the ``"flash"`` attention kernel (the reference's default is
``"blockwise"``): prompt ingestion is the path the kernel is for.
"""

from __future__ import annotations

from typing import Optional

from ..models import transformer as T
from ..models.config import ModelConfig


def build_prefill_step(cfg: ModelConfig, max_seq: Optional[int] = None,
                       attn_impl: str = "flash"):
    def prefill_step(params, batch):
        kw = {k: v for k, v in batch.items() if k != "tokens"}
        return T.prefill(params, cfg, batch["tokens"], max_seq=max_seq,
                         impl=attn_impl, **kw)

    return prefill_step


def build_decode_step(cfg: ModelConfig):
    def decode_step(params, cache, token, pos):
        logits, cache = T.decode_step(params, cfg, token, cache, pos)
        return logits[:, 0, :], cache

    return decode_step
