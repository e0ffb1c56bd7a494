"""The model-facing attention call (the port of ``repro/kernels/ops.py``).

The reference's wrapper folds GQA heads, transposes to ``(B*H, S, D)``,
pads the sequences to block multiples and head_dim to the TPU's 128
lanes, and slices the result back.  The port's kernel reads the
``(B, S, heads, D)`` layout by strides and masks its own ragged edges,
so none of that is needed here: this is the reference's signature over
``flash_attention.flash_attention_bshd``.
"""

from __future__ import annotations

from typing import Optional

import torch

from .flash_attention import flash_attention_bshd


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_pos: Optional[torch.Tensor] = None,
                    k_pos: Optional[torch.Tensor] = None, *,
                    causal: bool = True, window: int = 0, cap: float = 0.0,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q: (B,Sq,H,D); k,v: (B,Sk,KV,D) -> (B,Sq,H,D) in q's type.

    Positions are taken as contiguous from 0 (the prefill layout);
    ``q_pos``/``k_pos`` exist for ``models.layers.attention_core``'s
    signature and are not read, as in the reference."""
    return flash_attention_bshd(q, k, v, causal=causal, window=window,
                                cap=cap, scale=scale)
