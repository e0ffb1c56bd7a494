"""Plain PyTorch oracle for the attention kernels: the port of
``repro/kernels/ref.py`` (independent of ``models.layers``; deliberately
the simplest possible formulation).

Unlike ``flash_attention.flash_attention_reference``, which gives 0 on a
row with nothing visible as the kernels do, this oracle keeps the
reference's plain softmax and gives NaN there.
"""

from __future__ import annotations

import torch


def attention_reference(q, k, v, *, causal=True, window=0, cap=0.0,
                        scale=None):
    """q: (B,Sq,H,D); k,v: (B,Sk,KV,D).  Returns (B,Sq,H,D) in q.dtype."""
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = scale if scale is not None else D ** -0.5
    kh = torch.repeat_interleave(k, G, dim=2)            # (B,Sk,H,D)
    vh = torch.repeat_interleave(v, G, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kh.float()) * scale
    if cap:
        s = torch.tanh(s / cap) * cap
    qp = torch.arange(Sq, device=q.device)[:, None]
    kp = torch.arange(Sk, device=q.device)[None, :]
    ok = torch.ones(Sq, Sk, dtype=torch.bool, device=q.device)
    if causal:
        ok &= kp <= qp
    if window:
        ok &= kp > qp - window
    s = torch.where(ok[None, None], s, float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p, vh.float())
    return o.to(q.dtype)
