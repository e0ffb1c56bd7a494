"""Mamba2 SSD (state-space duality) block in PyTorch: the port of
``repro/models/ssd.py``.

The sequence is split into chunks of Q tokens.  Within a chunk the
computation is a masked, decay-weighted attention-like product; across
chunks a first-order recurrence carries the running state (B, H, P, N)
in fp32, here a Python loop over chunks where the reference scans.
Jamba's Mamba-1 layers are instantiated with the same block (d_state
from the config), as in the reference.

Shapes: D = d_model, I = d_inner, H = ssm heads, P = head dim,
G = groups, N = d_state, K = conv kernel width, Q = chunk.

Prefill and decode round as the reference's do, which is not alike: the
prefill's convolution is K shifted multiply-adds and its skip term is
taken in the activations' type; decode's convolution is one product over
the window and its skip term is fp32.

``ssd_layer`` is a span of ``obs.spans`` (recorded only while a profiler
records).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..obs import spans
from ..runtime.sharding import (_local_kv, at_use, is_dtensor, like, lshard,
                                shard_block)
from .config import ModelConfig
from .layers import Layout, rms_norm_gated


def ssd_params_layout(cfg: ModelConfig) -> Layout:
    D, I, H = cfg.d_model, cfg.d_inner, cfg.ssm_heads
    G, N, K = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_conv
    d_in = 2 * I + 2 * G * N + H
    conv_dim = cfg.conv_dim
    return {
        "w_in": ((D, d_in), ("embed", "ssm_inner"), D ** -0.5),
        "conv_w": ((conv_dim, K), ("ssm_inner", "conv"), conv_dim ** -0.5),
        "conv_b": ((conv_dim,), ("ssm_inner",), 0.0),
        "dt_bias": ((H,), ("ssm_heads",), 0.0),
        "A_log": ((H,), ("ssm_heads",), 0.0),
        "skip_D": ((H,), ("ssm_heads",), 0.0),
        "w_norm": ((I,), ("ssm_inner",), 0.0),
        "w_out": ((I, D), ("ssm_inner", "embed"), I ** -0.5),
    }


def _split_in(h, cfg: ModelConfig):
    I, G, N, H = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
    return torch.split(h, [I, I, G * N, G * N, H], dim=-1)


def _causal_conv(x, w, b, cache: Optional[torch.Tensor] = None):
    """Depthwise causal conv.  x: (B,S,C); w: (C,K); cache: (B,K-1,C)
    holds the trailing inputs of the previous segment.  Returns
    (y (B,S,C), new_cache (B,K-1,C))."""
    K = w.shape[1]
    S = x.shape[1]
    if cache is None:
        cache = x.new_zeros(x.shape[0], K - 1, x.shape[2])
    xx = torch.cat([cache, x], dim=1)                       # (B, S+K-1, C)
    # K is tiny (4): K shifted multiply-adds, in the reference's order
    y = 0
    for i in range(K):
        y = y + xx[:, i:i + S, :] * w[:, i][None, None, :]
    y = y + b[None, None, :]
    # a copy, so that a kept cache does not hold all of ``xx``
    new_cache = xx[:, -(K - 1):, :].clone() if K > 1 else cache
    return y, new_cache


def ssd_scan(xh, dt, A, Bm, Cm, chunk: int,
             init_state: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD.  xh: (B,S,H,P); dt: (B,S,H); A: (H,) (negative);
    Bm, Cm: (B,S,G,N).  Returns (y (B,S,H,P), final_state (B,H,P,N)).

    The intra-chunk decay exp(cum_q - cum_k) is taken only where k <= q:
    the masked half is set to -inf before the exp, where the reference
    takes the exp everywhere and selects after it (the same values; its
    masked half can overflow to inf).  On DTensors each rank scans its
    batch rows and heads (``local_map``)."""
    if is_dtensor(xh):
        return _scan_local_heads(xh, dt, A, Bm, Cm, chunk, init_state)
    return _scan(xh, dt, A, Bm, Cm, chunk, init_state)


def _scan_local_heads(xh, dt, A, Bm, Cm, chunk, init_state):
    """``_scan`` on each rank's batch rows and heads of DTensor ``xh``,
    with the groups of B and C its heads read (head h reads group
    ``h // (H / G)``, as kv heads are read in ``map_local_heads``)."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = xh.device_mesh
    H, G = xh.shape[2], Bm.shape[2]
    xp = [p if p in (Shard(0), Shard(2)) else Replicate()
          for p in xh.placements]
    bp = [Shard(0) if p == Shard(0) else Replicate() for p in xp]
    ap = [Shard(0) if p == Shard(2) else Replicate() for p in xp]
    sp = [Shard(1) if p == Shard(2) else p for p in xp]   # (B, H, P, N)
    block, n_blocks = shard_block(mesh, xp, 2)
    n_loc = H // n_blocks

    def local(xl, dtl, al, bl, cl, *state):
        bl = _local_kv(bl, block * n_loc, n_loc, H // G).contiguous()
        cl = _local_kv(cl, block * n_loc, n_loc, H // G).contiguous()
        return _scan(xl, dtl, al, bl, cl, chunk, *state)

    args = [xh.redistribute(mesh, xp), like(dt, xh).redistribute(mesh, xp),
            like(A, xh).redistribute(mesh, ap),
            like(Bm, xh).redistribute(mesh, bp),
            like(Cm, xh).redistribute(mesh, bp)]
    ins = [xp, xp, ap, bp, bp]
    if init_state is not None:
        args.append(like(init_state, xh).redistribute(mesh, sp))
        ins.append(sp)
    run = local_map(local, out_placements=(xp, sp), in_placements=tuple(ins),
                    device_mesh=mesh)
    return run(*args)


def _scan(xh, dt, A, Bm, Cm, chunk: int,
          init_state: Optional[torch.Tensor] = None):
    B, S, H, P = xh.shape
    G, N = Bm.shape[2], Bm.shape[3]
    hpg = H // G
    Q = min(chunk, S)
    S_in = S
    pad = (-S) % Q
    if pad:  # padded tail has dt=0 => zero contribution to the state
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, 0, 0, pad))
        S = S + pad
    nc = S // Q

    a = dt * A[None, None, :]                               # (B,S,H) <= 0
    causal = torch.ones(Q, Q, dtype=torch.bool,
                        device=xh.device).tril()[None, :, :, None]
    state = init_state if init_state is not None else \
        torch.zeros(B, H, P, N, dtype=torch.float32, device=xh.device)
    ys = []
    for c in range(nc):
        sl = slice(c * Q, (c + 1) * Q)
        a_c, x_c, dt_c = a[:, sl], xh[:, sl].float(), dt[:, sl]
        B_c, C_c = Bm[:, sl].float(), Cm[:, sl].float()
        cum = torch.cumsum(a_c, dim=1)                      # (B,Q,H)
        # intra-chunk (attention-like, per head through its group)
        CB = torch.einsum("bqgn,bkgn->bgqk", C_c, B_c)      # (B,G,Q,Q)
        diff = cum[:, :, None, :] - cum[:, None, :, :]      # (B,Q,K,H)
        Ldec = torch.exp(torch.where(causal, diff, float("-inf")))
        CBh = torch.repeat_interleave(CB, hpg, dim=1)       # (B,H,Q,K)
        scores = CBh.permute(0, 2, 3, 1) * Ldec * dt_c[:, None, :, :]
        y_diag = torch.einsum("bqkh,bkhp->bqhp", scores, x_c)
        # inter-chunk: contribution of the carried state (group-aware)
        state_g = state.reshape(B, G, hpg, P, N)
        y_off = torch.einsum("bqgn,bghpn->bqghp", C_c,
                             state_g).reshape(B, Q, H, P)
        y_off = y_off * torch.exp(cum)[..., None]
        # new chunk state
        decay_tail = torch.exp(cum[:, -1:, :] - cum)        # (B,Q,H)
        sB = torch.repeat_interleave(Bm[:, sl], hpg, dim=2)  # (B,Q,H,N)
        contrib = torch.einsum("bqhn,bqhp->bhpn",
                               (sB * (dt_c * decay_tail)[..., None]).float(),
                               x_c)
        state = state * torch.exp(a_c.sum(dim=1))[..., None, None] + contrib
        ys.append((y_diag + y_off).to(xh.dtype))
    y = torch.cat(ys, dim=1)
    return y[:, :S_in], state


@spans.span("ssd_layer")
def ssd_layer(p, x, cfg: ModelConfig, cache: Optional[dict] = None,
              return_cache: bool = False):
    """Full-sequence SSD block: (B,S,D) -> (B,S,D).

    With ``return_cache`` also returns {"conv": (B,K-1,conv_dim),
    "state": (B,H,P,N)} for subsequent decode."""
    B, S, D = x.shape
    H, P = cfg.ssm_heads, cfg.ssm_head_dim
    G, N = cfg.ssm_groups, cfg.ssm_state
    h = x @ at_use(p["w_in"], x.dtype)
    z, xc, Bm, Cm, dt = _split_in(h, cfg)
    conv_in = torch.cat([xc, Bm, Cm], dim=-1)
    conv_out, conv_tail = _causal_conv(
        conv_in, at_use(p["conv_w"], x.dtype), p["conv_b"].to(x.dtype),
        None if cache is None else cache.get("conv"))
    conv_out = F.silu(conv_out)
    xc = conv_out[..., :cfg.d_inner]
    Bm = conv_out[..., cfg.d_inner:cfg.d_inner + G * N].reshape(B, S, G, N)
    Cm = conv_out[..., cfg.d_inner + G * N:].reshape(B, S, G, N)
    dt = F.softplus(dt.float() + p["dt_bias"].float()[None, None, :])
    A = -torch.exp(p["A_log"].float())
    xh = lshard(xc.reshape(B, S, H, P), "batch", "seq", "ssm_heads", None)
    y, state = ssd_scan(xh, dt, A, Bm, Cm, cfg.ssm_chunk,
                        None if cache is None else cache.get("state"))
    y = y + xh.float().to(y.dtype) * \
        p["skip_D"].to(y.dtype)[None, None, :, None]
    y = y.reshape(B, S, cfg.d_inner)
    y = rms_norm_gated(y, z, p["w_norm"], cfg.norm_eps)
    out = y @ at_use(p["w_out"], x.dtype)
    if return_cache:
        return out, {"conv": conv_tail, "state": state}
    return out


def _step(xh, dt, A, Bm, Cm, state, skip):
    """One token's recurrence: xh (B,H,P), dt (B,H), A and skip (H,),
    Bm, Cm (B,G,N), state (B,H,P,N) fp32; (y (B,H,P) fp32, new state)."""
    hpg = xh.shape[1] // Bm.shape[1]
    decay = torch.exp(dt * A[None, :])                      # (B,H)
    Bh = torch.repeat_interleave(Bm, hpg, dim=1)            # (B,H,N)
    state = state * decay[..., None, None] + \
        torch.einsum("bh,bhn,bhp->bhpn", dt, Bh.float(), xh.float())
    Ch = torch.repeat_interleave(Cm, hpg, dim=1)
    y = torch.einsum("bhn,bhpn->bhp", Ch.float(), state)
    return y + xh.float() * skip[None, :, None], state


def _step_local_heads(xh, dt, A, Bm, Cm, state, skip):
    """``_step`` on each rank's batch rows and heads of DTensor ``xh``,
    with the groups its heads read, as ``_scan_local_heads``."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    xh = lshard(xh, "batch", "ssm_heads", None)
    mesh = xh.device_mesh
    H, G = xh.shape[1], Bm.shape[1]
    xp = [p if p in (Shard(0), Shard(1)) else Replicate()
          for p in xh.placements]
    bp = [Shard(0) if p == Shard(0) else Replicate() for p in xp]
    hp = [Shard(0) if p == Shard(1) else Replicate() for p in xp]
    block, n_blocks = shard_block(mesh, xp, 1)
    n_loc = H // n_blocks

    def local(xl, dtl, al, bl, cl, sl, kl):
        groups = [_local_kv(t[:, None], block * n_loc, n_loc, H // G)[:, 0]
                  for t in (bl, cl)]
        return _step(xl, dtl, al, *groups, sl, kl)

    ins = (xp, xp, hp, bp, bp, xp, hp)
    args = [like(t, xh).redistribute(mesh, pl)
            for t, pl in zip((xh, dt, A, Bm, Cm, state, skip), ins)]
    run = local_map(local, out_placements=(xp, xp), in_placements=ins,
                    device_mesh=mesh)
    return run(*args)


def ssd_decode(p, x, cache: dict, cfg: ModelConfig):
    """Single-token decode: x (B,1,D); cache {"conv": (B,K-1,conv_dim),
    "state": (B,H,P,N)}.  Returns (out (B,1,D), cache), the cache's
    tensors written in place.  On DTensors each rank steps its batch
    rows and heads (``local_map``)."""
    B = x.shape[0]
    H, P = cfg.ssm_heads, cfg.ssm_head_dim
    G, N = cfg.ssm_groups, cfg.ssm_state
    h = x @ at_use(p["w_in"], x.dtype)                      # (B,1,d_in)
    z, xc, Bm, Cm, dt = _split_in(h, cfg)
    conv_in = torch.cat([xc, Bm, Cm], dim=-1)               # (B,1,conv_dim)
    window = torch.cat([cache["conv"].to(x.dtype), conv_in], dim=1)
    w = at_use(p["conv_w"], x.dtype)                        # (c,K)
    conv_out = torch.einsum("bkc,ck->bc", window, w) + p["conv_b"].to(x.dtype)
    conv_out = F.silu(conv_out)[:, None, :]                 # (B,1,c)
    xc = conv_out[..., :cfg.d_inner]
    Bm = conv_out[..., cfg.d_inner:cfg.d_inner + G * N].reshape(B, G, N)
    Cm = conv_out[..., cfg.d_inner + G * N:].reshape(B, G, N)
    dt = F.softplus(dt.float() + p["dt_bias"].float()[None, None, :])[:, 0]
    A = -torch.exp(p["A_log"].float())
    xh = xc.reshape(B, H, P)
    args = (xh, dt, A, Bm, Cm, cache["state"], p["skip_D"].float())
    if is_dtensor(xh):
        y, state = _step_local_heads(*args)
    else:
        y, state = _step(*args)
    y = y.reshape(B, 1, cfg.d_inner).to(x.dtype)
    y = rms_norm_gated(y, z, p["w_norm"], cfg.norm_eps)
    out = y @ at_use(p["w_out"], x.dtype)
    cache["conv"].copy_(window[:, 1:, :])
    cache["state"].copy_(state)
    return out, cache
