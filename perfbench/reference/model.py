"""The plain reference: the served models' forward pass in float32 (or
its lower-precision control), in plain PyTorch.

It imports nothing of the program.  It reads a configuration's ``model``
section (a dict) and the weights the benchmark made, a nested dict in
the port's parameter layout: ``embed`` (V, D), ``unembed`` (D, V),
``final_norm`` (D,), and ``layers[l]`` with ``ln1``, ``ln2`` and either
``attn`` (``wq``, ``wk``, ``wv``, ``wo``) or ``ssm`` (``w_in``,
``conv_w``, ``conv_b``, ``dt_bias``, ``A_log``, ``skip_D``, ``w_norm``,
``w_out``), and ``mlp`` (``w_gate``, ``w_up``, ``w_down``) or ``moe``
(``w_router`` and the stacked experts' ``w_gate``, ``w_up``,
``w_down``).  Matrix weights are read as ``x @ w``.

The equations, one sequence at a time (a batch row):
- RMSNorm ``x / rms(x) * (1 + w)`` (the layout's gains are offsets).
- Attention: q, k, v projections, RoPE on the two halves of each head
  (base ``rope_theta``; none where ``use_rope`` is false), grouped-query
  causal softmax attention, the output projection.
- MLP ``(silu(x Wg) * (x Wu)) Wd``.
- MoE: a softmax router, the top_k experts of each token (ties to the
  lower index) with their probabilities renormalised, and a capacity of
  ``max(1, min(S, ceil(S * top_k / E * capacity_factor)))`` slots per
  expert and sequence, filled in token order (token-major over the k
  choices); a choice past its expert's capacity is dropped.
- SSD (Mamba-2) block: in-projection to z, x, B, C and dt; a causal
  depthwise convolution (width ``ssm_conv``, bias) over [x, B, C] and
  SiLU; dt = softplus(dt + dt_bias), A = -exp(A_log);
  ``y_t = sum_{s<=t} C_t.B_s exp(sum_{r=s+1..t} dt_r A) dt_s x_s + D x_t``,
  computed by chunks of ``CHUNK`` tokens; RMSNorm of ``y * silu(z)``; the
  out-projection.
- The final RMSNorm and the unembedding to the first ``vocab_size``
  logits.

``quant="fp8"`` is the control: every matrix product's weight (per
output column) and input (per row) rounded to float8 e4m3 with a scale,
the rest as above, in float32.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

#: tokens a chunk of the SSD recurrence
CHUNK = 128
#: query rows an attention block
Q_BLOCK = 1024
#: positions unembedded at once
UNEMBED_BLOCK = 512
FP8_MAX = 448.0


def no_tf32() -> None:
    """Float32 products in float32 on the card, not TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _fp8(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with one scale per slice along
    ``dim`` (the slice's largest magnitude maps to 448), back in
    float32."""
    scale = t.abs().amax(dim=dim, keepdim=True).clamp(min=1e-30) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


class Model:
    """The reference over one configuration and its weights."""

    def __init__(self, m: Dict, params: Dict, quant: Optional[str] = None):
        if quant not in (None, "fp8"):
            raise ValueError(f"unknown precision {quant!r}")
        self.m, self.p, self.quant = m, params, quant
        self.D = m["d_model"]
        self.eps = m.get("norm_eps", 1e-6)

    # ------------------------------------------------------------ blocks
    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        w = w.float()
        if self.quant == "fp8":
            w = _fp8(w, 0)
            x = _fp8(x, -1)
        return x @ w

    def norm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        x = x * torch.rsqrt((x * x).mean(-1, keepdim=True) + self.eps)
        return x * (1.0 + w.float())

    def kind(self, l: int) -> str:
        m = self.m
        if m["family"] == "ssm":
            return "ssm"
        if m.get("hybrid_period"):
            return ("attn" if l % m["hybrid_period"] == m["hybrid_attn_index"]
                    else "ssm")
        return "attn"

    def is_moe(self, l: int) -> bool:
        m = self.m
        if not m.get("n_experts"):
            return False
        period = m.get("moe_period", 1)
        return l % period == period - 1 if period > 1 else True

    def rope(self, x: torch.Tensor) -> torch.Tensor:
        """x (S, heads, hd): rotate the two halves by position."""
        S, _, hd = x.shape
        half = hd // 2
        inv = self.m.get("rope_theta", 10000.0) ** (
            -torch.arange(half, dtype=torch.float32, device=x.device) / half)
        ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] \
            * inv[None, :]
        cos, sin = ang.cos()[:, None, :], ang.sin()[:, None, :]
        x1, x2 = x[..., :half], x[..., half:]
        return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)

    def attention(self, p: Dict, h: torch.Tensor) -> torch.Tensor:
        m = self.m
        S = h.shape[0]
        H, KV = m["n_heads"], m["n_kv_heads"]
        hd = m.get("head_dim") or self.D // H
        q = self.mm(h, p["wq"]).view(S, H, hd)
        k = self.mm(h, p["wk"]).view(S, KV, hd)
        v = self.mm(h, p["wv"]).view(S, KV, hd)
        if m.get("use_rope", True):
            q, k = self.rope(q), self.rope(k)
        G = H // KV
        kt = k.permute(1, 2, 0)                      # (KV, hd, S)
        vt = v.permute(1, 0, 2)                      # (KV, S, hd)
        out = torch.empty(S, H, hd, dtype=torch.float32, device=h.device)
        for lo in range(0, S, Q_BLOCK):
            hi = min(S, lo + Q_BLOCK)
            qb = q[lo:hi].view(hi - lo, KV, G, hd).permute(1, 2, 0, 3)
            s = torch.matmul(qb.reshape(KV, G * (hi - lo), hd),
                             kt[:, :, :hi]).view(KV, G, hi - lo, hi)
            s = s * hd ** -0.5
            rows = torch.arange(lo, hi, device=h.device)[:, None]
            cols = torch.arange(hi, device=h.device)[None, :]
            s = s.masked_fill(cols > rows, float("-inf"))
            pr = torch.softmax(s, -1)
            o = torch.matmul(pr.view(KV, G * (hi - lo), hi), vt[:, :hi])
            out[lo:hi] = o.view(KV, G, hi - lo, hd).permute(2, 0, 1, 3) \
                .reshape(hi - lo, H, hd)
        return self.mm(out.reshape(S, H * hd), p["wo"])

    def mlp(self, p: Dict, h: torch.Tensor) -> torch.Tensor:
        return self.mm(F.silu(self.mm(h, p["w_gate"])) * self.mm(h, p["w_up"]),
                       p["w_down"])

    def moe(self, p: Dict, h: torch.Tensor) -> torch.Tensor:
        m = self.m
        S = h.shape[0]
        E, K = m["n_experts"], m["top_k"]
        probs = torch.softmax(self.mm(h, p["w_router"]), -1)
        top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
        top_p, top_e = top_p[:, :K], top_e[:, :K]
        top_p = top_p / top_p.sum(-1, keepdim=True).clamp(min=1e-9)
        cap = max(1, min(S, int(math.ceil(
            S * K / E * m.get("capacity_factor", 1.25)))))
        flat_e = top_e.reshape(-1)                   # token-major choices
        onehot = F.one_hot(flat_e, E)
        slot = (onehot.cumsum(0) - 1).gather(1, flat_e[:, None])[:, 0]
        keep = (slot < cap) & (top_p.reshape(-1) > 0)
        weight = top_p.reshape(-1)
        token = torch.arange(S * K, device=h.device) // K
        out = torch.zeros_like(h)
        for e in range(E):
            sel = torch.nonzero(keep & (flat_e == e))[:, 0]
            if sel.numel() == 0:
                continue
            x = h[token[sel]]
            y = self.mm(F.silu(self.mm(x, p["w_gate"][e]))
                        * self.mm(x, p["w_up"][e]), p["w_down"][e])
            out.index_add_(0, token[sel], y * weight[sel, None])
        return out

    def ssd(self, p: Dict, h: torch.Tensor) -> torch.Tensor:
        m = self.m
        S = h.shape[0]
        inner = m["ssm_expand"] * self.D
        N = m["ssm_state"]
        G = m.get("ssm_groups", 1)
        P = m["ssm_head_dim"]
        H = inner // P
        Kc = m["ssm_conv"]
        proj = self.mm(h, p["w_in"])
        z, xbc, dt = torch.split(proj, [inner, inner + 2 * G * N, H], -1)
        w = p["conv_w"].float()                      # (channels, Kc)
        padded = torch.cat([xbc.new_zeros(Kc - 1, xbc.shape[1]), xbc], 0)
        conv = p["conv_b"].float()[None, :].expand(S, -1).clone()
        for i in range(Kc):                          # tap Kc-1 is token t
            conv = conv + padded[i:i + S] * w[:, i][None, :]
        xbc = F.silu(conv)
        x, Bm, Cm = torch.split(xbc, [inner, G * N, G * N], -1)
        x = x.view(S, H, P)
        Bm = Bm.view(S, G, N).repeat_interleave(H // G, 1)   # (S, H, N)
        Cm = Cm.view(S, G, N).repeat_interleave(H // G, 1)
        dt = F.softplus(dt + p["dt_bias"].float())           # (S, H)
        a = dt * -torch.exp(p["A_log"].float())              # (S, H)
        y = torch.empty(S, H, P, dtype=torch.float32, device=h.device)
        state = torch.zeros(H, P, N, dtype=torch.float32, device=h.device)
        for lo in range(0, S, CHUNK):
            hi = min(S, lo + CHUNK)
            c = torch.cumsum(a[lo:hi], 0)                    # (Q, H)
            seg = c[:, None, :] - c[None, :, :]              # (t, s, H)
            tri = torch.ones(hi - lo, hi - lo, dtype=torch.bool,
                             device=h.device).tril()[:, :, None]
            decay = torch.exp(seg.masked_fill(~tri, float("-inf")))
            cb = torch.einsum("thn,shn->tsh", Cm[lo:hi], Bm[lo:hi])
            wts = cb * decay * dt[lo:hi][None, :, :]
            inside = torch.einsum("tsh,shp->thp", wts, x[lo:hi])
            carried = torch.einsum("thn,hpn->thp", Cm[lo:hi], state) \
                * torch.exp(c)[:, :, None]
            y[lo:hi] = inside + carried
            tail = torch.exp(c[-1][None, :] - c) * dt[lo:hi]  # (Q, H)
            state = state * torch.exp(c[-1])[:, None, None] + torch.einsum(
                "sh,shn,shp->hpn", tail, Bm[lo:hi], x[lo:hi])
        y = y + x * p["skip_D"].float()[None, :, None]
        y = self.norm(y.reshape(S, inner) * F.silu(z), p["w_norm"])
        return self.mm(y, p["w_out"])

    # ----------------------------------------------------------- forward
    def hidden(self, sequences: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Each sequence's final hidden states (S, D), after the final
        norm; the sequences go through the model layer by layer."""
        embed = self.p["embed"]
        xs = [embed[t.long()].float() for t in sequences]
        for l, lp in enumerate(self.p["layers"]):
            mixer = self.attention if self.kind(l) == "attn" else self.ssd
            key = "attn" if self.kind(l) == "attn" else "ssm"
            for i, x in enumerate(xs):
                x = x + mixer(lp[key], self.norm(x, lp["ln1"]))
                if "ln2" in lp:
                    h = self.norm(x, lp["ln2"])
                    x = x + (self.moe(lp["moe"], h) if "moe" in lp
                             else self.mlp(lp["mlp"], h))
                xs[i] = x
        return [self.norm(x, self.p["final_norm"]) for x in xs]

    def unembed(self, x: torch.Tensor) -> torch.Tensor:
        """Logits (n, vocab_size) of hidden rows ``x`` (n, D)."""
        V = self.m["vocab_size"]
        w = self.p.get("unembed")
        w = self.p["embed"].T if w is None else w
        out = [self.mm(x[i:i + UNEMBED_BLOCK], w)[:, :V]
               for i in range(0, x.shape[0], UNEMBED_BLOCK)]
        return torch.cat(out, 0)

    def logits(self, sequences: Sequence[torch.Tensor],
               positions: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Each sequence's logits at its ``positions`` (n_i, vocab)."""
        hs = self.hidden(sequences)
        return [self.unembed(h[pos.long()]) for h, pos in zip(hs, positions)]


def logits(m: Dict, params: Dict, sequences, positions,
           quant: Optional[str] = None) -> List[torch.Tensor]:
    with torch.no_grad():
        return Model(m, params, quant).logits(sequences, positions)
