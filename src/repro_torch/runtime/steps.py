"""Step builders: the port of ``repro/runtime/steps.py``.

- ``build_train_step`` — training step with gradient accumulation over
  microbatches, per-layer remat, fp32 master parameters and AdamW;
- ``build_prefill_step`` / ``build_decode_step`` — serving: prompt
  ingestion returning a KV cache; single-token decode updating it.

Steps run eagerly on the parameters' device.  The training step updates
the parameters and the optimizer state in place (``optim.adamw``) and
accumulates the microbatches' gradients in the parameters' ``.grad``
(fp32 for fp32 parameters), so a step holds four copies of the tree, not
the reference's five.  It trains with ``naive`` attention by default, as
the reference does, and refuses ``flash``: the attention kernel has no
backward pass in either package.  ``build_prefill_step`` defaults to the
``"flash"`` attention kernel (the reference's default is
``"blockwise"``): prompt ingestion is the path the kernel is for.

Under a rules context (``sharding.use_rules``) with DTensor parameters
the same steps run sharded: the batch is placed by its logical axes as
the model reads it, gradients come back as DTensors, and the metrics
are whole tensors on every rank.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..models import transformer as T
from ..models.config import ModelConfig
from ..optim import adamw
from .sharding import full


class TrainHParams(NamedTuple):
    n_micro: int = 1
    peak_lr: float = 3e-4
    warmup: int = 100
    total_steps: int = 10_000
    weight_decay: float = 0.1
    max_grad_norm: float = 1.0
    attn_impl: str = "naive"
    remat: bool = True
    remat_policy: str = "dots"       # dots | none | everything


#: the reference's remat policies by name (``models.transformer``)
REMAT_POLICIES = T.REMAT_POLICIES


def build_train_step(cfg: ModelConfig, hp: TrainHParams):
    """Returns train_step(params, opt_state, batch) ->
    (params, opt_state, metrics).  ``batch`` is a dict with tokens and
    labels (+ frames / image_embeds when the arch needs them; numpy or
    tensors), global batch leading, each key cut into the same
    microbatches and passed on to ``loss_fn``; ``metrics`` holds
    ``loss`` and ``grad_norm`` as 0-d fp32 tensors on the parameters'
    device and ``lr`` as a float."""
    if hp.attn_impl == "flash":
        raise ValueError(
            "attn_impl='flash' cannot train: the flash attention kernel "
            "has no backward pass, in this package or in the reference "
            "(its Pallas kernel has no VJP); train with 'naive' or "
            "'blockwise'")
    if hp.remat_policy not in REMAT_POLICIES:
        raise ValueError(f"unknown remat policy {hp.remat_policy!r}: "
                         f"{', '.join(REMAT_POLICIES)}")

    def train_step(params, opt_state, batch):
        device = params["embed"].device
        batch = {k: torch.as_tensor(v).to(device) for k, v in batch.items()}
        B = batch["tokens"].shape[0]
        n_micro = min(hp.n_micro, B)
        if B % n_micro:
            raise ValueError(f"batch {B} does not split into {n_micro} "
                             "microbatches")
        mb = B // n_micro
        plist = adamw.leaves(params)
        for p in plist:
            p.requires_grad_(True)
            p.grad = None
        loss_sum = torch.zeros((), dtype=torch.float32, device=device)
        with torch.enable_grad():
            for i in range(n_micro):
                micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
                total, (loss, _aux) = T.loss_fn(
                    params, cfg, micro.pop("tokens"), micro.pop("labels"),
                    impl=hp.attn_impl, remat=hp.remat,
                    remat_policy=hp.remat_policy, **micro)
                (total / n_micro).backward()
                loss_sum += full(loss.detach())
        grads = adamw.tree_map(lambda p: p.grad, params)
        lr = adamw.cosine_lr(opt_state.step, peak=hp.peak_lr,
                             warmup=hp.warmup, total=hp.total_steps)
        params, opt_state, gnorm = adamw.update(
            grads, opt_state, params, lr=lr, weight_decay=hp.weight_decay,
            max_norm=hp.max_grad_norm)
        for p in plist:
            p.grad = None
        return params, opt_state, {"loss": loss_sum / n_micro,
                                   "grad_norm": gnorm, "lr": lr}

    return train_step


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
