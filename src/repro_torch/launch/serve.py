"""Serving launcher: batched prefill + decode with a KV cache, plus the
Ganesha-style cache-invalidation loop over LCAP (paper §IV-C-1).  The
port of ``repro/launch/serve.py``.

Replicas prefill prompts into a KV/page cache keyed by (prompt-id,
version).  When a prompt's backing object changes (simulated admin
write), the owning replica emits CL_EVICT; every other replica is an
EPHEMERAL changelog reader and drops its stale entry — the paper's
loose metadata-cache invalidation.

The prefill's attention runs through the hand-written CUDA kernel
(``attn_impl="flash"``); the reference's launcher prefills with
``"naive"``.  Decode attention is plain PyTorch, as in the reference.
Every family serves here: MoE layers attend as dense ones do, an
attention-free model (mamba2) launches no kernel, a VLM (pixtral) takes
seeded random image-patch embeddings for its first positions, and an
encoder-decoder (whisper) seeded random frame embeddings for its encoder,
whose bidirectional attention launches the kernel with no causal mask.
Runs on the card unless ``--device cpu`` is given; weights are random,
from a seeded ``torch.Generator``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-8b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-moe-30b-a3b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-small
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch


def make_batch(cfg, batch: int, prompt_len: int, seed: int = 0,
               device=None) -> Dict[str, torch.Tensor]:
    """The launcher's inputs, drawn as the reference's launcher draws
    them from one ``np.random.RandomState(seed)``: token ids
    (``"tokens"``), then for an encoder-decoder float32 normal frame
    embeddings (``"frames"``, (batch, n_frames, d_model)), then for a VLM
    float32 normal image-patch embeddings (``"image_embeds"``, (batch,
    n_image_patches, d_model)); on the card unless ``device`` asks for
    the CPU (``models.transformer.resolve_device``)."""
    from ..models.transformer import resolve_device
    dev = resolve_device(device)
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, cfg.vocab_size, (batch, prompt_len))
    out = {"tokens": torch.from_numpy(ids.astype(np.int64)).to(dev)}

    def normal(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dev)

    if cfg.is_encoder_decoder:
        out["frames"] = normal(batch, cfg.n_frames, cfg.d_model)
    if cfg.n_image_patches:
        out["image_embeds"] = normal(batch, cfg.n_image_patches, cfg.d_model)
    return out


def make_tokens(cfg, batch: int, prompt_len: int, seed: int = 0,
                device=None) -> torch.Tensor:
    """``make_batch``'s token ids alone."""
    return make_batch(cfg, batch, prompt_len, seed, device)["tokens"]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve(cfg, params, tokens: torch.Tensor, *,
          extras: Optional[Dict[str, torch.Tensor]] = None, gen_len: int,
          replicas: int = 2) -> Dict:
    """Prefill ``tokens`` (B, P) with ``extras`` (``frames`` and
    ``image_embeds``, as ``make_batch`` gives them), decode greedily to
    ``gen_len`` tokens
    (the prefill's and ``gen_len - 1`` decode steps), then run the
    cache-invalidation loop over ``replicas`` page caches.  Under a
    rules context with placed parameters the model runs sharded and the
    logits are gathered whole for the greedy choice.  Returns the
    generated tokens, the prefill's last-position logits, host seconds
    of the prefill and of the decode steps (each ending in a device
    synchronise), and the invalidation counts."""
    from ..core.proxy import LcapProxy
    from ..runtime.sharding import full
    from ..runtime.steps import build_decode_step, build_prefill_step
    from ..track import ActivityTracker, CacheInvalidator

    B, P = tokens.shape
    G = gen_len
    device = tokens.device
    prefill = build_prefill_step(cfg, max_seq=P + G, attn_impl="flash")
    decode = build_decode_step(cfg)

    with torch.inference_mode():
        _sync(device)
        t0 = time.perf_counter()
        logits, cache = prefill(params, {"tokens": tokens, **(extras or {})})
        logits = full(logits)
        out_tokens = [torch.argmax(logits, -1)]
        _sync(device)
        t1 = time.perf_counter()
        for i in range(G - 1):
            pos = torch.full((B,), P + i, dtype=torch.int32, device=device)
            step_logits, cache = decode(params, cache, out_tokens[-1][:, None],
                                        pos)
            out_tokens.append(torch.argmax(full(step_logits), -1))
        gen = torch.stack(out_tokens, 1)
        _sync(device)
        t2 = time.perf_counter()

    # --- LCAP cache invalidation across replicas (paper §IV-C-1) ---------
    owner = ActivityTracker(run_id=1, host_id=0, jobid="serve-owner")
    proxy = LcapProxy({"host0": owner.llog})
    page_caches = [{(pid, 1): f"kv-page-{pid}" for pid in range(B)}
                   for _ in range(replicas)]
    invalidators = [CacheInvalidator(proxy, pc) for pc in page_caches]
    owner.evict(2, 1, reason="prompt-updated")      # object 2 changed
    proxy.pump()
    for inv in invalidators:
        inv.poll()

    return {"generated": gen, "prefill_logits": logits,
            "prefill_s": t1 - t0, "decode_s": t2 - t1, "decode_steps": G - 1,
            "evicted_per_replica": [inv.invalidated for inv in invalidators],
            "remaining_pages": [len(pc) for pc in page_caches]}


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-8b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--gen-len", type=int, default=8)
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; fails without a card) or cpu")
    args = ap.parse_args(argv)

    from .. import configs as C
    from ..models import transformer as T

    device = T.resolve_device(args.device)
    cfg = C.get_smoke(args.arch) if args.smoke else C.get_config(args.arch)
    params = T.init_params(cfg, seed=0, device=device)
    batch = make_batch(cfg, args.batch, args.prompt_len, seed=0,
                       device=device)
    tokens = batch.pop("tokens")
    out = serve(cfg, params, tokens, extras=batch, gen_len=args.gen_len,
                replicas=args.replicas)
    gen = out["generated"]

    print(json.dumps({
        "arch": cfg.arch_id,
        "generated_shape": list(gen.shape),
        "generated_finite": bool((gen >= 0).all()),
        "evicted_per_replica": out["evicted_per_replica"],
        "remaining_pages": out["remaining_pages"],
    }, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
