"""The sharded cases of tests/test_torch_sharding.py, on four gloo ranks
of a 2x2 ``(data, model)`` mesh (one spawn; ``torch_ranks``):

- ``loss``: granite-8b smoke's loss on the reference's inputs, the
  weights from ``inputs.npz`` (the reference's layout), unsharded and
  under ``cell_rules`` on the mesh;
- ``train``: one qwen2.5-14b smoke training step (``n_micro=2``,
  blockwise attention) unsharded and sharded: metrics, and whether the
  parameters stay DTensors with their axes' placements;
- ``gqa``: a flash-impl prefill (the plain version on the CPU) and two
  decode steps in float32, for head counts whose local q heads do not
  cover whole kv groups, unsharded and sharded;
- ``families``: the MoE, SSD, hybrid, VLM and encoder-decoder smoke
  models in float32, weights and inputs from ``inputs.npz``: the loss, a
  prefill and two decode steps, unsharded and sharded, with the experts
  each MoE call chose (``top_e``) in both runs;
- ``ce``: the vocab-parallel cross entropy of granite-8b's smoke model
  (untied unembedding) and gemma2-9b's (tied, scaled embeddings and a
  logit softcap) in float32, unsharded and sharded: the loss, its
  gradient with respect to the logits and to the unembedding table.

    python tests/torch_ranks_sharding.py <workdir>
"""

from __future__ import annotations

import math
import sys

import torch_ranks


def _max_diff(a, b) -> float:
    from repro_torch.runtime.sharding import full
    return float((full(a).float() - b.float()).abs().max())


def loss_case(mesh, inputs) -> dict:
    import torch
    from repro_torch import configs as C
    from repro_torch.models import transformer as T
    from repro_torch.models.config import ShapeConfig
    from repro_torch.runtime import sharding as SH, specs as SP
    cfg = C.get_smoke("granite-8b")
    params = T.params_from_jax(torch_ranks.unflatten(inputs, "granite/"),
                               device="cpu")
    tokens = torch.from_numpy(inputs["granite_tokens"])
    labels = torch.roll(tokens, -1, 1)
    with torch.no_grad():
        plain = float(T.loss_fn(params, cfg, tokens, labels)[0])
        rules = SP.cell_rules(cfg, ShapeConfig("t", 16, 4, "train"), mesh)
        placed = SP.place(rules, params, T.param_axes(cfg))
        with SH.use_rules(rules):
            sharded = float(SH.full(T.loss_fn(placed, cfg, tokens,
                                              labels)[0]))
    return {"plain": plain, "sharded": sharded}


def train_case(mesh, inputs) -> dict:
    import torch
    from repro_torch import configs as C
    from repro_torch.models import transformer as T
    from repro_torch.models.config import ShapeConfig
    from repro_torch.optim import adamw
    from repro_torch.runtime import sharding as SH, specs as SP
    from repro_torch.runtime.steps import TrainHParams, build_train_step
    cfg = C.get_smoke("qwen2.5-14b")
    step = build_train_step(cfg, TrainHParams(n_micro=2,
                                              attn_impl="blockwise"))
    batch = {"tokens": inputs["qwen_tokens"], "labels": inputs["qwen_labels"]}

    def weights():
        return T.params_from_jax(torch_ranks.unflatten(inputs, "qwen/"),
                                 device="cpu", dtype=torch.float32)

    params = weights()
    _, _, plain = step(params, adamw.init(params), batch)
    rules = SP.cell_rules(cfg, ShapeConfig("t", 16, 4, "train"), mesh)
    params = SP.place(rules, weights(), T.param_axes(cfg))
    with SH.use_rules(rules):
        params, opt, sharded = step(params, adamw.init(params), batch)
    placed = []
    SP.map_axes(lambda axes, p, m: placed.append(
        SH.is_dtensor(p) and SH.is_dtensor(m)
        and list(p.placements) == rules.placements(axes)
        and list(m.placements) == rules.placements(axes)),
        T.param_axes(cfg), params, opt.m)
    finite = all(math.isfinite(float(sharded[k]))
                 for k in ("loss", "grad_norm", "lr"))
    return {"plain": {k: float(v) for k, v in plain.items()},
            "sharded": {k: float(v) for k, v in sharded.items()},
            "finite": finite, "placed": all(placed),
            "leaves": len(placed)}


def gqa_case(mesh, inputs) -> dict:
    """Prefill (flash impl: the kernel's plain version on the CPU) and
    two decode steps in float32, unsharded and sharded, for (H, KV) =
    (12, 3) (rank r of tp 2 holds q heads 6r..6r+5, which read kv heads
    0,0,0,0,1,1 and 1,1,2,2,2,2: one kv head a q head) and (8, 2) (rank
    r's four q heads read kv head r: a slice).  The decode caches'
    slots are split over the model axis, so decode merges the ranks'
    softmax parts."""
    import torch
    from repro_torch.models import transformer as T
    from repro_torch.models.config import ModelConfig, ShapeConfig
    from repro_torch.runtime import sharding as SH, specs as SP
    out = {}
    T.COMPUTE_DTYPE = torch.float32
    for H, KV in ((12, 3), (8, 2)):
        cfg = ModelConfig(arch_id=f"gqa-{H}-{KV}", family="dense",
                          n_layers=2, d_model=64, n_heads=H, n_kv_heads=KV,
                          head_dim=16, d_ff=128, vocab_size=256)
        params = T.init_params(cfg, seed=H, device="cpu",
                               dtype=torch.float32)
        tokens = torch.from_numpy(inputs["gqa_tokens"])
        B, S = tokens.shape
        rules = SP.cell_rules(cfg, ShapeConfig("p", S, B, "prefill"), mesh)
        placed = SP.place(rules, params, T.param_axes(cfg))
        diffs = []
        with torch.no_grad():
            want, cache = T.prefill(params, cfg, tokens, max_seq=S + 4,
                                    impl="flash")
            with SH.use_rules(rules):
                got, dcache = T.prefill(placed, cfg, tokens, max_seq=S + 4,
                                        impl="flash")
            diffs.append(_max_diff(got, want))
            tok = torch.argmax(want, -1)[:, None]
            for i in range(2):
                pos = torch.full((B,), S + i, dtype=torch.int32)
                want, cache = T.decode_step(params, cfg, tok, cache, pos)
                with SH.use_rules(rules):
                    got, dcache = T.decode_step(placed, cfg, tok, dcache,
                                                pos)
                diffs.append(_max_diff(got, want))
                tok = torch.argmax(want[:, 0], -1)[:, None]
        out[f"{H}:{KV}"] = {
            "diffs": diffs,
            "cache_shard_dims": [p.dim if p.is_shard() else None
                                 for p in dcache[0]["k"].placements],
            "cache_diff": _max_diff(dcache[0]["k"], cache[0]["k"])}
    return out


#: the families' smoke models of the ``families`` case
FAMILIES = ("granite-moe-1b-a400m", "mamba2-780m", "jamba-v0.1-52b",
            "pixtral-12b", "whisper-small")


def family_run(cfg, params, inputs, arch, routes):
    """loss, prefill of all but the last token and two decode steps of
    ``inputs``' fixed tokens: whole tensors as lists, and the experts of
    every MoE call appended to ``routes``."""
    import torch
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    from repro_torch.runtime.sharding import full
    real = L.moe_route

    def route(*a, **k):
        r = real(*a, **k)
        routes.append(full(r.top_e).tolist())
        return r

    tokens = torch.from_numpy(inputs[f"{arch}:tokens"])
    extras = {k: torch.from_numpy(inputs[f"{arch}:{k}"])
              for k in ("frames", "image_embeds") if f"{arch}:{k}" in inputs}
    B, S = tokens.shape
    out = {}
    L.moe_route = route
    try:
        with torch.no_grad():
            out["loss"] = float(full(T.loss_fn(
                params, cfg, tokens, torch.roll(tokens, -1, 1),
                **extras)[1][0]))
            last, cache = T.prefill(params, cfg, tokens[:, :-1],
                                    max_seq=S + 2, **extras)
            out["prefill"] = full(last).tolist()
            for i, tok in enumerate(inputs[f"{arch}:decode"]):
                pos = torch.full((B,), S - 1 + i, dtype=torch.int32)
                logits, cache = T.decode_step(params, cfg,
                                              torch.from_numpy(tok), cache,
                                              pos)
                out[f"decode {i}"] = full(logits[:, 0]).tolist()
    finally:
        L.moe_route = real
    return out


def families_case(mesh, inputs) -> dict:
    import torch
    from repro_torch import configs as C
    from repro_torch.models import transformer as T
    from repro_torch.models.config import ShapeConfig
    from repro_torch.runtime import sharding as SH, specs as SP
    T.COMPUTE_DTYPE = torch.float32
    out = {}
    for arch in FAMILIES:
        cfg = C.get_smoke(arch)
        params = T.params_from_jax(torch_ranks.unflatten(inputs, f"{arch}/"),
                                   device="cpu", dtype=torch.float32)
        B, S = inputs[f"{arch}:tokens"].shape
        rules = SP.cell_rules(cfg, ShapeConfig("t", S, B, "train"), mesh)
        placed = SP.place(rules, params, T.param_axes(cfg))
        routes = {"plain": [], "sharded": []}
        plain = family_run(cfg, params, inputs, arch, routes["plain"])
        with SH.use_rules(rules):
            sharded = family_run(cfg, placed, inputs, arch,
                                 routes["sharded"])
        out[arch] = {"plain": plain, "sharded": sharded, "routes": routes}
    return out


#: the ``ce`` case's models, by their prefix in ``inputs.npz``, and the
#: leaf each unembeds with
CE_ARCHS = {"granite": ("granite-8b", "unembed"),
            "gemma": ("gemma2-9b", "embed")}


def ce_run(cfg, params, tokens, labels, table) -> dict:
    """The loss of ``tokens``, its gradient with respect to the logits
    (a leaf made of them) and to ``params[table]``, whole tensors as
    lists, and whether the logits were split over the vocabulary."""
    import torch
    from repro_torch.models import transformer as T
    from repro_torch.runtime.sharding import full, is_dtensor
    logits, _ = T.forward(params, cfg, tokens)
    leaf = logits.detach().requires_grad_()
    torch.mean(T.token_losses(leaf, labels)).backward()
    params[table].requires_grad_()
    _, (loss, _) = T.loss_fn(params, cfg, tokens, labels)
    loss.backward()
    split = is_dtensor(logits) and any(
        p.is_shard(logits.ndim - 1) for p in logits.placements)
    return {"loss": float(full(loss)), "vocab_split": split,
            "logits_grad": full(leaf.grad).tolist(),
            "table_grad": full(params[table].grad).tolist()}


def ce_case(mesh, inputs) -> dict:
    import torch
    from repro_torch import configs as C
    from repro_torch.models import transformer as T
    from repro_torch.models.config import ShapeConfig
    from repro_torch.runtime import sharding as SH, specs as SP
    T.COMPUTE_DTYPE = torch.float32
    out = {}
    for key, (arch, table) in CE_ARCHS.items():
        cfg = C.get_smoke(arch)
        tokens = torch.from_numpy(inputs[f"{key}_tokens"]).long()
        labels = torch.roll(tokens, -1, 1)

        def weights():
            return T.params_from_jax(torch_ranks.unflatten(inputs, f"{key}/"),
                                     device="cpu", dtype=torch.float32)

        plain = ce_run(cfg, weights(), tokens, labels, table)
        B, S = tokens.shape
        rules = SP.cell_rules(cfg, ShapeConfig("t", S, B, "train"), mesh)
        placed = SP.place(rules, weights(), T.param_axes(cfg))
        with SH.use_rules(rules):
            sharded = ce_run(cfg, placed, tokens, labels, table)
        out[key] = {"plain": plain, "sharded": sharded}
    return out


def cases(rank, mesh, inputs, workdir) -> dict:
    return {"loss": loss_case(mesh, inputs),
            "train": train_case(mesh, inputs),
            "gqa": gqa_case(mesh, inputs),
            "families": families_case(mesh, inputs),
            "ce": ce_case(mesh, inputs)}


if __name__ == "__main__":
    torch_ranks.rank_main(cases, sys.argv[1])
