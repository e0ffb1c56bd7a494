"""The four-rank cases of tests/test_torch_compress.py, on gloo ranks of
a 2x2 ``(data, model)`` mesh (one spawn; ``torch_ranks``):

- ``psum``: 8 steps of ``compressed_psum`` over the four ranks, rank r
  holding row r of ``inputs.npz``'s (4, 64) gradients, with error
  feedback; each step's mean and every rank's error buffer;
- ``restore``: the reference checkpoint under ``<workdir>/ckpt``
  (step 5) landed on the mesh by ``reshard_state``: whether every leaf is
  a DTensor placed by its logical axes, the largest difference of the
  gathered tensors from the checkpoint, and the gathered state saved
  again by rank 0 (``<workdir>/port_ckpt``, step 6) for a byte
  comparison;
- ``trainer``: granite-8b smoke trained 2 steps by a ``Trainer`` on the
  mesh (each rank its own work directory), checkpointing at step 2, and
  by one on the one-device record: the losses, whether the parameters are
  DTensors, which ranks wrote a checkpoint, and how far rank 0's
  checkpoint is from the sharded trainer's whole state.

    python tests/torch_ranks_compress.py <workdir>
"""

from __future__ import annotations

import os
import sys

import numpy as np

import torch_ranks

ARCH = "granite-8b"


def psum_case(rank, inputs) -> dict:
    import torch
    import torch.distributed as dist
    from repro_torch.optim import compress
    g = {"g": torch.from_numpy(inputs["grads"][rank])}
    err = {"g": torch.zeros(64)}
    means, errs = [], []
    for _ in range(8):
        mean, err = compress.compressed_psum(g, err)
        means.append(mean["g"].tolist())
        errs.append(err["g"].tolist())
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, errs)
    return {"means": means, "errs": every,
            "payload_bytes": compress.payload_bytes(g)}


def restore_case(rank, mesh, workdir) -> dict:
    from repro_torch import configs as C
    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw
    from repro_torch.runtime import sharding as SH, specs as SP
    from repro_torch.runtime.elastic import reshard_state
    cfg = C.get_smoke(ARCH)
    ck = os.path.join(workdir, "ckpt")
    names = restore_checkpoint(None, 5, ck)
    o = names["opt"]
    params, opt, rules = reshard_state(
        cfg, names["params"], adamw.AdamWState(o["step"], o["m"], o["v"]),
        mesh)
    placed = []
    for tree in (params, opt.m, opt.v):
        SP.map_axes(lambda axes, t: placed.append(
            SH.is_dtensor(t) and list(t.placements) ==
            rules.placements(axes)), T.param_axes(cfg), tree)
    back = {"params": T.params_to_jax(params, cfg),
            "opt": adamw.AdamWState(np.int32(opt.step),
                                    T.params_to_jax(opt.m, cfg),
                                    T.params_to_jax(opt.v, cfg))}
    want = dict(torch_ranks.flatten({"params": names["params"],
                                     "m": o["m"], "v": o["v"]}))
    got = dict(torch_ranks.flatten({"params": back["params"],
                                    "m": back["opt"].m,
                                    "v": back["opt"].v}))
    diff = max(float(np.abs(got[k] - want[k]).max()) for k in want)
    if rank == 0:
        save_checkpoint(back, 6, os.path.join(workdir, "port_ckpt"),
                        n_shards=3)
    return {"placed": all(placed), "leaves": len(placed),
            "same_names": sorted(got) == sorted(want), "max_diff": diff,
            "step": int(opt.step), "rules": rules is not None}


def trainer_case(rank, mesh, workdir) -> dict:
    import torch
    import torch.distributed as dist
    from repro_torch import configs as C
    from repro_torch.checkpoint import latest_step, restore_checkpoint
    from repro_torch.optim import adamw
    from repro_torch.runtime import sharding as SH
    from repro_torch.runtime.elastic import ElasticMesh
    from repro_torch.runtime.steps import TrainHParams
    from repro_torch.runtime.train_loop import Trainer
    cfg = C.get_smoke(ARCH)
    hp = TrainHParams(n_micro=1, attn_impl="naive", remat=False)
    kw = dict(hp=hp, global_batch=4, seq_len=16, n_hosts=2, ckpt_every=2,
              seed=0, device="cpu")
    # without a mesh a trainer in a process group would take one over all
    # its ranks, as the reference's takes every device: the one-device
    # record keeps this one unsharded
    one = ElasticMesh(shape=(1, 1), axis_names=("data", "model"),
                      device=torch.device("cpu"))
    out, held = {}, {}
    for name, mesh_ in (("sharded", mesh), ("plain", one)):
        wd = os.path.join(workdir, f"{name}{rank}")
        trainer = Trainer(cfg, workdir=wd, mesh=mesh_, **kw)
        out[name] = [h["loss"] for h in trainer.run(2)]
        out[f"{name}_dtensors"] = all(SH.is_dtensor(t) for t in
                                      adamw.leaves(trainer.params))
        # the whole state as the trainer holds it (gathered: a collective)
        tree = trainer.checkpoint_tree()
        held[name] = torch_ranks.flatten({"params": tree["params"],
                                          "opt": tree["opt"]._asdict()})
        trainer.close()
    wrote = [None] * dist.get_world_size()
    dist.all_gather_object(wrote, latest_step(
        os.path.join(workdir, f"sharded{rank}", "ckpt")))
    out["checkpoint_steps"] = wrote
    if rank == 0:
        a, b = (torch_ranks.flatten(restore_checkpoint(
            None, 2, os.path.join(workdir, f"{name}0", "ckpt")))
            for name in ("sharded", "plain"))
        out["same_names"] = sorted(a) == sorted(b) == sorted(
            held["sharded"])
        # rank 0's checkpoint against the sharded trainer's whole state
        out["checkpoint_vs_held"] = max(
            float(np.abs(a[k] - held["sharded"][k]).max()) for k in a)
    return out


def cases(rank, mesh, inputs, workdir) -> dict:
    return {"psum": psum_case(rank, inputs),
            "restore": restore_case(rank, mesh, workdir),
            "trainer": trainer_case(rank, mesh, workdir)}


if __name__ == "__main__":
    torch_ranks.rank_main(cases, sys.argv[1])
