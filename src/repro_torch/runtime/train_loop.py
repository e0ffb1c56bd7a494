"""End-to-end training with LCAP activity tracking: the port of
``repro/runtime/train_loop.py``.

Wires together the sharded data pipeline, the training step, one
``ActivityTracker`` producer per (simulated) host, the LCAP proxy and
the consumer groups (metrics DB, checkpoint committer, straggler
detector).  This is the host-side program each node runs.  Parameters
are fp32 master weights on the trainer's device, the card unless the
caller passes ``device="cpu"``.  Given a ``DeviceMesh``, the trainer
builds ``LogicalRules`` over it, places parameters and moments by their
logical axes and runs each step under the rules, as the reference's
does.  Checkpoints are written in the reference's layout (whole tensors,
gathered on every rank and written by rank 0), so either package
resumes the other's run.
"""

from __future__ import annotations

import os
import time
from typing import Dict, List

import numpy as np
import torch
import torch.distributed as dist

from ..checkpoint import AsyncCheckpointer, latest_step, restore_checkpoint
from ..core.proxy import LcapProxy
from ..data import ShardedTokenPipeline
from ..models import transformer as T
from ..optim import adamw
from ..track import (ActivityTracker, CheckpointCommitter, MetricsDB,
                     StragglerDetector)
from .elastic import ElasticMesh, make_elastic_mesh, mesh_device, reshard_state
from .sharding import LogicalRules, use_rules
from .specs import place
from .steps import TrainHParams, build_train_step


class Trainer:
    def __init__(self, cfg, *, workdir: str, mesh=None, hp: TrainHParams = None,
                 global_batch: int = 8, seq_len: int = 32, n_hosts: int = 2,
                 ckpt_every: int = 10, n_metrics_workers: int = 2,
                 seed: int = 0, device=None):
        self.cfg = cfg
        self.workdir = workdir
        os.makedirs(workdir, exist_ok=True)
        self.mesh = mesh or make_elastic_mesh(device=device)
        self.device = mesh_device(self.mesh)
        self.rules = None if isinstance(self.mesh, ElasticMesh) else \
            LogicalRules(self.mesh)
        self.hp = hp or TrainHParams(n_micro=1, attn_impl="naive",
                                     remat=False)
        self.global_batch = global_batch
        self.seq_len = seq_len
        self.ckpt_every = ckpt_every

        # --- LCAP backbone: one producer per (simulated) host ------------
        self.trackers = [
            ActivityTracker(run_id=1, host_id=h, jobid=f"{cfg.arch_id}",
                            shard=(0, h, 0, 0),
                            path=os.path.join(workdir, f"host{h}.llog"))
            for h in range(n_hosts)]
        self.proxy = LcapProxy({t.llog.producer_id: t.llog
                                for t in self.trackers})
        self.metrics = [MetricsDB(self.proxy,
                                  os.path.join(workdir, "metrics.sqlite"))
                        for _ in range(n_metrics_workers)]
        self.committer = CheckpointCommitter(
            self.proxy, os.path.join(workdir, "manifests"))
        self.straggler = StragglerDetector(self.proxy)
        self.ckpt = AsyncCheckpointer(os.path.join(workdir, "ckpt"),
                                      n_shards=n_hosts,
                                      tracker=self.trackers[0])

        # --- data ----------------------------------------------------------
        self.pipes = [ShardedTokenPipeline(
            cfg.vocab_size, seq_len, global_batch, n_hosts, h, seed=seed,
            tracker=t) for h, t in enumerate(self.trackers)]

        # --- model/optimizer state ------------------------------------------
        self.step = 0
        if not self._maybe_restore():
            self.params = T.init_params(cfg, seed=seed, device=self.device,
                                        dtype=torch.float32)
            if self.rules is not None:
                self.params = place(self.rules, self.params,
                                    T.param_axes(cfg))
            self.opt_state = adamw.init(self.params)

        self.train_step = build_train_step(cfg, self.hp)
        self.history: List[Dict[str, float]] = []

    # ------------------------------------------------------------------ io
    def _maybe_restore(self) -> bool:
        """Resume from the newest checkpoint in the workdir, if any."""
        ck_dir = os.path.join(self.workdir, "ckpt")
        last = latest_step(ck_dir)
        if last is None:
            return False
        restored = restore_checkpoint(None, last, ck_dir)
        opt = restored["opt"]
        self.params, self.opt_state, _ = reshard_state(
            self.cfg, restored["params"],
            adamw.AdamWState(opt["step"], opt["m"], opt["v"]), self.mesh)
        self.step = last
        for p in self.pipes:
            p.seek(last)
        return True

    def checkpoint_tree(self) -> Dict:
        """The trainer's state as host numpy arrays in the reference's
        checkpoint layout: ``{"params", "opt": AdamWState}``."""
        opt = self.opt_state
        return {"params": T.params_to_jax(self.params, self.cfg),
                "opt": adamw.AdamWState(
                    step=np.int32(opt.step),
                    m=T.params_to_jax(opt.m, self.cfg),
                    v=T.params_to_jax(opt.v, self.cfg))}

    # ---------------------------------------------------------------- loop
    def pump_consumers(self) -> None:
        self.proxy.pump()
        for w in self.metrics:
            w.poll()
        self.committer.poll()
        self.straggler.poll()
        self.proxy.flush_upstream()

    def run(self, n_steps: int) -> List[Dict[str, float]]:
        """``n_steps`` training steps, each timed to the end of its device
        work (a synchronise), committed, checkpointed every
        ``ckpt_every`` steps (by rank 0 of a mesh), and followed by one
        pump of the consumers."""
        with use_rules(self.rules):
            for _ in range(n_steps):
                t0 = time.time()
                shards = [next(p) for p in self.pipes]
                batch = {k: np.concatenate([s[k] for s in shards])
                         for k in shards[0]}
                self.params, self.opt_state, metrics = self.train_step(
                    self.params, self.opt_state, batch)
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                dt = time.time() - t0
                loss = float(metrics["loss"])
                self.step += 1
                for t in self.trackers:
                    t.step_commit(self.step, loss, dt,
                                  self.global_batch * self.seq_len)
                    t.heartbeat(self.step, dt)
                if self.step % self.ckpt_every == 0:
                    tree = self.checkpoint_tree()   # a collective on a mesh
                    if self.rules is None or dist.get_rank() == 0:
                        self.ckpt.submit(tree, self.step)
                self.pump_consumers()
                self.history.append({"step": self.step, "loss": loss,
                                     "time": dt})
            return self.history

    def close(self) -> None:
        self.ckpt.close()
        for w in self.metrics:
            w.close()
