"""Four gloo ranks on the CPU for the port's sharded tests: what they
share.  ``launch(script, workdir)`` runs a rank script in its own process
session with a time limit of its own, so that a hung rank fails its test
instead of the whole run; ``rank_main`` starts one rank's process group
on a ``FileStore`` under the work directory (no TCP port, so parallel
test workers never collide) and runs the script's cases on a 2x2
``(data, model)`` mesh.  Rank 0 writes what the cases return to
``<workdir>/result.json``.

Imports only torch and the port: the tests' reference runs stay in the
pytest process, and the ranks read their inputs from ``inputs.npz``.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

WORLD = 4
#: seconds one spawn of four ranks may take
SPAWN_TIMEOUT_S = 300
ROOT = Path(__file__).resolve().parents[1]


def launch(script: str, workdir, timeout: float = SPAWN_TIMEOUT_S) -> dict:
    """Run ``python <script> <workdir>``; the ranks' result, with the
    spawn's seconds under ``"seconds"``.  Kills the whole process group
    at the time limit."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    t0 = time.time()
    proc = subprocess.Popen([sys.executable, str(Path(__file__).parent /
                                                 script), str(workdir)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True, env=env, cwd=str(ROOT),
                            start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
        raise AssertionError(f"{script}: ranks still running after "
                             f"{timeout} s:\n{out[-3000:]}")
    if proc.returncode != 0:
        raise AssertionError(f"{script}: exit {proc.returncode}:\n"
                             f"{out[-4000:]}")
    result = json.loads((Path(workdir) / "result.json").read_text())
    result["seconds"] = time.time() - t0
    result["log"] = out
    return result


def save_inputs(workdir, **arrays) -> None:
    np.savez(Path(workdir) / "inputs.npz", **arrays)


def flatten(tree, prefix=""):
    """A nested dict of arrays as ``{"a/b/c": array}``."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flatten(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree)}


def unflatten(flat: dict, prefix: str) -> dict:
    """The nested dict under ``prefix`` of a ``flatten``ed mapping."""
    out: dict = {}
    for key, a in flat.items():
        if not key.startswith(prefix):
            continue
        node = out
        *path, leaf = key[len(prefix):].split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = np.asarray(a)
    return out


def rank_main(cases, workdir: str) -> None:
    """Spawn ``WORLD`` ranks running ``cases(rank, mesh, inputs,
    workdir)``."""
    import torch.multiprocessing as mp
    mp.spawn(_rank, args=(cases, workdir), nprocs=WORLD, join=True)


def _rank(rank: int, cases, workdir: str) -> None:
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(workdir, "store"), WORLD)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=WORLD)
    try:
        from repro_torch.runtime.elastic import make_elastic_mesh
        mesh = make_elastic_mesh(device="cpu")
        assert tuple(mesh.shape) == (2, 2), mesh
        with np.load(os.path.join(workdir, "inputs.npz")) as f:
            inputs = dict(f)
        result = cases(rank, mesh, inputs, workdir)
        if rank == 0:
            Path(workdir, "result.json").write_text(json.dumps(result))
    finally:
        dist.destroy_process_group()
