"""Sharded checkpoint save/restore riding the LCAP stream: the port of
``repro/checkpoint/ckpt.py``, whose files it reads and writes.

Save: the tree is flattened in JAX's order (dict keys sorted,
NamedTuple fields in order, list items in order) and each leaf named as
``jax.tree_util.keystr`` names it (``"['opt'].m['body']['slot0']..."``);
leaves are round-robined into ``n_shards`` .npz files, and
``step-XXXXXXXX.index.json`` lists the names.  Each completed shard
emits a CL_CKPT_WRITE record; the ``CheckpointCommitter`` group
publishes the manifest once every shard has been seen.  The npz shards
and the index are the reference's, byte for byte in layout, so either
package restores the other's checkpoints.  A trainer writes its state in
the reference's layout (``models.transformer.params_to_jax``).

Restore: read the index and the shards and rebuild the tree, either in
the structure of a donor tree or, without one, from the index's leaf
names; ``runtime.elastic.reshard_state`` then lands it on the device.

``AsyncCheckpointer`` copies the tree to the host on the caller's thread
(training updates the parameters in place) and serialises it off-thread
while the next step runs on the device.
"""

from __future__ import annotations

import json
import os
import re
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch


def _flatten(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """``(name, leaf)`` pairs in JAX's flattening order; None holds no
    leaf, as in JAX."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _flatten(tree[k], f"{prefix}[{k!r}]")]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [kv for f in tree._fields
                for kv in _flatten(getattr(tree, f), f"{prefix}.{f}")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree)
                for kv in _flatten(v, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def _unflatten(donor, leaves):
    """The structure of ``donor`` with its leaves taken from the iterator
    ``leaves``, in ``_flatten``'s order."""
    if donor is None:
        return None
    if isinstance(donor, dict):
        return {k: _unflatten(donor[k], leaves) for k in sorted(donor)}
    if isinstance(donor, tuple) and hasattr(donor, "_fields"):
        return type(donor)(*(_unflatten(getattr(donor, f), leaves)
                             for f in donor._fields))
    if isinstance(donor, (list, tuple)):
        return type(donor)(_unflatten(v, leaves) for v in donor)
    return next(leaves)


_KEY = re.compile(r"\['((?:[^'\\]|\\.)*)'\]|\[(\d+)\]|\.(\w+)")


def _from_names(names: List[str], arrays: List[np.ndarray]) -> Dict:
    """Nested dicts from ``keystr`` names: dict keys and NamedTuple
    fields become string keys, sequence positions integer keys."""
    root: Dict = {}
    for name, arr in zip(names, arrays):
        keys, pos = [], 0
        for m in _KEY.finditer(name):
            if m.start() != pos:
                raise ValueError(f"unparsable leaf name {name!r}")
            pos = m.end()
            s, i, attr = m.groups()
            keys.append(s if s is not None else
                        int(i) if i is not None else attr)
        if pos != len(name) or not keys:
            raise ValueError(f"unparsable leaf name {name!r}")
        node = root
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = arr
    return root


def _host(leaf) -> np.ndarray:
    """A leaf as a host numpy array (a tensor copied off its device;
    bf16, which numpy lacks, widened to fp32)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.to("cpu", copy=True).numpy()
    return np.asarray(leaf)


def _map(tree, fn):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(v, fn) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    return fn(tree)


def save_checkpoint(tree, step: int, out_dir: str, *, n_shards: int = 4,
                    tracker=None) -> List[str]:
    """Write ``n_shards`` npz files + a local index; emits CKPT_WRITE
    records when a tracker is given.  Returns the shard paths."""
    os.makedirs(out_dir, exist_ok=True)
    flat = _flatten(tree)
    paths = []
    for shard in range(n_shards):
        arrs = {str(i): _host(leaf)
                for i, (name, leaf) in enumerate(flat)
                if i % n_shards == shard}
        path = os.path.join(out_dir, f"step-{step:08d}-shard{shard}.npz")
        tmp = path + ".tmp.npz"
        np.savez(tmp, **arrs)
        os.replace(tmp, path)
        paths.append(path)
        if tracker is not None:
            tracker.ckpt_write(step, shard_id=shard,
                               nbytes=os.path.getsize(path), path=path,
                               total_shards=n_shards)
    index = {"step": step, "n_shards": n_shards,
             "leaves": [name for name, _ in flat]}
    with open(os.path.join(out_dir, f"step-{step:08d}.index.json"),
              "w") as fh:
        json.dump(index, fh)
    return paths


def latest_step(out_dir: str) -> Optional[int]:
    if not os.path.isdir(out_dir):
        return None
    steps = [int(f.split("-")[1].split(".")[0])
             for f in os.listdir(out_dir) if f.endswith(".index.json")]
    return max(steps) if steps else None


def restore_checkpoint(tree_like, step: int, out_dir: str):
    """Rebuild the checkpoint of ``step`` as host numpy arrays: in the
    structure of ``tree_like`` (a donor whose leaves are only placeholders;
    its leaf names must be the index's), or with ``tree_like=None`` as
    nested dicts built from the index's leaf names."""
    with open(os.path.join(out_dir, f"step-{step:08d}.index.json")) as fh:
        index = json.load(fh)
    n_shards = index["n_shards"]
    arrays: Dict[int, np.ndarray] = {}
    for shard in range(n_shards):
        path = os.path.join(out_dir, f"step-{step:08d}-shard{shard}.npz")
        with np.load(path) as z:
            for k in z.files:
                arrays[int(k)] = z[k]
    names = index["leaves"]
    if sorted(arrays) != list(range(len(names))):
        raise ValueError(f"step {step}: the shards hold leaves "
                         f"{sorted(arrays)[:4]}..., the index names "
                         f"{len(names)}")
    leaves = [arrays[i] for i in range(len(names))]
    if tree_like is None:
        return _from_names(names, leaves)
    donor = [name for name, _ in _flatten(tree_like)]
    if donor != names:
        raise ValueError(f"step {step}: the donor tree's leaves differ "
                         f"from the checkpoint's ({len(donor)} against "
                         f"{len(names)})")
    return _unflatten(tree_like, iter(leaves))


class AsyncCheckpointer:
    """Background checkpoint writer: snapshot on the caller thread
    (host copies), serialize+write off-thread."""

    def __init__(self, out_dir: str, n_shards: int = 4, tracker=None):
        self.out_dir = out_dir
        self.n_shards = n_shards
        self.tracker = tracker
        self._pool = ThreadPoolExecutor(max_workers=1)
        self._last: Optional[Future] = None

    def submit(self, tree, step: int) -> Future:
        host_tree = _map(tree, _host)
        self.wait()
        self._last = self._pool.submit(
            save_checkpoint, host_tree, step, self.out_dir,
            n_shards=self.n_shards, tracker=self.tracker)
        return self._last

    def wait(self) -> None:
        if self._last is not None:
            self._last.result()
            self._last = None

    def close(self) -> None:
        self.wait()
        self._pool.shutdown()
