"""Elastic scaling: mesh (re)planning + checkpoint resharding, the port
of ``repro/runtime/elastic.py``.

Membership comes from ELASTIC_JOIN/LEAVE changelog records (the
``ElasticController`` consumer).  On a generation change the runtime
drains in-flight steps, checkpoints, rebuilds the mesh from the
surviving ranks, restores the (mesh-agnostic) checkpoint onto it and
resumes from the DATA_CONSUME watermark.

``make_elastic_mesh`` gives a ``DeviceMesh`` of ``plan_mesh_shape(n)``
over the ranks of the default process group, named ``("data",
"model")``.  Without a process group it gives the one-device record
``ElasticMesh`` (n must be 1), under which no rules apply, as outside a
rules context in the reference.  Checkpoints are mesh-agnostic
(unsharded numpy per leaf), so resharding is distributing each leaf by
its logical axes (``reshard_state``), which returns the rules as the
reference's does.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from ..models import transformer as T
from ..optim import adamw
from .sharding import LogicalRules
from .specs import place


def plan_mesh_shape(n_devices: int) -> Tuple[int, int]:
    """Largest usable power-of-two (data, model) grid <= n_devices."""
    usable = 1 << int(math.log2(max(n_devices, 1)))
    data = 1 << (int(math.log2(usable)) // 2)
    return data, usable // data


@dataclass(frozen=True)
class ElasticMesh:
    """A one-device mesh with no process group: its ``(data, model)``
    shape and the device."""

    shape: Tuple[int, int]
    axis_names: Tuple[str, str]
    device: torch.device


def mesh_device(mesh) -> torch.device:
    """The device this rank computes on: an ``ElasticMesh``'s, or the
    current device of a ``DeviceMesh``'s type."""
    if isinstance(mesh, ElasticMesh):
        return mesh.device
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def make_elastic_mesh(n_devices: Optional[int] = None, device=None):
    """The ``(data, model)`` mesh of ``plan_mesh_shape(n)`` over the first
    ranks of the default process group (``None`` means all of them), on
    the card unless the caller passes ``device="cpu"``; raises without a
    card.  Without a process group, the one-device ``ElasticMesh``."""
    import torch.distributed as dist
    dev = T.resolve_device(device)
    if not dist.is_initialized():
        n = 1 if n_devices is None else n_devices
        if n != 1:
            raise RuntimeError(
                f"a mesh of {n} devices needs a process group of {n} ranks "
                "(torch.distributed.init_process_group); none is initialised")
        return ElasticMesh(shape=plan_mesh_shape(n),
                           axis_names=("data", "model"), device=dev)
    world = dist.get_world_size()
    data, model = plan_mesh_shape(world if n_devices is None else n_devices)
    if data * model > world:
        raise ValueError(f"a ({data}, {model}) mesh needs {data * model} "
                         f"ranks; the process group has {world}")
    from torch.distributed.device_mesh import DeviceMesh
    if dev.type == "cuda":
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    grid = torch.arange(data * model).reshape(data, model)
    return DeviceMesh(dev.type, grid, mesh_dim_names=("data", "model"))


def reshard_state(cfg, params, opt_state, mesh,
                  overrides: Optional[Dict] = None):
    """Land host state in the reference's layout (a restored checkpoint:
    numpy parameters, and an ``AdamWState`` of numpy moments or None) as
    the port's per-layer fp32 trees: on a ``DeviceMesh``, distributed by
    the logical rules leaf by leaf; on an ``ElasticMesh``, on its device
    with no rules.  Returns ``(params, opt_state, rules)``."""
    dev = mesh_device(mesh)
    rules = None if isinstance(mesh, ElasticMesh) else \
        LogicalRules(mesh, overrides)

    def land(tree):
        tree = T.params_from_jax(tree, device=dev, dtype=torch.float32)
        return tree if rules is None else place(rules, tree,
                                                T.param_axes(cfg))

    params = land(params)
    if opt_state is not None:
        opt_state = adamw.AdamWState(step=int(opt_state.step),
                                     m=land(opt_state.m),
                                     v=land(opt_state.v))
    return params, opt_state, rules
