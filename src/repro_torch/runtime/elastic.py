"""Elastic scaling on one device: the port of ``repro/runtime/elastic.py``.

Membership comes from ELASTIC_JOIN/LEAVE changelog records (the
``ElasticController`` consumer).  On a generation change the runtime
drains in-flight steps, checkpoints, rebuilds the mesh from the
surviving hosts, restores the (mesh-agnostic) checkpoint onto it and
resumes from the DATA_CONSUME watermark.

The port runs on one device.  ``plan_mesh_shape`` is the reference's;
``make_elastic_mesh`` gives a ``(1, 1)`` mesh record of that device and
raises for more (ROADMAP.md Queue 1, item 5).  The reference's logical
sharding rules (``LogicalRules``, ``use_rules``, ``shardings_of``) are
identity on one device and are not ported; ``reshard_state`` only lands
host state on the mesh's device and returns no rules.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from ..models import transformer as T
from ..optim import adamw


def plan_mesh_shape(n_devices: int) -> Tuple[int, int]:
    """Largest usable power-of-two (data, model) grid <= n_devices."""
    usable = 1 << int(math.log2(max(n_devices, 1)))
    data = 1 << (int(math.log2(usable)) // 2)
    return data, usable // data


@dataclass(frozen=True)
class ElasticMesh:
    """A one-device mesh: its ``(data, model)`` shape and the device."""

    shape: Tuple[int, int]
    axis_names: Tuple[str, str]
    device: torch.device


def make_elastic_mesh(n_devices: Optional[int] = None,
                      device=None) -> ElasticMesh:
    """The mesh of one device (``None`` means one): the card unless the
    caller passes ``device="cpu"``; raises without a card."""
    n = 1 if n_devices is None else n_devices
    if n != 1:
        raise NotImplementedError(
            f"a mesh of {n} devices: the port runs on one device "
            "(ROADMAP.md Queue 1, item 5)")
    return ElasticMesh(shape=plan_mesh_shape(n), axis_names=("data", "model"),
                       device=T.resolve_device(device))


def reshard_state(cfg, params, opt_state, mesh: ElasticMesh):
    """Land host state in the reference's layout (a restored checkpoint:
    numpy parameters, and an ``AdamWState`` of numpy moments or None) on
    the mesh's device as the port's per-layer fp32 trees.  Returns
    ``(params, opt_state)``."""
    def land(tree):
        return T.params_from_jax(tree, device=mesh.device,
                                 dtype=torch.float32)

    params = land(params)
    if opt_state is not None:
        opt_state = adamw.AdamWState(step=int(opt_state.step),
                                     m=land(opt_state.m),
                                     v=land(opt_state.v))
    return params, opt_state
