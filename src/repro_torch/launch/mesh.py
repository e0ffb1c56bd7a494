"""Production mesh definitions: the port of ``repro/launch/mesh.py``.

``make_production_mesh`` and ``make_host_mesh`` are FUNCTIONS (never
module-level state) over ``init_device_mesh``, so importing this module
touches no process group and no device.  The production shapes are the
reference's, ``(16, 16)`` and ``(2, 16, 16)``: they name the dry-run
cells.  Each needs a process group of that many ranks.

The hardware constants are the card's, not the reference's TPU v5e
figures: the roofline analysis of the port reads them.
"""

from __future__ import annotations


def make_production_mesh(*, multi_pod: bool = False, device: str = "cuda"):
    """The (data, model) mesh of 256 ranks, or (pod, data, model) of 512
    with ``multi_pod``, over the default process group's ranks of device
    type ``device``."""
    from torch.distributed.device_mesh import init_device_mesh
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device, shape, mesh_dim_names=axes)


def make_host_mesh(data: int = 1, model: int = 1, *, device: str = "cuda"):
    """A small (data, model) mesh over the default process group's ranks
    of device type ``device`` (``"cpu"`` for gloo ranks) — used by tests
    and the elastic runtime."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device, (data, model),
                            mesh_dim_names=("data", "model"))


# NVIDIA H100 80GB HBM3, 700 W (SXM): dense bf16 tensor-core peak, per
# card (NVIDIA H100 data sheet; the figure PERF.md's bounds use)
PEAK_FLOPS_BF16 = 989e12
# NVIDIA H100 80GB HBM3, 700 W (SXM): HBM3 bytes/s per card (data sheet)
HBM_BW = 3.35e12
# NVIDIA H100 80GB HBM3, 700 W (SXM): NVLink 4 bytes/s per card, one
# direction (the data sheet's 900 GB/s counts both; not measured: one
# card has no peer to measure it against)
NVLINK_BW = 450e9
# cards a host joins all to all by NVLink
CHIPS_PER_HOST = 8
# NVIDIA DGX H100: one ConnectX-7 400 Gb/s port a card between hosts,
# 50e9 bytes/s a direction per card (data sheet; not measured).  The
# dry run's collective term divides by it: every axis of either
# production mesh spans hosts (the 16-rank ``model`` axis two hosts of
# CHIPS_PER_HOST, ``data`` sixteen), and a ring over ranks of several
# hosts runs at the rate of the links between them
NETWORK_BW = 50e9
