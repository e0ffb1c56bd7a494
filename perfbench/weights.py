"""Weights made from the seed on the device, in the port's parameter
layout, handed the same to the program and to the reference.

Every drawn leaf comes out of one bf16 buffer filled by a few large
``normal_`` calls from one ``torch.Generator`` on the card; each leaf is
a view of it scaled by its init std.  The leaves whose std is 0 take the
layout's fixed values (0, but ``A_log = log(1..8)`` and ``skip_D = 1``),
in float32 where the port holds them in float32.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import torch

#: elements a ``normal_`` call fills at most
CHUNK = 1 << 30


def _leaves(layout, path=()) -> List[Tuple[tuple, tuple, float]]:
    if isinstance(layout, dict):
        return [x for k, v in layout.items() for x in _leaves(v, path + (k,))]
    if isinstance(layout, list):
        return [x for i, v in enumerate(layout)
                for x in _leaves(v, path + (i,))]
    shape, _axes, std = layout
    return [(path, tuple(shape), float(std))]


def _put(tree: Dict, path: tuple, value) -> None:
    node = tree
    for key, nxt in zip(path[:-1], path[1:]):
        if isinstance(node, list):
            while len(node) <= key:
                node.append([] if isinstance(nxt, int) else {})
            node = node[key]
        else:
            node = node.setdefault(key, [] if isinstance(nxt, int) else {})
    if isinstance(node, list):
        while len(node) <= path[-1]:
            node.append(None)
    node[path[-1]] = value


def make(layout, seed: int, device, is_fp32: Callable[[tuple], bool],
         dtype: torch.dtype = torch.bfloat16) -> Dict:
    """The parameter tree of ``layout`` (the port's nested dict and
    per-layer list of ``(shape, axes, std)``) drawn from ``seed``."""
    leaves = _leaves(layout)
    drawn = [(path, shape, std) for path, shape, std in leaves if std]
    total = sum(torch.Size(shape).numel() for _, shape, _ in drawn)
    gen = torch.Generator(device=device).manual_seed(seed % (1 << 63))
    buf = torch.empty(total, dtype=dtype, device=device)
    for lo in range(0, total, CHUNK):
        buf[lo:lo + CHUNK].normal_(generator=gen)
    tree: Dict = {}
    at = 0
    for path, shape, std in drawn:
        n = torch.Size(shape).numel()
        _put(tree, path, buf[at:at + n].view(shape).mul_(std))
        at += n
    for path, shape, std in leaves:
        if std:
            continue
        dt = torch.float32 if is_fp32(path) else dtype
        if path[-1] == "A_log":
            value = torch.log(torch.linspace(1.0, 8.0, shape[-1],
                                             device=device)).to(dt)
        elif path[-1] == "skip_D":
            value = torch.ones(shape, dtype=dt, device=device)
        else:
            value = torch.zeros(shape, dtype=dt, device=device)
        _put(tree, path, value)
    return tree
