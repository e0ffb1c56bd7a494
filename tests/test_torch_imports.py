"""The port stands alone: importing every ``repro_torch`` module pulls in
no JAX, nothing of the reference package, no ``msgpack`` (the card's
machine has none of them) and no ``triton``, and compiles or loads no
kernel."""

import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

SRC = Path(__file__).resolve().parents[1] / "src"


def port_modules() -> list:
    import repro_torch
    names = ["repro_torch"]
    for info in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
        names.append(info.name)
    return sorted(names)


def test_every_port_module_is_listed():
    names = port_modules()
    for want in ("repro_torch.core.records", "repro_torch.core.cluster",
                 "repro_torch.core.session", "repro_torch.kernels.stream_ops",
                 "repro_torch.core.msgpack_subset",
                 "repro_torch.kernels._build",
                 "repro_torch.kernels.flash_attention",
                 "repro_torch.kernels.ops", "repro_torch.models.config",
                 "repro_torch.models.layers",
                 "repro_torch.models.transformer", "repro_torch.configs",
                 "repro_torch.configs.granite_8b",
                 "repro_torch.configs.gemma2_9b",
                 "repro_torch.runtime.steps", "repro_torch.track.tracker",
                 "repro_torch.track.consumers",
                 "repro_torch.launch.serve"):
        assert want in names


def test_port_imports_no_jax_reference_or_msgpack():
    names = port_modules()
    code = (
        "import importlib, json, sys\n"
        f"for name in {names!r}:\n"
        "    importlib.import_module(name)\n"
        "from repro_torch.kernels import _build, flash_attention, stream_ops\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'repro', 'msgpack', 'triton'))\n"
        "print(json.dumps({'bad': bad, 'lib': not _build._libs,\n"
        "                  'launches': stream_ops.launches\n"
        "                  + flash_attention.launches}))\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == \
        '{"bad": [], "lib": true, "launches": 0}'
