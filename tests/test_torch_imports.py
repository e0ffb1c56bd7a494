"""The port stands alone: importing every ``repro_torch`` module pulls in
no JAX, nothing of the reference package and no ``msgpack`` (the card's
machine has none of them), and compiles or loads no kernel."""

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
                 "repro_torch.core.msgpack_subset"):
        assert want in names


def test_port_imports_no_jax_reference_or_msgpack():
    names = port_modules()
    code = (
        "import importlib, json, sys\n"
        f"for name in {names!r}:\n"
        "    importlib.import_module(name)\n"
        "from repro_torch.kernels import stream_ops\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'repro', 'msgpack'))\n"
        "print(json.dumps({'bad': bad, 'lib': stream_ops._lib is None,\n"
        "                  'launches': stream_ops.launches}))\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == \
        '{"bad": [], "lib": true, "launches": 0}'
