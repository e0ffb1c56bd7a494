"""Build and load the port's CUDA kernels: one helper for every source.

Each kernel lives in ``csrc/<name>.cu`` with a plain C interface.  At
first use it is compiled by ``nvcc`` for ``sm_90a`` into a shared
library under ``build/`` next to this file (named by a hash of the
source and the flags, so an edited source builds anew) and loaded with
``ctypes``.  Nothing is compiled or loaded at import time.

- ``build(*sources)`` compiles every source that has no library yet,
  one ``nvcc`` per source, all started together, and returns each
  library's path and the seconds its compile took (0 when it was built
  already).
- ``load(source, bind)`` builds and loads one source once per process;
  ``bind(lib)`` declares its functions' ``argtypes``/``restype``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Callable, Dict, List, Tuple

CSRC = Path(__file__).with_name("csrc")
BUILD_DIR = Path(__file__).with_name("build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_libs: Dict[Path, ctypes.CDLL] = {}
_lock = threading.Lock()


class KernelCompileError(RuntimeError):
    """A CUDA kernel could not be compiled or loaded.  A RuntimeError on
    purpose: callers that turn ``OSError`` into a shard failover must
    never mistake a missing kernel for a dead shard."""


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    return str(Path(home) / "bin" / "nvcc")


def library_path(source: Path) -> Path:
    """Where ``source``'s library goes: keyed by its bytes and flags."""
    digest = hashlib.sha1(source.read_bytes()
                          + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{source.stem}-{digest[:12]}.so"


def build(*sources: Path, verbose: bool = False) -> List[Tuple[Path, float]]:
    """Compile each source that is not built yet, all at once; return
    ``(library, seconds)`` per source, in order, where ``seconds`` is
    that source's own compile time (0 when it was built already).
    ``verbose`` adds ``-Xptxas -v`` and prints what the compiler says."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    try:
        for src in sources:
            out = library_path(src)
            if out.exists():
                jobs.append([src, out, None, None, None, 0.0])
                continue
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc(), *NVCC_FLAGS]
            if verbose:
                cmd += ["-Xptxas", "-v"]
            cmd += ["-o", str(tmp), str(src)]
            log = tempfile.TemporaryFile(mode="w+")
            job = [src, out, tmp, None, log, time.perf_counter()]
            jobs.append(job)
            try:
                job[3] = subprocess.Popen(cmd, stdout=log,
                                          stderr=subprocess.STDOUT)
            except OSError as exc:
                raise KernelCompileError(
                    f"cannot run nvcc ({cmd[0]}): {exc}") from exc
        running = [job for job in jobs if job[3] is not None]
        while running:
            for job in list(running):
                if job[3].poll() is not None:
                    job[5] = time.perf_counter() - job[5]
                    running.remove(job)
            if running:
                time.sleep(0.02)
        failed = []
        for src, out, tmp, proc, log, _ in jobs:
            if proc is None:
                continue
            log.seek(0)
            text = log.read()
            if proc.returncode != 0:
                failed.append(f"nvcc failed on {src.name} "
                              f"({proc.returncode}):\n{text}")
                continue
            if verbose:
                print(text, end="", flush=True)
            os.replace(tmp, out)
        if failed:
            raise KernelCompileError("\n".join(failed))
        return [(job[1], job[5]) for job in jobs]
    finally:
        for job in jobs:
            if job[3] is not None and job[3].poll() is None:
                job[3].kill()
                job[3].wait()
            if job[4] is not None:
                job[4].close()


def load(source: Path, bind: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    """The loaded library of ``source``, built at the first call."""
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            (path, _), = build(source)
            try:
                lib = ctypes.CDLL(str(path))
            except OSError as exc:
                raise KernelCompileError(
                    f"cannot load {path}: {exc}") from exc
            bind(lib)
            _libs[source] = lib
        return lib
