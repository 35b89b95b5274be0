"""Build and load the port's CUDA kernels.

The sources under ``csrc/`` have a plain C interface.  At first use they
are compiled with ``nvcc`` for ``sm_90a`` (one ``nvcc -c`` per source, all
started together, then one link) into a shared library under ``_build/``
beside this file, and loaded with ``ctypes``.  The library's name carries a
hash of the sources and flags, so an edited source is rebuilt and an
unchanged one is not.

Ranks of a distributed solve that share the checkout build at first use
too: the build holds an exclusive ``flock`` on ``_build/.lock``, so one
process compiles and the others wait, then load its library (the lock is
the kernel's, released when its holder exits, so a killed build leaves no
stale lock behind).

Nothing here runs at import time: the tests import every module on machines
that have neither ``nvcc`` nor a GPU.  The build runs when a CUDA tensor
first reaches a kernel wrapper.  A failed build raises with the compiler's
output; nothing falls back to another implementation.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

__all__ = ["load", "build", "NVCC_FLAGS", "info"]

_HERE = Path(__file__).resolve().parent
CSRC = _HERE / "csrc"
BUILD_DIR = _HERE / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_lock = threading.Lock()
_lib = None
# what the last build in this process did: seconds, compiler output, path
info: dict = {}


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked on PATH and under CUDA_HOME or "
        "/usr/local/cuda): the CUDA kernels cannot be built on this machine"
    )


def _sources():
    srcs = sorted(CSRC.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    return srcs


def _digest(srcs) -> str:
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    for p in srcs + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the sources if their library is not there yet; return its
    path.  Concurrent processes build once (``_build/.lock``)."""
    srcs = _sources()
    tag = _digest(srcs)
    lib_path = BUILD_DIR / f"libopenmg_kernels_{tag}.so"
    if lib_path.exists():
        info.update(seconds=0.0, log="", path=str(lib_path), cached=True)
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if lib_path.exists():   # another process built it meanwhile
                info.update(seconds=0.0, log="", path=str(lib_path), cached=True)
                return lib_path
            return _compile(srcs, tag, lib_path)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def _compile(srcs, tag, lib_path) -> Path:
    nvcc = _nvcc()
    t0 = time.perf_counter()
    objs, procs = [], []
    for src in srcs:
        obj = BUILD_DIR / f"{src.stem}_{tag}_{os.getpid()}.o"
        objs.append(obj)
        procs.append(
            subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
        )
    logs, failed = [], False
    for src, proc in zip(srcs, procs):
        out, _ = proc.communicate()
        logs.append(f"== {src.name}\n{out}")
        failed |= proc.returncode != 0
    log = "\n".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed:\n{log}")
    tmp = BUILD_DIR / f"{lib_path.name}.{os.getpid()}.tmp"
    link = subprocess.run(
        [nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}\n{log}")
    os.replace(tmp, lib_path)  # atomic: a concurrent build sees all or nothing
    for obj in objs:
        obj.unlink(missing_ok=True)
    info.update(
        seconds=time.perf_counter() - t0, log=log, path=str(lib_path),
        cached=False,
    )
    return lib_path


def load() -> ctypes.CDLL:
    """The kernels' library, built on first call.  Callers set ``argtypes``
    on the functions they use."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = ctypes.CDLL(str(build()))
        return _lib
