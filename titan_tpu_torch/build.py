"""Build a shared library from one source file at first use.

The library is named by a hash of the source, the headers it may
include and the command, so an edited source or header is rebuilt and
an unchanged one is reused. The compiler
writes to a temporary name unique to the process and thread, renamed
into place, so concurrent builds never load a half-written file; within
one process a lock per library makes a second thread wait for the first
build instead of compiling again. A failed build raises with the
compiler's stderr; nothing falls back.

Each compile that runs is reported to the callables in ``ON_BUILD``
(``fn(name, seconds)``); ``obs/devprof`` counts them as
``device.compile.*``. A library found already built reports nothing.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.abspath(__file__))
#: where the CUDA kernels of ``csrc/`` are built (listed in .gitignore)
CUDA_BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
#: callables ``fn(name, seconds)`` told of every compile that runs
ON_BUILD: list = []
_LOCKS: dict = {}
_LOCKS_LOCK = threading.Lock()


def build_shared(src: str, cmd: list[str], build_dir: str, name: str,
                 timeout: float = 600.0, headers: tuple = ()) -> str:
    """Compile ``src`` with ``cmd + ["-o", out, src]``; returns the path
    of the library. ``headers`` are the files it may include. The
    compiler's stderr (e.g. ``-Xptxas -v``) is kept beside it as
    ``<library>.log``."""
    h = hashlib.sha256("\0".join(cmd).encode())
    for path in (src, *sorted(headers)):
        with open(path, "rb") as f:
            h.update(f.read())
    digest = h.hexdigest()[:16]
    out = os.path.join(build_dir, f"{name}_{digest}.so")
    if os.path.exists(out):
        return out
    with _LOCKS_LOCK:
        lock = _LOCKS.setdefault(out, threading.Lock())
    with lock:
        if os.path.exists(out):       # another thread built it meanwhile
            return out
        os.makedirs(build_dir, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
        t0 = time.perf_counter()
        try:
            proc = subprocess.run(cmd + ["-o", tmp, src],
                                  capture_output=True, text=True,
                                  timeout=timeout)
            if proc.returncode != 0:
                raise RuntimeError(f"building {src} failed "
                                   f"({' '.join(cmd)}):\n{proc.stderr}")
            with open(out + ".log", "w") as f:
                f.write(proc.stderr)
            os.replace(tmp, out)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
        seconds = time.perf_counter() - t0
    for fn in list(ON_BUILD):
        fn(name, seconds)
    return out


def nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc`` (default
    ``/usr/local/cuda``), else the one on ``PATH``; raises if neither."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (CUDA_HOME or PATH): the CUDA "
                       "kernels cannot be built")


def build_cuda(name: str) -> str:
    """Build ``csrc/<name>.cu`` for sm_90a into a C-interface library
    under ``_build/``; returns its path. Every ``csrc/*.cuh`` counts as
    one of its headers."""
    csrc = os.path.join(_PKG, "csrc")
    headers = tuple(os.path.join(csrc, f) for f in os.listdir(csrc)
                    if f.endswith(".cuh"))
    return build_shared(os.path.join(csrc, f"{name}.cu"),
                        [nvcc()] + NVCC_FLAGS, CUDA_BUILD_DIR, name,
                        headers=headers)
