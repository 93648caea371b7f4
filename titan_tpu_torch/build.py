"""Build a shared library from one source file at first use.

The library is named by a hash of the source and the command, so an
edited source is rebuilt and an unchanged one is reused. The compiler
writes to a process-unique temporary name that is renamed into place,
so concurrent builds never load a half-written file. A failed build
raises with the compiler's stderr; nothing falls back.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess

_PKG = os.path.dirname(os.path.abspath(__file__))
#: where the CUDA kernels of ``csrc/`` are built (listed in .gitignore)
CUDA_BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def build_shared(src: str, cmd: list[str], build_dir: str, name: str,
                 timeout: float = 600.0) -> str:
    """Compile ``src`` with ``cmd + ["-o", out, src]``; returns the path
    of the library. The compiler's stderr (e.g. ``-Xptxas -v``) is kept
    beside it as ``<library>.log``."""
    with open(src, "rb") as f:
        digest = hashlib.sha256(
            f.read() + "\0".join(cmd).encode()).hexdigest()[:16]
    out = os.path.join(build_dir, f"{name}_{digest}.so")
    if os.path.exists(out):
        return out
    os.makedirs(build_dir, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    try:
        proc = subprocess.run(cmd + ["-o", tmp, src], capture_output=True,
                              text=True, timeout=timeout)
        if proc.returncode != 0:
            raise RuntimeError(
                f"building {src} failed ({' '.join(cmd)}):\n{proc.stderr}")
        with open(out + ".log", "w") as f:
            f.write(proc.stderr)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
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
    under ``_build/``; returns its path."""
    return build_shared(os.path.join(_PKG, "csrc", f"{name}.cu"),
                        [nvcc()] + NVCC_FLAGS, CUDA_BUILD_DIR, name)
