"""Build the port's CUDA kernels with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` compiles on its own into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds), named by
the hash of its source and flags under ``jpdse_tpu_torch/build/``. A file
lock guards the build directory; a library is built at its first use, or
ahead of time for all sources in parallel by :func:`build_all`.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)


def nvcc_path() -> str:
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(found).exists():
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return found


def library_path(name: str) -> Path:
    src = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build_all(names: Iterable[str] | None = None) -> Dict[str, str]:
    """Compile every named source (default: all of ``csrc/``) whose library
    is missing, one nvcc per source, all started together. Returns each
    compiler's output (empty for a library already built); raises with that
    output if one fails."""
    names = sorted(p.stem for p in CSRC_DIR.glob("*.cu")) if names is None else list(names)
    BUILD_DIR.mkdir(exist_ok=True)
    logs = {n: "" for n in names}
    with open(BUILD_DIR / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        procs = {}
        for n in names:
            out = library_path(n)
            if out.exists():
                continue
            tmp = out.with_suffix(f".so.{os.getpid()}")
            cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{n}.cu")]
            procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                         text=True), tmp, out)
        failed = []
        for n, (proc, tmp, out) in procs.items():
            logs[n] = proc.communicate()[0]
            if proc.returncode != 0:
                failed.append(n)
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, out)
        if failed:
            raise RuntimeError(
                "nvcc failed for " + ", ".join(failed) + ":\n"
                + "\n".join(logs[n] for n in failed)
            )
    return logs


@functools.cache
def load_library(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu``, building it if needed."""
    path = library_path(name)
    if not path.exists():
        build_all([name])
    return ctypes.CDLL(str(path))
