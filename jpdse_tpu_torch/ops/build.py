"""Build the port's CUDA kernels with ``nvcc``, load them with ctypes, and
launch them from their wrappers.

Each ``csrc/<name>.cu`` compiles on its own into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds), named by
the hash of its source and flags under ``jpdse_tpu_torch/build/``. A file
lock guards the build directory; a library is built at its first use, or
ahead of time for all sources in parallel by :func:`build_all`.

Every wrapper follows one rule: a CPU tensor takes the kernel's plain
version, a CUDA tensor launches the kernel (:func:`check_operand`, then
:func:`launch`) or raises, and any other device raises.
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
from typing import Dict, Iterable, Sequence

import torch

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


KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def check_operand(name: str, t: torch.Tensor, dtypes: Sequence[torch.dtype] = KERNEL_DTYPES):
    """Raise unless ``t`` is a contiguous CUDA tensor of one of ``dtypes``."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {t.device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: unsupported dtype {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: input must be contiguous")


_CTYPES = {"p": ctypes.c_void_p, "l": ctypes.c_longlong, "i": ctypes.c_int,
           "f": ctypes.c_float}


def c_function(library: str, symbol: str, signature: str):
    """``symbol`` of ``csrc/<library>.cu``, a launcher taking the arguments
    that ``signature`` spells (p: pointer, l: long long, i: int, f: float),
    then the stream, and returning a cudaError_t. Pointers and the stream
    go as ``c_void_p``, or ctypes would cut them to 32 bits."""
    fn = getattr(load_library(library), symbol)
    fn.argtypes = [_CTYPES[k] for k in signature] + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def launch(name: str, fn, t: torch.Tensor, *args) -> None:
    """``fn(*args, stream)`` on ``t``'s device and current stream; raises
    unless the launcher returns cudaSuccess (0)."""
    with torch.cuda.device(t.device):
        rc = fn(*args, torch.cuda.current_stream(t.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {rc}")
