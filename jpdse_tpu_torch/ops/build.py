"""Build the port's native code, load it with ctypes, and launch its CUDA
kernels from their wrappers.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` on its own into a shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds); each ``csrc/<name>.cpp`` (the host range coder) compiles with
``g++`` the same way. A library is named by the hash of its source, the
headers beside it and its flags, under ``jpdse_tpu_torch/build/``. A file
lock guards the build directory; a library is built at its first use, or
ahead of time for all sources in parallel by :func:`build_all`. Nothing is
built when a module is imported.

Every kernel wrapper follows one rule: a CPU tensor takes the kernel's
plain version, a CUDA tensor launches the kernel (:func:`check_operand`,
then :func:`launch`) or raises, and any other device raises.
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
GXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")  # jpdse_tpu/native/Makefile's


def nvcc_path() -> str:
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(found).exists():
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return found


def gxx_path() -> str:
    found = os.environ.get("CXX") or shutil.which("g++")
    if not found:
        raise RuntimeError("g++ not found: set CXX to a C++17 compiler")
    return found


def source_path(name: str) -> Path:
    """``csrc/<name>.cu`` or ``csrc/<name>.cpp``."""
    for suffix in (".cu", ".cpp"):
        src = CSRC_DIR / f"{name}{suffix}"
        if src.exists():
            return src
    raise FileNotFoundError(f"no source csrc/{name}.cu or csrc/{name}.cpp")


def _command(src: Path) -> list:
    """The compiler and its flags for ``src``, without the output."""
    if src.suffix == ".cu":
        return [nvcc_path(), *NVCC_FLAGS]
    return [gxx_path(), *GXX_FLAGS]


def library_path(name: str) -> Path:
    src = source_path(name)
    flags = NVCC_FLAGS if src.suffix == ".cu" else GXX_FLAGS
    headers = b"".join(p.read_bytes() for p in sorted(CSRC_DIR.glob("*.h")))
    digest = hashlib.sha256(src.read_bytes() + headers + " ".join(flags).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def sources() -> list:
    """The name of every source under ``csrc/``."""
    return sorted(p.stem for suffix in ("*.cu", "*.cpp") for p in CSRC_DIR.glob(suffix))


def build_all(names: Iterable[str] | None = None) -> Dict[str, str]:
    """Compile every named source (default: all of ``csrc/``) whose library
    is missing, one compiler per source, all started together. Returns each
    compiler's output (empty for a library already built); raises with that
    output if one fails."""
    names = sources() if names is None else list(names)
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
            src = source_path(n)
            cmd = [*_command(src), "-o", str(tmp), str(src)]
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
                "build failed for " + ", ".join(failed) + ":\n"
                + "\n".join(logs[n] for n in failed)
            )
    return logs


@functools.cache
def load_library(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu`` or ``.cpp``, building it if
    needed."""
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
