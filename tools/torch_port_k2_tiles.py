#!/usr/bin/env python3
"""Sweep kernel K2's tile size and block size on one GPU.

    python3 tools/torch_port_k2_tiles.py [--tiles 8192 16384 32768] [--threads 128 256]

Builds ``jpdse_tpu_torch/csrc/realign.cu`` once for each pair of
``kFrontTileBytes`` (the output bytes a block aims at) and
``kFrontThreads``, with nvcc into a temporary directory, checks each build
bit-exact against ``s2d_pad3_plain`` and prints the profiler's device time
a call (the median of three profiles of 20 calls) at (1, 512, 1024, C) for
C = 3, 36, 39 in bf16 and C = 3 in fp32. Beside them: a ``copy_`` of as
many bytes and a one-element ``fill_``, the floors of any kernel that
moves those bytes and of any launch. Imports no JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
import tempfile

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from jpdse_tpu_torch.ops import build, realign  # noqa: E402

SHAPES = [(3, torch.bfloat16), (36, torch.bfloat16), (39, torch.bfloat16), (3, torch.float32)]


def device_us(fn, iters: int = 20) -> float:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        runs.append(sum(e.self_device_time_total for e in events)
                    / max(1, sum(e.count for e in events)))
    return sorted(runs)[1]


def launcher(tmp: str, tile: int, threads: int):
    src = open(os.path.join(REPO, "jpdse_tpu_torch", "csrc", "realign.cu")).read()
    for old, new in (("kFrontTileBytes = 16384;", f"kFrontTileBytes = {tile};"),
                     ("kFrontThreads = 256;", f"kFrontThreads = {threads};")):
        if old not in src:
            raise RuntimeError(f"realign.cu no longer holds {old!r}")
        src = src.replace(old, new)
    path = os.path.join(tmp, f"realign_{tile}_{threads}")
    with open(path + ".cu", "w") as f:
        f.write(src)
    flags = [f for f in build.NVCC_FLAGS if f != "-Xptxas=-v"]
    subprocess.run([build.nvcc_path(), *flags, "-o", path + ".so", path + ".cu"], check=True)
    fn = ctypes.CDLL(path + ".so").s2d_pad3_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tiles", type=int, nargs="+", default=[8192, 16384, 32768])
    ap.add_argument("--threads", type=int, nargs="+", default=[128, 256])
    args = ap.parse_args()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[0]
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = {}
    for c, dtype in SHAPES:
        x = torch.randn((1, 512, 1024, c), device="cuda", generator=gen).to(dtype)
        want = realign.s2d_pad3_plain(x)
        half = (x.numel() + want.numel()) // 2
        a, b = torch.empty(half, dtype=dtype, device="cuda"), torch.empty(half, dtype=dtype,
                                                                          device="cuda")
        cases[c, dtype] = (x, want)
        print(f"[k2-tiles] C={c} {str(dtype)[6:]}: a copy_ of as many bytes "
              f"{device_us(lambda: b.copy_(a)):.2f} us ({card})", flush=True)
    one = torch.empty(1, device="cuda")
    print(f"[k2-tiles] a one-element fill_ {device_us(lambda: one.fill_(1.0)):.2f} us ({card})",
          flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        for tile in args.tiles:
            for threads in args.threads:
                fn = launcher(tmp, tile, threads)
                cells = []
                for (c, dtype), (x, want) in cases.items():
                    out = torch.empty_like(want)
                    stream = torch.cuda.current_stream().cuda_stream

                    def go():
                        rc = fn(x.data_ptr(), out.data_ptr(), 1, 512, 1024, c, x.element_size(),
                                want.shape[1], stream)
                        if rc != 0:
                            raise RuntimeError(f"launch failed with CUDA error {rc}")

                    go()
                    torch.cuda.synchronize()
                    if not torch.equal(out, want):
                        raise AssertionError(f"tile {tile}, {threads} threads, C={c} {dtype}")
                    cells.append(f"C={c} {str(dtype)[6:]} {device_us(go):.2f}")
                print(f"[k2-tiles] tile {tile} B, {threads} threads: " + ", ".join(cells)
                      + f" us on the device, bit-exact ({card})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
