#!/usr/bin/env python3
"""Where K3's backward spends its time: variants of the kernel, timed in one
process on one GPU.

    python3 tools/torch_port_k3_bwd_variants.py [--parent DIR] [--out DIR]

Each variant is ``jpdse_tpu_torch/csrc/instance_norm.cu`` with one text edit,
built with the port's nvcc flags into --out (default
``jpdse_tpu_torch/build/variants``) and loaded through the wrapper
``ops/instance_norm.py::fused_instance_norm_bwd`` in place of the built
kernel:
  - ``kernel``: the source as it is;
  - ``ring2``, ``ring4``, ``ring8``: the cp.async ring at 2, 4 or 8 slots
    (the cache gets what the ring leaves);
  - ``nocache``: no cache slots, every word through the ring twice;
  - ``fin1``: the finalize pass with one load in flight a lane;
  - ``phase1``: phase 1 alone (the kernel returns before the first grid
    barrier; its dx is not written);
  - ``nofinal``: both barriers but no finalize work (the means are left
    unset);
  - ``noarith``: the loads, copies and stores with no arithmetic beyond a
    sum (dx is wrong).
The last three are diagnostics whose output is not checked; the others are
held against the plain version on the same statistics (fp32 within 1e-5).
With --parent DIR the kernel of another checkout is timed too. Per shape
(the headline (1, 512, 1024, 64) bf16, the two smallest batch-1 slabs in
bf16, and the five training shapes in fp32, all with the ReLU) it prints each variant's mean device time by the
profiler and event time over 20 back-to-back calls, from three passes in
the order first to last, last to first, first to last, beside the byte
bound and the card's name and power limit. Imports no JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np

MEM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (data sheet)
SHAPES = [((1, 512, 1024, 64), "bfloat16"), ((1, 64, 128, 512), "bfloat16"),
          ((1, 32, 64, 1024), "bfloat16"), ((2, 512, 1024, 64), "float32"),
          ((2, 256, 512, 128), "float32"), ((2, 128, 256, 256), "float32"),
          ((2, 64, 128, 512), "float32"), ((2, 32, 64, 1024), "float32")]
DIAGNOSTIC = ("phase1", "nofinal", "noarith")
RING = "constexpr int kRing = 3;"
SYNC = "  cooperative_groups::grid_group grid = cooperative_groups::this_grid();\n  grid.sync();\n"
FINAL = ("    for (long long i = (static_cast<long long>(blockIdx.x) * kThreads + tid) / 32;\n"
         "         i < static_cast<long long>(p.batch) * p.c; i += warps) {")
ARITH1 = """          const float xh = (to_f(xw.v[v]) - mean[v]) * rstd[v];
          float gg = to_f(gw.v[v]);
          if (relu && !(xh > 0.f)) gg = 0.f;
          sg[v] += gg;
          sgx[v] += gg * xh;"""
ARITH3 = """        const float xh = (to_f(xw.v[v]) - mean[v]) * rstd[v];
        float gg = to_f(gw.v[v]);
        if (relu && !(xh > 0.f)) gg = 0.f;
        d[v] = rstd[v] * (gg - gm[v] - xh * gx[v]);"""
EDITS = {
    "kernel": [],
    "ring2": [(RING, RING.replace("3", "2"))],
    "ring4": [(RING, RING.replace("3", "4"))],
    "ring8": [(RING, RING.replace("3", "8"))],
    "fin1": [("constexpr int kFin = 8;", "constexpr int kFin = 1;")],
    "nocache": [("p.cache_iters = smem / (kThreads * 2 * static_cast<int>(sizeof(Vec<T, V>))) "
                 "- kRing;", "p.cache_iters = 0;")],
    "phase1": [(SYNC, "  return;\n" + SYNC)],
    "nofinal": [(FINAL, FINAL.replace("i < static_cast<long long>(p.batch) * p.c", "i < 0"))],
    "noarith": [(ARITH1, "          sg[v] += to_f(xw.v[v]) + to_f(gw.v[v]);"),
                (ARITH3, "        d[v] = to_f(xw.v[v]) + to_f(gw.v[v]);")],
}


def variant_source(src: str, edits) -> str:
    """``src`` with each (old, new) replaced where old occurs once: in the
    whole source, or else from the backward kernel on (the forward has
    the same grid barrier)."""
    mark = "instance_norm_bwd_kernel(const T* __restrict__ x"
    for old, new in edits:
        if src.count(old) == 1:
            src = src.replace(old, new)
            continue
        head, tail = src.split(mark, 1)
        if tail.count(old) != 1:
            raise ValueError(f"edit does not apply once: {old[:60]!r}")
        src = head + mark + tail.replace(old, new)
    return src


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="another checkout whose kernel is timed too")
    ap.add_argument("--out", default=None, help="build directory for the variants")
    args = ap.parse_args()
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, here)
    import torch

    from chip_smoke import cuda_ms, device_ms
    from jpdse_tpu_torch.ops import build
    from jpdse_tpu_torch.ops import instance_norm as k3

    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[0]
    out = args.out or os.path.join(here, "jpdse_tpu_torch", "build", "variants")
    os.makedirs(out, exist_ok=True)
    src = (build.CSRC_DIR / "instance_norm.cu").read_text()
    sources = {name: variant_source(src, edits) for name, edits in EDITS.items()}
    if args.parent:
        with open(os.path.join(args.parent, "jpdse_tpu_torch", "csrc", "instance_norm.cu")) as f:
            sources["parent"] = f.read()

    def compile_one(name):
        path, lib = os.path.join(out, f"{name}.cu"), os.path.join(out, f"lib{name}.so")
        with open(path, "w") as f:
            f.write(sources[name])
        res = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", lib, path],
                             capture_output=True, text=True)
        if res.returncode:
            raise RuntimeError(f"{name}: {res.stdout}{res.stderr}")
        return name, lib

    with ThreadPoolExecutor(len(sources)) as ex:
        built = list(ex.map(compile_one, sources))
    launchers = {}
    for name, lib in built:
        fn = ctypes.CDLL(lib).instance_norm_bwd_launch
        fn.argtypes = [build._CTYPES[k] for k in "ppppppliiiiii"] + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        launchers[name] = fn

    built_launcher = k3._bwd_launcher
    gen = torch.Generator(device="cuda").manual_seed(0)
    names = list(launchers)
    try:
        for shape, dtype in SHAPES:
            x = (torch.randn(shape, device="cuda", generator=gen) * 3 + 1).to(getattr(torch, dtype))
            g = torch.randn(shape, device="cuda", generator=gen).to(x.dtype)
            _, stats = k3._forward(x, None, True, 1e-5)
            want = k3.fused_instance_norm_bwd_plain(x, g, True, stats=stats)
            times = {n: [] for n in names}
            for n in names + names[::-1] + names:
                k3._bwd_launcher = (lambda f: lambda: f)(launchers[n])

                def fn():
                    return k3.fused_instance_norm_bwd(x, g, stats, True)

                err = (fn().float() - want.float()).abs().max().item()
                if n not in DIAGNOSTIC and dtype == "float32" and not err <= 1e-5:
                    raise AssertionError(f"{n} at {shape}: {err} from the plain version")
                times[n].append((device_ms(fn), cuda_ms(fn)))
            bound = 3 * x.numel() * x.element_size() / MEM_BYTES_PER_S * 1e3
            print(f"[variants] K3 backward {shape} {dtype} relu, bound {bound:.4f} ms: " + "; ".join(
                f"{n} device {np.mean([t[0] for t in v]):.4f} ms, events "
                f"{np.mean([t[1] for t in v]):.4f}" for n, v in times.items()) + f" ({card})",
                flush=True)
            del x, g, stats, want
    finally:
        k3._bwd_launcher = built_launcher
    return 0


if __name__ == "__main__":
    sys.exit(main())
