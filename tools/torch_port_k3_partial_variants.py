#!/usr/bin/env python3
"""K3's partial-statistics launches under other values of their partitions'
and rings' knobs, timed in one process on one GPU.

    python3 tools/torch_port_k3_partial_variants.py [--out DIR] [--only NAME,...]
        [--legs stats,apply,apply residual,sums,dx]

Each variant is ``jpdse_tpu_torch/csrc/instance_norm.cu`` built with the
port's nvcc flags and some of its knobs set by -D (the ``K3_PART_*`` and
``K3_APPLY_*`` macros of ``csrc/part_plan.h`` and ``instance_norm.cu``)
into --out (default ``jpdse_tpu_torch/build/variants``), and loaded through
the wrappers of ``ops/instance_norm.py`` in place of the built kernels, with
the stats' and sums' workspace plan (``partial_plan``) taken from the same
library:
  - ``kernel``: the source as it is;
  - ``nomerge``: a diagnostic whose stats and sums are wrong and not
    checked: no merge across chunks (the CTAs write their partials and
    end), so those launches' time less the merge's;
  - ``nobulk``: a tile that is the whole row loaded by each thread's
    16-byte cp.async, as narrower tiles are, not by one bulk copy a stage;
  - ``tile8``, ``tile32``: stats and sums tiles of at most 8 or 32 words;
  - ``merge64k``: a slab's partials up to 64 KiB before the tile narrows;
  - ``tilemin8``: tiles of at least 8 words (no 4-word tiles);
  - ``ring6``: rings of 6 stages (stats) and 4 (sums);
  - ``ctas264``: at most 264 CTAs a launch (two an SM) where chunks can grow;
  - ``min6``: chunks of at least 6 stages;
  - ``apply_tile32``: apply and dx tiles of at most 32 words;
  - ``apply_batch2``, ``apply_batch8``: 2 or 8 rows of each operand a
    thread loads a step (the dx on bf16 half that);
  - ``apply_fixed264``: 264 CTAs a launch whatever its size (no CTA for
    each 128 KiB); ``apply_ctas132``: at least 132;
  - ``apply_words4k``, ``apply_words16k``: a CTA for each 4096 or 16384
    words (64 or 256 KiB of x on the vector path);
  - ``apply_min2``: apply and dx chunks of at least 2 steps;
  - ``apply_lb1``: launch bounds that ask for one CTA an SM (registers not
    capped at half an SM's).
The apply and dx kernels' registers a thread are printed for each variant.
Every variant's legs (``chip_smoke.step_legs``) are held against their
plain versions at every shape and for two launches bit-equal
(``chip_smoke.check_leg``). Per shape (the spatial step's rank slabs, a
rank's 21 of 43 rows, an empty slab, the hires rows) it prints each
variant's mean device time by the profiler over two passes (first to last,
last to first) beside the byte bound and the card's name and power limit.
Imports no JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np

VARIANTS = {
    "kernel": {},
    "nomerge": {"K3_PART_DIAG_NOMERGE": 1},
    "nobulk": {"K3_PART_BULK": 0},
    "tile8": {"K3_PART_TILE_WORDS": 8},
    "tile32": {"K3_PART_TILE_WORDS": 32},
    "merge64k": {"K3_PART_MERGE_BYTES": 65536},
    "tilemin8": {"K3_PART_TILE_MIN": 8},
    "ring6": {"K3_PART_STATS_STAGES": 6, "K3_PART_SUMS_STAGES": 4},
    "ctas264": {"K3_PART_MAX_CTAS": 264},
    "min6": {"K3_PART_MIN_STAGES": 6},
    "apply_tile32": {"K3_APPLY_TILE_WORDS": 32},
    "apply_batch2": {"K3_APPLY_BATCH": 2},
    "apply_batch8": {"K3_APPLY_BATCH": 8},
    "apply_fixed264": {"K3_APPLY_MAX_CTAS": 264},
    "apply_ctas132": {"K3_APPLY_CTAS": 132},
    "apply_words4k": {"K3_APPLY_CTA_WORDS": 4096},
    "apply_words16k": {"K3_APPLY_CTA_WORDS": 16384},
    "apply_min2": {"K3_APPLY_MIN_STEPS": 2},
    "apply_lb1": {"K3_APPLY_MIN_BLOCKS": 1},
}
# each launcher the variants replace: its wrapper's cached getter, symbol, signature
LAUNCHERS = {"_stats_launcher": ("instance_norm_stats_launch", "ppppliiii"),
             "_apply_launcher": ("instance_norm_apply_launch", "ppppplii" "iiiif"),
             "_sums_launcher": ("instance_norm_bwd_sums_launch", "ppppppliiiii"),
             "_dx_launcher": ("instance_norm_bwd_dx_launch", "pppppl" "iiiiiif")}


def apply_registers(log: str) -> list:
    """The apply and dx kernels' registers a thread from ptxas's -v report,
    as "apply<float,4> 40" and so on."""
    out, entry = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '\S*?(apply|bwd_dx)_kernelI(f|13__nv_bfloat16)"
                      r"Li(\d+)E", line)
        if "Compiling entry" in line:
            entry = (f"{m.group(1).removeprefix('bwd_')}<{'float' if m.group(2) == 'f' else 'bf16'},"
                     f"{m.group(3)}>") if m else None
        regs = re.search(r"Used (\d+) registers", line)
        if regs and entry:
            out.append(f"{entry} {regs.group(1)}")
            entry = None
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="build directory for the variants")
    ap.add_argument("--only", default=None, help="comma-separated variant names")
    ap.add_argument("--legs", default=None, help="comma-separated legs (chip_smoke.STEP_LEGS)")
    args = ap.parse_args()
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, here)
    import torch

    import chip_smoke as cs
    from jpdse_tpu_torch.ops import build
    from jpdse_tpu_torch.ops import instance_norm as k3

    shapes = cs.STEP_RANK_SLABS + [((1, 21, 64, 1024), torch.float32),
                                   ((1, 0, 64, 1024), torch.float32),
                                   (cs.HIRES_PARTIAL_SHAPE, torch.float32)]
    legs = cs.STEP_LEGS if args.legs is None else tuple(args.legs.split(","))

    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[0]
    out = args.out or os.path.join(here, "jpdse_tpu_torch", "build", "variants")
    os.makedirs(out, exist_ok=True)
    variants = {n: e for n, e in VARIANTS.items()
                if args.only is None or n in args.only.split(",")}
    src = str(build.CSRC_DIR / "instance_norm.cu")

    def compile_one(name):
        lib = os.path.join(out, f"libpart_{name}.so")
        defines = [f"-D{k}={v}" for k, v in variants[name].items()]
        res = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, *defines, "-o", lib, src],
                             capture_output=True, text=True)
        if res.returncode:
            raise RuntimeError(f"{name}: {res.stdout}{res.stderr}")
        return name, lib, res.stdout + res.stderr

    with ThreadPoolExecutor(min(len(variants), 8)) as ex:
        built = list(ex.map(compile_one, variants))
    libs = {}
    for name, lib, log in built:
        print(f"[variants] {name} registers a thread: " + ", ".join(apply_registers(log)),
              flush=True)
        so = ctypes.CDLL(lib)
        fns = {}
        for attr, (symbol, sig) in LAUNCHERS.items():
            fn = getattr(so, symbol)
            fn.argtypes = [build._CTYPES[k] for k in sig] + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            fns[attr] = fn
        plan = so.instance_norm_part_plan
        plan.argtypes = [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                         ctypes.c_void_p]
        plan.restype = ctypes.c_int
        libs[name] = (fns, plan)

    kept = {attr: getattr(k3, attr) for attr in [*LAUNCHERS, "partial_plan"]}

    def use(name):
        fns, plan = libs[name]
        for attr, fn in fns.items():
            setattr(k3, attr, lambda fn=fn: fn)

        def partial_plan(b, hw, c, vec):
            o = (ctypes.c_longlong * 7)()
            if plan(hw, b, c, vec, o) != 0:
                raise ValueError((b, hw, c, vec))
            return tuple(o)

        k3.partial_plan = partial_plan

    gen = torch.Generator(device="cuda").manual_seed(0)
    names = list(libs)
    try:
        for shape, dtype in shapes:
            x = (torch.randn(shape, device="cuda", generator=gen) * 3 + 1).to(dtype)
            g = torch.randn(shape, device="cuda", generator=gen).to(x.dtype)
            res = (torch.randn(shape, device="cuda", generator=gen).to(x.dtype)
                   if cs.times_residual(shape) else None)
            other = count = None
            if tuple(shape) in cs.UNEVEN_TIMED:  # a rank's rows of 43: the other rank has the rest
                other = k3.instance_norm_stats_plain(torch.randn(
                    (1, 43 - shape[1]) + tuple(shape[2:]), device="cuda", generator=gen)).float()
                count = 43 * shape[2]
            times = {n: {leg: [] for leg in legs} for n in names}
            bounds = {}
            for n in names + names[::-1]:
                use(n)
                for leg, (kern, plain, bound, _) in cs.step_legs(k3, x, g, res, other,
                                                                 count).items():
                    if leg not in legs:
                        continue
                    if n != "nomerge" or leg not in ("stats", "sums"):
                        cs.check_leg(leg, kern, plain, x.dtype, f"{n} {shape} {dtype}")
                    times[n][leg].append(cs.device_ms(kern))
                    bounds[leg] = bound
            for leg in bounds:
                print(f"[variants] {leg} {shape} {dtype}, bound {bounds[leg]:.4f} ms: "
                      + "; ".join(f"{n} {np.mean(v[leg]):.4f}" for n, v in times.items())
                      + f" ms on the device ({card})", flush=True)
            del x, g, res, other
    finally:
        for attr, value in kept.items():
            setattr(k3, attr, value)
    return 0


if __name__ == "__main__":
    sys.exit(main())
