#!/usr/bin/env python3
"""K3's partial stats and sums launches under other values of their
partition's and ring's knobs, timed in one process on one GPU.

    python3 tools/torch_port_k3_partial_variants.py [--out DIR] [--only NAME,...]

Each variant is ``jpdse_tpu_torch/csrc/instance_norm.cu`` built with the
port's nvcc flags and some of its knobs set by -D (the ``K3_PART_*`` macros
of ``csrc/part_plan.h`` and ``instance_norm.cu``) into --out (default
``jpdse_tpu_torch/build/variants``), and loaded through the wrappers
``ops/instance_norm.py::instance_norm_stats`` and ``instance_norm_bwd_sums``
in place of the built kernels, with the wrappers' plan (``partial_plan``)
taken from the same library:
  - ``kernel``: the source as it is;
  - ``nomerge``: a diagnostic whose outputs are wrong and not checked: no
    merge across chunks (the CTAs write their partials and end), so the
    launch's time less the merge's;
  - ``nobulk``: a tile that is the whole row loaded by each thread's
    16-byte cp.async, as narrower tiles are, not by one bulk copy a stage;
  - ``tile8``, ``tile32``: channel tiles of at most 8 or 32 words;
  - ``merge64k``: a slab's partials up to 64 KiB before the tile narrows;
  - ``tilemin8``: tiles of at least 8 words (no 4-word tiles);
  - ``ring6``: rings of 6 stages (stats) and 4 (sums);
  - ``ctas264``: at most 264 CTAs a launch (two an SM) where chunks can grow;
  - ``min6``: chunks of at least 6 stages.
Every variant is held against the plain versions at every shape (the count
exact, mean and M2 within 1e-5 relative; sums within 1e-5 of their
max-abs). Per shape (the spatial step's rank slabs, a rank's 21 of 43 rows,
an empty slab, the hires rows) it prints each variant's mean device time by
the profiler over two passes (first to last, last to first) beside the byte
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
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="build directory for the variants")
    ap.add_argument("--only", default=None, help="comma-separated variant names")
    args = ap.parse_args()
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, here)
    import torch

    from chip_smoke import HIRES_PARTIAL_SHAPE, STEP_RANK_SLABS, bytes_ms, device_ms
    from jpdse_tpu_torch.ops import build
    from jpdse_tpu_torch.ops import instance_norm as k3

    shapes = STEP_RANK_SLABS + [((1, 21, 64, 1024), torch.float32),
                                ((1, 0, 64, 1024), torch.float32),
                                (HIRES_PARTIAL_SHAPE, torch.float32)]

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
        return name, lib

    with ThreadPoolExecutor(min(len(variants), 8)) as ex:
        built = list(ex.map(compile_one, variants))
    libs = {}
    for name, lib in built:
        so = ctypes.CDLL(lib)
        fns = []
        for symbol, sig in (("instance_norm_stats_launch", "ppppliiii"),
                            ("instance_norm_bwd_sums_launch", "ppppppliiiii")):
            fn = getattr(so, symbol)
            fn.argtypes = [build._CTYPES[k] for k in sig] + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            fns.append(fn)
        plan = so.instance_norm_part_plan
        plan.argtypes = [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                         ctypes.c_void_p]
        plan.restype = ctypes.c_int
        libs[name] = (fns, plan)

    kept = {attr: getattr(k3, attr) for attr in ("_stats_launcher", "_sums_launcher",
                                                 "partial_plan")}

    def use(name):
        (stats, sums), plan = libs[name]
        k3._stats_launcher, k3._sums_launcher = (lambda: stats), (lambda: sums)

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
            want_st = k3.instance_norm_stats_plain(x)
            _, ms = k3.instance_norm_apply(x, None, torch.stack([want_st, want_st]), True)
            want_sums = k3.instance_norm_bwd_sums_plain(x, g, ms, True)
            times = {n: {"stats": [], "sums": []} for n in names}
            for n in names + names[::-1]:
                use(n)
                runs = {"stats": lambda: k3.instance_norm_stats(x),
                        "sums": lambda: k3.instance_norm_bwd_sums(x, g, ms, True)}
                st, sums = runs["stats"](), runs["sums"]()
                rel = ((st[..., 1:] - want_st[..., 1:]).abs()
                       / want_st[..., 1:].abs().clamp_min(1.0)).max().item()
                err = (sums - want_sums).abs().max().item()
                scale = max(1.0, want_sums.abs().max().item())
                if n != "nomerge" and (
                        not torch.equal(st[..., 0], want_st[..., 0]) or not rel <= 1e-5
                        or not err <= 1e-5 * scale):
                    raise AssertionError(f"{n} at {shape} {dtype}: stats {rel:.2e} relative, "
                                         f"sums {err / scale:.2e} from the plain versions")
                for what, fn in runs.items():
                    times[n][what].append(device_ms(fn))
            for what, b in (("stats", bytes_ms(x)), ("sums", bytes_ms(x, g))):
                print(f"[variants] {what} {shape} {dtype}, bound {b:.4f} ms: " + "; ".join(
                    f"{n} {np.mean(v[what]):.4f}" for n, v in times.items())
                    + f" ms on the device ({card})", flush=True)
            del x, g, ms, want_st, want_sums
    finally:
        for attr, value in kept.items():
            setattr(k3, attr, value)
    return 0


if __name__ == "__main__":
    sys.exit(main())
