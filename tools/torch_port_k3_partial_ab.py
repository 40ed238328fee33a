#!/usr/bin/env python3
"""Parent/change A/B of K3's partial-statistics launches (``instance_norm_stats``,
``instance_norm_apply``, ``instance_norm_bwd_sums``, ``instance_norm_bwd_dx``)
on one GPU.

    python3 tools/torch_port_k3_partial_ab.py --parent DIR [--rounds N]

DIR is another checkout of the repo (e.g. the parent commit unpacked by
``git archive`` into a git-ignored directory). The script runs 4 x --rounds
fresh processes in blocks of parent, change, change, parent; each one
imports ``jpdse_tpu_torch`` from its own checkout, builds its kernels, and
times the four launches at the spatial step's own rank slabs: every norm
level's rows halved (spatial 2) at batch 2 in fp32 (the training step) and
batch 1 in bf16 (serving), one rank's 21 of 43 rows and an empty slab in
fp32 (the uneven heights), and the hires recipe's rows in fp32. The legs
and their checks are chip_smoke.py's (``step_legs``, ``check_leg``): the
apply with the ReLU, and with the residual at the deepest level's slabs and
the hires rows; the sums and the dx with the ReLU. Each leg is first held
against its plain version and a second launch (bit-equal). Per case it
records the profiler's device time a call, the CUDA-event time a call over
20 back-to-back calls (x as a step finds it, just read or written: in the
50 MB L2 where it fits), the event time of a call made after a 64 MB
scratch write has flushed the L2, and ``torch.var_mean`` over (H, W), the
one PyTorch call that computes the stats launch's function. It prints one
JSON line per process and, at the end, each side's medians beside the byte
bound, and the device time summed over one rank-step's launches at the
step's slabs (``chip_smoke.step_launches``: the stats and the apply 90
times, the sums and the dx 45), with the card's name and power limit.
Imports no JAX.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def yardstick():
    """This checkout's chip_smoke.py, whose timers, bound and shapes both
    sides are measured by (imported by path, so that a child imports the
    port from its own checkout)."""
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cases(cs):
    """The timed slabs: chip_smoke's STEP_RANK_SLABS (every norm level's rows
    halved at batch 2 in fp32 and batch 1 in bf16), one rank's 21 of 43 rows,
    an empty slab, the hires rows."""
    return ([(shape, str(dtype).removeprefix("torch.")) for shape, dtype in cs.STEP_RANK_SLABS]
            + [((1, 21, 64, 1024), "float32"), ((1, 0, 64, 1024), "float32"),
               (cs.HIRES_PARTIAL_SHAPE, "float32")])


# the legs summed over a rank-step, by the kernels they time
PAIRS = {"stats + sums": ("stats", "sums"), "apply + dx": ("apply", "apply residual", "dx")}


def key(shape, dtype) -> str:
    return f"{tuple(shape)} {dtype}"


def child(repo: str) -> dict:
    cs = yardstick()
    sys.path.insert(0, os.path.abspath(repo))
    import torch

    from jpdse_tpu_torch.ops import build
    from jpdse_tpu_torch.ops import instance_norm as k3

    build.build_all()

    gen = torch.Generator(device="cuda").manual_seed(0)
    record = {"repo": repo, "cases": {}}
    for shape, dtype in cases(cs):
        x = (torch.randn(shape, device="cuda", generator=gen) * 3 + 1).to(getattr(torch, dtype))
        g = torch.randn(shape, device="cuda", generator=gen).to(x.dtype)
        res = (torch.randn(shape, device="cuda", generator=gen).to(x.dtype)
               if cs.times_residual(shape) else None)
        other = count = None
        if tuple(shape) in cs.UNEVEN_TIMED:  # a rank's rows of 43: the other rank has the rest
            rows = 43
            other = k3.instance_norm_stats(torch.randn(
                (1, rows - shape[1]) + tuple(shape[2:]), device="cuda", generator=gen))
            count = rows * shape[2]
        case = {}
        for leg, (kern, plain, bound, library) in cs.step_legs(k3, x, g, res, other,
                                                               count).items():
            cs.check_leg(leg, kern, plain, x.dtype, key(shape, dtype))
            case[leg] = {"device_ms": cs.device_ms(kern), "event_ms": cs.cuda_ms(kern),
                         "flushed_ms": cs.flushed_ms(kern), "bound_ms": bound,
                         "library_ms": cs.cuda_ms(library) if library and x.numel() else None}
        record["cases"][key(shape, dtype)] = case
        del x, g, res, other
    return record


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="the other checkout to compare with")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        print(json.dumps(child(args.child)), flush=True)
        return 0
    cs = yardstick()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[0]
    order = []
    for _ in range(args.rounds):
        order += [("parent", args.parent), ("change", HERE), ("change", HERE),
                  ("parent", args.parent)]
    recs = {"parent": [], "change": []}
    for i, (side, repo) in enumerate(order):
        out = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", repo],
                             capture_output=True, text=True, timeout=900)
        if out.returncode != 0:
            print(out.stdout[-4000:], out.stderr[-4000:], file=sys.stderr)
            raise RuntimeError(f"run {i} ({side}) failed")
        rec = json.loads(out.stdout.strip().splitlines()[-1])
        recs[side].append(rec)
        print(f"[ab] run {i} {side}: {json.dumps(rec)}", flush=True)

    def med(side, case, name, what):
        return float(np.median([r["cases"][case][name][what] for r in recs[side]]))

    per_step = {pair: {side: 0.0 for side in recs} for pair in PAIRS}
    step_bound = dict.fromkeys(PAIRS, 0.0)
    for shape, dtype in cases(cs):
        case = key(shape, dtype)
        for name, first in recs["change"][0]["cases"][case].items():
            bound = first["bound_ms"]
            share = (lambda side: f"{bound / med(side, case, name, 'device_ms'):.0%} of the "
                     "bound" if bound else "no bytes to move")
            cells = [f"{side} device {med(side, case, name, 'device_ms'):.4f} ms ({share(side)}),"
                     f" events {med(side, case, name, 'event_ms'):.4f}, L2 flushed "
                     f"{med(side, case, name, 'flushed_ms'):.4f}" for side in ("parent", "change")]
            lib = first.get("library_ms")
            ratio = med("change", case, name, "device_ms") / med("parent", case, name, "device_ms")
            print(f"[ab] {name} {case}: " + "; ".join(cells)
                  + f"; change / parent (device) {ratio:.3f}"
                  + (f"; torch.var_mean over (H, W) {lib:.4f} ms" if lib else "")
                  + f"; bound {bound:.4f} ms (bytes); medians of {len(recs['change'])} processes "
                  f"a side ({card})", flush=True)
            launches = cs.step_launches(shape, name)
            pair = next(p for p, legs in PAIRS.items() if name in legs)
            for side in recs:
                per_step[pair][side] += launches * med(side, case, name, "device_ms")
            step_bound[pair] += launches * bound
    for pair, legs in PAIRS.items():
        n = " + ".join(f"{leg} {sum(cs.step_launches(sh, leg) for sh, _ in cs.STEP_RANK_SLABS)}"
                       for leg in legs)
        print(f"[ab] {pair} per spatial rank-step ({n} launches at the step's rank slabs, "
              f"batch 2, fp32): parent {per_step[pair]['parent']:.4f} ms, change "
              f"{per_step[pair]['change']:.4f} ms of device time "
              f"({per_step[pair]['change'] / per_step[pair]['parent']:.3f}x); bound "
              f"{step_bound[pair]:.4f} ms ({card})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
