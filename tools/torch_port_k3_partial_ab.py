#!/usr/bin/env python3
"""Parent/change A/B of K3's partial-statistics stats and sums launches
(``instance_norm_stats``, ``instance_norm_bwd_sums``) on one GPU.

    python3 tools/torch_port_k3_partial_ab.py --parent DIR [--rounds N]

DIR is another checkout of the repo (e.g. the parent commit unpacked by
``git archive`` into a git-ignored directory). The script runs 4 x --rounds
fresh processes in blocks of parent, change, change, parent; each one
imports ``jpdse_tpu_torch`` from its own checkout, builds its kernels, and
times both launches at the spatial step's own rank slabs: every norm
level's rows halved (spatial 2) at batch 2 in fp32 (the training step) and
batch 1 in bf16 (serving), one rank's 21 of 43 rows and an empty slab in
fp32 (the uneven heights), and the hires recipe's rows in fp32. Each case is
first checked against the plain version (the count exact, mean and M2
within 1e-5 relative; sums within 1e-5 of their max-abs) and for two
launches bit-equal. Per case it records the profiler's device time a call,
the CUDA-event time a call over 20 back-to-back calls (x as a step finds
it, just read or written: in the 50 MB L2 where it fits), the event time
of a call made after a 64 MB scratch write has flushed the L2, and
``torch.var_mean`` over (H, W), the one PyTorch call that computes the
stats launch's function. It prints one JSON line per process and, at the
end, each side's medians beside the byte bound, and the device time summed
over one rank-step's launches at the step's slabs (the stats 90 times, the
sums 45, by the flagship's norm sites), with the card's name and power
limit. Imports no JAX.
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


def step_launches(cs, shape, name):
    """Launches a spatial rank-step makes at a batch-2 rank slab: the stats
    twice a norm site (block remat), the sums once (chip_smoke.K3_BWD_SITES)."""
    sites = sum(n for (site, _), n in cs.K3_BWD_SITES.items()
                if site == (2 * shape[1],) + shape[2:])
    return sites * (2 if name == "stats" else 1)


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
        st = k3.instance_norm_stats(x)
        want = k3.instance_norm_stats_plain(x)
        rel = ((st[..., 1:] - want[..., 1:]).abs() / want[..., 1:].abs().clamp_min(1.0))
        if (not torch.equal(st[..., 0], want[..., 0]) or rel.max().item() > 1e-5
                or not torch.equal(st, k3.instance_norm_stats(x))):
            raise AssertionError(f"stats {key(shape, dtype)}: differs from its plain version "
                                 "or from itself")
        # the sums on statistics of the whole slab (both ranks' rows the same)
        _, ms = k3.instance_norm_apply(x, None, torch.stack([st, st]), True)
        sums = k3.instance_norm_bwd_sums(x, g, ms, True)
        want = k3.instance_norm_bwd_sums_plain(x, g, ms, True)
        err = (sums - want).abs().max().item() if sums.numel() else 0.0
        if (err > 1e-5 * max(1.0, want.abs().max().item() if want.numel() else 0.0)
                or not torch.equal(sums, k3.instance_norm_bwd_sums(x, g, ms, True))):
            raise AssertionError(f"sums {key(shape, dtype)}: differs from its plain version "
                                 "or from itself")
        runs = {"stats": lambda: k3.instance_norm_stats(x),
                "sums": lambda: k3.instance_norm_bwd_sums(x, g, ms, True)}
        case = {}
        for name, fn in runs.items():
            case[name] = {"device_ms": cs.device_ms(fn), "event_ms": cs.cuda_ms(fn),
                          "flushed_ms": cs.flushed_ms(fn)}
        case["stats"]["library_ms"] = cs.cuda_ms(
            lambda: torch.var_mean(x, dim=(1, 2), correction=0)) if x.numel() else None
        case["stats"]["bound_ms"] = cs.bytes_ms(x)
        case["sums"]["bound_ms"] = cs.bytes_ms(x, g)
        record["cases"][key(shape, dtype)] = case
        del x, g, st, ms, sums, want
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

    per_step = {side: 0.0 for side in recs}
    step_bound = 0.0
    for shape, dtype in cases(cs):
        case = key(shape, dtype)
        for name in ("stats", "sums"):
            bound = recs["change"][0]["cases"][case][name]["bound_ms"]
            share = (lambda side: f"{bound / med(side, case, name, 'device_ms'):.0%} of the "
                     "bound" if bound else "no bytes to move")
            cells = [f"{side} device {med(side, case, name, 'device_ms'):.4f} ms ({share(side)}),"
                     f" events {med(side, case, name, 'event_ms'):.4f}, L2 flushed "
                     f"{med(side, case, name, 'flushed_ms'):.4f}" for side in ("parent", "change")]
            lib = recs["change"][0]["cases"][case][name].get("library_ms")
            ratio = med("change", case, name, "device_ms") / med("parent", case, name, "device_ms")
            print(f"[ab] {name} {case}: " + "; ".join(cells)
                  + f"; change / parent (device) {ratio:.3f}"
                  + (f"; torch.var_mean over (H, W) {lib:.4f} ms" if lib else "")
                  + f"; bound {bound:.4f} ms (bytes); medians of {len(recs['change'])} processes "
                  f"a side ({card})", flush=True)
            if shape[0] == 2:
                sites = step_launches(cs, shape, name)
                for side in recs:
                    per_step[side] += sites * med(side, case, name, "device_ms")
                step_bound += sites * bound
    print(f"[ab] stats and sums per spatial rank-step (90 + 45 launches at the step's rank "
          f"slabs, batch 2, fp32): parent {per_step['parent']:.4f} ms, change "
          f"{per_step['change']:.4f} ms of device time; bound {step_bound:.4f} ms ({card})",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
