#!/usr/bin/env python3
"""Parent/change A/B of the re-alignment kernels K1 and K2 on one GPU.

    python3 tools/torch_port_realign_ab.py --parent DIR [--rounds N]

DIR is another checkout of the repo (e.g. the parent commit unpacked by
``git archive`` into a git-ignored directory). The script runs 2 x --rounds
fresh processes in blocks of parent, change, change, parent; each one
imports ``jpdse_tpu_torch.ops.realign`` from its own checkout, builds it,
and times K2 (``s2d_pad3``) at (1, 512, 1024, C) for C = 3, 36, 39 in bf16
and C = 3 in fp32, and K1 (``s2d_realign_pad3``) at (1, 256, 512, 256) in
bf16, each checked bit-exact against its plain version first. Per shape it
records the profiler's device time a call, the CUDA-event time a call over
20 back-to-back calls, and the host's time a call. It prints one JSON line
per process and, at the end, each side's medians beside the byte bound and
the card's name and power limit. Imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

MEM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (data sheet)
K2_SHAPES = [((1, 512, 1024, 3), "bfloat16"), ((1, 512, 1024, 36), "bfloat16"),
             ((1, 512, 1024, 39), "bfloat16"), ((1, 512, 1024, 3), "float32")]
K1_SHAPE = ((1, 256, 512, 256), "bfloat16")


def child(repo: str) -> dict:
    sys.path.insert(0, os.path.abspath(repo))
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from jpdse_tpu_torch.ops import build, realign

    build.build_all(["realign"])

    def device_ms(fn, iters=10):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        return sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA) / 1e3 / iters

    def event_ms(fn, iters=20):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    def host_ms(fn, iters=50):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        return (t1 - t0) / iters * 1e3

    gen = torch.Generator(device="cuda").manual_seed(0)
    record = {"repo": repo, "k2": {}, "k1": {}}
    cases = [("k2", s, d, realign.s2d_pad3, realign.s2d_pad3_plain) for s, d in K2_SHAPES]
    cases.append(("k1", *K1_SHAPE, realign.s2d_realign_pad3, realign.s2d_realign_pad3_plain))
    for kind, shape, dtype, fn, plain in cases:
        x = torch.randn(shape, device="cuda", generator=gen).to(getattr(torch, dtype))
        out = fn(x)
        if not torch.equal(out, plain(x)):
            raise AssertionError(f"{kind} differs from its plain version at {shape} {dtype}")
        nbytes = (x.numel() + out.numel()) * x.element_size()
        record[kind][f"{shape} {dtype}"] = {
            "device_ms": device_ms(lambda: fn(x)), "event_ms": event_ms(lambda: fn(x)),
            "host_ms": host_ms(lambda: fn(x)), "bound_ms": nbytes / MEM_BYTES_PER_S * 1e3}
    return record


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="the other checkout to compare with")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        print(json.dumps(child(args.child)), flush=True)
        return 0
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[0]
    order = []
    for _ in range(args.rounds):
        order += [("parent", args.parent), ("change", here), ("change", here),
                  ("parent", args.parent)]
    recs = {"parent": [], "change": []}
    for i, (side, repo) in enumerate(order):
        out = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", repo],
                             capture_output=True, text=True, timeout=600)
        if out.returncode != 0:
            print(out.stdout, out.stderr, file=sys.stderr)
            raise RuntimeError(f"run {i} ({side}) failed")
        rec = json.loads(out.stdout.strip().splitlines()[-1])
        recs[side].append(rec)
        print(f"[ab] run {i} {side}: {json.dumps(rec)}", flush=True)
    for kind in ("k2", "k1"):
        for shape in recs["change"][0][kind]:
            cells = []
            for side in ("parent", "change"):
                rows = [r[kind][shape] for r in recs[side]]
                med = {k: float(np.median([row[k] for row in rows]))
                       for k in ("device_ms", "event_ms", "host_ms")}
                cells.append(f"{side} device {med['device_ms'] * 1e3:.2f} us, events "
                             f"{med['event_ms'] * 1e3:.2f} us, host {med['host_ms'] * 1e3:.2f} us")
            bound = recs["change"][0][kind][shape]["bound_ms"]
            print(f"[ab] {kind.upper()} {shape}: " + "; ".join(cells)
                  + f"; bound {bound * 1e3:.2f} us (bytes); medians of {len(recs['change'])} "
                  f"processes a side ({card})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
