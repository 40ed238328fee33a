#!/usr/bin/env python3
"""Parent/change A/B of K3's backward (``fused_instance_norm_bwd``) on one GPU.

    python3 tools/torch_port_k3_bwd_ab.py --parent DIR [--rounds N] [--train-steps N]

DIR is another checkout of the repo (e.g. the parent commit unpacked by
``git archive`` into a git-ignored directory). The script runs 4 x --rounds
fresh processes in blocks of parent, change, change, parent; each one
imports ``jpdse_tpu_torch`` from its own checkout, builds its kernels, and
times the backward kernel on the forward's statistics at every norm shape
of the flagship: batch 1 in bf16 (the serving shapes) and batch 2 in fp32
(the training step's), each with and without the ReLU (the residual form
runs the same kernel as the bare norm). Each case is first checked against
the plain version on the same statistics (fp32 within 1e-5, bf16 within one
ulp beyond that). Per case it records the profiler's device time a call,
the CUDA-event time a call over 20 back-to-back calls, the event time of a
call made after a 64 MB scratch write has flushed the L2, and the backward
of ``F.instance_norm`` on the same tensor. With --train-steps N > 0 each
process also times N steps of the flagship's phase-2 recipe in the kernel
configuration (``chip_smoke.flagship_train_config``) and profiles one more:
the device time of all its kernels, and K3's forward and backward. It prints one JSON
line per process and, at the end, each side's medians beside the byte
bound, the launch-weighted sum over a training step's 45 backward sites,
and the card's name and power limit. Imports no JAX.
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
LEVELS = [(512, 1024, 64), (256, 512, 128), (128, 256, 256), (64, 128, 512), (32, 64, 1024)]
CASES = ([((1,) + s, "bfloat16", relu) for s in LEVELS for relu in (True, False)]
         + [((2,) + s, "float32", relu) for s in LEVELS for relu in (True, False)])
# the training step's backward launches by level and ReLU (netG 27, netE 9,
# netE4label 9: every head, down and up site has the ReLU; the res blocks'
# second norm takes the residual instead)
STEP_SITES = {(s, True): 6 for s in LEVELS[:4]}
STEP_SITES.update({(LEVELS[4], True): 12, (LEVELS[4], False): 9})


def key(shape, dtype, relu) -> str:
    return f"{tuple(shape)} {dtype} relu={relu}"


def child(repo: str, train_steps: int) -> dict:
    sys.path.insert(0, os.path.abspath(repo))
    import torch
    import torch.nn.functional as F
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from jpdse_tpu_torch.ops import build
    from jpdse_tpu_torch.ops import instance_norm as k3

    build.build_all()

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

    scratch = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")

    def flushed_ms(fn, iters=10):
        """Event time of one call after the L2 is flushed, mean of `iters`."""
        fn()
        pairs = []
        for i in range(iters):
            scratch.fill_(i)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            pairs.append((start, end))
        torch.cuda.synchronize()
        return float(np.mean([s.elapsed_time(e) for s, e in pairs]))

    gen = torch.Generator(device="cuda").manual_seed(0)
    record = {"repo": repo, "cases": {}}
    for shape, dtype, relu in CASES:
        x = (torch.randn(shape, device="cuda", generator=gen) * 3 + 1).to(getattr(torch, dtype))
        g = torch.randn(shape, device="cuda", generator=gen).to(x.dtype)
        _, stats = k3._forward(x, None, relu, 1e-5)

        def fn():
            return k3.fused_instance_norm_bwd(x, g, stats, relu)

        got, want = fn(), k3.fused_instance_norm_bwd_plain(x, g, relu, stats=stats)
        err = (got.float() - want.float()).abs()
        if dtype == "float32":
            bad = err.max().item() > 1e-5
        else:
            mag = torch.maximum(got.float().abs(), want.float().abs()).clamp_min(1e-30)
            bad = ((err - 1e-5).clamp_min(0) / torch.exp2(torch.floor(torch.log2(mag)) - 7)
                   ).max().item() > 1.0
        if bad or not torch.equal(got, fn()):
            raise AssertionError(f"{key(shape, dtype, relu)}: the kernel differs from its plain "
                                 f"version ({err.max().item():.3e}) or from itself")
        xc = x.permute(0, 3, 1, 2).detach().requires_grad_()
        yc = F.instance_norm(xc, eps=1e-5)
        gc = g.permute(0, 3, 1, 2)
        record["cases"][key(shape, dtype, relu)] = {
            "device_ms": device_ms(fn), "event_ms": event_ms(fn), "flushed_ms": flushed_ms(fn),
            "library_ms": event_ms(lambda: torch.autograd.grad(yc, xc, gc, retain_graph=True)),
            "bound_ms": 3 * x.numel() * x.element_size() / MEM_BYTES_PER_S * 1e3,
            "max_abs_err": err.max().item()}
        del x, g, stats, got, want, xc, yc, gc
    if train_steps > 0:
        record["train"] = train(repo, train_steps)
    return record


def train(repo: str, steps: int) -> dict:
    """Steps of the kernel configuration's phase-2 recipe from this
    checkout's chip_smoke.py: host-clock times, the median after the first,
    and one profiled step's device time of K3's forward and backward."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    from jpdse_tpu_torch.trainer import Trainer

    trainer = Trainer(chip_smoke.flagship_train_config(True, 0), mode="train", device="cuda")
    batches = [chip_smoke.make_batch(100 + i, chip_smoke.TRAIN_BATCH) for i in range(steps)]
    times = []
    for b in batches:
        t0 = time.perf_counter()
        trainer.step(b)
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        trainer.step(batches[-1])
        torch.cuda.synchronize()
    k3 = {"forward": 0.0, "backward": 0.0, "all kernels": 0.0}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            k3["all kernels"] += e.self_device_time_total / 1e3
            if "instance_norm" in e.key:
                k3["backward" if "bwd" in e.key else "forward"] += e.self_device_time_total / 1e3
    return {"steps_ms": times, "median_ms": float(np.median(times[1:] if steps > 1 else times)),
            "k3_device_ms": k3}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="the other checkout to compare with")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--train-steps", type=int, default=0)
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        print(json.dumps(child(args.child, args.train_steps)), flush=True)
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
        out = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", repo,
                              "--train-steps", str(args.train_steps)],
                             capture_output=True, text=True, timeout=900)
        if out.returncode != 0:
            print(out.stdout[-4000:], out.stderr[-4000:], file=sys.stderr)
            raise RuntimeError(f"run {i} ({side}) failed")
        rec = json.loads(out.stdout.strip().splitlines()[-1])
        recs[side].append(rec)
        print(f"[ab] run {i} {side}: {json.dumps(rec)}", flush=True)

    def med(side, case, what):
        return float(np.median([r["cases"][case][what] for r in recs[side]]))

    per_step = {side: 0.0 for side in recs}
    step_bound = 0.0
    for shape, dtype, relu in CASES:
        case = key(shape, dtype, relu)
        bound = recs["change"][0]["cases"][case]["bound_ms"]
        cells = [f"{side} device {med(side, case, 'device_ms'):.4f} ms ("
                 f"{bound / med(side, case, 'device_ms'):.0%} of the bound), events "
                 f"{med(side, case, 'event_ms'):.4f}, L2 flushed {med(side, case, 'flushed_ms'):.4f}"
                 for side in ("parent", "change")]
        print(f"[ab] K3 backward {case}: " + "; ".join(cells)
              + f"; change / parent (device) "
              f"{med('change', case, 'device_ms') / med('parent', case, 'device_ms'):.3f}; "
              f"backward of F.instance_norm {med('change', case, 'library_ms'):.4f} ms; bound "
              f"{bound:.4f} ms (bytes: x and g read, dx written); medians of "
              f"{len(recs['change'])} processes a side ({card})", flush=True)
        sites = STEP_SITES.get((shape[1:], relu), 0) if shape[0] == 2 else 0
        for side in recs:
            per_step[side] += sites * med(side, case, "device_ms")
        step_bound += sites * bound
    print(f"[ab] K3 backward per training step (45 launches, batch 2, fp32, weighted by "
          f"site): parent {per_step['parent']:.4f} ms, change {per_step['change']:.4f} ms of "
          f"device time; bound {step_bound:.4f} ms ({card})", flush=True)
    if args.train_steps > 0:
        for side in ("parent", "change"):
            tr = [r["train"] for r in recs[side]]
            print(f"[ab] kernel config training step, {side}: medians "
                  + ", ".join(f"{t['median_ms']:.1f}" for t in tr) + " ms; device ms in one "
                  "profiled step (all kernels / K3 forward / K3 backward): " + ", ".join(
                      f"{t['k3_device_ms']['all kernels']:.1f} / {t['k3_device_ms']['forward']:.2f}"
                      f" / {t['k3_device_ms']['backward']:.2f}" for t in tr) + f" ({card})",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
