#!/usr/bin/env python3
"""Parent/change A/B of the PyTorch port's standard serving paths on one GPU.

    python3 tools/torch_port_serve_ab.py --parent DIR [--pairs N] [--requests N]

DIR is another checkout of the repo (e.g. the parent commit unpacked by
``git archive`` into a git-ignored directory). The script runs 2 x --pairs
fresh processes, in blocks of parent, change, change, parent; each one
imports ``jpdse_tpu_torch`` from its own checkout, builds its kernels and
serves --requests bf16 requests (batch 1, 1024x512, random weights from
--seed) on the kernel configuration's standard path (K3 at the 45 norm
sites) and then on the default standard path (no kernel), the same
process's control for host noise. Per request it records compress and
decompress time on the host clock and the host time spent in K3's wrapper
launches (``build.launch``, which holds the C launcher and its
``cudaLaunchCooperativeKernel`` or ``cudaLaunchKernel``); then one request
of the kernel path runs under torch.profiler, which gives the host time of
each CUDA launch API and the device's busy share. It prints one JSON line
per process and, at the end, each side's medians. Imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

H, W = 512, 1024
LAUNCH_APIS = ("cudaLaunchCooperativeKernel", "cudaLaunchKernel", "cudaLaunchKernelExC",
               "cuLaunchKernel", "cuLaunchKernelEx")


def child(repo: str, requests: int, seed: int) -> dict:
    """Serve both standard paths from ``repo``'s package; return the record."""
    sys.path.insert(0, os.path.abspath(repo))
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from jpdse_tpu_torch.config import flagship_config
    from jpdse_tpu_torch.models.codec import SemanticCodec
    from jpdse_tpu_torch.ops import build
    from jpdse_tpu_torch.serve import CodecServer

    build.build_all()
    k3_host = [0.0, 0]
    launch = build.launch

    def timed_launch(name, fn, t, *args):
        t0 = time.perf_counter()
        launch(name, fn, t, *args)
        if name == "fused_instance_norm":
            k3_host[0] += time.perf_counter() - t0
            k3_host[1] += 1

    build.launch = timed_launch
    rng = np.random.default_rng(seed + 1)
    batches = [{
        "label": rng.integers(0, 35, (1, H, W)).astype(np.float32),
        "instance": rng.integers(0, 1000, (1, H, W)).astype(np.int32),
        "image": rng.normal(size=(1, H, W, 3)).astype(np.float32),
    } for _ in range(requests)]
    state = SemanticCodec(flagship_config(), device="cuda", seed=seed).state_dict()
    record = {"repo": repo, "paths": {}}
    for label, kernels in (("kernel-standard", True), ("standard", False)):
        cfg = flagship_config(kernels=kernels)
        cfg.model.fast_inference = False
        server = CodecServer(cfg, state, device="cuda")
        torch.cuda.synchronize()
        rows = {"compress_ms": [], "decompress_ms": [], "k3_host_ms": [], "k3_calls": []}
        for batch in batches:
            k3_host[:] = [0.0, 0]
            t0 = time.perf_counter()
            codes = server.compress(batch)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            server.decompress(codes)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            rows["compress_ms"].append((t1 - t0) * 1e3)
            rows["decompress_ms"].append((t2 - t1) * 1e3)
            rows["k3_host_ms"].append(k3_host[0] * 1e3)
            rows["k3_calls"].append(k3_host[1])
        record["paths"][label] = rows
        if kernels:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                server.decompress(server.compress(batches[-1]))
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
            events = prof.key_averages()
            device = sum(e.self_device_time_total for e in events
                         if e.device_type == DeviceType.CUDA) / 1e3
            apis = {e.key: {"count": e.count, "host_ms": e.cpu_time_total / 1e3}
                    for e in events if e.key in LAUNCH_APIS}
            record["profile"] = {"wall_ms": wall, "device_ms": device,
                                 "busy": device / wall, "launch_apis": apis}
        del server
        torch.cuda.empty_cache()
    return record


def median_after_first(xs):
    return float(np.median(xs[1:] if len(xs) > 1 else xs))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="the other checkout to compare with")
    ap.add_argument("--pairs", type=int, default=8)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        print(json.dumps(child(args.child, args.requests, args.seed)), flush=True)
        return 0
    if not args.parent:
        ap.error("--parent is required")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sides = {"parent": os.path.abspath(args.parent), "change": here}
    order = [s for i in range(args.pairs)
             for s in (("parent", "change") if i % 2 == 0 else ("change", "parent"))]
    runs = {"parent": [], "change": []}
    for i, side in enumerate(order):
        out = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", sides[side],
                              "--requests", str(args.requests), "--seed", str(args.seed)],
                             capture_output=True, text=True, check=True, cwd=sides[side])
        rec = json.loads(out.stdout.strip().splitlines()[-1])
        runs[side].append(rec)
        line = {"run": i, "side": side}
        for label, rows in rec["paths"].items():
            line[label] = {k: round(median_after_first(v), 4) for k, v in rows.items()}
        prof = rec["profile"]
        line["profile"] = {"wall_ms": round(prof["wall_ms"], 3),
                           "device_ms": round(prof["device_ms"], 3),
                           "busy": round(prof["busy"], 4),
                           "launch_apis": {k: {"count": v["count"],
                                               "host_ms": round(v["host_ms"], 3),
                                               "host_us_per_call": round(
                                                   1e3 * v["host_ms"] / v["count"], 2)}
                                           for k, v in prof["launch_apis"].items()}}
        print(f"[ab] {json.dumps(line)}", flush=True)
        print(f"[ab] run {i} {side} per request, kernel-standard compress/decompress ms: "
              + ", ".join(f"{c:.2f}/{d:.2f}" for c, d in zip(
                  rec["paths"]["kernel-standard"]["compress_ms"],
                  rec["paths"]["kernel-standard"]["decompress_ms"])), flush=True)
    for side, recs in runs.items():
        for label in ("kernel-standard", "standard"):
            c = [median_after_first(r["paths"][label]["compress_ms"]) for r in recs]
            d = [median_after_first(r["paths"][label]["decompress_ms"]) for r in recs]
            print(f"[ab] {side} {label}: per-run medians compress "
                  f"{[round(x, 2) for x in c]}, decompress {[round(x, 2) for x in d]}; "
                  f"median of runs {np.median(c):.2f} / {np.median(d):.2f} ms ({card})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
