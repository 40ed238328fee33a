#!/usr/bin/env python3
"""Where the PyTorch port's serving time goes on one NVIDIA GPU.

    python3 tools/torch_port_stages.py [--seed N] [--iters N] [--path P]

Drives the flagship codec (Cityscapes 1024x512, batch 1, bf16, random
weights from --seed) through one of jpdse_tpu_torch's serving paths
(--path: 'fast', the default s2d fast path; 'kernel-fast', the fast path in
the kernel configuration, K1, K2 and K4; 'kernel-standard', the standard
path with K3; 'standard', the standard path without it) and prints:
  * for the fast paths, per-stage device time of compress and decompress
    (CUDA events around each _FastTrunk stage, median over --iters runs
    after a warm-up);
  * the top kernels by device time (with their launch counts), the
    device's busy share and the number of kernel launches over one
    compress + decompress, from torch.profiler.
Every line carries the card's name and power limit. Imports no JAX.
"""

from __future__ import annotations

import argparse
import functools
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

H, W = 512, 1024


def stage_times(fast, batch, iters: int):
    """Median ms of each stage of compress and decompress."""
    inputs = fast._inputs(batch)
    lab, img = inputs["input_label"], inputs["real_image"]
    e4l, e, g = fast.netE4label, fast.netE, fast.netG
    stages = {}

    def run(name, fn, *args):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(*args)
        end.record()
        stages.setdefault(name, []).append((start, end))
        return out

    def stage(trunk, name):  # a stage on the trunk's own weights
        return functools.partial(getattr(trunk, name), trunk.weights)

    with torch.inference_mode():
        for _ in range(iters + 1):
            run("compress: input assembly (one-hot, edges)", fast._inputs, batch)
            c1 = run("compress: netE4label front", stage(e4l, "front"), lab)
            c1 = run("compress: netE4label mid_down + binarizer",
                     lambda h: e4l.apply_binarizer(e4l.weights, e4l.mid_down(e4l.weights, h)), c1)
            c2 = run("compress: netE front", stage(e, "front"), img)
            c2 = run("compress: netE mid_down + binarizer",
                     lambda h: e.apply_binarizer(e.weights, e.mid_down(e.weights, h)), c2)
            l_ = run("decompress: netE4label mid_up", stage(e4l, "mid_up"), c1)
            l_ = run("decompress: netE4label back (K1 inside)", stage(e4l, "back"), l_)
            f_ = run("decompress: netE mid_up", stage(e, "mid_up"), c2)
            f_ = run("decompress: netE back (K1 inside)", stage(e, "back"), f_)
            x = torch.cat([l_, f_.to(l_.dtype)], dim=-1)
            h = run("decompress: netG front", stage(g, "front"), x)
            h = run("decompress: netG mid_down", stage(g, "mid_down"), h)
            h = run("decompress: netG res_blocks", stage(g, "res_blocks"), h)
            h = run("decompress: netG mid_up", stage(g, "mid_up"), h)
            run("decompress: netG back (K1 inside)", stage(g, "back"), h)
    torch.cuda.synchronize()
    # drop the first (warm-up) sample of each stage
    return {k: float(np.median([s.elapsed_time(e) for s, e in v[1:]])) for k, v in stages.items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--path", default="fast",
                    choices=("fast", "kernel-fast", "kernel-standard", "standard"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_port_stages: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]

    from jpdse_tpu_torch.config import flagship_config
    from jpdse_tpu_torch.models.codec import SemanticCodec
    from jpdse_tpu_torch.serve import CodecServer

    cfg = flagship_config(kernels=args.path.startswith("kernel"))
    cfg.model.fast_inference = not args.path.endswith("standard")
    server = CodecServer(cfg, SemanticCodec(cfg, device="cuda", seed=args.seed).state_dict(),
                         device="cuda")
    card = f"{args.path} path; {card}"
    rng = np.random.default_rng(args.seed + 1)
    batch = {
        "label": torch.from_numpy(rng.integers(0, 35, (1, H, W)).astype(np.float32)).cuda(),
        "instance": torch.from_numpy(rng.integers(0, 1000, (1, H, W)).astype(np.int32)).cuda(),
        "image": torch.from_numpy(rng.normal(size=(1, H, W, 3)).astype(np.float32)).cuda(),
    }
    times = stage_times(server.fast, batch, args.iters) if server.fast is not None else {}
    for part in ("compress", "decompress") if times else ():
        total = sum(v for k, v in times.items() if k.startswith(part))
        print(f"[stages] {part}: {total:.3f} ms in stages ({card})")
        for k, v in sorted(((k, v) for k, v in times.items() if k.startswith(part)),
                           key=lambda kv: -kv[1]):
            print(f"[stages]   {k[len(part) + 2:]}: {v:.3f} ms ({100 * v / total:.1f}%)")

    # one compress + decompress under the profiler: kernels by device time
    from torch.profiler import ProfilerActivity, profile

    codes = server.compress_codes(batch)
    server.decompress_codes(codes)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        server.decompress_codes(server.compress_codes(batch))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    from torch.autograd import DeviceType

    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    kernel_ms = sum(e.self_device_time_total for e in events) / 1e3
    if not events:
        print(f"[profile] no CUDA-typed events; entries with device time ({card}):")
        for e in sorted(prof.key_averages(), key=lambda e: -e.self_device_time_total)[:15]:
            print(f"[profile]   {e.self_device_time_total / 1e3:8.3f} ms  x{e.count:<4d} {e.key[:100]}")
        return 0
    launches = sum(e.count for e in events)
    print(f"[profile] compress + decompress: wall {wall_ms:.3f} ms, kernels {kernel_ms:.3f} ms, "
          f"device busy {100 * kernel_ms / wall_ms:.1f}%, {launches} kernel launches ({card})")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:15]:
        print(f"[profile]   {e.self_device_time_total / 1e3:8.3f} ms  x{e.count:<4d} {e.key[:100]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
