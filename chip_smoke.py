#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--requests N] [--train-steps N]

Phases, each printing a line as it ends:
  1. environment: the card's name and power limit, torch and CUDA versions;
  2. build: every kernel under jpdse_tpu_torch/csrc/ with nvcc and the
     host range coder with g++, in parallel; the coder's pack and unpack
     of a flagship-sized code timed on the host;
  3. kernels: each kernel (K1 grid re-alignment, K2 front pad + s2d, K3
     fused InstanceNorm, K4 s2d head conv) against its plain PyTorch version
     on the card at the serving paths' shapes, in fp32 and bf16 (bit-exact
     for data movement), and timed beside its bound and, where one PyTorch
     call computes the same function, that call (K2 and K3 also by the
     profiler's device time and the host's time a call); K3 shown to be one
     launch per call (profiler) and tried under CUDA-graph capture; K3's
     backward against its plain version at the same shapes (one device
     kernel per call; timed at the largest slab in bf16 back to back and
     after an L2 flush, beside the backward of F.instance_norm, and at each
     training shape in fp32 beside its bound; its CUDA-graph replay
     bit-equal to the eager call); K4's dense-A mode against torch.matmul;
  4. the flagship codec at full width (Cityscapes 1024x512, random weights
     from --seed), fp32 with TF32 off: the default s2d fast path, the fast
     path in the kernel configuration (K1, K2, K4) and the standard path
     with K3, each against the port's default standard path;
  5. serving: a CodecServer answers --requests bf16 requests on each of
     four paths, the default fast path, the kernel configuration's fast
     path and its standard path, and the default standard path: compress
     to one .jpds stream, decompress the image from the stream alone, and
     the same through the tensor API (compress_codes, decompress_codes),
     whose codes must equal the stream's; with every kernel's launch count
     set to 0 just before a path and read just after, and asserted per
     call; stream bytes, bpp, the device part and the host coder's pack
     and unpack times are printed beside the totals;
  6. eval and deploy: a synthetic Cityscapes val split (4 triplets at
     2048x1024, from --seed) read with the flagship's preprocessing
     ('fixed' to 1024x512), the flagship's opt.json and the seeded codec's
     params_g.pt; the port's entry points test.main, compress.main and
     decompress.main run in-process on the default fast path, the kernel
     configuration's fast path (K1, K2, K4) and its standard path (K3),
     with every kernel's count set to 0 just before each entry point and
     read just after, asserted per image; finite metrics, the .rc and .jpds
     bytes against the reported rates, each decompressed PNG within one
     uint8 level of the test run's reconstruction, and each image's
     host-clock split (load, device, coder, metrics, gallery) printed;
  7. training: the flagship's phase-2 GAN recipe
     (artifacts/flagship_r3/phase2/opt.json: batch 2 at 1024x512, fp32, block
     remat, VGG, feature matching, distortion) at full width, in the default
     configuration and the kernel configuration (K3 forward and backward at
     the 45 generator-side norm sites): (a) one loss_and_grads of each from
     the same weights and generator seed, fp32 with TF32 off, metrics and
     every gradient tensor held against each other, binarizer bits near
     their threshold counted; (b) --train-steps Trainer.steps of each, with
     PyTorch's default precision (TF32 convolutions): median step time,
     images/s, peak memory, finite losses and K3's launches per step, then
     one profiled step with K3's forward and backward as separate groups;
     (c) the entry point, train.run.main, on a synthetic Cityscapes
     train/val split: one epoch of 2 steps with validation and a best-val
     save, then a second main that resumes, validates the load and writes
     save_dir/latest;
  8. the flagship's phase-1 recipe (artifacts/flagship_r3/phase1/opt.json:
     no netE, netG fed by netE4label's one code, no distortion loss) at full
     width: (a) and (b) as in 7, with K3 at its 36 norm sites (72 forward
     and 36 backward launches a step); (c) the phase chain through
     train.run.main: phase 1 with a save, phase 2 restored from it (the
     matched-leaf count held against the state dicts' names and shapes),
     phase 1 with --max_host_rss_gb 0.001 (exit 75, save_dir/latest) and a
     second main that resumes from latest; (d) the phase-1 codec's codes and
     fp32 images on three paths against the default standard path, then
     --requests bf16 requests served through one-code .jpds streams on the
     four paths of 5, launches asserted per call; (e) a codec with the
     generator's bottleneck binarized (after its residual blocks, the
     encoders unbinarized) at the flagship's widths: one compress and
     decompress in fp32 on the standard and the fast path, codes equal and
     images within 1e-3;
  9. summary: the card, a JSON line of per-kernel numbers, the total
     seconds, and a last line {"ok": true, "device": {...}}.

Any failure raises and the script exits non-zero without the last line.
Without CUDA it exits non-zero before doing anything. Imports no JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

H, W = 512, 1024
FP32_ATOL = 1e-3
MEM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (data sheet)
BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak (data sheet)
# K3 at every distinct norm shape of the standard path (batch 1, 1024x512):
# heads and last ups, then the downs / ups, then the res blocks
NORM_SHAPES = [(1, 512, 1024, 64), (1, 256, 512, 128), (1, 128, 256, 256),
               (1, 64, 128, 512), (1, 32, 64, 1024)]
# the same sites in the training step (batch 2): the kernels' partition
# into slabs and chunks depends on the batch
TRAIN_NORM_SHAPES = [(2,) + s[1:] for s in NORM_SHAPES]
NORM_COMBOS = [(True, False), (False, True), (False, False)]  # (relu, residual)
# K3's backward launches in a training step, by (H, W, C) and ReLU: netG 27,
# netE 9 and netE4label 9; every head, down and up site and each res block's
# first norm has the ReLU, each res block's second takes the residual
K3_BWD_SITES = {(s[1:], True): 6 for s in NORM_SHAPES[:4]}
K3_BWD_SITES.update({(NORM_SHAPES[4][1:], True): 12, (NORM_SHAPES[4][1:], False): 9})
KERNELS = {  # wrapper -> (its module under jpdse_tpu_torch/ops and csrc/, the TPU kernel)
    "s2d_realign_pad3": ("realign", "jpdse_tpu/ops/pallas/realign.py:67"),
    "s2d_pad3": ("realign", "jpdse_tpu/ops/pallas/realign.py:137"),
    "fused_instance_norm": ("instance_norm", "jpdse_tpu/ops/pallas/instance_norm.py:125"),
    "fused_instance_norm_bwd": ("instance_norm", "jpdse_tpu/ops/pallas/instance_norm.py:100"),
    "head_conv_s2d": ("head_conv", "jpdse_tpu/ops/pallas/head_conv.py:90"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def wrappers() -> dict:
    """Each kernel's wrapper, whose ``launches`` attribute counts launches."""
    import importlib

    return {name: getattr(importlib.import_module(f"jpdse_tpu_torch.ops.{mod}"), name)
            for name, (mod, _) in KERNELS.items()}


def reset_counts() -> None:
    for fn in wrappers().values():
        fn.launches = 0


def read_counts() -> dict:
    return {name: fn.launches for name, fn in wrappers().items()}


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() in ms, by CUDA events around `iters` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def flushed_ms(fn, iters: int = 10) -> float:
    """Mean device time of one fn() call made after a 64 MB scratch write
    has flushed the 50 MB L2, by CUDA events around the call alone."""
    scratch = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")
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
    return float(np.mean([a.elapsed_time(b) for a, b in pairs]))


def device_ms(fn, iters: int = 10) -> float:
    """Device time of one fn() call in ms from the profiler, for an fn that
    launches each of its kernels once: each kernel's mean over the launches
    the profiler recorded, summed. What the card spends, without the host's
    launch time; a launch the profiler drops moves no mean."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total / e.count for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.count) / 1e3


def host_ms(fn, iters: int = 50) -> float:
    """Host time per call of fn() when the card keeps up: the wrapper's
    Python, its allocations and the launch itself, in ms."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / iters * 1e3


def bytes_ms(*tensors) -> float:
    """Least time to read or write each tensor once at the memory rate."""
    return sum(t.numel() * t.element_size() for t in tensors) / MEM_BYTES_PER_S * 1e3


def dt(dtype) -> str:
    return str(dtype)[6:]


def make_batch(seed: int, b: int = 1):
    """A synthetic Cityscapes-like request, as __graft_entry__._batch makes
    it: labels in [0, 35), instance ids, a normal-distributed image."""
    rng = np.random.default_rng(seed)
    return {
        "label": rng.integers(0, 35, (b, H, W)).astype(np.float32),
        "instance": rng.integers(0, 1000, (b, H, W)).astype(np.int32),
        "image": rng.normal(size=(b, H, W, 3)).astype(np.float32),
    }


def kernel_entry(name: str, max_err: float, k: float, p: float, bound_ms: float,
                 bound_by: str, library_ms) -> dict:
    mod, replaces = KERNELS[name]
    return {
        "name": name, "route": "cuda", "source": f"jpdse_tpu_torch/csrc/{mod}.cu",
        "replaces": replaces, "max_abs_err": max_err, "ms": k, "plain_ms": p,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
    }


def phase_k1(card: str, gen) -> dict:
    """K1 against its plain version; returns its numbers for the summary."""
    from jpdse_tpu_torch.ops import realign

    dev = "cuda"
    max_err = 0.0
    cases = [
        ((2, 256, 512, 256), torch.float32, 0, None),
        ((2, 256, 512, 256), torch.bfloat16, 0, None),
        ((1, 5, 7, 20), torch.float32, 0, None),  # odd ws, C=5: the element-wise path
        ((1, 5, 7, 20), torch.bfloat16, 0, None),
        ((1, 8, 7, 20), torch.float32, 4, 24),
        ((2, 16, 20, 256), torch.bfloat16, 4, None),
        # K4's producer: s2d of the netG / netE4label fine inputs, 1 extra
        # row, channels padded to a multiple of 8
        ((1, 256, 512, 156), torch.bfloat16, 1, 160),
        ((1, 256, 512, 156), torch.float32, 1, 160),
        ((1, 256, 512, 144), torch.bfloat16, 1, 144),
    ]
    for shape, dtype, extra, channels in cases:
        y = torch.randn(shape, device=dev, generator=gen).to(dtype)
        got = realign.s2d_realign_pad3(y, extra, channels)
        want = realign.s2d_realign_pad3_plain(y, extra, channels)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"K1 differs from its plain version at {shape} {dtype} "
                                 f"extra_rows={extra} channels={channels}")
        max_err = max(max_err, (got.float() - want.float()).abs().max().item())
        log(f"[kernels] K1 s2d_realign_pad3 {tuple(shape)} {dt(dtype)} "
            f"extra_rows={extra} channels={channels}: bit-exact (torch.equal)")

    def timed(shape, dtype):
        y = torch.randn(shape, device=dev, generator=gen).to(dtype)
        k = cuda_ms(lambda: realign.s2d_realign_pad3(y))
        p = cuda_ms(lambda: realign.s2d_realign_pad3_plain(y))
        out_numel = shape[0] * (shape[1] + 3) * (shape[2] + 3) * shape[3]
        bound_ms = (y.numel() + out_numel) * y.element_size() / MEM_BYTES_PER_S * 1e3
        log(f"[kernels] K1 {tuple(shape)} {dt(dtype)}: kernel {k:.4f} ms, "
            f"plain {p:.4f} ms, bound {bound_ms * 1e3:.1f} us (bytes) ({card})")
        return k, p, bound_ms

    timed((2, 256, 512, 256), torch.float32)
    timed((2, 256, 512, 256), torch.bfloat16)
    # the serving path's own shape: B=1, bf16
    k, p, bound_ms = timed((1, 256, 512, 256), torch.bfloat16)
    return kernel_entry("s2d_realign_pad3", max_err, k, p, bound_ms, "bytes", None)


def phase_k2(card: str, gen) -> dict:
    """K2 bit-exact against its plain version at the fronts' channel counts
    (netE C=3; netE4label C=36 and netG C=39 when K4 is off), both dtypes,
    with and without extra rows, and at the edge shapes of its tiling (W 4
    and 6, C 1 and 5, B=2, the largest extra_rows, an input that starts
    off a 16-byte boundary; the output's tiles start off one anyway);
    timed at (1, 512, 1024, C) for C=3, 36, 39 in bf16 and C=3 in fp32 by
    CUDA events, by the profiler's device time and by the host's time a
    call."""
    from jpdse_tpu_torch.ops import realign

    def check(x, extra, what):
        got = realign.s2d_pad3(x, extra)
        want = realign.s2d_pad3_plain(x, extra)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"K2 differs from its plain version at {what}")

    for c in (3, 36, 39):
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn((1, H, W, c), device="cuda", generator=gen).to(dtype)
            for extra in (0, 1):
                check(x, extra, f"C={c} {dtype} extra_rows={extra}")
            log(f"[kernels] K2 s2d_pad3 (1, {H}, {W}, {c}) {dt(dtype)} extra_rows=0,1: "
                "bit-exact (torch.equal)")
    for shape in ((2, 8, 4, 1), (2, 8, 6, 5), (2, 6, 4, 39), (2, 8, 1024, 3), (2, 10, 6, 36)):
        h = shape[1]
        extra = h // 2 - 2  # the largest the reflection allows
        for dtype in (torch.float32, torch.bfloat16):
            n = int(np.prod(shape))
            flat = torch.randn((n + 1,), device="cuda", generator=gen).to(dtype)
            for x, where in ((flat[:n].view(shape), "aligned"),
                             (flat[1:].view(shape), "input 1 element off 16 bytes")):
                check(x, extra, f"{shape} {dtype} extra_rows={extra}, {where}")
        log(f"[kernels] K2 s2d_pad3 {shape} fp32, bf16 extra_rows={extra}, aligned and "
            "unaligned input: bit-exact (torch.equal)")

    times = {}
    for c, dtype in ((3, torch.bfloat16), (36, torch.bfloat16), (39, torch.bfloat16),
                     (3, torch.float32)):
        x = torch.randn((1, H, W, c), device="cuda", generator=gen).to(dtype)
        k = cuda_ms(lambda: realign.s2d_pad3(x))
        k_dev = device_ms(lambda: realign.s2d_pad3(x))
        k_host = host_ms(lambda: realign.s2d_pad3(x))
        p = cuda_ms(lambda: realign.s2d_pad3_plain(x))
        out = realign.s2d_pad3(x)  # extra_rows=0, as timed
        bound = bytes_ms(x, out)
        # a contiguous copy of as many bytes: what any kernel that moves them
        # takes on this card, launch included
        half = (x.numel() + out.numel()) // 2
        src, dst = torch.empty(half, dtype=dtype, device="cuda"), torch.empty(half, dtype=dtype,
                                                                            device="cuda")
        copy_dev = device_ms(lambda: dst.copy_(src))
        times[c, dtype] = (k, p, bound, k_dev, k_host, copy_dev)
        log(f"[kernels] K2 (1, {H}, {W}, {c}) {dt(dtype)}: on the device {k_dev * 1e3:.2f} us by "
            f"the profiler ({bound / k_dev:.0%} of its bound), events {k * 1e3:.2f} us a call, "
            f"host {k_host * 1e3:.2f} us a call; plain {p:.4f} ms; bound {bound * 1e3:.2f} us "
            f"(bytes); a copy_ of as many bytes {copy_dev * 1e3:.2f} us on the device ({card})")
    k, p, bound, k_dev, k_host, copy_dev = times[3, torch.bfloat16]
    entry = kernel_entry("s2d_pad3", 0.0, k, p, bound, "bytes", None)
    entry["device_ms"] = k_dev
    entry["host_ms"] = k_host
    entry["copy_device_ms"] = copy_dev
    entry["device_ms_by_shape"] = {f"(1, {H}, {W}, {c}) {dt(d)}": v[3]
                                   for (c, d), v in times.items()}
    return entry


def bf16_excess_ulps(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest difference in bf16 ulps of the larger output magnitude, after
    the fp32 tolerance (1e-5) that the statistics carry is taken off. Where
    x - mean or norm + residual cancels, the output is far smaller than the
    terms, and a last-digit difference of the fp32 statistics is many of its
    own ulps (measured: 37 and 216 ulps at (1, 512, 1024, 64)); beyond that
    difference, the one cast may round differently by one ulp."""
    g, w = got.float(), want.float()
    mag = torch.maximum(g.abs(), w.abs()).clamp_min(1e-30)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return (((g - w).abs() - 1e-5).clamp_min(0) / ulp).max().item()


def phase_k3(card: str, gen) -> dict:
    """K3 at every distinct norm shape of the standard path and of the
    training step, for each (relu, residual) the modules use plus the bare
    norm: fp32 within 1e-5 abs of the plain version, bf16 within 1 ulp
    beyond that (see bf16_excess_ulps); deterministic; timed in bf16 beside
    F.instance_norm for the bare norm at the serving shapes."""
    from jpdse_tpu_torch.ops import instance_norm as k3

    max_err = 0.0
    entry = None
    for shape in NORM_SHAPES + TRAIN_NORM_SHAPES:
        base = torch.randn(shape, device="cuda", generator=gen) * 3 + 1
        res32 = torch.randn(shape, device="cuda", generator=gen)
        for dtype in (torch.float32, torch.bfloat16):
            x = base.to(dtype)
            for relu, has_res in NORM_COMBOS:
                res = res32.to(dtype) if has_res else None
                got = k3.fused_instance_norm(x, res, relu=relu)
                again = k3.fused_instance_norm(x, res, relu=relu)
                want = k3.fused_instance_norm_plain(x, res, relu=relu)
                torch.cuda.synchronize()
                if not torch.equal(got, again):
                    raise AssertionError(f"K3 not deterministic at {shape} {dtype}")
                err = (got.float() - want.float()).abs().max().item()
                what = f"K3 {shape} {dt(dtype)} relu={relu} residual={has_res}"
                if dtype == torch.float32:
                    max_err = max(max_err, err)
                    if not err <= 1e-5:
                        raise AssertionError(f"{what}: max abs diff {err} > 1e-5")
                    log(f"[kernels] {what}: max abs diff {err:.2e} (tolerance 1e-5); "
                        "two runs bit-equal")
                else:
                    u = bf16_excess_ulps(got, want)
                    if not u <= 1.0:
                        raise AssertionError(f"{what}: {u} bf16 ulps beyond 1e-5 from the plain "
                                             "version")
                    log(f"[kernels] {what}: max abs diff {err:.2e}, max {u:.2f} bf16 ulp "
                        "beyond 1e-5 (tolerance 1); two runs bit-equal")
        if shape in TRAIN_NORM_SHAPES:
            continue
        # timing, bf16: the bare norm beside the library's InstanceNorm, and
        # the sites' own (relu) and (residual) forms
        x = base.to(torch.bfloat16)
        res = res32.to(torch.bfloat16)
        xc = x.permute(0, 3, 1, 2)  # NCHW view of the channels-last tensor
        k = cuda_ms(lambda: k3.fused_instance_norm(x))
        p = cuda_ms(lambda: k3.fused_instance_norm_plain(x))
        lib = cuda_ms(lambda: F.instance_norm(xc, eps=1e-5))
        k_relu = cuda_ms(lambda: k3.fused_instance_norm(x, relu=True))
        k_res = cuda_ms(lambda: k3.fused_instance_norm(x, res))
        p_relu = cuda_ms(lambda: k3.fused_instance_norm_plain(x, relu=True))
        k_dev = device_ms(lambda: k3.fused_instance_norm(x))
        k_host = host_ms(lambda: k3.fused_instance_norm(x))
        bound = bytes_ms(x, x)
        log(f"[kernels] K3 {shape} bf16: kernel {k:.4f} ms (relu {k_relu:.4f}, residual "
            f"{k_res:.4f}; on the device {k_dev:.4f} ms by the profiler; host {k_host:.4f} ms "
            f"a call), plain {p:.4f} ms (relu {p_relu:.4f}), F.instance_norm "
            f"{lib:.4f} ms, bound {bound * 1e3:.1f} us (bytes; residual form "
            f"{bytes_ms(x, x, x) * 1e3:.1f} us) ({card})")
        if entry is None:  # the largest slab: the heads' and last ups' sites
            entry = (k, p, bound, lib)
            k3_launch_facts(k3, x, res)
    k, p, bound, lib = entry
    return kernel_entry("fused_instance_norm", max_err, k, p, bound, "bytes", lib)


def one_kernel(what: str, fn) -> dict:
    """The device kernels of one call of fn() by the profiler; raises unless
    it is one."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = {e.key: e.count for e in prof.key_averages() if e.device_type == DeviceType.CUDA}
    if sum(kernels.values()) != 1:
        raise AssertionError(f"{what} ran {sum(kernels.values())} device kernels in one call, "
                             "want 1")
    return kernels


def k3_launch_facts(k3, x, res) -> None:
    """One call of K3 is one kernel launch on the device (profiler); and
    whether its cooperative launch can be captured in a CUDA graph (the
    answer is logged either way); once captured, the replay must give the
    eager call's bits."""
    kernels = one_kernel("K3", lambda: k3.fused_instance_norm(x, res, relu=True))
    log(f"[kernels] K3 {tuple(x.shape)} one call under the profiler: device kernels {kernels}")
    want = k3.fused_instance_norm(x, res, relu=True)
    try:
        graph = torch.cuda.CUDAGraph()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            k3.fused_instance_norm(x, res, relu=True)
        torch.cuda.current_stream().wait_stream(side)
        with torch.cuda.graph(graph):
            got = k3.fused_instance_norm(x, res, relu=True)
    except Exception as e:  # recorded, not a failure: no serving path captures graphs yet
        log(f"[kernels] K3 under CUDA-graph capture: not capturable: {type(e).__name__}: {e}")
        return
    got.zero_()
    graph.replay()
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError("K3's CUDA-graph replay differs from the eager call")
    log("[kernels] K3 under CUDA-graph capture: captured; replay bit-equal to the eager call")


def phase_k3_bwd(card: str, gen) -> dict:
    """K3's backward at every distinct norm shape of the standard path and of
    the training step, under the three (relu, residual) forms, through the
    autograd Function (K3's forward keeps the statistics the backward
    kernel reads): dx in fp32 within 1e-5 abs of the plain version on the
    same statistics, bf16 within 1 ulp beyond that, the residual's gradient
    the output's own; deterministic; one device kernel per call; timed in
    bf16 at the largest slab beside the backward of F.instance_norm on the
    same tensor. (Recomputing the statistics, as JAX's _fused_in_bwd does,
    moves xhat by rounding, and where xhat is 0 to rounding the ReLU's
    mask, and with it dx, can take the other side of the kink; that
    difference is logged.)"""
    from jpdse_tpu_torch.ops import instance_norm as k3

    max_err = 0.0
    entry = None
    for shape in NORM_SHAPES + TRAIN_NORM_SHAPES:
        base = torch.randn(shape, device="cuda", generator=gen) * 3 + 1
        g32 = torch.randn(shape, device="cuda", generator=gen)
        res32 = torch.randn(shape, device="cuda", generator=gen)
        for dtype in (torch.float32, torch.bfloat16):
            g = g32.to(dtype)
            for relu, has_res in NORM_COMBOS:
                x = base.to(dtype, copy=True).requires_grad_()
                res = res32.to(dtype, copy=True).requires_grad_() if has_res else None
                y = k3.fused_instance_norm(x, res, relu=relu)
                grads = torch.autograd.grad(y, [x] + ([res] if has_res else []), g,
                                            retain_graph=True)
                again = torch.autograd.grad(y, x, g)[0]
                # the statistics the Function kept, from a second (bit-equal) forward launch
                _, stats = k3._forward(x.detach(), None if res is None else res.detach(), relu,
                                       1e-5)
                want = k3.fused_instance_norm_bwd_plain(x.detach(), g, relu, stats=stats)
                recomputed = k3.fused_instance_norm_bwd_plain(x.detach(), g, relu)
                torch.cuda.synchronize()
                got = grads[0]
                what = f"K3 backward {shape} {dt(dtype)} relu={relu} residual={has_res}"
                if not torch.equal(got, again):
                    raise AssertionError(f"{what}: not deterministic")
                if has_res and not torch.equal(grads[1], g):
                    raise AssertionError(f"{what}: the residual's gradient is not the output's")
                err = (got.float() - want.float()).abs().max().item()
                err_re = (got.float() - recomputed.float()).abs().max().item()
                if dtype == torch.float32:
                    max_err = max(max_err, err)
                    if not err <= 1e-5:
                        raise AssertionError(f"{what}: max abs diff {err} > 1e-5")
                    log(f"[kernels] {what}: max abs diff {err:.2e} (tolerance 1e-5; "
                        f"{err_re:.2e} from the plain version's own statistics); two runs "
                        "bit-equal")
                else:
                    u = bf16_excess_ulps(got, want)
                    if not u <= 1.0:
                        raise AssertionError(f"{what}: {u} bf16 ulps beyond 1e-5 from the plain "
                                             "version")
                    log(f"[kernels] {what}: max abs diff {err:.2e}, max {u:.2f} bf16 ulp beyond "
                        f"1e-5 (tolerance 1; {err_re:.2e} from the plain version's own "
                        "statistics); two runs bit-equal")
        if shape in TRAIN_NORM_SHAPES:
            # timing at the training step's shapes, fp32, with and without the ReLU
            # (the residual form runs the bare norm's kernel)
            x, g = base, g32
            for relu in (True, False):
                _, stats = k3._forward(x, None, relu, 1e-5)
                k = cuda_ms(lambda: k3.fused_instance_norm_bwd(x, g, stats, relu))
                k_dev = device_ms(lambda: k3.fused_instance_norm_bwd(x, g, stats, relu))
                bound = bytes_ms(x, g, x)
                log(f"[kernels] K3 backward {shape} fp32 relu={relu}: kernel {k:.4f} ms (on the "
                    f"device {k_dev:.4f} ms, {bound / k_dev:.0%} of its bound), bound "
                    f"{bound * 1e3:.1f} us (bytes); {K3_BWD_SITES.get((shape[1:], relu), 0)} "
                    f"launches a training step ({card})")
            continue
        if entry is not None:
            continue
        # timing at the largest slab, bf16: the kernel alone on the forward's
        # statistics (back to back, and each call after the L2 is flushed), its
        # plain version, and the library's backward
        x = base.to(torch.bfloat16)
        g = g32.to(torch.bfloat16)
        _, stats = k3._forward(x, None, True, 1e-5)
        kernels = one_kernel("K3 backward", lambda: k3.fused_instance_norm_bwd(x, g, stats, True))
        k = cuda_ms(lambda: k3.fused_instance_norm_bwd(x, g, stats, True))
        k_dev = device_ms(lambda: k3.fused_instance_norm_bwd(x, g, stats, True))
        k_cold = flushed_ms(lambda: k3.fused_instance_norm_bwd(x, g, stats, True))
        k_plain = cuda_ms(lambda: k3.fused_instance_norm_bwd_plain(x, g, True))
        xc = x.permute(0, 3, 1, 2).detach().requires_grad_()
        yc = F.instance_norm(xc, eps=1e-5)
        gc = g.permute(0, 3, 1, 2)
        lib = cuda_ms(lambda: torch.autograd.grad(yc, xc, gc, retain_graph=True))
        bound = bytes_ms(x, g, x)
        log(f"[kernels] K3 backward {shape} bf16 relu: one call is {kernels} on the device; "
            f"kernel {k:.4f} ms (on the device {k_dev:.4f} ms by the profiler; {bound / k_dev:.0%} "
            f"of its bound; {k_cold:.4f} ms a call after an L2 flush), plain {k_plain:.4f} ms, "
            f"backward of F.instance_norm {lib:.4f} ms, bound {bound * 1e3:.1f} us (bytes: x and "
            f"g read, dx written) ({card})")
        k3_bwd_graph(k3, x, g, stats)
        entry = (k, k_plain, bound, lib, k_dev)
    k, p, bound, lib, k_dev = entry
    e = kernel_entry("fused_instance_norm_bwd", max_err, k, p, bound, "bytes", lib)
    e["device_ms"] = k_dev
    return e


def k3_bwd_graph(k3, x, g, stats) -> None:
    """K3's backward, one cooperative launch, captured in a CUDA graph: the
    replay must give the eager call's bits."""
    want = k3.fused_instance_norm_bwd(x, g, stats, True)
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        k3.fused_instance_norm_bwd(x, g, stats, True)
    torch.cuda.current_stream().wait_stream(side)
    with torch.cuda.graph(graph):
        got = k3.fused_instance_norm_bwd(x, g, stats, True)
    got.zero_()
    graph.replay()
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError("K3 backward's CUDA-graph replay differs from the eager call")
    log("[kernels] K3 backward under CUDA-graph capture: captured; replay bit-equal to the "
        "eager call")


def phase_k4(card: str, gen) -> dict:
    """K4 at both heads as the kernel configuration hands them over (netG:
    156 s2d channels, padded by the producer to 160 with zeros and zero
    weight rows; netE4label: 144): fp32 within 1e-4 relative of the plain
    version with TF32 off, bf16 within 1e-2 relative; timed in bf16 beside
    F.conv2d on the same operands and on the unpadded ones. The bound counts
    the head's own channels, so the padding is part of the kernel's gap to
    it. Then the dense-A leg: K4's main loop on a materialised (M, K) =
    (131072, 16 * 156) matrix against torch.matmul."""
    from jpdse_tpu_torch.ops import head_conv as k4

    kp, ho, n = 4, H // 2, 256
    extra = k4.head_conv_extra_rows(ho, kp)
    max_err = 0.0
    entry = None
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for trunk, c_head in (("netG", 156), ("netE4label", 144)):
            c = k4.padded_channels(c_head)
            xp32 = torch.randn((1, ho + kp - 1 + extra, W // 2 + 3, c), device="cuda",
                               generator=gen)
            w32 = torch.randn((kp, kp, c, n), device="cuda", generator=gen) * 0.02
            xp32[..., c_head:] = 0
            w32[:, :, c_head:] = 0
            w32 = w32.reshape(kp, kp * c, n)
            for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 1e-2)):
                xp, w = xp32.to(dtype), w32.to(dtype)
                got = k4.head_conv_s2d(xp, w, kp, ho=ho)
                want = k4.head_conv_s2d_plain(xp, w, kp, ho=ho)
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                rel = err / want.float().abs().max().item()
                if dtype == torch.float32:
                    max_err = max(max_err, err)
                if tuple(got.shape) != (1, ho, W // 2, n) or not rel <= tol:
                    raise AssertionError(f"K4 {trunk} {dtype}: shape {tuple(got.shape)}, "
                                         f"relative diff {rel} > {tol}")
                log(f"[kernels] K4 head_conv_s2d {trunk} xp {tuple(xp.shape)} {dt(dtype)}: "
                    f"max abs diff {err:.3e}, relative {rel:.2e} (tolerance {tol}; plain with "
                    "TF32 off)")
            xp, w = xp32.to(torch.bfloat16), w32.to(torch.bfloat16)
            w_oihw = k4._unfold(w, kp, c).contiguous(memory_format=torch.channels_last)
            xin = xp[:, : ho + kp - 1].permute(0, 3, 1, 2)
            k = cuda_ms(lambda: k4.head_conv_s2d(xp, w, kp, ho=ho))
            k_dev = device_ms(lambda: k4.head_conv_s2d(xp, w, kp, ho=ho))
            p = cuda_ms(lambda: k4.head_conv_s2d_plain(xp, w, kp, ho=ho))
            lib = cuda_ms(lambda: F.conv2d(xin, w_oihw))
            lib_head = lib
            if c_head != c:  # cuDNN on the head's own channels, as the default path runs it
                xin_h = xin[:, :c_head].contiguous(memory_format=torch.channels_last)
                w_h = w_oihw[:, :c_head].contiguous(memory_format=torch.channels_last)
                lib_head = cuda_ms(lambda: F.conv2d(xin_h, w_h))
            flops = 2.0 * ho * (W // 2) * n * kp * kp * c_head
            bound = flops / BF16_FLOPS * 1e3
            moved = bytes_ms(xp[:, : ho + kp - 1, ..., :c_head], w[:, : kp * c_head], got)
            log(f"[kernels] K4 {trunk} bf16: kernel {k:.4f} ms ({flops / k / 1e9:.1f} TFLOP/s of "
                f"the head's {c_head} channels, {k / bound:.2f}x its bound; on the device "
                f"{k_dev:.4f} ms by the profiler), plain {p:.4f} ms, F.conv2d on the same "
                f"{c} channels {lib:.4f} ms, on the head's {c_head} {lib_head:.4f} ms, bound "
                f"{bound:.4f} ms ({flops / 1e12:.3f} TFLOP at the {BF16_FLOPS / 1e12:.0f} TFLOP/s "
                f"dense bf16 peak; {c / c_head - 1:.1%} more work in the kernel's padded "
                f"operands; its bytes alone {moved:.4f} ms) ({card})")
            if entry is None:
                entry = (k, p, bound, lib)
        dense = phase_k4_dense(card, gen, ho * (W // 2), kp * kp * 156, n)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    k, p, bound, lib = entry
    e = kernel_entry("head_conv_s2d", max_err, k, p, bound, "operations", lib)
    e["dense_a_leg"] = dense
    return e


def phase_k4_dense(card: str, gen, m: int, kd: int, n: int) -> dict:
    """K4's dense-A mode (the port of the TPU probes' plain GEMM at the
    netG head's im2col shape, its 156 channels unpadded): bf16 (m, kd) @ (kd, n) within 1e-2 relative of
    torch.matmul, timed beside it."""
    from jpdse_tpu_torch.ops import head_conv as k4

    a = torch.randn((m, kd), device="cuda", generator=gen).to(torch.bfloat16)
    b = (torch.randn((kd, n), device="cuda", generator=gen) * 0.02).to(torch.bfloat16)
    got = k4.head_conv_gemm(a, b)
    want = torch.matmul(a, b)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    rel = err / want.float().abs().max().item()
    if not rel <= 1e-2:
        raise AssertionError(f"K4 dense-A ({m}, {kd}) x ({kd}, {n}): relative diff {rel} > 1e-2")
    k = cuda_ms(lambda: k4.head_conv_gemm(a, b))
    mm = cuda_ms(lambda: torch.matmul(a, b))
    p = cuda_ms(lambda: k4.head_conv_gemm_plain(a, b))
    flops = 2.0 * m * n * kd
    bound = flops / BF16_FLOPS * 1e3
    log(f"[kernels] K4 dense-A leg ({m}, {kd}) x ({kd}, {n}) bf16: max abs diff {err:.3e}, "
        f"relative {rel:.2e} to torch.matmul (tolerance 1e-2); kernel {k:.4f} ms "
        f"({flops / k / 1e9:.1f} TFLOP/s), torch.matmul {mm:.4f} ms ({flops / mm / 1e9:.1f} "
        f"TFLOP/s), plain {p:.4f} ms, bound {bound:.4f} ms ({card})")
    return {"name": "head_conv_gemm", "route": "cuda",
            "source": "jpdse_tpu_torch/csrc/head_conv.cu",
            "replaces": "tools/bench_pallas_matmul.py:48, tools/bench_head_kernel_probe.py:72",
            "max_abs_err": err, "ms": k, "plain_ms": p, "bound_ms": bound,
            "bound_by": "operations", "library_ms": mm}


def phase_coder(card: str, seed: int) -> None:
    """The host range coder (built with g++ in the build phase): pack and
    unpack of one flagship request's codes (2 x (32, 64, 128) bits) on the
    host, random bits and all-zero bits, each pack coding both ways as
    codec_io.pack does; the round trip must give the codes back."""
    from jpdse_tpu_torch import codec_io

    rng = np.random.default_rng(seed)
    shapes = [(H // 16, W // 16, 128)] * 2
    for what, codes in (("random bits", [rng.integers(0, 2, s).astype(np.uint8) for s in shapes]),
                        ("all-zero bits", [np.zeros(s, np.uint8) for s in shapes])):
        pack_ms, unpack_ms = [], []
        for _ in range(5):
            t0 = time.perf_counter()
            stream = codec_io.pack(codes, (H, W))
            t1 = time.perf_counter()
            got, hw = codec_io.unpack(stream)
            pack_ms.append((t1 - t0) * 1e3)
            unpack_ms.append((time.perf_counter() - t1) * 1e3)
        if hw != (H, W) or not all(np.array_equal(g[0], c) for g, c in zip(got, codes)):
            raise AssertionError(f"coder round trip of {what} lost bits")
        bits = sum(c.size for c in codes)
        log(f"[coder] {what}, {bits} bits: .jpds v{stream[4]} {len(stream)} bytes; pack "
            f"{np.median(pack_ms):.2f} ms (both context models), unpack "
            f"{np.median(unpack_ms):.2f} ms, medians of 5 on the host ({card})")


def coded_modules(cfg) -> list:
    """(name, its code's shape at batch 1) of each binarized module, in
    get_codes_shaped order."""
    m, out = cfg.model, []
    for name, on, n_down, c in (
            ("netE4label", cfg.use_netE4label and not m.no_label_encoder_binarization,
             m.n_downsample_E4label, m.label_encoder_binarizer_out_channels),
            ("netE", cfg.use_netE and not m.no_encoder_binarization, m.n_downsample_E,
             m.encoder_binarizer_out_channels),
            ("netG", not m.no_generator_binarization, m.n_downsample_global,
             m.generator_binarizer_out_channels)):
        if on:
            out.append((name, (1, H // 2**n_down, W // 2**n_down, c)))
    return out


def check_codes(what: str, got, want, presign, names=("netE4label", "netE"),
                near: float = 1e-5) -> None:
    if len(got) != len(want) or len(want) != len(names):
        raise AssertionError(f"{what}: {len(got)} codes against {len(want)}")
    for name, f, s, p in zip(names, got, want, presign):
        diff = f != s
        away = diff & (p.abs() >= near)
        if away.any():
            raise AssertionError(f"{what} {name} codes: {int(away.sum())} bits differ away from 0")
        worst = f", the largest |pre-sign| among them {p[diff].abs().max().item():.2e}" \
            if diff.any() else ""
        log(f"[parity] {what} {name} codes {tuple(f.shape)}: {int(diff.sum())} of "
            f"{diff.numel()} bits differ (allowed only where |pre-sign| < {near}){worst}")


def check_image(what: str, got, want) -> None:
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    log(f"[parity] {what} vs the default standard decode from the same codes, TF32 off "
        f"(cudnn.allow_tf32=False, matmul.allow_tf32=False): max abs diff {err:.3e} "
        f"(tolerance {FP32_ATOL})")
    if not err <= FP32_ATOL:
        raise AssertionError(f"{what} differs from the standard path by {err}")


def phase_fp32_parity(cfg, kcfg, codec, seed: int, k3_launches: int = 45,
                      tag: str = "") -> None:
    """At full width in fp32, TF32 off for convolutions and matmuls, against
    the port's default standard path: the default fast path, the fast path
    in the kernel configuration (K1, K2, K4) and the standard path with K3
    (``k3_launches`` for a compress and a decompress)."""
    from jpdse_tpu_torch.models.codec import SemanticCodec
    from jpdse_tpu_torch.models.fast_codec import FastCodec

    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        batch = {k: torch.as_tensor(v, device="cuda") for k, v in make_batch(seed).items()}
        with torch.inference_mode():
            inputs = codec.prepare(batch)
            std_codes = codec.get_codes_shaped(inputs)
            presign = codec.get_presign(inputs)
            std_img = codec.decode_from_codes(std_codes)
        state = codec.state_dict()
        names = [n for n, _ in coded_modules(cfg)]
        for what, c in (("fp32 default fast path", cfg), ("fp32 kernel-config fast path", kcfg)):
            fast = FastCodec(c, state, device="cuda", dtype=torch.float32)
            reset_counts()
            check_codes(f"{tag}{what}", fast.get_codes_shaped(batch), std_codes, presign, names)
            check_image(f"{tag}{what}", fast.decode_from_codes(std_codes), std_img)
            log(f"[parity] {tag}{what}: kernel launches {read_counts()}")
        fused = SemanticCodec(kcfg, device="cuda", seed=None, dtype=torch.float32)
        fused.load_state_dict(state)
        reset_counts()
        what = f"{tag}fp32 standard path with K3"
        with torch.inference_mode():
            check_codes(what, fused.get_codes_shaped(fused.prepare(batch)), std_codes, presign,
                        names)
            check_image(what, fused.decode_from_codes(std_codes), std_img)
        counts = read_counts()
        log(f"[parity] {what}: kernel launches {counts}")
        if counts["fused_instance_norm"] != k3_launches:
            raise AssertionError(f"K3 launched {counts['fused_instance_norm']} times, "
                                 f"want {k3_launches}")
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def serve_path(label: str, cfg, state, batches, want_compress: dict, want_decompress: dict,
               card: str):
    """Serve ``batches`` through a CodecServer with every kernel's count set
    to 0 just before and read just after: every request through the tensor
    API (compress_codes, decompress_codes), then every request compressed
    to a .jpds stream and decompressed from it, the stream's codes equal to
    compress_codes'; each call's launches are asserted. Returns the medians
    after the first request (ms), the counts over the run, and the last
    request's codes and image."""
    from jpdse_tpu_torch import codec_io
    from jpdse_tpu_torch.serve import CodecServer

    torch.cuda.empty_cache()  # each path starts from the same allocator state
    server = CodecServer(cfg, state, device="cuda")
    code_shapes = [shape for _, shape in coded_modules(cfg)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rows = {k: [] for k in ("compress", "decompress", "compress: device part", "pack", "unpack",
                            "decompress: device part", "compress_codes", "decompress_codes",
                            "bytes")}
    reset_counts()

    def call(r: int, name: str, want: dict, fn):
        before = read_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        rows[name].append((time.perf_counter() - t0) * 1e3)
        after = read_counts()
        rose = {k: after[k] - before[k] for k in after}
        if rose != {k: want.get(k, 0) for k in after}:
            raise AssertionError(f"{label} request {r}: {name} launched {rose}, want {want}")
        return out

    # the tensor API first, as a server that keeps codes on the card serves
    # them: its times compare with a checkout that serves no bytes
    tensor_codes, tensor_images = [], []
    for r, batch in enumerate(batches):
        codes = call(r, "compress_codes", want_compress, lambda: server.compress_codes(batch))
        image = call(r, "decompress_codes", want_decompress,
                     lambda: server.decompress_codes(codes))
        if [tuple(c.shape) for c in codes] != code_shapes or any(
            c.dtype != torch.uint8 or int(c.max()) > 1 for c in codes
        ):
            raise AssertionError(f"{label} request {r}: codes "
                                 f"{[(tuple(c.shape), c.dtype) for c in codes]}")
        tensor_codes.append([c.cpu().numpy() for c in codes])
        tensor_images.append(image[0].cpu().numpy())
    # then every request through .jpds bytes
    for r, batch in enumerate(batches):
        streams = call(r, "compress", want_compress, lambda: server.compress(batch))
        rows["compress: device part"].append(server.times["compress_codes"])
        rows["pack"].append(server.times["pack"])
        image = call(r, "decompress", want_decompress, lambda: server.decompress(streams[0]))
        rows["unpack"].append(server.times["unpack"])
        rows["decompress: device part"].append(server.times["decompress_codes"])
        rows["bytes"].append(len(streams[0]))
        got, hw = codec_io.unpack(streams[0])
        if len(streams) != 1 or hw != (H, W) or not all(
                np.array_equal(g, c) for g, c in zip(got, tensor_codes[r])):
            raise AssertionError(f"{label} request {r}: the stream's codes differ from "
                                 "compress_codes'")
        if image.shape != (H, W, 3) or image.dtype != np.float32 or not np.isfinite(image).all() \
                or np.abs(image).max() > 1.0:
            raise AssertionError(f"{label} request {r}: image {image.shape} {image.dtype} not "
                                 "finite in [-1, 1]")
        diff = float(np.abs(image - tensor_images[r]).max())
        if not diff <= 1e-2:  # equal codes, one bf16 decode each
            raise AssertionError(f"{label} request {r}: decompress of the stream differs from "
                                 f"decompress_codes of its codes by {diff}")
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    for r in range(len(batches)):
        log(f"[serve] {label} request {r}: .jpds {rows['bytes'][r]} bytes "
            f"({8 * rows['bytes'][r] / (H * W):.4f} bpp); compress {rows['compress'][r]:.2f} ms "
            f"(device part {rows['compress: device part'][r]:.2f}, pack {rows['pack'][r]:.2f}), "
            f"decompress {rows['decompress'][r]:.2f} ms (unpack {rows['unpack'][r]:.2f}, device "
            f"part {rows['decompress: device part'][r]:.2f}); tensor API compress_codes "
            f"{rows['compress_codes'][r]:.2f} ms, decompress_codes "
            f"{rows['decompress_codes'][r]:.2f} ms ({card})")
    rest = slice(1, None) if len(batches) > 1 else slice(None)
    med = {k: float(np.median(v[rest])) for k, v in rows.items()}
    mp = H * W / 1e6
    log(f"[serve] {label}: bf16 batch 1 at {W}x{H}, medians of requests after the first: "
        f"compress {med['compress']:.2f} ms ({mp / med['compress'] * 1e3:.2f} MP/s; device "
        f"part {med['compress: device part']:.2f}, pack {med['pack']:.2f}), decompress "
        f"{med['decompress']:.2f} ms ({mp / med['decompress'] * 1e3:.2f} MP/s; unpack "
        f"{med['unpack']:.2f}, device part {med['decompress: device part']:.2f}); tensor API "
        f"{med['compress_codes']:.2f} / {med['decompress_codes']:.2f} ms; .jpds "
        f"{med['bytes']:.0f} bytes ({8 * med['bytes'] / (H * W):.4f} bpp); peak memory "
        f"{peak:.2f} GiB ({card})")
    log(f"[serve] {label}: codes {code_shapes} uint8 in {{0,1}}, equal to each stream's; images "
        f"({H}, {W}, 3) finite in [-1, 1]; launches {counts}, per call: compress and "
        f"compress_codes {want_compress}, decompress and decompress_codes {want_decompress}")
    return med, counts, codes, image


# kernel launches per compress and per decompress on each serving path
SERVE_LAUNCHES = {
    "default fast path": ({}, {"s2d_realign_pad3": 3}),
    "kernel-config fast path": ({"s2d_realign_pad3": 1, "s2d_pad3": 1, "head_conv_s2d": 1},
                                {"s2d_realign_pad3": 4, "head_conv_s2d": 1}),
    "kernel-config standard path": ({"fused_instance_norm": 10}, {"fused_instance_norm": 35}),
    # the same standard path without K3, to read K3's end-to-end effect
    "default standard path": ({}, {}),
}


def phase_serve(cfg, kcfg, codec, seed: int, requests: int, card: str,
                want: dict = SERVE_LAUNCHES, tag: str = "") -> dict:
    """The four serving paths in bf16, each call's launches asserted
    against ``want``; returns each path's launch counts."""
    import copy

    state = codec.state_dict()
    batches = [make_batch(seed + 1 + r) for r in range(requests)]
    kstd, dstd = copy.deepcopy(kcfg), copy.deepcopy(cfg)
    kstd.model.fast_inference = dstd.model.fast_inference = False
    configs = {"default fast path": cfg, "kernel-config fast path": kcfg,
               "kernel-config standard path": kstd, "default standard path": dstd}
    results, launches = {}, {}
    for label, c in configs.items():
        want_c, want_d = want[label]
        med, counts, codes, image = serve_path(f"{tag}{label}", c, state, batches, want_c,
                                               want_d, card)
        results[label], launches[label] = med, counts
        if label == "default fast path":
            # the served bf16 image against the fp32 standard path on the same codes
            with torch.inference_mode():
                ref = codec.decode_from_codes([x.float() for x in codes])[0].cpu().numpy()
            diff = np.abs(image - ref)
            log(f"[serve] bf16 served image vs fp32 standard decode of its codes: max abs diff "
                f"{diff.max():.3e}, mean {diff.mean():.3e} (information)")
    base = results["default fast path"]
    for label, med in results.items():
        c_ms, d_ms = med["compress"], med["decompress"]
        log(f"[serve] medians, {tag}{label}: compress {c_ms:.2f} ms ({c_ms / base['compress']:.3f}x "
            f"the default fast path's {base['compress']:.2f}), decompress {d_ms:.2f} ms "
            f"({d_ms / base['decompress']:.3f}x its {base['decompress']:.2f}); "
            f"tensor API {med['compress_codes']:.2f} / {med['decompress_codes']:.2f} ms; host "
            f"coder pack {med['pack']:.2f}, unpack {med['unpack']:.2f} ms ({card})")
    return launches


EVAL_IMAGES = 4
# the flagship's preprocessing and normalization, as its training run saved
# them (artifacts/flagship_r3/phase3/opt.json): 'fixed', crop 1024, aspect 2
FLAGSHIP_PREPROCESS = ("fixed", 1024, 1024, 2.0)
FLAGSHIP_NORMALIZE_STD = (1.0, 1.0, 1.0)
KERNEL_FLAGS = ["--fused_instance_norm", "1", "--head_pallas", "1", "--front_realign", "pallas"]
# flags, then kernel launches per image of test.main, compress.main and
# decompress.main. test.main takes the rate from the standard path's codes
# (as the JAX Trainer does), reconstructs through the chosen path in one
# pass, and codes through it again for the .rc dumps: on the fast path in
# the kernel configuration that is K3 10 (rate), K1 5 + K2 1 + K4 2 (the full
# pass) and K1 1 + K2 1 + K4 1 (the codes); on its standard path K3 10 + 45
# + 10.
EVAL_PATHS = {
    "default fast path": (["--fast_inference", "1"], {"s2d_realign_pad3": 3}, {},
                          {"s2d_realign_pad3": 3}),
    "kernel-config fast path": (
        ["--fast_inference", "1"] + KERNEL_FLAGS,
        {"fused_instance_norm": 10, "s2d_realign_pad3": 6, "s2d_pad3": 2, "head_conv_s2d": 3},
        {"s2d_realign_pad3": 1, "s2d_pad3": 1, "head_conv_s2d": 1},
        {"s2d_realign_pad3": 4, "head_conv_s2d": 1}),
    "kernel-config standard path": (
        ["--fast_inference", "0"] + KERNEL_FLAGS, {"fused_instance_norm": 65},
        {"fused_instance_norm": 10}, {"fused_instance_norm": 35}),
}
_SPLIT = re.compile(r"host clock: load ([\d.]+), device ([\d.]+), coder ([\d.]+), "
                    r"metrics ([\d.]+), gallery ([\d.]+)")


def write_cityscapes(root: Path, seed: int, split: str = "val") -> None:
    """EVAL_IMAGES Cityscapes triplets of ``split`` at 2048x1024 from
    ``seed``: a smooth random photo with noise, block labels of 34 classes
    and 16-bit instance ids (class * 1000 + k), written as PNGs with PIL,
    the port's image I/O."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    for i in range(EVAL_IMAGES):
        city = ("frankfurt", "lindau")[i % 2]
        name = f"{city}_{i:06d}_000019"
        img_dir, gt_dir = root / "leftImg8bit" / split / city, root / "gtFine" / split / city
        img_dir.mkdir(parents=True, exist_ok=True)
        gt_dir.mkdir(parents=True, exist_ok=True)
        small = Image.fromarray(rng.integers(0, 256, (32, 64, 3), dtype=np.uint8))
        photo = np.asarray(small.resize((2048, 1024), Image.BICUBIC)).astype(np.int16)
        photo = np.clip(photo + rng.integers(-8, 9, photo.shape), 0, 255).astype(np.uint8)
        blocks = rng.integers(0, 34, (32, 64))
        inst = blocks * 1000 + rng.integers(0, 8, blocks.shape)
        full = np.ones((32, 32), np.int32)
        Image.fromarray(photo).save(img_dir / f"{name}_leftImg8bit.png")
        Image.fromarray(np.kron(blocks, full).astype(np.uint8)).save(
            gt_dir / f"{name}_gtFine_labelIds.png")
        Image.fromarray(np.kron(inst, full).astype(np.int32)).save(
            gt_dir / f"{name}_gtFine_instanceIds.png")


def run_entry(label: str, name: str, fn, want: dict, per: int = EVAL_IMAGES, tag: str = "[eval]",
              keep=("batch ", "test set avg", "compressed ", "restored params", "fast inference")):
    """One entry point with every kernel count set to 0 just before and read
    just after, asserted against ``want`` launches per ``per`` (images);
    returns its result, its printed text and its counts. What it prints is
    kept (and shown if it raises); its lines starting with ``keep`` are
    passed on."""
    reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as out:
        try:
            result = fn()
        except BaseException:
            sys.stdout.write(out.getvalue())
            raise
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    text = out.getvalue()
    for line in text.splitlines():
        if line.startswith(keep):
            log(f"{tag} {label}: {name}: {line}")
    counts = read_counts()
    per_unit = {k: v / per for k, v in counts.items()}
    if per_unit != {k: float(want.get(k, 0)) for k in counts}:
        raise AssertionError(f"{label}: {name} launched {per_unit} per {per}, want {want}")
    log(f"{tag} {label}: {name} {seconds:.2f} s; launches per {per} "
        f"{'images' if per > 1 else 'run'} { {k: v for k, v in per_unit.items() if v} }")
    return result, text, counts


def phase_eval(codec, seed: int, card: str) -> dict:
    """The eval and deploy entry points on the card (see the module's
    docstring, phase 6); returns each path's launch counts over its three
    entry points."""
    from PIL import Image

    from jpdse_tpu_torch import compress, decompress, test
    from jpdse_tpu_torch.config import derive_eval_config, flagship_config
    from jpdse_tpu_torch.data.cityscapes import CityscapesDataset
    from jpdse_tpu_torch.train.checkpoint import save_params

    launches = {}
    with tempfile.TemporaryDirectory(prefix="jpdse_eval_") as tmp:
        root, run = Path(tmp) / "cityscapes", Path(tmp) / "run"
        t0 = time.perf_counter()
        write_cityscapes(root, seed)
        cfg = flagship_config()
        mode, load, crop, aspect = FLAGSHIP_PREPROCESS
        for pp in (cfg.data.preprocess, cfg.data.val_preprocess, cfg.data.test_preprocess):
            pp.preprocess_mode, pp.load_size, pp.crop_size = mode, load, crop
            pp.aspect_ratio = aspect
        cfg.data.dataset, cfg.data.root_dir = "cityscapes", str(root)
        cfg.data.normalize_std = FLAGSHIP_NORMALIZE_STD
        cfg.data.num_workers = 2
        cfg.optim.seed = seed
        run.mkdir()
        cfg.save(str(run / "opt.json"))
        save_params(str(run), codec.state_dict())
        log(f"[eval] wrote {EVAL_IMAGES} Cityscapes val triplets at 2048x1024, the flagship's "
            f"opt.json ({mode} {crop}x{round(crop / aspect)}, bf16) and params_g.pt in "
            f"{time.perf_counter() - t0:.1f} s")
        # what one image costs the data pipeline, on one thread and not
        # overlapped: the loader's workers hide it behind the rest
        dataset = CityscapesDataset(derive_eval_config(cfg, "val"))
        load_ms = []
        for i in range(EVAL_IMAGES):
            t0 = time.perf_counter()
            dataset.__getitem__(i, rng=np.random.default_rng(i))
            load_ms.append((time.perf_counter() - t0) * 1e3)
        log(f"[eval] load + preprocess a 2048x1024 triplet to 1024x512, one thread (ms): "
            f"{', '.join(f'{t:.1f}' for t in load_ms)} ({card})")
        base = ["--load_opt", "--opt_file", str(run / "opt.json"), "--checkpoints_dir",
                str(run), "--mode", "val"]
        for label, (flags, want_test, want_comp, want_dec) in EVAL_PATHS.items():
            out = Path(tmp) / label.replace(" ", "_")
            torch.cuda.empty_cache()
            metrics, text, c_test = run_entry(label, "test.main", lambda: test.main(
                base + flags + ["--save_dir", str(out / "test")], device="cuda"), want_test)
            summary, _, c_comp = run_entry(label, "compress.main", lambda: compress.main(
                base + flags + ["--save_dir", str(out / "bits")], device="cuda"), want_comp)
            written, _, c_dec = run_entry(label, "decompress.main", lambda: decompress.main(
                ["--input", str(out / "bits")] + base + flags
                + ["--save_dir", str(out / "recon")], device="cuda"), want_dec)
            launches[label] = {k: c_test[k] + c_comp[k] + c_dec[k] for k in c_test}

            keys = ("L1", "MSE", "PSNR", "MS-SSIM", "shannon_bpp", "actual_bpp", "coded_bpp",
                    "total_bpp")
            if metrics["n_images"] != EVAL_IMAGES or not np.isfinite(
                    [metrics[k] for k in keys]).all():
                raise AssertionError(f"{label}: metrics {metrics}")
            rc = sorted((out / "test/codes").glob("*.rc"))
            rc_bpp = sum(len(p.read_bytes()) * 8.0 / (H * W) for p in rc) / EVAL_IMAGES
            if len(rc) != EVAL_IMAGES or not np.isclose(metrics["coded_bpp"], rc_bpp,
                                                        rtol=1e-12, atol=0):
                raise AssertionError(f"{label}: coded_bpp {metrics['coded_bpp']} but the "
                                     f"{len(rc)} .rc files make {rc_bpp}")
            jpds = sorted((out / "bits").glob("*.jpds"))
            jpds_bpp = sum(len(p.read_bytes()) for p in jpds) * 8.0 / (EVAL_IMAGES * H * W)
            if len(jpds) != EVAL_IMAGES or summary["avg_bpp"] != jpds_bpp:
                raise AssertionError(f"{label}: avg_bpp {summary['avg_bpp']} but the "
                                     f"{len(jpds)} .jpds files make {jpds_bpp}")
            worst = 0
            for p in map(Path, written):
                got = np.asarray(Image.open(p)).astype(np.int16)
                want = np.asarray(Image.open(
                    out / "test/test_visualizations/images/reconstructed_image"
                    / p.name)).astype(np.int16)
                if got.shape != (H, W, 3):
                    raise AssertionError(f"{label}: {p.name} has shape {got.shape}")
                worst = max(worst, int(np.abs(got - want).max()))
            if len(written) != EVAL_IMAGES or worst > 1:
                raise AssertionError(f"{label}: decompressed PNGs differ from the test run's "
                                     f"reconstructions by {worst} uint8 levels")
            log(f"[eval] {label}: L1 {metrics['L1']:.4f}, MSE {metrics['MSE']:.4f}, PSNR "
                f"{metrics['PSNR']:.4f} dB, MS-SSIM {metrics['MS-SSIM']:.6f}; shannon "
                f"{metrics['shannon_bpp']:.6f}, actual {metrics['actual_bpp']:.6f}, coded "
                f"{metrics['coded_bpp']:.6f} bpp (= the .rc files), .jpds {jpds_bpp:.6f} bpp "
                f"(= compress_summary.json); decompressed PNGs within {worst} uint8 level(s) "
                f"of the test run's reconstructions (random weights from seed {seed})")
            splits = [tuple(float(x) for x in m) for m in _SPLIT.findall(text)]
            if len(splits) != EVAL_IMAGES:
                raise AssertionError(f"{label}: {len(splits)} per-image lines, want "
                                     f"{EVAL_IMAGES}")
            for i, sp in enumerate(splits):
                log(f"[eval] {label} image {i}: host clock (ms) load {sp[0] * 1e3:.1f}, device "
                    f"{sp[1] * 1e3:.1f} (rate, reconstruction, codes), coder {sp[2] * 1e3:.1f}, "
                    f"metrics {sp[3] * 1e3:.1f}, gallery {sp[4] * 1e3:.1f} ({card})")
            rest = np.median(np.asarray(splits[1:]), axis=0)
            log(f"[eval] {label}: median of images after the first, host clock (ms): load "
                f"{rest[0] * 1e3:.1f}, device {rest[1] * 1e3:.1f}, coder {rest[2] * 1e3:.1f}, "
                f"metrics {rest[3] * 1e3:.1f}, gallery {rest[4] * 1e3:.1f} ({card})")
    return launches


# -- training ----------------------------------------------------------------------
TRAIN_BATCH = 2
# the generator side's norm sites, by the flagship recipe's phase: netG 27,
# netE 9 and netE4label 9 in phase 2; phase 1 has no netE
K3_SITES = {2: 45, 1: 36}
K3_BWD_SITES_BY_PHASE = {2: K3_BWD_SITES, 1: {
    **{(s[1:], True): 4 for s in NORM_SHAPES[:4]},
    (NORM_SHAPES[4][1:], True): 11, (NORM_SHAPES[4][1:], False): 9}}
GRAD_TOL = 1e-3  # a gradient tensor's relative L2 difference, unless fp32 conditioning is worse
# ... and never more than this, per network: set from the controls' largest
# readings on an H100 (G 1.32e-02, D 1.65e-03; the kernel config's 7.92e-03
# and 1.75e-03), with room both ways
GRAD_CEIL = {"G": 2e-2, "D": 5e-3}
K3_SITE_TOL = 1e-5  # K3 at a site of the step against its plain version, of the output's max-abs
# biases that an InstanceNorm follows have a gradient of 0 in exact arithmetic
NORMED_BIAS = re.compile(r"(^|\.)(head|down\.\d+|up\.\d+|res\.\d+|layer[1-9])\..*bias$")


def flagship_train_config(kernels: bool, seed: int, phase: int = 2):
    """The flagship's phase-2 recipe (artifacts/flagship_r3/phase2/opt.json):
    batch 2 at 1024x512 ('fixed', normalize_std 1), fp32, block remat, Adam
    lr 2e-4 betas (0.5, 0.999), num_D 2, n_layers_D 3, ndf 64, LSGAN, VGG,
    feature matching and L1 distortion (the config's defaults), at full
    width; or its phase-1 recipe (artifacts/flagship_r3/phase1/opt.json:
    no netE, no distortion loss, normalize_std 0.5); ``kernels``: K3 at
    every generator-side norm site."""
    from jpdse_tpu_torch.config import flagship_config

    cfg = flagship_config(kernels=kernels)
    m = cfg.model
    m.compute_dtype, m.fast_inference = "float32", False
    cfg.optim.remat, cfg.optim.remat_granularity, cfg.optim.seed = True, "block", seed
    cfg.data.batch_size = TRAIN_BATCH
    cfg.data.normalize_std = FLAGSHIP_NORMALIZE_STD
    if phase == 1:
        m.no_feat, cfg.loss.no_distortion_loss = True, True
        cfg.data.normalize_std = (0.5, 0.5, 0.5)
    mode, load, crop, aspect = FLAGSHIP_PREPROCESS
    pp = cfg.data.preprocess
    pp.preprocess_mode, pp.load_size, pp.crop_size, pp.aspect_ratio = mode, load, crop, aspect
    cfg.validate()
    return cfg


def k3_per_step(counts: dict, steps: int) -> tuple:
    return (counts["fused_instance_norm"] / steps, counts["fused_instance_norm_bwd"] / steps)


class K3SiteCheck:
    """While active, every launch of K3's forward and backward is also run
    through its plain version on the same inputs (the backward's on the
    forward's statistics, as in phase_k3_bwd; the plain runs launch
    nothing): the difference, against the output's max-abs (the forward's
    at least 1), must stay within K3_SITE_TOL. The backward's wrapper is
    swapped in the module, whose own launch counter then lands on the
    stand-in; it is carried back on exit."""

    def __init__(self):
        from jpdse_tpu_torch.ops import instance_norm as k3

        self.k3, self.worst, self.counts = k3, {}, {}

    @property
    def calls(self) -> dict:
        return {kind: sum(n for k, n in self.counts.items() if k[0] == kind)
                for kind in ("forward", "backward")}

    def _check(self, kind: str, got: torch.Tensor, want: torch.Tensor, what: tuple) -> None:
        scale = want.float().abs().max().item()
        if kind == "forward":
            scale = max(scale, 1.0)
        err = (got.float() - want.float()).abs().max().item() / scale
        key = (kind,) + what
        self.worst[key] = max(self.worst.get(key, 0.0), err)
        self.counts[key] = self.counts.get(key, 0) + 1
        if not err <= K3_SITE_TOL:
            raise AssertionError(f"K3 {kind} at {what}: {err:.2e} of the output's max-abs from "
                                 f"the plain version (tolerance {K3_SITE_TOL})")

    def __enter__(self):
        k3 = self.k3
        self.fwd, self.bwd = k3._forward, k3.fused_instance_norm_bwd

        def forward(x, residual, relu, eps):
            y, stats = self.fwd(x, residual, relu, eps)
            with torch.no_grad():
                want = k3.fused_instance_norm_plain(x, residual, relu, eps)
            self._check("forward", y, want, (tuple(x.shape), relu, residual is not None))
            return y, stats

        def backward(x, g, stats, relu=False, eps=1e-5):
            dx = self.bwd(x, g, stats, relu, eps)
            with torch.no_grad():
                want = k3.fused_instance_norm_bwd_plain(x, g, relu, eps, stats)
            self._check("backward", dx, want, (tuple(x.shape), relu))
            return dx

        backward.launches = self.bwd.launches
        k3._forward, k3.fused_instance_norm_bwd = forward, backward
        return self

    def __exit__(self, *exc):
        k3 = self.k3
        self.bwd.launches = k3.fused_instance_norm_bwd.launches
        k3._forward, k3.fused_instance_norm_bwd = self.fwd, self.bwd

    def summary(self) -> str:
        parts = []
        for kind in ("forward", "backward"):
            forms = {k[1:]: v for k, v in self.worst.items() if k[0] == kind}
            err, form = max((v, f) for f, v in forms.items())
            parts.append(f"{kind} {self.calls[kind]} calls at {len(forms)} (shape, relu, "
                         f"residual) forms, worst {err:.2e} at {form}")
        return "; ".join(parts)


def phase_train_parity(seed: int, card: str, phase: int = 2) -> dict:
    """(a) One loss_and_grads of the ``phase`` recipe in the kernel
    configuration against the default one, fp32 with TF32 off, from the same weights and the same generator
    seed: the eight metrics within 1e-4 relative; every binarizer bit that
    differs lying within 1e-5 of its threshold (1 - x) / 2 = u; a bias an
    InstanceNorm follows 0 to rounding (at most 1e-5 of its network's
    largest gradient); and the gradients no farther from the default's
    than the step's own fp32 conditioning allows. That is measured in the
    same run by two controls, the default configuration again on the image
    with each value moved by 2^-22 of itself, up or down at random (a
    difference at fp32 rounding, as K3's is, which flips no binarizer
    bit): for each network the largest relative L2 difference of a tensor,
    kernel configuration against default, is at most GRAD_TOL or twice the
    controls' largest, and never more than GRAD_CEIL. (The first card run
    found the controls at 8e-3 in relative L2 and 5e-2 of a tensor's
    max-abs: a pre-activation on the other side of a ReLU's kink moves a
    weight gradient that sums a few thousand positions by percents.) Since
    that bound is loose for one kernel, every K3 launch of the kernel
    configuration's step is also held against the plain version on its own
    inputs (K3SiteCheck). Returns the launch counts of both
    configurations."""
    from jpdse_tpu_torch.train import step
    from jpdse_tpu_torch.trainer import Trainer

    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        t0 = time.perf_counter()
        base = Trainer(flagship_train_config(False, seed, phase), mode="train", device="cuda")
        fused = Trainer(flagship_train_config(True, seed, phase), mode="train", device="cuda")
        sites_n, tag = K3_SITES[phase], f"phase-{phase} recipe"
        for a, b in ((base.gan.codec, fused.gan.codec), (base.gan.disc, fused.gan.disc),
                     (base.gan.vgg, fused.gan.vgg)):
            b.load_state_dict(a.state_dict())
        batch = make_batch(seed, TRAIN_BATCH)
        controls = []
        for i in (1, 2):
            signs = np.random.default_rng(seed + i).choice([-1.0, 1.0], batch["image"].shape)
            controls.append(dict(batch, image=(batch["image"] * (1 + 2.0**-22 * signs)).astype(
                np.float32)))
        n_g = sum(p.numel() for p in base.gan.codec.parameters())
        n_d = sum(p.numel() for p in base.gan.disc.parameters())
        log(f"[train] {tag} at {W}x{H}, batch {TRAIN_BATCH}, fp32: G {n_g} and D {n_d} "
            f"parameters, VGG19 random from seed 0; two trainers built in "
            f"{time.perf_counter() - t0:.1f} s")
        out, launches = {}, {}
        for label, t, b in (("default", base, batch), ("kernel config", fused, batch),
                            ("control 1", base, controls[0]), ("control 2", base, controls[1])):
            gen = torch.Generator(device="cuda").manual_seed(seed)
            placed = t.place(b)
            reset_counts()
            t0 = time.perf_counter()
            if label == "kernel config":
                with K3SiteCheck() as sites:
                    out[label] = step.loss_and_grads(t.gan, placed, gen)
                    torch.cuda.synchronize()
            else:
                out[label] = step.loss_and_grads(t.gan, placed, gen)
            torch.cuda.synchronize()
            counts = read_counts()
            log(f"[train] {tag} parity, {label}: loss_and_grads {time.perf_counter() - t0:.2f} s (fp32, "
                f"TF32 off); launches {counts}")
            if not label.startswith("control"):
                launches[label] = counts
        want_k3 = {"default": (0, 0), "kernel config": (2 * sites_n, sites_n)}
        for label, counts in launches.items():
            if k3_per_step(counts, 1) != want_k3[label]:
                raise AssertionError(f"{label}: K3 forward and backward launched "
                                     f"{k3_per_step(counts, 1)}, want {want_k3[label]}")
        if sites.calls != {"forward": 2 * sites_n, "backward": sites_n}:
            raise AssertionError(f"K3 site check saw {sites.calls}")
        bwd_forms = {(k[1][1:], k[2]): n for k, n in sites.counts.items() if k[0] == "backward"}
        if bwd_forms != K3_BWD_SITES_BY_PHASE[phase]:
            raise AssertionError(f"K3 backward's launches by (H, W, C) and ReLU: {bwd_forms}, "
                                 f"want {K3_BWD_SITES_BY_PHASE[phase]}")
        log(f"[parity] {tag}: train K3 at every launch of the kernel config's step against the plain "
            f"version on the same inputs (difference / the output's max-abs, tolerance "
            f"{K3_SITE_TOL}): {sites.summary()}")
        # the binarizers' draws: netE4label's first, then netE's (where there is one)
        with torch.no_grad():
            pre = {label: t.gan.codec.get_presign(t.gan.codec.prepare(t.place(b)))
                   for label, t, b in (("default", base, batch), ("kernel config", fused, batch),
                                       ("control 1", base, controls[0]),
                                       ("control 2", base, controls[1]))}
        gen = torch.Generator(device="cuda").manual_seed(seed)
        for i, name in enumerate(("netE4label", "netE")[:len(pre["default"])]):
            x0 = pre["default"][i]
            u = torch.rand(x0.shape, dtype=x0.dtype, device="cuda", generator=gen)
            near = ((1.0 - x0) / 2.0 - u).abs() < 1e-5
            flips = {}
            for label in ("kernel config", "control 1", "control 2"):
                flipped = ((1.0 - x0) / 2.0 <= u) != ((1.0 - pre[label][i]) / 2.0 <= u)
                flips[label] = int(flipped.sum())
                if (flipped & ~near).any():
                    raise AssertionError(f"{name}, {label}: a binarizer bit differs away from "
                                         "its threshold")
            log(f"[parity] {tag}: train {name} stochastic bits that differ from the default's, of "
                f"{x0.numel()}: " + ", ".join(f"{k} {v}" for k, v in flips.items())
                + f"; all within 1e-5 of the threshold ({int(near.sum())} bits lie there)")
            if flips["control 1"] or flips["control 2"]:
                raise AssertionError(f"{name}: a control flipped a binarizer bit, so its "
                                     "gradients are no measure of rounding alone")
        (m0, g0), (m1, g1) = out["default"], out["kernel config"]
        worst = 0.0
        for k in step.METRICS:
            a, b = m0[k].item(), m1[k].item()
            rel = abs(b - a) / abs(a) if a else abs(b)
            worst = max(worst, rel)
            if not (np.isfinite(a) and rel <= 1e-4):
                raise AssertionError(f"parity: {k} {b} against {a}")
        log(f"[parity] {tag}: train metrics, kernel config vs default: "
            + ", ".join(f"{k} {m1[k].item():.6f} / {m0[k].item():.6f}" for k in step.METRICS)
            + f"; largest relative difference {worst:.2e} (tolerance 1e-4)")
        others = ("kernel config", "control 1", "control 2")
        for j, (net, module) in enumerate((("G", base.gan.codec), ("D", base.gan.disc))):
            names = [n for n, _ in module.named_parameters()]
            top = max(g.abs().max().item() for g in g0[j])
            zero = 0.0
            l2 = dict.fromkeys(others, (0.0, ""))
            peak = dict.fromkeys(others, (0.0, ""))
            for i, (n, a) in enumerate(zip(names, g0[j])):
                if NORMED_BIAS.search(n):
                    zero = max(zero, a.abs().max().item(), g1[j][i].abs().max().item())
                    continue
                for label in others:
                    d = out[label][1][j][i] - a
                    rel2 = (d.norm() / a.norm()).item()
                    relmax = (d.abs().max() / a.abs().max()).item()
                    l2[label] = max(l2[label], (rel2, n))
                    peak[label] = max(peak[label], (relmax, n))
            noise = max(l2["control 1"][0], l2["control 2"][0])
            bound = min(GRAD_CEIL[net], max(GRAD_TOL, 2 * noise))
            log(f"[parity] {tag}: train {net} gradients, {len(names)} tensors; largest relative L2 "
                f"difference and largest difference against a tensor's max-abs, each against "
                f"the default: " + "; ".join(
                    f"{label} {l2[label][0]:.2e} at {l2[label][1]}, {peak[label][0]:.2e} at "
                    f"{peak[label][1]}" for label in others)
                + f". Bound for the kernel config: {bound:.2e} (GRAD_TOL {GRAD_TOL} or twice "
                f"the controls', at most {GRAD_CEIL[net]}). The biases an InstanceNorm follows at most {zero:.2e} (0 to "
                f"rounding; largest gradient {top:.3e})")
            if not (l2["kernel config"][0] <= bound and zero <= 1e-5 * top):
                raise AssertionError(f"parity: {net} gradients differ: {l2}, norm-fed biases "
                                     f"{zero} (top {top})")
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    return launches


def profile_step(label: str, trainer, batch, card: str) -> None:
    """One more step under the profiler (after the counted ones): the
    device's busy time against the step's wall time, split into
    convolutions and GEMMs (cuDNN, cuBLAS), K3's forward, K3's backward and
    the rest (element-wise, reductions, the optimizer); the norm sites whose
    output gradient came strided and was copied before K3's backward; and
    the largest kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from jpdse_tpu_torch.ops.instance_norm import FusedInstanceNorm

    torch.cuda.synchronize()
    FusedInstanceNorm.grad_copies = 0
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        trainer.step(batch)
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    copies = FusedInstanceNorm.grad_copies
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    groups = {"conv/gemm": 0.0, "K3 forward": 0.0, "K3 backward": 0.0, "rest": 0.0}
    conv = re.compile(r"conv|cudnn|xmma|gemm|wgrad|dgrad|fprop|cutlass|sm90|sm80", re.I)
    for e in kernels:
        key = ("K3 backward" if "instance_norm_bwd_kernel" in e.key
               else "K3 forward" if "instance_norm_kernel" in e.key
               else "conv/gemm" if conv.search(e.key) else "rest")
        groups[key] += e.self_device_time_total / 1e3
    busy = sum(groups.values())
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    log(f"[train] {label}: one profiled step, wall {wall:.1f} ms, device busy {busy:.1f} ms "
        f"({busy / wall:.0%}): " + ", ".join(f"{k} {v:.1f} ms" for k, v in groups.items())
        + f"; {sum(e.count for e in kernels)} kernel launches; K3's backward found the "
        f"output's gradient strided (and copied it first) at {copies} sites; largest: "
        + "; ".join(f"{e.key[:70]} x{e.count} {e.self_device_time_total / 1e3:.2f} ms"
                    for e in top) + f" ({card})")


def phase_train_steps(seed: int, steps: int, card: str, phase: int = 2) -> dict:
    """(b) ``steps`` Trainer.steps of the ``phase`` recipe in each configuration at PyTorch's default
    precision (convolutions in TF32, matmuls in fp32): the median step after
    the first, images/s, peak memory, finite losses, K3's launches per step;
    then one more step under the profiler. Returns each configuration's
    launch counts."""
    from jpdse_tpu_torch.trainer import Trainer

    if not (torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32):
        raise AssertionError("the timed steps run at PyTorch's default precision")
    batches = [make_batch(seed + 100 + i, TRAIN_BATCH) for i in range(steps)]
    launches, medians = {}, {}
    for label, kernels in (("default", False), ("kernel config", True)):
        torch.cuda.empty_cache()
        trainer = Trainer(flagship_train_config(kernels, seed, phase), mode="train",
                          device="cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        times, losses = [], []
        for b in batches:
            t0 = time.perf_counter()
            metrics = trainer.step(b)  # ends in the metrics' host fetch
            times.append((time.perf_counter() - t0) * 1e3)
            losses.append(metrics)
            if not all(np.isfinite(v) for v in metrics.values()):
                raise AssertionError(f"{label}: losses {metrics}")
        launches[label] = counts = read_counts()
        sites_n = K3_SITES[phase]
        want = (2 * sites_n, sites_n) if kernels else (0, 0)
        if k3_per_step(counts, steps) != want:
            raise AssertionError(f"{label}: K3 forward and backward per step "
                                 f"{k3_per_step(counts, steps)}, want {want}")
        peak = torch.cuda.max_memory_allocated() / 2**30
        med = float(np.median(times[1:] if steps > 1 else times))
        medians[label] = med
        k3 = (f"K3 per step: forward {want[0]} ({sites_n} + {sites_n} in the remat "
              f"recompute), backward {want[1]}" if kernels else "no K3")
        log(f"[train] phase-{phase} recipe, {label}: steps (ms) {', '.join(f'{t:.1f}' for t in times)}; median after "
            f"the first {med:.1f} ms, {TRAIN_BATCH / med * 1e3:.3f} images/s; peak memory "
            f"{peak:.2f} GiB; {k3}; convolutions in TF32 ({card})")
        log(f"[train] phase-{phase} recipe, {label}: losses of the last step " + ", ".join(
            f"{k} {v:.4f}" for k, v in losses[-1].items()) + f"; steps taken "
            f"{trainer.steps_taken}")
        profile_step(f"phase-{phase} recipe, {label}", trainer, batches[-1], card)
        del trainer
    log(f"[train] phase-{phase} recipe: kernel config step / default step: "
        f"{medians['kernel config'] / medians['default']:.3f} ({card})")
    return launches


def phase_train_entry(seed: int, card: str) -> dict:
    """(c) train.run.main in the kernel configuration on a synthetic
    Cityscapes train/val split (EVAL_IMAGES triplets each at 2048x1024,
    read 'fixed' to 1024x512): one epoch of 2 steps, validation and a
    best-val save; a fresh Trainer restores it (steps taken, the eval loss);
    then a second main resumes, validates the load, trains an epoch and
    writes save_dir/latest. Counts are set to 0 before each main and
    asserted after it. Returns both mains' counts."""
    from jpdse_tpu_torch.cli import parse_config
    from jpdse_tpu_torch.config import derive_eval_config
    from jpdse_tpu_torch.data import create_dataloader
    from jpdse_tpu_torch.train import run
    from jpdse_tpu_torch.trainer import Trainer

    launches = {}
    with tempfile.TemporaryDirectory(prefix="jpdse_train_") as tmp:
        root, out = Path(tmp) / "cityscapes", Path(tmp) / "run"
        for split in ("train", "val"):
            write_cityscapes(root, seed + (split == "train"), split)
        mode, load, crop, _ = FLAGSHIP_PREPROCESS
        argv = ["--dataset", "cityscapes", "--root_dir", str(root), "--no_generator_binarization",
                "--normalize_std", "1", "--batch_size", str(TRAIN_BATCH), "--remat", "1",
                "--seed", str(seed), "--num_workers", "2", "--max_recon_dump", "2",
                "--fused_instance_norm", "1", "--save_dir", str(out)]
        for prefix in ("", "val_"):
            argv += [f"--{prefix}preprocess_mode", mode, f"--{prefix}load_size", str(load),
                     f"--{prefix}crop_size", str(crop)]
        steps = EVAL_IMAGES // TRAIN_BATCH
        images = {"first": EVAL_IMAGES + 2, "resumed": EVAL_IMAGES}  # validated and dumped
        runs = {"first": argv + ["--num_epochs", "1", "--val_interval", "1"],
                "resumed": argv + ["--num_epochs", "1", "--val_interval", "5", "--load_model",
                                   "--checkpoints_dir", str(out), "--latest_interval", "1"]}
        trainers = {}
        for label, args in runs.items():
            torch.cuda.empty_cache()
            sites_n = K3_SITES[2]
            want = {"fused_instance_norm": steps * 2 * sites_n + images[label] * sites_n,
                    "fused_instance_norm_bwd": steps * sites_n}
            trainer, _, counts = run_entry(
                label, "train.run.main", lambda: run.main(args, device="cuda"), want, per=1,
                tag="[train]", keep=("epoch ", "val set avg", "saving model", "checkpoint",
                                     "resuming", "latest-state", "device_cache", "restored"))
            trainers[label] = trainer
            launches[f"train entry: {label}"] = counts
            if label == "first":
                cfg = parse_config(argv, is_train=True)
                val = next(iter(create_dataloader(derive_eval_config(cfg, "val"))))
                loss = trainer.get_eval_loss(val)
                cfg.checkpoints_dir = cfg.save_dir
                with contextlib.redirect_stdout(io.StringIO()):
                    again = Trainer(cfg, mode="train", device="cuda")
                    again.load()
                got = again.get_eval_loss(val)
                if again.steps_taken != steps or again.start_epoch != 1 or abs(got - loss) > 1e-4:
                    raise AssertionError(f"restore: steps {again.steps_taken}, epoch "
                                         f"{again.start_epoch}, eval loss {got} against {loss}")
                log(f"[train] restored from the best-val save: steps taken {again.steps_taken}, "
                    f"eval loss {got:.6f} against {loss:.6f} before the save")
                del again, trainer
                trainers.pop(label)
        resumed = trainers["resumed"]
        latest = json.loads((out / "latest/trainer_meta.json").read_text())
        if resumed.start_epoch != 1 or resumed.steps_taken != 2 * steps or latest["epoch"] != 1:
            raise AssertionError(f"resume: start epoch {resumed.start_epoch}, steps "
                                 f"{resumed.steps_taken}, latest epoch {latest['epoch']}")
        files = sorted(p.name for p in out.iterdir())
        log(f"[train] resumed main: started at epoch {resumed.start_epoch + 1}, steps taken "
            f"{resumed.steps_taken}, save_dir/latest at epoch {latest['epoch']}; save_dir holds "
            f"{files}")
    return launches


# -- the flagship's phase-1 recipe and the generator-input assemblies --------------
# kernel launches per compress and per decompress of the phase-1 codec (no netE):
# the fast path's compress re-aligns and convolves netE4label's head (K1, K4 in
# the kernel configuration), its decompress re-aligns netE4label's back and
# netG's head and back; the standard path's K3 runs at netE4label's head and
# downs (5), then its ups and netG's 27 sites (31)
PHASE1_SERVE_LAUNCHES = {
    "default fast path": ({}, {"s2d_realign_pad3": 2}),
    "kernel-config fast path": ({"s2d_realign_pad3": 1, "head_conv_s2d": 1},
                                {"s2d_realign_pad3": 3, "head_conv_s2d": 1}),
    "kernel-config standard path": ({"fused_instance_norm": 5}, {"fused_instance_norm": 31}),
    "default standard path": ({}, {}),
}
PHASE1_FLAGS = ["--no_feat", "--no_distortion_loss", "--normalize_std", "0.5"]


def phase1_serving_configs():
    """The flagship's serving configuration (bf16, the fast path) and its
    kernel configuration, with the phase-1 assembly: netE4label's one code
    into netG, no netE."""
    from jpdse_tpu_torch.config import flagship_config

    out = []
    for kernels in (False, True):
        cfg = flagship_config(kernels=kernels)
        cfg.model.no_feat = True
        cfg.validate()
        out.append(cfg)
    return out


def phase8_serve(seed: int, requests: int, card: str) -> dict:
    """(d) The phase-1 codec at full width: codes and fp32 images of the
    three other paths against the default standard path (TF32 off), then
    --requests bf16 requests served on the four paths through .jpds bytes
    (one code a stream), launches asserted per call. Returns each path's
    counts."""
    from jpdse_tpu_torch.models.codec import SemanticCodec

    cfg, kcfg = phase1_serving_configs()
    codec = SemanticCodec(cfg, device="cuda", seed=seed, dtype=torch.float32)
    log(f"[phase1] phase-1 codec (no netE), {sum(p.numel() for p in codec.parameters())} "
        f"parameters from seed {seed}; one code {coded_modules(cfg)}")
    phase_fp32_parity(cfg, kcfg, codec, seed, k3_launches=36, tag="phase-1 codec: ")
    launches = phase_serve(cfg, kcfg, codec, seed, requests, card, PHASE1_SERVE_LAUNCHES,
                           "phase-1 codec, ")
    del codec
    torch.cuda.empty_cache()
    return launches


def phase8_g_binarized(seed: int, card: str) -> dict:
    """(e) The generator's bottleneck binarized after its residual blocks
    (the encoders unbinarized) at the flagship's widths, fp32 with TF32 off:
    one compress and one decompress through .jpds bytes on the standard and
    the fast path; the codes equal but where a pre-sign lies within
    FP32_ATOL of 0, the images of the standard path's stream within
    FP32_ATOL; the fast path's launches asserted (compress K1 2: the
    encoders' backs; decompress K1 1: netG's back). Returns each path's
    counts."""
    import copy

    from jpdse_tpu_torch import codec_io
    from jpdse_tpu_torch.config import flagship_config
    from jpdse_tpu_torch.models.codec import SemanticCodec
    from jpdse_tpu_torch.serve import CodecServer

    cfg = flagship_config()
    m = cfg.model
    m.no_generator_binarization = False
    m.no_encoder_binarization = m.no_label_encoder_binarization = True
    m.compute_dtype = "float32"
    cfg.validate()
    std_cfg = copy.deepcopy(cfg)
    std_cfg.model.fast_inference = False
    codec = SemanticCodec(cfg, device="cuda", seed=seed, dtype=torch.float32)
    state = codec.state_dict()
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        batch = make_batch(seed + 50)
        with torch.inference_mode():
            inputs = codec.prepare({k: torch.as_tensor(v, device="cuda") for k, v in batch.items()})
            presign = codec.get_presign(inputs)
        out, launches = {}, {}
        for label, c, want in (("standard path", std_cfg, ({}, {})),
                               ("fast path", cfg, ({"s2d_realign_pad3": 2},
                                                   {"s2d_realign_pad3": 1}))):
            server = CodecServer(c, state, device="cuda")
            reset_counts()
            t0 = time.perf_counter()
            stream = server.compress(batch)[0]
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            comp = read_counts()
            # both paths decode the standard path's stream, so their images share codes
            image = server.decompress(out["standard path"][0] if out else stream)
            t2 = time.perf_counter()
            counts = read_counts()
            dec = {k: counts[k] - comp[k] for k in counts}
            for got, w, what in ((comp, want[0], "compress"), (dec, want[1], "decompress")):
                if got != {k: w.get(k, 0) for k in got}:
                    raise AssertionError(f"G-binarized {label}: {what} launched {got}, want {w}")
            codes, hw = codec_io.unpack(stream)
            if hw != (H, W) or [c.shape for c in codes] != [shape for _, shape in
                                                            coded_modules(cfg)]:
                raise AssertionError(f"G-binarized {label}: stream codes {[c.shape for c in codes]}")
            out[label] = (stream, codes[0], image)
            launches[f"G-binarized {label}"] = counts
            log(f"[phase1] G-binarized codec, {label}: .jpds {len(stream)} bytes "
                f"({8 * len(stream) / (H * W):.4f} bpp, one code {codes[0].shape[1:]}); "
                f"compress {(t1 - t0) * 1e3:.2f} ms, decompress {(t2 - t1) * 1e3:.2f} ms (fp32, "
                f"first call); launches {counts} ({card})")
        (_, c0, i0), (_, c1, i1) = out["standard path"], out["fast path"]
        # the code sits behind two whole encoders and netG's front (25 norm
        # sites): a pre-sign's fp32 difference between the paths reaches the
        # images' own tolerance, not the shallow encoder codes' 1e-5
        check_codes("G-binarized fast path", [torch.from_numpy(c1)], [torch.from_numpy(c0)],
                    [presign[0][:1].cpu()], ["netG"], near=FP32_ATOL)
        check_image("G-binarized fast path, the standard path's stream,", torch.from_numpy(i1),
                    torch.from_numpy(i0))
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    del codec
    torch.cuda.empty_cache()
    return launches


def _exit_code(fn):
    """fn() -> None, or the code of the SystemExit it raised."""
    def run():
        try:
            fn()
        except SystemExit as e:
            return e.code
        return None
    return run


def phase8_chain(seed: int, card: str) -> dict:
    """(c) The flagship's phase chain through train.run.main in the kernel
    configuration at full width, on a synthetic Cityscapes train/val split:
    phase 1 for one epoch of 2 steps with a best-val save; phase 2 restored
    from it (--load_model --checkpoints_dir), its matched-leaf count held
    against the count worked out from the two state dicts' names and shapes;
    phase 1 again with --max_host_rss_gb 0.001, which must exit 75 with
    save_dir/latest written; and a second main with the same flags, which
    must resume from latest at epoch 2 with 2 steps taken. Counts are set to
    0 before each main and asserted after it. Returns each main's counts."""
    from jpdse_tpu_torch.train import run
    from jpdse_tpu_torch.train.checkpoint import PARAMS_D_FILE, PARAMS_FILE

    launches = {}
    n1, n2 = K3_SITES[1], K3_SITES[2]
    steps = EVAL_IMAGES // TRAIN_BATCH
    keep = ("epoch ", "val set avg", "saving model", "checkpoint", "resuming", "latest-state",
            "restored", "optimizer state", "host RSS")
    with tempfile.TemporaryDirectory(prefix="jpdse_phases_") as tmp:
        tmp = Path(tmp)
        root = tmp / "cityscapes"
        for split in ("train", "val"):
            write_cityscapes(root, seed + 10 + (split == "train"), split)
        mode, load, crop, _ = FLAGSHIP_PREPROCESS
        base = ["--dataset", "cityscapes", "--root_dir", str(root), "--no_generator_binarization",
                "--batch_size", str(TRAIN_BATCH), "--remat", "1", "--seed", str(seed),
                "--num_workers", "2", "--max_recon_dump", "2", "--fused_instance_norm", "1"]
        for prefix in ("", "val_"):
            base += [f"--{prefix}preprocess_mode", mode, f"--{prefix}load_size", str(load),
                     f"--{prefix}crop_size", str(crop)]
        d1, d2, d3 = (str(tmp / d) for d in ("phase1", "phase2", "phase1_rss"))
        rss = base + PHASE1_FLAGS + ["--save_dir", d3, "--num_epochs", "2", "--val_interval", "5",
                                     "--max_host_rss_gb", "0.001"]
        # (argv, K3 forward and backward launches, the exit code)
        runs = {
            "phase 1": (base + PHASE1_FLAGS + ["--save_dir", d1, "--num_epochs", "1",
                                               "--val_interval", "1"],
                        steps * 2 * n1 + (EVAL_IMAGES + 2) * n1, steps * n1, None),
            "phase 2 from phase 1": (
                base + ["--normalize_std", "1", "--save_dir", d2, "--num_epochs", "1",
                        "--val_interval", "5", "--load_model", "--checkpoints_dir", d1],
                EVAL_IMAGES * n2 + steps * 2 * n2, steps * n2, None),
            "phase 1, host-memory limit": (rss, steps * 2 * n1, steps * n1, 75),
            "phase 1, resumed": (rss + ["--load_model", "--checkpoints_dir", d3],
                                 EVAL_IMAGES * n1 + steps * 2 * n1, steps * n1, 75),
        }
        for label, (argv, fwd, bwd, code) in runs.items():
            torch.cuda.empty_cache()
            result = {}

            def main_run(argv=argv):
                result["trainer"] = run.main(argv, device="cuda")

            got, text, counts = run_entry(
                label, "train.run.main", _exit_code(main_run),
                {"fused_instance_norm": fwd, "fused_instance_norm_bwd": bwd}, per=1,
                tag="[phase1]", keep=keep)
            launches[f"phase chain: {label}"] = counts
            if got != code:
                raise AssertionError(f"{label}: main exited with {got}, want {code}")
            if label == "phase 2 from phase 1":
                trainer = result["trainer"]
                want_k = want_n = 0
                for name, template in ((PARAMS_FILE, trainer.gan.codec.state_dict()),
                                       (PARAMS_D_FILE, trainer.gan.disc.state_dict())):
                    saved = torch.load(Path(d1) / name, map_location="cpu", weights_only=True)
                    want_k += sum(k in saved and saved[k].shape == t.shape
                                  for k, t in template.items())
                    want_n += len(template)
                m = re.search(rf"restored params from {re.escape(d1)}: (\d+)/(\d+) leaves "
                               "matched", text)
                if not m or (int(m[1]), int(m[2])) != (want_k, want_n) or want_k == want_n:
                    raise AssertionError(f"phase 2's restore: {m and m[0]}, want {want_k}/{want_n}")
                if "optimizer state not restored" not in text:
                    raise AssertionError("phase 2 restored phase 1's Adam state")
                log(f"[phase1] phase 2 restored {want_k} of {want_n} leaves from phase 1 (netG's "
                    f"head and netE fresh), the Adams fresh")
                del trainer, result["trainer"]
            if label.startswith("phase 1, "):
                latest = json.loads((Path(d3) / "latest/trainer_meta.json").read_text())
                opt = torch.load(Path(d3) / "latest/opt.pt", map_location="cpu",
                                 weights_only=True)
                first = label.endswith("limit")
                want_at = (0, steps) if first else (1, 2 * steps)
                if (latest["epoch"], opt["steps_taken"]) != want_at:
                    raise AssertionError(f"{label}: latest at epoch {latest['epoch']}, steps "
                                         f"{opt['steps_taken']}, want {want_at}")
                if not first and not ("resuming from latest-state checkpoint" in text and
                                      f"starting from epoch 2 with {steps} steps taken" in text):
                    raise AssertionError(f"{label}: did not resume from latest at epoch 2 "
                                         f"with {steps} steps taken")
                log(f"[phase1] {label}: exit {got}, save_dir/latest at epoch {latest['epoch']} "
                    f"with {opt['steps_taken']} steps taken"
                    + ("" if first else "; resumed from latest at epoch 2 after 2 steps"))
    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--train-steps", type=int, default=4)
    args = ap.parse_args()
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs an NVIDIA GPU",
              file=sys.stderr)
        return 1

    card = card_line()
    log(f"[env] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} device(s), device 0: {torch.cuda.get_device_name(0)}")

    from jpdse_tpu_torch.config import flagship_config
    from jpdse_tpu_torch.models.codec import SemanticCodec
    from jpdse_tpu_torch.ops.build import build_all

    t0 = time.perf_counter()
    logs = build_all()
    log(f"[build] built {sorted(logs)} (.cu with nvcc, .cpp with g++) in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"[build] {name}: {line.strip()}")

    phase_coder(card, args.seed)

    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    entries = [phase_k1(card, gen), phase_k2(card, gen), phase_k3(card, gen),
               phase_k3_bwd(card, gen), phase_k4(card, gen)]

    cfg = flagship_config()
    kcfg = flagship_config(kernels=True)
    codec = SemanticCodec(cfg, device="cuda", seed=args.seed, dtype=torch.float32)
    n_params = sum(p.numel() for p in codec.parameters())
    log(f"[serve] flagship codec, {n_params} parameters from seed {args.seed}")
    phase_fp32_parity(cfg, kcfg, codec, args.seed)
    launches = phase_serve(cfg, kcfg, codec, args.seed, args.requests, card)
    eval_launches = phase_eval(codec, args.seed, card)
    for label, counts in eval_launches.items():
        launches[f"eval: {label}"] = counts
    del codec
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    train_launches = {f"train parity: {k}": v for k, v in
                      phase_train_parity(args.seed, card).items()}
    train_launches.update({f"train steps: {k}": v for k, v in
                           phase_train_steps(args.seed, args.train_steps, card).items()})
    train_launches.update(phase_train_entry(args.seed, card))
    log(f"[train] training phase {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    train_launches.update({f"phase-1 train parity: {k}": v for k, v in
                           phase_train_parity(args.seed, card, phase=1).items()})
    train_launches.update({f"phase-1 train steps: {k}": v for k, v in
                           phase_train_steps(args.seed, args.train_steps, card, phase=1).items()})
    train_launches.update(phase8_chain(args.seed, card))
    launches.update({f"phase-1 serve: {k}": v for k, v in
                     phase8_serve(args.seed, args.requests, card).items()})
    launches.update(phase8_g_binarized(args.seed, card))
    log(f"[phase1] phase-1 recipe and assemblies phase {time.perf_counter() - t0:.1f} s")
    launches.update(train_launches)
    for e in entries:
        name = e["name"]
        in_eval = sum(eval_launches[label][name] for label in eval_launches)
        in_train = sum(train_launches[label][name] for label in train_launches)
        if name != "fused_instance_norm_bwd" and in_eval == 0:
            raise AssertionError(f"{name} was not launched in the eval phase")
        if name.startswith("fused_instance_norm") and in_train == 0:
            raise AssertionError(f"{name} was not launched in the training phase")
        by_path = {label: counts[name] for label, counts in launches.items()}
        e["launches"] = sum(by_path.values())
        e["launches_by_path"] = by_path
        if e["launches"] == 0:
            raise AssertionError(f"{name} was not launched on any path")

    log(card)
    log(json.dumps({"kernels": entries}))
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
