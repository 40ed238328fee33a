#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--requests N]

Phases, each printing a line as it ends:
  1. environment: the card's name and power limit, torch and CUDA versions;
  2. build: every kernel under jpdse_tpu_torch/csrc/ with nvcc, in parallel;
  3. kernels: each kernel (K1 grid re-alignment, K2 front pad + s2d, K3
     fused InstanceNorm, K4 s2d head conv) against its plain PyTorch version
     on the card at the serving paths' shapes, in fp32 and bf16 (bit-exact
     for data movement), and timed beside its bound and, where one PyTorch
     call computes the same function, that call; K3 shown to be one launch
     per call (profiler) and tried under CUDA-graph capture; K4's
     dense-A mode against torch.matmul;
  4. the flagship codec at full width (Cityscapes 1024x512, random weights
     from --seed), fp32 with TF32 off: the default s2d fast path, the fast
     path in the kernel configuration (K1, K2, K4) and the standard path
     with K3, each against the port's default standard path;
  5. serving: a CodecServer answers --requests bf16 requests (compress to
     binary codes, decompress from the codes alone) on each of four paths,
     the default fast path, the kernel configuration's fast path and its
     standard path, and the default standard path, with every kernel's
     launch count set to 0 just before a path and read just after, and
     asserted per request;
  6. summary: the card, a JSON line of per-kernel numbers, the total
     seconds, and a last line {"ok": true, "device": {...}}.

Any failure raises and the script exits non-zero without the last line.
Without CUDA it exits non-zero before doing anything. Imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

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
NORM_COMBOS = [(True, False), (False, True), (False, False)]  # (relu, residual)
KERNELS = {  # wrapper -> (its module under jpdse_tpu_torch/ops and csrc/, the TPU kernel)
    "s2d_realign_pad3": ("realign", "jpdse_tpu/ops/pallas/realign.py:67"),
    "s2d_pad3": ("realign", "jpdse_tpu/ops/pallas/realign.py:137"),
    "fused_instance_norm": ("instance_norm", "jpdse_tpu/ops/pallas/instance_norm.py:125"),
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


def device_ms(fn, iters: int = 10) -> float:
    """Mean device time of the kernels fn() launches, in ms per call, from
    the profiler: what the card spends, without the host's launch time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e3 / iters


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
    with and without extra rows; timed at the netE front's shape."""
    from jpdse_tpu_torch.ops import realign

    times = {}
    for c in (3, 36, 39):
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn((1, H, W, c), device="cuda", generator=gen).to(dtype)
            for extra in (0, 1):
                got = realign.s2d_pad3(x, extra)
                want = realign.s2d_pad3_plain(x, extra)
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    raise AssertionError(f"K2 differs from its plain version at C={c} "
                                         f"{dtype} extra_rows={extra}")
            log(f"[kernels] K2 s2d_pad3 (1, {H}, {W}, {c}) {dt(dtype)} extra_rows=0,1: "
                "bit-exact (torch.equal)")
            if dtype == torch.bfloat16:
                k = cuda_ms(lambda: realign.s2d_pad3(x))
                p = cuda_ms(lambda: realign.s2d_pad3_plain(x))
                bound = bytes_ms(x, realign.s2d_pad3(x))  # extra_rows=0, as timed
                times[c] = (k, p, bound)
                log(f"[kernels] K2 (1, {H}, {W}, {c}) bf16: kernel {k:.4f} ms, plain {p:.4f} ms, "
                    f"bound {bound * 1e3:.2f} us (bytes) ({card})")
    return kernel_entry("s2d_pad3", 0.0, *times[3], "bytes", None)


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
    """K3 at every distinct norm shape of the standard path, for each
    (relu, residual) the modules use plus the bare norm: fp32 within 1e-5
    abs of the plain version, bf16 within 1 ulp beyond that (see
    bf16_excess_ulps); deterministic; timed in bf16 beside F.instance_norm
    for the bare norm."""
    from jpdse_tpu_torch.ops import instance_norm as k3

    max_err = 0.0
    entry = None
    for shape in NORM_SHAPES:
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


def k3_launch_facts(k3, x, res) -> None:
    """One call of K3 is one kernel launch on the device (profiler); and
    whether its cooperative launch can be captured in a CUDA graph (the
    answer is logged either way); once captured, the replay must give the
    eager call's bits."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    k3.fused_instance_norm(x, res, relu=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        k3.fused_instance_norm(x, res, relu=True)
        torch.cuda.synchronize()
    kernels = {e.key: e.count for e in prof.key_averages() if e.device_type == DeviceType.CUDA}
    log(f"[kernels] K3 {tuple(x.shape)} one call under the profiler: device kernels {kernels}")
    if sum(kernels.values()) != 1:
        raise AssertionError(f"K3 ran {sum(kernels.values())} device kernels in one call, want 1")
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


def check_codes(what: str, got, want, presign) -> None:
    for name, f, s, p in zip(("netE4label", "netE"), got, want, presign):
        diff = f != s
        away = diff & (p.abs() >= 1e-5)
        if away.any():
            raise AssertionError(f"{what} {name} codes: {int(away.sum())} bits differ away from 0")
        log(f"[parity] {what} {name} codes {tuple(f.shape)}: {int(diff.sum())} of "
            f"{diff.numel()} bits differ (allowed only where |pre-sign| < 1e-5)")


def check_image(what: str, got, want) -> None:
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    log(f"[parity] {what} vs the default standard decode from the same codes, TF32 off "
        f"(cudnn.allow_tf32=False, matmul.allow_tf32=False): max abs diff {err:.3e} "
        f"(tolerance {FP32_ATOL})")
    if not err <= FP32_ATOL:
        raise AssertionError(f"{what} differs from the standard path by {err}")


def phase_fp32_parity(cfg, kcfg, codec, seed: int) -> None:
    """At full width in fp32, TF32 off for convolutions and matmuls, against
    the port's default standard path: the default fast path, the fast path
    in the kernel configuration (K1, K2, K4) and the standard path with K3."""
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
        for what, c in (("fp32 default fast path", cfg), ("fp32 kernel-config fast path", kcfg)):
            fast = FastCodec(c, state, device="cuda", dtype=torch.float32)
            reset_counts()
            check_codes(what, fast.get_codes_shaped(batch), std_codes, presign)
            check_image(what, fast.decode_from_codes(std_codes), std_img)
            log(f"[parity] {what}: kernel launches {read_counts()}")
        fused = SemanticCodec(kcfg, device="cuda", seed=None, dtype=torch.float32)
        fused.load_state_dict(state)
        reset_counts()
        with torch.inference_mode():
            check_codes("fp32 standard path with K3", fused.get_codes_shaped(fused.prepare(batch)),
                        std_codes, presign)
            check_image("fp32 standard path with K3", fused.decode_from_codes(std_codes), std_img)
        counts = read_counts()
        log(f"[parity] fp32 standard path with K3: kernel launches {counts}")
        if counts["fused_instance_norm"] != 45:
            raise AssertionError(f"K3 launched {counts['fused_instance_norm']} times, want 45")
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def serve_path(label: str, cfg, state, batches, want_compress: dict, want_decompress: dict,
               card: str):
    """Serve ``batches`` through a CodecServer with every kernel's count set
    to 0 just before and read just after, asserting each request's launches
    in compress and decompress. Returns (compress ms, decompress ms medians
    after the first request, counts over the run, last codes, last image)."""
    from jpdse_tpu_torch.serve import CodecServer

    torch.cuda.empty_cache()  # each path starts from the same allocator state
    server = CodecServer(cfg, state, device="cuda")
    m = cfg.model
    code_shapes = [
        (1, H // 2**m.n_downsample_E4label, W // 2**m.n_downsample_E4label,
         m.label_encoder_binarizer_out_channels),
        (1, H // 2**m.n_downsample_E, W // 2**m.n_downsample_E, m.encoder_binarizer_out_channels),
    ]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t_comp, t_dec = [], []
    reset_counts()
    for r, batch in enumerate(batches):
        before = read_counts()
        t0 = time.perf_counter()
        codes = server.compress(batch)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        mid = read_counts()
        image = server.decompress(codes)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        after = read_counts()
        t_comp.append(t1 - t0)
        t_dec.append(t2 - t1)
        for phase, lo, hi, want in (("compress", before, mid, want_compress),
                                    ("decompress", mid, after, want_decompress)):
            rose = {k: hi[k] - lo[k] for k in hi}
            if rose != {k: want.get(k, 0) for k in hi}:
                raise AssertionError(f"{label} request {r}: {phase} launched {rose}, want {want}")
        if [tuple(c.shape) for c in codes] != code_shapes or any(
            c.dtype != torch.uint8 or int(c.max()) > 1 for c in codes
        ):
            raise AssertionError(f"{label} request {r}: codes "
                                 f"{[(tuple(c.shape), c.dtype) for c in codes]}")
        if tuple(image.shape) != (1, H, W, 3) or not torch.isfinite(image).all() \
                or image.abs().max().item() > 1.0:
            raise AssertionError(f"{label} request {r}: image {tuple(image.shape)} not finite "
                                 "in [-1, 1]")
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    mp = H * W / 1e6
    for r in range(len(batches)):
        log(f"[serve] {label} request {r}: compress {t_comp[r] * 1e3:.2f} ms, decompress "
            f"{t_dec[r] * 1e3:.2f} ms ({card})")
    rest = slice(1, None) if len(batches) > 1 else slice(None)
    c_ms = float(np.median(t_comp[rest])) * 1e3
    d_ms = float(np.median(t_dec[rest])) * 1e3
    log(f"[serve] {label}: bf16 batch 1 at {W}x{H}, median of requests after the first: "
        f"compress {c_ms:.2f} ms ({mp / c_ms * 1e3:.2f} MP/s), decompress {d_ms:.2f} ms "
        f"({mp / d_ms * 1e3:.2f} MP/s), peak memory {peak:.2f} GiB ({card})")
    log(f"[serve] {label}: codes {code_shapes} uint8 in {{0,1}}; images (1, {H}, {W}, 3) "
        f"finite in [-1, 1]; launches {counts}, per request: compress {want_compress}, "
        f"decompress {want_decompress}")
    return c_ms, d_ms, counts, codes, image


def phase_serve(cfg, kcfg, codec, seed: int, requests: int, card: str) -> dict:
    """The four serving paths in bf16; returns each path's launch counts."""
    import copy

    state = codec.state_dict()
    batches = [make_batch(seed + 1 + r) for r in range(requests)]
    kstd, dstd = copy.deepcopy(kcfg), copy.deepcopy(cfg)
    kstd.model.fast_inference = dstd.model.fast_inference = False
    paths = {
        "default fast path": (cfg, {}, {"s2d_realign_pad3": 3}),
        "kernel-config fast path": (
            kcfg, {"s2d_realign_pad3": 1, "s2d_pad3": 1, "head_conv_s2d": 1},
            {"s2d_realign_pad3": 4, "head_conv_s2d": 1}),
        "kernel-config standard path": (
            kstd, {"fused_instance_norm": 10}, {"fused_instance_norm": 35}),
        # the same standard path without K3, to read K3's end-to-end effect
        "default standard path": (dstd, {}, {}),
    }
    results, launches = {}, {}
    for label, (c, want_c, want_d) in paths.items():
        c_ms, d_ms, counts, codes, image = serve_path(label, c, state, batches, want_c, want_d,
                                                     card)
        results[label], launches[label] = (c_ms, d_ms), counts
        if label == "default fast path":
            # the served bf16 image against the fp32 standard path on the same codes
            with torch.inference_mode():
                ref = codec.decode_from_codes([x.float() for x in codes])
            diff = (image - ref).abs()
            log(f"[serve] bf16 served image vs fp32 standard decode of its codes: max abs diff "
                f"{diff.max().item():.3e}, mean {diff.mean().item():.3e} (information)")
    base_c, base_d = results["default fast path"]
    for label, (c_ms, d_ms) in results.items():
        log(f"[serve] medians, {label}: compress {c_ms:.2f} ms ({c_ms / base_c:.3f}x the default "
            f"fast path's {base_c:.2f}), decompress {d_ms:.2f} ms ({d_ms / base_d:.3f}x its "
            f"{base_d:.2f}) ({card})")
    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--requests", type=int, default=4)
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
    log(f"[build] built {sorted(logs)} with nvcc in {time.perf_counter() - t0:.1f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"[build] {name}: {line.strip()}")

    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    entries = [phase_k1(card, gen), phase_k2(card, gen), phase_k3(card, gen),
               phase_k4(card, gen)]

    cfg = flagship_config()
    kcfg = flagship_config(kernels=True)
    codec = SemanticCodec(cfg, device="cuda", seed=args.seed, dtype=torch.float32)
    n_params = sum(p.numel() for p in codec.parameters())
    log(f"[serve] flagship codec, {n_params} parameters from seed {args.seed}")
    phase_fp32_parity(cfg, kcfg, codec, args.seed)
    launches = phase_serve(cfg, kcfg, codec, args.seed, args.requests, card)
    for e in entries:
        by_path = {label: counts[e["name"]] for label, counts in launches.items()}
        e["launches"] = sum(by_path.values())
        e["launches_by_path"] = by_path
        if e["launches"] == 0:
            raise AssertionError(f"{e['name']} was not launched on any serving path")

    log(card)
    log(json.dumps({"kernels": entries}))
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
