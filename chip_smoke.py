#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--requests N]

Phases, each printing a line as it ends:
  1. environment: the card's name and power limit, torch and CUDA versions;
  2. build: every kernel under jpdse_tpu_torch/csrc/ with nvcc, in parallel;
  3. kernels: each kernel against its plain PyTorch version on the card at
     the serving path's shapes (bit-exact for data movement), and timed;
  4. the flagship codec at full width (Cityscapes 1024x512, random weights
     from --seed): the s2d fast path against the port's standard path in
     fp32, then a CodecServer serving --requests requests in bf16, compress
     to binary codes and decompress from the codes alone, with the kernels'
     launch counts read around it;
  5. summary: the card, a JSON line of per-kernel numbers, the total
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

H, W = 512, 1024
FP32_ATOL = 1e-3
MEM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (data sheet)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


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


def make_batch(seed: int, b: int = 1):
    """A synthetic Cityscapes-like request, as __graft_entry__._batch makes
    it: labels in [0, 35), instance ids, a normal-distributed image."""
    rng = np.random.default_rng(seed)
    return {
        "label": rng.integers(0, 35, (b, H, W)).astype(np.float32),
        "instance": rng.integers(0, 1000, (b, H, W)).astype(np.int32),
        "image": rng.normal(size=(b, H, W, 3)).astype(np.float32),
    }


def phase_kernels(card: str) -> dict:
    """K1 against its plain version; returns its numbers for the summary."""
    from jpdse_tpu_torch.ops import realign

    dev = "cuda"
    max_err = 0.0
    cases = [
        ((2, 256, 512, 256), torch.float32, 0),
        ((2, 256, 512, 256), torch.bfloat16, 0),
        ((1, 5, 7, 20), torch.float32, 0),  # odd ws, C=5: the element-wise path
        ((1, 5, 7, 20), torch.bfloat16, 0),
        ((1, 8, 7, 20), torch.float32, 4),
        ((2, 16, 20, 256), torch.bfloat16, 4),
    ]
    gen = torch.Generator(device=dev).manual_seed(0)
    for shape, dtype, extra in cases:
        y = torch.randn(shape, device=dev, generator=gen).to(dtype)
        got = realign.s2d_realign_pad3(y, extra)
        want = realign.s2d_realign_pad3_plain(y, extra)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"K1 differs from its plain version at {shape} {dtype} extra_rows={extra}")
        max_err = max(max_err, (got.float() - want.float()).abs().max().item())
        log(f"[kernels] K1 s2d_realign_pad3 {tuple(shape)} {str(dtype)[6:]} "
            f"extra_rows={extra}: bit-exact (torch.equal)")

    def timed(shape, dtype):
        y = torch.randn(shape, device=dev, generator=gen).to(dtype)
        k = cuda_ms(lambda: realign.s2d_realign_pad3(y))
        p = cuda_ms(lambda: realign.s2d_realign_pad3_plain(y))
        out_numel = shape[0] * (shape[1] + 3) * (shape[2] + 3) * shape[3]
        bound_ms = (y.numel() + out_numel) * y.element_size() / MEM_BYTES_PER_S * 1e3
        log(f"[kernels] K1 {tuple(shape)} {str(dtype)[6:]}: kernel {k:.4f} ms, "
            f"plain {p:.4f} ms, bound {bound_ms * 1e3:.1f} us (bytes) ({card})")
        return k, p, bound_ms

    timed((2, 256, 512, 256), torch.float32)
    timed((2, 256, 512, 256), torch.bfloat16)
    # the serving path's own shape: B=1, bf16
    k, p, bound_ms = timed((1, 256, 512, 256), torch.bfloat16)
    return {
        "name": "s2d_realign_pad3", "route": "cuda",
        "source": "jpdse_tpu_torch/csrc/realign.cu",
        "replaces": "jpdse_tpu/ops/pallas/realign.py:67",
        "max_abs_err": max_err, "ms": k, "plain_ms": p,
        "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": None,
    }


def phase_fp32_parity(cfg, codec, seed: int) -> None:
    """The s2d fast path against the port's standard path at full width in
    fp32, TF32 off for convolutions and matmuls."""
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
        fast = FastCodec(cfg, codec.state_dict(), device="cuda", dtype=torch.float32)
        fast_codes = fast.get_codes_shaped(batch)
        for name, f, s, p in zip(("netE4label", "netE"), fast_codes, std_codes, presign):
            diff = f != s
            away = diff & (p.abs() >= 1e-5)
            if away.any():
                raise AssertionError(f"fp32 {name} codes: {int(away.sum())} bits differ away from 0")
            log(f"[serve] fp32 {name} codes {tuple(f.shape)}: {int(diff.sum())} of {diff.numel()} "
                "bits differ (allowed only where |pre-sign| < 1e-5)")
        fast_img = fast.decode_from_codes(std_codes)
        torch.cuda.synchronize()
        err = (fast_img - std_img).abs().max().item()
        log(f"[serve] fp32 fast vs standard decode from the same codes, TF32 off "
            f"(cudnn.allow_tf32=False, matmul.allow_tf32=False): max abs diff {err:.3e} "
            f"(tolerance {FP32_ATOL})")
        if not err <= FP32_ATOL:
            raise AssertionError(f"fp32 fast path differs from the standard path by {err}")
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def phase_serve(cfg, codec, seed: int, requests: int, card: str) -> int:
    """CodecServer at the flagship's bf16; returns K1's launches in the run."""
    from jpdse_tpu_torch.ops import realign
    from jpdse_tpu_torch.serve import CodecServer

    server = CodecServer(cfg, codec.state_dict(), device="cuda")
    m = cfg.model
    code_shapes = [
        (1, H // 2**m.n_downsample_E4label, W // 2**m.n_downsample_E4label,
         m.label_encoder_binarizer_out_channels),
        (1, H // 2**m.n_downsample_E, W // 2**m.n_downsample_E, m.encoder_binarizer_out_channels),
    ]
    batches = [make_batch(seed + 1 + r) for r in range(requests)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t_comp, t_dec = [], []
    realign.s2d_realign_pad3.launches = 0
    for r, batch in enumerate(batches):
        t0 = time.perf_counter()
        codes = server.compress(batch)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        after_compress = realign.s2d_realign_pad3.launches
        image = server.decompress(codes)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        t_comp.append(t1 - t0)
        t_dec.append(t2 - t1)
        rose = realign.s2d_realign_pad3.launches - after_compress
        if rose != 3:
            raise AssertionError(f"request {r}: K1 launched {rose} times in decompress, want 3")
        if [tuple(c.shape) for c in codes] != code_shapes or any(
            c.dtype != torch.uint8 or int(c.max()) > 1 for c in codes
        ):
            raise AssertionError(f"request {r}: codes {[(tuple(c.shape), c.dtype) for c in codes]}")
        if tuple(image.shape) != (1, H, W, 3) or not torch.isfinite(image).all() \
                or image.abs().max().item() > 1.0:
            raise AssertionError(f"request {r}: image {tuple(image.shape)} not finite in [-1, 1]")
    launches = realign.s2d_realign_pad3.launches
    peak = torch.cuda.max_memory_allocated() / 2**30
    mp = H * W / 1e6
    for r in range(requests):
        log(f"[serve] request {r}: compress {t_comp[r] * 1e3:.2f} ms, decompress "
            f"{t_dec[r] * 1e3:.2f} ms ({card})")
    rest = slice(1, None) if requests > 1 else slice(None)
    c_ms = float(np.median(t_comp[rest])) * 1e3
    d_ms = float(np.median(t_dec[rest])) * 1e3
    log(f"[serve] bf16 batch 1 at {W}x{H}, median of requests after the first: compress "
        f"{c_ms:.2f} ms ({mp / c_ms * 1e3:.2f} MP/s), decompress {d_ms:.2f} ms "
        f"({mp / d_ms * 1e3:.2f} MP/s), peak memory {peak:.2f} GiB ({card})")
    log(f"[serve] codes {code_shapes} uint8 in {{0,1}}; images (1, {H}, {W}, 3) finite in "
        f"[-1, 1]; K1 launched {launches} times, 3 per decompress")

    # the served bf16 image against the fp32 standard path on the same codes
    with torch.inference_mode():
        ref = codec.decode_from_codes([c.float() for c in codes])
    diff = (image - ref).abs()
    log(f"[serve] bf16 served image vs fp32 standard decode of its codes: max abs diff "
        f"{diff.max().item():.3e}, mean {diff.mean().item():.3e} (information)")
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
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")

    k1 = phase_kernels(card)

    cfg = flagship_config()
    codec = SemanticCodec(cfg, device="cuda", seed=args.seed, dtype=torch.float32)
    n_params = sum(p.numel() for p in codec.parameters())
    log(f"[serve] flagship codec, {n_params} parameters from seed {args.seed}")
    phase_fp32_parity(cfg, codec, args.seed)
    k1["launches"] = phase_serve(cfg, codec, args.seed, args.requests, card)

    log(card)
    log(json.dumps({"kernels": [k1]}))
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
