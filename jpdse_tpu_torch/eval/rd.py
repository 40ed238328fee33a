"""Rate-distortion measurements, the twins of the repository's
``tools/measure_rd.py`` (``parity``) and ``tools/base_codec_rd.py``
(``base``). Both read Cityscapes images at 1024x512 and score uint8
images (PSNR, MS-SSIM, L1, MSE) with ``ops/metrics.py``; the rate is the
base codec's real stream bytes over the pixels.

``parity``: the phase-2 inference configuration (``no_label_encoding``,
``no_feat_encoding``, ``no_generator_binarization``, ``use_compressed``;
'fixed' preprocessing at ``--crop``, std 1) through two stacks per
base-codec quality. The golden one is the reference's generator rebuilt
from its spec with seeded reference-init weights
(``convert/torch_ref.py``); the same weights go into the port through
``convert/torch_import.py``, decoded on the standard path or, with
``--fast``, on the s2d fast path. Each image's generator input is
assembled by both, independently, and must agree bit for bit. A point
passes where |dPSNR| <= 0.05 dB and |dMS-SSIM| <= 0.001 between the
stacks; ``main`` returns the points and whether all passed, and the
module's command exits 1 where one failed. On the card both stacks run
there in fp32 with TF32 off, so the bar measures the port, not the
convolutions' precision.

``base``: the base codec alone over ``leftImg8bit/<mode>/*/*.png``,
bicubic to ``--width`` x ``--height``: the line the learned codec is
compared with at matched bpp. heif raises ``CodecUnavailable`` where
libheif does not load; use jpg, webp or j2k there.

    python -m jpdse_tpu_torch.eval.rd parity --root DATA --ext jpg \\
        --qualities 30,50,70,90 --out rd_results_jpg.json [--fast]
    python -m jpdse_tpu_torch.eval.rd base --root DATA --mode val --ext jpg \\
        --qualities 20,50,80 --out base_codec_rd.json

Runs on the card; ``--device cpu`` (or ``main(argv, device="cpu")``) runs
it on the CPU.
"""

from __future__ import annotations

import argparse
import contextlib
import glob
import json
import os
import sys
import time
from typing import List, Optional

import numpy as np
import torch
from PIL import Image

from jpdse_tpu_torch.codecs.bridge import encode_decode
from jpdse_tpu_torch.config import Config, PreprocessConfig, apply_dataset_defaults
from jpdse_tpu_torch.convert import torch_ref
from jpdse_tpu_torch.convert.torch_import import convert_global_generator
from jpdse_tpu_torch.data import create_dataloader
from jpdse_tpu_torch.data.prefetch import DEVICE_KEYS, to_device
from jpdse_tpu_torch.models.codec import prepare_inputs
from jpdse_tpu_torch.ops.metrics import denormalize_to_uint8, ms_ssim, psnr
from jpdse_tpu_torch.platform import resolve_device
from jpdse_tpu_torch.serve import CodecServer

DPSNR_MAX = 0.05  # dB
DMSSSIM_MAX = 0.001


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="what", required=True)
    par = sub.add_parser("parity", help="the port against the golden reference stack")
    par.add_argument("--ext", default="jpg",
                     choices=["jpg", "webp", "j2k", "avif", "heif", "bpg"])
    par.add_argument("--qualities", default="30,50,70,90")
    par.add_argument("--n-images", type=int, default=30)
    par.add_argument("--ngf", type=int, default=64)
    par.add_argument("--n-down", type=int, default=4)
    par.add_argument("--n-blocks", type=int, default=9)
    par.add_argument("--crop", type=int, default=1024)
    par.add_argument("--seed", type=int, default=0)
    par.add_argument("--fast", action="store_true",
                     help="decode through the s2d fast path (models/fast_codec.py)")
    par.add_argument("--out", default="rd_results.json")
    par.add_argument("--root", default="datasets/cityscapes_split")
    base = sub.add_parser("base", help="the base codec alone")
    base.add_argument("--root", default="datasets/cityscapes_split")
    base.add_argument("--mode", default="val")
    base.add_argument("--ext", default="heif")
    base.add_argument("--qualities", default="20,30,40,50,60,70")
    base.add_argument("--width", type=int, default=1024)
    base.add_argument("--height", type=int, default=512)
    base.add_argument("--out", default="base_codec_rd.json")
    for p in (par, base):
        p.add_argument("--device", default=None,
                       help="where to run (default: main's device, the card)")
    return ap.parse_args(argv)


@contextlib.contextmanager
def tf32_off():
    """Convolutions and matmuls in fp32 on the card (TF32 off), restored
    after."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def image_metrics(rec_u8: torch.Tensor, real_u8: torch.Tensor) -> dict:
    """PSNR, MS-SSIM, L1 and MSE of one uint8-valued image (H, W, 3) against
    another, with one fetch from the device."""
    diff = rec_u8.float() - real_u8.float()
    vals = torch.stack([psnr(rec_u8, real_u8), ms_ssim(rec_u8[None], real_u8[None]),
                        diff.abs().mean(), (diff * diff).mean()]).tolist()
    return dict(zip(("psnr", "msssim", "l1", "mse"), vals))


def parity_config(args: argparse.Namespace) -> Config:
    """The phase-2 inference configuration the parity bar is measured at."""
    cfg = Config()
    cfg.mode = "val"
    cfg.is_train = False
    cfg.data.dataset = "cityscapes"
    apply_dataset_defaults(cfg)
    cfg.data.root_dir = args.root
    cfg.data.num_workers = 0
    cfg.data.max_dataset_size = args.n_images
    cfg.data.preprocess = PreprocessConfig("fixed", args.crop, args.crop, 2.0)
    cfg.data.normalize_std = (1.0, 1.0, 1.0)
    m = cfg.model
    m.no_label_encoding = True
    m.no_feat_encoding = True
    m.no_generator_binarization = True
    m.ngf = args.ngf
    m.n_downsample_global = args.n_down
    m.n_blocks_global = args.n_blocks
    m.fast_inference = args.fast
    cfg.codec.use_compressed = True
    cfg.codec.ext = args.ext
    cfg.validate()
    return cfg


def _synced_ms(device: torch.device, t0: float) -> float:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return (time.perf_counter() - t0) * 1e3


@torch.no_grad()
def parity(args: argparse.Namespace, device: torch.device) -> dict:
    cfg = parity_config(args)
    sem_nc = cfg.data.semantic_nc
    gen_t = torch_ref.build_phase2_generator(sem_nc, cfg.model.input_nc, args.ngf, args.n_down,
                                             args.n_blocks, seed=args.seed)
    state = {f"netG.{k}": v for k, v in convert_global_generator(
        gen_t.state_dict(), args.n_down, args.n_blocks, binarize=False).items()}
    gen_t = gen_t.to(device)
    server = CodecServer(cfg, state, device=device)
    mean, std = cfg.data.normalize_mean, cfg.data.normalize_std
    h, w = args.crop // 2, args.crop
    results = {"config": vars(args), "points": []}
    tags = ("port", "torch")

    for q in [int(x) for x in args.qualities.split(",")]:
        cfg.codec.quality = (q,)
        acc = {f"{k}_{t}": 0.0 for k in ("psnr", "msssim", "l1", "mse", "ms") for t in tags}
        acc["bpp"] = 0.0
        n = 0
        t_start = time.time()
        for batch in create_dataloader(cfg):
            placed = {k: to_device(batch[k], device) for k in DEVICE_KEYS if k in batch}
            t0 = time.perf_counter()
            fake_p = server.decode(placed)
            ms_port = _synced_ms(device, t0) / fake_p.shape[0]
            nbytes = np.asarray(batch["base_codec_bytes"]).reshape(-1)
            for j in range(fake_p.shape[0]):
                g_in = torch_ref.phase2_generator_input(
                    np.asarray(batch["label"][j]), np.asarray(batch["instance"][j]),
                    np.asarray(batch["compressed"][j]), sem_nc)
                # the two stacks' generator inputs, assembled independently, agree bit for bit
                one = {k: v[j:j + 1] for k, v in placed.items()}
                port_in = prepare_inputs(cfg, one["label"], one["instance"], one["image"],
                                         one["compressed"])
                port_cat = torch.cat([port_in["input_label"][0], port_in["compressed_img"][0]], -1)
                g_in_t = torch.from_numpy(g_in).to(device)
                pp_err = float((g_in_t - port_cat).abs().max())
                if pp_err != 0.0:
                    raise AssertionError(f"preprocessing mismatch: {pp_err}")
                t0 = time.perf_counter()
                fake_t = gen_t(g_in_t.permute(2, 0, 1)[None].contiguous()).permute(0, 2, 3, 1)[0]
                ms_torch = _synced_ms(device, t0)
                real_u8 = denormalize_to_uint8(placed["image"][j], mean, std)
                for tag, rec, ms in (("port", fake_p[j], ms_port), ("torch", fake_t, ms_torch)):
                    for k, v in image_metrics(denormalize_to_uint8(rec, mean, std),
                                              real_u8).items():
                        acc[f"{k}_{tag}"] += v
                    acc[f"ms_{tag}"] += ms
                acc["bpp"] += float(nbytes[j]) * 8.0 / (h * w)
                n += 1
            print(f"[{args.ext} q={q}] {n}/{args.n_images} ({time.time() - t_start:.0f}s "
                  f"elapsed)", flush=True)
        point = {k: v / n for k, v in acc.items()}
        point.update(ext=args.ext, quality=q, n_images=n)
        point["dpsnr"] = abs(point["psnr_port"] - point["psnr_torch"])
        point["dmsssim"] = abs(point["msssim_port"] - point["msssim_torch"])
        point["verdict"] = ("OK" if point["dpsnr"] <= DPSNR_MAX
                            and point["dmsssim"] <= DMSSSIM_MAX else "FAIL")
        results["points"].append(point)
        print(json.dumps(point), flush=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)

    print("\n=== parity summary ===")
    for p in results["points"]:
        print(f"{p['ext']} q={p['quality']}: bpp={p['bpp']:.4f} "
              f"PSNR {p['psnr_port']:.3f} vs {p['psnr_torch']:.3f} "
              f"(d={p['dpsnr']:.4f}dB) MS-SSIM {p['msssim_port']:.5f} vs "
              f"{p['msssim_torch']:.5f} (d={p['dmsssim']:.6f}) [{p['verdict']}]; "
              f"ms an image {p['ms_port']:.2f} port, {p['ms_torch']:.2f} golden")
    results["ok"] = all(p["verdict"] == "OK" for p in results["points"])
    return results


@torch.no_grad()
def base(args: argparse.Namespace, device: torch.device) -> dict:
    paths = sorted(glob.glob(os.path.join(args.root, "leftImg8bit", args.mode, "*", "*.png")))
    if not paths:
        raise SystemExit(f"no images under {args.root}/leftImg8bit/{args.mode}")
    print(f"{len(paths)} images, ext={args.ext}")
    rows = []
    for q in [int(x) for x in args.qualities.split(",")]:
        tot = {"bpp": 0.0, "psnr": 0.0, "msssim": 0.0, "l1": 0.0}
        for p in paths:
            img = Image.open(p).convert("RGB").resize((args.width, args.height), Image.BICUBIC)
            dec, nbytes = encode_decode(img, args.ext, q)
            a = torch.from_numpy(np.asarray(img, np.float32)).to(device)
            b = torch.from_numpy(np.asarray(dec, np.float32)).to(device)
            m = image_metrics(a, b)
            tot["bpp"] += nbytes * 8.0 / (args.width * args.height)
            for k in ("psnr", "msssim", "l1"):
                tot[k] += m[k]
        row = {"ext": args.ext, "quality": q, **{k: v / len(paths) for k, v in tot.items()}}
        rows.append(row)
        print(f"q={q}: bpp {row['bpp']:.4f}, PSNR {row['psnr']:.2f} dB, "
              f"MS-SSIM {row['msssim']:.4f}, L1 {row['l1']:.2f}")
    result = {"images": len(paths), "rows": rows}
    with open(args.out, "w") as f:
        json.dump(result, f, indent=2)
    print(f"wrote {args.out}")
    return result


def main(argv: Optional[List[str]] = None, device="cuda") -> dict:
    args = parse_args(argv)
    device = resolve_device(args.device or device)
    with tf32_off():
        return parity(args, device) if args.what == "parity" else base(args, device)


if __name__ == "__main__":
    out = main()
    sys.exit(0 if out.get("ok", True) else 1)
