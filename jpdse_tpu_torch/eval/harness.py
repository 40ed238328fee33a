"""Evaluation harness, the port of ``jpdse_tpu/eval/harness.py``: optional
input noise, the rate of the binary codes (Shannon estimate, raw length and
the real range-coded bytes), the rate of the side info (the base codec's
stream bytes as ``base_codec_bpp``, the id maps as ``pack`` codes them as
``sem_side_bpp``) and the total a receiver needs, the reconstruction
gallery, the code dumps (``codes/<name>_code`` raw, ``<name>_code.rc``
coded), and L1 / MSE / PSNR / MS-SSIM on denormalized uint8 images,
computed on the device and weighted per image.

Each batch's line also gives the host-clock split of its time: waiting for
the loader (decode and preprocess not hidden by prefetching), the device
path (rate, codes, reconstruction, ending on the host), the range coder,
the metrics and the gallery write.
"""

from __future__ import annotations

import os
import time
from typing import Dict

import numpy as np
import torch

from jpdse_tpu_torch import native
from jpdse_tpu_torch.codec_io import downsample_ids, sem_side_blobs, side_requirements
from jpdse_tpu_torch.config import Config, check_ported
from jpdse_tpu_torch.ops.metrics import denormalize_to_uint8, ms_ssim, psnr


def add_noise(batch: Dict, cfg: Config, rng: np.random.Generator) -> Dict:
    """Test-time robustness: Gaussian noise on the normalized image,
    clipped to the image's own range. Other distributions raise."""
    img = batch["image"]
    mx, mn = img.max(), img.min()
    if "normal" in cfg.data.noise_distribution:
        noise = rng.normal(cfg.data.noise_mean, cfg.data.noise_std, img.shape)
        img = img + noise.astype(np.float32)
    else:
        raise NotImplementedError(f"noise distribution {cfg.data.noise_distribution} not supported")
    batch["image"] = np.clip(img, mn, mx)
    return batch


def coded_stream(code: np.ndarray, contexts: np.ndarray, shapes) -> bytes:
    """One image's flat code range-coded both ways, the smaller stream
    behind a one-byte marker of its contexts (0 per-channel, 1 spatial)."""
    code = code.astype(np.uint8)
    stream = native.entropy_encode(code, contexts=contexts)
    spatial = native.entropy_encode_spatial(code, shapes)
    if len(spatial) < len(stream):
        return b"\x01" + spatial
    return b"\x00" + stream


def evaluate(cfg: Config, trainer, loader, visualizer=None, gallery=None,
             write: bool = True) -> Dict[str, float]:
    """Run the evaluation; returns the metrics averaged per image. Without
    ``write`` (a rank other than 0 of a process group, which evaluates the
    same unsharded set) the codes are coded and counted but no file is
    written."""
    check_ported(cfg)
    try:
        need_label, need_inst, need_base = side_requirements(cfg)
    except ValueError:  # raw uncompressed visuals: not deployable, no side accounting
        need_label = need_inst = need_base = False
    get_codes = not cfg.do_not_get_codes and cfg.has_binary_codes
    if not cfg.do_not_get_codes and not cfg.has_binary_codes:
        print("note: no binarized module in this configuration; skipping code dumps")
    if get_codes and cfg.save_dir and write:
        os.makedirs(os.path.join(cfg.save_dir, "codes"), exist_ok=True)

    rng = np.random.default_rng(cfg.optim.seed or 0)
    mean, std = cfg.data.normalize_mean, cfg.data.normalize_std
    totals: Dict[str, float] = {
        "L1": 0.0, "MSE": 0.0, "PSNR": 0.0, "MS-SSIM": 0.0,
        "shannon_bpp": 0.0, "actual_bpp": 0.0,
    }
    n_images = 0
    start = time.time()
    t_wait = time.perf_counter()
    for i, batch in enumerate(loader):
        split = {"load": time.perf_counter() - t_wait}
        if cfg.data.add_noise:
            batch = add_noise(batch, cfg, rng)
        h, w = batch["image"].shape[1:3]
        b = batch["image"].shape[0]
        if "base_codec_bytes" in batch:
            totals["base_codec_bpp"] = totals.get("base_codec_bpp", 0.0) + float(
                np.sum(np.asarray(batch["base_codec_bytes"], np.float64)) * 8.0 / (h * w))
        t0 = time.perf_counter()
        if need_label or need_inst:
            totals["sem_side_bpp"] = totals.get("sem_side_bpp", 0.0) + sem_side_bytes(
                cfg, batch, need_label, need_inst) * 8.0 / (h * w)
        split["side"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        dev = trainer.place(batch)
        if get_codes:
            shannon_bpp, actual_bpp = trainer.get_eval_rate(dev)
            totals["shannon_bpp"] += shannon_bpp * b
            totals["actual_bpp"] += actual_bpp * b
        recon = trainer.get_img(dev)
        codes = contexts = code_shapes = None
        if get_codes and cfg.save_dir:
            codes, contexts, code_shapes = trainer.get_code_and_contexts(dev)
        recon_host = recon.cpu().numpy()
        split["device"] = time.perf_counter() - t0

        split["coder"] = split["gallery"] = 0.0
        for j in range(b):
            if visualizer is not None and gallery is not None:
                t0 = time.perf_counter()
                visuals = {}
                if not cfg.model.no_label:
                    visuals["label"] = batch["label"][j]
                visuals["image"] = batch["image"][j]
                visuals["reconstructed_image"] = recon_host[j]
                visualizer.save_images(gallery, visuals, batch["path"][j])
                split["gallery"] += time.perf_counter() - t0
            if codes is not None:
                t0 = time.perf_counter()
                base = os.path.splitext(os.path.basename(batch["path"][j]))[0]
                code_path = os.path.join(cfg.save_dir, "codes", base + "_code")
                stream = coded_stream(codes[j], contexts, code_shapes)
                if write:
                    with open(code_path, "wb") as f:
                        f.write(codes[j].astype(np.uint8).tobytes())
                    with open(code_path + ".rc", "wb") as f:
                        f.write(stream)
                totals["coded_bpp"] = totals.get("coded_bpp", 0.0) + len(stream) * 8.0 / (h * w)
                split["coder"] += time.perf_counter() - t0
        if gallery is not None:
            t0 = time.perf_counter()
            gallery.save()
            split["gallery"] += time.perf_counter() - t0

        t0 = time.perf_counter()
        recon_u8 = denormalize_to_uint8(recon, mean, std)
        real_u8 = denormalize_to_uint8(dev["image"], mean, std)
        diff = recon_u8 - real_u8
        # one host fetch of the four numbers
        l1_v, mse_v, psnr_v, msssim_v = torch.stack([
            diff.abs().mean(), (diff**2).mean(), psnr(recon_u8, real_u8),
            ms_ssim(recon_u8, real_u8)]).cpu().tolist()
        split["metrics"] = time.perf_counter() - t0
        totals["L1"] += l1_v * b
        totals["MSE"] += mse_v * b
        totals["PSNR"] += psnr_v * b
        totals["MS-SSIM"] += msssim_v * b
        n_images += b

        end = time.time()
        print(
            f"batch {i + 1}/{len(loader)}, recon loss (L1/MSE/MS-SSIM/PSNR) "
            f"{l1_v:.4f}/{mse_v:.4f}/{msssim_v:.4f}/{psnr_v:.2f}dB, "
            f"batch processing time (s) {end - start:.4f} (host clock: load "
            f"{split['load']:.4f}, device {split['device']:.4f}, coder {split['coder']:.4f}, "
            f"metrics {split['metrics']:.4f}, gallery {split['gallery']:.4f}, "
            f"side {split['side']:.4f})"
        )
        start = time.time()
        t_wait = time.perf_counter()

    avgs = {k: v / max(n_images, 1) for k, v in totals.items()}
    # total_bpp: every byte a receiver needs: the coded learned codes, the
    # id maps, and the base codec's streams only where the receiver decodes
    # them (with a binarized netE the base codec only feeds the encoder)
    if cfg.has_binary_codes and not get_codes:
        avgs["total_bpp"] = None  # the learned-code rate was not measured
    else:
        learned = avgs.get("coded_bpp")
        if learned is None:
            learned = avgs.get("actual_bpp", 0.0) if get_codes else 0.0
        avgs["total_bpp"] = learned + avgs.get("sem_side_bpp", 0.0)
        if need_base:
            avgs["total_bpp"] += avgs.get("base_codec_bpp", 0.0)
    avgs["n_images"] = n_images
    return avgs


def sem_side_bytes(cfg: Config, batch: Dict, need_label: bool, need_inst: bool) -> int:
    """The bytes of the batch's id-map sections, as ``codec_io.pack`` writes
    them (at ``codec.sem_downsample``)."""
    f = cfg.codec.sem_downsample
    n = 0
    for j in range(batch["image"].shape[0]):
        label = inst = None
        if need_label and "label" in batch:
            label = downsample_ids(np.asarray(batch["label"][j]).astype(np.int32), f)
        if need_inst and "instance" in batch:
            inst = downsample_ids(np.asarray(batch["instance"][j]), f)
        n += sum(len(blob) for blob in sem_side_blobs(label, inst)[:2] if blob)
    return n
