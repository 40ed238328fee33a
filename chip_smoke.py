#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU, or on four.

    python3 chip_smoke.py [--seed N] [--requests N] [--train-steps N]
    python3 chip_smoke.py --cards 4 [--seed N]

With no --cards (or --cards 1) it runs phases 1-17 and the summary on
card 0. --cards 4 runs phase 18 alone, below.

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
     the hires recipe's shapes among them: K1 at (1, 512, 1024, 128) and as
     the producer of its 2048x1024 head, K3 and its backward at (1, 1024,
     2048, 32), K4 on that head with N = 128; K3's partial-statistics form
     (the spatial axis: stats, apply, backward sums, backward dx) at two
     ranks' halves of every norm shape against its plain versions and the
     one-launch plain form of the whole, timed at (1, 256, 1024, 64) bf16,
     and on the spatial axis's uneven and empty rank slabs (each slab's
     four launches against their plain versions, an empty slab's launches
     included; timed on a rank's 21 of 43 rows and on an empty slab);
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
  9. the base-codec recipe (artifacts/flagship_r3_compressed/phase{A,B}/
     opt.json: raw one-hot semantics and the edge map beside a base codec's
     decoded image into netG, no encoder, no code; batch 2 at 1024x512, fp32,
     block remat, cache_images; phase A the GAN, phase B distortion only) at
     full width. Its base codec is fixed to jpg q50 (BASE_CODEC, the tracked
     jpg base-codec recipe's quality) in place of the recipe's heif q30:
     libheif does not load on the card's machine. (0) the probe: the codecs
     the machine offers, heif raising CodecUnavailable, one encode and one
     decode of a 1024x512 scene timed on the host; (a) and (b) as in 7 for
     phase A, with K3 at netG's 27 norm sites (54 forward and 27 backward
     launches a step), the base codec's round trip done before the timed
     steps; (c) phase A through train.run.main on a synthetic split read by
     PairedDataset with cache_images, two epochs of 2 steps with each
     epoch's loader wait, and phase B restored from it, every leaf matched;
     (d) fp32 images of three paths against the default standard path,
     then --requests bf16 requests through side-info-only .jpds streams on
     the four serving paths: no launch in a compress, K1 on the fast paths,
     K4 on the kernel configuration's fast path, K3 on its standard path
     per decompress, the stream's bytes by section (id maps, base codec) and
     the host stages (id-map coding, the base codec's decode) beside the
     device part; (e) netG over the decoded image alone (flagship_r4_nosem's
     model) on the kernel configuration's fast path, K2 on its 3-channel
     front; (f) test.main, compress.main and decompress.main on the kernel
     configuration's fast path, each .jpds file as long as sem_side_bpp and
     base_codec_bpp say plus its container;
 10. the hires recipe (artifacts/flagship_r3_hires/phase{A,B}/opt.json: phase
     9's assembly into a LocalEnhancer, ngf 32 (its global trunk at 64 on
     the input pooled to 1024x512, one enhancer of 3 res blocks), batch 1 at
     2048x1024, fp32, block remat; BASE_CODEC in place of heif q30, nothing
     else cut): (a) as in 7 with the trunk unfrozen (K3 72 / 36 a step,
     each launch against its plain version, the (1, 1024, 2048, 32) slab
     among them); (b) --train-steps steps of each configuration with the
     trunk frozen (K3 45 / 9), then as many unfrozen, timed apart, each with
     one profiled step; (0) and (c) phase 9's phase-A weights re-nested by
     the warm-start module (jpdse_tpu_torch.train.warmstart), phase A through
     train.run.main from it (every trunk leaf but the tail restored, the
     count asserted), the trunk bit-equal through its frozen epoch and
     trained in the next, phase B restored from it; (d) fp32 images of three
     paths against the default standard path, then --requests bf16 requests
     through side-info-only .jpds streams at 2048x1024 on the four paths (no
     launch in a compress; K1 1 per decompress on the default fast path; K1
     3 + K4 2, N 256 and 128, on the kernel configuration's; K3 36 on its
     standard path); (e) test.main, compress.main and decompress.main on the
     kernel configuration's fast path, 2 images, each .jpds as long as the
     rates say plus its container; (f) a grouped netE (3 groups) with
     instance-wise pooling on the standard path, kernel against default
     configuration, fp32;
 11. the training options: the phase-2 recipe (batch 2 at 1024x512, full
     width and depth, random weights from --seed) (a) through the fast
     train decode (optim.fast_train, models/fast_train.py) against the
     standard decode, one loss_and_grads in fp32 with TF32 off and both
     decodes' binarizers deterministic, every run on the standard
     decode's code bits: metrics within 1e-3 of max(1, |m|), G's gradients
     by phase 7 (a)'s rule, a tensor over it arbitrated by the same step
     of both decodes in float64 (every tensor of G and D within 1e-9 in
     relative L2), K1, K2 and K4 launched 0 times; (b) --train-steps
     steps with fast train off, on, on, off, then with the bf16 VGG
     (optim.vgg_bf16), each with one step on a placed batch that copies
     nothing of pixel size to the card and one profiled step; (c) one step
     with model.use_dropout in the default and the kernel configuration:
     each res block's mask keeps 1/2 within 0.01, K3 90 / 45 a step, the
     eval decode bit-equal to the codec's without dropout; (d) the device
     cache (data/device_cache.py) on a synthetic split: an epoch's cached
     batches bit-equal to the host batches on the card for the phase-2
     recipe and base-codec phase A (both flip variants of its jpg round
     trip cached), prefetched host batches too, a profiled cached step
     without a host-to-device copy of pixel size (and a host one with
     them), train.run.main with the cache on and off in both configurations
     (the "resident" line, loader waits, step times) and phase A with it;
     (e) --profile_dir: one trace, of the first epoch, naming K3's kernels
     in the kernel configuration;
 12. data-parallel training and the reference-checkpoint import: (a) the
     phase-2 recipe in the kernel configuration through a process group of
     one rank on NCCL against the single-process path, two steps, each from
     the single-process path's parameters and Adams and on its code bits
     (PinnedSigns), held by phase 7 (a)'s rule with its two controls, K3
     90 / 45 a step on both, the all-reduced gradients and metrics
     bit-equal to their input, then both paths timed; (b) two ranks on the
     one card over gloo (NCCL refuses two ranks on one device), spawned,
     each stepping batch 1, its row of the global batch of 2, held against
     one process's step on the global batch by the same rule (hold_layout,
     as phase 18's), the ranks' uniforms gathered bit-equal to that
     step's, every K3 launch against its plain version, the gradients and
     the parameters after the step bit-equal across the ranks; (c) the reference stack
     (convert/torch_ref.py's RefLearnedCodec) at the flagship's widths,
     reference_weights_init seed 0, written as net_*.pth and imported by
     Trainer.load, one request served through .jpds bytes on the default
     and the kernel configuration's standard path, fp32 with TF32 off:
     codes equal to the reference's, images within 1e-3 of its decode;
 13. the spatial axis: two ranks of one process each on the card at
     spatial_axis 2 (gloo), spawned: (a) the phase-2 recipe at full width
     (batch 2, each rank 256 rows of both images) in the default and the
     kernel configuration, two steps each, each from the single-process
     path's parameters and Adams and on its code bits (PinnedSigns), held
     against one process's step by phase 7 (a)'s rule and within 1e-9 in
     float64, the ranks' uniforms gathered bit-equal to one process's, the
     parameters bit-equal across ranks after each step, K3's partial form
     90 / 90 / 45 / 45 a rank a step in the kernel configuration with every
     launch against its plain version, and the group's all-reduces counted;
     (b) test.main of one synthetic 2048x1024 triplet read 'fixed' to
     1024x512 in the kernel configuration, fp32 with TF32 off, sharded
     against one process: the code files bit-equal, the rates equal, the
     reconstruction within 1e-3; between (a) and (b) the ranks also run
     phase 14 (c), and after (b) phase 15;
 14. the batch norm (model.norm 'batch'; no kernel: JAX's is XLA code, and
     K3 stays off at its sites): (a) the norm on the card against the same
     call on the CPU, both in float64, at every norm shape of the phase-2
     step (G's and D's, batch 2 at 1024x512): the output, the gradients of
     x, scale and bias and the updated running statistics within 1e-9 of
     their max-abs; the quantizers (S2HVQ, S2HVQV2, rounded_identity) the
     same way; (b) the phase-2 recipe with the batch norm at full width and
     depth (fp32, block remat, random weights from --seed): one
     loss_and_grads with TF32 off in which each of G's norms advances its
     statistics once and D's twice, the buffers within 1e-5 of the
     momentum rule applied in float64 to each forward's batch statistics;
     the same step without remat leaves the statistics equal;
     --train-steps steps timed against the instance-norm recipe's (median
     host-clock step after the first, max_memory_allocated); the kernel
     configuration launches nothing; (c) in phase 13's two gloo ranks, at
     data_axis 2 and at spatial_axis 2, one float64 loss_and_grads against
     one process's on the global batch, every gradient and statistic
     within 1e-9, the statistics bit-equal across ranks; (d) (b)'s state
     saved, then test.main of one synthetic 2048x1024 triplet read 'fixed'
     to 1024x512 (the fast path asked for falls back to the standard
     path): its code files equal an in-process Trainer's codes,
     Trainer.compress then decompress within 1e-3 of get_img, and a decode
     on the batch's statistics differs from it;
 15. the spatial axis beyond the standard path, in phase 13's two ranks
     after its (b) (their one-process references in the parent meanwhile):
     (a) the flagship's default fast path (the 'auto' switches, whose
     K1, K2 and K4 are off on a rank's rows) on phase 13's triplet, bf16
     and fp32 with TF32 off: test.main, then Trainer.get_code, compress,
     decompress and get_img at spatial 2 against one process: the rates
     equal; in fp32 the code files equal, the codes equal except where the
     standard path's pre-sign is within 1e-5 of 0, the streams
     byte-identical where the codes are, the images within 1e-3; in bf16
     (where a bit that rounding moves across 0 changes what the random
     weights decode) within twice what one process's own bf16 rounding
     sets, its bf16 run against its fp32 run: each differing code bit's
     pre-sign and the images' relative L2; no K1, K2 or K4 launch in a
     rank's test.main; (b) the phase-2 recipe
     through the fast train decode at full width, batch 2, one float64
     loss_and_grads of each rank's 256 rows against one process's on its
     code bits, every gradient within 1e-9, no kernel launched; (c) the
     hires recipe at 2048x1024, batch 1, each rank 512 rows, in the kernel
     configuration: one fp32 step with the trunk frozen (TF32 off; the
     unfrozen one is phase 16 (a)'s, at 2048x1376), K3's partial form 45 /
     45 / 9 / 9 a rank-step, every launch against its plain version (the
     (1, 512, 2048, 32) fp32 slabs among them), then unfrozen in float64
     against one process within 1e-9; then test.main of one 2048x1024
     triplet of the hires recipe through the sharded fast path, fp32: the
     rates equal (no code: its streams are side info), the reconstruction
     and the decompressed stream within 1e-3;
 16. the spatial axis at uneven heights, on a synthetic 2048x1365 photo
     read 'none' (CLIC's rule) to 2048x1376: (a) in phase 13's two ranks
     after phase 15, the hires recipe at 2048x1376, batch 1, kernel
     configuration, trunk unfrozen (its global trunk's fourth down 43
     rows, 21 / 22 a rank): one fp32 step (TF32 off) with K3's partial
     form 72 / 72 / 36 / 36 a rank-step and every launch against its plain
     version on the same uneven slab, its metrics within 1e-4 of one
     process's, one float64 step against one process within 1e-9 with
     both peaks of memory, then its test.main through the sharded fast
     path against one process's: rates equal, streams byte-identical,
     images within 1e-4; (b) a spawn of its own, four gloo ranks at
     spatial_axis 4 on the one card: the flagship's test.main (with
     Trainer.get_code, compress, decompress and get_img) on the default
     fast path and on the kernel configuration's standard path, fp32, TF32
     off, against one process: code files and streams byte-identical where
     no code bit differs, a bit allowed to differ only at a pre-sign within
     1e-5 of 0, the reconstruction within 1e-4 (on one process's code bits
     where a bit differs, EvalSigns); the standard path's K3 partial 65 /
     65 a rank;
 17. the measurement entry points, on 2 synthetic 2048x1024 Cityscapes val
     triplets read 'fixed' to 1024x512: (a) eval/rd.py's parity mode at the
     flagship's widths (ngf 64, 4 downsamples, 9 res blocks), jpg q30 and
     q90, on the standard path and with --fast, fp32 with TF32 off on the
     card: the golden reference stack (convert/torch_ref.py, seed --seed)
     against the port fed its weights through convert/torch_import.py, every
     point's verdict OK, every image's generator input bit-equal between the
     two stacks, K1 launched by every fast decode the same number of times
     and by no standard one, ms an image for each stack; (b)
     train/seg_vgg.py, 20 steps at batch 2 on 512 crops of 4 train images
     whose labels are their brightness bands, scored on 2 val images: the
     last step's cross-entropy below the first's, the median step time
     after the first, the exported trunk reloaded through init_vgg19 and
     through a Trainer's --vgg_weights_path bit-equal to the trained one;
     (c) eval/sem_wise.py on a seeded flagship-width checkpoint (opt.json
     and params_g.pt) in the kernel configuration's standard path: K3 45
     an image, the JSON within 1e-9 of a float64 numpy re-scoring of the
     reconstructions it returns; (d) eval/rd.py's base mode, jpg q30 and
     q90 alone over the same images;
 19. summary: the card, a JSON line of per-kernel numbers (the partial
     kernels also timed at (1, 512, 2048, 32) fp32, "hires", and on a
     rank's uneven and empty slabs, "uneven"), the total seconds, and a
     last line {"ok": true, "device": {...}}.

Phase 18 (--cards 4), the data and spatial axes across four cards, one
process a card (cuda:0-3) over NCCL; it raises unless four CUDA devices
are visible and every rank's group is NCCL, and never runs fewer ranks or
gloo. First the cards' names and power limits, the interconnect
(nvidia-smi topo -m, card 0's NVLink state, peer access) and NCCL's
version; every kernel built; four ranks spawned, each joined with a
timeout and killed after it:
  (a) data 4: one step of the phase-2 recipe in the kernel configuration
      at the flagship's full width, one image a rank (global batch 4),
      held against one process's step on the global batch (the twin, on
      card 0 inside rank 0) by phase 7 (a)'s rule (fp32, TF32 off, two
      perturbed-input controls, every run on the twin's code bits, the
      float64 steps within 1e-9 in every G and D tensor); the ranks'
      uniforms, gathered, bit-equal to the twin's draws; K3 90 forward and
      45 backward a rank, each launch against its plain version; the
      all-reduced 783.9 MiB of gradients and the 8 metrics bit-identical on
      every rank, and the parameters after step.apply;
  (b) data 2 x spatial 2, the layout of the JAX system's multichip step:
      the same with one image a spatial group (global batch 2), K3's
      partial form 90 / 90 / 45 / 45 a rank-step on its slabs, each launch
      against its plain version, and the spatial group's all-reduces
      (calls and MiB a rank-step) printed;
  (c) test.main at spatial 4 (one group of the four cards), the kernel
      configuration's standard path in fp32 with TF32 off, on one
      synthetic 2048x1024 triplet read 'fixed' to 1024x512, against the
      same run in one process on card 0: the .rc bytes and the rates
      equal, the reconstruction within 1e-3, K3's partial stats and apply
      65 a rank;
  (e) for (a)'s and (b)'s layouts in the kernel and the default
      configuration, batch 2 a card, TF32 convolutions: steps timed by the
      host clock in the order one card, four cards, four cards, one card;
      one four-card step with CUDA events around the gradient all-reduce
      and the spatial all-reduces (ms and share of the step); images/s on
      four cards and on one, the scaling efficiency, peak memory a card;
  (d) then, from this process, train.run.main across the four cards:
      python -m torch.distributed.run --nproc_per_node 4 -m
      jpdse_tpu_torch.train --spatial_axis 2 (batch 1 a spatial group) on
      a synthetic Cityscapes split for two epochs, each saving
      save_dir/latest (only rank 0 writes: each step once in loss_log.txt
      and metrics.jsonl); then the same flags with --load_model for one
      more epoch, each rank under torch.distributed.run running
      train.run.main through --resume-rank, which holds the restored
      parameters and Adams bit-equal to the saved files and across the
      ranks, from latest at epoch 3 with 4 steps taken;
and ends with the scaling table, a JSON line of it, and a last line
{"ok": true, "device": {..., "count": 4}}.

Any failure raises and the script exits non-zero without the last line.
Without CUDA (or, for --cards 4, without four cards) it exits non-zero
before doing anything. Imports no JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
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
# the hires recipe's full-resolution sites (its enhancer's c7 and up, batch 1
# at 2048x1024): 4x the pixels of any other slab, and C = 32
HIRES_NORM_SHAPES = [(1, 1024, 2048, 32)]
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
    # K3's partial-statistics form (the spatial axis): JAX's K3 under a mesh
    "instance_norm_stats": ("instance_norm", "jpdse_tpu/ops/pallas/instance_norm.py:125"),
    "instance_norm_apply": ("instance_norm", "jpdse_tpu/ops/pallas/instance_norm.py:125"),
    "instance_norm_bwd_sums": ("instance_norm", "jpdse_tpu/ops/pallas/instance_norm.py:100"),
    "instance_norm_bwd_dx": ("instance_norm", "jpdse_tpu/ops/pallas/instance_norm.py:100"),
}
K3_PARTIAL = ("instance_norm_stats", "instance_norm_apply", "instance_norm_bwd_sums",
              "instance_norm_bwd_dx")
# the flagship's largest norm slab halved over H, one rank's rows at spatial 2
PARTIAL_SHAPE = (1, 256, 1024, 64)
# ... and the hires recipe's (its enhancer's c7 and up at 2048x1024)
HIRES_PARTIAL_SHAPE = (1, 512, 2048, 32)


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
    for _ in range(3):  # the profiler now and then records no kernel: try again
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total = sum(e.self_device_time_total / e.count for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA and e.count) / 1e3
        if total > 0:
            return total
    log("[kernels] the profiler recorded no device time in 3 tries: CUDA events instead")
    return cuda_ms(fn, iters)


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


def make_batch(seed: int, b: int = 1, h: int = H, w: int = W):
    """A synthetic Cityscapes-like request, as __graft_entry__._batch makes
    it: labels in [0, 35), instance ids, a normal-distributed image."""
    rng = np.random.default_rng(seed)
    return {
        "label": rng.integers(0, 35, (b, h, w)).astype(np.float32),
        "instance": rng.integers(0, 1000, (b, h, w)).astype(np.int32),
        "image": rng.normal(size=(b, h, w, 3)).astype(np.float32),
    }


def train_batch(cfg, seed: int) -> dict:
    """make_batch at the recipe's batch and image size, with the base
    codec's round trip of each image where the recipe reads it, as the data
    pipeline makes it."""
    from jpdse_tpu_torch.trainer import train_image_hw

    batch = make_batch(seed, cfg.data.batch_size, *train_image_hw(cfg))
    return with_base_codec(cfg, batch) if cfg.codec.use_compressed else batch


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
        # the hires recipe: its enhancer's back at 2048x1024 (ngf 32), and the
        # producer of its 2048x1024 head's K4 (156 -> 160 channels)
        ((1, 512, 1024, 128), torch.bfloat16, 0, None),
        ((1, 512, 1024, 128), torch.float32, 0, None),
        ((1, 512, 1024, 156), torch.bfloat16, 1, 160),
        ((1, 512, 1024, 156), torch.float32, 1, 160),
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
    hires = timed((1, 512, 1024, 128), torch.bfloat16)
    # the serving path's own shape: B=1, bf16
    k, p, bound_ms = timed((1, 256, 512, 256), torch.bfloat16)
    e = kernel_entry("s2d_realign_pad3", max_err, k, p, bound_ms, "bytes", None)
    e["hires_(1, 512, 1024, 128)_bf16"] = dict(zip(("ms", "plain_ms", "bound_ms"), hires))
    return e


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
    difference, the one cast may round differently by one ulp. 0 for an
    empty slab's."""
    if want.numel() == 0:
        return 0.0 if got.shape == want.shape else float("inf")
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
    entry = hires = None
    for shape in NORM_SHAPES + TRAIN_NORM_SHAPES + HIRES_NORM_SHAPES:
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
        if shape in HIRES_NORM_SHAPES:
            # the hires training step's fp32 slab: kernel, plain and library beside the bound
            xc = base.permute(0, 3, 1, 2)
            k = cuda_ms(lambda: k3.fused_instance_norm(base, relu=True))
            k_dev = device_ms(lambda: k3.fused_instance_norm(base, relu=True))
            p = cuda_ms(lambda: k3.fused_instance_norm_plain(base, relu=True))
            lib = cuda_ms(lambda: F.instance_norm(xc, eps=1e-5))
            bound = bytes_ms(base, base)
            hires = {"shape": str(shape), "dtype": "float32", "ms": k, "device_ms": k_dev,
                     "plain_ms": p, "bound_ms": bound, "library_ms": lib}
            log(f"[kernels] K3 {shape} fp32 relu: kernel {k:.4f} ms (on the device {k_dev:.4f} "
                f"ms, {bound / k_dev:.0%} of its bound), plain {p:.4f} ms, F.instance_norm "
                f"{lib:.4f} ms, bound {bound * 1e3:.1f} us (bytes) ({card})")
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
    e = kernel_entry("fused_instance_norm", max_err, k, p, bound, "bytes", lib)
    e["hires"] = hires
    return e


def one_kernel(what: str, fn) -> dict:
    """The device kernels of one call of fn() by the profiler; raises unless
    it is one. A profile that recorded none is taken again, up to three
    times, as device_ms does: the profiler now and then drops a launch."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        kernels = {e.key: e.count for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA}
        if kernels:
            break
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
    hires = {}
    for shape in NORM_SHAPES + TRAIN_NORM_SHAPES + HIRES_NORM_SHAPES:
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
        if shape in TRAIN_NORM_SHAPES or shape in HIRES_NORM_SHAPES:
            # timing at the training step's shapes, fp32, with and without the ReLU
            # (the residual form runs the bare norm's kernel)
            x, g = base, g32
            for relu in (True, False):
                _, stats = k3._forward(x, None, relu, 1e-5)
                k = cuda_ms(lambda: k3.fused_instance_norm_bwd(x, g, stats, relu))
                k_dev = device_ms(lambda: k3.fused_instance_norm_bwd(x, g, stats, relu))
                bound = bytes_ms(x, g, x)
                sites = (K3_BWD_SITES_HIRES if shape in HIRES_NORM_SHAPES else K3_BWD_SITES)
                log(f"[kernels] K3 backward {shape} fp32 relu={relu}: kernel {k:.4f} ms (on the "
                    f"device {k_dev:.4f} ms, {bound / k_dev:.0%} of its bound), bound "
                    f"{bound * 1e3:.1f} us (bytes); {sites.get((shape[1:], relu), 0)} "
                    f"launches a training step ({card})")
                if shape in HIRES_NORM_SHAPES and relu:
                    p = cuda_ms(lambda: k3.fused_instance_norm_bwd_plain(x, g, relu, stats=stats))
                    xc = x.permute(0, 3, 1, 2).detach().requires_grad_()
                    yc = F.instance_norm(xc, eps=1e-5)
                    gc = g.permute(0, 3, 1, 2)
                    lib = cuda_ms(lambda: torch.autograd.grad(yc, xc, gc, retain_graph=True))
                    hires = {"shape": str(shape), "dtype": "float32", "ms": k,
                             "device_ms": k_dev, "plain_ms": p, "bound_ms": bound,
                             "library_ms": lib}
                    log(f"[kernels] K3 backward {shape} fp32 relu: plain {p:.4f} ms, backward "
                        f"of F.instance_norm {lib:.4f} ms ({card})")
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
    e["hires"] = hires
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


def _halves(x: torch.Tensor) -> list:
    """Two ranks' rows of a slab at spatial 2."""
    h = x.shape[1] // 2
    return [x[:, :h].contiguous(), x[:, h:].contiguous()]


def phase_k3_partial(card: str, gen) -> list:
    """K3's partial-statistics form (the spatial axis): each of its four
    kernels at two ranks' halves of every serving and training norm shape
    (a bare norm, ReLU, residual), against its plain version on the same
    inputs (stats: the mean and M2 within 1e-5 relative, the count exact;
    apply and dx: fp32 within 1e-5 of the output's max-abs, bf16 within 1
    ulp beyond that; sums, fp32 in both: 1e-5 of their max-abs), the halves together
    against the one-launch plain form of the whole slab, every rank's
    merged statistics bit-equal, deterministic; then each timed at
    PARTIAL_SHAPE in bf16 beside its plain version and its bound. One
    PyTorch call computes the stats launch's function, ``torch.var_mean``
    over (H, W) (the mean and the biased variance, M2 over the count; its
    outputs in x's dtype): its library_ms. None computes apply, sums or dx,
    which read statistics merged across ranks: library_ms null."""
    from jpdse_tpu_torch.ops import instance_norm as k3

    worst = dict.fromkeys(K3_PARTIAL, 0.0)
    count = float
    for shape in NORM_SHAPES + TRAIN_NORM_SHAPES + HIRES_NORM_SHAPES:
        base = torch.randn(shape, device="cuda", generator=gen) * 3 + 1
        g32 = torch.randn(shape, device="cuda", generator=gen)
        res32 = torch.randn(shape, device="cuda", generator=gen)
        for dtype in (torch.float32, torch.bfloat16):
            x, g = base.to(dtype), g32.to(dtype)
            parts, gparts = _halves(x), _halves(g)
            stats = torch.stack([k3.instance_norm_stats(p) for p in parts])
            for p_, st in zip(parts, stats):
                want = k3.instance_norm_stats_plain(p_)
                if not torch.equal(st[..., 0], want[..., 0]):
                    raise AssertionError(f"K3 stats {shape}: counts differ")
                err = max(((st[..., i] - want[..., i]).abs()
                           / want[..., i].abs().clamp_min(1.0)).max().item() for i in (1, 2))
                worst["instance_norm_stats"] = max(worst["instance_norm_stats"], err)
                if not err <= 1e-5:
                    raise AssertionError(f"K3 stats {shape} {dt(dtype)}: {err:.2e} relative")
            for relu, has_res in NORM_COMBOS:
                res = res32.to(dtype) if has_res else None
                rparts = _halves(res) if has_res else [None, None]
                ys, mss = [], []
                for p_, r_ in zip(parts, rparts):
                    y, ms = k3.instance_norm_apply(p_, r_, stats, relu)
                    again, _ = k3.instance_norm_apply(p_, r_, stats, relu)
                    want, _ = k3.instance_norm_apply_plain(p_, r_, stats, relu)
                    if not torch.equal(y, again):
                        raise AssertionError(f"K3 apply {shape}: not deterministic")
                    _note_held(worst, "instance_norm_apply", y, want, dtype)
                    ys.append(y)
                    mss.append(ms)
                if not torch.equal(mss[0], mss[1]):
                    raise AssertionError(f"K3 apply {shape}: the ranks' statistics differ")
                whole = k3.fused_instance_norm_plain(x, res, relu)
                _held(f"K3 partial forward {shape} {dt(dtype)} relu={relu} residual={has_res}",
                      torch.cat(ys, 1), whole, dtype)
                if has_res:
                    continue
                sums = []
                for p_, gp in zip(parts, gparts):
                    got = k3.instance_norm_bwd_sums(p_, gp, mss[0], relu)
                    want = k3.instance_norm_bwd_sums_plain(p_, gp, mss[0], relu)
                    worst["instance_norm_bwd_sums"] = max(worst["instance_norm_bwd_sums"],
                                                          _site_err(got, want))
                    sums.append(got)
                sums = torch.stack(sums)
                n = count(shape[1] * shape[2])
                dxs = []
                for p_, gp in zip(parts, gparts):
                    dx = k3.instance_norm_bwd_dx(p_, gp, mss[0], sums, n, relu)
                    want = k3.instance_norm_bwd_dx_plain(p_, gp, mss[0], sums, n, relu)
                    _note_held(worst, "instance_norm_bwd_dx", dx, want, dtype)
                    dxs.append(dx)
                _held(f"K3 partial backward {shape} {dt(dtype)} relu={relu}", torch.cat(dxs, 1),
                      k3.fused_instance_norm_bwd_plain(x, g, relu, stats=mss[0]), dtype)
        torch.cuda.synchronize()
    for name, err in worst.items():
        if not err <= K3_SITE_TOL:
            raise AssertionError(f"{name}: {err:.2e} of its output's max-abs from its plain "
                                 f"version (tolerance {K3_SITE_TOL})")
    log(f"[kernels] K3 partial form at two ranks' halves of "
        f"{len(NORM_SHAPES + TRAIN_NORM_SHAPES + HIRES_NORM_SHAPES)} "
        f"shapes, fp32 and bf16: worst against the plain versions on the same inputs "
        + ", ".join(f"{k} {v:.2e}" for k, v in worst.items()) + f" (tolerance {K3_SITE_TOL})")

    # timing at one rank's rows of the largest slab, bf16
    x = (torch.randn(PARTIAL_SHAPE, device="cuda", generator=gen) * 3 + 1).to(torch.bfloat16)
    g = torch.randn(PARTIAL_SHAPE, device="cuda", generator=gen).to(torch.bfloat16)
    st = k3.instance_norm_stats(x)
    stats = torch.stack([st, st])
    _, ms = k3.instance_norm_apply(x, None, stats, True)
    sums = torch.stack([k3.instance_norm_bwd_sums(x, g, ms, True)] * 2)
    n = count(2 * PARTIAL_SHAPE[1] * PARTIAL_SHAPE[2])
    runs = {
        "instance_norm_stats": (lambda: k3.instance_norm_stats(x),
                                lambda: k3.instance_norm_stats_plain(x), bytes_ms(x),
                                lambda: torch.var_mean(x, dim=(1, 2), correction=0)),
        "instance_norm_apply": (lambda: k3.instance_norm_apply(x, None, stats, True),
                                lambda: k3.instance_norm_apply_plain(x, None, stats, True),
                                bytes_ms(x, x), None),
        "instance_norm_bwd_sums": (lambda: k3.instance_norm_bwd_sums(x, g, ms, True),
                                   lambda: k3.instance_norm_bwd_sums_plain(x, g, ms, True),
                                   bytes_ms(x, g), None),
        "instance_norm_bwd_dx": (lambda: k3.instance_norm_bwd_dx(x, g, ms, sums, n, True),
                                 lambda: k3.instance_norm_bwd_dx_plain(x, g, ms, sums, n, True),
                                 bytes_ms(x, g, x), None),
    }
    entries = []
    for name, (kern, plain, bound, library) in runs.items():
        k = cuda_ms(kern)
        k_dev = device_ms(kern)
        p = cuda_ms(plain)
        lib = None if library is None else cuda_ms(library)
        log(f"[kernels] {name} {PARTIAL_SHAPE} bf16 relu: kernel {k:.4f} ms (on the device "
            f"{k_dev:.4f} ms, {bound / k_dev:.0%} of its bound), plain {p:.4f} ms, bound "
            f"{bound * 1e3:.1f} us (bytes); "
            + ("no PyTorch call computes it" if lib is None else
               f"torch.var_mean over (H, W) {lib:.4f} ms (on the device "
               f"{device_ms(library):.4f} ms)") + f" ({card})")
        e = kernel_entry(name, worst[name], k, p, bound, "bytes", lib)
        e["device_ms"] = k_dev
        entries.append(e)
    fwd = sum(e["ms"] for e in entries[:2])
    bwd = sum(e["ms"] for e in entries[2:])
    log(f"[kernels] K3 partial form at {PARTIAL_SHAPE} bf16: forward (stats + apply) "
        f"{fwd * 1e3:.1f} us against a bound of {bytes_ms(x, x, x) * 1e3:.1f} us, backward "
        f"(sums + dx) {bwd * 1e3:.1f} us against {bytes_ms(x, g, x, g, x) * 1e3:.1f} us ({card})")
    for e, hires in zip(entries, phase_k3_partial_hires(card, gen)):
        e["hires"] = hires
    for e, uneven in zip(entries, phase_k3_partial_uneven(card, gen)):
        e["uneven"] = uneven
    step = phase_k3_partial_step(card, gen)
    entries[0]["step_slabs"], entries[2]["step_slabs"] = step["stats"], step["sums"]
    entries[1]["step_slabs"], entries[3]["step_slabs"] = step["apply"], step["dx"]
    entries[1]["step_slabs"]["residual"] = step["apply residual"]
    return entries


# the spatial step's rank slabs at spatial 2: every norm level's rows halved,
# batch 2 in fp32 (the training step) and batch 1 in bf16 (serving)
STEP_RANK_SLABS = ([((2, s[1] // 2) + s[2:], torch.float32) for s in NORM_SHAPES]
                   + [((1, s[1] // 2) + s[2:], torch.bfloat16) for s in NORM_SHAPES])
# the partial launches' timed legs: the apply with the ReLU, and with the
# residual (a res block's second norm) where the slab's level has res blocks
STEP_LEGS = ("stats", "apply", "apply residual", "sums", "dx")


def step_launches(shape, leg: str) -> int:
    """Launches of ``leg`` a spatial rank-step makes at the batch-2 rank slab
    ``shape``, by K3_BWD_SITES' sites whose rows it halves: the stats and
    the apply twice a site (block remat recomputes the forward), the apply
    in the site's form (ReLU, or the residual), the sums and the dx once
    (timed with the ReLU: a residual site's dx masks nothing, at the same
    bytes); 0 at batch 1."""
    if shape[0] != 2:
        return 0
    whole = (2 * shape[1],) + tuple(shape[2:])
    relu, res = K3_BWD_SITES.get((whole, True), 0), K3_BWD_SITES.get((whole, False), 0)
    return {"stats": 2 * (relu + res), "apply": 2 * relu, "apply residual": 2 * res,
            "sums": relu + res, "dx": relu + res}[leg]


def times_residual(shape) -> bool:
    """Whether the apply's residual form is timed at a slab: at the levels
    whose res blocks take it (the deepest) and at the hires rows (its
    enhancer's res blocks)."""
    return tuple(shape[2:]) == NORM_SHAPES[4][2:] or tuple(shape) == HIRES_PARTIAL_SHAPE


def step_legs(k3, x: torch.Tensor, g: torch.Tensor, res, other=None, count=None) -> dict:
    """The partial kernels' timed legs on one rank's slab x (g its output's
    gradient, res a residual or None), as {leg: (kernel, plain, bound ms,
    library or None)}: two ranks' statistics, this rank's and ``other``'s
    (by default this rank's again), over ``count`` pixels (by default twice
    x's), the apply with the ReLU (and with ``res`` where given), the sums
    and the dx with the ReLU. Only the stats' function is one PyTorch call,
    torch.var_mean over (H, W)."""
    st = k3.instance_norm_stats(x)
    parts = torch.stack([st, st if other is None else other])
    _, ms = k3.instance_norm_apply(x, None, parts, True)
    sums = torch.stack([k3.instance_norm_bwd_sums(x, g, ms, True)] * 2)
    n = float(count or 2 * x.shape[1] * x.shape[2])
    legs = {
        "stats": (lambda: k3.instance_norm_stats(x), lambda: k3.instance_norm_stats_plain(x),
                  bytes_ms(x), lambda: torch.var_mean(x, dim=(1, 2), correction=0)),
        "apply": (lambda: k3.instance_norm_apply(x, None, parts, True),
                  lambda: k3.instance_norm_apply_plain(x, None, parts, True), bytes_ms(x, x), None),
        "sums": (lambda: k3.instance_norm_bwd_sums(x, g, ms, True),
                 lambda: k3.instance_norm_bwd_sums_plain(x, g, ms, True), bytes_ms(x, g), None),
        "dx": (lambda: k3.instance_norm_bwd_dx(x, g, ms, sums, n, True),
               lambda: k3.instance_norm_bwd_dx_plain(x, g, ms, sums, n, True), bytes_ms(x, g, x),
               None),
    }
    if res is not None:
        legs["apply residual"] = (lambda: k3.instance_norm_apply(x, res, parts, False),
                                  lambda: k3.instance_norm_apply_plain(x, res, parts, False),
                                  bytes_ms(x, res, x), None)
    return legs


def check_leg(leg: str, kern, plain, dtype, what: str) -> float:
    """One leg's launch against its plain version on the same inputs and
    against a second launch (bit-equal): the stats' count exact, mean and
    M2 within 1e-5 relative (to max(1, |value|)); the sums within 1e-5 of
    their max-abs; the apply's y and the dx in fp32 within 1e-5 of the
    output's max-abs (at least 1 for y), in bf16 within one ulp beyond
    that, and the apply's mean and rstd within 1e-5 of their max-abs.
    Returns the error; raises past the tolerance."""
    got, again, want = kern(), kern(), plain()
    outs = got if isinstance(got, tuple) else (got,)
    if not all(torch.equal(a, b) for a, b in zip(outs, again if isinstance(again, tuple)
                                                 else (again,))):
        raise AssertionError(f"K3 {leg} {what}: two launches differ")
    if leg == "stats":
        if not torch.equal(got[..., 0], want[..., 0]):
            raise AssertionError(f"K3 stats {what}: counts differ")
        err = max((((got[..., i] - want[..., i]).abs() / want[..., i].abs().clamp_min(1.0))
                   .max().item() if got.numel() else 0.0) for i in (1, 2))
    elif leg == "sums":
        err = _site_err(got, want)
    else:
        name = "instance_norm_bwd_dx" if leg == "dx" else "instance_norm_apply"
        worst = {name: 0.0}
        _note_held(worst, name, outs[0], want[0] if isinstance(want, tuple) else want, dtype)
        err = worst[name] if len(outs) == 1 else max(worst[name], _site_err(outs[1], want[1]))
    if not err <= K3_SITE_TOL:
        raise AssertionError(f"K3 {leg} {what}: {err:.2e} from its plain version "
                             f"(tolerance {K3_SITE_TOL})")
    return err


def phase_k3_partial_step(card: str, gen) -> dict:
    """The four partial launches at STEP_RANK_SLABS (STEP_LEGS: the apply
    with the ReLU, and with the residual at the deepest level, whose res
    blocks take it): each first held against its plain version and a second
    launch (check_leg), then timed beside its bound, its plain version and,
    for the stats, torch.var_mean over (H, W): the profiler's device time,
    CUDA events over back-to-back calls (x as a step finds it, just read: in
    the 50 MB L2 where it fits), and events of one call after a 64 MB write
    has flushed the L2. Then the device time summed over one spatial
    rank-step's launches at the training slabs (step_launches). Returns
    {leg: {"slabs": {shape: numbers}, "rank_step_device_ms": t,
    "rank_step_bound_ms": t}}."""
    from jpdse_tpu_torch.ops import instance_norm as k3

    out = {leg: {"slabs": {}, "rank_step_device_ms": 0.0, "rank_step_bound_ms": 0.0}
           for leg in STEP_LEGS}
    worst = dict.fromkeys(STEP_LEGS, 0.0)
    for shape, dtype in STEP_RANK_SLABS:
        x = (torch.randn(shape, device="cuda", generator=gen) * 3 + 1).to(dtype)
        g = torch.randn(shape, device="cuda", generator=gen).to(dtype)
        res = (torch.randn(shape, device="cuda", generator=gen).to(dtype)
               if times_residual(shape) else None)
        for leg, (kern, plain, bound, library) in step_legs(k3, x, g, res).items():
            worst[leg] = max(worst[leg], check_leg(leg, kern, plain, dtype,
                                                   f"{shape} {dt(dtype)}"))
            k, k_dev, k_flushed = cuda_ms(kern), device_ms(kern), flushed_ms(kern)
            p = cuda_ms(plain)
            lib = None if library is None else cuda_ms(library)
            out[leg]["slabs"][f"{shape} {dt(dtype)}"] = {
                "ms": k, "device_ms": k_dev, "flushed_ms": k_flushed, "plain_ms": p,
                "bound_ms": bound, "bound_by": "bytes", "library_ms": lib}
            launches = step_launches(shape, leg)
            out[leg]["rank_step_device_ms"] += launches * k_dev
            out[leg]["rank_step_bound_ms"] += launches * bound
            log(f"[kernels] {leg} {shape} {dt(dtype)} (a rank's slab of the spatial step): "
                f"kernel {k:.4f} ms, on the device {k_dev:.4f} ms ({bound / k_dev:.0%} of its "
                f"bound), L2 flushed {k_flushed:.4f} ms; plain {p:.4f} ms; bound "
                f"{bound * 1e3:.1f} us (bytes)"
                + ("" if lib is None else f"; torch.var_mean over (H, W) {lib:.4f} ms")
                + (f"; {launches} launches a rank-step" if launches else "") + f" ({card})")
        del x, g, res
    log("[kernels] the partial launches at the spatial step's rank slabs against their plain "
        "versions, two launches bit-equal: worst "
        + ", ".join(f"{k} {v:.2e}" for k, v in worst.items()) + f" (tolerance {K3_SITE_TOL})")
    for leg, o in out.items():
        log(f"[kernels] {leg} summed over a spatial rank-step's launches (batch 2, fp32): "
            f"device {o['rank_step_device_ms']:.4f} ms against a bound of "
            f"{o['rank_step_bound_ms']:.4f} ms ({card})")
    for label, legs in (("stats + sums", ("stats", "sums")),
                        ("apply + dx", ("apply", "apply residual", "dx"))):
        log(f"[kernels] {label} a spatial rank-step: device "
            f"{sum(out[leg]['rank_step_device_ms'] for leg in legs):.4f} ms against a bound of "
            f"{sum(out[leg]['rank_step_bound_ms'] for leg in legs):.4f} ms ({card})")
    return out


# the spatial axis's uneven splits of a norm slab on phase 16's paths: (slab, ranks).
# The hires recipe at 2048x1376 runs its global trunk on 1024x688, whose fourth down
# has 43 rows (21 / 22 over two ranks); the flagship at 1376 rows over four ranks has
# 86 at its fourth down (21 / 22 / 21 / 22); a slab of 3 rows over four leaves rank 0
# none; a small odd slab takes the one-word path (vec 1)
UNEVEN_SPLITS = [((1, 43, 64, 1024), 2), ((1, 86, 128, 512), 4), ((1, 3, 64, 1024), 4),
                 ((2, 7, 12, 6), 3)]
# timed: one rank's 21 rows of the hires trunk's 43 (fp32), and a rank's empty slab
UNEVEN_TIMED = ((1, 21, 64, 1024), (1, 0, 64, 1024))


def _uneven(x: torch.Tensor, size: int) -> list:
    """The ``size`` ranks' rows of a slab as the spatial axis splits them."""
    from jpdse_tpu_torch.parallel.spatial import bounds

    b = bounds(x.shape[1], size)
    return [x[:, b[s]:b[s + 1]].contiguous() for s in range(size)]


def phase_k3_partial_uneven(card: str, gen) -> list:
    """K3's partial kernels on the spatial axis's uneven and empty rank
    slabs (UNEVEN_SPLITS), fp32 and bf16, ReLU with and without a
    residual: each rank's stats, apply, sums and dx launch (an empty slab's
    too: one launch each) against its plain version on the same slab (the
    tolerances of :func:`phase_k3_partial`); an empty slab's stats and sums
    exactly 0; the stats merged in rank order to the same mean and rstd
    bits on every rank; the ranks together against the one-launch plain
    form of the whole. Then each timed in fp32 at UNEVEN_TIMED, beside its
    plain version and its bound (an empty slab's bound is 0 bytes).
    Returns one dict per kernel, in K3_PARTIAL's order."""
    from jpdse_tpu_torch.ops import instance_norm as k3

    worst = dict.fromkeys(K3_PARTIAL, 0.0)
    before = {n: getattr(k3, n).launches for n in K3_PARTIAL}
    want_launches = dict.fromkeys(K3_PARTIAL, 0)
    for shape, size in UNEVEN_SPLITS:
        base = torch.randn(shape, device="cuda", generator=gen) * 3 + 1
        g32 = torch.randn(shape, device="cuda", generator=gen)
        res32 = torch.randn(shape, device="cuda", generator=gen)
        for dtype in (torch.float32, torch.bfloat16):
            x, g = base.to(dtype), g32.to(dtype)
            parts, gparts = _uneven(x, size), _uneven(g, size)
            stats = []
            for p_ in parts:
                st = k3.instance_norm_stats(p_)
                want = k3.instance_norm_stats_plain(p_)
                if not torch.equal(st[..., 0], want[..., 0]) or (
                        p_.shape[1] == 0 and not torch.equal(st, torch.zeros_like(st))):
                    raise AssertionError(f"K3 stats {tuple(p_.shape)}: counts differ")
                err = max(((st[..., i] - want[..., i]).abs()
                           / want[..., i].abs().clamp_min(1.0)).max().item() for i in (1, 2))
                worst["instance_norm_stats"] = max(worst["instance_norm_stats"], err)
                stats.append(st)
            stats = torch.stack(stats)
            want_launches["instance_norm_stats"] += size
            for has_res in (False, True):
                res = res32.to(dtype) if has_res else None
                rparts = _uneven(res, size) if has_res else [None] * size
                ys, mss = [], []
                for p_, r_ in zip(parts, rparts):
                    y, ms = k3.instance_norm_apply(p_, r_, stats, True)
                    want, _ = k3.instance_norm_apply_plain(p_, r_, stats, True)
                    if y.shape != p_.shape:
                        raise AssertionError(f"K3 apply {tuple(p_.shape)}: shape {y.shape}")
                    _note_held(worst, "instance_norm_apply", y, want, dtype)
                    ys.append(y)
                    mss.append(ms)
                want_launches["instance_norm_apply"] += size
                if not all(torch.equal(m, mss[0]) for m in mss):
                    raise AssertionError(f"K3 apply {shape} over {size}: the ranks merged apart")
                _held(f"K3 partial forward {shape} over {size} ranks {dt(dtype)} residual="
                      f"{has_res}", torch.cat(ys, 1), k3.fused_instance_norm_plain(x, res, True),
                      dtype)
            sums = []
            for p_, gp in zip(parts, gparts):
                got = k3.instance_norm_bwd_sums(p_, gp, mss[0], True)
                want = k3.instance_norm_bwd_sums_plain(p_, gp, mss[0], True)
                if p_.shape[1] == 0 and not torch.equal(got, torch.zeros_like(got)):
                    raise AssertionError(f"K3 sums of an empty slab: {got.abs().max().item()}")
                worst["instance_norm_bwd_sums"] = max(worst["instance_norm_bwd_sums"],
                                                      _site_err(got, want))
                sums.append(got)
            sums = torch.stack(sums)
            n = float(shape[1] * shape[2])
            dxs = []
            for p_, gp in zip(parts, gparts):
                dx = k3.instance_norm_bwd_dx(p_, gp, mss[0], sums, n, True)
                _note_held(worst, "instance_norm_bwd_dx", dx,
                           k3.instance_norm_bwd_dx_plain(p_, gp, mss[0], sums, n, True), dtype)
                dxs.append(dx)
            want_launches["instance_norm_bwd_sums"] += size
            want_launches["instance_norm_bwd_dx"] += size
            _held(f"K3 partial backward {shape} over {size} ranks {dt(dtype)}", torch.cat(dxs, 1),
                  k3.fused_instance_norm_bwd_plain(x, g, True, stats=mss[0]), dtype)
        torch.cuda.synchronize()
    got_launches = {n: getattr(k3, n).launches - before[n] for n in K3_PARTIAL}
    if got_launches != want_launches:
        raise AssertionError(f"K3 partial on uneven slabs launched {got_launches}, want "
                             f"{want_launches} (an empty slab launches too)")
    for name, err in worst.items():
        if not err <= K3_SITE_TOL:
            raise AssertionError(f"{name} on uneven slabs: {err:.2e} from its plain version "
                                 f"(tolerance {K3_SITE_TOL})")
    from jpdse_tpu_torch.parallel.spatial import bounds

    splits = "; ".join(
        f"{tuple(sh)} over {n}: rows {'/'.join(str(b[i + 1] - b[i]) for i in range(n))}"
        for sh, n in UNEVEN_SPLITS for b in [bounds(sh[1], n)])
    log(f"[kernels] K3 partial form on uneven rank slabs ({splits}), fp32 and bf16, ReLU with "
        f"and without a residual: every launch made, an empty slab's included "
        f"({sum(want_launches.values())}); worst against the plain versions "
        + ", ".join(f"{k} {v:.2e}" for k, v in worst.items()) + f" (tolerance {K3_SITE_TOL})")

    out = {name: {} for name in K3_PARTIAL}
    for shape in UNEVEN_TIMED:
        x = torch.randn(shape, device="cuda", generator=gen) * 3 + 1
        g = torch.randn(shape, device="cuda", generator=gen)
        rows = 43  # the slab the rows are of
        stats = torch.stack([k3.instance_norm_stats(torch.randn(
            (1, rows - shape[1]) + shape[2:], device="cuda", generator=gen)),
            k3.instance_norm_stats(x)])
        _, ms = k3.instance_norm_apply(x, None, stats, True)
        sums = torch.stack([k3.instance_norm_bwd_sums(x, g, ms, True)] * 2)
        n = float(rows * shape[2])
        runs = {
            "instance_norm_stats": (lambda: k3.instance_norm_stats(x),
                                    lambda: k3.instance_norm_stats_plain(x), bytes_ms(x)),
            "instance_norm_apply": (lambda: k3.instance_norm_apply(x, None, stats, True),
                                    lambda: k3.instance_norm_apply_plain(x, None, stats, True),
                                    bytes_ms(x, x)),
            "instance_norm_bwd_sums": (lambda: k3.instance_norm_bwd_sums(x, g, ms, True),
                                       lambda: k3.instance_norm_bwd_sums_plain(x, g, ms, True),
                                       bytes_ms(x, g)),
            "instance_norm_bwd_dx": (
                lambda: k3.instance_norm_bwd_dx(x, g, ms, sums, n, True),
                lambda: k3.instance_norm_bwd_dx_plain(x, g, ms, sums, n, True),
                bytes_ms(x, g, x)),
        }
        tag = "empty" if shape[1] == 0 else f"{shape[1]} of {rows} rows"
        for name, (kern, plain, bound) in runs.items():
            k, k_dev, p = cuda_ms(kern), device_ms(kern), cuda_ms(plain)
            out[name][tag] = {"shape": list(shape), "dtype": "fp32", "ms": k, "device_ms": k_dev,
                              "plain_ms": p, "bound_ms": bound, "bound_by": "bytes"}
            log(f"[kernels] {name} {shape} fp32 (a rank's slab, {tag}): kernel {k:.4f} ms (on "
                f"the device {k_dev:.4f} ms"
                + (f", {bound / k_dev:.0%} of its bound" if bound else ", no bytes to move")
                + f"), plain {p:.4f} ms, bound {bound * 1e3:.1f} us (bytes) ({card})")
    return [out[name] for name in K3_PARTIAL]


def phase_k3_partial_hires(card: str, gen) -> list:
    """The four partial kernels timed at HIRES_PARTIAL_SHAPE in fp32, one
    rank's rows of the hires recipe's full-resolution slab at spatial 2
    (its enhancer's c7 and up: ReLU; its res blocks' second norm takes a
    residual, timed for the apply too): each beside its plain version, its
    bound and, for the stats, torch.var_mean over (H, W). Returns one dict
    per kernel, in K3_PARTIAL's order."""
    from jpdse_tpu_torch.ops import instance_norm as k3

    shape = HIRES_PARTIAL_SHAPE
    x = torch.randn(shape, device="cuda", generator=gen) * 3 + 1
    g = torch.randn(shape, device="cuda", generator=gen)
    res = torch.randn(shape, device="cuda", generator=gen)
    stats = torch.stack([k3.instance_norm_stats(x)] * 2)
    _, ms = k3.instance_norm_apply(x, None, stats, True)
    sums = torch.stack([k3.instance_norm_bwd_sums(x, g, ms, True)] * 2)
    n = float(2 * shape[1] * shape[2])
    runs = {
        "instance_norm_stats": (lambda: k3.instance_norm_stats(x),
                                lambda: k3.instance_norm_stats_plain(x), bytes_ms(x),
                                lambda: torch.var_mean(x, dim=(1, 2), correction=0)),
        "instance_norm_apply": (lambda: k3.instance_norm_apply(x, None, stats, True),
                                lambda: k3.instance_norm_apply_plain(x, None, stats, True),
                                bytes_ms(x, x), None),
        "instance_norm_apply residual": (
            lambda: k3.instance_norm_apply(x, res, stats, False),
            lambda: k3.instance_norm_apply_plain(x, res, stats, False), bytes_ms(x, res, x),
            None),
        "instance_norm_bwd_sums": (lambda: k3.instance_norm_bwd_sums(x, g, ms, True),
                                   lambda: k3.instance_norm_bwd_sums_plain(x, g, ms, True),
                                   bytes_ms(x, g), None),
        "instance_norm_bwd_dx": (lambda: k3.instance_norm_bwd_dx(x, g, ms, sums, n, True),
                                 lambda: k3.instance_norm_bwd_dx_plain(x, g, ms, sums, n, True),
                                 bytes_ms(x, g, x), None),
    }
    out = {}
    for name, (kern, plain, bound, library) in runs.items():
        k, k_dev, p = cuda_ms(kern), device_ms(kern), cuda_ms(plain)
        lib = None if library is None else cuda_ms(library)
        out[name] = {"shape": list(shape), "dtype": "fp32", "ms": k, "device_ms": k_dev,
                     "plain_ms": p, "bound_ms": bound, "bound_by": "bytes", "library_ms": lib}
        log(f"[kernels] {name} {shape} fp32 (the hires recipe's rows at spatial 2): kernel "
            f"{k:.4f} ms (on the device {k_dev:.4f} ms, {bound / k_dev:.0%} of its bound), plain "
            f"{p:.4f} ms, bound {bound * 1e3:.1f} us (bytes); "
            + ("no PyTorch call computes it" if lib is None else
               f"torch.var_mean over (H, W) {lib:.4f} ms (on the device "
               f"{device_ms(library):.4f} ms)") + f" ({card})")
    out["instance_norm_apply"]["residual"] = out.pop("instance_norm_apply residual")
    return [out[name] for name in K3_PARTIAL]


def _note_held(worst: dict, name: str, got: torch.Tensor, want: torch.Tensor, dtype) -> None:
    """An fp32 output's difference against its max-abs (at least 1 for the
    apply's) into ``worst``; a bf16 output within one ulp beyond 1e-5."""
    if dtype == torch.float32:
        floor = 1.0 if name == "instance_norm_apply" else 0.0
        worst[name] = max(worst[name], _site_err(got, want, floor))
    elif not bf16_excess_ulps(got, want) <= 1.0:
        raise AssertionError(f"{name} at {tuple(got.shape)} bf16: more than 1 ulp beyond 1e-5 "
                             "from its plain version")


def _site_err(got: torch.Tensor, want: torch.Tensor, floor: float = 0.0) -> float:
    """The largest difference against the output's max-abs (at least
    ``floor``); 0 for an empty slab's."""
    if want.numel() == 0:
        return 0.0 if got.shape == want.shape else float("inf")
    scale = max(want.float().abs().max().item(), floor, 1e-30)
    return (got.float() - want.float()).abs().max().item() / scale


def _held(what: str, got: torch.Tensor, want: torch.Tensor, dtype) -> None:
    """fp32 within 1e-5 of the plain form's max-abs (at least 1), bf16 within
    one ulp beyond 1e-5."""
    if dtype == torch.float32:
        err = _site_err(got, want, 1.0)
        if not err <= 1e-5:
            raise AssertionError(f"{what}: {err:.2e} from the one-launch plain form")
    elif not bf16_excess_ulps(got, want) <= 1.0:
        raise AssertionError(f"{what}: more than 1 bf16 ulp beyond 1e-5 from the plain form")



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

    kp = 4
    max_err = 0.0
    entry = None
    hires = None
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        # (trunk, s2d channels, output rows and columns, N): the hires recipe's
        # enhancer head is 2048x1024 with ngf 32, so N = 4 x 32
        for trunk, c_head, ho, wo, n in (("netG", 156, H // 2, W // 2, 256),
                                         ("netE4label", 144, H // 2, W // 2, 256),
                                         ("hires enhancer", 156, H, W, 128)):
            extra = k4.head_conv_extra_rows(ho, kp)
            c = k4.padded_channels(c_head)
            xp32 = torch.randn((1, ho + kp - 1 + extra, wo + 3, c), device="cuda",
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
                if tuple(got.shape) != (1, ho, wo, n) or not rel <= tol:
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
            flops = 2.0 * ho * wo * n * kp * kp * c_head
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
            if n == 128:
                hires = {"trunk": trunk, "xp": str(tuple(xp.shape)), "n": n, "ms": k,
                         "device_ms": k_dev, "plain_ms": p, "bound_ms": bound,
                         "library_ms": lib}
        dense = phase_k4_dense(card, gen, (H // 2) * (W // 2), kp * kp * 156, 256)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    k, p, bound, lib = entry
    e = kernel_entry("head_conv_s2d", max_err, k, p, bound, "operations", lib)
    e["dense_a_leg"] = dense
    e["hires"] = hires
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
TINY_PREPROCESS = ("fixed", 128, 128, 2.0)  # the tiny flagship's 128x64, on the CPU
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


def write_cityscapes(root: Path, seed: int, split: str = "val", n: int = EVAL_IMAGES,
                     h: int = 1024) -> None:
    """``n`` (EVAL_IMAGES) Cityscapes triplets of ``split`` at 2048x``h`` from
    ``seed``: a smooth random photo with noise, block labels of 34 classes
    and 16-bit instance ids (class * 1000 + k), written as PNGs with PIL,
    the port's image I/O."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    for i in range(n):
        city = ("frankfurt", "lindau")[i % 2]
        name = f"{city}_{i:06d}_000019"
        img_dir, gt_dir = root / "leftImg8bit" / split / city, root / "gtFine" / split / city
        img_dir.mkdir(parents=True, exist_ok=True)
        gt_dir.mkdir(parents=True, exist_ok=True)
        photo, label, inst = synthetic_scene(rng, h, 2048)
        Image.fromarray(photo).save(img_dir / f"{name}_leftImg8bit.png")
        Image.fromarray(label.astype(np.uint8)).save(gt_dir / f"{name}_gtFine_labelIds.png")
        Image.fromarray(inst).save(gt_dir / f"{name}_gtFine_instanceIds.png")


def synthetic_scene(rng, h: int, w: int):
    """(uint8 photo (h, w, 3), int32 label ids, int32 instance ids): a
    smooth random photo with noise, 32x32 blocks of 34 classes and instance
    ids class * 1000 + k, as Cityscapes' conventions have them."""
    from PIL import Image

    small = Image.fromarray(rng.integers(0, 256, (32, 64, 3), dtype=np.uint8))
    photo = np.asarray(small.resize((w, h), Image.BICUBIC)).astype(np.int16)
    photo = np.clip(photo + rng.integers(-8, 9, photo.shape), 0, 255).astype(np.uint8)
    blocks = rng.integers(0, 34, (-(-h // 32), -(-w // 32)))
    inst = blocks * 1000 + rng.integers(0, 8, blocks.shape)
    full = np.ones((32, 32), np.int32)
    return (photo, np.kron(blocks, full)[:h, :w].astype(np.int32),
            np.kron(inst, full)[:h, :w].astype(np.int32))


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
K3_SITES = {2: 45, 1: 36, "A": 27, "B": 27}
K3_BWD_SITES_BY_PHASE = {2: K3_BWD_SITES, 1: {
    **{(s[1:], True): 4 for s in NORM_SHAPES[:4]},
    (NORM_SHAPES[4][1:], True): 11, (NORM_SHAPES[4][1:], False): 9}}
# the base-codec recipe's phases have netG alone: its head and last up, each
# down and up, and the res blocks
K3_BWD_SITES_BY_PHASE["A"] = K3_BWD_SITES_BY_PHASE["B"] = {
    **{(s[1:], True): 2 for s in NORM_SHAPES[:4]},
    (NORM_SHAPES[4][1:], True): 10, (NORM_SHAPES[4][1:], False): 9}
# the hires recipe (batch 1): its global trunk's 27 sites at phase A's shapes, and
# the enhancer's c7 and up at 2048x1024 x 32, d1 and 3 res blocks at 1024x512 x 64;
# frozen, the enhancer's 9 alone
K3_BWD_SITES_HIRES_ENHANCER = {(HIRES_NORM_SHAPES[0][1:], True): 2,
                               (NORM_SHAPES[0][1:], True): 4, (NORM_SHAPES[0][1:], False): 3}
K3_BWD_SITES_HIRES = dict(K3_BWD_SITES_BY_PHASE["A"])
K3_BWD_SITES_HIRES[NORM_SHAPES[0][1:], True] += 4
K3_BWD_SITES_HIRES[NORM_SHAPES[0][1:], False] = 3
K3_BWD_SITES_HIRES[HIRES_NORM_SHAPES[0][1:], True] = 2
GRAD_TOL = 1e-3  # a gradient tensor's relative L2 difference, unless fp32 conditioning is worse
# ... and never more than this, per network: set from the controls' largest
# readings on an H100 (G 1.32e-02, D 1.65e-03; the kernel config's 7.92e-03
# and 1.75e-03), with room both ways
GRAD_CEIL = {"G": 2e-2, "D": 5e-3}
K3_SITE_TOL = 1e-5  # K3 at a site of the step against its plain version, of the output's max-abs
# biases that a norm follows have a gradient of 0 in exact arithmetic (a
# LocalEnhancer's c7, d1 and up among them); a batch norm's own bias trains
NORMED_BIAS = re.compile(r"(^|\.)(head|down\.\d+|up(\.\d+)?|res\.\d+|layer[1-9]|c7|d1)\."
                         r"(?!.*BatchNorm_0).*bias$")


def flagship_train_config(kernels: bool, seed: int, phase=2, tiny: bool = False):
    """The flagship's phase-2 recipe (artifacts/flagship_r3/phase2/opt.json):
    batch 2 at 1024x512 ('fixed', normalize_std 1), fp32, block remat, Adam
    lr 2e-4 betas (0.5, 0.999), num_D 2, n_layers_D 3, ndf 64, LSGAN, VGG,
    feature matching and L1 distortion (the config's defaults), at full
    width; or its phase-1 recipe (artifacts/flagship_r3/phase1/opt.json:
    no netE, no distortion loss, normalize_std 0.5); or the base-codec
    recipe's phase A or B (artifacts/flagship_r3_compressed/phase{A,B}/
    opt.json, BASE_CODEC in place of its heif: raw semantics and the base
    codec's decoded image into netG, no encoder, cache_images; B distortion
    only, the lr on a plateau schedule); or the hires recipe's phase
    "hiresA" or "hiresB" (artifacts/flagship_r3_hires/phase{A,B}/opt.json:
    the same assembly into a LocalEnhancer, batch 1 at 2048x1024, A with
    niter_fix_global 10); ``kernels``: K3 at every generator-side norm
    site. ``tiny`` narrows the phase-2 recipe to the tiny flagship (ndf 8)
    at 128x64, for a rehearsal on the CPU."""
    from jpdse_tpu_torch.config import flagship_config

    cfg = flagship_config(kernels=kernels, tiny=tiny)
    m = cfg.model
    m.compute_dtype, m.fast_inference = "float32", False
    cfg.optim.remat, cfg.optim.remat_granularity, cfg.optim.seed = True, "block", seed
    cfg.data.batch_size = TRAIN_BATCH
    cfg.data.normalize_std = FLAGSHIP_NORMALIZE_STD
    if phase == 1:
        m.no_feat, cfg.loss.no_distortion_loss = True, True
        cfg.data.normalize_std = (0.5, 0.5, 0.5)
    if phase in ("A", "B", "hiresA", "hiresB"):
        use_base_codec(cfg)
    if phase in ("B", "hiresB"):
        L = cfg.loss
        L.no_d_gan_loss = L.no_g_gan_loss = L.no_gan_feat_loss = L.no_vgg_loss = True
        cfg.optim.schedule_lr, cfg.optim.lr_decay_patience = True, 3
    mode, load, crop, aspect = TINY_PREPROCESS if tiny else FLAGSHIP_PREPROCESS
    if tiny:
        m.ndf = 8
    if phase in ("hiresA", "hiresB"):
        use_hires(cfg, niter_fix_global=10 if phase == "hiresA" else 0)
        cfg.data.batch_size = 1
        mode, load, crop, aspect = HIRES_PREPROCESS
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


def perturbed(batch: dict, seed: int) -> list:
    """Phase 7 (a)'s two controls of ``batch``: the image (and the decoded
    image where the recipe reads one) with each value moved by 2^-22 of
    itself, up or down at random."""
    controls = []
    for i in (1, 2):
        moved = {}
        for j, k in enumerate(k for k in ("image", "compressed") if k in batch):
            signs = np.random.default_rng(seed + i + 10 * j).choice([-1.0, 1.0], batch[k].shape)
            moved[k] = (batch[k] * (1 + 2.0**-22 * signs)).astype(np.float32)
        controls.append(dict(batch, **moved))
    return controls


def hold_step(tag: str, out: dict, pre: dict, modules, seed: int, ref: str, test: str,
              out64: dict = None) -> None:
    """Phase 7 (a)'s rule for one loss_and_grads of ``test`` against ``ref``
    (``out[label]`` = (metrics, (G's, D's gradients)) for both and for the
    controls "control 1" and "control 2", ``ref`` on perturbed inputs;
    ``pre[label]`` the binarizers' pre-signs): every binarizer bit that
    differs lies within 1e-5 of its threshold against the draws of the
    generator seeded ``seed``, and no control flips one (without ``pre``,
    every run took ``ref``'s code bits, :class:`PinnedSigns`); the metrics within
    1e-4 relative; each network's largest relative L2 difference of a
    gradient tensor at most GRAD_TOL or twice the controls', and never more
    than GRAD_CEIL; a bias an InstanceNorm follows 0 to rounding.
    ``modules`` are ``ref``'s codec and discriminator (the names). With
    ``out64`` (the gradients of ``ref``'s and ``test``'s same step in
    float64, as phase 11 (a) arbitrates) every G and D tensor must agree
    within F64_TOL there, and a tensor over the fp32 bound then passes: fp32
    rounding alone moves netE's tail bias (3 values, each a sum over ~1M
    positions) by 5e-3 to 2.8e-2 between runs of one path (phase 11 (a))."""
    from jpdse_tpu_torch.train import step

    # the binarizers' draws: netE4label's first, then netE's (where there is one)
    gen = None
    others = (test, "control 1", "control 2")
    for i, name in enumerate(("netE4label", "netE")[:len(pre[ref]) if pre else 0]):
        x0 = pre[ref][i]
        gen = gen or torch.Generator(device=x0.device).manual_seed(seed)
        u = torch.rand(x0.shape, dtype=x0.dtype, device=x0.device, generator=gen)
        near = ((1.0 - x0) / 2.0 - u).abs() < 1e-5
        flips = {}
        for label in others:
            flipped = ((1.0 - x0) / 2.0 <= u) != ((1.0 - pre[label][i]) / 2.0 <= u)
            flips[label] = int(flipped.sum())
            if (flipped & ~near).any():
                raise AssertionError(f"{name}, {label}: a binarizer bit differs away from "
                                     "its threshold")
        log(f"[parity] {tag}: train {name} stochastic bits that differ from the {ref}'s, of "
            f"{x0.numel()}: " + ", ".join(f"{k} {v}" for k, v in flips.items())
            + f"; all within 1e-5 of the threshold ({int(near.sum())} bits lie there)")
        if flips["control 1"] or flips["control 2"]:
            raise AssertionError(f"{name}: a control flipped a binarizer bit, so its "
                                 "gradients are no measure of rounding alone")
    (m0, g0), (m1, g1) = out[ref], out[test]
    worst = 0.0
    for k in step.METRICS:
        a, b = m0[k].item(), m1[k].item()
        rel = abs(b - a) / abs(a) if a else abs(b)
        worst = max(worst, rel)
        if not (np.isfinite(a) and rel <= 1e-4):
            raise AssertionError(f"parity: {k} {b} against {a}")
    log(f"[parity] {tag}: train metrics, {test} vs {ref}: "
        + ", ".join(f"{k} {m1[k].item():.6f} / {m0[k].item():.6f}" for k in step.METRICS)
        + f"; largest relative difference {worst:.2e} (tolerance 1e-4)")
    for j, (net, module) in enumerate((("G", modules[0]), ("D", modules[1]))):
        names = [n for n, _ in module.named_parameters()]
        top = max(g.abs().max().item() for g in g0[j])
        zero = 0.0
        l2 = dict.fromkeys(others, (0.0, ""))
        peak = dict.fromkeys(others, (0.0, ""))
        rel_test, worst64 = {}, (0.0, "")
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
                if label == test:
                    rel_test[n] = rel2
            if out64 is not None:
                a64 = out64[ref][j][i]
                worst64 = max(worst64, (((out64[test][j][i] - a64).norm() / a64.norm()).item(), n))
        noise = max(l2["control 1"][0], l2["control 2"][0])
        bound = min(GRAD_CEIL[net], max(GRAD_TOL, 2 * noise))
        over = sorted(n for n, v in rel_test.items() if v > bound)
        if out64 is not None:
            log(f"[parity] {tag}: train {net} gradients in float64, {test} vs {ref}: largest "
                f"relative L2 {worst64[0]:.2e} at {worst64[1]} (tolerance {F64_TOL}); tensors "
                f"over the fp32 bound, decided by float64: {over or 'none'}")
            if not worst64[0] <= F64_TOL:
                raise AssertionError(f"parity: {net} gradients differ in float64: {worst64}")
            over = []
        log(f"[parity] {tag}: train {net} gradients, {len(names)} tensors; largest relative L2 "
            f"difference and largest difference against a tensor's max-abs, each against "
            f"the {ref}: " + "; ".join(
                f"{label} {l2[label][0]:.2e} at {l2[label][1]}, {peak[label][0]:.2e} at "
                f"{peak[label][1]}" for label in others)
            + f". Bound for the {test}: {bound:.2e} (GRAD_TOL {GRAD_TOL} or twice "
            f"the controls', at most {GRAD_CEIL[net]}). The biases an InstanceNorm follows at "
            f"most {zero:.2e} (0 to rounding; largest gradient {top:.3e})")
        if over or not zero <= 1e-5 * top:
            raise AssertionError(f"parity: {net} gradients differ: {l2}, norm-fed biases "
                                 f"{zero} (top {top})")


def phase_train_parity(seed: int, card: str, phase=2) -> dict:
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
            if a is not None:
                b.load_state_dict(a.state_dict())
        batch = train_batch(base.cfg, seed)
        controls = perturbed(batch, seed)
        for t in (base, fused):  # every norm site of a LocalEnhancer's step, its trunk too
            if t.cfg.model.niter_fix_global:
                t.maybe_unfreeze_global(t.cfg.model.niter_fix_global)
        n_g = sum(p.numel() for p in base.gan.codec.parameters())
        n_d = sum(p.numel() for p in base.gan.disc.parameters())
        _, hh, ww, _ = batch["image"].shape
        log(f"[train] {tag} at {ww}x{hh}, batch {base.cfg.data.batch_size}, fp32: G {n_g} and "
            f"D {n_d} "
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
        with torch.no_grad():
            pre = {label: t.gan.codec.get_presign(t.gan.codec.prepare(t.place(b)))
                   for label, t, b in (("default", base, batch), ("kernel config", fused, batch),
                                       ("control 1", base, controls[0]),
                                       ("control 2", base, controls[1]))}
        hold_step(tag, out, pre, (base.gan.codec, base.gan.disc), seed, "default",
                  "kernel config")
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


def phase_train_steps(seed: int, steps: int, card: str, phase=2) -> dict:
    """(b) ``steps`` Trainer.steps of the ``phase`` recipe in each configuration at PyTorch's default
    precision (convolutions in TF32, matmuls in fp32): the median step after
    the first, images/s, peak memory, finite losses, K3's launches per step;
    then one more step under the profiler. Returns each configuration's
    launch counts."""
    from jpdse_tpu_torch.trainer import Trainer

    if not (torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32):
        raise AssertionError("the timed steps run at PyTorch's default precision")
    cfg = flagship_train_config(False, seed, phase)
    # the base codec's round trip of each batch is done here, before the timed steps
    batches = [train_batch(cfg, seed + 100 + i) for i in range(steps)]
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


# -- the base-codec recipe: raw semantics over a base codec's decoded image -----------
# libheif does not load on the card's machine (heif_available() is False
# there: no libheif, libx265 or libde265 is installed), so phase 9 fixes the
# recipe's base codec to jpg at the quality of the repo's
# tracked jpg base-codec recipe (artifacts/three_phase/phase2/opt.json); the
# model, the side info and every path are the recipe's own
BASE_CODEC = ("jpg", 50)
# kernel launches per decompress of a side-info-only stream (a compress
# launches none: it is host work): the fast path re-aligns netG's back (K1),
# in the kernel configuration also its 156-channel head (K1 feeding K4); the
# standard path's K3 runs at netG's 27 norm sites
BASE_SERVE_LAUNCHES = {
    "default fast path": {"s2d_realign_pad3": 1},
    "kernel-config fast path": {"s2d_realign_pad3": 2, "head_conv_s2d": 1},
    "kernel-config standard path": {"fused_instance_norm": 27},
    "default standard path": {},
}
# netG over the decoded image alone (no semantics): K2 on its 3-channel front
NOSEM_LAUNCHES = {"s2d_realign_pad3": 1, "s2d_pad3": 1}
BASE_FLAGS = ["--no_feat_encoding", "--no_label_encoding", "--use_compressed", "--ext",
              BASE_CODEC[0], "--quality", str(BASE_CODEC[1]), "--cache_images", "1"]


def use_base_codec(cfg, nosem: bool = False) -> None:
    """The base-codec recipe's model on ``cfg``: raw one-hot semantics and
    the edge map (36 channels) beside BASE_CODEC's decoded image (3) into
    netG, no encoder; with ``nosem`` the decoded image alone
    (artifacts/flagship_r4_nosem_q20/phaseA/opt.json's model)."""
    m = cfg.model
    m.no_feat_encoding = m.no_label_encoding = True
    if nosem:
        m.no_label = m.no_instance = True
    cfg.codec.use_compressed = cfg.data.cache_images = True
    cfg.codec.ext, cfg.codec.quality = BASE_CODEC[0], (BASE_CODEC[1],)
    cfg.validate()


def with_base_codec(cfg, batch: dict) -> dict:
    """``batch`` with each image's round trip through the base codec, as
    the data pipeline adds it: ``compressed`` (normalized), the streams,
    their codec and bytes."""
    from jpdse_tpu_torch.codecs.bridge import compress_for_model
    from jpdse_tpu_torch.utils.misc import tensor2im

    d = cfg.data
    trips = [compress_for_model(tensor2im(im, d.normalize_mean, d.normalize_std), cfg.codec.ext,
                                cfg.codec.quality, d.normalize_mean, d.normalize_std, True)
             for im in batch["image"]]
    return dict(batch, compressed=np.stack([t[0] for t in trips]),
                base_codec_bytes=np.array([t[1] for t in trips], np.int64),
                base_codec_streams=[t[2] for t in trips], base_codec_ext=[t[3] for t in trips])


def scene_batch(cfg, seed: int, h: int = H, w: int = W) -> dict:
    """One request of a synthetic scene at w x h (synthetic_scene, the
    image normalized as the data pipeline does), with its base-codec round
    trip."""
    from jpdse_tpu_torch.data.transforms import image_to_normalized
    from PIL import Image

    photo, label, inst = synthetic_scene(np.random.default_rng(seed), h, w)
    d = cfg.data
    image = image_to_normalized(Image.fromarray(photo), d.normalize_mean, d.normalize_std)
    return with_base_codec(cfg, {"label": label[None].astype(np.float32), "instance": inst[None],
                                 "image": image[None]})


def base_codec_configs(nosem: bool = False):
    """The recipe's serving configuration (bf16, the fast path) and its
    kernel configuration."""
    from jpdse_tpu_torch.config import flagship_config

    out = []
    for kernels in (False, True):
        cfg = flagship_config(kernels=kernels)
        use_base_codec(cfg, nosem)
        out.append(cfg)
    return out


def phase9_probe(card: str) -> None:
    """(0) What the card's machine offers: the codecs, libheif; the heif
    leg raises CodecUnavailable where libheif does not load, as in JAX.
    One encode and one decode of a 1024x512 scene by BASE_CODEC, timed on
    the host."""
    from jpdse_tpu_torch import native
    from jpdse_tpu_torch.codecs import bridge

    heif = native.heif_available()
    log(f"[base] available_codecs() {bridge.available_codecs()}; heif_available() {heif}; "
        f"phase 9's base codec: {BASE_CODEC[0]} q{BASE_CODEC[1]} (fixed in the script)")
    photo = synthetic_scene(np.random.default_rng(7), H, W)[0]
    if not heif:
        try:
            bridge.encode_bytes(photo, "heif", 30)
        except bridge.CodecUnavailable as e:
            log(f"[base] ext heif raises CodecUnavailable here: {e}")
        else:
            raise AssertionError("heif encoded without libheif")
    enc, dec, n = [], [], 0
    for _ in range(5):
        t0 = time.perf_counter()
        stream, ext = bridge.encode_bytes(photo, *BASE_CODEC)
        t1 = time.perf_counter()
        out = bridge.decode_bytes(stream, ext)
        dec.append((time.perf_counter() - t1) * 1e3)
        enc.append((t1 - t0) * 1e3)
        n = len(stream)
    err = np.abs(out.astype(np.int16) - photo).mean()
    if out.shape != photo.shape or not err < 32:
        raise AssertionError(f"{BASE_CODEC} round trip: shape {out.shape}, mean error {err}")
    log(f"[base] {BASE_CODEC[0]} q{BASE_CODEC[1]} of a {W}x{H} scene: {n} bytes "
        f"({8 * n / (H * W):.4f} bpp, mean abs error {err:.2f} levels); encode {np.median(enc):.2f} ms, decode "
        f"{np.median(dec):.2f} ms on the host, medians of 5 ({card})")


def base_stream_sections(stream: bytes) -> dict:
    """Bytes of a side-info-only stream by section: the container, the id
    maps, the base codec's streams."""
    from jpdse_tpu_torch import codec_io

    bs = codec_io.unpack_full(stream)
    base = sum(len(p) for p in bs.side.base_payloads or [])
    flags = stream[14]  # no code: magic 4, version and size 5, n_codes 1, payload length 4
    n_maps = bin(flags & 3).count("1")
    container = 15 + 4 * n_maps + (2 + len(bs.side.base_ext) + 4 * len(bs.side.base_payloads)
                                   if flags & 4 else 0)
    return {"container": container, "id maps": len(stream) - container - base,
            "base codec": base}


def phase9_serve(seed: int, requests: int, card: str, configs=None, table=None,
                 hw=(H, W), tag: str = "[base]", what: str = "base-codec") -> dict:
    """(d) The recipe's codec at full width: fp32 images of the three other
    paths against the default standard path (TF32 off, the same side
    inputs); then --requests bf16 requests through side-info-only .jpds
    streams on the four serving paths, launches asserted per call (none in
    a compress), bytes by section and the host stages beside the device
    part. Returns each path's counts. ``configs`` (the serving and the
    kernel configuration), ``table`` (launches per decompress by path), the
    requests' ``hw``, ``tag`` and ``what`` serve phase 10's hires recipe."""
    import copy

    from jpdse_tpu_torch import codec_io
    from jpdse_tpu_torch.models.codec import SemanticCodec
    from jpdse_tpu_torch.models.fast_codec import FastCodec
    from jpdse_tpu_torch.serve import CodecServer

    cfg, kcfg = configs or base_codec_configs()
    table = table or BASE_SERVE_LAUNCHES
    hh, ww = hw
    codec = SemanticCodec(cfg, device="cuda", seed=seed, dtype=torch.float32)
    state = codec.state_dict()
    log(f"{tag} {what} codec: netG over {cfg.netG_input_nc} channels, "
        f"{sum(p.numel() for p in codec.parameters())} parameters from seed {seed}; "
        f"side_requirements {codec_io.side_requirements(cfg)}")
    request = scene_batch(cfg, seed + 60, hh, ww)
    dev = {k: torch.as_tensor(request[k], device="cuda")
           for k in ("label", "instance", "image", "compressed")}
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.inference_mode():
            want = codec.decode(codec.prepare(dev))[0]
        fused = SemanticCodec(kcfg, device="cuda", seed=None, dtype=torch.float32)
        fused.load_state_dict(state)
        for path, fn, launch in (
                ("fp32 default fast path", lambda: FastCodec(cfg, state, device="cuda",
                                                             dtype=torch.float32).decode(dev),
                 table["default fast path"]),
                ("fp32 kernel-config fast path", lambda: FastCodec(
                    kcfg, state, device="cuda", dtype=torch.float32).decode(dev),
                 table["kernel-config fast path"]),
                ("fp32 standard path with K3", lambda: fused.decode(fused.prepare(dev))[0],
                 table["kernel-config standard path"])):
            reset_counts()
            with torch.inference_mode():
                got = fn()
            check_image(f"{what} codec, {path}", got, want)
            counts = {k: v for k, v in read_counts().items() if v}
            if counts != launch:
                raise AssertionError(f"{what} {path}: launched {counts}, want {launch}")
        del fused
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved

    kstd, dstd = copy.deepcopy(kcfg), copy.deepcopy(cfg)
    kstd.model.fast_inference = dstd.model.fast_inference = False
    paths = {"default fast path": cfg, "kernel-config fast path": kcfg,
             "kernel-config standard path": kstd, "default standard path": dstd}
    batches = [scene_batch(cfg, seed + 61 + r, hh, ww) for r in range(requests)]
    launches = {}
    for label, c in paths.items():
        torch.cuda.empty_cache()
        server = CodecServer(c, state, device="cuda")
        rows = {k: [] for k in ("compress", "idmap", "pack", "decompress", "unpack",
                                "base_decode", "device part")}
        reset_counts()
        for r, batch in enumerate(batches):
            before = read_counts()
            t0 = time.perf_counter()
            streams = server.compress(batch)
            rows["compress"].append((time.perf_counter() - t0) * 1e3)
            rows["idmap"].append(server.times["idmap"])
            rows["pack"].append(server.times["pack"])
            mid = read_counts()
            t0 = time.perf_counter()
            image = server.decompress(streams[0])
            torch.cuda.synchronize()
            rows["decompress"].append((time.perf_counter() - t0) * 1e3)
            for k in ("unpack", "base_decode"):
                rows[k].append(server.times[k])
            rows["device part"].append(server.times["decompress_codes"])
            after = read_counts()
            comp = {k: mid[k] - before[k] for k in mid}
            dec = {k: after[k] - mid[k] for k in mid}
            want_dec = table[label]
            if any(comp.values()) or dec != {k: want_dec.get(k, 0) for k in dec}:
                raise AssertionError(f"{what} {label} request {r}: compress launched "
                                     f"{comp}, decompress {dec}, want none and {want_dec}")
            bs = codec_io.unpack_full(streams[0])
            if bs.codes or bs.image_hw != (hh, ww) or not np.array_equal(
                    bs.side.label, batch["label"][0].astype(np.int32)) or \
                    bs.side.base_payloads != batch["base_codec_streams"][0]:
                raise AssertionError(f"{what} {label} request {r}: the stream does not "
                                     "hold the request's side info alone")
            if image.shape != (hh, ww, 3) or not np.isfinite(image).all() or \
                    np.abs(image).max() > 1.0:
                raise AssertionError(f"{what} {label} request {r}: image {image.shape}")
            sec = base_stream_sections(streams[0])
            log(f"{tag} {label} request {r}: .jpds {len(streams[0])} bytes "
                f"({8 * len(streams[0]) / (hh * ww):.4f} bpp: id maps {sec['id maps']} bytes "
                f"{8 * sec['id maps'] / (hh * ww):.4f} bpp, {BASE_CODEC[0]} "
                f"{sec['base codec']} bytes {8 * sec['base codec'] / (hh * ww):.4f} bpp, container "
                f"{sec['container']}); compress {rows['compress'][r]:.2f} ms (id-map coding "
                f"{rows['idmap'][r]:.2f}, pack {rows['pack'][r]:.2f}, no device work), "
                f"decompress {rows['decompress'][r]:.2f} ms (unpack {rows['unpack'][r]:.2f}, "
                f"{BASE_CODEC[0]} decode {rows['base_decode'][r]:.2f}, device part "
                f"{rows['device part'][r]:.2f}) ({card})")
        launches[f"{what} serve: {label}"] = read_counts()
        rest = slice(1, None) if requests > 1 else slice(None)
        med = {k: float(np.median(v[rest])) for k, v in rows.items()}
        log(f"{tag} {label}: bf16 batch 1 at {ww}x{hh}, medians after the first request: "
            f"compress {med['compress']:.2f} ms (id-map coding {med['idmap']:.2f}), decompress "
            f"{med['decompress']:.2f} ms (unpack {med['unpack']:.2f}, {BASE_CODEC[0]} decode "
            f"{med['base_decode']:.2f}, device part {med['device part']:.2f}); launches per "
            f"decompress {table[label]} ({card})")
        del server
    del codec
    torch.cuda.empty_cache()
    return launches


def phase9_nosem(seed: int, card: str) -> dict:
    """(e) netG over the decoded image alone (flagship_r4_nosem's model) on
    the kernel configuration's fast path: K2 on netG's 3-channel front and
    K1 in its back, asserted; its fp32 image against the default standard
    path's (TF32 off), and one bf16 request through bytes. Returns the
    counts."""
    from jpdse_tpu_torch import codec_io
    from jpdse_tpu_torch.models.codec import SemanticCodec
    from jpdse_tpu_torch.models.fast_codec import FastCodec
    from jpdse_tpu_torch.serve import CodecServer

    cfg, kcfg = base_codec_configs(nosem=True)
    codec = SemanticCodec(cfg, device="cuda", seed=seed, dtype=torch.float32)
    state = codec.state_dict()
    batch = scene_batch(cfg, seed + 70)
    dev = {k: torch.as_tensor(batch[k], device="cuda") for k in ("image", "compressed")}
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.inference_mode():
            want = codec.decode(codec.prepare(dev))[0]
        fast = FastCodec(kcfg, state, device="cuda", dtype=torch.float32)
        reset_counts()
        got = fast.decode(dev)
        counts = {k: v for k, v in read_counts().items() if v}
        check_image("nosem codec, fp32 kernel-config fast path", got, want)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    if counts != NOSEM_LAUNCHES:
        raise AssertionError(f"nosem kernel-config fast decode launched {counts}, want "
                             f"{NOSEM_LAUNCHES}")
    server = CodecServer(kcfg, state, device="cuda")
    reset_counts()
    stream = server.compress(batch)[0]
    if any(read_counts().values()) or codec_io.side_requirements(kcfg) != (False, False, True):
        raise AssertionError("nosem compress: device work, or side info beyond the base codec")
    t0 = time.perf_counter()
    image = server.decompress(stream)
    ms = (time.perf_counter() - t0) * 1e3
    counts = read_counts()
    if {k: v for k, v in counts.items() if v} != NOSEM_LAUNCHES or not np.isfinite(image).all():
        raise AssertionError(f"nosem decompress launched {counts}")
    log(f"[base] nosem codec (netG over {cfg.netG_input_nc} channels, "
        f"{sum(p.numel() for p in codec.parameters())} parameters), kernel-config fast path: "
        f"K2 on netG's 3-channel front and K1 in its back, {counts['s2d_pad3']} and "
        f"{counts['s2d_realign_pad3']} per decompress; .jpds {len(stream)} bytes "
        f"({8 * len(stream) / (H * W):.4f} bpp, the {BASE_CODEC[0]} stream alone); bf16 "
        f"decompress {ms:.2f} ms, first call (device part "
        f"{server.times['decompress_codes']:.2f}) ({card})")
    del codec, server
    torch.cuda.empty_cache()
    return {"base-codec nosem: kernel-config fast path": counts}


def phase9_chain(seed: int, card: str, keep_dir: Path) -> dict:
    """(c) The recipe through train.run.main in the kernel configuration at
    full width, on a synthetic Cityscapes train/val split read through
    PairedDataset with cache_images: phase A for two epochs of 2 steps
    (each epoch's loader wait printed; the device cache makes the base
    codec's round trips when it is built) with validation and a best-val save at
    the end; then phase B (distortion only) restored from it, every leaf
    matched, validated, for one epoch. Counts are set to 0 before each main
    and asserted after it. Phase A's params_g.pt is copied into
    ``keep_dir`` (phase 10 warm-starts from it). Returns each main's counts."""
    import shutil

    from jpdse_tpu_torch.train import run
    from jpdse_tpu_torch.train.checkpoint import PARAMS_D_FILE, PARAMS_FILE

    launches = {}
    n = K3_SITES["A"]
    steps = EVAL_IMAGES // TRAIN_BATCH
    keep = ("epoch ", "val set avg", "saving model", "checkpoint", "restored",
            "optimizer state", "device_cache")
    with tempfile.TemporaryDirectory(prefix="jpdse_base_") as tmp:
        tmp = Path(tmp)
        root = tmp / "cityscapes"
        for split in ("train", "val"):
            write_cityscapes(root, seed + 20 + (split == "train"), split)
        mode, load, crop, _ = FLAGSHIP_PREPROCESS
        base = ["--dataset", "cityscapes", "--root_dir", str(root), "--no_generator_binarization",
                "--normalize_std", "1", "--batch_size", str(TRAIN_BATCH), "--remat", "1",
                "--seed", str(seed), "--num_workers", "2", "--max_recon_dump", "2",
                "--fused_instance_norm", "1"] + BASE_FLAGS
        for prefix in ("", "val_"):
            base += [f"--{prefix}preprocess_mode", mode, f"--{prefix}load_size", str(load),
                     f"--{prefix}crop_size", str(crop)]
        da, db = str(tmp / "phaseA"), str(tmp / "phaseB")
        runs = {
            "phase A": (base + ["--save_dir", da, "--num_epochs", "2", "--val_interval", "2"],
                        2 * steps * 2 * n + (EVAL_IMAGES + 2) * n, 2 * steps * n),
            "phase B from phase A": (
                base + ["--save_dir", db, "--num_epochs", "1", "--val_interval", "5",
                        "--no_d_gan_loss", "--no_g_gan_loss", "--no_gan_feat_loss",
                        "--no_vgg_loss", "--schedule_lr", "1", "--lr_decay_patience", "3",
                        "--load_model", "--checkpoints_dir", da],
                EVAL_IMAGES * n + steps * 2 * n, steps * n),
        }
        for label, (argv, fwd, bwd) in runs.items():
            torch.cuda.empty_cache()
            result = {}

            def main_run(argv=argv):
                result["trainer"] = run.main(argv, device="cuda")

            _, text, counts = run_entry(
                label, "train.run.main", main_run,
                {"fused_instance_norm": fwd, "fused_instance_norm_bwd": bwd}, per=1,
                tag="[base]", keep=keep)
            launches[f"base-codec chain: {label}"] = counts
            trainer = result.pop("trainer")
            waits = [tuple(float(x) for x in m) for m in re.findall(
                r"loader wait ([\d.]+) s of ([\d.]+) s", text)]
            if label == "phase A":
                if len(waits) != 2 or trainer.steps_taken != 2 * steps:
                    raise AssertionError(f"phase A: loader waits {waits}, steps "
                                         f"{trainer.steps_taken}")
                log(f"[base] phase A: loader wait {waits[0][0]:.3f} s of the first epoch's "
                    f"{waits[0][1]:.3f} s, {waits[1][0]:.3f} s of the second's "
                    f"{waits[1][1]:.3f} s (the device cache: every image's {BASE_CODEC[0]} "
                    f"round trips made once, when it is built) ({card})")
            else:
                want_n = len(trainer.gan.codec.state_dict()) + len(trainer.gan.disc.state_dict())
                for name in (PARAMS_FILE, PARAMS_D_FILE):
                    if not (Path(da) / name).exists():
                        raise AssertionError(f"phase A saved no {name}")
                if f"restored params from {da}: {want_n}/{want_n} leaves matched" not in text:
                    raise AssertionError(f"phase B's restore: want {want_n}/{want_n}")
                if trainer.steps_taken != 3 * steps:
                    raise AssertionError(f"phase B: steps taken {trainer.steps_taken}")
                keep_dir.mkdir(parents=True, exist_ok=True)
                shutil.copy(Path(da) / PARAMS_FILE, keep_dir / PARAMS_FILE)
                log(f"[base] phase B restored all {want_n} leaves from phase A and took "
                    f"{steps} distortion-only steps; loader wait {waits[0][0]:.3f} s of "
                    f"{waits[0][1]:.3f} s ({card})")
            del trainer
    return launches


def phase9_eval(seed: int, card: str, kcfg=None, per_image=None, images: int = EVAL_IMAGES,
                preprocess=FLAGSHIP_PREPROCESS, tag: str = "[base]",
                what: str = "base-codec") -> dict:
    """(f) test.main, compress.main and decompress.main of the recipe's
    codec (random weights from --seed) on the kernel configuration's fast
    path, on a synthetic Cityscapes val split: finite metrics, the side
    rates, each .jpds file as long as sem_side_bpp and base_codec_bpp say
    plus its container's bytes, decompressed PNGs within one uint8 level
    of the test run's reconstructions. Returns the counts. ``kcfg``,
    ``per_image`` (launches), the first ``images`` of the split read with
    ``preprocess``, ``tag`` and ``what`` serve phase 10's hires recipe."""
    from PIL import Image

    from jpdse_tpu_torch import compress, decompress, test
    from jpdse_tpu_torch.models.codec import SemanticCodec
    from jpdse_tpu_torch.train.checkpoint import save_params

    if kcfg is None:
        _, kcfg = base_codec_configs()
        per_image = BASE_SERVE_LAUNCHES["kernel-config fast path"]
    mode, load, crop, aspect = preprocess
    hh, ww = round(crop / aspect), crop
    with tempfile.TemporaryDirectory(prefix="jpdse_base_eval_") as tmp:
        root, run_dir, out = Path(tmp) / "cityscapes", Path(tmp) / "run", Path(tmp) / "out"
        write_cityscapes(root, seed + 30)
        for pp in (kcfg.data.preprocess, kcfg.data.val_preprocess, kcfg.data.test_preprocess):
            pp.preprocess_mode, pp.load_size, pp.crop_size = mode, load, crop
            pp.aspect_ratio = aspect
        kcfg.data.dataset, kcfg.data.root_dir = "cityscapes", str(root)
        kcfg.data.normalize_std = FLAGSHIP_NORMALIZE_STD
        kcfg.data.num_workers, kcfg.optim.seed = 2, seed
        run_dir.mkdir()
        kcfg.save(str(run_dir / "opt.json"))
        codec = SemanticCodec(kcfg, device="cuda", seed=seed, dtype=torch.float32)
        save_params(str(run_dir), codec.state_dict())
        del codec
        argv = ["--load_opt", "--opt_file", str(run_dir / "opt.json"), "--checkpoints_dir",
                str(run_dir), "--mode", "val", "--max_dataset_size", str(images)]
        metrics, text, c_test = run_entry(what, "test.main", lambda: test.main(
            argv + ["--save_dir", str(out / "test")], device="cuda"), per_image, images, tag)
        summary, _, c_comp = run_entry(what, "compress.main", lambda: compress.main(
            argv + ["--save_dir", str(out / "bits")], device="cuda"), {}, images, tag)
        written, _, c_dec = run_entry(what, "decompress.main", lambda: decompress.main(
            ["--input", str(out / "bits")] + argv + ["--save_dir", str(out / "recon")],
            device="cuda"), per_image, images, tag)
        rates = ("sem_side_bpp", "base_codec_bpp", "total_bpp", "PSNR", "MS-SSIM", "L1")
        if metrics["n_images"] != images or not np.isfinite([metrics[k] for k in rates]).all():
            raise AssertionError(f"{what} eval: metrics {metrics}")
        if not np.isclose(metrics["total_bpp"], metrics["sem_side_bpp"]
                          + metrics["base_codec_bpp"], rtol=1e-12, atol=0):
            raise AssertionError(f"{what} eval: total_bpp {metrics['total_bpp']}")
        files = sorted((out / "bits").glob("*.jpds"))
        data = [p.read_bytes() for p in files]
        container = sum(base_stream_sections(b)["container"] for b in data)
        side = (metrics["sem_side_bpp"] + metrics["base_codec_bpp"]) * images * hh * ww / 8
        if len(files) != images or not np.isclose(sum(map(len, data)), side + container,
                                                       rtol=0, atol=1e-6):
            raise AssertionError(f"{what} deploy: {len(files)} files of "
                                 f"{sum(map(len, data))} bytes, the rates say {side} + "
                                 f"{container}")
        worst = 0
        for p in map(Path, written):
            got = np.asarray(Image.open(p)).astype(np.int16)
            ref = np.asarray(Image.open(out / "test/test_visualizations/images/"
                                        "reconstructed_image" / p.name)).astype(np.int16)
            worst = max(worst, int(np.abs(got - ref).max()))
        if len(written) != images or worst > 1:
            raise AssertionError(f"{what} deploy: PNGs differ by {worst} levels")
        splits = [tuple(float(x) for x in m) for m in re.findall(
            r"host clock: load ([\d.]+), device ([\d.]+), coder ([\d.]+), metrics ([\d.]+), "
            r"gallery ([\d.]+), side ([\d.]+)", text)]
        rest = np.median(np.asarray(splits[1:]), axis=0) * 1e3
        log(f"{tag} eval, kernel-config fast path: PSNR {metrics['PSNR']:.4f} dB, MS-SSIM "
            f"{metrics['MS-SSIM']:.6f}; sem_side_bpp {metrics['sem_side_bpp']:.6f}, "
            f"base_codec_bpp {metrics['base_codec_bpp']:.6f}, total_bpp "
            f"{metrics['total_bpp']:.6f} = the {images} .jpds files' "
            f"{sum(map(len, data))} bytes less {container} of containers; PNGs within {worst} "
            f"level(s); per image after the first, host clock (ms): load {rest[0]:.1f}, device "
            f"{rest[1]:.1f}, id-map rate {rest[5]:.1f}, metrics {rest[3]:.1f}, gallery "
            f"{rest[4]:.1f} ({card})")
    return {f"{what} eval: kernel-config fast path": {
        k: c_test[k] + c_comp[k] + c_dec[k] for k in c_test}}


def phase9(seed: int, requests: int, steps: int, card: str, keep: Path) -> tuple:
    """The base-codec recipe at full width: (0) the probe, (a) one step's
    parity, (b) timed steps, (c) the phase chain (phase A's weights kept in
    ``keep``), (d) serving, (e) the nosem codec, (f) eval and deploy.
    Returns (serving and eval counts, training counts)."""
    t0 = time.perf_counter()
    phase9_probe(card)
    train = {f"phase-A train parity: {k}": v for k, v in
             phase_train_parity(seed, card, phase="A").items()}
    train.update({f"phase-A train steps: {k}": v for k, v in
                  phase_train_steps(seed, steps, card, phase="A").items()})
    train.update(phase9_chain(seed, card, keep))
    serve = phase9_serve(seed, requests, card)
    serve.update(phase9_nosem(seed, card))
    serve.update(phase9_eval(seed, card))
    log(f"[base] base-codec recipe phase {time.perf_counter() - t0:.1f} s")
    return serve, train


# -- the hires recipe: a LocalEnhancer at 2048x1024 ----------------------------------
# artifacts/flagship_r3_hires/phase{A,B}/opt.json: the base-codec recipe's
# assembly (raw semantics beside BASE_CODEC's decoded image, 39 channels) into a
# LocalEnhancer (ngf 32: its global trunk at ngf 64 on the input pooled to
# 1024x512, one enhancer of 3 res blocks at 2048x1024), batch 1, fp32, block
# remat; phase A the GAN with the trunk frozen for niter_fix_global epochs,
# phase B distortion only. Its base codec is BASE_CODEC, as in phase 9
HIRES_H, HIRES_W = 1024, 2048
HIRES_PREPROCESS = ("fixed", 2048, 2048, 2.0)
K3_SITES["hiresA"] = K3_SITES["hiresB"] = 36  # the trunk's 27 and the enhancer's 9
K3_BWD_SITES_BY_PHASE["hiresA"] = K3_BWD_SITES_BY_PHASE["hiresB"] = K3_BWD_SITES_HIRES
K3_HIRES_FROZEN = (27 + 2 * 9, 9)  # K3 forward and backward a frozen step
# kernel launches per decompress of a side-info-only stream: the fast path
# re-aligns the enhancer's back (K1; the trunk has no back), in the kernel
# configuration also both 156-channel heads (K1 feeding K4, N 256 and 128); the
# standard path's K3 runs at all 36 norm sites
HIRES_SERVE_LAUNCHES = {
    "default fast path": {"s2d_realign_pad3": 1},
    "kernel-config fast path": {"s2d_realign_pad3": 3, "head_conv_s2d": 2},
    "kernel-config standard path": {"fused_instance_norm": 36},
    "default standard path": {},
}
HIRES_FLAGS = ["--netG", "local", "--ngf", "32", "--n_local_enhancers", "1",
               "--n_blocks_local", "3"]


def use_hires(cfg, niter_fix_global: int = 0) -> None:
    """The hires recipe's LocalEnhancer on ``cfg`` (use_base_codec's
    assembly)."""
    m = cfg.model
    m.netG, m.ngf, m.n_local_enhancers, m.n_blocks_local = "local", 32, 1, 3
    m.niter_fix_global = niter_fix_global
    cfg.validate()


def hires_configs():
    """The hires recipe's serving configuration (bf16, the fast path) and
    its kernel configuration."""
    out = base_codec_configs()
    for cfg in out:
        use_hires(cfg)
    return out


def phase10_warmstart(src: Path, dst: Path) -> int:
    """(0) Phase 9's phase-A weights (a global netG, ngf 64, 39 input
    channels) re-nested by the warm-start module; returns the trunk's leaf
    count, every source leaf but the tail's two."""
    from jpdse_tpu_torch.train import warmstart

    with contextlib.redirect_stdout(io.StringIO()) as out:
        path = warmstart.main(["--src", str(src), "--dst", str(dst)])
    params = torch.load(path, map_location="cpu", weights_only=True)
    source = torch.load(src / "params_g.pt", map_location="cpu", weights_only=True)
    trunk = [k for k in params if k.startswith("netG.global.")]
    if len(trunk) != len(source) - 2 or len(params) != len(trunk) or any(
            not torch.equal(params[k], source["netG." + k[len("netG.global."):]]) for k in trunk):
        raise AssertionError(f"warm start: {len(trunk)} trunk leaves of {len(source)}")
    log(f"[hires] warm start: {out.getvalue().strip()}")
    return len(trunk)


def phase10_steps(seed: int, steps: int, card: str) -> dict:
    """(b) ``steps`` Trainer.steps of phase A in each configuration with the
    global trunk frozen, then ``steps`` more after it is unfrozen, at
    PyTorch's default precision: the median of each run after its first
    step, images/s, peak memory, K3's launches per step, and one profiled
    step of each. Returns the launch counts."""
    from jpdse_tpu_torch.trainer import Trainer

    cfg = flagship_train_config(False, seed, "hiresA")
    batches = [train_batch(cfg, seed + 100 + i) for i in range(steps)]
    launches, medians = {}, {}
    for label, kernels in (("default", False), ("kernel config", True)):
        torch.cuda.empty_cache()
        trainer = Trainer(flagship_train_config(kernels, seed, "hiresA"), mode="train",
                          device="cuda")
        for frozen in (True, False):
            if not frozen:
                with contextlib.redirect_stdout(io.StringIO()):
                    trainer.maybe_unfreeze_global(trainer.cfg.model.niter_fix_global)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            times = []
            for b in batches:
                t0 = time.perf_counter()
                metrics = trainer.step(b)
                times.append((time.perf_counter() - t0) * 1e3)
                if not all(np.isfinite(v) for v in metrics.values()):
                    raise AssertionError(f"hires {label}: losses {metrics}")
            state = "frozen" if frozen else "unfrozen"
            launches[f"{label}, {state}"] = counts = read_counts()
            want = (0, 0)
            if kernels:
                want = K3_HIRES_FROZEN if frozen else (72, 36)
            if k3_per_step(counts, steps) != want:
                raise AssertionError(f"hires {label}, {state}: K3 per step "
                                     f"{k3_per_step(counts, steps)}, want {want}")
            peak = torch.cuda.max_memory_allocated() / 2**30
            med = float(np.median(times[1:] if steps > 1 else times))
            medians[label, state] = med
            log(f"[hires] phase A, {label}, trunk {state}: steps (ms) "
                f"{', '.join(f'{t:.1f}' for t in times)}; median after the first {med:.1f} ms, "
                f"{1e3 / med:.3f} images/s; peak memory {peak:.2f} GiB; K3 per step forward "
                f"{want[0]}, backward {want[1]}; convolutions in TF32 ({card})")
            profile_step(f"hires phase A, {label}, trunk {state}", trainer, batches[-1], card)
        del trainer
    for state in ("frozen", "unfrozen"):
        log(f"[hires] phase A, trunk {state}: kernel config step / default step: "
            f"{medians['kernel config', state] / medians['default', state]:.3f} ({card})")
    return launches


def phase10_chain(seed: int, card: str, warm_src: Path) -> dict:
    """(0) and (c): the warm start, then phase A through train.run.main in the
    kernel configuration from it (--load_model), every trunk leaf restored,
    the trunk frozen for its first epoch (niter_fix_global 2: the warm
    start's sidecar says epoch 0, so the run starts at epoch 1, as the JAX
    package's does) and trained in its second, 2 steps each on a synthetic
    2048x1024 split: the trunk bit-equal to the warm start in the best-val
    save after the first epoch, changed in save_dir/latest after the
    second; then phase B restored from latest, every leaf matched. Counts
    are set to 0 before each main and asserted after it. Returns them."""
    from jpdse_tpu_torch.train import run
    from jpdse_tpu_torch.train.checkpoint import PARAMS_FILE

    launches = {}
    images = 2
    fwd, bwd = K3_HIRES_FROZEN
    keep = ("epoch ", "val set avg", "saving model", "checkpoint", "restored",
            "optimizer state", "now also")
    with tempfile.TemporaryDirectory(prefix="jpdse_hires_") as tmp:
        tmp = Path(tmp)
        root = tmp / "cityscapes"
        for split in ("train", "val"):
            write_cityscapes(root, seed + 40 + (split == "train"), split)
        n_trunk = phase10_warmstart(warm_src, tmp / "warm")
        mode, load, crop, _ = HIRES_PREPROCESS
        base = ["--dataset", "cityscapes", "--root_dir", str(root), "--no_generator_binarization",
                "--normalize_std", "1", "--batch_size", "1", "--remat", "1",
                "--seed", str(seed), "--num_workers", "2", "--max_recon_dump", "2",
                "--max_dataset_size", str(images), "--fused_instance_norm", "1"]
        base += BASE_FLAGS + HIRES_FLAGS
        for prefix in ("", "val_"):
            base += [f"--{prefix}preprocess_mode", mode, f"--{prefix}load_size", str(load),
                     f"--{prefix}crop_size", str(crop)]
        da, db = tmp / "phaseA", tmp / "phaseB"
        runs = {
            # validations after the load and after the frozen epoch, with the dump
            "phase A from the warm start": (
                base + ["--save_dir", str(da), "--num_epochs", "2", "--val_interval", "2",
                        "--latest_interval", "1", "--niter_fix_global", "2", "--load_model",
                        "--checkpoints_dir", str(tmp / "warm")],
                images * (fwd + 72) + 3 * images * 36, images * (bwd + 36)),
            "phase B from phase A": (
                base + ["--save_dir", str(db), "--num_epochs", "1", "--val_interval", "5",
                        "--no_d_gan_loss", "--no_g_gan_loss", "--no_gan_feat_loss",
                        "--no_vgg_loss", "--schedule_lr", "1", "--lr_decay_patience", "3",
                        "--load_model", "--checkpoints_dir", str(da / "latest")],
                images * 36 + images * 72, images * 36),
        }
        for label, (argv, f, b) in runs.items():
            torch.cuda.empty_cache()
            result = {}

            def main_run(argv=argv):
                result["trainer"] = run.main(argv, device="cuda")

            _, text, counts = run_entry(
                label, "train.run.main", main_run,
                {"fused_instance_norm": f, "fused_instance_norm_bwd": b}, per=1, tag="[hires]",
                keep=keep)
            launches[f"hires chain: {label}"] = counts
            trainer = result.pop("trainer")
            sizes = len(trainer.gan.codec.state_dict()) + len(trainer.gan.disc.state_dict())
            if label.startswith("phase A"):
                want = f"restored params from {tmp / 'warm'}: {n_trunk}/{sizes} leaves matched"
                if want not in text or text.count("now also finetuning global generator") != 1:
                    raise AssertionError(f"phase A: want '{want}' and one unfreeze")
                warm = torch.load(tmp / "warm" / PARAMS_FILE, weights_only=True)
                first = torch.load(da / PARAMS_FILE, weights_only=True)
                second = torch.load(da / "latest" / PARAMS_FILE, weights_only=True)
                epochs = [json.loads((d / "trainer_meta.json").read_text())["epoch"]
                          for d in (da, da / "latest")]
                weights = [k for k in warm if k.endswith("weight")]
                held = all(torch.equal(first[k], warm[k]) for k in warm)
                moved = sum(not torch.equal(second[k], warm[k]) for k in weights)
                if epochs != [1, 2] or not held or moved != len(weights) or \
                        trainer.steps_taken != 2 * images:
                    raise AssertionError(f"phase A: epochs {epochs}, trunk held {held}, "
                                         f"{moved} of {len(weights)} trunk weights moved after")
                log(f"[hires] phase A restored {n_trunk} of {sizes} leaves from the warm start "
                    f"(every global-trunk leaf but the tail); all {len(warm)} trunk leaves "
                    f"bit-equal to it after the frozen epoch 1, all {moved} trunk weights "
                    f"changed after epoch 2 ({card})")
            else:
                if f"restored params from {da / 'latest'}: {sizes}/{sizes} leaves matched" \
                        not in text or trainer.steps_taken != 3 * images:
                    raise AssertionError(f"phase B's restore: want {sizes}/{sizes}, steps "
                                         f"{trainer.steps_taken}")
                log(f"[hires] phase B restored all {sizes} leaves from phase A's latest state and "
                    f"took {images} distortion-only steps ({card})")
            del trainer
    return launches


def phase10_grouped(seed: int, card: str) -> dict:
    """(f) A codec with a grouped netE (3 groups: nef 48 and a 96-bit code,
    the flagship's nearest widths that 3 divides) whose output is averaged
    over each instance, at 1024x512 on the standard path: the kernel
    configuration (K3 at its 45 sites) against the default, fp32, TF32 off,
    one decode. Returns the counts."""
    import copy

    from jpdse_tpu_torch.config import flagship_config
    from jpdse_tpu_torch.models.codec import SemanticCodec

    cfgs = []
    for kernels in (False, True):
        cfg = flagship_config(kernels=kernels)
        m = cfg.model
        m.netE_groups, m.nef, m.encoder_binarizer_out_channels = 3, 48, 96
        m.inst_wise_pool, m.fast_inference = True, False
        cfg.validate()
        cfgs.append(cfg)
    codec = SemanticCodec(cfgs[0], device="cuda", seed=seed, dtype=torch.float32)
    fused = SemanticCodec(copy.deepcopy(cfgs[1]), device="cuda", seed=None, dtype=torch.float32)
    fused.load_state_dict(codec.state_dict())
    batch = {k: torch.as_tensor(v, device="cuda") for k, v in make_batch(seed + 80).items()}
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.inference_mode():
            want = codec.decode(codec.prepare(batch))[0]
            reset_counts()
            got = fused.decode(fused.prepare(batch))[0]
            counts = read_counts()
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    check_image("grouped, instance-pooled netE codec, fp32 standard path with K3", got, want)
    if {k: v for k, v in counts.items() if v} != {"fused_instance_norm": 45}:
        raise AssertionError(f"grouped codec: launched {counts}")
    log(f"[hires] grouped netE (3 groups) with inst_wise_pool: "
        f"{sum(p.numel() for p in codec.parameters())} parameters; K3 45 a decode ({card})")
    del codec, fused
    torch.cuda.empty_cache()
    return {"grouped netE codec: kernel-config standard path": counts}


def phase10(seed: int, requests: int, steps: int, card: str, warm_src: Path) -> tuple:
    """The hires recipe at full width: (a) one step's parity, (b) frozen and
    unfrozen timed steps, (0) and (c) the warm start and the phase chain, (d)
    serving at 2048x1024, (e) eval and deploy, (f) the grouped netE. Returns
    (serving and eval counts, training counts)."""
    t0 = time.perf_counter()
    train = {f"hires train parity: {k}": v for k, v in
             phase_train_parity(seed, card, phase="hiresA").items()}
    train.update({f"hires train steps: {k}": v for k, v in
                  phase10_steps(seed, steps, card).items()})
    train.update(phase10_chain(seed, card, warm_src))
    serve = phase9_serve(seed, requests, card, hires_configs(), HIRES_SERVE_LAUNCHES,
                         (HIRES_H, HIRES_W), "[hires]", "hires")
    _, kcfg = hires_configs()
    serve.update(phase9_eval(seed, card, kcfg, HIRES_SERVE_LAUNCHES["kernel-config fast path"],
                             2, HIRES_PREPROCESS, "[hires]", "hires"))
    serve.update(phase10_grouped(seed, card))
    log(f"[hires] hires recipe phase {time.perf_counter() - t0:.1f} s")
    return serve, train


# -- phase 11: the fast train decode, dropout, the bf16 VGG, the device cache, the trace --
FAST_KERNELS = ("s2d_realign_pad3", "s2d_pad3", "head_conv_s2d")
FAST_METRIC_TOL = 1e-3  # of max(1, |metric|): JAX's own bound (tests/test_fast_train.py:86-109)
F64_TOL = 1e-9  # a gradient tensor's relative L2 difference between two float64 steps
# (read 3.4e-14 to 4.7e-14 in G, 7.4e-15 to 8.2e-15 in D on an H100)
DROPOUT_SHARE_TOL = 0.01  # kept share of a res block's mask around 1/2
PIXEL_BYTES = H * W  # a host-to-device copy this large carries pixels (one uint8 map)
K3_TRACE_NAMES = ("instance_norm_kernel", "instance_norm_bwd_kernel")


class SignRecorder:
    """While active, the stochastic sign is the deterministic one (as
    JAX's tests/test_fast_train.py runs both decodes), and each binarizer's
    pre-sign (its tanh) is kept, in call order: netE4label's, then netE's.
    Given ``ref``, another run's pre-signs in the same order, each call
    takes ref's code bits (its sign where this run's differs), with the
    sign's own straight-through gradient: two runs then differ by their
    arithmetic alone, not by a code bit that rounding moved across 0."""

    def __init__(self, ref=None):
        from jpdse_tpu_torch.ops import quantizers
        from jpdse_tpu_torch.parallel import spatial

        self.q, self.calls, self.ref, self.spatial = quantizers, [], ref, spatial

    def __enter__(self):
        self.saved = self.q.stochastic_sign_ste

        def sign(x, generator):
            k = len(self.calls)
            self.calls.append(self.spatial.like(x.detach(), x))  # its height kept
            y = self.q.deterministic_sign_ste(x)
            if self.ref is None:
                return y
            bits = torch.sign(self.ref[k])
            return y + (torch.where(torch.sign(x.detach()) == bits, y, bits) - y).detach()

        self.q.stochastic_sign_ste = sign
        return self

    def __exit__(self, *exc):
        self.q.stochastic_sign_ste = self.saved


class EvalSigns:
    """While active, the deterministic sign (every binarizer of an
    evaluation's standard path) keeps each call's pre-sign, in call order;
    given ``ref``, one process's pre-signs in that order, each call takes
    ref's code bits (this rank's rows of them under a spatial shard): two
    runs then decode the same codes, and differ by their arithmetic alone."""

    def __init__(self, ref=None):
        from jpdse_tpu_torch.ops import quantizers

        self.q, self.calls, self.ref = quantizers, [], ref

    def __enter__(self):
        from jpdse_tpu_torch.parallel import spatial

        self.saved = own = self.q.deterministic_sign_ste

        def sign(x):
            k = len(self.calls)
            self.calls.append(spatial.like(x.detach(), x))
            if self.ref is None:
                return own(x)
            bits = torch.sign(self.ref[k]).to(x.device, x.dtype)
            shard = spatial.current()
            return spatial.like(bits if shard is None else shard.rows(bits), x)

        self.q.deterministic_sign_ste = sign
        return self

    def __exit__(self, *exc):
        self.q.deterministic_sign_ste = self.saved


def float64_state(gan):
    """A float64 copy of a GAN training state's networks, the fast train
    decode rebuilt on the copy's codec: a step whose own rounding is ~1e-16
    (as tests/test_torch_port_train_step.py::port_step_f64 makes one)."""
    import copy

    from jpdse_tpu_torch.models.fast_train import make_fast_train_decode

    s = copy.copy(gan)
    s.codec = copy.deepcopy(gan.codec).double()
    s.codec.dtype = torch.float64
    s.disc = copy.deepcopy(gan.disc).double()
    s.vgg = None if gan.vgg is None else copy.deepcopy(gan.vgg).double()
    if gan.fast_decode is not None:
        s.fast_decode = make_fast_train_decode(gan.cfg, s.codec)
    return s


def phase11_parity(seed: int, card: str) -> dict:
    """(a) The phase-2 recipe passes fast_train_ineligible_reason; one
    loss_and_grads through the fast train decode against the standard
    decode, fp32 with TF32 off and both decodes' binarizers deterministic,
    from the same weights: the eight metrics within FAST_METRIC_TOL of
    max(1, |m|); every binarizer bit that differs lying within 1e-5 of 0;
    G's gradient tensors no farther from the standard decode's, in relative
    L2, than phase 7 (a)'s rule allows (GRAD_TOL or twice two controls' on
    inputs moved by 2^-22, at most GRAD_CEIL), D's printed beside them; the
    biases an InstanceNorm follows 0 to rounding on both; and K1, K2, K4
    (and K3) launched 0 times by the fast decode. As in phase 7, the
    controls measure rounding alone, so they flip no code bit: the fast
    decode and the controls take the standard decode's code bits
    (SignRecorder's ``ref``), a bit that differs lying within 1e-5 of 0
    (asserted; a code bit moved across 0 by rounding moves G's gradients
    by ~1e-1, seen at seeds 2 and 3). The three leaves farthest apart are
    printed with the controls' readings there. G's tail-bias leaf of netE
    (3 values, each a sum over a million positions that nearly cancels)
    reads rounding alone at 2.5e-3 to 2.8e-2 between runs of the same seed,
    cuDNN's atomics reordering it, the controls too: there fp32 cannot
    decide at the cap. So, as the CPU step tests do, float64 arbitrates:
    the same step of both decodes in float64 (float64_state; each on the
    standard float64 decode's code bits), whose gradients of every tensor
    of G and D must agree within F64_TOL in relative L2; a G tensor over
    the fp32 bound passes only so, and is named. Returns the counts."""
    from jpdse_tpu_torch.models.fast_train import fast_train_ineligible_reason
    from jpdse_tpu_torch.train import step
    from jpdse_tpu_torch.trainer import Trainer

    cfg_fast = flagship_train_config(False, seed)
    cfg_fast.optim.fast_train = True
    reason = fast_train_ineligible_reason(cfg_fast)
    if reason is not None:
        raise AssertionError(f"the phase-2 recipe is not fast-train eligible: {reason}")
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        base = Trainer(flagship_train_config(False, seed), mode="train", device="cuda")
        fast = Trainer(cfg_fast, mode="train", device="cuda")
        for a, b in ((base.gan.codec, fast.gan.codec), (base.gan.disc, fast.gan.disc),
                     (base.gan.vgg, fast.gan.vgg)):
            b.load_state_dict(a.state_dict())
        batch = train_batch(base.cfg, seed)
        out, presign, launches = {}, {}, {}

        def run(label, t, b):
            gen = torch.Generator(device="cuda").manual_seed(seed)
            placed = t.place(b)
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            with SignRecorder(presign.get("standard decode")) as rec:
                out[label] = step.loss_and_grads(t.gan, placed, gen)
                torch.cuda.synchronize()
            presign[label] = rec.calls
            launches[label] = counts = read_counts()
            log(f"[fast] parity, {label}: loss_and_grads {time.perf_counter() - t0:.2f} s (fp32, "
                f"TF32 off, deterministic binarizers); launches {counts}")

        run("standard decode", base, batch)
        run("fast train decode", fast, batch)
        if any(launches["fast train decode"].values()):
            raise AssertionError(f"the fast train decode launched {launches['fast train decode']}")
        controls = ("control 1", "control 2")
        for i, label in enumerate(controls, 1):
            signs = np.random.default_rng(seed + i).choice([-1.0, 1.0], batch["image"].shape)
            run(label, base, dict(batch, image=(batch["image"] * (1 + 2.0**-22 * signs))
                                  .astype(np.float32)))
        ref = presign["standard decode"]
        for label in ("fast train decode", *controls):
            if len(presign[label]) != len(ref):
                raise AssertionError(f"{label}: {len(presign[label])} binarizer calls, the "
                                     f"standard decode {len(ref)}")
        for i, name in enumerate(("netE4label", "netE")):
            x0 = ref[i]
            near = x0.abs() < 1e-5
            flips = {}
            for label in ("fast train decode", *controls):
                flipped = torch.sign(presign[label][i]) != torch.sign(x0)
                flips[label] = int(flipped.sum())
                if (flipped & ~near).any():
                    raise AssertionError(f"{name}, {label}: a code bit differs away from 0")
            log(f"[fast] parity: {name} code bits that differ from the standard decode's, of "
                f"{x0.numel()}: " + ", ".join(f"{k} {v}" for k, v in flips.items())
                + f"; all within 1e-5 of 0 ({int(near.sum())} pre-signs lie there), and each "
                "run took the standard decode's bits")
        out64, pre64 = {}, {}
        for label, t in (("standard decode", base), ("fast train decode", fast)):
            s64 = float64_state(t.gan)
            placed = t.place(batch)
            placed = dict(placed, image=placed["image"].double())
            gen = torch.Generator(device="cuda").manual_seed(seed)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with SignRecorder(pre64.get("standard decode")) as rec:
                m64, g64 = step.loss_and_grads(s64, placed, gen)
                torch.cuda.synchronize()
            out64[label], pre64[label] = g64, rec.calls
            log(f"[fast] parity, {label} in float64: loss_and_grads "
                f"{time.perf_counter() - t0:.2f} s, loss_G {m64['loss_G'].item():.9f}")
            del s64, placed
        (m0, g0), (m1, g1) = out["standard decode"], out["fast train decode"]
        worst = 0.0
        for k in step.METRICS:
            a, b = m0[k].item(), m1[k].item()
            rel = abs(b - a) / max(1.0, abs(a))
            worst = max(worst, rel)
            if not (np.isfinite(b) and rel <= FAST_METRIC_TOL):
                raise AssertionError(f"fast train: {k} {b} against {a}")
        log("[fast] parity: metrics, fast train vs standard decode: " + ", ".join(
            f"{k} {m1[k].item():.6f} / {m0[k].item():.6f}" for k in step.METRICS)
            + f"; largest difference {worst:.2e} of max(1, |m|) (tolerance {FAST_METRIC_TOL})")
        others = ("fast train decode", *controls)
        for j, (net, module) in enumerate((("G", base.gan.codec), ("D", base.gan.disc))):
            names = [n for n, _ in module.named_parameters()]
            top = max(g.abs().max().item() for g in g0[j])
            zero = 0.0
            rel = {label: {} for label in others}
            rel64 = {}
            for i, (n, a) in enumerate(zip(names, g0[j])):
                if NORMED_BIAS.search(n):
                    zero = max(zero, a.abs().max().item(), g1[j][i].abs().max().item())
                    continue
                for label in others:
                    rel[label][n] = ((out[label][1][j][i] - a).norm() / a.norm()).item()
                a64 = out64["standard decode"][j][i]
                rel64[n] = ((out64["fast train decode"][j][i] - a64).norm() / a64.norm()).item()
            l2 = {label: max((v, n) for n, v in r.items()) for label, r in rel.items()}
            noise = max(l2[c][0] for c in controls)
            bound = min(GRAD_CEIL[net], max(GRAD_TOL, 2 * noise))
            far = sorted(rel["fast train decode"], key=rel["fast train decode"].get)[-3:][::-1]
            over = sorted((n for n, v in rel["fast train decode"].items() if v > bound),
                          key=rel["fast train decode"].get, reverse=True)
            worst64 = max((v, n) for n, v in rel64.items())
            log(f"[fast] parity: {net} gradients, {len(names)} tensors; largest relative L2 "
                f"difference from the standard decode's: " + "; ".join(
                    f"{label} {l2[label][0]:.2e} at {l2[label][1]}" for label in others)
                + f". Bound: {bound:.2e}{' (asserted)' if net == 'G' else ''}, the fast train "
                f"decode's reading {l2['fast train decode'][0] / bound:.2f} of it. Its three "
                f"largest, with the controls' there: " + "; ".join(
                    f"{n} {rel['fast train decode'][n]:.2e} ("
                    + ", ".join(f"{rel[c][n]:.2e}" for c in controls) + ")" for n in far)
                + f". In float64, the fast train decode's largest relative L2 difference "
                f"{worst64[0]:.2e} at {worst64[1]} (tolerance {F64_TOL})"
                + (f"; over the fp32 bound, passed by float64: {', '.join(over)}" if over else "")
                + f". The biases an InstanceNorm follows at most {zero:.2e} (largest gradient "
                f"{top:.3e})")
            if not zero <= 1e-5 * top:
                raise AssertionError(f"fast train: {net}'s norm-fed biases {zero} (top {top})")
            if not worst64[0] <= F64_TOL:
                raise AssertionError(f"fast train: {net} gradients differ in float64: {worst64}, "
                                     f"in fp32 {l2}")
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    del base, fast
    torch.cuda.empty_cache()
    return {f"fast train parity: {k}": launches[k] for k in
            ("standard decode", "fast train decode")}


def phase11_steps(seed: int, steps: int, card: str) -> dict:
    """(b) ``steps`` Trainer.steps of the phase-2 recipe in the default
    configuration at PyTorch's default precision, in the order fast train
    off, on, on, off, then with the bf16 VGG: each configuration's median
    step after the first, images/s and peak memory; then one step on a
    batch already on the card, which copies nothing of pixel size to it
    (upload_counter: the fast decode's weight re-layouts read index
    tensors kept on the card), and one profiled step (device busy time and
    its split). Numbers, not a claim. Returns the counts."""
    from jpdse_tpu_torch.trainer import Trainer

    cfg = flagship_train_config(False, seed)
    batches = [train_batch(cfg, seed + 100 + i) for i in range(steps)]
    runs = (("fast train off", {}), ("fast train on", {"fast_train": True}),
            ("fast train on, again", {"fast_train": True}), ("fast train off, again", {}),
            ("vgg_bf16", {"vgg_bf16": True}))
    medians, launches = {}, {}
    for label, opts in runs:
        torch.cuda.empty_cache()
        cfg = flagship_train_config(False, seed)
        for k, v in opts.items():
            setattr(cfg.optim, k, v)
        trainer = Trainer(cfg, mode="train", device="cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        times = []
        for b in batches:
            t0 = time.perf_counter()
            metrics = trainer.step(b)
            times.append((time.perf_counter() - t0) * 1e3)
            if not all(np.isfinite(v) for v in metrics.values()):
                raise AssertionError(f"{label}: losses {metrics}")
        launches[f"fast train steps: {label}"] = counts = read_counts()
        if any(counts.values()):
            raise AssertionError(f"{label}: the default configuration launched {counts}")
        peak = torch.cuda.max_memory_allocated() / 2**30
        medians[label] = med = float(np.median(times[1:] if steps > 1 else times))
        placed = trainer.place(batches[-1])
        torch.cuda.synchronize()
        with upload_counter() as uploads:
            trainer.step(placed)
        big = [n for n in uploads.sizes if n >= PIXEL_BYTES]
        if big:
            raise AssertionError(f"{label}: a step on a placed batch copied {big} bytes to the "
                                 "card")
        log(f"[fast] phase-2 recipe, default configuration, {label}: steps (ms) "
            f"{', '.join(f'{t:.1f}' for t in times)}; median after the first {med:.1f} ms, "
            f"{TRAIN_BATCH / med * 1e3:.3f} images/s; peak memory {peak:.2f} GiB; losses of "
            f"the last step G_VGG {metrics['G_VGG']:.4f}, loss_G {metrics['loss_G']:.4f}; "
            f"a step on a placed batch: {len(uploads.sizes)} host-to-device copies of "
            f"{sum(uploads.sizes)} bytes, none of >= {PIXEL_BYTES} ({card})")
        profile_step(f"phase-2 recipe, {label}", trainer, batches[-1], card)
        del trainer
    off = (medians["fast train off"] + medians["fast train off, again"]) / 2
    on = (medians["fast train on"] + medians["fast train on, again"]) / 2
    log(f"[fast] phase-2 recipe: fast train step / standard step {on / off:.3f} (medians "
        f"{on:.1f} / {off:.1f} ms, off-on-on-off); vgg_bf16 step / standard step "
        f"{medians['vgg_bf16'] / off:.3f} ({card})")
    return launches


def phase11_dropout(seed: int, card: str) -> dict:
    """(c) One step of the phase-2 recipe with model.use_dropout in the
    default and the kernel configuration: each res block's mask keeps
    1/2 within DROPOUT_SHARE_TOL (9 masks, drawn once a step under block
    remat), K3 90 forward and 45 backward a step in the kernel
    configuration (phase 7's), none by default; then the eval decode of the
    same weights bit-equal to a codec's without dropout. Returns the
    counts."""
    from jpdse_tpu_torch.models import layers
    from jpdse_tpu_torch.models.codec import SemanticCodec
    from jpdse_tpu_torch.trainer import Trainer

    launches = {}
    batch = train_batch(flagship_train_config(False, seed), seed + 7)
    draw = layers.dropout_mask
    for label, kernels in (("default", False), ("kernel config", True)):
        torch.cuda.empty_cache()
        cfg = flagship_train_config(kernels, seed)
        cfg.model.use_dropout = True
        trainer = Trainer(cfg, mode="train", device="cuda")
        shares = []

        def recorded(shape, generator, device, hg=None):
            mask = draw(shape, generator, device, hg)
            shares.append(mask.float().mean().item())
            return mask

        layers.dropout_mask = recorded
        try:
            reset_counts()
            metrics = trainer.step(batch)
            launches[f"dropout step: {label}"] = counts = read_counts()
        finally:
            layers.dropout_mask = draw
        sites = K3_SITES[2]
        want = (2 * sites, sites) if kernels else (0, 0)
        if k3_per_step(counts, 1) != want:
            raise AssertionError(f"dropout, {label}: K3 {k3_per_step(counts, 1)}, want {want}")
        n_blocks = cfg.model.n_blocks_global
        if len(shares) != n_blocks or max(abs(s - 0.5) for s in shares) > DROPOUT_SHARE_TOL:
            raise AssertionError(f"dropout, {label}: kept shares {shares}")
        if not all(np.isfinite(v) for v in metrics.values()):
            raise AssertionError(f"dropout, {label}: losses {metrics}")
        plain_cfg = flagship_train_config(kernels, seed)
        plain = SemanticCodec(plain_cfg, device="cuda", seed=None)
        plain.load_state_dict(trainer.gan.codec.state_dict())
        codec = trainer.gan.codec
        deterministic = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            with torch.inference_mode():
                placed = trainer.place(batch)
                got = codec.decode(codec.prepare(placed))[0]
                want_img = plain.decode(plain.prepare(placed))[0]
        finally:
            torch.backends.cudnn.deterministic = deterministic
        if not torch.equal(got, want_img):
            raise AssertionError(f"dropout, {label}: the eval decode differs from the codec's "
                                 "without dropout")
        log(f"[dropout] phase-2 recipe, {label}: one step with use_dropout; kept shares of the "
            f"{n_blocks} res blocks' masks {', '.join(f'{s:.4f}' for s in shares)} (1/2 within "
            f"{DROPOUT_SHARE_TOL}); K3 a step {k3_per_step(counts, 1)}; the eval decode "
            f"bit-equal to the same weights' without dropout ({card})")
        del trainer, plain, codec
    return launches


def trace_facts(trace_dir: Path) -> dict:
    """The one Chrome trace under ``trace_dir``: its host-to-device memcpy
    records (all, and those of PIXEL_BYTES or more with their bytes),
    whether it names K3's forward and backward kernels, and how many
    optimizer steps it holds."""
    files = sorted(trace_dir.glob("*.pt.trace.json"))
    if len(files) != 1:
        raise AssertionError(f"{trace_dir}: {len(files)} traces, want 1 (the first epoch's)")
    events = json.loads(files[0].read_text())["traceEvents"]
    sized = [int(e.get("args", {}).get("bytes", 0)) for e in events
             if "HtoD" in e.get("name", "")]
    pixel = [n for n in sized if n >= PIXEL_BYTES]
    names = {e.get("name", "") for e in events}
    return {"copies": len(sized), "pixel_copies": len(pixel), "pixel_bytes": sum(pixel),
            "k3": all(any(k in n for n in names) for k in K3_TRACE_NAMES),
            # the host's ranges: the card's copy of each (gpu_user_annotation) left out
            "optimizer_steps": sum(e.get("name", "").startswith("Optimizer.step#")
                                   for e in events if e.get("ph") == "X"
                                   and not e.get("cat", "").startswith("gpu_")),
            "mb": files[0].stat().st_size / 2**20}


def upload_counter():
    """A dispatch mode that, while active, keeps the bytes of every copy
    PyTorch makes from host memory to the card (``aten._to_copy`` and
    ``aten.copy_`` with a CPU source and a CUDA destination): what the
    profiler's memcpy records show, without relying on them (a trace taken
    late in this script's process held no memcpy record at all)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    aten = torch.ops.aten

    class UploadCounter(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.sizes = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func is aten._to_copy.default:
                src, dst = args[0], out
            elif func is aten.copy_.default:
                dst, src = args[0], args[1]
            else:
                return out
            if isinstance(src, torch.Tensor) and src.device.type == "cpu" and \
                    dst.device.type == "cuda":
                self.sizes.append(src.numel() * src.element_size())
            return out

    return UploadCounter()


def profiled_steps(cfg, cache, meta, host, tmp: Path, card: str) -> None:
    """One Trainer of ``cfg`` takes a step (the warm-up: cuDNN's choices,
    the pooling tables), then one step under ``utils.profiling.trace`` on a
    batch the device cache assembles and one on a host batch, each placed
    inside the trace: the cached step copies nothing of pixel size to the
    card, the host one its image and maps (counted by upload_counter; the
    trace's own memcpy records printed beside)."""
    from jpdse_tpu_torch.trainer import Trainer
    from jpdse_tpu_torch.utils.profiling import trace

    trainer = Trainer(cfg, mode="train", device="cuda")
    meta.set_epoch(2)
    host.set_epoch(2)
    metas, hosts = list(meta), list(host)
    trainer.step(trainer.place(cache.place(metas[0])))
    parts = []
    for label, batch in (("cached", lambda: trainer.place(cache.place(metas[1]))),
                         ("host", lambda: trainer.place(hosts[1]))):
        out = tmp / f"step_{label}"
        with trace(str(out)), upload_counter() as uploads:
            trainer.step(batch())
        f = trace_facts(out)
        pixel = [n for n in uploads.sizes if n >= PIXEL_BYTES]
        if f["optimizer_steps"] != 2 or (not pixel) != (label == "cached"):
            raise AssertionError(f"profiled {label} step: uploads {uploads.sizes}, trace {f}")
        parts.append(f"{label} batch: {len(uploads.sizes)} host-to-device copies by PyTorch, "
                     f"{len(pixel)} of >= {PIXEL_BYTES} bytes ({sum(pixel) / 2**20:.1f} MiB); "
                     f"the trace's memcpy records {f['copies']}, {f['pixel_copies']} of them "
                     f"that large")
    log(f"[cache] phase-2 recipe, one profiled step after a warm-up: " + "; ".join(parts)
        + f" ({card})")
    del trainer


def phase11_cache(seed: int, card: str) -> dict:
    """(d) and (e). On a synthetic Cityscapes train/val split (EVAL_IMAGES
    triplets at 2048x1024 read 'fixed' to 1024x512, cache_images): the
    device cache's batches of one epoch against the host batches on the
    card, bit for bit, for the phase-2 recipe and base-codec phase A (both
    flip variants of its jpg round trip cached), placed through
    prefetch_to_device; without the cache, prefetch_to_device's batches
    against the host batches; one profiled step on a cached batch without
    a host-to-device copy of pixel size, and one on a host batch with them
    (profiled_steps). Then train.run.main of the phase-2 recipe with the
    cache on and off in the default and the kernel configuration, each
    under --profile_dir: the "resident" line, each epoch's loader wait and
    step times, one trace of the first epoch only (the cached kernel
    configuration trains two epochs), K3's kernels named in the kernel
    configuration's; and phase A for one epoch with the cache. Counts are set to 0 before each
    main and asserted after it. Returns them."""
    from jpdse_tpu_torch.cli import parse_config
    from jpdse_tpu_torch.data import create_dataloader
    from jpdse_tpu_torch.data.device_cache import maybe_device_cache
    from jpdse_tpu_torch.data.prefetch import prefetch_to_device
    from jpdse_tpu_torch.train import run

    launches = {}
    steps = EVAL_IMAGES // TRAIN_BATCH
    sites = K3_SITES[2]
    with tempfile.TemporaryDirectory(prefix="jpdse_cache_") as tmp:
        tmp = Path(tmp)
        root = tmp / "cityscapes"
        for split in ("train", "val"):
            write_cityscapes(root, seed + 60 + (split == "train"), split)
        mode, load, crop, _ = FLAGSHIP_PREPROCESS
        base = ["--dataset", "cityscapes", "--root_dir", str(root), "--no_generator_binarization",
                "--normalize_std", "1", "--batch_size", str(TRAIN_BATCH), "--remat", "1",
                "--seed", str(seed), "--num_workers", "2", "--cache_images", "1",
                "--val_interval", "5"]
        for prefix in ("", "val_"):
            base += [f"--{prefix}preprocess_mode", mode, f"--{prefix}load_size", str(load),
                     f"--{prefix}crop_size", str(crop)]
        for recipe, extra in (("phase-2 recipe", []), ("base-codec phase A", BASE_FLAGS)):
            cfg = parse_config(base + extra, is_train=True)
            with contextlib.redirect_stdout(io.StringIO()):
                host, meta, twin = (create_dataloader(cfg) for _ in range(3))
                t0 = time.perf_counter()
                cache = maybe_device_cache(meta, cfg, "cuda")
            if cache is None:
                raise AssertionError(f"{recipe}: the device cache declined")
            built = time.perf_counter() - t0
            meta.meta_only = True
            keys = ["image", "label", "instance"] + (["compressed"] if extra else [])
            n = 0
            for hb, placed in zip(host, prefetch_to_device(meta, 2, "cuda", cache.place)):
                for k in keys:
                    if not (placed[k].is_cuda and torch.equal(placed[k].cpu(),
                                                              torch.from_numpy(hb[k]))):
                        raise AssertionError(f"{recipe}: cached {k} differs from the host batch")
                n += 1
            if extra and cache.ds["compressed"].shape[0] != 2 * EVAL_IMAGES:
                raise AssertionError(f"{recipe}: {cache.ds['compressed'].shape[0]} compressed "
                                     "variants cached")
            host.set_epoch(1)
            twin.set_epoch(1)
            for hb, placed in zip(host, prefetch_to_device(twin, 2, "cuda")):
                for k in keys:
                    if not torch.equal(placed[k].cpu(), torch.from_numpy(hb[k])):
                        raise AssertionError(f"{recipe}: prefetched {k} differs from the host's")
            log(f"[cache] {recipe}: {EVAL_IMAGES} samples resident ({cache.nbytes / 2**20:.1f} MiB, "
                f"{', '.join(f'{k} {v.dtype}'.replace('torch.', '') for k, v in cache.ds.items())}"
                f"), built in {built:.2f} s; {n} cached batches of an epoch bit-equal to the host "
                f"batches on the card, and {n} prefetched host batches too ({card})")
            if not extra:
                profiled_steps(cfg, cache, meta, host, tmp, card)
            del cache, host, meta, twin
        runs = {
            "kernel config, device cache on": (KERNEL_FLAGS, True, 2),
            "kernel config, device cache off": (KERNEL_FLAGS, False, 1),
            "default, device cache on": ([], True, 1),
            "default, device cache off": ([], False, 1),
            "base-codec phase A, device cache on": (BASE_FLAGS, True, 1),
        }
        keep = ("device_cache", "val device_cache", "epoch ")
        for label, (flags, cached, epochs) in runs.items():
            torch.cuda.empty_cache()
            trace_dir = tmp / f"trace{len(launches)}"
            argv = base + flags + ["--save_dir", str(tmp / f"run{len(launches)}"),
                                   "--num_epochs", str(epochs), "--device_cache", str(int(cached))]
            profiled = not label.startswith("base")
            if profiled:
                argv += ["--profile_dir", str(trace_dir)]
            k3 = "fused_instance_norm" in " ".join(flags)
            n_sites = K3_SITES["A"] if label.startswith("base") else sites
            want = {"fused_instance_norm": epochs * steps * 2 * n_sites,
                    "fused_instance_norm_bwd": epochs * steps * n_sites} if k3 else {}
            trainer, text, counts = run_entry(label, "train.run.main",
                                              lambda: run.main(argv, device="cuda"), want, per=1,
                                              tag="[cache]", keep=keep)
            launches[f"device cache: {label}"] = counts
            if ("resident on device" in text) != cached or trainer.steps_taken != epochs * steps:
                raise AssertionError(f"{label}: resident line {'resident on device' in text}, "
                                     f"steps {trainer.steps_taken}")
            waits = [tuple(float(x) for x in m) for m in re.findall(
                r"loader wait ([\d.]+) s of ([\d.]+) s", text)]
            step_s = [float(x) for x in re.findall(r"batch processing time \(s\) ([\d.]+)", text)]
            if len(waits) != epochs or len(step_s) != epochs * steps:
                raise AssertionError(f"{label}: loader waits {waits}, batch times {step_s}")
            facts = ""
            if profiled:
                f = trace_facts(trace_dir)
                if f["optimizer_steps"] != 2 * steps:
                    raise AssertionError(f"{label}: the trace holds {f['optimizer_steps']} "
                                         f"optimizer steps, want {2 * steps} (the first epoch)")
                if k3 and not f["k3"]:
                    raise AssertionError(f"{label}: the trace names no K3 kernel")
                facts = (f"; trace of the first epoch {f['mb']:.1f} MB: {f['copies']} "
                         f"host-to-device memcpy records, {f['pixel_copies']} of >= "
                         f"{PIXEL_BYTES} bytes ({f['pixel_bytes'] / 2**20:.1f} MiB)"
                         + ("; names K3's forward and backward kernels" if k3 else ""))
            log(f"[cache] {label}: loader wait " + ", ".join(
                f"{w:.4f} s of {t:.4f} s" for w, t in waits) + "; batch times (s) "
                + ", ".join(f"{s:.4f}" for s in step_s) + facts + f" ({card})")
            del trainer
    return launches


def phase11(seed: int, steps: int, card: str) -> dict:
    """The fast train decode, dropout, the bf16 VGG, the device cache and
    the trace: (a) parity, (b) steps, (c) dropout, (d) + (e) the device
    cache, the prefetch and the trace. Returns the training counts."""
    t0 = time.perf_counter()
    launches = phase11_parity(seed, card)
    launches.update(phase11_steps(seed, steps, card))
    launches.update(phase11_dropout(seed, card))
    launches.update(phase11_cache(seed, card))
    log(f"[fast] fast train, dropout, bf16 VGG and device cache phase "
        f"{time.perf_counter() - t0:.1f} s")
    return launches


# -- phase 12: data-parallel training and the reference-checkpoint import ------------
class PinnedSigns(SignRecorder):
    """SignRecorder that also draws each binarizer's uniforms as the
    stochastic sign does (for the global batch under a mesh, this rank's
    rows) and keeps them: the draws are checked, the code bits are ``ref``'s
    (so a control or another path differs from ``ref`` by its arithmetic
    alone, not by a bit that rounding moved across 0)."""

    def __enter__(self):
        from jpdse_tpu_torch.parallel import spatial
        from jpdse_tpu_torch.parallel.mesh import draw_rows

        super().__enter__()
        pinned, self.draws = self.q.stochastic_sign_ste, []

        def sign(x, generator):
            self.draws.append(draw_rows(x.shape, lambda shape: torch.rand(
                shape, dtype=x.dtype, device=x.device, generator=generator),
                spatial.global_h(x)))
            return pinned(x, generator)

        self.q.stochastic_sign_ste = sign
        return self


def pinned_bits(tag: str, ref: list, runs: dict) -> None:
    """Each run's code bits against ``ref``'s (pre-signs, in call order):
    where a sign differs, ``ref``'s pre-sign lies within 1e-5 of 0 (the runs
    took ``ref``'s bits there, PinnedSigns)."""
    for i, name in enumerate(("netE4label", "netE")[:len(ref)]):
        flips = {}
        for label, pre in runs.items():
            flipped = torch.sign(pre[i]) != torch.sign(ref[i])
            flips[label] = int(flipped.sum())
            if (flipped & (ref[i].abs() >= 1e-5)).any():
                raise AssertionError(f"{tag}, {name}, {label}: a code bit differs away from 0")
        log(f"[parity] {tag}: {name} pre-signs whose sign differs from the reference run's, "
            f"of {ref[i].numel()}: " + ", ".join(f"{k} {v}" for k, v in flips.items())
            + " (each within 1e-5 of 0; every run takes the reference's bits)")


REF_TOL = FP32_ATOL  # the imported codec against the reference stack, fp32, TF32 off
DP_TIMED_STEPS = 2


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


@contextlib.contextmanager
def tf32_off():
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def sync(device) -> None:
    """Wait for ``device`` where it is a card (a CPU rehearsal has nothing
    to wait for)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def counted_step(gan, batch: dict, gen) -> tuple:
    """One loss_and_grads with every kernel's count set to 0 just before it
    and read just after: (metrics, grads), counts."""
    from jpdse_tpu_torch.train import step

    reset_counts()
    out = step.loss_and_grads(gan, batch, gen)
    sync(next(gan.codec.parameters()).device)
    return out, read_counts()


def timed_steps(label: str, trainer, batch: dict, card: str) -> None:
    """DP_TIMED_STEPS Trainer.steps after one untimed: the host clock per
    step (ending in a synchronize) and the CUDA events' time, medians."""
    placed = trainer.place(batch)
    trainer.step(placed)
    host, dev = [], []
    for _ in range(DP_TIMED_STEPS):
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        trainer.step(placed)
        end.record()
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
        dev.append(start.elapsed_time(end))
    log(f"[dp] {label}: step median {np.median(host):.1f} ms host clock, {np.median(dev):.1f} ms "
        f"CUDA events ({DP_TIMED_STEPS} steps after one, TF32 convolutions, batch "
        f"{batch['image'].shape[0]}; {card})")


def f64_step(t, batch: dict, seed: int, ref=None):
    """One loss_and_grads of trainer ``t``'s state in float64 (its mesh
    kept), on ``ref``'s code bits: (G's and D's gradients, the pre-signs).
    K3 has no float64 form, so its sites run the plain InstanceNorm."""
    from jpdse_tpu_torch.train import step

    s64 = float64_state(t.gan)
    for module in s64.codec.modules():
        if getattr(module, "fused", False):
            module.fused = False
    placed = t.place(batch)
    placed = dict(placed, image=placed["image"].double())
    gen = torch.Generator(device=t.device).manual_seed(seed)
    with PinnedSigns(ref) as rec:
        _, g64 = step.loss_and_grads(s64, placed, gen)
    sync(t.device)
    return g64, rec.calls


def f64_steps(runs: dict, seed: int) -> dict:
    """The float64 gradients of each (trainer, batch) in ``runs``, every run
    on the first one's code bits."""
    out, ref = {}, None
    for label, (t, batch) in runs.items():
        t0 = time.perf_counter()
        out[label], calls = f64_step(t, batch, seed, ref)
        ref = ref if ref is not None else calls
        log(f"[dp] {label} in float64: loss_and_grads {time.perf_counter() - t0:.2f} s")
    return out


def phase12_world1(seed: int, card: str) -> dict:
    """(a) The phase-2 recipe in the kernel configuration through the
    data-parallel path, a process group of one rank on NCCL, against the
    single-process path: two steps, each from the single-process path's
    parameters and Adams, each loss_and_grads held by phase 7 (a)'s rule
    (fp32, TF32 off, two perturbed-input controls of the single-process
    path; every run on the single-process run's code bits, PinnedSigns; a
    tensor over the fp32 bound decided by the same step of both paths in
    float64, every tensor within F64_TOL), K3 forward and backward at all 45 sites and the
    same launches in both, the all-reduced metrics and gradients bit-equal
    to their input; then both paths timed. Returns the launch counts."""
    import torch.distributed as dist

    from jpdse_tpu_torch.parallel import distributed
    from jpdse_tpu_torch.train import step
    from jpdse_tpu_torch.trainer import Trainer

    t0 = time.perf_counter()
    single = Trainer(flagship_train_config(True, seed), mode="train", device="cuda")
    assert single.mesh is None
    distributed.initialize("cuda", f"localhost:{free_port()}", 1, 0)
    launches = {}
    try:
        dp = Trainer(flagship_train_config(True, seed), mode="train", device="cuda")
        if dp.mesh is None or dp.mesh.world != 1 or dist.get_backend() != "nccl":
            raise AssertionError(f"the data-parallel trainer has no NCCL mesh: {dp.mesh}")
        batch = train_batch(single.cfg, seed)
        controls = perturbed(batch, seed)
        log(f"[dp] (a) world 1 on NCCL, phase-2 recipe, kernel configuration, batch 2 at "
            f"1024x512: trainers built in {time.perf_counter() - t0:.1f} s")
        for k in range(2):
            tag = f"phase-2 recipe, world 1, step {k + 1}"
            # both paths take their gradients at the same point: an Adam step moves a
            # parameter whose gradient is rounding noise by up to lr, either way
            for a, b in ((single.gan.codec, dp.gan.codec), (single.gan.disc, dp.gan.disc),
                         (single.gan.opt_g, dp.gan.opt_g), (single.gan.opt_d, dp.gan.opt_d)):
                b.load_state_dict(a.state_dict())
            dp.gan.steps_taken = single.gan.steps_taken
            dp.gan.lambda_distortion_weight = single.gan.lambda_distortion_weight
            out, pre = {}, {}
            with tf32_off():
                ref = None
                for label, t, b in (("single process", single, batch), ("world 1", dp, batch),
                                    ("control 1", single, controls[0]),
                                    ("control 2", single, controls[1])):
                    gen = torch.Generator(device="cuda").manual_seed(seed + k)
                    with PinnedSigns(ref) as rec:
                        out[label], counts = counted_step(t.gan, t.place(b), gen)
                    pre[label] = rec.calls
                    ref = pre["single process"]
                    if label in ("single process", "world 1"):
                        launches[f"dp world 1 step {k + 1}: {label}"] = counts
                        if k3_per_step(counts, 1) != (2 * K3_SITES[2], K3_SITES[2]):
                            raise AssertionError(f"{tag}, {label}: K3 launched "
                                                 f"{k3_per_step(counts, 1)}")
            pinned_bits(tag, ref, {k_: v for k_, v in pre.items() if k_ != "single process"})
            out64 = f64_steps({"single process": (single, batch), "world 1": (dp, batch)},
                              seed + k)
            hold_step(tag, out, None, (single.gan.codec, single.gan.disc), seed + k,
                      "single process", "world 1", out64)
            m, g = out["single process"]
            m2 = {key: v.clone() for key, v in m.items()}
            g2 = ([x.clone() for x in g[0]], [x.clone() for x in g[1]])
            step.reduce_over_ranks(m2, g2)
            torch.cuda.synchronize()
            same = all(torch.equal(m[key], m2[key]) for key in m) and all(
                torch.equal(a, b) for i in (0, 1) for a, b in zip(g[i], g2[i]))
            if not same:
                raise AssertionError(f"{tag}: the world-1 all-reduce changed its input")
            n_bytes = sum(x.numel() * x.element_size() for x in g[0] + g[1])
            log(f"[dp] {tag}: K3 {k3_per_step(launches[f'dp world 1 step {k + 1}: world 1'], 1)} "
                f"on both paths; the NCCL all-reduce of {n_bytes / 2**20:.1f} MiB of gradients "
                f"and the 8 metrics bit-equal to its input")
            step.apply(single.gan, out["single process"][1])
            step.apply(dp.gan, out["world 1"][1])
        tb = train_batch(single.cfg, seed + 7)
        for label, t in (("single process", single), ("world 1 (NCCL)", dp),
                         ("world 1 (NCCL)", dp), ("single process", single)):
            timed_steps(f"(a) {label}", t, tb, card)
    finally:
        dist.destroy_process_group()
    del single, dp
    torch.cuda.empty_cache()
    return launches


def _phase12_rank(rank: int, port: int, seed: int, work: str) -> None:
    """(b) One of two ranks on the one card (gloo, which all-reduces CUDA
    tensors there; NCCL refuses two ranks on one device), batch 1 each,
    its row of the global batch of 2: :func:`hold_layout` at data 2 (the
    twin on the global batch, phase 7 (a)'s rule with two controls and the
    float64 arbiter, the uniforms gathered bit for bit); rank 0 keeps its
    launch counts."""
    os.environ["LOCAL_RANK"] = "0"
    import torch.distributed as dist

    from jpdse_tpu_torch.ops.build import build_all
    from jpdse_tpu_torch.parallel import distributed

    build_all()  # loads the kernels the parent built
    distributed.initialize("cuda", f"localhost:{port}", 2, rank, backend="gloo")
    if dist.get_backend() != "gloo":
        raise AssertionError(f"rank {rank}: a {dist.get_backend()} group, want gloo")
    counts = hold_layout(rank, 1, seed, torch.device("cuda", 0), tag="[dp] (b)")["counts"]
    if rank == 0:
        with open(os.path.join(work, "counts.json"), "w") as f:
            json.dump(counts, f)
    distributed.barrier()
    dist.destroy_process_group()


def phase12_two_ranks(seed: int, card: str) -> dict:
    """(b) Two ranks of one process each on the card (gloo), spawned; the
    parent waits and reads rank 0's launch counts."""
    t0 = time.perf_counter()
    ctx = torch.multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="jpdse_dp_") as work:
        port = free_port()
        procs = [ctx.Process(target=_phase12_rank, args=(r, port, seed, work)) for r in range(2)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(timeout=600)
        codes = [p.exitcode for p in procs]
        for p in procs:
            if p.is_alive():
                p.kill()
        if codes != [0, 0]:
            raise AssertionError(f"(b) the two ranks exited with {codes}")
        with open(os.path.join(work, "counts.json")) as f:
            counts = json.load(f)
    log(f"[dp] (b) two gloo ranks on one card held against the single-process step on the "
        f"global batch; {time.perf_counter() - t0:.1f} s with the spawn ({card})")
    return {"dp 2 ranks, rank 0": counts}


def phase12_reference(seed: int, card: str) -> dict:
    """(c) The reference-architecture stack (convert/torch_ref.py,
    RefLearnedCodec) at the flagship's widths, weights from
    reference_weights_init with seed 0, written as net_*.pth and imported by
    Trainer.load; one request served through .jpds bytes on the default
    standard path and on the kernel configuration's (K3), fp32 with TF32
    off: the codes equal the reference's (a bit may differ only within 1e-5
    of its threshold), the decompressed image within REF_TOL of the
    reference's decode of the same codes, and, where no bit differs, of its
    own forward. Returns the launch counts per path."""
    from jpdse_tpu_torch.config import flagship_config
    from jpdse_tpu_torch.convert import torch_ref
    from jpdse_tpu_torch.trainer import Trainer

    t0 = time.perf_counter()
    golden = torch_ref.RefLearnedCodec(seed=0).cuda()
    n_down = 4
    cut = 4 + 3 * n_down  # each encoder's Binarizer in its Sequential
    batch = make_batch(seed + 12)
    batch["instance"] = np.random.default_rng(seed + 13).integers(0, 6, batch["instance"].shape
                                                                  ).astype(np.int32)
    oh = torch_ref.phase2_generator_input(batch["label"][0], batch["instance"][0],
                                          np.zeros_like(batch["image"][0]))[..., :36]
    x_lab = torch.from_numpy(oh.transpose(2, 0, 1)[None].copy()).cuda()
    x_img = torch.from_numpy(batch["image"][0].transpose(2, 0, 1)[None].copy()).cuda()
    launches = {}
    with tempfile.TemporaryDirectory(prefix="jpdse_ref_") as ckpt, tf32_off(), torch.no_grad():
        for name in ("netG", "netE", "netE4label"):
            torch.save(getattr(golden, name).state_dict(),
                       os.path.join(ckpt, name.replace("net", "net_") + ".pth"))
        e4, e = golden.netE4label.model, golden.netE.model
        ref_pre = [torch.tanh(e4[cut].conv(e4[:cut](x_lab))),  # tanh of the binarizers' input
                   torch.tanh(e[cut].conv(e[:cut](x_img)))]
        ref_codes = [torch.sign(p) for p in ref_pre]
        whole = golden(x_lab, x_img).permute(0, 2, 3, 1)[0]
        log(f"[ref] (c) RefLearnedCodec at flagship widths ({sum(p.numel() for p in golden.parameters())} "
            f"parameters, reference_weights_init seed 0) written as net_*.pth in "
            f"{time.perf_counter() - t0:.1f} s")
        for label, kernels in (("default standard", False), ("kernel config standard", True)):
            cfg = flagship_config(kernels=kernels)
            cfg.model.compute_dtype, cfg.model.fast_inference = "float32", False
            cfg.checkpoints_dir = ckpt
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                trainer = Trainer(cfg, mode="test", device="cuda")
                trainer.load()
            if "imported the reference checkpoint" not in buf.getvalue():
                raise AssertionError(f"(c) {label}: the reference checkpoint was not imported")
            reset_counts()
            t1 = time.perf_counter()
            stream = trainer.compress(batch)[0]
            image = trainer.decompress(stream)
            torch.cuda.synchronize()
            dt_ms = (time.perf_counter() - t1) * 1e3
            launches[f"reference import: {label}"] = read_counts()
            codes = trainer._server.compress_codes(batch)
            flips = []
            for c, r, p in zip(codes, ref_codes, ref_pre):
                diff = c[0].permute(2, 0, 1).float() * 2 - 1 != r[0]
                flips.append(int(diff.sum()))
                if (diff & (p[0].abs() >= 1e-5)).any():
                    raise AssertionError(f"(c) {label}: a code bit differs from the reference's "
                                         "away from its threshold")
            # the reference's decode of the port's codes
            lab = golden.netE4label.model[cut + 1:](codes[0].permute(0, 3, 1, 2).float() * 2 - 1)
            feat = golden.netE.model[cut + 1:](codes[1].permute(0, 3, 1, 2).float() * 2 - 1)
            want = golden.netG(torch.cat([lab, feat], 1)).permute(0, 2, 3, 1)[0].cpu().numpy()
            err = float(np.abs(image - want).max())
            err_whole = (f"{float((torch.from_numpy(image).cuda() - whole).abs().max()):.2e}"
                         if not any(flips) else "not compared (a bit differs)")
            log(f"[ref] (c) {label}: one request through .jpds bytes, {len(stream)} bytes, "
                f"{dt_ms:.1f} ms host clock; code bits that differ from the reference's, of "
                f"{[c.numel() for c in codes]}: {flips}; image against the reference's decode "
                f"of the same codes {err:.2e}, against its own forward {err_whole} (tolerance "
                f"{REF_TOL}, fp32, TF32 off); launches {launches[f'reference import: {label}']} "
                f"({card})")
            if not err <= REF_TOL or (not any(flips) and not float(err_whole) <= REF_TOL):
                raise AssertionError(f"(c) {label}: the imported codec misses the reference")
            del trainer
    del golden
    torch.cuda.empty_cache()
    return launches


def phase12(seed: int, card: str) -> tuple:
    """Phase 12: (a) world 1 on NCCL, (b) two gloo ranks on the card, (c)
    the reference-checkpoint import. Returns (serve counts, train counts)."""
    t0 = time.perf_counter()
    train = phase12_world1(seed, card)
    train.update(phase12_two_ranks(seed, card))
    serve = phase12_reference(seed, card)
    log(f"[dp] data-parallel and reference-import phase {time.perf_counter() - t0:.1f} s")
    return serve, train


# -- phase 13: the spatial axis ------------------------------------------------------
SPATIAL_K3 = {"instance_norm_stats": 90, "instance_norm_apply": 90,
              "instance_norm_bwd_sums": 45, "instance_norm_bwd_dx": 45}  # a rank, a step
SPATIAL_EVAL_IMAGES = 1
SPATIAL_EVAL_K3 = {"instance_norm_stats": 65, "instance_norm_apply": 65}  # a rank, an image


class K3PartialCheck:
    """While active, every launch of K3's partial form is also run through
    its plain version on the same inputs: the count exact, the mean and M2
    within K3_SITE_TOL relative, the apply's output within K3_SITE_TOL of
    its max-abs (at least 1), the sums and dx within K3_SITE_TOL of their
    max-abs. The wrappers are swapped in the module, whose launch counters
    then land on the stand-ins; they are carried back on exit."""

    def __init__(self):
        from jpdse_tpu_torch.ops import instance_norm as k3

        self.k3, self.worst, self.calls = k3, dict.fromkeys(K3_PARTIAL, 0.0), 0

    def _note(self, name: str, err: float, what) -> None:
        self.worst[name] = max(self.worst[name], err)
        self.calls += 1
        if not err <= K3_SITE_TOL:
            raise AssertionError(f"{name} at {what}: {err:.2e} from its plain version "
                                 f"(tolerance {K3_SITE_TOL})")

    def __enter__(self):
        k3 = self.k3
        self.orig = {name: getattr(k3, name) for name in K3_PARTIAL}
        o = self.orig

        def stats(x):
            got = o["instance_norm_stats"](x)
            with torch.no_grad():
                want = k3.instance_norm_stats_plain(x)
            if not torch.equal(got[..., 0], want[..., 0]):
                raise AssertionError(f"instance_norm_stats at {tuple(x.shape)}: counts differ")
            self._note("instance_norm_stats", max(
                ((got[..., i] - want[..., i]).abs() / want[..., i].abs().clamp_min(1.0)).max().item()
                for i in (1, 2)), tuple(x.shape))
            return got

        def apply(x, residual, parts, relu=False, eps=1e-5):
            y, ms = o["instance_norm_apply"](x, residual, parts, relu, eps)
            with torch.no_grad():
                want, _ = k3.instance_norm_apply_plain(x, residual, parts, relu, eps)
            self._note("instance_norm_apply", _site_err(y, want, 1.0), tuple(x.shape))
            return y, ms

        def sums(x, g, ms, relu=False):
            got = o["instance_norm_bwd_sums"](x, g, ms, relu)
            with torch.no_grad():
                want = k3.instance_norm_bwd_sums_plain(x, g, ms, relu)
            self._note("instance_norm_bwd_sums", _site_err(got, want), tuple(x.shape))
            return got

        def dx(x, g, ms, parts, count, relu=False):
            got = o["instance_norm_bwd_dx"](x, g, ms, parts, count, relu)
            with torch.no_grad():
                want = k3.instance_norm_bwd_dx_plain(x, g, ms, parts, count, relu)
            self._note("instance_norm_bwd_dx", _site_err(got, want), tuple(x.shape))
            return got

        for name, fn in zip(K3_PARTIAL, (stats, apply, sums, dx)):
            fn.launches = o[name].launches
            setattr(k3, name, fn)
        return self

    def __exit__(self, *exc):
        for name, fn in self.orig.items():
            fn.launches = getattr(self.k3, name).launches
            setattr(self.k3, name, fn)

    def summary(self) -> str:
        return (f"{self.calls} launches each held against its plain version on the same inputs, "
                "worst " + ", ".join(f"{k} {v:.2e}" for k, v in self.worst.items())
                + f" (tolerance {K3_SITE_TOL})")


def _same_on_every_rank(tag: str, tensors: list, what: str = "parameters") -> None:
    """Rank 0's tensors broadcast to every rank, each held bit for bit
    against the rank's own (a rank that differs raises)."""
    from jpdse_tpu_torch.parallel import distributed

    theirs = [t.detach().clone() for t in tensors]
    distributed.broadcast_(theirs)
    if not all(torch.equal(a, b) for a, b in zip(theirs, tensors)):
        raise AssertionError(f"{tag}: rank {distributed.rank()}'s {what} differ from rank 0's")


def spatial_eval_argv(run: Path, out: Path, opt: str) -> list:
    return ["--load_opt", "--opt_file", str(run / opt), "--checkpoints_dir", str(run),
            "--save_dir", str(out), "--mode", "val"]


def spatial_eval_image(argv: list, signs=None) -> np.ndarray:
    """The reconstruction of the split's first batch by a test-mode Trainer
    on the run's weights (the path test.main takes), its binarizers'
    signs through ``signs`` where given."""
    from jpdse_tpu_torch.cli import parse_config
    from jpdse_tpu_torch.config import derive_eval_config
    from jpdse_tpu_torch.data import create_dataloader
    from jpdse_tpu_torch.trainer import Trainer

    with contextlib.redirect_stdout(io.StringIO()):
        cfg = derive_eval_config(parse_config(argv, is_train=False), mode="val")
        trainer = Trainer(cfg, mode="test", device="cuda")
        trainer.load()
        batch = next(iter(create_dataloader(cfg)))
        with signs or contextlib.nullcontext():
            return trainer.get_img(batch).cpu().numpy()


def spatial_eval(argv: list, tag: str, prefix: str = "[spatial] (b)") -> tuple:
    """test.main with every kernel count set to 0 just before it and read
    just after, in fp32 with TF32 off, then the first image's
    reconstruction: (metrics, counts, image)."""
    from jpdse_tpu_torch import test

    with tf32_off():
        reset_counts()
        with contextlib.redirect_stdout(io.StringIO()) as text:
            metrics = test.main(argv, device="cuda")
        torch.cuda.synchronize()
        counts = read_counts()
        image = spatial_eval_image(argv)
    for line in text.getvalue().splitlines():
        if line.startswith(("test set avg", "multi-process mesh", "fast_inference")):
            log(f"{prefix} {tag}: {line}")
    return metrics, counts, image


def _phase13_rank(rank: int, port: int, seed: int, work: str) -> None:
    """One of two ranks at spatial_axis 2 on the one card (gloo). (a) For
    the default and then the kernel configuration, two steps, each from the
    single-process path's parameters and Adams (the twin, stepped on rank 0
    on the whole batch; its gradients broadcast, so both ranks' twins step
    alike): rank 0 records the twin's pre-signs and uniforms, every rank
    steps its 256 rows of both images on those code bits (PinnedSigns), the
    same in float64, rank 0 holds the sharded step against the twin's by
    phase 7 (a)'s rule with two controls and the float64 arbiter, and the
    ranks' uniforms, gathered, against the twin's bit for bit; in the
    kernel configuration every partial-form launch is held against its
    plain version (K3PartialCheck); after each step the ranks' parameters
    are bit-identical. Then phase 14 (c) (_phase14_ranks). (b) test.main
    sharded, then the first image's reconstruction."""
    os.environ["LOCAL_RANK"] = "0"
    import torch.distributed as dist

    from jpdse_tpu_torch.ops.build import build_all
    from jpdse_tpu_torch.parallel import distributed, spatial
    from jpdse_tpu_torch.train import step
    from jpdse_tpu_torch.trainer import Trainer

    build_all()  # loads the kernels the parent built
    distributed.initialize("cuda", f"localhost:{port}", 2, rank, backend="gloo")
    result = {"train": {}}
    for kernels in (False, True):
        label = "kernel configuration" if kernels else "default configuration"
        t0 = time.perf_counter()
        cfg = flagship_train_config(kernels, seed)
        cfg.parallel.spatial_axis = 2
        dp = Trainer(cfg, mode="train", device="cuda:0")
        twin = Trainer(flagship_train_config(kernels, seed), mode="train", device="cuda:0")
        twin.mesh = twin.gan.mesh = None  # the same weights, stepped as one process
        if dp.mesh is None or dp.mesh.spatial != 2 or dist.get_backend() != "gloo":
            raise AssertionError(f"rank {rank}: no gloo mesh of spatial 2: {dp.mesh}")
        batch = train_batch(dp.cfg, seed)
        shard = dp.mesh.shard(batch["image"].shape[1])

        def mine(t):  # this rank's H rows of a whole tensor (an image's, or a code's)
            return t[:, dp.mesh.h_rows(t.shape[1])]

        h_rows = dp.mesh.h_rows(batch["image"].shape[1])
        log(f"[spatial] (a) rank {rank}, {label}: trainers built in "
            f"{time.perf_counter() - t0:.1f} s; this rank's rows {h_rows.start}-{h_rows.stop} of "
            f"{batch['image'].shape[1]}")
        for k in range(2):
            tag = f"phase-2 recipe, spatial 2, {label}, step {k + 1}"
            for a, b in ((twin.gan.codec, dp.gan.codec), (twin.gan.disc, dp.gan.disc),
                         (twin.gan.opt_g, dp.gan.opt_g), (twin.gan.opt_d, dp.gan.opt_d)):
                b.load_state_dict(a.state_dict())
            dp.gan.steps_taken = twin.gan.steps_taken
            dp.gan.lambda_distortion_weight = twin.gan.lambda_distortion_weight
            out, pre, out64 = {}, {}, {}
            with tf32_off():
                with torch.no_grad():  # the twin's pre-signs' shapes, then rank 0's values
                    ref = twin.gan.codec.get_presign(twin.gan.codec.prepare(twin.place(batch)))
                if rank == 0:
                    gen = torch.Generator(device="cuda").manual_seed(seed + k)
                    with PinnedSigns() as rec:
                        out["single process"], _ = counted_step(twin.gan, twin.place(batch), gen)
                    ref, single_draws = rec.calls, rec.draws
                distributed.broadcast_(ref)
                gen = torch.Generator(device="cuda").manual_seed(seed + k)
                check = K3PartialCheck() if kernels else contextlib.nullcontext()
                t1 = time.perf_counter()
                spatial.traffic.update(calls=0, bytes=0)
                with PinnedSigns([mine(r) for r in ref]) as rec, check:
                    out["2 spatial ranks"], counts = counted_step(dp.gan, dp.place(batch), gen)
                dt_s = time.perf_counter() - t1
                traffic = dict(spatial.traffic)
                want = SPATIAL_K3 if kernels else {}
                if {n: counts[n] for n in K3_PARTIAL} != {n: want.get(n, 0) for n in K3_PARTIAL} \
                        or counts["fused_instance_norm"] or counts["fused_instance_norm_bwd"]:
                    raise AssertionError(f"rank {rank}, {tag}: launches {counts}")
                result["train"][f"spatial 2, {label}, step {k + 1}"] = counts
                log(f"[spatial] (a) rank {rank}, {tag}: loss_and_grads of its rows {dt_s:.2f} s "
                    f"(fp32, TF32 off, halo exchanges and the gradient all-reduce over gloo "
                    f"included); {traffic['calls']} all-reduces over the spatial group "
                    f"({traffic['bytes'] / 2**20:.1f} MiB) besides the gradients'; launches "
                    f"{ {n: v for n, v in counts.items() if v} }"
                    + (f"; {check.summary()}" if kernels else ""))
                pre["2 spatial ranks"] = [spatial.gather_rows(x, shard) for x in rec.calls]
                draws = [spatial.gather_rows(u, shard) for u in rec.draws]
                ref64 = [r.double() for r in ref]
                if rank == 0:
                    out64["single process"], ref64 = f64_step(twin, batch, seed + k)
                distributed.broadcast_(ref64)
                out64["2 spatial ranks"], _ = f64_step(dp, batch, seed + k,
                                                       [mine(r) for r in ref64])
                if rank == 0:
                    if not all(torch.equal(a, b) for a, b in zip(draws, single_draws)):
                        raise AssertionError(f"{tag}: the ranks' uniforms are not the global "
                                             "draws' rows")
                    for i, b in enumerate(perturbed(batch, seed)):
                        gen = torch.Generator(device="cuda").manual_seed(seed + k)
                        with PinnedSigns(ref) as rec:
                            out[f"control {i + 1}"], _ = counted_step(twin.gan, twin.place(b), gen)
                        pre[f"control {i + 1}"] = rec.calls
                    pinned_bits(tag, ref, pre)
                    hold_step(tag, out, None, (twin.gan.codec, twin.gan.disc), seed + k,
                              "single process", "2 spatial ranks", out64)
                    log(f"[spatial] (a) {tag}: the ranks' {sum(u.numel() for u in draws)} "
                        "binarizer uniforms, gathered, bit-equal to one process's")
            # the twin's gradients from rank 0, so both ranks' twins step alike
            g_twin = out["single process"][1] if rank == 0 else (
                [torch.zeros_like(p) for p in twin.gan.codec.parameters()],
                [torch.zeros_like(p) for p in twin.gan.disc.parameters()])
            distributed.broadcast_(list(g_twin[0]) + list(g_twin[1]))
            step.apply(twin.gan, g_twin)
            step.apply(dp.gan, out["2 spatial ranks"][1])
            _same_on_every_rank(tag, list(dp.gan.codec.parameters())
                                + list(dp.gan.disc.parameters()))
            log(f"[spatial] (a) rank {rank}, {tag}: parameters after the step bit-equal to rank "
                "0's")
            del out, out64
        del dp, twin
        torch.cuda.empty_cache()
    _phase14_ranks(rank, seed)
    run = Path(work) / "eval"
    metrics, counts, image = spatial_eval(
        spatial_eval_argv(run, Path(work) / f"rank{rank}", "opt.json"), f"rank {rank}")
    result["eval"] = {"metrics": metrics, "counts": counts}
    if rank == 0:
        np.save(os.path.join(work, "rank0_image.npy"), image)
    result["phase15"] = _phase15_ranks(rank, seed, work)
    result["phase16"] = _phase16_ranks(rank, seed, work)
    torch.save(result, os.path.join(work, f"rank{rank}.pt"))
    distributed.barrier()
    dist.destroy_process_group()


def phase13(seed: int, card: str) -> tuple:
    """Phase 13, the spatial axis: two ranks of one process each at
    spatial_axis 2 on the card (gloo), spawned. (a) the phase-2 recipe at
    full width in the default and the kernel configuration (see
    _phase13_rank); (b) test.main of one synthetic 2048x1024 triplet read
    'fixed' to 1024x512 in the kernel configuration, fp32 with TF32 off,
    sharded, against the same run in one process here: the .rc bytes
    equal, the rates equal, the first image's reconstruction within
    FP32_ATOL. Returns (eval counts, train counts)."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="jpdse_spatial_") as work:
        run = Path(work) / "eval"
        sharded_eval_setup(run, seed, 13, 2, "opt.json")
        phase15_setup(Path(work), seed)
        phase16_setup(Path(work), seed)
        ctx = torch.multiprocessing.get_context("spawn")
        port = free_port()
        procs = [ctx.Process(target=_phase13_rank, args=(r, port, seed, work)) for r in range(2)]
        for p in procs:
            p.start()
        # meanwhile the same evaluation in one process
        one_metrics, one_counts, one_image = spatial_eval(
            spatial_eval_argv(run, Path(work) / "single", "opt1.json"), "one process")
        one15 = phase15_one_process(Path(work))
        one16 = spatial_fast_eval(Path(work) / "uneven_hires", "opt_float32_fast_1.json",
                                  Path(work) / "uneven_hires_one")
        for p in procs:
            p.join(timeout=900)
        codes = [p.exitcode for p in procs]
        for p in procs:
            if p.is_alive():
                p.kill()
        if codes != [0, 0]:
            raise AssertionError(f"phase 13: the two ranks exited with {codes}")
        ranks = [torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=False)
                 for r in range(2)]
        check_sharded_eval(Path(work), (one_metrics, one_counts, one_image),
                           [r["eval"] for r in ranks], "[spatial] (b)", card)
        train = {f"{k}, rank {r}": v for r, res in enumerate(ranks)
                 for k, v in res["train"].items()}
        evals = {f"spatial eval, rank {r}": res["eval"]["counts"] for r, res in enumerate(ranks)}
        evals["spatial eval, one process"] = one_counts
        rank_evals15 = {k: v for res in ranks for k, v in res["phase15"][0].items()}
        evals.update(rank_evals15)
        evals.update(phase15_check(Path(work), one15, rank_evals15, card))
        rank_evals16 = {k: v for res in ranks for k, v in res["phase16"][0].items()}
        evals.update(rank_evals16)
        evals.update(phase16_check_hires(Path(work), one16, rank_evals16, card))
        for res in ranks:
            train.update(res["phase15"][1])
            train.update(res["phase16"][1])
        evals.update(phase16_flagship(seed, Path(work), card))
    log(f"[spatial] spatial-axis phase {time.perf_counter() - t0:.1f} s with the spawn ({card})")
    return evals, train


# -- phase 14: the batch norm ---------------------------------------------------------
BN_TOL = 1e-9  # float64: the card against the CPU, two ranks against one process
# fp32 running statistics after a step against the momentum rule applied in
# float64 to each forward's batch statistics (the step sums in fp32)
BN_STAT_TOL = 1e-5
BN_EVAL_IMAGES = 1


def batch_norm_config(kernels: bool, seed: int, remat: bool = True):
    """The flagship's phase-2 recipe (flagship_train_config) with model.norm
    'batch' at every norm site of G, the encoders and D; ``remat`` False
    keeps every activation."""
    cfg = flagship_train_config(kernels, seed)
    cfg.model.norm, cfg.optim.remat = "batch", remat
    cfg.validate()
    return cfg


class StatsRecorder:
    """While active, a forward hook on every batch norm of ``nets`` (a dict
    of name -> module) records the input shapes it sees and, for each
    forward that advances the running statistics (UPDATE, not a remat
    recompute), applies the momentum rule in float64 to that input's batch
    statistics and counts the forward: what the buffers must hold after
    the step."""

    def __init__(self, nets: dict):
        from jpdse_tpu_torch.models import layers

        self.layers = layers
        self.norms = {f"{net}:{name}": m for net, root in nets.items()
                      for name, m in root.named_modules() if isinstance(m, layers.BatchNorm)}

    def __enter__(self):
        L = self.layers
        self.expected = {n: (m.mean.double().clone(), m.var.double().clone())
                         for n, m in self.norms.items()}
        self.counts = {n: 0 for n in self.norms}
        self.shapes = set()

        def hook(name):
            def fn(module, args, out):
                x = args[0]
                self.shapes.add((name.split(":")[0], tuple(x.shape)))
                ctx = L.norm_state()
                if ctx.mode == L.UPDATE and not ctx.replay:
                    with torch.no_grad():
                        mean, var = L.batch_stats(x.detach().double())
                    m0, v0 = self.expected[name]
                    self.expected[name] = (L.MOMENTUM * m0 + (1 - L.MOMENTUM) * mean,
                                           L.MOMENTUM * v0 + (1 - L.MOMENTUM) * var)
                    self.counts[name] += 1
            return fn

        self.handles = [m.register_forward_hook(hook(n)) for n, m in self.norms.items()]
        return self

    def __exit__(self, *exc):
        for h in self.handles:
            h.remove()

    def check(self, tag: str, per_step: dict) -> float:
        """Each norm advanced ``per_step[net]`` times, its buffers within
        BN_STAT_TOL of the rule's values (of each tensor's max-abs); returns
        the largest such error."""
        worst = 0.0
        for n, m in self.norms.items():
            want = per_step[n.split(":")[0]]
            if self.counts[n] != want:
                raise AssertionError(f"{tag}: {n} advanced {self.counts[n]} times, want {want}")
            for got, exp in zip((m.mean, m.var), self.expected[n]):
                err = ((got.double() - exp).abs().max() / exp.abs().max()).item()
                worst = max(worst, err)
                if not err <= BN_STAT_TOL:
                    raise AssertionError(f"{tag}: {n} is {err:.2e} from the momentum rule")
        return worst


def stats_of(*modules) -> list:
    """Every batch norm's running statistics of ``modules``, in order."""
    from jpdse_tpu_torch.convert import is_stat

    return [v for m in modules for k, v in m.state_dict().items() if is_stat(k)]


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return ((a - b).norm() / max(b.norm().item(), 1e-300)).item()


def phase14_layer(shapes: list, seed: int, card: str) -> None:
    """(a) The batch norm on the card against the same call on the CPU, both
    in float64, at every norm shape of the phase-2 step (G's and D's, as
    StatsRecorder saw them): the output, the gradients of x, scale and bias
    and the running statistics after an UPDATE forward, each within BN_TOL
    of its max-abs; then the quantizers' forward and gradients likewise."""
    from jpdse_tpu_torch.models import layers
    from jpdse_tpu_torch.ops import quantizers as q

    t0 = time.perf_counter()
    rng = np.random.default_rng(seed + 14)
    worst = 0.0
    for net, shape in shapes:
        c = shape[-1]
        x = torch.from_numpy(rng.normal(size=shape) * 2.0 + 0.5)
        cot = torch.from_numpy(rng.normal(size=shape))
        state = {"BatchNorm_0.scale": torch.from_numpy(1 + 0.02 * rng.normal(size=c)),
                 "BatchNorm_0.bias": torch.from_numpy(0.1 * rng.normal(size=c)),
                 "BatchNorm_0.mean": torch.from_numpy(0.1 * rng.normal(size=c)),
                 "BatchNorm_0.var": torch.from_numpy(rng.uniform(0.5, 1.5, c))}
        outs = []
        for dev in ("cpu", "cuda"):
            norm = layers.Norm("batch", c).double().to(dev)
            norm.load_state_dict(state)
            xi = x.to(dev).detach().requires_grad_(True)
            with layers.norm_mode(layers.UPDATE):
                y = norm(xi)
            y.backward(cot.to(dev))
            bn = norm.BatchNorm_0
            outs.append([t.detach().cpu() for t in (y, xi.grad, bn.scale.grad, bn.bias.grad,
                                                    bn.mean, bn.var)])
            del norm, xi, y
        for name, a, b in zip(("y", "dx", "dscale", "dbias", "mean", "var"), outs[1], outs[0]):
            err = ((a - b).abs().max() / b.abs().max()).item()
            worst = max(worst, err)
            if not err <= BN_TOL:
                raise AssertionError(f"(a) {net} {shape}: {name} on the card {err:.2e} from the CPU")
        del x, cot, outs
    log(f"[batch norm] (a) the batch norm on the card against the CPU in float64 at the "
        f"{len(shapes)} norm shapes of the phase-2 step ({', '.join(f'{n} {s}' for n, s in shapes)}):"
        f" output, dx, dscale, dbias and the updated statistics within {worst:.2e} of their "
        f"max-abs (tolerance {BN_TOL}); {time.perf_counter() - t0:.1f} s")
    worst = 0.0
    for cls, (n_c, size, sigma) in ((q.S2HVQ, (64, 8, 10.0)), (q.S2HVQV2, (64, 8, 10.0))):
        x = torch.from_numpy(rng.normal(size=(4096, 16 * size)))
        cot = torch.from_numpy(rng.normal(size=(4096, 16, n_c)))
        outs = []
        for dev in ("cpu", "cuda"):
            m = cls(n_c, size, sigma, generator=torch.Generator().manual_seed(seed)).double()
            m = m.to(dev)
            xi = x.to(dev).detach().requires_grad_(True)
            soft = m.encode(xi, 16, True)
            soft.backward(cot.to(dev))
            hard = m.encode(xi.detach(), 16, False)
            r = q.rounded_identity(xi * 3.0)
            grads = [p.grad for _, p in m.named_parameters() if p.grad is not None]
            outs.append([t.detach().cpu() for t in [soft, xi.grad, hard, m.decode(hard), r,
                                                    q.S2HVQ.get_cross_entropy(
                                                        q.S2HVQ.get_pmf(soft), q.S2HVQ.get_pmf(
                                                            hard))] + grads])
        for a, b in zip(outs[1], outs[0]):
            err = ((a - b).abs().max() / max(b.abs().max().item(), 1e-300)).item()
            worst = max(worst, err)
            if not err <= BN_TOL:
                raise AssertionError(f"(a) {cls.__name__} on the card {err:.2e} from the CPU")
    log(f"[batch norm] (a) S2HVQ and S2HVQV2 (64 centers of 8, 4096 x 16 codes) and "
        f"rounded_identity on the card against the CPU in float64: soft and hard codes, "
        f"decode, cross-entropy, x's and the parameters' gradients within {worst:.2e} ({card})")


def phase14_train(seed: int, steps: int, card: str, run: Path) -> dict:
    """(b) The phase-2 recipe with model.norm 'batch' at full width and
    depth (batch 2 at 1024x512, fp32, block remat, random weights from
    --seed): one loss_and_grads with TF32 off under StatsRecorder (each of
    G's norms advanced once, D's twice, the buffers as the momentum rule
    says), the same step without remat (statistics equal), then (a)'s
    check at the shapes the recorder saw; ``steps`` Trainer.steps with
    PyTorch's default precision against as many of the instance-norm
    recipe (median host-clock step after the first, peak memory); one step
    in the kernel configuration, which launches no K3; the state saved in
    ``run`` for (d). Returns the launch counts."""
    from jpdse_tpu_torch.train import step
    from jpdse_tpu_torch.trainer import Trainer

    t0 = time.perf_counter()
    cfg = batch_norm_config(False, seed)
    cfg.save_dir = str(run)
    bn = Trainer(cfg, mode="train", device="cuda")
    batch = train_batch(cfg, seed + 14)
    placed = bn.place(batch)
    flat = Trainer(batch_norm_config(False, seed, remat=False), mode="train", device="cuda")
    for a, b in ((bn.gan.codec, flat.gan.codec), (bn.gan.disc, flat.gan.disc)):
        b.load_state_dict(a.state_dict())
    before = [t.clone() for t in stats_of(bn.gan.codec, bn.gan.disc)]
    launches = {}
    with tf32_off():
        rec = StatsRecorder({"G": bn.gan.codec, "D": bn.gan.disc})
        with SignRecorder() as signs, rec:
            (metrics, _), launches["batch norm, block remat"] = counted_step(
                bn.gan, placed, torch.Generator(device="cuda").manual_seed(seed))
        if not all(torch.isfinite(v).item() for v in metrics.values()):
            raise AssertionError(f"(b) losses {metrics}")
        rule = rec.check("(b) block remat", {"G": 1, "D": 2})
        torch.cuda.reset_peak_memory_stats()
        with SignRecorder(signs.calls):
            (_, _), launches["batch norm, no remat"] = counted_step(
                flat.gan, flat.place(batch), torch.Generator(device="cuda").manual_seed(seed))
        peak_flat = torch.cuda.max_memory_allocated() / 2**30
    after = stats_of(bn.gan.codec, bn.gan.disc)
    remat_err = max(((a - b).abs().max() / b.abs().max()).item()
                    for a, b in zip(after, stats_of(flat.gan.codec, flat.gan.disc)))
    if not remat_err <= 1e-6:
        raise AssertionError(f"(b) statistics with remat {remat_err:.2e} from those without")
    moved = sum(not torch.equal(a, b) for a, b in zip(before, after))
    if moved != len(after):
        raise AssertionError(f"(b) {len(after) - moved} of {len(after)} statistics did not move")
    log(f"[batch norm] (b) phase-2 recipe, norm batch, full width, one loss_and_grads (fp32, "
        f"TF32 off): losses finite; {len(after)} statistics ({len(rec.norms)} norms: each of "
        f"G's advanced once, D's twice) all moved, within {rule:.2e} of the momentum rule on each "
        f"forward's batch statistics in float64; the same step without remat (peak "
        f"{peak_flat:.2f} GiB) leaves them within {remat_err:.2e} ({card})")
    del flat
    torch.cuda.empty_cache()
    phase14_layer(sorted(rec.shapes), seed, card)
    del rec  # it holds the norms

    batches = [train_batch(cfg, seed + 140 + i) for i in range(steps)]
    medians = {}
    for label in ("batch norm", "instance norm"):  # one trainer on the card at a time
        if label == "instance norm":
            bn.save(0, 1.0)  # (d) evaluates it
            del bn
            torch.cuda.empty_cache()
        trainer = bn if label == "batch norm" else Trainer(
            flagship_train_config(False, seed), mode="train", device="cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for b in batches:
            t1 = time.perf_counter()
            m = trainer.step(b)  # ends in the metrics' host fetch
            times.append((time.perf_counter() - t1) * 1e3)
            if not all(np.isfinite(v) for v in m.values()):
                raise AssertionError(f"(b) {label}: losses {m}")
        medians[label] = float(np.median(times[1:] if steps > 1 else times))
        log(f"[batch norm] (b) phase-2 recipe, {label}: steps (ms) "
            f"{', '.join(f'{t:.1f}' for t in times)}; median after the first "
            f"{medians[label]:.1f} ms host clock; max_memory_allocated "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; convolutions in TF32 ({card})")
        del trainer
    log(f"[batch norm] (b) batch-norm step / instance-norm step: "
        f"{medians['batch norm'] / medians['instance norm']:.3f} ({card})")
    torch.cuda.empty_cache()
    kt = Trainer(batch_norm_config(True, seed), mode="train", device="cuda")
    if any(getattr(m, "fused", False) for m in kt.gan.codec.modules()):
        raise AssertionError("(b) a batch-norm site of the kernel configuration is fused")
    with SignRecorder():
        _, launches["batch norm, kernel configuration"] = counted_step(
            kt.gan, kt.place(batch), torch.Generator(device="cuda").manual_seed(seed))
    if any(launches["batch norm, kernel configuration"].values()):
        raise AssertionError(f"(b) the kernel configuration launched "
                             f"{launches['batch norm, kernel configuration']}")
    log("[batch norm] (b) the kernel configuration with norm batch: no K3 site (JAX's rule: "
        "fused and norm == 'instance'), 0 launches of any kernel in a step")
    del kt
    torch.cuda.empty_cache()
    log(f"[batch norm] (b) {time.perf_counter() - t0:.1f} s")
    return launches


def phase14_eval(seed: int, card: str, run: Path) -> dict:
    """(d) Evaluation of (b)'s saved state, fp32 with TF32 off, the fast path
    asked for (the batch norm falls back to the standard path): test.main
    of BN_EVAL_IMAGES synthetic 2048x1024 triplet(s) read 'fixed' to
    1024x512, its code files equal to an in-process Trainer's codes of the
    same batch; Trainer.compress then decompress of each image within
    FP32_ATOL of get_img; a decode with the batch's statistics differs from
    it (eval reads the running averages). Returns test.main's counts."""
    from jpdse_tpu_torch import test
    from jpdse_tpu_torch.cli import parse_config
    from jpdse_tpu_torch.config import derive_eval_config
    from jpdse_tpu_torch.data import create_dataloader
    from jpdse_tpu_torch.models import layers
    from jpdse_tpu_torch.trainer import Trainer

    t0 = time.perf_counter()
    root, out = run / "cityscapes", run / "eval"
    write_cityscapes(root, seed + 14, n=BN_EVAL_IMAGES)
    cfg = batch_norm_config(False, seed)
    mode, load, crop, aspect = FLAGSHIP_PREPROCESS
    for pp in (cfg.data.preprocess, cfg.data.val_preprocess, cfg.data.test_preprocess):
        pp.preprocess_mode, pp.load_size, pp.crop_size, pp.aspect_ratio = mode, load, crop, aspect
    cfg.data.dataset, cfg.data.root_dir, cfg.data.num_workers = "cityscapes", str(root), 1
    cfg.model.fast_inference = True
    cfg.save(str(run / "opt.json"))
    argv = ["--load_opt", "--opt_file", str(run / "opt.json"), "--checkpoints_dir", str(run),
            "--save_dir", str(out), "--mode", "val"]
    with tf32_off():
        reset_counts()
        with contextlib.redirect_stdout(io.StringIO()) as text:
            metrics = test.main(argv, device="cuda")
        torch.cuda.synchronize()
        counts = read_counts()
        if "fast_inference unavailable" not in text.getvalue():
            raise AssertionError("(d) test.main did not fall back to the standard path")
        with contextlib.redirect_stdout(io.StringIO()):
            ecfg = derive_eval_config(parse_config(argv, is_train=False), mode="val")
            trainer = Trainer(ecfg, mode="test", device="cuda")
            trainer.load()
        batch = next(iter(create_dataloader(ecfg)))
        codes = trainer.get_code(batch)
        for j, p in enumerate(batch["path"]):
            name = os.path.splitext(os.path.basename(p))[0]
            if (out / "codes" / f"{name}_code").read_bytes() != codes[j].astype(np.uint8).tobytes():
                raise AssertionError(f"(d) {name}: test.main's code file differs from the "
                                     "in-process codes")
        img = trainer.get_img(batch)
        streams = trainer.compress(batch)
        err = max(float(np.abs(trainer.decompress(s) - img[j].cpu().numpy()).max())
                  for j, s in enumerate(streams))
        if not err <= FP32_ATOL:
            raise AssertionError(f"(d) a decompressed image is {err:.2e} from get_img")
        codec = trainer._std.codec
        with torch.no_grad(), layers.norm_mode(layers.BATCH):
            train_img = codec._decode(codec.prepare(trainer.place(batch)), True, None)[0]
        diff = float((train_img.float() - img).abs().max())
        if not diff > 1e-2:
            raise AssertionError(f"(d) a decode with the batch's statistics is {diff:.2e} from "
                                 "the eval decode: eval does not read the running averages")
    log(f"[batch norm] (d) (b)'s state saved and evaluated: test.main of {BN_EVAL_IMAGES} "
        f"2048x1024 triplet(s) read 'fixed' to 1024x512 (the fast path falls back to the standard "
        f"path), coded {metrics.get('coded_bpp', float('nan')):.6f} bpp, PSNR "
        f"{metrics['PSNR']:.4f} dB; its code files equal the in-process codes; "
        f"{len(streams)} .jpds stream(s) of {sum(map(len, streams))} bytes decompress within "
        f"{err:.2e} of get_img (tolerance {FP32_ATOL}); a decode with the batch's statistics "
        f"differs by {diff:.3f}; {time.perf_counter() - t0:.1f} s ({card})")
    return {"batch norm eval": counts}


def _f64_bn_step(gan, placed: dict, seed: int, ref=None) -> tuple:
    """One loss_and_grads of a float64 copy of ``gan`` on ``ref``'s code
    bits: (G's and D's gradients, the running statistics after it, the
    pre-signs)."""
    from jpdse_tpu_torch.train import step

    s64 = float64_state(gan)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    with PinnedSigns(ref) as rec:
        _, grads = step.loss_and_grads(s64, dict(placed, image=placed["image"].double()), gen)
    torch.cuda.synchronize()
    return grads, stats_of(s64.codec, s64.disc), rec.calls


def _phase14_ranks(rank: int, seed: int) -> None:
    """(c) of phase 14, in phase 13's two ranks: the batch-norm recipe at
    full width, one float64 loss_and_grads at data_axis 2 (each rank one
    image of the global batch of 2) and at spatial_axis 2 (each rank 256
    rows of both), on one process's code bits, against that process's
    float64 step on the global batch (rank 0): every gradient and running
    statistic within BN_TOL in relative L2 (a bias a norm follows within
    BN_TOL absolute), the statistics bit-equal across ranks."""
    from jpdse_tpu_torch.parallel import distributed
    from jpdse_tpu_torch.trainer import Trainer

    t0 = time.perf_counter()
    twin = Trainer(batch_norm_config(False, seed), mode="train", device="cuda:0")
    twin.mesh = twin.gan.mesh = None
    batch = train_batch(twin.cfg, seed + 14)
    with torch.no_grad():
        ref = [r.double() for r in twin.gan.codec.get_presign(
            twin.gan.codec.prepare(twin.place(batch)))]
    if rank == 0:
        want_g, want_s, ref = _f64_bn_step(twin.gan, twin.place(batch), seed)
    distributed.broadcast_(ref)
    worst, out = 0.0, {}
    for axis in ("data", "spatial"):
        cfg = batch_norm_config(False, seed)
        cfg.parallel.spatial_axis = 2 if axis == "spatial" else 1
        dp = Trainer(cfg, mode="train", device="cuda:0")
        if dp.mesh is None or dp.mesh.world != 2 or dp.mesh.spatial != cfg.parallel.spatial_axis:
            raise AssertionError(f"(c) rank {rank}: not a mesh of 2 on the {axis} axis: {dp.mesh}")
        if axis == "data":
            rows = {k: v[rank:rank + 1] for k, v in batch.items()}
            mine = [r[rank:rank + 1] for r in ref]
        else:
            rows = batch
            mine = [r[:, dp.mesh.h_rows(r.shape[1])] for r in ref]
        t1 = time.perf_counter()
        grads, stats, _ = _f64_bn_step(dp.gan, dp.place(rows), seed, mine)
        _same_on_every_rank(f"(c) {axis} axis, running statistics", stats)
        if rank == 0:
            names = [[n for n, _ in m.named_parameters()] for m in (dp.gan.codec, dp.gan.disc)]
            for net, got, want in zip(names, grads, want_g):
                for n, a, b in zip(net, got, want):
                    err = (a - b).abs().max().item() if NORMED_BIAS.search(n) else _rel(a, b)
                    worst = max(worst, err)
                    if not err <= BN_TOL:
                        raise AssertionError(f"(c) {axis} axis: {n}'s gradient {err:.2e} from "
                                             "one process's")
            for a, b in zip(stats, want_s):
                worst = max(worst, _rel(a, b))
                if not _rel(a, b) <= BN_TOL:
                    raise AssertionError(f"(c) {axis} axis: a running statistic "
                                         f"{_rel(a, b):.2e} from one process's")
        out[axis] = time.perf_counter() - t1
        del dp, grads, stats
        torch.cuda.empty_cache()
    if rank == 0:
        log(f"[batch norm] (c) two gloo ranks on the card, batch-norm recipe at full width, "
            f"float64, against one process on the global batch: data_axis 2 "
            f"({out['data']:.1f} s) and spatial_axis 2 ({out['spatial']:.1f} s), every gradient "
            f"and running statistic within {worst:.2e} (tolerance {BN_TOL}), the statistics "
            f"bit-equal across the ranks; {time.perf_counter() - t0:.1f} s in the ranks")
    del twin
    torch.cuda.empty_cache()


def phase14(seed: int, steps: int, card: str) -> tuple:
    """Phase 14, the batch norm ((c) runs in phase 13's ranks). Returns
    (eval counts, train counts)."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="jpdse_bn_") as work:
        train = phase14_train(seed, steps, card, Path(work))
        evals = phase14_eval(seed, card, Path(work))
    log(f"[batch norm] batch-norm phase {time.perf_counter() - t0:.1f} s ({card})")
    return evals, train


# -- phase 15: the spatial axis beyond the standard path ----------------------------------
SPATIAL_F64_TOL = 1e-9  # float64: two ranks against one process
# a rank-step of the hires recipe in the kernel configuration at spatial 2: K3's
# partial form at the generator's norm sites, as K3_HIRES_FROZEN counts them
# (the enhancer's stacks recomputed by their block remat; the backward where
# autograd reaches: the enhancer's 9 with the trunk frozen, all 36 unfrozen)
SPATIAL_K3_HIRES = {
    "frozen": dict(zip(K3_PARTIAL, (27 + 2 * 9, 27 + 2 * 9, 9, 9))),
    "unfrozen": dict(zip(K3_PARTIAL, (72, 72, 36, 36))),
}
FAST_DTYPES = ("bfloat16", "float32")
KERNELS_OFF_ON_A_SHARD = ("s2d_realign_pad3", "s2d_pad3", "head_conv_s2d")


def phase15_setup(work: Path, seed: int) -> None:
    """The runs phase 15 evaluates: the flagship's default serving
    configuration (the fast path, 'auto' switches) on phase 13's split in
    bf16 and fp32, and the hires recipe's serving configuration (fp32) on
    one 2048x1024 triplet read at 2048x1024, each with an opt file for one
    process and one for spatial_axis 2, random weights from the seed."""
    from jpdse_tpu_torch.config import flagship_config
    from jpdse_tpu_torch.models.codec import SemanticCodec
    from jpdse_tpu_torch.train.checkpoint import save_params

    for name, root, hires in (("fast", work / "eval" / "cityscapes", False),
                              ("hires", work / "hires" / "cityscapes", True)):
        run = work / name
        run.mkdir(parents=True, exist_ok=True)
        if hires:
            write_cityscapes(root, seed + 15, n=SPATIAL_EVAL_IMAGES)
        for dtype in (("float32",) if hires else FAST_DTYPES):
            cfg = hires_configs()[0] if hires else flagship_config()
            cfg.model.compute_dtype, cfg.model.fast_inference = dtype, True
            mode, load, crop, aspect = HIRES_PREPROCESS if hires else FLAGSHIP_PREPROCESS
            for pp in (cfg.data.preprocess, cfg.data.val_preprocess, cfg.data.test_preprocess):
                pp.preprocess_mode, pp.load_size, pp.crop_size = mode, load, crop
                pp.aspect_ratio = aspect
            cfg.data.dataset, cfg.data.root_dir = "cityscapes", str(root)
            cfg.data.normalize_std = FLAGSHIP_NORMALIZE_STD
            cfg.data.num_workers, cfg.optim.seed = 1, seed
            for size in (2, 1):
                cfg.parallel.spatial_axis = size
                cfg.save(str(run / f"opt_{dtype}_{size}.json"))
        save_params(str(run), SemanticCodec(cfg, device="cuda", seed=seed + 15,
                                            dtype=torch.float32).state_dict())


def spatial_fast_eval(run: Path, opt: str, out: Path, presign: bool = False) -> tuple:
    """test.main of the split through the fast path, every kernel count set
    to 0 just before it and read just after, then a test-mode Trainer on the
    same weights: the first batch's codes (``get_code``), its ``.jpds``
    streams (``compress``), the first stream decompressed, the
    reconstruction (``get_img``) and, with ``presign``, the standard path's
    pre-signs of the codes. fp32 with TF32 off. Returns (results, counts)."""
    from jpdse_tpu_torch import test
    from jpdse_tpu_torch.cli import parse_config
    from jpdse_tpu_torch.config import derive_eval_config
    from jpdse_tpu_torch.data import create_dataloader
    from jpdse_tpu_torch.trainer import Trainer

    argv = spatial_eval_argv(run, out, opt)
    fp32 = "float32" in opt
    with tf32_off() if fp32 else contextlib.nullcontext():
        reset_counts()
        with contextlib.redirect_stdout(io.StringIO()) as text:
            metrics = test.main(argv, device="cuda")
        torch.cuda.synchronize()
        counts = read_counts()
        with contextlib.redirect_stdout(io.StringIO()) as text2:
            cfg = derive_eval_config(parse_config(argv, is_train=False), mode="val")
            trainer = Trainer(cfg, mode="test", device="cuda")
            trainer.load()
            batch = next(iter(create_dataloader(cfg)))
            res = {"metrics": metrics, "text": text.getvalue() + text2.getvalue(),
                   "recon": trainer.get_img(batch).cpu().numpy()}
            if cfg.has_binary_codes:
                res["codes"] = trainer.get_code(batch)
            res["streams"] = trainer.compress(batch)
            res["decompressed"] = trainer.decompress(res["streams"][0])
            if presign and cfg.has_binary_codes:
                codec = trainer._std.codec
                with torch.no_grad():
                    pre = codec.get_presign(codec.prepare(trainer.place(batch)))
                res["presign"] = torch.cat([p.float().reshape(p.shape[0], -1) for p in pre],
                                           1).cpu().numpy()
    codes_dir = out / "codes"
    res["code_files"] = ({p.name: p.read_bytes() for p in sorted(codes_dir.iterdir())}
                         if codes_dir.exists() else {})
    return res, counts


def _phase15_fast_train(rank: int, seed: int) -> float:
    """(b) The phase-2 recipe through the fast train decode at full width,
    batch 2: one float64 loss_and_grads of each rank's 256 rows of both
    images against one process's on the whole batch (rank 0), on that
    run's code bits. Returns the worst relative L2 (rank 0)."""
    from jpdse_tpu_torch.parallel import distributed
    from jpdse_tpu_torch.trainer import Trainer

    t0 = time.perf_counter()
    cfgs = [flagship_train_config(False, seed) for _ in range(2)]
    for cfg, size in zip(cfgs, (2, 1)):
        cfg.optim.fast_train, cfg.parallel.spatial_axis = True, size
    dp = Trainer(cfgs[0], mode="train", device="cuda:0")
    if dp.gan.fast_decode is None or dp.mesh is None or dp.mesh.spatial != 2:
        raise AssertionError(f"(b) rank {rank}: no fast train decode on a spatial mesh")
    batch = train_batch(dp.cfg, seed + 15)
    with torch.no_grad():  # the pre-signs' shapes, then rank 0's values
        ref = [r.double() for r in dp.gan.codec.get_presign(dp.gan.codec.prepare(
            dp.place(batch)))]
    worst = 0.0
    # every rank builds the twin: a Trainer under a process group broadcasts its weights
    twin = Trainer(cfgs[1], mode="train", device="cuda:0")
    twin.mesh = twin.gan.mesh = None
    if rank == 0:
        want, ref = f64_step(twin, batch, seed)
    del twin
    torch.cuda.empty_cache()
    distributed.broadcast_(ref)
    reset_counts()
    got, _ = f64_step(dp, batch, seed, [r[:, dp.mesh.h_rows(r.shape[1])] for r in ref])
    counts = read_counts()
    if any(counts.values()):
        raise AssertionError(f"(b) rank {rank}: the fast train step launched {counts}")
    if rank == 0:
        worst = _hold_f64("(b) fast train", dp.gan, got, want)
        log(f"[spatial paths] (b) phase-2 recipe through the fast train decode, full width, "
            f"batch 2, float64, two gloo ranks (256 rows each) against one process on its code "
            f"bits: every gradient within {worst:.2e} (tolerance {SPATIAL_F64_TOL}); no kernel "
            f"launched; {time.perf_counter() - t0:.1f} s in the ranks")
    del dp, got
    torch.cuda.empty_cache()
    return worst


def _hold_f64(tag: str, gan, got: tuple, want: tuple) -> float:
    """G's and D's float64 gradients against one process's: each within
    SPATIAL_F64_TOL in relative L2 (a bias a norm follows, absolute).
    Returns the worst."""
    worst = 0.0
    names = [[n for n, _ in m.named_parameters()] for m in (gan.codec, gan.disc)]
    for net, a_s, b_s in zip(names, got, want):
        for n, a, b in zip(net, a_s, b_s):
            err = (a - b).abs().max().item() if NORMED_BIAS.search(n) else _rel(a, b)
            worst = max(worst, err)
            if not err <= SPATIAL_F64_TOL:
                raise AssertionError(f"{tag}: {n}'s gradient {err:.2e} from one process's")
    return worst


def _phase15_hires(rank: int, seed: int) -> dict:
    """(c) The hires recipe's LocalEnhancer at 2048x1024, batch 1, each rank
    512 rows, in the kernel configuration: one fp32 loss_and_grads with the
    trunk frozen (TF32 off; phase 16 (a) takes the unfrozen one, at
    2048x1376), K3's partial form counted a rank-step and every launch held
    against its plain version (K3PartialCheck); then unfrozen in float64
    (K3 has no float64 form: its
    sites run the plain InstanceNorm) against one process (rank 0) within
    1e-9. Returns the counts."""
    from jpdse_tpu_torch.trainer import Trainer

    t0 = time.perf_counter()
    cfg = flagship_train_config(True, seed, "hiresA")
    cfg.parallel.spatial_axis = 2
    dp = Trainer(cfg, mode="train", device="cuda:0")
    batch = train_batch(dp.cfg, seed + 16)
    trunk = dp.gan.codec.netG.global_trunk
    trunk.requires_grad_(False)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    check = K3PartialCheck()
    t1 = time.perf_counter()
    with tf32_off(), check:
        (metrics, _), counts = counted_step(dp.gan, dp.place(batch), gen)
    if {n: counts[n] for n in K3_PARTIAL} != SPATIAL_K3_HIRES["frozen"] or \
            counts["fused_instance_norm"] or counts["fused_instance_norm_bwd"]:
        raise AssertionError(f"(c) rank {rank}, trunk frozen: launches {counts}")
    if not all(np.isfinite(v.item()) for v in metrics.values()):
        raise AssertionError(f"(c) rank {rank}, trunk frozen: metrics {metrics}")
    out = {f"spatial paths: hires, spatial 2, trunk frozen, rank {rank}": counts}
    log(f"[spatial paths] (c) rank {rank}, hires recipe, kernel configuration, trunk frozen, "
        f"fp32 (TF32 off): loss_and_grads of its 512 rows {time.perf_counter() - t1:.2f} s; "
        f"K3 partial a rank-step { {n: counts[n] for n in K3_PARTIAL} }; {check.summary()}")
    trunk.requires_grad_(True)  # the float64 step below is the unfrozen one
    torch.cuda.empty_cache()
    want = None
    # every rank builds the twin: a Trainer under a process group broadcasts its weights
    twin = Trainer(flagship_train_config(True, seed, "hiresA"), mode="train", device="cuda:0")
    twin.mesh = twin.gan.mesh = None
    if rank == 0:
        twin.gan.codec.netG.global_trunk.requires_grad_(True)
        torch.cuda.reset_peak_memory_stats()
        want, _ = f64_step(twin, batch, seed)
        peak_one = torch.cuda.max_memory_allocated() / 2**30
    del twin
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    got, _ = f64_step(dp, batch, seed)
    peak = torch.cuda.max_memory_allocated() / 2**30
    if rank == 0:
        worst = _hold_f64("(c) hires", dp.gan, got, want)
        log(f"[spatial paths] (c) hires recipe, trunk unfrozen, float64, two gloo ranks (512 "
            f"rows each) against one process: every gradient within {worst:.2e} (tolerance "
            f"{SPATIAL_F64_TOL}); peak memory one process {peak_one:.2f} GiB, a rank "
            f"{peak:.2f} GiB (allocated by this process, the other rank's beside it); "
            f"{time.perf_counter() - t0:.1f} s in the ranks")
    del dp, got, want
    torch.cuda.empty_cache()
    return out


def _phase15_ranks(rank: int, seed: int, work: str) -> dict:
    """Phase 15 in phase 13's two ranks: (a) the flagship's default fast
    path at spatial 2 in bf16 and fp32 (spatial_fast_eval, its results
    saved for the parent); (b) _phase15_fast_train; (c) _phase15_hires,
    then the hires recipe's test.main through the sharded fast path. Returns
    (eval counts, train counts)."""
    from jpdse_tpu_torch.parallel import distributed

    t0 = time.perf_counter()
    evals, train = {}, {}
    for dtype in FAST_DTYPES:
        res, counts = spatial_fast_eval(Path(work) / "fast", f"opt_{dtype}_2.json",
                                        Path(work) / f"fast_{dtype}_rank{rank}")
        evals[f"spatial paths: flagship fast path {dtype}, spatial 2, rank {rank}"] = counts
        torch.save(res, os.path.join(work, f"fast_{dtype}_rank{rank}.pt"))
    distributed.barrier()
    _phase15_fast_train(rank, seed)
    train.update(_phase15_hires(rank, seed))
    res, counts = spatial_fast_eval(Path(work) / "hires", "opt_float32_2.json",
                                    Path(work) / f"hires_rank{rank}")
    evals[f"spatial paths: hires fast path float32, spatial 2, rank {rank}"] = counts
    torch.save(res, os.path.join(work, f"hires_rank{rank}.pt"))
    log(f"[spatial paths] rank {rank}: phase 15 in the ranks {time.perf_counter() - t0:.1f} s")
    return evals, train


def phase15_one_process(work: Path) -> dict:
    """The one-process references of phase 15 (a) and (c)'s test.main, run
    in the parent while the ranks train. Returns {tag: (results, counts)}."""
    out = {}
    for dtype in FAST_DTYPES:
        out[f"fast {dtype}"] = spatial_fast_eval(work / "fast", f"opt_{dtype}_1.json",
                                                 work / f"fast_{dtype}_one",
                                                 presign=dtype == "float32")
    out["hires float32"] = spatial_fast_eval(work / "hires", "opt_float32_1.json",
                                             work / "hires_one")
    return out


def _code_flips(got: np.ndarray, want: np.ndarray, presign: np.ndarray) -> tuple:
    """(code bits that differ, the largest |pre-sign| among them)."""
    flipped = got != want
    return int(flipped.sum()), float(np.abs(presign[flipped]).max()) if flipped.any() else 0.0


def _rel_l2(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def phase15_check(work: Path, one: dict, rank_evals: dict, card: str) -> dict:
    """Phase 15's sharded runs against one process's. fp32 ((a)'s flagship
    and (c)'s hires recipe): the rates and test.main's code files equal,
    the codes equal except where the pre-sign (the standard path's, fp32)
    is within 1e-5 of 0, the streams byte-identical where the codes are,
    the reconstruction and the decompressed stream within FP32_ATOL. bf16
    ((a)): a bit that bf16 rounding moves across 0 changes what the random
    weights decode, so the run is held against one process's bf16 run
    under the bound that one process's own bf16 rounding sets, its
    distance from its fp32 run (the control): every differing code bit at
    a pre-sign within twice the control's largest, the images within
    twice the control's relative L2, the raw rate equal, the streams
    byte-identical where the codes are. K1, K2 and K4 launch nowhere in
    the ranks' test.main (``rank_evals``: its counts). Returns the
    one-process eval counts."""
    off = {tag: {k: v for k, v in c.items() if k in KERNELS_OFF_ON_A_SHARD and v}
           for tag, c in rank_evals.items()}
    if any(off.values()):
        raise AssertionError(f"K1, K2 or K4 launched on a shard: {off}")
    images = ("recon", "decompressed")
    ref32 = one["fast float32"][0]
    control_bf16 = one["fast bfloat16"][0]
    ctrl_flips, ctrl_top = _code_flips(control_bf16["codes"], ref32["codes"], ref32["presign"])
    ctrl_rel = {k: _rel_l2(control_bf16[k], ref32[k]) for k in images}
    counts = {}
    for tag in [f"fast {d}" for d in FAST_DTYPES] + ["hires float32"]:
        want, c_one = one[tag]
        counts[f"spatial paths: {tag}, one process"] = c_one
        stem = tag.replace(" ", "_") if tag.startswith("fast") else "hires"
        fp32 = tag.endswith("float32")
        lines = []
        for r in range(2):
            got = torch.load(work / f"{stem}_rank{r}.pt", weights_only=False)
            if "fast inference path enabled" not in got["text"] or "using the standard path" \
                    in got["text"]:
                raise AssertionError(f"{tag}, rank {r}: the fast path was not taken")
            m, w = got["metrics"], want["metrics"]
            # the coded rate follows the code bits
            rates = [k for k in ("actual_bpp", "sem_side_bpp", "base_codec_bpp", "n_images")
                     + (("coded_bpp", "total_bpp") if fp32 else ()) if m.get(k) is not None]
            if any(m[k] != w[k] for k in rates):
                raise AssertionError(f"{tag}, rank {r}: rates {m} against {w}")
            if fp32 and r == 0 and got["code_files"] != want["code_files"]:
                raise AssertionError(f"{tag}: the sharded code files differ from one process's")
            flips, top = 0, 0.0
            if "codes" in want:
                flips, top = _code_flips(got["codes"], want["codes"], ref32["presign"])
            if not top <= (1e-5 if fp32 else 2 * ctrl_top):
                raise AssertionError(f"{tag}, rank {r}: a code bit differs at |pre-sign| "
                                     f"{top:.2e}")
            if flips == 0 and got["streams"] != want["streams"]:
                raise AssertionError(f"{tag}, rank {r}: equal codes, different streams")
            err = {k: float(np.abs(got[k] - want[k]).max()) for k in images}
            rel = {k: _rel_l2(got[k], want[k]) for k in images}
            if fp32 and not max(err.values()) <= FP32_ATOL:
                raise AssertionError(f"{tag}, rank {r}: images {err} from one process's")
            if not fp32 and not all(rel[k] <= 2 * ctrl_rel[k] for k in images):
                raise AssertionError(f"{tag}, rank {r}: images {rel} (relative L2) from one "
                                     f"process's, its bf16 run {ctrl_rel} from its fp32 run")
            same = "byte-identical" if got["streams"] == want["streams"] else "differ"
            lines.append(f"rank {r}: coded {m.get('coded_bpp')} bpp, {flips} code bits differ "
                         f"(largest |pre-sign| {top:.2e}), streams {same}, reconstruction and "
                         f"decompressed stream {err['recon']:.2e} and {err['decompressed']:.2e} "
                         f"from one process's (relative L2 {rel['recon']:.2e}, "
                         f"{rel['decompressed']:.2e})")
        if not fp32:
            lines.append(f"the control, one process's bf16 run against its fp32 run: "
                         f"{ctrl_flips} code bits differ (largest |pre-sign| {ctrl_top:.2e}), "
                         f"images {ctrl_rel['recon']:.2e} and {ctrl_rel['decompressed']:.2e} "
                         f"apart (relative L2)")
        log(f"[spatial paths] {'(a)' if tag.startswith('fast') else '(c)'} test.main, "
            f"Trainer.get_code, compress, decompress and get_img through the fast path, {tag}, "
            f"spatial 2 against one process: coded {want['metrics'].get('coded_bpp')} bpp, "
            f"total {want['metrics'].get('total_bpp')} bpp; " + "; ".join(lines)
            + f"; launches one process { {k: v for k, v in c_one.items() if v} }, a rank none "
            f"({card})")
    return counts


# -- phase 16: the spatial axis at uneven heights ---------------------------------------
# CLIC's preprocessing ('none') rounds H to a multiple of 32: a 2048x1365 photo is read
# at 2048x1376 (32 x 43), whose deeper layers split unevenly over the ranks
UNEVEN_PHOTO_H = 1365
UNEVEN_H, UNEVEN_W = 1376, 2048
UNEVEN_RECON_TOL = 1e-4  # the sharded reconstruction against one process's, fp32, TF32 off
# K3's partial form a rank-step of the hires recipe unfrozen (as SPATIAL_K3_HIRES), and a
# rank's test.main of one image on the flagship's kernel-configuration standard path
UNEVEN_K3_TEST = {"instance_norm_stats": 65, "instance_norm_apply": 65}
UNEVEN_PATHS = ("fast", "kernel_standard")


def uneven_preprocess(cfg) -> None:
    """Every split read 'none' (CLIC's rule: H and W rounded to 32)."""
    for pp in (cfg.data.preprocess, cfg.data.val_preprocess, cfg.data.test_preprocess):
        pp.preprocess_mode, pp.load_size, pp.crop_size = "none", UNEVEN_W, UNEVEN_W
    cfg.validate()


def hires_uneven_config(seed: int, size: int):
    """The hires recipe's phase A in the kernel configuration, its batch of
    one 2048x1376 image ('fixed' at that aspect, so the trainer's batch and
    pool have its shape), at spatial ``size``."""
    cfg = flagship_train_config(True, seed, "hiresA")
    cfg.data.preprocess.aspect_ratio = UNEVEN_W / UNEVEN_H
    cfg.parallel.spatial_axis = size
    cfg.validate()
    return cfg


def phase16_setup(work: Path, seed: int) -> None:
    """The runs phase 16 evaluates, each on one synthetic 2048x1365
    triplet read 'none' to 2048x1376, random weights from the seed, an opt
    file for one process and one for the spatial group: (a) the hires
    recipe's serving configuration (fp32, the fast path) at spatial 2;
    (b) the flagship's default fast path and its kernel configuration's
    standard path (fp32) at spatial 4."""
    from jpdse_tpu_torch.config import flagship_config
    from jpdse_tpu_torch.models.codec import SemanticCodec
    from jpdse_tpu_torch.train.checkpoint import save_params

    for name, size in (("uneven_hires", 2), ("uneven_flagship", 4)):
        run = work / name
        root = run / "cityscapes"
        write_cityscapes(root, seed + 16, n=1, h=UNEVEN_PHOTO_H)
        paths = ({"fast": hires_configs()[0]} if name == "uneven_hires" else
                 {"fast": flagship_config(), "kernel_standard": flagship_config(kernels=True)})
        for path, cfg in paths.items():
            cfg.model.compute_dtype = "float32"
            cfg.model.fast_inference = path == "fast"
            uneven_preprocess(cfg)
            cfg.data.dataset, cfg.data.root_dir = "cityscapes", str(root)
            cfg.data.normalize_std = FLAGSHIP_NORMALIZE_STD
            cfg.data.num_workers, cfg.optim.seed = 1, seed
            for s in (size, 1):
                cfg.parallel.spatial_axis = s
                cfg.save(str(run / f"opt_float32_{path}_{s}.json"))
        save_params(str(run), SemanticCodec(cfg, device="cuda", seed=seed + 16,
                                            dtype=torch.float32).state_dict())


def _phase16_hires(rank: int, seed: int) -> dict:
    """(a) The hires recipe at 2048x1376 (its global trunk's fourth down 43
    rows: 21 / 22 over the two ranks), batch 1, kernel configuration, trunk
    unfrozen: one fp32 loss_and_grads (TF32 off) of each rank's 688 rows,
    K3's partial form counted a rank-step and every launch held against its
    plain version on the same uneven slab (K3PartialCheck), the metrics
    against one process's fp32 step (rank 0); then in float64 against one
    process within SPATIAL_F64_TOL, with the peak memory of one process and
    of a rank. Returns the counts."""
    from jpdse_tpu_torch.trainer import Trainer

    t0 = time.perf_counter()
    dp = Trainer(hires_uneven_config(seed, 2), mode="train", device="cuda:0")
    dp.gan.codec.netG.global_trunk.requires_grad_(True)
    batch = train_batch(dp.cfg, seed + 17)
    if batch["image"].shape[1:3] != (UNEVEN_H, UNEVEN_W):
        raise AssertionError(f"(a) the batch is {batch['image'].shape}")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    check = K3PartialCheck()
    t1 = time.perf_counter()
    with tf32_off(), check:
        (metrics, _), counts = counted_step(dp.gan, dp.place(batch), gen)
    dt_rank = time.perf_counter() - t1
    if {n: counts[n] for n in K3_PARTIAL} != SPATIAL_K3_HIRES["unfrozen"] or \
            counts["fused_instance_norm"] or counts["fused_instance_norm_bwd"]:
        raise AssertionError(f"(a) rank {rank}: launches {counts}")
    out = {f"uneven: hires 2048x1376, spatial 2, rank {rank}": counts}
    log(f"[uneven] (a) rank {rank}, hires recipe at 2048x1376, kernel configuration, trunk "
        f"unfrozen, fp32 (TF32 off): loss_and_grads of its 688 rows {dt_rank:.2f} s; K3 partial "
        f"a rank-step { {n: counts[n] for n in K3_PARTIAL} }; {check.summary()}")
    # every rank builds the twin: a Trainer under a process group broadcasts its weights
    twin = Trainer(hires_uneven_config(seed, 1), mode="train", device="cuda:0")
    twin.mesh = twin.gan.mesh = None
    twin.gan.codec.netG.global_trunk.requires_grad_(True)
    want = peak_one = None
    if rank == 0:
        with tf32_off():
            (m_one, _), _ = counted_step(twin.gan, twin.place(batch),
                                         torch.Generator(device="cuda").manual_seed(seed))
        rel = {k: abs(metrics[k].item() - m_one[k].item()) / max(abs(m_one[k].item()), 1e-12)
               for k in metrics}
        if not max(rel.values()) <= 1e-4:
            raise AssertionError(f"(a) the sharded fp32 step's metrics {rel} from one process's")
        log(f"[uneven] (a) fp32: the two ranks' metrics against one process's step, worst "
            f"{max(rel.values()):.2e} relative (tolerance 1e-4)")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        want, _ = f64_step(twin, batch, seed)
        peak_one = torch.cuda.max_memory_allocated() / 2**30
    del twin
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    got, _ = f64_step(dp, batch, seed)
    peak = torch.cuda.max_memory_allocated() / 2**30
    if rank == 0:
        worst = _hold_f64("(a) hires 2048x1376", dp.gan, got, want)
        log(f"[uneven] (a) hires recipe at 2048x1376, trunk unfrozen, float64, two gloo ranks "
            f"(688 rows each; 21 and 22 at the trunk's fourth down) against one process: every "
            f"gradient within {worst:.2e} (tolerance {SPATIAL_F64_TOL}); peak memory one process "
            f"{peak_one:.2f} GiB, a rank {peak:.2f} GiB (allocated by this process, the other "
            f"rank's beside it); {time.perf_counter() - t0:.1f} s in the ranks")
    del dp, got, want
    torch.cuda.empty_cache()
    return out


def _phase16_ranks(rank: int, seed: int, work: str) -> tuple:
    """Phase 16 (a) in phase 13's two ranks: _phase16_hires, then the hires
    recipe's test.main, codes, streams and reconstruction through the
    sharded fast path at 2048x1376 (spatial_fast_eval, saved for the
    parent). Returns (eval counts, train counts)."""
    t0 = time.perf_counter()
    train = _phase16_hires(rank, seed)
    res, counts = spatial_fast_eval(Path(work) / "uneven_hires", "opt_float32_fast_2.json",
                                    Path(work) / f"uneven_hires_rank{rank}")
    torch.save(res, os.path.join(work, f"uneven_hires_rank{rank}.pt"))
    log(f"[uneven] rank {rank}: phase 16 (a) in the ranks {time.perf_counter() - t0:.1f} s")
    return {f"uneven: hires fast path 2048x1376, spatial 2, rank {rank}": counts}, train


def phase16_check_hires(work: Path, one: tuple, rank_evals: dict, card: str) -> dict:
    """(a)'s sharded test.main against one process's: the rates equal, the
    code files and the streams byte-identical, the reconstruction and the
    decompressed stream within UNEVEN_RECON_TOL, no K1, K2 or K4 on a
    shard. Returns the one-process counts."""
    off = {tag: {k: v for k, v in c.items() if k in KERNELS_OFF_ON_A_SHARD and v}
           for tag, c in rank_evals.items()}
    if any(off.values()):
        raise AssertionError(f"(a) K1, K2 or K4 launched on a shard: {off}")
    want, c_one = one
    lines = []
    for r in range(2):
        got = torch.load(work / f"uneven_hires_rank{r}.pt", weights_only=False)
        if "fast inference path enabled" not in got["text"]:
            raise AssertionError(f"(a) rank {r}: the fast path was not taken")
        m, w = got["metrics"], want["metrics"]
        rates = [k for k in ("actual_bpp", "coded_bpp", "total_bpp", "sem_side_bpp",
                             "base_codec_bpp", "n_images") if w.get(k) is not None]
        if any(m[k] != w[k] for k in rates):
            raise AssertionError(f"(a) rank {r}: rates {m} against {w}")
        if got["code_files"] != want["code_files"] or got["streams"] != want["streams"]:
            raise AssertionError(f"(a) rank {r}: code files or streams differ from one process's")
        err = {k: float(np.abs(got[k] - want[k]).max()) for k in ("recon", "decompressed")}
        if not max(err.values()) <= UNEVEN_RECON_TOL:
            raise AssertionError(f"(a) rank {r}: images {err} from one process's")
        lines.append(f"rank {r}: streams byte-identical ({sum(map(len, got['streams']))} bytes), "
                     f"reconstruction {err['recon']:.2e} and decompressed stream "
                     f"{err['decompressed']:.2e} from one process's")
    log(f"[uneven] (a) the hires recipe's test.main, compress and decompress through the fast "
        f"path at 2048x1376 ('none'), fp32, spatial 2 against one process: total "
        f"{want['metrics'].get('total_bpp')} bpp on both; " + "; ".join(lines)
        + f" (tolerance {UNEVEN_RECON_TOL}); launches one process "
        f"{ {k: v for k, v in c_one.items() if v} }, a rank none ({card})")
    return {"uneven: hires fast path 2048x1376, one process": c_one}


def _phase16_rank(rank: int, port: int, work: str) -> None:
    """(b) One of four ranks at spatial_axis 4 on the one card (gloo): the
    flagship's test.main of the 2048x1376 triplet, then its codes, streams,
    decompressed stream and reconstruction (spatial_fast_eval), on its
    default fast path and on the kernel configuration's standard path,
    saved for the parent."""
    os.environ["LOCAL_RANK"] = "0"
    import torch.distributed as dist

    from jpdse_tpu_torch.ops.build import build_all
    from jpdse_tpu_torch.parallel import distributed

    build_all()  # loads the kernels the parent built
    distributed.initialize("cuda", f"localhost:{port}", 4, rank, backend="gloo")
    run = Path(work) / "uneven_flagship"
    ref = torch.load(os.path.join(work, "uneven_presign.pt"), weights_only=False)
    for path in UNEVEN_PATHS:
        opt = f"opt_float32_{path}_4.json"
        res, counts = spatial_fast_eval(run, opt, Path(work) / f"uneven_{path}_rank{rank}")
        if path == "kernel_standard":  # the decode on one process's code bits
            with tf32_off():
                res["pinned"] = spatial_eval_image(
                    spatial_eval_argv(run, Path(work) / f"uneven_pinned_rank{rank}", opt),
                    EvalSigns(ref))
        torch.save(dict(res, counts=counts), os.path.join(work, f"uneven_{path}_rank{rank}.pt"))
    distributed.barrier()
    dist.destroy_process_group()


def phase16_flagship(seed: int, work: Path, card: str) -> dict:
    """(b) The flagship over four gloo ranks at spatial_axis 4 (spawned) on
    one synthetic 2048x1365 triplet read 'none' to 2048x1376 (its fourth
    down's 86 rows: 21 / 22 / 21 / 22), on the default fast path and on
    the kernel configuration's standard path, fp32 with TF32 off, against
    the same runs in one process here: test.main's code files
    byte-identical, the rates equal, the codes equal (a bit may differ only
    at a pre-sign within 1e-5 of 0, where the ranks' partial K3 and one
    process's one-launch K3 and whole-tensor convolutions round apart; then
    the files differ by it, and a moved bit decodes a different image, so
    the decode is held on one process's code bits, EvalSigns), the streams
    byte-identical where the codes are, the reconstruction within
    UNEVEN_RECON_TOL; no K1, K2 or K4 on a shard; the standard path's K3
    partial launches a rank UNEVEN_K3_TEST. Returns the eval counts."""
    t0 = time.perf_counter()
    run = work / "uneven_flagship"
    # one process's standard-path pre-signs, whose code bits the ranks decode once more
    rec = EvalSigns()
    with tf32_off():
        pinned_one = spatial_eval_image(spatial_eval_argv(
            run, work / "uneven_pinned_one", "opt_float32_kernel_standard_1.json"), rec)
    torch.save([c.cpu() for c in rec.calls], work / "uneven_presign.pt")
    ctx = torch.multiprocessing.get_context("spawn")
    port = free_port()
    procs = [ctx.Process(target=_phase16_rank, args=(r, port, str(work))) for r in range(4)]
    for p in procs:
        p.start()
    one = {path: spatial_fast_eval(run, f"opt_float32_{path}_1.json", work / f"uneven_{path}_one",
                                   presign=True) for path in UNEVEN_PATHS}
    for p in procs:
        p.join(timeout=600)
    codes = [p.exitcode for p in procs]
    for p in procs:
        if p.is_alive():
            p.kill()
    if codes != [0, 0, 0, 0]:
        raise AssertionError(f"phase 16 (b): the four ranks exited with {codes}")
    counts = {}
    for path, (want, one_counts) in one.items():
        counts[f"uneven: flagship {path} 2048x1376, one process"] = one_counts
        lines = []
        for r in range(4):
            got = torch.load(work / f"uneven_{path}_rank{r}.pt", weights_only=False)
            counts[f"uneven: flagship {path} 2048x1376, spatial 4, rank {r}"] = got["counts"]
            off = {k: v for k, v in got["counts"].items() if k in KERNELS_OFF_ON_A_SHARD and v}
            partial = {k: v for k, v in got["counts"].items() if k in K3_PARTIAL and v}
            if off or partial != (UNEVEN_K3_TEST if path == "kernel_standard" else {}):
                raise AssertionError(f"(b) {path}, rank {r}: launches {got['counts']}")
            flips, top = _code_flips(got["codes"], want["codes"], want["presign"])
            err = {k: float(np.abs(got[k] - want[k]).max()) for k in ("recon", "decompressed")}
            if "pinned" in got:
                err["pinned"] = float(np.abs(got["pinned"] - pinned_one).max())
            # test.main writes on rank 0 alone
            files = got["code_files"] == (want["code_files"] if r == 0 else {})
            same = files and got["streams"] == want["streams"]
            lines.append(f"rank {r}: {flips} of {want['codes'].size} code bits differ (largest "
                         f"|pre-sign| {top:.2e}), code files and streams "
                         f"{'byte-identical' if same else 'differ'}, reconstruction "
                         f"{err['recon']:.2e} and decompressed stream {err['decompressed']:.2e} "
                         f"from one process's"
                         + (f", on one process's code bits {err['pinned']:.2e}" if "pinned" in err
                            else ""))
            m, w = got["metrics"], want["metrics"]
            rates = ("actual_bpp", "n_images") + (("coded_bpp", "total_bpp") if flips == 0 else ())
            bad = [k for k in rates if m[k] != w[k]]
            # a moved bit decodes a different image: then the decode is held on pinned bits
            held = err if flips == 0 else {k: v for k, v in err.items() if k == "pinned"}
            if bad or not top <= 1e-5 or (flips == 0 and not same) or not want["code_files"] \
                    or not held or not max(held.values()) <= UNEVEN_RECON_TOL:
                log(f"[uneven] (b) {path}: " + "; ".join(lines))
                raise AssertionError(f"(b) {path}, rank {r}: rates {bad} differ, or a code bit "
                                     f"at |pre-sign| {top:.2e}, or files or streams, or images "
                                     f"{err} (tolerance {UNEVEN_RECON_TOL})")
        log(f"[uneven] (b) the flagship's test.main, Trainer.get_code, compress, decompress and "
            f"get_img, {path.replace('_', ' ')} path, one 2048x1376 image ('none'), fp32, TF32 "
            f"off, four gloo ranks at spatial 4 (86 rows at the fourth down: 21/22/21/22) "
            f"against one process: coded {want['metrics']['coded_bpp']:.6f} bpp; "
            + "; ".join(lines) + f" (tolerance {UNEVEN_RECON_TOL}); launches a rank "
            f"{ {k: v for k, v in got['counts'].items() if v} }, one process "
            f"{ {k: v for k, v in one_counts.items() if v} } ({card})")
    log(f"[uneven] phase 16 (b) {time.perf_counter() - t0:.1f} s with the spawn ({card})")
    return counts


# -- phase 17: the measurement entry points ---------------------------------------------
RD_IMAGES = 2
RD_QUALITIES = "30,90"
SEG_STEPS = 20
SEG_SPLIT = (("train", 4), ("val", 2))
# the classes of the seg split's labels, by the photo's brightness band: learnable
SEG_CLASSES = np.array([7, 8, 11, 21, 23, 26], np.uint8)
SEM_WISE_K3 = 45  # K3 a reconstruction on the kernel configuration's standard path
RESCORE_TOL = 1e-9


def write_seg_split(root: Path, seed: int) -> None:
    """SEG_SPLIT's Cityscapes triplets at 2048x1024 from ``seed``, each
    label the class of its pixel's brightness band (SEG_CLASSES), so a
    network can learn it from the image."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    for split, n in SEG_SPLIT:
        for i in range(n):
            name = f"aachen_{i:06d}_000019"
            img_dir = root / "leftImg8bit" / split / "aachen"
            gt_dir = root / "gtFine" / split / "aachen"
            img_dir.mkdir(parents=True, exist_ok=True)
            gt_dir.mkdir(parents=True, exist_ok=True)
            photo, _, _ = synthetic_scene(rng, 1024, 2048)
            band = np.minimum(photo.astype(np.int32).mean(-1) * len(SEG_CLASSES) / 256.0,
                              len(SEG_CLASSES) - 1).astype(np.int64)
            Image.fromarray(photo).save(img_dir / f"{name}_leftImg8bit.png")
            Image.fromarray(SEG_CLASSES[band]).save(gt_dir / f"{name}_gtFine_labelIds.png")


def rescore_sem_wise(recons: list, mean, std, n_classes: int) -> dict:
    """The sem-wise JSON of (label, image, reconstruction) batches, again in
    float64 numpy: uint8 images as ops/metrics.py::denormalize_to_uint8
    makes them (float32), per-class sums by bincount."""
    from jpdse_tpu_torch.eval.sem_wise import summarize

    mean, std = np.asarray(mean, np.float32), np.asarray(std, np.float32)

    def u8(x):
        return np.floor(np.clip((x.astype(np.float32) * std + mean) * np.float32(255.0),
                                0, 255)).astype(np.float64)

    num, den, n = np.zeros(n_classes), np.zeros(n_classes), 0
    for label, image, recon in recons:
        lab = np.clip(label.astype(np.int64), 0, n_classes - 1).reshape(-1)
        num += np.bincount(lab, weights=np.abs(u8(image) - u8(recon)).sum(-1).reshape(-1),
                           minlength=n_classes)
        den += np.bincount(lab, minlength=n_classes)
        n += recon.shape[0]
    return summarize(num, den, n)


def counted_decodes():
    """A context in which every CodecServer.decode appends its K1 launches
    to the list it yields."""
    from jpdse_tpu_torch.ops import realign
    from jpdse_tpu_torch.serve import CodecServer

    per_call = []
    plain = CodecServer.decode

    def decode(self, batch):
        before = realign.s2d_realign_pad3.launches
        out = plain(self, batch)
        per_call.append(realign.s2d_realign_pad3.launches - before)
        return out

    @contextlib.contextmanager
    def ctx():
        CodecServer.decode = decode
        try:
            yield per_call
        finally:
            CodecServer.decode = plain

    return ctx()


def phase17_rd(root: Path, tmp: Path, seed: int, card: str) -> dict:
    """(a) eval/rd.py parity at the flagship's widths on both paths, and (d)
    its base mode on the same images. Returns each run's launch counts."""
    from jpdse_tpu_torch.eval import rd

    launches = {}
    n_points = RD_IMAGES * len(RD_QUALITIES.split(","))
    for fast in (False, True):
        label = "fast path" if fast else "standard path"
        argv = ["parity", "--root", str(root), "--ext", "jpg", "--qualities", RD_QUALITIES,
                "--n-images", str(RD_IMAGES), "--crop", "1024", "--seed", str(seed), "--out",
                str(tmp / f"rd_{label.split()[0]}.json")] + (["--fast"] if fast else [])
        reset_counts()
        t0 = time.perf_counter()
        with counted_decodes() as per_decode, contextlib.redirect_stdout(io.StringIO()) as out:
            try:
                res = rd.main(argv, device="cuda")
            except BaseException:
                sys.stdout.write(out.getvalue())
                raise
        seconds = time.perf_counter() - t0
        counts = read_counts()
        launches[f"rd parity, {label}"] = counts
        k1 = counts["s2d_realign_pad3"]
        others = {k: v for k, v in counts.items() if v and k != "s2d_realign_pad3"}
        if others or len(per_decode) != n_points or sum(per_decode) != k1:
            raise AssertionError(f"(a) {label}: launches {counts}, K1 by decode {per_decode}")
        if fast and not (per_decode[0] > 0 and len(set(per_decode)) == 1):
            raise AssertionError(f"(a) the fast decodes launched K1 {per_decode} times")
        if not fast and k1:
            raise AssertionError(f"(a) the standard path launched K1 {k1} times")
        for p in res["points"]:
            log(f"[measure] (a) rd parity, {label}, jpg q{p['quality']}: {p['n_images']} images "
                f"1024x512, bpp {p['bpp']:.6f}; PSNR {p['psnr_port']:.4f} port / "
                f"{p['psnr_torch']:.4f} golden dB (d {p['dpsnr']:.2e}), MS-SSIM "
                f"{p['msssim_port']:.6f} / {p['msssim_torch']:.6f} (d {p['dmsssim']:.2e}), L1 "
                f"{p['l1_port']:.4f} / {p['l1_torch']:.4f} [{p['verdict']}]; ms an image "
                f"{p['ms_port']:.2f} port, {p['ms_torch']:.2f} golden (host clock, synced, fp32, "
                f"TF32 off) ({card})")
        if not res["ok"]:
            raise AssertionError(f"(a) {label}: a point failed the parity bar: {res['points']}")
        log(f"[measure] (a) rd parity, {label}: every point OK, preprocessing bit-exact on "
            f"{n_points} images; K1 a decode {per_decode}; the first point's ms hold each "
            f"stack's first decode; {seconds:.1f} s ({card})")

    reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        res = rd.main(["base", "--root", str(root), "--mode", "val", "--ext", "jpg",
                       "--qualities", RD_QUALITIES, "--out", str(tmp / "base.json")],
                      device="cuda")
    counts = read_counts()
    launches["rd base"] = counts
    rows = res["rows"]
    if (res["images"] != RD_IMAGES or any(counts.values())
            or not np.isfinite([r[k] for r in rows for k in ("bpp", "psnr", "msssim", "l1")]).all()
            or not (rows[1]["bpp"] > rows[0]["bpp"] and rows[1]["psnr"] > rows[0]["psnr"])):
        raise AssertionError(f"(d) rd base: {res}, launches {counts}")
    for r in rows:
        log(f"[measure] (d) rd base, jpg q{r['quality']} alone over {res['images']} images "
            f"1024x512: bpp {r['bpp']:.6f}, PSNR {r['psnr']:.4f} dB, MS-SSIM {r['msssim']:.6f}, "
            f"L1 {r['l1']:.4f} ({card})")
    log(f"[measure] (d) rd base: {time.perf_counter() - t0:.1f} s ({card})")
    return launches


def phase17_seg_vgg(tmp: Path, seed: int, card: str) -> dict:
    """(b) train/seg_vgg.py: SEG_STEPS steps at batch 2 on 512 crops, the
    export reloaded two ways."""
    from jpdse_tpu_torch.config import flagship_config
    from jpdse_tpu_torch.models.vgg import init_vgg19
    from jpdse_tpu_torch.train import seg_vgg
    from jpdse_tpu_torch.trainer import Trainer

    root = tmp / "seg"
    write_seg_split(root, seed + 171)
    argv = ["--root", str(root), "--out", str(tmp / "seg_out"), "--steps", str(SEG_STEPS),
            "--batch", "2", "--crop", "512", "--seed", str(seed)]
    reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        res = seg_vgg.main(argv, device="cuda")
    seconds = time.perf_counter() - t0
    counts = read_counts()
    losses = res["losses"]
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]) or any(counts.values()):
        raise AssertionError(f"(b) seg VGG: CE {losses}, launches {counts}")
    trunk = res["model"].trunk.state_dict()
    loaded = init_vgg19("cuda", None, res["out_path"]).state_dict()
    cfg = flagship_config(tiny=True)
    cfg.loss.vgg_weights_path = res["out_path"]
    with contextlib.redirect_stdout(io.StringIO()):
        via_trainer = Trainer(cfg, mode="train", device="cuda").gan.vgg.state_dict()
    for what, state in (("init_vgg19", loaded), ("--vgg_weights_path", via_trainer)):
        if set(state) != set(trunk) or not all(torch.equal(state[k], trunk[k]) for k in trunk):
            raise AssertionError(f"(b) the export reloaded through {what} differs from the "
                                 f"trained trunk")
    step_ms = res["step_ms"]
    log(f"[measure] (b) seg VGG: {SEG_STEPS} steps at batch 2 on 512 crops of "
        f"{SEG_SPLIT[0][1]} images 1024x512, CE {losses[0]:.4f} -> {losses[-1]:.4f}; "
        f"held-out pixel accuracy (1/16) {res['heldout_pixel_acc']:.4f} on {SEG_SPLIT[1][1]}; "
        f"step ms (host clock, loss fetched) first {step_ms[0]:.1f}, median of the rest "
        f"{np.median(step_ms[1:]):.2f}; the export bit-equal to the trunk through init_vgg19 "
        f"and --vgg_weights_path; {seconds:.1f} s ({card})")
    return {"seg vgg": counts}


def phase17_sem_wise(root: Path, tmp: Path, seed: int, card: str) -> dict:
    """(c) eval/sem_wise.py on a seeded flagship-width checkpoint in the
    kernel configuration's standard path."""
    from jpdse_tpu_torch.config import flagship_config
    from jpdse_tpu_torch.eval import sem_wise
    from jpdse_tpu_torch.models.codec import SemanticCodec
    from jpdse_tpu_torch.train.checkpoint import save_params

    run = tmp / "sem_wise_run"
    run.mkdir()
    cfg = flagship_config(kernels=True)
    cfg.model.fast_inference = False
    mode, load, crop, aspect = FLAGSHIP_PREPROCESS
    for pp in (cfg.data.preprocess, cfg.data.val_preprocess, cfg.data.test_preprocess):
        pp.preprocess_mode, pp.load_size, pp.crop_size = mode, load, crop
        pp.aspect_ratio = aspect
    cfg.data.dataset, cfg.data.root_dir = "cityscapes", str(root)
    cfg.data.normalize_std = FLAGSHIP_NORMALIZE_STD
    cfg.data.num_workers, cfg.optim.seed = 2, seed
    cfg.save(str(run / "opt.json"))
    save_params(str(run), SemanticCodec(cfg, device="cuda", seed=seed + 17).state_dict())
    recons = []
    argv = ["--opt_file", str(run / "opt.json"), "--checkpoints_dir", str(run), "--root_dir",
            str(root), "--mode", "val", "--out", str(tmp / "sem_wise.json")]
    res, _, counts = run_entry(
        "kernel-config standard path", "eval.sem_wise",
        lambda: sem_wise.main(argv, device="cuda", recons=recons),
        {"fused_instance_norm": SEM_WISE_K3}, per=RD_IMAGES, tag="[measure] (c)")
    again = rescore_sem_wise(recons, cfg.data.normalize_mean, cfg.data.normalize_std,
                             cfg.data.semantic_nc)
    worst = abs(again["overall_l1_uint8"] - res["overall_l1_uint8"])
    if again["n_images"] != res["n_images"] or len(again["per_class"]) != len(res["per_class"]):
        raise AssertionError(f"(c) re-scored {again} against {res}")
    for a, b in zip(again["per_class"], res["per_class"]):
        if a["class_id"] != b["class_id"] or a["pixel_share"] != b["pixel_share"]:
            raise AssertionError(f"(c) class rows differ: {a} re-scored, {b} returned")
        worst = max(worst, abs(a["l1_uint8"] - b["l1_uint8"]))
    if not worst <= RESCORE_TOL or res["n_images"] != RD_IMAGES:
        raise AssertionError(f"(c) the JSON is {worst:.2e} from its float64 re-scoring")
    top = sorted(res["per_class"], key=lambda r: -r["pixel_share"])[:3]
    log(f"[measure] (c) sem-wise eval of {res['n_images']} images: {len(res['per_class'])} "
        f"classes, overall L1 {res['overall_l1_uint8']:.4f} (uint8 levels), e.g. "
        + ", ".join(f"{r['name']} {r['l1_uint8']:.3f} ({r['pixel_share']:.3f})" for r in top)
        + f"; the JSON within {worst:.1e} of its float64 numpy re-scoring (tolerance "
        f"{RESCORE_TOL}); K3 {counts['fused_instance_norm']} launches ({card})")
    return {"sem-wise eval": counts}


def phase17(seed: int, card: str) -> dict:
    """Phase 17, the measurement entry points on the card. Returns each
    run's launch counts."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="jpdse_measure_") as work:
        tmp = Path(work)
        root = tmp / "cityscapes"
        write_cityscapes(root, seed + 17, n=RD_IMAGES)
        launches = phase17_rd(root, tmp, seed, card)
        torch.cuda.empty_cache()
        launches.update(phase17_seg_vgg(tmp, seed, card))
        torch.cuda.empty_cache()
        launches.update(phase17_sem_wise(root, tmp, seed, card))
    log(f"[measure] measurement phase {time.perf_counter() - t0:.1f} s ({card})")
    return launches


# -- phase 18 (--cards 4): the parallel axes across four cards on NCCL -----------------
CARDS = 4
CARDS_TIMED_STEPS = 3  # host-clock steps a set, after one untimed
CARDS_JOIN_S = 480  # the ranks' joins, after which a rank still running is killed
CARDS_ENTRY_S = 300  # a torchrun launch of (d), after which its process group is killed
CARDS_LAYOUTS = {"data 4": 1, "data 2 x spatial 2": 2}  # layout -> spatial_axis
DATA_K3 = {"fused_instance_norm": 2 * K3_SITES[2], "fused_instance_norm_bwd": K3_SITES[2]}
CARDS_K3 = ("fused_instance_norm", "fused_instance_norm_bwd") + K3_PARTIAL


def topology() -> str:
    """What the card's machine says of its interconnect: ``nvidia-smi topo
    -m`` (or why it says nothing), the NVLink state of card 0 and which
    card pairs CUDA can map peer to peer."""
    lines = []
    for cmd in (["nvidia-smi", "topo", "-m"], ["nvidia-smi", "nvlink", "--status", "-i", "0"]):
        out = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
        text = (out.stdout + out.stderr).strip() or f"(no output, exit {out.returncode})"
        lines.append(f"$ {' '.join(cmd)}\n{text}")
    n = torch.cuda.device_count()
    peer = [[i == j or torch.cuda.can_device_access_peer(i, j) for j in range(n)]
            for i in range(n)]
    lines.append("peer access (torch.cuda.can_device_access_peer): "
                 + "; ".join(f"{i}: " + "".join("1" if p else "0" for p in row)
                             for i, row in enumerate(peer)))
    return "\n".join(lines)


def hold_layout(rank: int, s: int, seed: int, device: torch.device, tiny: bool = False,
                tag: str = "[cards]") -> dict:
    """One step of the phase-2 recipe in the kernel configuration on the
    process group's ranks at spatial_axis ``s``, one image a spatial
    group, held against one process's step on the global batch (the twin,
    stepped on rank 0's device): phase 7 (a)'s rule with two controls and
    the float64 arbiter, every run on the twin's code bits; the ranks'
    uniforms, gathered, bit-equal to the twin's draws; on a card K3 (or its
    partial form) launched as many times as the layout asks, each launch
    against its plain version; the all-reduced gradients and metrics
    bit-identical on every rank, and so the parameters after
    ``step.apply``. Phase 12 (b) and phase 18 (a), (b)."""
    import torch.distributed as dist

    from jpdse_tpu_torch.parallel import distributed, spatial
    from jpdse_tpu_torch.train import step
    from jpdse_tpu_torch.trainer import Trainer

    world = distributed.world()
    n_data = world // s
    layout = f"data {n_data}" + (f" x spatial {s}" if s > 1 else "")
    ranks = f"{world} ranks"
    t0 = time.perf_counter()
    cfg = flagship_train_config(True, seed, tiny=tiny)
    cfg.data.batch_size, cfg.parallel.spatial_axis = 1, s
    dp = Trainer(cfg, mode="train", device=device)
    whole = flagship_train_config(True, seed, tiny=tiny)
    whole.data.batch_size = n_data
    twin = Trainer(whole, mode="train", device=device)  # every rank joins its broadcast
    twin.mesh = twin.gan.mesh = None  # the same weights, stepped as one process
    m = dp.mesh
    if (m.world, m.n_data, m.spatial) != (world, n_data, s):
        raise AssertionError(f"rank {rank}: the mesh is {m}, want {layout}")
    batch = train_batch(whole, seed)
    rows = {k: v[m.rows(1)] for k, v in batch.items()}
    shard = m.shard(batch["image"].shape[1])

    def mine(t):  # this rank's batch rows and H rows of a global tensor
        t = t[m.rows(1)]
        return t if shard is None else t[:, m.h_rows(t.shape[1])]

    def whole_of(t):  # the ranks' rows of a tensor gathered to the global one
        return m.gather_rows(t if shard is None else spatial.gather_rows(t, shard))

    what = f"phase-2 recipe, {layout}, {ranks}"
    if rank == 0:
        hg = batch["image"].shape[1]
        log(f"{tag} {layout}: global batch {n_data}, rank 0's rows "
            f"{m.h_rows(hg).start}-{m.h_rows(hg).stop} of {hg}; trainers built in "
            f"{time.perf_counter() - t0:.1f} s ({device})")
    out, pre, out64 = {}, {}, {}
    with tf32_off():
        with torch.no_grad():  # the twin's pre-signs' shapes, then rank 0's values
            ref = twin.gan.codec.get_presign(twin.gan.codec.prepare(twin.place(batch)))
        if rank == 0:
            gen = torch.Generator(device=device).manual_seed(seed)
            with PinnedSigns() as rec:
                out["one process"], _ = counted_step(twin.gan, twin.place(batch), gen)
            ref, single_draws = rec.calls, rec.draws
        distributed.broadcast_(ref)
        gen = torch.Generator(device=device).manual_seed(seed)
        check = contextlib.nullcontext()
        if device.type == "cuda":  # every launch against its plain version on its inputs
            check = K3SiteCheck() if s == 1 else K3PartialCheck()
        spatial.traffic.update(calls=0, bytes=0)
        t1 = time.perf_counter()
        with PinnedSigns([mine(r) for r in ref]) as rec, check:
            out[ranks], counts = counted_step(dp.gan, dp.place(rows), gen)
        seconds = time.perf_counter() - t1
        traffic = dict(spatial.traffic)
        want = {} if device.type != "cuda" else DATA_K3 if s == 1 else SPATIAL_K3
        if {n: counts[n] for n in CARDS_K3} != {n: want.get(n, 0) for n in CARDS_K3}:
            raise AssertionError(f"rank {rank}, {what}: launches {counts}, want {want}")
        log(f"{tag} rank {rank}, {what}: loss_and_grads of its share {seconds:.2f} s (fp32, "
            f"TF32 off, the exchanges and the gradient all-reduce over {dist.get_backend()} "
            "included); "
            f"{traffic['calls']} all-reduces over the spatial group "
            f"({traffic['bytes'] / 2**20:.1f} MiB); K3 launches "
            f"{ {n: counts[n] for n in CARDS_K3 if counts[n]} }"
            + (f"; {check.summary()}" if device.type == "cuda" else ""))
        pre[ranks] = [whole_of(x) for x in rec.calls]
        draws = [whole_of(u) for u in rec.draws]
        ref64 = [r.double() for r in ref]
        if rank == 0:
            out64["one process"], ref64 = f64_step(twin, batch, seed)
        distributed.broadcast_(ref64)
        out64[ranks], _ = f64_step(dp, rows, seed, [mine(r) for r in ref64])
        if rank == 0:
            if not all(torch.equal(a, b) for a, b in zip(draws, single_draws)):
                raise AssertionError(f"{what}: the ranks' uniforms are not the global draws' rows")
            for i, b in enumerate(perturbed(batch, seed)):
                gen = torch.Generator(device=device).manual_seed(seed)
                with PinnedSigns(ref) as rec:
                    out[f"control {i + 1}"], _ = counted_step(twin.gan, twin.place(b), gen)
                pre[f"control {i + 1}"] = rec.calls
            pinned_bits(what, ref, pre)
            hold_step(what, out, None, (twin.gan.codec, twin.gan.disc), seed, "one process",
                      ranks, out64)
            log(f"{tag} {what}: the ranks' {sum(u.numel() for u in draws)} binarizer uniforms, "
                "gathered, bit-equal to one process's on the global batch")
    metrics, grads = out[ranks]
    stacked = torch.stack([metrics[k] for k in step.METRICS])
    _same_on_every_rank(what, list(grads[0]) + list(grads[1]) + [stacked],
                        "all-reduced gradients and metrics")
    step.apply(dp.gan, grads)
    _same_on_every_rank(what, list(dp.gan.codec.parameters()) + list(dp.gan.disc.parameters()))
    n_bytes = sum(g.numel() * g.element_size() for g in grads[0] + grads[1])
    if rank == 0:
        log(f"{tag} {what}: the all-reduce of {n_bytes / 2**20:.1f} MiB of gradients and the "
            f"{len(step.METRICS)} metrics bit-identical on every rank, and the parameters after "
            "step.apply")
    del dp, twin, out, out64
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return {"counts": counts, "traffic": traffic, "grad_mib": n_bytes / 2**20,
            "seconds": seconds}


def _cards_eval(rank: int, work: Path) -> dict:
    """(c) test.main sharded over one spatial group of the four ranks (the
    run's opt4.json: spatial_axis 4), then the first image's
    reconstruction (rank 0 keeps it)."""
    metrics, counts, image = spatial_eval(
        spatial_eval_argv(work / "eval", work / f"rank{rank}", "opt4.json"), f"rank {rank}",
        "[cards] (c)")
    if rank == 0:
        np.save(work / "rank0_image.npy", image)
    return {"metrics": metrics, "counts": counts}


@contextlib.contextmanager
def comm_events(device: torch.device):
    """While active, CUDA events on the current stream around each gradient
    all-reduce (``distributed.all_reduce_mean_``) and each spatial exchange
    or reduction (``SpatialShard.all_reduce_``); yields a dict whose
    ``"ms"`` callable sums their times, read after a synchronize."""
    from jpdse_tpu_torch.parallel import distributed, spatial

    pairs = {"gradient all-reduce": [], "spatial all-reduces": []}
    reduce_mean, shard_reduce = distributed.all_reduce_mean_, spatial.SpatialShard.all_reduce_

    def timed(kind, fn):
        def run(*args, **kwargs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record(torch.cuda.current_stream(device))
            out = fn(*args, **kwargs)
            end.record(torch.cuda.current_stream(device))
            pairs[kind].append((start, end))
            return out
        return run

    distributed.all_reduce_mean_ = timed("gradient all-reduce", reduce_mean)
    spatial.SpatialShard.all_reduce_ = timed("spatial all-reduces", shard_reduce)
    try:
        yield {"ms": lambda: {k: sum(a.elapsed_time(b) for a, b in v) for k, v in pairs.items()},
               "calls": lambda: {k: len(v) for k, v in pairs.items()}}
    finally:
        distributed.all_reduce_mean_, spatial.SpatialShard.all_reduce_ = reduce_mean, shard_reduce


def _timed_set(trainer, placed: dict, device: torch.device) -> list:
    """CARDS_TIMED_STEPS Trainer.steps after one untimed, each by the host
    clock up to a synchronize: their ms."""
    trainer.step(placed)
    times = []
    for _ in range(CARDS_TIMED_STEPS):
        sync(device)
        t0 = time.perf_counter()
        trainer.step(placed)
        sync(device)
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def _cards_timings(rank: int, seed: int, device: torch.device, card: str) -> list:
    """(e) For each layout and each configuration, the phase-2 recipe at
    batch 2 a card (TF32 convolutions, as PyTorch trains): steps timed by
    the host clock in the order one card (rank 0's card, the others
    waiting at a barrier), four cards, four cards, one card; one more
    four-card step with CUDA events around the gradient all-reduce and the
    spatial all-reduces; images/s, the scaling efficiency, and each card's
    peak memory over its four-card steps (card 0's with the one-card
    trainer's state beside it). Returns rank 0's rows."""
    from jpdse_tpu_torch.parallel import distributed, spatial
    from jpdse_tpu_torch.trainer import Trainer

    rows_out = []
    for layout, s in CARDS_LAYOUTS.items():
        for kernels in (True, False):
            label = f"{layout}, {'kernel' if kernels else 'default'} configuration"
            n_data = CARDS // s
            cfg = flagship_train_config(kernels, seed)
            cfg.parallel.spatial_axis = s  # batch 2 a spatial group: 2 images a card's rows
            dp = Trainer(cfg, mode="train", device=device)
            one = Trainer(flagship_train_config(kernels, seed), mode="train", device=device)
            one.mesh = one.gan.mesh = None  # rank 0's one-card trainer (all joined its broadcast)
            if rank:
                one = None
                torch.cuda.empty_cache()
            whole = flagship_train_config(kernels, seed)
            whole.data.batch_size = TRAIN_BATCH * n_data
            batch = train_batch(whole, seed + 18)
            placed = dp.place({k: v[dp.mesh.rows(TRAIN_BATCH)] for k, v in batch.items()})
            placed_one = one and one.place({k: v[:TRAIN_BATCH] for k, v in batch.items()})
            times = {"one card": [], "four cards": []}
            peak = 0
            for which in ("one card", "four cards", "four cards", "one card"):
                if which == "one card":
                    if rank == 0:
                        times[which] += _timed_set(one, placed_one, device)
                    distributed.barrier()
                    continue
                torch.cuda.reset_peak_memory_stats(device)
                times[which] += _timed_set(dp, placed, device)
                peak = max(peak, torch.cuda.max_memory_allocated(device))
            spatial.traffic.update(calls=0, bytes=0)
            sync(device)
            with comm_events(device) as ev:
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                dp.step(placed)
                end.record()
                sync(device)
            comm, calls, step_ms = ev["ms"](), ev["calls"](), start.elapsed_time(end)
            traffic = dict(spatial.traffic)
            peaks = distributed.all_gather_rows(
                torch.tensor([[peak / 2**30]], dtype=torch.float64, device=device))
            if rank == 0:
                one_ms, four_ms = np.median(times["one card"]), np.median(times["four cards"])
                ips_one, ips_four = TRAIN_BATCH / one_ms * 1e3, TRAIN_BATCH * n_data / four_ms * 1e3
                row = {"layout": layout, "kernels": kernels, "one_card_ms": times["one card"],
                       "four_cards_ms": times["four cards"], "one_card_images_s": ips_one,
                       "four_cards_images_s": ips_four, "efficiency": ips_four / (CARDS * ips_one),
                       "events_step_ms": step_ms, "comm_ms": comm, "comm_calls": calls,
                       "spatial_mib": traffic["bytes"] / 2**20, "spatial_calls": traffic["calls"],
                       "peak_gib": peaks.flatten().tolist()}
                rows_out.append(row)
                log(f"[cards] (e) {label}: one card (batch {TRAIN_BATCH}) "
                    f"{' '.join(f'{t:.1f}' for t in times['one card'])} ms, median {one_ms:.1f} ms, "
                    f"{ips_one:.3f} images/s; four cards (batch {TRAIN_BATCH} a card's rows, "
                    f"global {TRAIN_BATCH * n_data}) {' '.join(f'{t:.1f}' for t in times['four cards'])}"
                    f" ms, median {four_ms:.1f} ms, {ips_four:.3f} images/s; scaling efficiency "
                    f"{row['efficiency']:.3f}; one four-card step by CUDA events {step_ms:.1f} ms, "
                    f"of it the gradient all-reduce {comm['gradient all-reduce']:.2f} ms "
                    f"({comm['gradient all-reduce'] / step_ms:.1%}, {calls['gradient all-reduce']} "
                    f"call) and the spatial all-reduces {comm['spatial all-reduces']:.2f} ms "
                    f"({comm['spatial all-reduces'] / step_ms:.1%}, {traffic['calls']} calls, "
                    f"{traffic['bytes'] / 2**20:.1f} MiB a rank); peak memory a card "
                    f"{', '.join(f'{p:.2f}' for p in row['peak_gib'])} GiB ({card})")
            del dp, one, placed, placed_one
            torch.cuda.empty_cache()
    return rows_out


def multicard_rank(rank: int, port: int, seed: int, work: str, device: str, backend: str,
                   tiny: bool = False, legs: str = "abce", card: str = "") -> None:
    """Phase 18's rank ``rank`` of four, on ``device`` (``cuda:rank`` on the
    card's machine, or the CPU for a rehearsal) over ``backend``: legs (a)
    data 4 and (b) data 2 x spatial 2, held against one process
    (hold_layout); (c) test.main at spatial 4 (_cards_eval); (e) the
    timings (_cards_timings). Writes its results to ``work/rank{rank}.pt``."""
    os.environ["LOCAL_RANK"] = str(rank)
    import torch.distributed as dist

    from jpdse_tpu_torch.parallel import distributed

    dev = torch.device(device)
    if dev.type == "cuda":
        from jpdse_tpu_torch.ops.build import build_all

        build_all()  # loads the kernels the parent built
    distributed.initialize(dev.type, f"localhost:{port}", CARDS, rank, backend=backend)
    try:
        if dist.get_backend() != backend or distributed.world() != CARDS:
            raise AssertionError(f"rank {rank}: a {dist.get_backend()} group of "
                                 f"{distributed.world()}, want {backend} of {CARDS}")
        if dev.type == "cuda" and torch.cuda.current_device() != dev.index:
            raise AssertionError(f"rank {rank} drives card {torch.cuda.current_device()}, "
                                 f"want {dev}")
        result = {"backend": dist.get_backend(), "device": str(dev)}
        for leg, s in (("a", 1), ("b", 2)):
            if leg in legs:
                result[leg] = hold_layout(rank, s, seed, dev, tiny)
        if "c" in legs:
            result["c"] = _cards_eval(rank, Path(work))
        if "e" in legs:
            result["e"] = _cards_timings(rank, seed, dev, card)
        torch.save(result, os.path.join(work, f"rank{rank}.pt"))
        distributed.barrier()
    finally:
        dist.destroy_process_group()


def sharded_eval_setup(run: Path, seed: int, offset: int, spatial_axis: int, opt: str) -> None:
    """The run of phases 13 (b) and 18 (c): SPATIAL_EVAL_IMAGES synthetic
    2048x1024 triplets read 'fixed' to 1024x512 (from ``seed + offset``),
    the kernel configuration's standard path in fp32, its opt.json at
    spatial_axis 1 (opt1.json) and at ``spatial_axis`` (``opt``), and a
    codec's params_g.pt seeded ``seed + offset``."""
    from jpdse_tpu_torch.config import flagship_config
    from jpdse_tpu_torch.models.codec import SemanticCodec
    from jpdse_tpu_torch.train.checkpoint import save_params

    root = run / "cityscapes"
    write_cityscapes(root, seed + offset, n=SPATIAL_EVAL_IMAGES)
    cfg = flagship_config(kernels=True)
    cfg.model.compute_dtype, cfg.model.fast_inference = "float32", False
    mode, load, crop, aspect = FLAGSHIP_PREPROCESS
    for pp in (cfg.data.preprocess, cfg.data.val_preprocess, cfg.data.test_preprocess):
        pp.preprocess_mode, pp.load_size, pp.crop_size = mode, load, crop
        pp.aspect_ratio = aspect
    cfg.data.dataset, cfg.data.root_dir = "cityscapes", str(root)
    cfg.data.normalize_std = FLAGSHIP_NORMALIZE_STD
    cfg.data.num_workers, cfg.optim.seed = 1, seed
    cfg.save(str(run / "opt1.json"))
    cfg.parallel.spatial_axis = spatial_axis
    cfg.save(str(run / opt))
    save_params(str(run), SemanticCodec(flagship_config(kernels=True), device="cuda",
                                        seed=seed + offset).state_dict())


def check_sharded_eval(work: Path, one: tuple, rank_evals: list, tag: str, card: str) -> None:
    """A sharded test.main (each rank's metrics and launch counts; rank 0's
    first image in ``work/rank0_image.npy``, its code files under
    ``work/rank0``) against one process's (metrics, counts, image; code
    files under ``work/single``): rank 0's code files bit-equal and no
    other rank's, the rates equal on every rank, the reconstruction within
    FP32_ATOL, K3's partial stats and apply SPATIAL_EVAL_K3 a rank."""
    one_metrics, one_counts, one_image = one
    rc_one = {p.name: p.read_bytes() for p in (work / "single" / "codes").glob("*")}
    rc_sharded = {p.name: p.read_bytes() for p in (work / "rank0" / "codes").glob("*")}
    if not rc_one or rc_sharded != rc_one:
        raise AssertionError(f"{tag} the sharded test.main's code files differ from one "
                             f"process's: {sorted(rc_sharded)} vs {sorted(rc_one)}")
    want = {k: v * SPATIAL_EVAL_IMAGES for k, v in SPATIAL_EVAL_K3.items()}
    for r, res in enumerate(rank_evals):
        codes = work / f"rank{r}" / "codes"
        if r and codes.exists() and any(codes.iterdir()):
            raise AssertionError(f"{tag} rank {r} wrote code files")
        for k in ("actual_bpp", "coded_bpp", "total_bpp", "n_images"):
            if res["metrics"][k] != one_metrics[k]:
                raise AssertionError(f"{tag} rank {r}: {k} {res['metrics'][k]} sharded, "
                                     f"{one_metrics[k]} one process")
        got = {k: v for k, v in res["counts"].items() if v}
        if got != want:
            raise AssertionError(f"{tag} rank {r}'s test.main launched {got}, want {want}")
    err = float(np.abs(np.load(work / "rank0_image.npy") - one_image).max())
    if not err <= FP32_ATOL:
        raise AssertionError(f"{tag} the sharded reconstruction is {err:.2e} from one process's")
    m = rank_evals[0]["metrics"]
    log(f"{tag} test.main of {SPATIAL_EVAL_IMAGES} 2048x1024 triplet(s) read 'fixed' to "
        f"1024x512, kernel configuration, fp32, TF32 off, spatial {len(rank_evals)} against one "
        f"process: {len(rc_one)} code files bit-equal ({sum(map(len, rc_one.values()))} "
        f"bytes), coded {m['coded_bpp']:.6f} bpp on every rank, PSNR {m['PSNR']:.4f} / "
        f"{one_metrics['PSNR']:.4f} dB, reconstruction within {err:.2e} (tolerance "
        f"{FP32_ATOL}); launches a rank {want}, one process "
        f"{ {k: v for k, v in one_counts.items() if v} } ({card})")


def torchrun(argv: list, log_path: Path, timeout_s: float = CARDS_ENTRY_S) -> str:
    """``python -m torch.distributed.run --nproc_per_node 4`` of ``argv``
    (a module's or a script's), its output kept in ``log_path``; the whole
    process group killed after ``timeout_s``. Returns the output; raises
    unless it exits with 0."""
    import signal

    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", str(CARDS),
           "--master_addr", "localhost", "--master_port", str(free_port())] + argv
    with open(log_path, "w") as f:
        proc = subprocess.Popen(cmd, stdout=f, stderr=subprocess.STDOUT, start_new_session=True,
                                cwd=Path(__file__).resolve().parent)
        try:
            code = proc.wait(timeout=timeout_s)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
            code = "killed after its time limit"
    text = log_path.read_text()
    if code != 0:
        sys.stdout.write(text[-20000:])
        raise AssertionError(f"(d) {' '.join(argv[:2])} across four cards exited with {code}")
    return text


def resume_rank(work: Path, argv: list) -> int:
    """(d)'s resumed run, one rank of it under torchrun: train.run.main
    with its epoch loop's first call held: the restored parameters and
    Adam moments bit-equal to the files under save_dir/latest and to rank
    0's, the epoch and step count they name. Writes what it saw to
    ``work/resume_rank{rank}.json``."""
    import torch.distributed as dist

    from jpdse_tpu_torch.parallel import distributed
    from jpdse_tpu_torch.train import run
    from jpdse_tpu_torch.train.checkpoint import OPT_FILE, PARAMS_D_FILE, PARAMS_FILE

    seen = {}
    epoch_loop = run.run_epoch

    def first_epoch(trainer, loader, cfg, epoch, *args):
        if not seen:
            gan, latest = trainer.gan, Path(cfg.save_dir) / "latest"
            own = {PARAMS_FILE: gan.codec.state_dict(), PARAMS_D_FILE: gan.disc.state_dict()}
            files = {k: torch.load(latest / k, map_location="cpu", weights_only=True)
                     for k in own}
            opt = torch.load(latest / OPT_FILE, map_location="cpu", weights_only=True)
            adam_equal = all(
                torch.equal(torch.as_tensor(v).cpu(), torch.as_tensor(opt[name]["state"][i][k]))
                for name, o in (("opt_g", gan.opt_g), ("opt_d", gan.opt_d))
                for i, st in o.state_dict()["state"].items() for k, v in st.items())
            tensors = [t for sd in own.values() for t in sd.values()]
            theirs = [t.detach().clone() for t in tensors]
            distributed.broadcast_(theirs)
            seen.update(
                rank=distributed.rank(), device=str(trainer.device), backend=dist.get_backend(),
                epoch=epoch, steps=trainer.steps_taken, adam_equal=adam_equal,
                files_equal=all(own[k].keys() == files[k].keys() and all(
                    torch.equal(v.cpu(), files[k][n]) for n, v in own[k].items()) for k in own),
                rank0_equal=all(torch.equal(a, b) for a, b in zip(theirs, tensors)))
        return epoch_loop(trainer, loader, cfg, epoch, *args)

    run.run_epoch = first_epoch
    trainer = run.main(argv)
    seen["steps_after"] = trainer.steps_taken
    (work / f"resume_rank{seen['rank']}.json").write_text(json.dumps(seen))
    dist.destroy_process_group()
    return 0


def cards_entry(work: Path, seed: int, card: str) -> None:
    """(d) train.run.main across the four cards at spatial_axis 2 (data 2 x
    spatial 2, batch 1 a spatial group), in the kernel configuration, on a
    synthetic Cityscapes train/val split: ``python -m
    torch.distributed.run --nproc_per_node 4 -m jpdse_tpu_torch.train`` for
    two epochs of 2 steps, each ending in a save of save_dir/latest; then
    the same flags with ``--load_model``, one more epoch, through
    :func:`resume_rank` under torchrun. Only rank 0 writes (each step's
    line once in loss_log.txt and metrics.jsonl); the resumed run starts
    from latest at epoch 3 with 4 steps taken (phase 8 (c)'s rule), its
    restored state bit-equal to the files and across the ranks, each rank
    on its own card over NCCL, and ends at 6 steps."""
    root, out = work / "cityscapes", work / "run"
    for split in ("train", "val"):
        write_cityscapes(root, seed + 18 + (split == "train"), split)
    mode, load, crop, _ = FLAGSHIP_PREPROCESS
    argv = ["--dataset", "cityscapes", "--root_dir", str(root), "--no_generator_binarization",
            "--normalize_std", "1", "--batch_size", "1", "--remat", "1", "--seed", str(seed),
            "--num_workers", "2", "--max_recon_dump", "2", "--fused_instance_norm", "1",
            "--spatial_axis", "2", "--val_interval", "5", "--latest_interval", "1",
            "--save_dir", str(out)]
    for prefix in ("", "val_"):
        argv += [f"--{prefix}preprocess_mode", mode, f"--{prefix}load_size", str(load),
                 f"--{prefix}crop_size", str(crop)]
    steps = EVAL_IMAGES // 2  # a global batch of 2: one image for each of two spatial groups
    t0 = time.perf_counter()
    text = torchrun(["-m", "jpdse_tpu_torch.train"] + argv + ["--num_epochs", "2"],
                    work / "train.log")
    seconds = time.perf_counter() - t0
    mesh_lines = text.count("multi-process mesh: dcn=2 x data=1 x spatial=2")
    loss_log = (out / "loss_log.txt").read_text().splitlines()
    step_lines = [line for line in loss_log if ", batch " in line]
    jsonl = [json.loads(line) for line in (out / "metrics.jsonl").read_text().splitlines()]
    latest = json.loads((out / "latest" / "trainer_meta.json").read_text())
    opt = torch.load(out / "latest" / "opt.pt", map_location="cpu", weights_only=True)
    want_lines = [f"epoch {e}/2, batch {i}/{steps}" for e in (1, 2) for i in range(1, steps + 1)]
    if (mesh_lines != CARDS or [line.split(", distortion")[0] for line in step_lines] != want_lines
            or len(jsonl) != 2 * steps or latest["epoch"] != 1 or opt["steps_taken"] != 2 * steps):
        raise AssertionError(f"(d) the first run: {mesh_lines} mesh lines, loss_log {step_lines}, "
                             f"{len(jsonl)} metrics lines, latest at epoch {latest['epoch']} "
                             f"with {opt['steps_taken']} steps")
    log(f"[cards] (d) torch.distributed.run --nproc_per_node 4 -m jpdse_tpu_torch.train "
        f"--spatial_axis 2: two epochs of {steps} steps (data 2 x spatial 2, batch 1 a spatial "
        f"group) in {seconds:.1f} s with the launch; every rank printed the 2 x 2 mesh, "
        f"loss_log.txt and metrics.jsonl hold each step once (rank 0 writes), save_dir/latest "
        f"at epoch {latest['epoch']} with {opt['steps_taken']} steps ({card})")
    t0 = time.perf_counter()
    text = torchrun([str(Path(__file__).resolve()), "--resume-rank", str(work)] + argv
                    + ["--num_epochs", "1", "--load_model", "--checkpoints_dir", str(out)],
                    work / "resume.log")
    seconds = time.perf_counter() - t0
    seen = [json.loads((work / f"resume_rank{r}.json").read_text()) for r in range(CARDS)]
    latest = json.loads((out / "latest" / "trainer_meta.json").read_text())
    bad = [s for r, s in enumerate(seen)
           if (s["rank"], s["device"], s["backend"]) != (r, f"cuda:{r}", "nccl")
           or (s["epoch"], s["steps"], s["steps_after"]) != (2, 2 * steps, 3 * steps)
           or not (s["files_equal"] and s["rank0_equal"] and s["adam_equal"])]
    if (bad or "resuming from latest-state checkpoint" not in text
            or f"starting from epoch 3 with {2 * steps} steps taken" not in text
            or latest["epoch"] != 2):
        raise AssertionError(f"(d) the resumed run: {bad or seen}, latest at {latest}")
    log(f"[cards] (d) the resumed run (train.run.main under torch.distributed.run, "
        f"--load_model): every rank on its own card over nccl resumed from latest at epoch 3 "
        f"with {2 * steps} steps taken, its parameters and Adams bit-equal to the files and "
        f"to rank 0's before its first step; it ended at {seen[0]['steps_after']} steps, latest "
        f"at epoch {latest['epoch']}; {seconds:.1f} s with the launch ({card})")


def cards_summary(rows: list, ranks: list, card: str) -> None:
    """The scaling table of (e) and the launches of (a) and (b)."""
    log("[cards] scaling, phase-2 recipe at batch 2 a card, TF32 convolutions "
        f"({card}; interconnect as printed at the start):")
    log("[cards]   layout | configuration | one card ms | images/s | four cards ms | images/s | "
        "efficiency | gradient all-reduce ms (share) | spatial all-reduces ms (share), MiB a "
        "rank | peak GiB a card (card 0's with the one-card trainer's state)")
    for r in rows:
        one_ms, four_ms = np.median(r["one_card_ms"]), np.median(r["four_cards_ms"])
        c, step_ms = r["comm_ms"], r["events_step_ms"]
        log(f"[cards]   {r['layout']} | {'kernel' if r['kernels'] else 'default'} | {one_ms:.1f} | "
            f"{r['one_card_images_s']:.3f} | {four_ms:.1f} | {r['four_cards_images_s']:.3f} | "
            f"{r['efficiency']:.3f} | {c['gradient all-reduce']:.2f} "
            f"({c['gradient all-reduce'] / step_ms:.1%}) | {c['spatial all-reduces']:.2f} "
            f"({c['spatial all-reduces'] / step_ms:.1%}), {r['spatial_mib']:.1f} | "
            + ", ".join(f"{p:.2f}" for p in r["peak_gib"]))
    log(json.dumps({"cards": CARDS, "card": card, "nccl": torch.cuda.nccl.version(),
                    "launches_a_rank_step": {
                        leg: {k: v for k, v in ranks[0][leg]["counts"].items() if v}
                        for leg in ("a", "b")},
                    "spatial_traffic_b": ranks[0]["b"]["traffic"],
                    "scaling": rows}))


def phase18(seed: int) -> None:
    """Phase 18, the parallel axes across four cards on NCCL (see the
    docstring's --cards 4)."""
    from jpdse_tpu_torch.ops.build import build_all

    n = torch.cuda.device_count()
    if n < CARDS:  # never fewer ranks, never several on one card
        raise RuntimeError(f"phase 18 needs {CARDS} CUDA devices; torch.cuda.device_count() is {n}")
    t_start = time.perf_counter()
    cards = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                           capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    card = cards.splitlines()[0]
    topo = topology()
    log(f"[env] cards:\n{cards}")
    log(f"[env] {topo}")
    log(f"[env] NCCL {'.'.join(map(str, torch.cuda.nccl.version()))}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {n} device(s)")
    t0 = time.perf_counter()
    build_all()
    log(f"[build] built every kernel in {time.perf_counter() - t0:.1f} s")
    with tempfile.TemporaryDirectory(prefix="jpdse_cards_") as work:
        work = Path(work)
        sharded_eval_setup(work / "eval", seed, 18, CARDS, "opt4.json")
        t0 = time.perf_counter()
        ctx = torch.multiprocessing.get_context("spawn")
        port = free_port()
        procs = [ctx.Process(target=multicard_rank,
                             args=(r, port, seed, str(work), f"cuda:{r}", "nccl", False, "abce",
                                   card)) for r in range(CARDS)]
        for p in procs:
            p.start()
        one = spatial_eval(spatial_eval_argv(work / "eval", work / "single", "opt1.json"),
                           "one process", "[cards] (c)")  # on card 0 meanwhile
        deadline = time.perf_counter() + CARDS_JOIN_S
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.perf_counter()))
        codes = [p.exitcode for p in procs]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        if codes != [0] * CARDS:
            raise AssertionError(f"phase 18: the four ranks exited with {codes}")
        ranks = [torch.load(work / f"rank{r}.pt", weights_only=False) for r in range(CARDS)]
        if [r["backend"] for r in ranks] != ["nccl"] * CARDS or \
                [r["device"] for r in ranks] != [f"cuda:{r}" for r in range(CARDS)]:
            raise AssertionError(f"phase 18: ranks on {[(r['backend'], r['device']) for r in ranks]}")
        log(f"[cards] (a), (b), (c) and (e) in four ranks on NCCL, cuda:0-3, "
            f"{time.perf_counter() - t0:.1f} s with the spawn")
        check_sharded_eval(work, one, [r["c"] for r in ranks], "[cards] (c)", card)
        cards_entry(work / "entry", seed, card)
        cards_summary(ranks[0]["e"], ranks, card)
    log(card)
    log(f"total {time.perf_counter() - t_start:.1f} s ({card})")


def main() -> int:
    if sys.argv[1:2] == ["--resume-rank"]:  # a rank of phase 18 (d)'s resumed run
        return resume_rank(Path(sys.argv[2]), sys.argv[3:])
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--train-steps", type=int, default=4)
    ap.add_argument("--cards", type=int, default=1, choices=(1, CARDS),
                    help=f"{CARDS}: phase 18 alone, one rank on each of {CARDS} cards over NCCL")
    args = ap.parse_args()
    t_start = time.perf_counter()
    if args.cards == CARDS and torch.cuda.device_count() < CARDS:
        print(f"chip_smoke --cards {CARDS}: needs {CARDS} CUDA devices, one rank a card over "
              f"NCCL; torch.cuda.device_count() is {torch.cuda.device_count()}", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    if args.cards == CARDS:
        phase18(args.seed)
        log(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0

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
               phase_k3_bwd(card, gen), phase_k4(card, gen)] + phase_k3_partial(card, gen)

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
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="jpdse_warm_src_") as keep:
        serve9, train9 = phase9(args.seed, args.requests, args.train_steps, card, Path(keep))
        launches.update(serve9)
        train_launches.update(train9)
        torch.cuda.empty_cache()
        serve10, train10 = phase10(args.seed, args.requests, args.train_steps, card,
                                   Path(keep))
    launches.update(serve10)
    train_launches.update(train10)
    torch.cuda.empty_cache()
    train_launches.update(phase11(args.seed, args.train_steps, card))
    torch.cuda.empty_cache()
    serve12, train12 = phase12(args.seed, card)
    launches.update(serve12)
    train_launches.update(train12)
    torch.cuda.empty_cache()
    eval13, train13 = phase13(args.seed, card)
    eval_launches.update(eval13)
    launches.update(eval13)
    train_launches.update(train13)
    torch.cuda.empty_cache()
    eval14, train14 = phase14(args.seed, args.train_steps, card)
    eval_launches.update(eval14)
    launches.update(eval14)
    train_launches.update(train14)
    torch.cuda.empty_cache()
    eval17 = phase17(args.seed, card)
    eval_launches.update(eval17)
    launches.update(eval17)
    launches.update(train_launches)
    for e in entries:
        name = e["name"]
        in_eval = sum(eval_launches[label][name] for label in eval_launches)
        in_train = sum(train_launches[label][name] for label in train_launches)
        if name not in ("fused_instance_norm_bwd", "instance_norm_bwd_sums",
                        "instance_norm_bwd_dx") and in_eval == 0:
            raise AssertionError(f"{name} was not launched in the eval phase")
        if (name.startswith("fused_instance_norm") or name in K3_PARTIAL) and in_train == 0:
            raise AssertionError(f"{name} was not launched in the training phase")
        by_path = {label: counts[name] for label, counts in launches.items()}
        e["launches"] = sum(by_path.values())
        e["launches_by_path"] = by_path
        if e["launches"] == 0:
            raise AssertionError(f"{name} was not launched on any path")

    log(card)
    log(json.dumps({"kernels": entries}))
    log(f"total {time.perf_counter() - t_start:.1f} s ({card})")
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
