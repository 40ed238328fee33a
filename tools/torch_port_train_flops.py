#!/usr/bin/env python3
"""Count the work of the port's GAN training step from the code, on the
meta device (no memory, no card): the forward FLOPs of each network at one
image, the whole step's FLOPs at the flagship's phase-2 recipe (batch 2,
1024x512, block remat), and the bytes of G's parameters, gradients and Adam
moments; then the step's bound at the H100's fp32 (CUDA cores) and TF32
peaks.

    python3 tools/torch_port_train_flops.py [--batch 2] [--height 512] [--width 1024]

FLOPs are PyTorch's ``FlopCounterMode`` counts (2 per multiply-add of the
convolutions and matmuls, their backward included; the element-wise work is
not counted). Binarization is counted with the deterministic sign: the
stochastic draws change no FLOP count.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch
from torch.utils.flop_counter import FlopCounterMode

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

FP32_FLOPS = 67e12  # H100 SXM fp32 on the CUDA cores (data sheet)
TF32_FLOPS = 495e12  # H100 SXM dense TF32 tensor-core peak (data sheet)


def flops(fn) -> int:
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--height", type=int, default=512)
    ap.add_argument("--width", type=int, default=1024)
    args = ap.parse_args()

    from jpdse_tpu_torch.config import flagship_config
    from jpdse_tpu_torch.models.codec import SemanticCodec
    from jpdse_tpu_torch.models.discriminator import build_discriminator
    from jpdse_tpu_torch.models.vgg import init_vgg19
    from jpdse_tpu_torch.ops import quantizers
    from jpdse_tpu_torch.train import step
    from jpdse_tpu_torch.train.state import create_train_state

    quantizers.stochastic_sign_ste = lambda x, gen: quantizers.deterministic_sign_ste(x)
    cfg = flagship_config()
    cfg.model.compute_dtype, cfg.model.fast_inference = "float32", False
    cfg.optim.remat = True
    meta = torch.device("meta")
    codec = SemanticCodec(cfg, device=meta, seed=None)
    disc = build_discriminator(cfg, meta, None)
    vgg = init_vgg19(meta, None)
    h, w = args.height, args.width

    def batch(b):
        return {"label": torch.zeros((b, h, w), device=meta),
                "instance": torch.zeros((b, h, w), dtype=torch.int32, device=meta),
                "image": torch.zeros((b, h, w, 3), device=meta)}

    with torch.no_grad():
        inputs = codec.prepare(batch(1))
        label = codec.netE4label(inputs["input_label"])
        feat = codec.netE(inputs["real_image"])
        g_in = torch.cat([label, feat], dim=-1)
        fake = torch.zeros((1, h, w, 3), device=meta)
        d_in = torch.zeros((1, h, w, cfg.netD_input_nc), device=meta)
        per_image = {
            "netG": flops(lambda: codec.netG(g_in)),
            "netG res blocks": flops(lambda: [blk(torch.zeros(
                (1, h // 16, w // 16, 1024), device=meta)) for blk in codec.netG.res]),
            "netE4label": flops(lambda: codec.netE4label(inputs["input_label"])),
            "netE": flops(lambda: codec.netE(inputs["real_image"])),
            "VGG19 to relu5_1": flops(lambda: vgg(fake)),
            "D (both scales)": flops(lambda: disc(d_in)),
        }
    state = create_train_state(cfg, codec, disc, vgg)
    total = flops(lambda: step.loss_and_grads(state, batch(args.batch),
                                              torch.Generator()))
    n_g = sum(p.numel() for p in codec.parameters())
    n_d = sum(p.numel() for p in disc.parameters())
    out = {
        "shape": [args.batch, h, w],
        "forward_tflop_per_image": {k: v / 1e12 for k, v in per_image.items()},
        "step_tflop": total / 1e12,
        "step_bound_ms_fp32": total / FP32_FLOPS * 1e3,
        "step_bound_ms_tf32": total / TF32_FLOPS * 1e3,
        "g_params": n_g, "d_params": n_d,
        # parameters, gradients and Adam's two moments, fp32
        "g_train_state_gb": 4 * 4 * n_g / 1e9,
    }
    print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
