"""The semantics-aware codec, the port of ``jpdse_tpu/models/codec.py``
(``prepare_inputs`` :30 and ``SemanticCodec`` for the learned-code
configuration): netE4label codes the semantics, netE the visuals, and
netG decodes their concatenation."""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from jpdse_tpu_torch.config import Config, check_ported
from jpdse_tpu_torch.models.generator import Encoder, GlobalGenerator
from jpdse_tpu_torch.models.layers import build
from jpdse_tpu_torch.ops.semantics import prepare_semantics
from jpdse_tpu_torch.platform import resolve_device


def compute_dtype(cfg: Config) -> torch.dtype:
    return torch.bfloat16 if cfg.model.compute_dtype == "bfloat16" else torch.float32


def prepare_inputs(cfg: Config, label, instance, image) -> Dict[str, Optional[torch.Tensor]]:
    """One-hot label + edge map (``input_label``) beside the image
    (``real_image``), both in the image's dtype."""
    m = cfg.model
    label_tensor = prepare_semantics(
        label, instance, cfg.data.semantic_nc,
        no_label=m.no_label, no_instance=m.no_instance, dtype=image.dtype,
    )
    return {"input_label": label_tensor, "real_image": image}


class SemanticCodec(nn.Module):
    """netG + netE4label + netE with random weights from ``seed`` (or zeros
    with ``seed=None``, for loading a state dict). Parameters are fp32;
    activations run in ``dtype`` (default: the config's compute dtype).
    ``model.fused_instance_norm`` runs every norm site through kernel K3
    (differentiable). ``optim.remat`` recomputes activations in the
    backward: each block at ``remat_granularity`` 'block', the whole
    decode at 'decode'."""

    def __init__(self, cfg: Config, device="cuda", seed: Optional[int] = 0, dtype=None):
        super().__init__()
        cfg.validate()
        check_ported(cfg)
        self.cfg = cfg
        self.dtype = dtype or compute_dtype(cfg)
        m = cfg.model
        dev = resolve_device(device)
        gen = None if seed is None else torch.Generator(device=dev).manual_seed(seed)
        remat = cfg.optim.remat and cfg.optim.remat_granularity == "block"
        self.remat_decode = cfg.optim.remat and cfg.optim.remat_granularity == "decode"
        self.netG = build(lambda: GlobalGenerator(
            cfg.netG_input_nc, cfg.data.num_out_channels, m.ngf,
            m.n_downsample_global, m.n_blocks_global, m.fused_instance_norm, remat), dev, gen)
        self.netE = build(lambda: Encoder(
            cfg.netE_input_nc, m.feat_num, m.nef, m.n_downsample_E, binarize=True,
            binarizer_out_channels=m.encoder_binarizer_out_channels,
            fused=m.fused_instance_norm, remat=remat), dev, gen)
        self.netE4label = build(lambda: Encoder(
            cfg.netE4label_input_nc, m.label_encoder_out_channels, m.ne4lf,
            m.n_downsample_E4label, binarize=True,
            binarizer_out_channels=m.label_encoder_binarizer_out_channels,
            fused=m.fused_instance_norm, remat=remat), dev, gen)

    def prepare(self, batch: Dict) -> Dict[str, torch.Tensor]:
        return prepare_inputs(self.cfg, batch["label"], batch["instance"], batch["image"].to(self.dtype))

    def decode(self, inputs, train: bool = False, deterministic: bool = True,
               generator: Optional[torch.Generator] = None):
        """Full reconstruction from prepared inputs: (fake image, the label
        encoder's output), as the JAX package's ``decode`` returns them. In
        training (``deterministic`` False) the binarizers draw from
        ``generator``. ``train`` selects the norms' training mode in JAX,
        which instance norms do not read; it is kept for the signature."""
        del train
        if self.remat_decode and torch.is_grad_enabled():
            # the recompute replays the binarizers' draws from the same state
            state = None if generator is None else generator.get_state()

            def run(label, image):
                if state is not None:
                    generator.set_state(state)
                return self._decode(label, image, deterministic, generator)

            return checkpoint(run, inputs["input_label"], inputs["real_image"],
                              use_reentrant=False)
        return self._decode(inputs["input_label"], inputs["real_image"], deterministic, generator)

    def _decode(self, input_label, image, deterministic, generator):
        label = self.netE4label(input_label, deterministic, generator)
        feat = self.netE(image, deterministic, generator)
        return self.netG(torch.cat([label, feat.to(label.dtype)], dim=-1)), label

    def get_codes_shaped(self, inputs) -> List[torch.Tensor]:
        """Codes in (B, h, w, C) layout with values (sign + 1) / 2, in the
        order netE4label, netE."""
        return [
            (self.netE4label.encode(inputs["input_label"]) + 1.0) / 2.0,
            (self.netE.encode(inputs["real_image"]) + 1.0) / 2.0,
        ]

    def get_presign(self, inputs) -> List[torch.Tensor]:
        """tanh of the binarizers' inputs, in get_codes_shaped order: where a
        value is near 0 its code bit rests on rounding."""
        return [
            self.netE4label.binarizer.presign(self.netE4label.features(inputs["input_label"])),
            self.netE.binarizer.presign(self.netE.features(inputs["real_image"])),
        ]

    def decode_from_codes(self, codes: List[torch.Tensor]):
        """Image from codes alone ((B, h, w, C) in {0, 1}, get_codes_shaped
        order)."""
        label = self.netE4label.decode_from_code((codes[0] * 2.0 - 1.0).to(self.dtype))
        feat = self.netE.decode_from_code((codes[1] * 2.0 - 1.0).to(self.dtype))
        return self.netG(torch.cat([label, feat.to(label.dtype)], dim=-1))
