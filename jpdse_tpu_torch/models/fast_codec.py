"""Space-to-depth inference path, the port of
``jpdse_tpu/models/fast_codec.py::FastCodec`` for global generators and
LocalEnhancers (``_FastLocalG``): ``decode``, ``get_codes_shaped`` and
``decode_from_codes`` (with the stream's side info as ``side_batch``) over
the weights of a ``SemanticCodec``, with netG and each encoder the configuration has as
an s2d ``_FastTrunk``, and the generator's input assembled as the standard
path assembles it. The kernel switches (``cfg.model.fast``, env overrides
applied) are resolved once, at construction, and passed to every trunk.

``sem_masking``, a grouped netE, ``inst_wise_pool`` and norms other than
the instance norm are refused, as the JAX package refuses them; the
standard path serves them. The ablations (``zero_*``, ``use_netE_output``) are applied
as ``SemanticCodec`` applies them. ``fast.s2d_e2e`` is carried as data: the
trunk inputs are assembled in the fine domain either way.

Under the spatial axis (``parallel/spatial.py``'s ``sharding``) the three
methods take this rank's rows of the batch (of the codes, for
``decode_from_codes``) and return this rank's rows, as JAX's
``FastCodec(..., sharded=True)`` under a mesh; the trunks then run their
sharded stages (``models/fast_trunk.py``)."""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from jpdse_tpu_torch.config import Config, check_ported
from jpdse_tpu_torch.models.codec import _concat, assemble, cast, compute_dtype, prepare_inputs
from jpdse_tpu_torch.models.fast_trunk import _FastLocalG, _FastTrunk, _sub
from jpdse_tpu_torch.parallel import spatial
from jpdse_tpu_torch.platform import resolve_device
from jpdse_tpu_torch.train.step import raw_side_inputs


class FastCodec:
    """Deterministic s2d inference over ``state`` (a ``SemanticCodec``
    state dict). Batches are dicts of tensors on ``device``: ``label``
    (B, H, W), ``instance`` (B, H, W) and ``image`` (B, H, W, 3), the
    semantic maps where the configuration reads them."""

    def __init__(self, cfg: Config, state: Dict[str, torch.Tensor], device="cuda", dtype=None):
        cfg.validate()
        check_ported(cfg)
        m = cfg.model
        if m.sem_masking or m.netE_groups != 1 or m.inst_wise_pool or m.norm != "instance":
            raise ValueError("FastCodec runs ungrouped instance-norm configurations without "
                             "sem_masking or inst_wise_pool; the standard path (SemanticCodec) "
                             "serves the others")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = dtype or compute_dtype(cfg)
        self.fp = fp = m.fast.resolved()
        fp.validate(check_combos=False)

        def trunk(name, n_down, n_blocks, binarize):
            return _FastTrunk(_sub(state, name), n_down, n_blocks, binarize, self.dtype,
                              self.device, fp)

        g_bin = "none"
        if not m.no_generator_binarization:
            g_bin = "before_res" if m.bin_generator_before_res else "after_res"
        if m.netG == "local":
            # a LocalEnhancer has no binarizer (SemanticCodec raises for one)
            self.netG = _FastLocalG(_sub(state, "netG"), m.n_downsample_global,
                                    m.n_blocks_global, m.n_local_enhancers, m.n_blocks_local,
                                    self.dtype, self.device, fp)
        else:
            self.netG = trunk("netG", m.n_downsample_global, m.n_blocks_global, g_bin)
        self.netE = self.netE4label = None
        if cfg.use_netE:
            self.netE = trunk("netE", m.n_downsample_E, 0,
                              "none" if m.no_encoder_binarization else "mid")
        if cfg.use_netE4label:
            self.netE4label = trunk("netE4label", m.n_downsample_E4label, 0,
                                    "none" if m.no_label_encoder_binarization else "mid")

    def _coded(self, trunk: Optional[_FastTrunk]) -> bool:
        return trunk is not None and trunk.binarize != "none"

    def _inputs(self, batch: Dict[str, torch.Tensor]) -> Dict[str, Optional[torch.Tensor]]:
        # the one-hot and edge values are exact in bf16, so build them there
        return prepare_inputs(self.cfg, batch.get("label"), batch.get("instance"),
                              cast(batch["image"], self.dtype),
                              cast(batch.get("compressed"), self.dtype))

    def _vis(self, inputs):
        """The visuals: the base codec's decoded image under use_compressed,
        else the image."""
        return inputs["compressed_img" if self.cfg.codec.use_compressed else "real_image"]

    def _features(self, inputs):
        """(label features, visual features): each encoder's output where
        the configuration has it, else the raw input, else None."""
        label = inputs["input_label"]
        if self.netE4label is not None:
            label = self.netE4label(label)
        feat = None
        if not self.cfg.model.no_feat:
            feat = self._vis(inputs)
            if self.netE is not None:
                feat = self.netE(feat)
        return label, feat

    @torch.inference_mode()
    def decode(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        label, feat = self._features(self._inputs(batch))
        if self.cfg.model.use_netE_output:
            return feat
        return self.netG(assemble(self.cfg, label, feat)[0])

    @torch.inference_mode()
    def get_codes_shaped(self, batch: Dict[str, torch.Tensor]) -> List[torch.Tensor]:
        """Codes in (B, h, w, C) layout with values (sign + 1) / 2, one per
        binarized module, in the order netE4label, netE, netG (as
        SemanticCodec.get_codes_shaped)."""
        inputs = self._inputs(batch)
        codes = []
        if self._coded(self.netE4label):
            codes.append(self.netE4label.encode(inputs["input_label"]))
        if self._coded(self.netE):
            codes.append(self.netE.encode(self._vis(inputs)))
        if self.netG.binarize != "none":
            codes.append(self.netG.encode(assemble(self.cfg, *self._features(inputs))[0]))
        return [spatial.like((c + 1.0) / 2.0, c) for c in codes]

    @torch.inference_mode()
    def decode_from_codes(self, codes: List[torch.Tensor],
                          side_batch: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
        """Image from the codes ((B, h, w, C) in {0, 1}) and, for the
        branches they do not carry, ``side_batch``: a batch dict of what the
        stream's side info holds (the semantic maps, the base codec's
        decoded image as ``compressed``)."""
        m = self.cfg.model

        def pm1(c):
            return spatial.like(c.to(self.dtype) * 2.0 - 1.0, c)

        if self.netG.binarize != "none":
            return self.netG.decode_from_code(pm1(codes[0]))
        side = None
        if side_batch is not None:
            side = (raw_side_inputs(side_batch, self.dtype) if side_batch.get("label") is None
                    else self._inputs(side_batch))

        def need_side(what):
            if side is None:
                raise ValueError(f"decode_from_codes: {what} must ride as .jpds side info "
                                 "for this configuration")

        i = 0
        label = None
        if self._coded(self.netE4label):
            label = self.netE4label.decode_from_code(pm1(codes[i]))
            i += 1
        elif not m.no_label:
            need_side("raw semantics")
            label = side["input_label"]
            if self.netE4label is not None:
                label = self.netE4label(label)
        feat = None
        if not m.no_feat:
            if self._coded(self.netE):
                feat = self.netE.decode_from_code(pm1(codes[i]))
                i += 1
            else:
                need_side("visual features (base-codec payload)")
                feat = self._vis(side)
                if self.netE is not None:
                    feat = self.netE(feat)
        return self.netG(_concat(self.cfg, label, feat))
