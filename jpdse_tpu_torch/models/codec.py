"""The semantics-aware codec, the port of ``jpdse_tpu/models/codec.py``
(``prepare_inputs`` :30 and ``SemanticCodec``): netG, with netE4label coding
the semantics and netE the visuals where the configuration has them, and
the generator's input assembled from their outputs, the raw semantics or
the raw (or semantically masked) image, or the base codec's decoded image
(``codec.use_compressed``), as ``_generator_input`` (:160-208) assembles it.
The encoders, or the generator's bottleneck, may carry a binarizer, whose
codes ``get_codes_shaped`` returns and ``decode_from_codes`` decodes. netG
is a ``GlobalGenerator`` or, with ``model.netG`` 'local', a
``LocalEnhancer`` (:105-123), which has no binarizer; netE may be grouped
(``model.netE_groups``) and average its output over each instance
(``model.inst_wise_pool``)."""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from jpdse_tpu_torch.config import Config, check_ported
from jpdse_tpu_torch.models.generator import Encoder, GlobalGenerator, LocalEnhancer
from jpdse_tpu_torch.models.layers import build
from jpdse_tpu_torch.ops.semantics import degrade_ids, prepare_semantics, sem_mask
from jpdse_tpu_torch.platform import resolve_device
from jpdse_tpu_torch.train.step import raw_side_inputs

# the float inputs of a decode, as the remat checkpoint passes them
_DECODE_TENSORS = ("input_label", "real_image", "masked_img", "compressed_img")


def compute_dtype(cfg: Config) -> torch.dtype:
    return torch.bfloat16 if cfg.model.compute_dtype == "bfloat16" else torch.float32


def prepare_inputs(cfg: Config, label, instance, image,
                   compressed=None) -> Dict[str, Optional[torch.Tensor]]:
    """One-hot label + edge map (``input_label``) beside the image
    (``real_image``), both in the image's dtype; the instance ids
    (``instance_ids``); the base codec's decoded image (``compressed_img``);
    under ``model.sem_masking`` the visuals (the decoded image under
    ``codec.use_compressed``) gated by each semantic channel
    (``masked_img``). Under ``codec.sem_downsample`` the maps are first
    taken down and back up, as a receiver rebuilds them from the stream.
    Unused entries are None."""
    m = cfg.model
    f = cfg.codec.sem_downsample
    if f > 1:
        label, instance = degrade_ids(label, f), degrade_ids(instance, f)
    label_tensor = prepare_semantics(
        label, instance, cfg.data.semantic_nc,
        no_label=m.no_label, no_instance=m.no_instance, dtype=image.dtype,
    )
    masked = None
    if m.sem_masking:
        vis = compressed if cfg.codec.use_compressed else image
        masked = sem_mask(vis, label_tensor, m.binary_mask, m.input_nc)
    return {"input_label": label_tensor, "real_image": image, "instance_ids": instance,
            "masked_img": masked, "compressed_img": compressed}


def _concat(cfg: Config, input_label, feat):
    """The generator's input from the label features and the visual
    features, by the assembly rules of ``_generator_input``."""
    if feat is None:
        return input_label
    if cfg.model.sem_masking or input_label is None:
        return feat
    return torch.cat([input_label, feat.to(input_label.dtype)], dim=-1)


def assemble(cfg: Config, input_label, feat):
    """(netG's input, the label features D sees) from the label features
    and the visual features, after the ablations zero_vis, zero_sem and
    zero_ins (which zeroes the edge map, the last channel)."""
    m = cfg.model
    if feat is not None and m.zero_vis:
        feat = torch.zeros_like(feat)
    if m.zero_sem and input_label is not None:
        input_label = torch.zeros_like(input_label)
    elif m.zero_ins and not m.no_instance and input_label is not None:
        input_label = torch.cat(
            [input_label[..., :-1], torch.zeros_like(input_label[..., -1:])], dim=-1)
    return _concat(cfg, input_label, feat), input_label


class SemanticCodec(nn.Module):
    """netG [+ netE4label] [+ netE] with random weights from ``seed`` (or
    zeros with ``seed=None``, for loading a state dict), assembled by the
    config's channel arithmetic. Parameters are fp32; activations run in
    ``dtype`` (default: the config's compute dtype).
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
        if m.netG == "local":
            if not m.no_generator_binarization:
                raise ValueError("local enhancers do not support binarization "
                                 "(pix2pixHD_model.py:68 help text)")
            self.netG = build(lambda: LocalEnhancer(
                cfg.netG_input_nc, cfg.data.num_out_channels, m.ngf, m.n_downsample_global,
                m.n_blocks_global, m.n_local_enhancers, m.n_blocks_local, m.norm,
                fused=m.fused_instance_norm, remat=remat), dev, gen)
        else:
            self.netG = build(lambda: GlobalGenerator(
                cfg.netG_input_nc, cfg.data.num_out_channels, m.ngf,
                m.n_downsample_global, m.n_blocks_global, m.fused_instance_norm, remat,
                binarize=not m.no_generator_binarization,
                binarizer_out_channels=m.generator_binarizer_out_channels,
                bin_before_res=m.bin_generator_before_res, norm=m.norm), dev, gen)
        self.netE = self.netE4label = None
        if cfg.use_netE:
            self.netE = build(lambda: Encoder(
                cfg.netE_input_nc, m.feat_num, m.nef, m.n_downsample_E,
                binarize=not m.no_encoder_binarization,
                binarizer_out_channels=m.encoder_binarizer_out_channels,
                fused=m.fused_instance_norm, remat=remat, norm=m.norm, groups=m.netE_groups,
                inst_wise_pool=m.inst_wise_pool, num_segments=m.max_instance_id), dev, gen)
        if cfg.use_netE4label:
            self.netE4label = build(lambda: Encoder(
                cfg.netE4label_input_nc, m.label_encoder_out_channels, m.ne4lf,
                m.n_downsample_E4label, binarize=not m.no_label_encoder_binarization,
                binarizer_out_channels=m.label_encoder_binarizer_out_channels,
                fused=m.fused_instance_norm, remat=remat, norm=m.norm), dev, gen)

    @property
    def label_coded(self) -> bool:
        """Whether netE4label's code is one of the codes."""
        return self.netE4label is not None and self.netE4label.binarizer is not None

    @property
    def feat_coded(self) -> bool:
        """Whether netE's code is one of the codes."""
        return self.netE is not None and self.netE.binarizer is not None

    def prepare(self, batch: Dict) -> Dict[str, Optional[torch.Tensor]]:
        comp = batch.get("compressed")
        return prepare_inputs(self.cfg, batch.get("label"), batch.get("instance"),
                              batch["image"].to(self.dtype),
                              None if comp is None else comp.to(self.dtype))

    def side_inputs(self, side_batch: Optional[Dict]) -> Optional[Dict]:
        """:meth:`decode_from_codes`'s side inputs from a batch of what a
        stream's side info holds (``serve.CodecServer`` rebuilds it)."""
        if side_batch is None:
            return None
        if side_batch.get("label") is None:
            return raw_side_inputs(side_batch, self.dtype)
        return self.prepare(side_batch)

    def _vis(self, inputs):
        """The visuals netE or netG reads: the masked image under
        sem_masking, else the base codec's decoded image under
        use_compressed, else the image."""
        if self.cfg.model.sem_masking:
            return inputs["masked_img"]
        if self.cfg.codec.use_compressed:
            return inputs["compressed_img"]
        return inputs["real_image"]

    def _generator_input(self, inputs, deterministic: bool, generator):
        """(netG's input, the label features D sees, netE's output before
        the zero_vis ablation); the binarizers draw netE4label's first,
        then netE's."""
        m = self.cfg.model
        input_label = inputs["input_label"]
        if self.netE4label is not None:
            input_label = self.netE4label(input_label, deterministic, generator)
        feat = None
        if not m.no_feat:
            vis = self._vis(inputs)
            feat = vis if self.netE is None else self.netE(vis, deterministic, generator,
                                                           inputs["instance_ids"])
        concat, input_label = assemble(self.cfg, input_label, feat)
        return concat, input_label, feat

    def decode(self, inputs, train: bool = False, deterministic: bool = True,
               generator: Optional[torch.Generator] = None):
        """Full reconstruction from prepared inputs: (fake image, the label
        features), as the JAX package's ``decode`` returns them; under
        ``use_netE_output`` the image is netE's output and netG is not run.
        In training (``deterministic`` False) the binarizers draw from
        ``generator``. ``train`` selects the norms' training mode in JAX,
        which instance norms do not read; it is kept for the signature."""
        del train
        if self.remat_decode and torch.is_grad_enabled():
            # the recompute replays the binarizers' draws from the same state
            state = None if generator is None else generator.get_state()
            keys = [k for k in _DECODE_TENSORS if inputs.get(k) is not None]

            def run(*tensors):
                if state is not None:
                    generator.set_state(state)
                return self._decode(dict(inputs, **dict(zip(keys, tensors))), deterministic,
                                    generator)

            return checkpoint(run, *[inputs[k] for k in keys], use_reentrant=False)
        return self._decode(inputs, deterministic, generator)

    def _decode(self, inputs, deterministic, generator):
        concat, input_label, raw_feat = self._generator_input(inputs, deterministic, generator)
        if self.cfg.model.use_netE_output:
            return raw_feat, input_label
        return self.netG(concat, deterministic, generator), input_label

    def get_codes_shaped(self, inputs) -> List[torch.Tensor]:
        """Codes in (B, h, w, C) layout with values (sign + 1) / 2, one per
        binarized module, in the order netE4label, netE, netG."""
        codes = []
        if self.label_coded:
            codes.append(self.netE4label.encode(inputs["input_label"]))
        if self.feat_coded:
            codes.append(self.netE.encode(self._vis(inputs)))
        if self.netG.binarizer is not None:
            codes.append(self.netG.encode(self._generator_input(inputs, True, None)[0]))
        return [(c + 1.0) / 2.0 for c in codes]

    def get_presign(self, inputs) -> List[torch.Tensor]:
        """tanh of the binarizers' inputs, in get_codes_shaped order: where a
        value is near 0 its code bit rests on rounding."""
        out = []
        if self.label_coded:
            out.append(self.netE4label.binarizer.presign(
                self.netE4label.features(inputs["input_label"])))
        if self.feat_coded:
            out.append(self.netE.binarizer.presign(self.netE.features(self._vis(inputs))))
        if self.netG.binarizer is not None:
            concat = self._generator_input(inputs, True, None)[0]
            out.append(self.netG.binarizer.presign(self.netG.features(concat)))
        return out

    def decode_from_codes(self, codes: List[torch.Tensor],
                          side_inputs: Optional[Dict[str, Optional[torch.Tensor]]] = None):
        """Image from the codes ((B, h, w, C) in {0, 1}, get_codes_shaped
        order) and, for the branches the codes do not carry (raw semantics,
        an unbinarized encoder's or the raw image's visuals), ``side_inputs``:
        a ``prepare_inputs`` dict of what the stream's side info holds."""
        m = self.cfg.model

        def pm1(c):
            return (c * 2.0 - 1.0).to(self.dtype)

        if self.netG.binarizer is not None:
            # the generator's bottleneck code carries everything before it
            return self.netG.decode_from_code(pm1(codes[0]))

        def need_side(what):
            if side_inputs is None:
                raise ValueError(
                    f"decode_from_codes: this configuration carries {what} outside the "
                    "learned codes: pack them as .jpds side info and pass side_inputs")

        i = 0
        input_label = None
        if self.label_coded:
            input_label = self.netE4label.decode_from_code(pm1(codes[i]))
            i += 1
        elif not m.no_label and not m.sem_masking:
            # (under sem_masking the label only shapes masked_img below)
            need_side("raw semantics (label/instance maps)")
            input_label = side_inputs["input_label"]
            if self.netE4label is not None:
                # a label encoder without a binarizer runs on the side input
                input_label = self.netE4label(input_label)
        feat = None
        if not m.no_feat:
            if self.feat_coded:
                feat = self.netE.decode_from_code(pm1(codes[i]))
                i += 1
                if m.inst_wise_pool:
                    raise ValueError("inst_wise_pool needs instance ids at decode time")
            else:
                need_side("visual features (base-codec payload)")
                feat = self._vis(side_inputs)
                if self.netE is not None:
                    feat = self.netE(feat, inst=side_inputs.get("instance_ids"))
        return self.netG(_concat(self.cfg, input_label, feat))
