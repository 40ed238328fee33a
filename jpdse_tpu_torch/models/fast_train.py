"""The fast train decode (``optim.fast_train``), the port of
``jpdse_tpu/models/fast_train.py``: the whole decode (netE4label, netE,
netG) through the s2d trunks of ``models/fast_trunk.py``, forward and
backward. The s2d weight transforms are exact linear re-layouts, so their
differentiable twins (``ops/s2d.py``, ``*_oihw``) run on the live
parameters at every step and the gradients flow back through them to the
standard-layout parameters: the optimizer, the checkpoints and every other
reader see the same parameters as on the standard path.

The trunks run the train-safe switches the JAX package sets (:211-217): no
K4 head, no fold, and the grid re-alignment and the front's pad + s2d as
plain PyTorch compositions (``fused_realign`` and ``front_realign`` '0'),
chosen by the configuration; kernels K1, K2 and K4 are not launched. The
gates of :func:`fast_train_ineligible_reason` keep K3 off this path too (no
``fused_instance_norm``). With ``optim.remat`` at block granularity each
stage and res block is recomputed in the backward
(``torch.utils.checkpoint``, as ``jax.checkpoint`` there); at decode
granularity the whole decode is, its draws replayed.

The train-mode binarizers (1x1 conv, tanh, the stochastic sign with a
straight-through gradient) draw from one ``torch.Generator`` per trunk,
derived from the step's generator as the JAX package folds 101 and 102
into the step's key: same distribution as the standard path's draws,
different draws. The deterministic forward and every gradient equal the
standard decode's up to float reassociation
(``tests/test_torch_port_fast_train.py``).
"""

from __future__ import annotations

import copy
import hashlib
from typing import Dict, Optional

import torch

from jpdse_tpu_torch.config import Config
from jpdse_tpu_torch.models.codec import assemble, checkpoint_decode
from jpdse_tpu_torch.models.fast_trunk import _FastTrunk
from jpdse_tpu_torch.models.layers import remat_call
from jpdse_tpu_torch.ops import quantizers
from jpdse_tpu_torch.ops.s2d import (
    conv_s1_weights_to_s2d_oihw,
    conv_s2_weights_from_s2d_nopad_oihw,
    conv_valid,
    convT_s2_weights_to_s2d_oihw,
)
from jpdse_tpu_torch.parallel import spatial

# the salts of the trunks' generators, the numbers the JAX package folds in
NETE4LABEL_SALT, NETE_SALT = 101, 102


def fast_train_ineligible_reason(cfg: Config) -> Optional[str]:
    """None when the config can train through the s2d codec; else why
    (the JAX package's gates and messages, :52-77)."""
    m = cfg.model
    if m.netG != "global":
        return "netG != global (the LocalEnhancer pyramid is inference-only)"
    if not m.no_generator_binarization:
        return "generator binarizer in the decode (resume-from-code split)"
    if m.sem_masking or m.use_netE_output:
        return "sem_masking / use_netE_output assembly not re-expressed"
    if m.norm != "instance":
        return "only instance norm is re-expressed (instance_norm_s2d)"
    if m.use_dropout:
        return "dropout in res blocks (train-mode rng path)"
    if m.fused_instance_norm or m.phase_deconv:
        return "fused-IN / phase-deconv variants not re-expressed"
    if cfg.use_netE and (m.netE_groups != 1 or m.inst_wise_pool):
        return "grouped / instance-pooled visual encoder not re-expressed"
    return None


def _trunk_transforms(p: Dict[str, torch.Tensor], trunk: _FastTrunk) -> Dict[str, torch.Tensor]:
    """The stages' weight dict from a trunk's live parameters ``p`` (by
    name, as ``named_parameters`` gives them), keyed as
    ``_FastTrunk.build_weights`` keys it, by differentiable ops (:80-122).
    The convolutions cast each weight to the activations' dtype."""
    w = {"head_w": conv_s1_weights_to_s2d_oihw(p["head.conv.conv.weight"]),
         "head_b": p["head.conv.conv.bias"].repeat(4),
         "down0_w": conv_s2_weights_from_s2d_nopad_oihw(p["down.0.conv.conv.weight"]),
         "down0_b": p["down.0.conv.conv.bias"]}
    for i in range(1, trunk.n_down):
        w[f"down{i}_w"] = p[f"down.{i}.conv.conv.weight"]
        w[f"down{i}_b"] = p[f"down.{i}.conv.conv.bias"]
    for i in range(trunk.n_res):
        for j in (1, 2):
            w[f"res{i}_w{j}"] = p[f"res.{i}.conv{j}.conv.weight"]
            w[f"res{i}_b{j}"] = p[f"res.{i}.conv{j}.conv.bias"]
    for i in range(trunk.n_mid_up):
        w[f"up{i}_w"] = p[f"up.{i}.deconv.weight"]
        w[f"up{i}_b"] = p[f"up.{i}.deconv.bias"]
    last = trunk.n_down - 1
    w["uplast_w"] = convT_s2_weights_to_s2d_oihw(p[f"up.{last}.deconv.weight"])
    w["uplast_b"] = p[f"up.{last}.deconv.bias"].repeat(4)
    w["tail_w"] = conv_s1_weights_to_s2d_oihw(p["tail.conv.weight"])
    w["tail_b"] = p["tail.conv.bias"].repeat(4)
    if trunk.binarize != "none":
        w["bin_w"] = p["binarizer.conv.weight"]
    return w


def trunk_generator(parent: torch.Generator, salt: int) -> torch.Generator:
    """A generator on the parent's device seeded from the parent's state
    and ``salt`` (the port of ``jax.random.fold_in``). The state is read on
    the host, so the card is not waited for; the caller advances the
    parent."""
    state = parent.get_state().numpy().tobytes() + salt.to_bytes(4, "little")
    seed = int.from_bytes(hashlib.blake2b(state, digest_size=8).digest(), "little") >> 1
    return torch.Generator(device=parent.device).manual_seed(seed)


class _TrainTrunk:
    """One codec trunk through the s2d train path: the skeleton's stage
    forwards on the weights built each step, each stage and res block
    recomputed in the backward with ``use_remat`` (:125-174)."""

    def __init__(self, trunk: _FastTrunk, use_remat: bool):
        self.trunk, self.use_remat = trunk, use_remat

    def _binarizer(self, w, h, generator, deterministic):
        """The train-mode Binarizer: 1x1 bias-free conv, tanh, the sign
        with a straight-through gradient, stochastic in training."""
        z = spatial.like(torch.tanh(conv_valid(h, w["bin_w"])), h)
        if deterministic or generator is None:
            return quantizers.deterministic_sign_ste(z)
        return spatial.like(quantizers.stochastic_sign_ste(z, generator), h)

    def __call__(self, w, x, generator=None, deterministic=True):
        t, remat = self.trunk, self.use_remat
        h = remat_call(remat, t.front, w, x)
        h = remat_call(remat, t.mid_down, w, h)
        if t.binarize in ("before_res", "mid"):
            h = self._binarizer(w, h, generator, deterministic)
        for i in range(t.n_res):
            h = remat_call(remat, t.res_block, w, h, i)
        if t.binarize == "after_res":
            h = self._binarizer(w, h, generator, deterministic)
        h = remat_call(remat, t.mid_up, w, h)
        return remat_call(remat, t.back, w, h)


class FastTrainDecode:
    """``(inputs, generator, deterministic) -> (fake, input_label)``: the
    s2d-domain train decode of ``codec`` (a ``SemanticCodec``), on its live
    parameters (:177-290). Raises ValueError with the failed gate for an
    ineligible config."""

    def __init__(self, cfg: Config, codec):
        reason = fast_train_ineligible_reason(cfg)
        if reason is not None:
            raise ValueError(f"optim.fast_train unavailable: {reason}")
        self.cfg, self.codec = cfg, codec
        m = cfg.model
        # the train-safe switches: no kernel without a backward, no folds
        fp = copy.copy(m.fast.resolved())
        fp.head_pallas, fp.head_fold, fp.fused_realign, fp.front_realign = "0", False, "0", "0"
        self.fp = fp
        use_remat = cfg.optim.remat and cfg.optim.remat_granularity == "block"
        self.remat_decode = cfg.optim.remat and cfg.optim.remat_granularity == "decode"

        def build(module, n_down, n_blocks, binarize):
            if module is None:
                return None
            skel = _FastTrunk(module.state_dict(), n_down, n_blocks, binarize, codec.dtype,
                              None, fp, weights=False)
            return module, _TrainTrunk(skel, use_remat)

        self.netG = build(codec.netG, m.n_downsample_global, m.n_blocks_global, "none")
        self.netE = build(codec.netE, m.n_downsample_E, 0,
                          "none" if m.no_encoder_binarization else "mid")
        self.netE4label = build(codec.netE4label, m.n_downsample_E4label, 0,
                                "none" if m.no_label_encoder_binarization else "mid")

    @staticmethod
    def _run(net, x, generator, deterministic):
        module, trunk = net
        w = _trunk_transforms(dict(module.named_parameters()), trunk.trunk)
        return trunk(w, x, generator, deterministic)

    def __call__(self, inputs, generator: Optional[torch.Generator] = None,
                 deterministic: bool = True):
        if self.remat_decode and torch.is_grad_enabled():
            return checkpoint_decode(self._decode, inputs, generator, deterministic)
        return self._decode(inputs, deterministic, generator)

    def _decode(self, inputs, deterministic, generator):
        """Mirrors ``SemanticCodec._generator_input`` and netG through the
        s2d trunks: netE4label's draws from the generator salted 101,
        netE's from 102."""
        cfg, m = self.cfg, self.cfg.model
        gens = {}
        if generator is not None and not deterministic:
            gens = {s: trunk_generator(generator, s) for s in (NETE4LABEL_SALT, NETE_SALT)}
            # advance the step's generator, so the next step draws anew
            torch.empty(1, device=generator.device).uniform_(generator=generator)
        input_label = inputs["input_label"]
        if self.netE4label is not None:
            input_label = self._run(self.netE4label, input_label, gens.get(NETE4LABEL_SALT),
                                    deterministic)
        feat = None
        if not m.no_feat:
            feat = inputs["compressed_img" if cfg.codec.use_compressed else "real_image"]
            if self.netE is not None:
                feat = self._run(self.netE, feat, gens.get(NETE_SALT), deterministic)
        concat, input_label = assemble(cfg, input_label, feat)
        return self._run(self.netG, concat, None, True), input_label


def make_fast_train_decode(cfg: Config, codec) -> FastTrainDecode:
    """The fast train decode of ``codec``; raises ValueError for an
    ineligible config (callers check :func:`fast_train_ineligible_reason`
    first for a soft path)."""
    return FastTrainDecode(cfg, codec)
