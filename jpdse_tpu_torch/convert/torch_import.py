"""Import reference PyTorch checkpoints (``net_G.pth`` / ``net_E.pth`` /
``net_E4label.pth`` / ``net_D.pth``, CPU state dicts written by the
reference's ``base_model.py:54-59``) into the port's state dicts, the twin
of ``jpdse_tpu/convert/torch_import.py:60-166``.

The reference stores each network as one ``nn.Sequential``, so its keys are
positional (``model.<idx>.weight``); the index arithmetic follows its
construction order (``networks.py``):

* GlobalGenerator (:210-247): 0 ReflectionPad, 1 Conv7, 2 norm, 3 act,
  then per downsample [Conv3s2, norm, act], an optional Binarizer,
  n_blocks ResnetBlock, an optional Binarizer, per upsample [ConvT3s2,
  norm, act], ReflectionPad, Conv7, Tanh;
* Encoder (:312-338): the same without residual blocks;
* ResnetBlock.conv_block (:272-301): 0 pad, 1 conv, 2 norm, 3 act, 4 pad,
  5 conv, 6 norm;
* MultiscaleDiscriminator with getIntermFeat (:379-386):
  ``scale{i}_layer{j}.0`` for the conv of each per-layer Sequential.

The reference is PyTorch, and so are the port's layouts: a conv weight
stays OIHW and a ConvTranspose weight stays (in, out, kh, kw) (the
reference's networks are ungrouped), so each tensor only changes its name,
cast to fp32. Names are the port's (``netG.down.0.conv.conv.weight``,
``convert/__init__.py``).
"""

from __future__ import annotations

import os
from typing import Dict, Mapping

import torch

StateDict = Dict[str, torch.Tensor]


def _state_dict(path_or_sd) -> Mapping[str, torch.Tensor]:
    if isinstance(path_or_sd, (str, os.PathLike)):
        return torch.load(path_or_sd, map_location="cpu", weights_only=True)
    return path_or_sd


def _take(out: StateDict, sd: Mapping, key: str, name: str) -> None:
    """``key``'s weight (and bias, where there is one) under ``name``."""
    out[f"{name}.weight"] = sd[f"{key}.weight"].detach().float().clone()
    if f"{key}.bias" in sd:
        out[f"{name}.bias"] = sd[f"{key}.bias"].detach().float().clone()


def convert_global_generator(sd, n_downsampling: int = 4, n_blocks: int = 9,
                             binarize: bool = False, bin_before_res: bool = False) -> StateDict:
    """A reference GlobalGenerator's state dict -> the port's
    ``GlobalGenerator`` state dict (head, down.i, binarizer, res.i, up.i,
    tail)."""
    sd = _state_dict(sd)
    out: StateDict = {}
    idx = 1  # 0 is the ReflectionPad
    _take(out, sd, f"model.{idx}", "head.conv.conv")
    idx += 3  # conv, norm, act
    for i in range(n_downsampling):
        _take(out, sd, f"model.{idx}", f"down.{i}.conv.conv")
        idx += 3
    if binarize and bin_before_res:
        _take(out, sd, f"model.{idx}.conv", "binarizer.conv")
        idx += 1
    for i in range(n_blocks):
        base = f"model.{idx}.conv_block"
        _take(out, sd, f"{base}.1", f"res.{i}.conv1.conv")
        _take(out, sd, f"{base}.5", f"res.{i}.conv2.conv")
        idx += 1
    if binarize and not bin_before_res:
        _take(out, sd, f"model.{idx}.conv", "binarizer.conv")
        idx += 1
    for i in range(n_downsampling):
        _take(out, sd, f"model.{idx}", f"up.{i}.deconv")
        idx += 3
    idx += 1  # the last ReflectionPad
    _take(out, sd, f"model.{idx}", "tail.conv")
    return out


def convert_encoder(sd, n_downsampling: int = 4, binarize: bool = True) -> StateDict:
    """A reference Encoder's state dict -> the port's ``Encoder``'s."""
    sd = _state_dict(sd)
    out: StateDict = {}
    idx = 1
    _take(out, sd, f"model.{idx}", "head.conv.conv")
    idx += 3
    for i in range(n_downsampling):
        _take(out, sd, f"model.{idx}", f"down.{i}.conv.conv")
        idx += 3
    if binarize:
        _take(out, sd, f"model.{idx}.conv", "binarizer.conv")
        idx += 1
    for i in range(n_downsampling):
        _take(out, sd, f"model.{idx}", f"up.{i}.deconv")
        idx += 3
    idx += 1
    _take(out, sd, f"model.{idx}", "tail.conv")
    return out


def convert_multiscale_discriminator(sd, num_D: int = 2, n_layers: int = 3) -> StateDict:
    """A reference MultiscaleDiscriminator (getIntermFeat layout) -> the
    port's: ``scale{i}.layer{j}`` for j <= n_layers, ``scale{i}.pred`` for
    the last conv."""
    sd = _state_dict(sd)
    out: StateDict = {}
    for i in range(num_D):
        for j in range(n_layers + 2):
            name = f"layer{j}" if j <= n_layers else "pred"
            _take(out, sd, f"scale{i}_layer{j}.0", f"scale{i}.{name}.conv")
    return out


def _prefixed(prefix: str, sd: StateDict) -> StateDict:
    return {f"{prefix}.{k}": v for k, v in sd.items()}


def import_reference_checkpoint(checkpoints_dir: str, cfg,
                                template: Mapping[str, torch.Tensor]) -> StateDict:
    """The codec's state dict ``template`` with ``net_G.pth`` (and
    ``net_E.pth`` / ``net_E4label.pth`` where the configuration has those
    encoders) from a reference checkpoint directory in place of its
    networks' entries; a network without its file keeps the template's."""
    m = cfg.model
    out = dict(template)
    g_path = os.path.join(checkpoints_dir, "net_G.pth")
    if os.path.exists(g_path):
        out.update(_prefixed("netG", convert_global_generator(
            g_path, m.n_downsample_global, m.n_blocks_global,
            binarize=not m.no_generator_binarization,
            bin_before_res=m.bin_generator_before_res)))
    e_path = os.path.join(checkpoints_dir, "net_E.pth")
    if cfg.use_netE and os.path.exists(e_path):
        out.update(_prefixed("netE", convert_encoder(
            e_path, m.n_downsample_E, binarize=not m.no_encoder_binarization)))
    e4_path = os.path.join(checkpoints_dir, "net_E4label.pth")
    if cfg.use_netE4label and os.path.exists(e4_path):
        out.update(_prefixed("netE4label", convert_encoder(
            e4_path, m.n_downsample_E4label, binarize=not m.no_label_encoder_binarization)))
    return out


def import_reference_discriminator(checkpoints_dir: str, cfg,
                                   template: Mapping[str, torch.Tensor]) -> StateDict:
    """The discriminator's state dict ``template`` with ``net_D.pth`` in
    place where the directory has one."""
    out = dict(template)
    d_path = os.path.join(checkpoints_dir, "net_D.pth")
    if os.path.exists(d_path):
        out.update(convert_multiscale_discriminator(d_path, cfg.model.num_D,
                                                    cfg.model.n_layers_D))
    return out
