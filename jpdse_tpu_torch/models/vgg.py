"""VGG19 feature extractor for the perceptual loss, the port of
``jpdse_tpu/models/vgg.py``: the activations after relu1_1, relu2_1,
relu3_1, relu4_1 and relu5_1 (NHWC), with the JAX package's weight file
layout (``.npz`` of ``conv{s}_{i}.kernel`` HWIO and ``.bias``).

Without a weights file the trunk takes a random init from an explicit
generator, as the JAX package's flagship runs did (no converted VGG19
weights are in the repository).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from jpdse_tpu_torch.models.layers import conv_nhwc

# (channels, convs in the stage) per VGG19 stage
STAGES = ((64, 2), (128, 2), (256, 4), (512, 4), (512, 4))
SLICE_AT = ("conv1_1", "conv2_1", "conv3_1", "conv4_1", "conv5_1")


def conv_names() -> List[str]:
    """The convs the trunk runs through conv5_1, in order."""
    names = []
    for s, (_, n) in enumerate(STAGES, start=1):
        names += [f"conv{s}_{c}" for c in range(1, n + 1)]
    return names[: names.index(SLICE_AT[-1]) + 1]


class Vgg19Features(nn.Module):
    """3x3 same-padded convs with ReLU, 2x2 max pools between stages; returns
    the five relu{k}_1 activations."""

    def __init__(self):
        super().__init__()
        in_ch = 3
        for name in conv_names():
            out = STAGES[int(name[4]) - 1][0]
            self.add_module(name, nn.Conv2d(in_ch, out, 3, padding=1))
            in_ch = out

    def forward(self, x) -> List[torch.Tensor]:
        """The five slices, computed in the trunk's own dtype (fp32 for a
        bf16 image, as the JAX package's fp32 trunk takes one)."""
        x = x.to(self.conv1_1.weight.dtype)
        outs = []
        for name in conv_names():
            if name.endswith("_1") and name != "conv1_1":
                x = F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)
            conv = getattr(self, name)
            x = torch.relu(conv_nhwc(x, conv.weight, conv.bias, 1, 1))
            if name in SLICE_AT:
                outs.append(x)
        return outs


def load_vgg19_params(path: str) -> Dict[str, torch.Tensor]:
    """A converted ``.npz`` (the JAX package's layout) as a Vgg19Features
    state dict."""
    data = np.load(path)
    state = {}
    for key in data.files:
        name, kind = key.rsplit(".", 1)
        a = np.asarray(data[key], np.float32)
        if kind == "kernel":
            state[f"{name}.weight"] = torch.from_numpy(a.transpose(3, 2, 0, 1).copy())
        else:
            state[f"{name}.bias"] = torch.from_numpy(a.copy())
    return state


def init_vgg19(device, generator: Optional[torch.Generator],
               weights_path: Optional[str] = None) -> Vgg19Features:
    """The frozen trunk on ``device``: the converted weights when given, else
    a random init from ``generator`` (conv kernels normal with variance
    1 / fan_in, the scale of Flax's default init, untruncated; biases 0).
    Its parameters need no gradient."""
    with torch.device("meta"):
        vgg = Vgg19Features()
    vgg = vgg.to_empty(device=device)
    with torch.no_grad():
        if weights_path:
            vgg.load_state_dict(load_vgg19_params(weights_path))
        else:
            for name in conv_names():
                conv = getattr(vgg, name)
                fan_in = conv.weight[0].numel()
                conv.weight.normal_(0.0, 1.0, generator=generator)
                conv.weight.mul_(fan_in ** -0.5)
                conv.bias.zero_()
    return vgg.requires_grad_(False).eval()
