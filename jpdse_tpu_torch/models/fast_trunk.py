"""s2d-transformed trunk forward, the port of
``jpdse_tpu/models/fast_trunk.py::_FastTrunk`` for global trunks.

The head 7x7 conv, the first stride-2 downsample, the last transposed conv
and the 7x7 tail run in the space-to-depth domain with weights transformed
once at construction (ops/s2d.py); the mid trunk runs unchanged. The tail is
the direct s2d conv (the JAX package's ``fast.tail_split=False`` form: its
tap split exists to fill the TPU's 128 output lanes). The back stage
re-aligns the s2d grid with kernel K1 (ops/realign.py).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from jpdse_tpu_torch.models.layers import conv_transpose_nhwc, instance_norm, reflect_pad
from jpdse_tpu_torch.ops.realign import s2d_realign_pad3
from jpdse_tpu_torch.ops.s2d import (
    conv_s1_weights_to_s2d,
    conv_s2_weights_from_s2d_nopad,
    conv_valid,
    convT_s2_weights_to_s2d,
    depth_to_space,
    hwio_to_oihw,
    instance_norm_s2d,
    oihw_to_hwio,
    space_to_depth,
)


def _pad_hw(h: torch.Tensor, top: int, bottom: int, left: int, right: int) -> torch.Tensor:
    """Zero pad of an NHWC tensor's H and W axes."""
    return F.pad(h, (0, 0, left, right, top, bottom))


class _FastTrunk:
    """Transformed weights + staged forward for one GlobalGenerator or
    Encoder trunk. ``state``: the trunk's state dict (keys as in
    ``models/generator.py``). ``binarize``: 'none' or 'mid' (an encoder's
    binarizer between its downs and ups)."""

    def __init__(self, state: Dict[str, torch.Tensor], n_down: int, n_blocks: int,
                 binarize: str, dtype: torch.dtype, device):
        self.n_down, self.n_res, self.binarize = n_down, n_blocks, binarize
        self.dtype = dtype

        def cl(t):  # a weight in the compute dtype, channels-last like the activations
            return t.detach().to(device=device, dtype=dtype).contiguous(
                memory_format=torch.channels_last)

        def vec(t):
            return t.detach().to(device=device, dtype=dtype)

        def s2d_w(w: np.ndarray):
            return hwio_to_oihw(w, device, dtype)

        w: Dict[str, torch.Tensor] = {}
        w["head_w"] = s2d_w(conv_s1_weights_to_s2d(oihw_to_hwio(state["head.conv.conv.weight"])))
        w["head_b"] = vec(state["head.conv.conv.bias"].repeat(4))
        w["down0_w"] = s2d_w(conv_s2_weights_from_s2d_nopad(
            oihw_to_hwio(state["down.0.conv.conv.weight"])))
        w["down0_b"] = vec(state["down.0.conv.conv.bias"])
        for i in range(1, n_down):
            w[f"down{i}_w"] = cl(state[f"down.{i}.conv.conv.weight"])
            w[f"down{i}_b"] = vec(state[f"down.{i}.conv.conv.bias"])
        for i in range(n_blocks):
            for j in (1, 2):
                w[f"res{i}_w{j}"] = cl(state[f"res.{i}.conv{j}.conv.weight"])
                w[f"res{i}_b{j}"] = vec(state[f"res.{i}.conv{j}.conv.bias"])
        for i in range(n_down - 1):
            w[f"up{i}_w"] = vec(state[f"up.{i}.deconv.weight"])
            w[f"up{i}_b"] = vec(state[f"up.{i}.deconv.bias"])
        # last upsample straight into s2d form: g is the effective correlation
        # kernel, the (in, out, kh, kw) ConvTranspose weight as (kh, kw, in, out), flipped
        wl = state[f"up.{n_down - 1}.deconv.weight"].detach().float().cpu().numpy()
        g = np.flip(wl.transpose(2, 3, 0, 1), axis=(0, 1))
        w["uplast_w"] = s2d_w(convT_s2_weights_to_s2d(np.ascontiguousarray(g)))
        w["uplast_b"] = vec(state[f"up.{n_down - 1}.deconv.bias"].repeat(4))
        w["tail_w"] = s2d_w(conv_s1_weights_to_s2d(oihw_to_hwio(state["tail.conv.weight"])))
        w["tail_b"] = vec(state["tail.conv.bias"].repeat(4))
        if binarize != "none":
            w["bin_w"] = cl(state["binarizer.conv.weight"])
        self.weights = w

    # -- stages -----------------------------------------------------------
    def front(self, x: torch.Tensor) -> torch.Tensor:
        """Fine input -> normal-domain tensor after down0 (H/2, W/2, C1)."""
        w = self.weights
        xp = space_to_depth(reflect_pad(x.to(self.dtype), 3))
        h = conv_valid(xp, w["head_w"], w["head_b"])
        h = torch.relu(instance_norm_s2d(h))
        h = conv_valid(_pad_hw(h, 1, 0, 1, 0), w["down0_w"], w["down0_b"])
        return torch.relu(instance_norm(h))

    def mid_down(self, h: torch.Tensor) -> torch.Tensor:
        w = self.weights
        for i in range(1, self.n_down):
            h = conv_valid(_pad_hw(h, 1, 1, 1, 1), w[f"down{i}_w"], w[f"down{i}_b"], stride=2)
            h = torch.relu(instance_norm(h))
        return h

    def apply_binarizer(self, h: torch.Tensor) -> torch.Tensor:
        return torch.sign(torch.tanh(conv_valid(h, self.weights["bin_w"])))

    def res_blocks(self, h: torch.Tensor) -> torch.Tensor:
        w = self.weights
        for i in range(self.n_res):
            r = conv_valid(reflect_pad(h, 1), w[f"res{i}_w1"], w[f"res{i}_b1"])
            r = torch.relu(instance_norm(r))
            r = conv_valid(reflect_pad(r, 1), w[f"res{i}_w2"], w[f"res{i}_b2"])
            h = h + instance_norm(r)
        return h

    def mid_up(self, h: torch.Tensor) -> torch.Tensor:
        w = self.weights
        for i in range(self.n_down - 1):
            h = torch.relu(instance_norm(conv_transpose_nhwc(h, w[f"up{i}_w"], w[f"up{i}_b"])))
        return h

    def back(self, h: torch.Tensor) -> torch.Tensor:
        """Normal-domain (H/2, W/2, C) -> fine output with tanh."""
        w = self.weights
        y = conv_valid(_pad_hw(h, 0, 1, 0, 1), w["uplast_w"], w["uplast_b"])
        y = torch.relu(instance_norm_s2d(y))
        yp = s2d_realign_pad3(y.contiguous())
        return depth_to_space(torch.tanh(conv_valid(yp, w["tail_w"], w["tail_b"])))

    # -- full passes --------------------------------------------------------
    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        h = self.mid_down(self.front(x))
        if self.binarize == "mid":
            h = self.apply_binarizer(h)
        return self.back(self.mid_up(self.res_blocks(h)))

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """Fine input -> {-1, 0, +1} code (through the binarizer)."""
        if self.binarize == "none":
            raise ValueError("no binarizer in this trunk")
        return self.apply_binarizer(self.mid_down(self.front(x)))

    def decode_from_code(self, code_pm1: torch.Tensor) -> torch.Tensor:
        """Resume after the binarizer from a {-1, +1} code."""
        if self.binarize == "none":
            raise ValueError("no binarizer in this trunk")
        return self.back(self.mid_up(code_pm1.to(self.dtype)))
