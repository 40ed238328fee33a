"""s2d-transformed trunk forward, the port of
``jpdse_tpu/models/fast_trunk.py::_FastTrunk`` for global trunks.

The head 7x7 conv, the first stride-2 downsample, the last transposed conv
and the 7x7 tail run in the space-to-depth domain with weights transformed
once at construction (ops/s2d.py); the mid trunk runs unchanged. The tail is
the direct s2d conv (the JAX package's ``fast.tail_split=False`` form: its
tap split exists to fill the TPU's 128 output lanes). The back stage
re-aligns the s2d grid with kernel K1 (ops/realign.py).

The kernel switches of ``config.FastPathConfig`` pick the front:
``head_pallas`` runs a wide head (s2d input of >= 64 channels, or every
head with 'force') as kernel K4 (ops/head_conv.py) fed by K1 with extra
rows and its channels padded to a multiple of 8 (zero weights for the
padding); ``front_realign`` enters the s2d domain of the other heads through
kernel K2 (ops/realign.py ``s2d_pad3``).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from jpdse_tpu_torch.config import FastPathConfig
from jpdse_tpu_torch.models.layers import conv_transpose_nhwc, instance_norm, reflect_pad
from jpdse_tpu_torch.ops.head_conv import head_conv_extra_rows, head_conv_s2d, padded_channels
from jpdse_tpu_torch.ops.realign import s2d_pad3, s2d_realign_pad3
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
    weights_fold_w,
)


def _pad_hw(h: torch.Tensor, top: int, bottom: int, left: int, right: int) -> torch.Tensor:
    """Zero pad of an NHWC tensor's H and W axes."""
    return F.pad(h, (0, 0, left, right, top, bottom))


class _FastTrunk:
    """Transformed weights + staged forward for one GlobalGenerator or
    Encoder trunk. ``state``: the trunk's state dict (keys as in
    ``models/generator.py``). ``binarize``: 'none' or 'mid' (an encoder's
    binarizer between its downs and ups). ``fp``: the resolved kernel
    switches."""

    def __init__(self, state: Dict[str, torch.Tensor], n_down: int, n_blocks: int,
                 binarize: str, dtype: torch.dtype, device, fp: FastPathConfig):
        self.n_down, self.n_res, self.binarize = n_down, n_blocks, binarize
        self.dtype, self.fp = dtype, fp

        def cl(t):  # a weight in the compute dtype, channels-last like the activations
            return t.detach().to(device=device, dtype=dtype).contiguous(
                memory_format=torch.channels_last)

        def vec(t):
            return t.detach().to(device=device, dtype=dtype)

        def s2d_w(w: np.ndarray):
            return hwio_to_oihw(w, device, dtype)

        w: Dict[str, torch.Tensor] = {}
        wp_head = conv_s1_weights_to_s2d(oihw_to_hwio(state["head.conv.conv.weight"]))
        self.head_kp, _, c4, _ = wp_head.shape
        head = self.fp.head_pallas
        # K4 for heads whose s2d input is wide (JAX: fast_trunk.py:114-129)
        self.head_fold = "pallas" if head == "force" or (head == "1" and c4 >= 64) else "none"
        if self.head_fold == "pallas":
            # K4 reads padded_channels(c4) input channels; the padding's weights are 0
            self.head_c = padded_channels(c4)
            wp_pad = np.pad(wp_head, ((0, 0), (0, 0), (0, self.head_c - c4), (0, 0)))
            w["head_w"] = torch.from_numpy(np.ascontiguousarray(weights_fold_w(wp_pad).reshape(
                self.head_kp, self.head_kp * self.head_c, -1))).to(device=device, dtype=dtype)
        else:
            w["head_w"] = s2d_w(wp_head)
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
        x = x.to(self.dtype)
        if self.head_fold == "pallas":
            h = self._front_head_pallas(x)
        else:
            if self.fp.front_realign in ("auto", "pallas"):
                xp = s2d_pad3(x.contiguous())
            else:
                xp = space_to_depth(reflect_pad(x, 3))
            h = conv_valid(xp, w["head_w"], w["head_b"])
        h = torch.relu(instance_norm_s2d(h))
        h = conv_valid(_pad_hw(h, 1, 0, 1, 0), w["down0_w"], w["down0_b"])
        return torch.relu(instance_norm(h))

    def _front_head_pallas(self, x: torch.Tensor) -> torch.Tensor:
        """The head conv as K4, with the JAX package's producer: plain
        space_to_depth, then K1 re-aligning it with the extra rows K4's
        TPU form needed (fast_trunk.py:272-305) and zero channels up to
        the multiple of 8 that K4's TMA needs, then the bias."""
        kp = self.head_kp
        ho = x.shape[1] // 2
        xp = s2d_realign_pad3(space_to_depth(x), extra_rows=head_conv_extra_rows(ho, kp),
                              channels=self.head_c)
        return head_conv_s2d(xp, self.weights["head_w"], kp, ho=ho) + self.weights["head_b"]

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
