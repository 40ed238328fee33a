"""Reference-architecture PyTorch builders and preprocessing, written from
the reference's spec (cited file:line below): the port's own copy of
``jpdse_tpu/convert/torch_ref.py``, the golden stack that the reference
checkpoint import (``convert/torch_import.py``) is held against.

Beside the JAX package's copy, ``RefGlobalGenerator`` takes the reference
GlobalGenerator's optional bottleneck Binarizer (``networks.py:210-247``),
after its residual blocks or, with ``bin_before_res``, before them, so the
import of a binarized generator has a golden stack too; without it the
networks, their keys and their outputs are the JAX package's copy's.

Nothing here runs on the port's serving or training paths.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as tnn


class RefResnetBlock(tnn.Module):
    """pix2pixHD residual block spec (networks.py:266-305): reflect pad,
    3x3 conv, InstanceNorm(affine=False), ReLU, reflect pad, 3x3 conv,
    InstanceNorm — plus identity skip. Attribute named ``conv_block`` to
    reproduce the reference checkpoint key layout."""

    def __init__(self, dim: int):
        super().__init__()
        self.conv_block = tnn.Sequential(
            tnn.ReflectionPad2d(1),
            tnn.Conv2d(dim, dim, 3),
            tnn.InstanceNorm2d(dim, affine=False),
            tnn.ReLU(True),
            tnn.ReflectionPad2d(1),
            tnn.Conv2d(dim, dim, 3),
            tnn.InstanceNorm2d(dim, affine=False),
        )

    def forward(self, x):
        return x + self.conv_block(x)


class RefGlobalGenerator(tnn.Module):
    """GlobalGenerator spec (networks.py:198-247): ReflectionPad(3) + 7x7 conv
    + norm + ReLU, n_down strided 3x3 convs, n_blocks res blocks, mirrored
    ConvTranspose2d(3, 2, 1, output_padding=1) upsampling, ReflectionPad(3) +
    7x7 conv + Tanh, with an optional bottleneck RefBinarizer
    (``binarizer_out_channels``) after the res blocks or, with
    ``bin_before_res``, before them (they then run at its width). Held in
    ``self.model`` so state_dict keys are ``model.<idx>.*`` exactly like
    reference checkpoints (base_model.py:54-59)."""

    def __init__(self, input_nc, output_nc, ngf=64, n_downsampling=4, n_blocks=9,
                 binarizer_out_channels=None, bin_before_res=False):
        super().__init__()
        layers = [
            tnn.ReflectionPad2d(3),
            tnn.Conv2d(input_nc, ngf, 7),
            tnn.InstanceNorm2d(ngf, affine=False),
            tnn.ReLU(True),
        ]
        for i in range(n_downsampling):
            m = 2**i
            layers += [
                tnn.Conv2d(ngf * m, ngf * m * 2, 3, 2, 1),
                tnn.InstanceNorm2d(ngf * m * 2, affine=False),
                tnn.ReLU(True),
            ]
        m = 2**n_downsampling
        width = ngf * m
        binarizer = None
        if binarizer_out_channels is not None:
            binarizer = RefBinarizer(width, binarizer_out_channels)
        if binarizer is not None and bin_before_res:
            layers.append(binarizer)
            width = binarizer_out_channels
        for _ in range(n_blocks):
            layers.append(RefResnetBlock(width))
        if binarizer is not None and not bin_before_res:
            layers.append(binarizer)
            width = binarizer_out_channels
        for i in range(n_downsampling):
            m = 2 ** (n_downsampling - i)
            layers += [
                tnn.ConvTranspose2d(width, ngf * m // 2, 3, 2, 1, output_padding=1),
                tnn.InstanceNorm2d(ngf * m // 2, affine=False),
                tnn.ReLU(True),
            ]
            width = ngf * m // 2
        layers += [tnn.ReflectionPad2d(3), tnn.Conv2d(ngf, output_nc, 7), tnn.Tanh()]
        self.model = tnn.Sequential(*layers)

    def forward(self, x):
        return self.model(x)


def reference_weights_init(module: tnn.Module):
    """weights_init spec (networks.py:19-25): conv weights ~ normal(0, 0.02),
    BatchNorm gamma ~ normal(1, 0.02), beta 0."""
    name = module.__class__.__name__
    if name.find("Conv") != -1 and hasattr(module, "weight"):
        module.weight.data.normal_(0.0, 0.02)
        if getattr(module, "bias", None) is not None:
            module.bias.data.zero_()
    elif name.find("BatchNorm2d") != -1:
        module.weight.data.normal_(1.0, 0.02)
        module.bias.data.fill_(0)


def build_phase2_generator(
    semantic_nc: int = 35, input_nc: int = 3, ngf: int = 64,
    n_downsampling: int = 4, n_blocks: int = 9, seed: int = 0,
) -> RefGlobalGenerator:
    """The flagship phase-2 inference configuration's netG
    (scripts/pix2pixHD_bpg_train.sh:5-7: --no_label_encoding
    --no_feat_encoding --no_generator_binarization --use_compressed):
    input = one-hot semantics (semantic_nc) + edge map (1) + base-codec
    decoded visuals (input_nc), per the channel arithmetic at
    pix2pixHD_model.py:117-133."""
    torch.manual_seed(seed)
    g = RefGlobalGenerator(semantic_nc + 1 + input_nc, 3, ngf, n_downsampling, n_blocks)
    g.apply(reference_weights_init)
    return g.eval()


# ---------------------------------------------------------------------------
# torch-side model preprocessing, from spec (independent re-derivation used to
# cross-check the framework's jnp ops)
# ---------------------------------------------------------------------------

def one_hot_label_np(label: np.ndarray, num_channels: int) -> np.ndarray:
    """One-hot scatter spec (pix2pixHD_model.py:376-387). label: (H, W) int.
    Returns (H, W, num_channels) float32."""
    label = np.clip(label.astype(np.int64), 0, num_channels - 1)
    out = np.zeros(label.shape + (num_channels,), np.float32)
    np.put_along_axis(out, label[..., None], 1.0, axis=-1)
    return out


def instance_edges_np(inst: np.ndarray) -> np.ndarray:
    """get_edges spec (pix2pixHD_model.py:774-783): a pixel is an edge when
    its instance id differs from any 4-neighbor. inst: (H, W) int ->
    (H, W, 1) float32 in {0,1}."""
    edge = np.zeros(inst.shape, bool)
    edge[:, 1:] |= inst[:, 1:] != inst[:, :-1]
    edge[:, :-1] |= inst[:, 1:] != inst[:, :-1]
    edge[1:, :] |= inst[1:, :] != inst[:-1, :]
    edge[:-1, :] |= inst[1:, :] != inst[:-1, :]
    return edge.astype(np.float32)[..., None]


def phase2_generator_input(
    label: np.ndarray, instance: np.ndarray, compressed: np.ndarray,
    semantic_nc: int = 35,
) -> np.ndarray:
    """Assemble netG's input for the phase-2 config in the reference's channel
    order (pix2pixHD_model.py:545-606): [one-hot | edge | decoded visuals].
    Returns (H, W, semantic_nc + 1 + C) float32 (NHWC; callers transpose for
    torch)."""
    oh = one_hot_label_np(label, semantic_nc)
    edge = instance_edges_np(instance)
    return np.concatenate([oh, edge, compressed.astype(np.float32)], axis=-1)


@torch.no_grad()
def torch_decode(gen: RefGlobalGenerator, gen_input_nhwc: np.ndarray) -> np.ndarray:
    """(H, W, C) or (B, H, W, C) input -> reconstruction, NHWC float32."""
    x = gen_input_nhwc
    if x.ndim == 3:
        x = x[None]
    t = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))
    y = gen(t)
    return y.numpy().transpose(0, 2, 3, 1)


class RefBinarizer(tnn.Module):
    """Binarizer spec (quantizers/binarize.py:44-54): bias-free 1x1 conv +
    tanh + sign (deterministic eval form, binarize.py:36-41). Checkpoint key
    layout: ``<idx>.conv.weight``."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.conv = tnn.Conv2d(in_ch, out_ch, 1, bias=False)

    def forward(self, x):
        return torch.sign(torch.tanh(self.conv(x)))


class RefEncoder(tnn.Module):
    """Encoder spec (networks.py:307-338, ungrouped): ReflectionPad(3) + 7x7
    conv + IN + ReLU, n strided 3x3 convs, Binarizer, mirrored
    ConvTranspose2d(3,2,1,op=1) ups, ReflectionPad(3) + 7x7 conv + Tanh.
    ``self.model`` matches reference checkpoint keys (net_E.pth /
    net_E4label.pth)."""

    def __init__(self, input_nc, output_nc, nef=64, n_downsampling=4,
                 binarizer_out_channels=128):
        super().__init__()
        layers = [
            tnn.ReflectionPad2d(3),
            tnn.Conv2d(input_nc, nef, 7),
            tnn.InstanceNorm2d(nef, affine=False),
            tnn.ReLU(True),
        ]
        for i in range(n_downsampling):
            m = 2**i
            layers += [
                tnn.Conv2d(nef * m, nef * m * 2, 3, 2, 1),
                tnn.InstanceNorm2d(nef * m * 2, affine=False),
                tnn.ReLU(True),
            ]
        layers.append(RefBinarizer(nef * 2**n_downsampling, binarizer_out_channels))
        up_in = binarizer_out_channels
        for i in range(n_downsampling):
            m = 2 ** (n_downsampling - i)
            layers += [
                tnn.ConvTranspose2d(up_in, nef * m // 2, 3, 2, 1, output_padding=1),
                tnn.InstanceNorm2d(nef * m // 2, affine=False),
                tnn.ReLU(True),
            ]
            up_in = nef * m // 2
        layers += [tnn.ReflectionPad2d(3), tnn.Conv2d(nef, output_nc, 7), tnn.Tanh()]
        self.model = tnn.Sequential(*layers)

    def forward(self, x):
        return self.model(x)


class RefLearnedCodec(tnn.Module):
    """The fully-learned flagship: binarized label encoder + binarized visual
    encoder feeding the global generator (channel arithmetic per
    pix2pixHD_model.py:117-183 with label/feat encoding on)."""

    def __init__(self, semantic_nc=35, input_nc=3, label_out=36, feat_num=3,
                 ngf=64, nef=64, ne4lf=64, n_down=4, enc_bits=128,
                 lab_bits=128, n_blocks=9, seed=0):
        super().__init__()
        torch.manual_seed(seed)
        self.netE4label = RefEncoder(semantic_nc + 1, label_out, ne4lf, n_down, lab_bits)
        self.netE = RefEncoder(input_nc, feat_num, nef, n_down, enc_bits)
        self.netG = RefGlobalGenerator(label_out + feat_num, 3, ngf, n_down, n_blocks)
        self.apply(reference_weights_init)
        self.eval()

    def forward(self, one_hot_edge, image):
        lab = self.netE4label(one_hot_edge)
        feat = self.netE(image)
        return self.netG(torch.cat([lab, feat], 1))
