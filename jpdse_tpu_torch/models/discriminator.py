"""PatchGAN discriminators (NHWC), the port of
``jpdse_tpu/models/discriminator.py:22-92``.

``NLayerDiscriminator`` returns its per-layer feature list [layer0, ...,
prediction]; ``MultiscaleDiscriminator`` runs ``num_D`` of them over an
``avg_pool_3s2`` pyramid, the i-th result from the discriminator named
``scale{num_D-1-i}`` on the i-times-downsampled input. Submodule names are
the Flax ones (``scale1.layer0.conv.weight`` is Flax's
``scale1/layer0/conv/kernel``). The norms are the plain InstanceNorm, as in
the JAX package: K3 serves the generator's sites only.
"""

from __future__ import annotations

from typing import List, Optional

import torch
from torch import nn

from jpdse_tpu_torch.config import NotPorted
from jpdse_tpu_torch.models.layers import Conv, avg_pool_3s2, build, instance_norm, leaky_relu


def _norm(kind: str):
    if kind == "instance":
        return instance_norm
    if kind == "identity":
        return lambda x: x
    if kind == "batch":
        raise NotPorted("the discriminator's batch norm is ROADMAP Queue 1 item 10")
    raise NotImplementedError(f"norm [{kind}] not found")


class NLayerDiscriminator(nn.Module):
    """4x4-kernel PatchGAN: stride-2 convs to ``n_layers``, one stride-1 conv,
    the stride-1 prediction; zero padding 2, leaky ReLU 0.2."""

    def __init__(self, input_nc: int, ndf: int = 64, n_layers: int = 3, norm: str = "instance",
                 use_sigmoid: bool = False):
        super().__init__()
        self.norm, self.use_sigmoid, self.n_layers = _norm(norm), use_sigmoid, n_layers
        kw, padw = 4, 2
        widths = [ndf]
        for _ in range(1, n_layers + 1):
            widths.append(min(widths[-1] * 2, 512))
        for n in range(n_layers + 1):
            stride = 2 if n < n_layers else 1
            setattr(self, f"layer{n}", Conv(input_nc if n == 0 else widths[n - 1], widths[n],
                                            kw, stride, padw))
        self.pred = Conv(widths[n_layers], 1, kw, 1, padw)

    def forward(self, x) -> List[torch.Tensor]:
        feats = []
        h = leaky_relu(self.layer0(x))
        feats.append(h)
        for n in range(1, self.n_layers + 1):
            h = leaky_relu(self.norm(getattr(self, f"layer{n}")(h)))
            feats.append(h)
        h = self.pred(h)
        feats.append(torch.sigmoid(h) if self.use_sigmoid else h)
        return feats


class MultiscaleDiscriminator(nn.Module):
    """``num_D`` PatchGANs over an AvgPool(3, 2, 1, count_include_pad=False)
    pyramid; ``keep_input`` prepends each scale's input to its list."""

    def __init__(self, input_nc: int, ndf: int = 64, n_layers: int = 3, num_D: int = 2,
                 norm: str = "instance", use_sigmoid: bool = False):
        super().__init__()
        self.num_D = num_D
        for i in range(num_D):
            self.add_module(f"scale{i}", NLayerDiscriminator(input_nc, ndf, n_layers, norm,
                                                             use_sigmoid))

    def forward(self, x, keep_input: bool = False) -> List[List[torch.Tensor]]:
        results = []
        h = x
        for i in range(self.num_D):
            feats = getattr(self, f"scale{self.num_D - 1 - i}")(h)
            results.append([h] + feats if keep_input else feats)
            if i != self.num_D - 1:
                h = avg_pool_3s2(h)
        return results


def build_discriminator(cfg, device, generator: Optional[torch.Generator]):
    """The config's discriminator on ``device``, its weights drawn from
    ``generator`` by the reference's law (kernels normal(0, 0.02), biases 0),
    the law of the JAX package's ``Conv`` init; zeros if None."""
    m = cfg.model
    return build(lambda: MultiscaleDiscriminator(
        cfg.netD_input_nc, m.ndf, m.n_layers_D, m.num_D, m.norm, use_sigmoid=m.no_lsgan),
        device, generator)
