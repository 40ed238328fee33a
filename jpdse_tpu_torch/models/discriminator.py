"""PatchGAN discriminators (NHWC), the port of
``jpdse_tpu/models/discriminator.py:22-92``.

``NLayerDiscriminator`` returns its per-layer feature list [layer0, ...,
prediction]; ``MultiscaleDiscriminator`` runs ``num_D`` of them over an
``avg_pool_3s2`` pyramid, the i-th result from the discriminator named
``scale{num_D-1-i}`` on the i-times-downsampled input. Submodule names are
the Flax ones (``scale1.layer0.conv.weight`` is Flax's
``scale1/layer0/conv/kernel``, ``scale1.norm1.BatchNorm_0.scale`` its
``scale1/norm1/BatchNorm_0/scale``). The norms are the plain
``layers.Norm``, as in the JAX package: K3 serves the generator's sites
only. ``mode`` is the batch norm's (``layers.norm_mode``): the running
averages by default, as JAX's ``train=False``; the training step reads D
with the batch's statistics (``BATCH``, G's loss) and advances them
(``UPDATE``, D's own loss).

Under the spatial axis (``parallel/spatial.py``) a layer's input is this
rank's rows, and its kw-4, pad-2 convs give ``hg / 2 + 1`` rows (stride 2)
or ``hg + 1`` (stride 1): rows that do not split evenly, each owned by one
rank. Every feature is marked with its global height, which the losses
count by (``train/losses.py``).
"""

from __future__ import annotations

from typing import List, Optional

import torch
from torch import nn

from jpdse_tpu_torch.models.layers import RUNNING, Conv, Norm, avg_pool_3s2, build, leaky_relu, \
    norm_mode
from jpdse_tpu_torch.parallel import spatial


class NLayerDiscriminator(nn.Module):
    """4x4-kernel PatchGAN: stride-2 convs to ``n_layers``, one stride-1 conv,
    the stride-1 prediction; zero padding 2, leaky ReLU 0.2."""

    def __init__(self, input_nc: int, ndf: int = 64, n_layers: int = 3, norm: str = "instance",
                 use_sigmoid: bool = False):
        super().__init__()
        self.use_sigmoid, self.n_layers = use_sigmoid, n_layers
        kw, padw = 4, 2
        widths = [ndf]
        for _ in range(1, n_layers + 1):
            widths.append(min(widths[-1] * 2, 512))
        for n in range(n_layers + 1):
            stride = 2 if n < n_layers else 1
            setattr(self, f"layer{n}", Conv(input_nc if n == 0 else widths[n - 1], widths[n],
                                            kw, stride, padw))
            if n:
                setattr(self, f"norm{n}", Norm(norm, widths[n]))
        self.pred = Conv(widths[n_layers], 1, kw, 1, padw)

    def forward(self, x) -> List[torch.Tensor]:
        sharded = spatial.current() is not None

        def keep(out, conv_out):  # the conv's global height, kept on its activation
            return spatial.mark(out, spatial.global_h(conv_out)) if sharded else out

        feats = []
        h = self.layer0(x)
        h = keep(leaky_relu(h), h)
        feats.append(h)
        for n in range(1, self.n_layers + 1):
            c = getattr(self, f"layer{n}")(h)
            h = keep(leaky_relu(getattr(self, f"norm{n}")(c)), c)
            feats.append(h)
        c = self.pred(h)
        feats.append(keep(torch.sigmoid(c), c) if self.use_sigmoid else c)
        return feats


class MultiscaleDiscriminator(nn.Module):
    """``num_D`` PatchGANs over an AvgPool(3, 2, 1, count_include_pad=False)
    pyramid; ``keep_input`` prepends each scale's input to its list; every
    norm reads the statistics of ``mode``."""

    def __init__(self, input_nc: int, ndf: int = 64, n_layers: int = 3, num_D: int = 2,
                 norm: str = "instance", use_sigmoid: bool = False):
        super().__init__()
        self.num_D = num_D
        for i in range(num_D):
            self.add_module(f"scale{i}", NLayerDiscriminator(input_nc, ndf, n_layers, norm,
                                                             use_sigmoid))

    def forward(self, x, keep_input: bool = False, mode: str = RUNNING
                ) -> List[List[torch.Tensor]]:
        with norm_mode(mode):
            return self._forward(x, keep_input)

    def _forward(self, x, keep_input: bool) -> List[List[torch.Tensor]]:
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
