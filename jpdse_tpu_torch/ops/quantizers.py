"""Quantizers with straight-through gradients, the port of
``jpdse_tpu/ops/quantizers.py``: the sign (``stochastic_sign_ste`` :28-47,
``deterministic_sign_ste`` :50-58), ``rounded_identity`` (:61),
``DifferentiableSign`` (:72), the ``Binarizer`` (:84-107) that every
binarized module of the codec holds, and the soft-to-hard vector
quantizers ``S2HVQ`` (:110) and ``S2HVQV2`` (:191), which no model of
either package uses. Every stochastic draw comes from an explicit
``torch.Generator``. Parameters are named as Flax names them
(``codebook``; ``fc1``..``fc3`` of ``S2HVQV2``, whose Dense kernels the
weight bridge transposes), so ``convert.from_jax_params`` carries them.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from jpdse_tpu_torch.models.layers import conv_nhwc
from jpdse_tpu_torch.parallel import spatial
from jpdse_tpu_torch.parallel.mesh import draw_rows


class _SignSTE(torch.autograd.Function):
    """``sign`` (``u`` None) or the stochastic sign against the uniform draws
    ``u``, with an identity gradient."""

    @staticmethod
    def forward(ctx, x, u):
        if u is None:
            return torch.sign(x)
        return sign_from_uniform(x, u)

    @staticmethod
    def backward(ctx, g):
        return g, None


def sign_from_uniform(x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """+1 where (1 - x) / 2 <= u, else -1, in x's dtype: P(+1) = (1 + x) / 2
    for u uniform on [0, 1)."""
    return torch.where((1.0 - x) / 2.0 <= u, 1.0, -1.0).to(x.dtype)


def stochastic_sign_ste(x: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """Stochastic binarization with a straight-through gradient: u drawn by
    ``torch.rand`` in x's dtype from ``generator`` (for the global batch in
    a data-parallel step, ``parallel/mesh.py::draw_rows``)."""
    hg = None if spatial.current() is None else spatial.global_h(x)
    u = draw_rows(x.shape, lambda s: torch.rand(s, dtype=x.dtype, device=x.device,
                                                generator=generator), hg)
    return spatial.like(_SignSTE.apply(x, u), x)


def deterministic_sign_ste(x: torch.Tensor) -> torch.Tensor:
    """sign(x) (0 at 0, as ``jnp.sign``) with an identity gradient."""
    return spatial.like(_SignSTE.apply(x, None), x)


class _RoundSTE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return torch.round(x)

    @staticmethod
    def backward(ctx, g):
        return g


def rounded_identity(x: torch.Tensor) -> torch.Tensor:
    """round(x), half to even as ``jnp.round`` rounds, with an identity
    gradient."""
    return _RoundSTE.apply(x)


class DifferentiableSign(nn.Module):
    """The stochastic sign in training (``deterministic`` False, its draws
    from ``generator``), the sign in evaluation."""

    def forward(self, x: torch.Tensor, deterministic: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if deterministic:
            return deterministic_sign_ste(x)
        if generator is None:
            raise ValueError("the stochastic sign needs an explicit torch.Generator")
        return stochastic_sign_ste(x, generator)


class Binarizer(nn.Module):
    """1x1 bias-free (optionally grouped) conv + tanh + ``DifferentiableSign``,
    NHWC: the sign in evaluation, the stochastic sign in training
    (``deterministic`` False)."""

    def __init__(self, in_channels: int, out_channels: int, groups: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels, 1, bias=False, groups=groups)
        self.sign = DifferentiableSign()

    def presign(self, x: torch.Tensor) -> torch.Tensor:
        """tanh(conv1x1(x)): the value whose sign is the code bit."""
        return spatial.like(torch.tanh(conv_nhwc(x, self.conv.weight, groups=self.conv.groups)),
                            x)

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return spatial.like(self.sign(self.presign(x), deterministic, generator), x)


class S2HVQ(nn.Module):
    """Soft-to-hard vector quantization: the codebook ``(n_centers,
    center_size)`` a parameter (drawn normal(0, 1) from ``generator``, as
    Flax's ``normal(1.0)``; zeros without one, for loading), the squared
    L2 distance to every center the score. ``encode`` is soft (a softmax of
    ``-sigma`` times the score) in training and a hard one-hot of the
    nearest center in evaluation; ``decode`` is always the hard lookup of
    the argmax center."""

    def __init__(self, n_centers: int, center_size: int, sigma: float = 10.0,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        if sigma <= 0:
            raise ValueError(f"sigma must be positive, got {sigma}")
        self.n_centers, self.center_size, self.sigma = n_centers, center_size, sigma
        self.codebook = nn.Parameter(torch.zeros(n_centers, center_size, device=device))
        if generator is not None:
            with torch.no_grad():
                self.codebook.normal_(0.0, 1.0, generator=generator)

    def _score(self, x_mtrx: torch.Tensor) -> torch.Tensor:
        """(n, code_len, center_size) -> (n, code_len, n_centers) squared
        distances, as ``|x|^2 - 2 x.c + |c|^2``."""
        cb = self.codebook.to(x_mtrx.dtype)
        x2 = (x_mtrx ** 2).sum(-1, keepdim=True)
        return x2 - 2.0 * torch.einsum("ncd,kd->nck", x_mtrx, cb) + (cb ** 2).sum(-1)

    def _vec2mtrx(self, x: torch.Tensor, code_len: int) -> torch.Tensor:
        n, d = x.shape
        if d % code_len != 0 or d // code_len != self.center_size:
            raise ValueError(f"code_len {code_len} incompatible with d={d}, "
                             f"center_size={self.center_size}")
        return x.reshape(n, code_len, d // code_len)

    def soft_quantize(self, x_mtrx: torch.Tensor) -> torch.Tensor:
        return torch.softmax(-self.sigma * self._score(x_mtrx), dim=-1)

    def hard_quantize(self, x_mtrx: torch.Tensor) -> torch.Tensor:
        """The one-hot of the center of least score (the first of a tie)."""
        idx = torch.argmin(self._score(x_mtrx), dim=-1)
        return F.one_hot(idx, self.n_centers).to(x_mtrx.dtype)

    def encode(self, x: torch.Tensor, code_len: int, train: bool = True,
               raw: bool = True) -> torch.Tensor:
        """x (n, d) -> (n, code_len, n_centers) scores with ``raw``, else
        (n, code_len) indices of the largest."""
        x_mtrx = self._vec2mtrx(x, code_len)
        code_raw = self.soft_quantize(x_mtrx) if train else self.hard_quantize(x_mtrx)
        return code_raw if raw else torch.argmax(code_raw, dim=-1)

    def decode(self, code_raw: torch.Tensor) -> torch.Tensor:
        """(n, code_len, n_centers) -> (n, code_len * center_size): the
        codebook rows of the argmax centers."""
        return self.codebook[torch.argmax(code_raw, dim=-1)].reshape(code_raw.shape[0], -1)

    def forward(self, x: torch.Tensor, code_len: int, train: bool = True) -> torch.Tensor:
        """The quantize-dequantize round trip."""
        return self.decode(self.encode(x, code_len, train=train, raw=True))

    @staticmethod
    def get_pmf(scores: torch.Tensor) -> torch.Tensor:
        """The histogram over centers of (n, code_len, n_centers) scores."""
        return scores.sum(dim=(0, 1)) / (scores.shape[0] * scores.shape[1])

    @staticmethod
    def get_cross_entropy(pmf1: torch.Tensor, pmf2: torch.Tensor) -> torch.Tensor:
        """H(pmf1, pmf2) in bits over the centers where pmf2 > 0."""
        safe = pmf2 > 0
        log2p = torch.where(safe, torch.log2(torch.where(safe, pmf2, 1.0)), 0.0)
        return torch.where(safe, -pmf1 * log2p, 0.0).sum()


class S2HVQV2(S2HVQ):
    """:class:`S2HVQ` whose score is a learned MLP, center_size -> 64 -> 128
    -> n_centers with tanh between (``fc1``..``fc3``, Flax's ``Dense``,
    kernels drawn normal(0, 1 / fan_in) from ``generator``, biases 0).
    ``hard_quantize`` still takes the argmin of that score, as JAX's
    does."""

    def __init__(self, n_centers: int, center_size: int, sigma: float = 10.0,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__(n_centers, center_size, sigma, generator, device)
        widths = (center_size, 64, 128, n_centers)
        for i in range(3):
            fc = nn.Linear(widths[i], widths[i + 1], device=device)
            with torch.no_grad():
                fc.bias.zero_()
                if generator is None:
                    fc.weight.zero_()
                else:
                    fc.weight.normal_(0.0, widths[i] ** -0.5, generator=generator)
            setattr(self, f"fc{i + 1}", fc)

    def _score(self, x_mtrx: torch.Tensor) -> torch.Tensor:
        h = torch.tanh(F.linear(x_mtrx, self.fc1.weight.to(x_mtrx.dtype),
                                self.fc1.bias.to(x_mtrx.dtype)))
        h = torch.tanh(F.linear(h, self.fc2.weight.to(h.dtype), self.fc2.bias.to(h.dtype)))
        return F.linear(h, self.fc3.weight.to(h.dtype), self.fc3.bias.to(h.dtype))
