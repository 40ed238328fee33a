"""s2d-transformed trunk forwards, the port of
``jpdse_tpu/models/fast_trunk.py``: ``_FastTrunk`` for one GlobalGenerator
or Encoder trunk, and ``_FastLocalG`` (:454-505), the LocalEnhancer pyramid
built of them.

The head 7x7 conv, the first stride-2 downsample, the last transposed conv
and the 7x7 tail run in the space-to-depth domain with weights transformed
once at construction (ops/s2d.py); the mid trunk runs unchanged. The tail is
the direct s2d conv (the JAX package's ``fast.tail_split=False`` form: its
tap split exists to fill the TPU's 128 output lanes). The back stage
re-aligns the s2d grid, by default with kernel K1 (ops/realign.py).

Under the spatial axis (``parallel/spatial.py``'s ``sharding``) each
stage computes this rank's rows, as JAX's ``_FastTrunk(..., sharded=True)``
under a mesh: the s2d convolutions on rows that carry their halos
(``spatial.take_rows``: the fine rows the head reads for the rank's s2d
rows, reflected at the global edges only; one zero row above down 0 and
below the last upsample; the tail's fine rows, reflected likewise, taken
for the s2d rows that cover the rank's fine output rows, which need not
start on an even row), the normal-domain
convolutions, transposed convolutions and norms through their sharded
forms, the s2d InstanceNorm over the group's sums. Kernels K1, K2 and K4,
which take a whole tensor, are off there: 'auto' takes the compositions
and a switch that forces one raises (``config.check_fast_shard``).

The kernel switches of ``config.FastPathConfig`` pick the front:
``head_pallas`` runs a wide head (s2d input of >= 64 channels, or every
head with 'force') as kernel K4 (ops/head_conv.py) fed by K1 with extra
rows and its channels padded to a multiple of 8 (zero weights for the
padding); ``front_realign`` enters the s2d domain of the other heads through
kernel K2 (ops/realign.py ``s2d_pad3``). ``norm_shift`` selects the shifted
moments of the s2d InstanceNorms (ops/s2d.py ``instance_norm_s2d``).

A trunk's stages are there as its state has them (JAX: fast_trunk.py:84-85,
140-184): no ``head`` means no front (the trunk starts from a given feature
map), no ``tail`` no s2d back stage, every ``up`` then running as a plain
transposed conv. So the enhancer's global trunk (no tail) ends in plain
transposed convs, each enhancer's downsample stack is a front-only trunk
and its upsample stack a back-only trunk, the last one's with its tail:
the same transforms and kernel switches as a global trunk's, at the
enhancer's full resolution.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from jpdse_tpu_torch.config import FastPathConfig, check_fast_shard
from jpdse_tpu_torch.models.layers import (
    avg_pool_3s2,
    conv_transpose_nhwc,
    instance_norm,
    reflect_pad,
    relu,
)
from jpdse_tpu_torch.ops.head_conv import head_conv_extra_rows, head_conv_s2d, padded_channels
from jpdse_tpu_torch.ops.realign import (
    s2d_pad3,
    s2d_realign_pad3,
    s2d_realign_pad3_plain,
)
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
from jpdse_tpu_torch.parallel import spatial


def _pad_hw(h: torch.Tensor, top: int, bottom: int, left: int, right: int) -> torch.Tensor:
    """Zero pad of an NHWC tensor's H and W axes."""
    return F.pad(h, (0, 0, left, right, top, bottom))


def _span(b, s: int, scale: int, before: int, after: int) -> range:
    """The rows ``[scale b[s] - before, scale b[s + 1] + after)`` that rank
    ``s`` reads for its rows ``[b[s], b[s + 1])`` of a stage, none for a rank
    without rows (it runs the stage on zero rows)."""
    if b[s + 1] == b[s]:
        return range(0)
    return range(scale * b[s] - before, scale * b[s + 1] + after)


def _sub(state: Dict[str, torch.Tensor], prefix: str, rename=()) -> Dict[str, torch.Tensor]:
    """The entries of ``state`` under ``prefix.``, without it, each key's
    leading ``old.`` replaced by ``new.`` for (old, new) in ``rename``."""
    out = {}
    for k, v in state.items():
        if k.startswith(prefix + "."):
            k = k[len(prefix) + 1:]
            for old, new in rename:
                if k.startswith(old + "."):
                    k = new + k[len(old):]
            out[k] = v
    return out


class _FastTrunk:
    """Staged s2d forward for one GlobalGenerator or Encoder trunk.
    ``state``: the trunk's state dict (keys as in ``models/generator.py``).
    ``binarize``: 'none', 'mid' (an encoder's binarizer between its downs
    and ups), or a generator's bottleneck binarizer 'before_res' or
    'after_res' its residual blocks. ``fp``: the resolved kernel switches.
    The stages follow from the keys of ``state`` (the module docstring).

    The stages read the weights from a dict handed to them (``w``), keyed
    as :meth:`build_weights` keys it: serving passes ``self.weights``,
    transformed once here from detached copies; the fast train decode
    (``models/fast_train.py``) passes one built each step from the live
    parameters by the differentiable twins of the transforms. With
    ``weights=False`` the trunk is a skeleton: the structure, no weights."""

    def __init__(self, state: Dict[str, torch.Tensor], n_down: int, n_blocks: int,
                 binarize: str, dtype: torch.dtype, device, fp: FastPathConfig,
                 weights: bool = True):
        self.n_down, self.n_res, self.binarize = n_down, n_blocks, binarize
        self.dtype, self.fp = dtype, fp
        self.has_front = "head.conv.conv.weight" in state
        self.has_back = "tail.conv.weight" in state
        self.head_fold = "none"
        if self.has_front:
            _, cin, k, _ = state["head.conv.conv.weight"].shape
            self.head_kp, c4 = k // 2 + 1, 4 * cin
            head = fp.head_pallas
            # K4 for heads whose s2d input is wide (JAX: fast_trunk.py:114-129)
            if head == "force" or (head == "1" and c4 >= 64):
                self.head_fold = "pallas"
                # K4 reads padded_channels(c4) input channels; the padding's weights are 0
                self.head_c = padded_channels(c4)
        # plain upsamples: all but the last with a back, else every one there is
        n_up = n_down - 1 if self.has_back else n_down
        self.n_mid_up = next((i for i in range(n_up) if f"up.{i}.deconv.weight" not in state),
                             n_up)
        self.weights = self.build_weights(state, device) if weights else None

    def build_weights(self, state: Dict[str, torch.Tensor], device) -> Dict[str, torch.Tensor]:
        """The stages' weight dict from detached copies of ``state``: the
        s2d transforms in numpy, every weight in the compute dtype."""
        dtype, n_down = self.dtype, self.n_down

        def cl(t):  # a weight in the compute dtype, channels-last like the activations
            return t.detach().to(device=device, dtype=dtype).contiguous(
                memory_format=torch.channels_last)

        def vec(t):
            return t.detach().to(device=device, dtype=dtype)

        def s2d_w(w: np.ndarray):
            return hwio_to_oihw(w, device, dtype)

        w: Dict[str, torch.Tensor] = {}
        if self.has_front:
            wp_head = conv_s1_weights_to_s2d(oihw_to_hwio(state["head.conv.conv.weight"]))
            if self.head_fold == "pallas":
                c4 = wp_head.shape[2]
                wp_pad = np.pad(wp_head, ((0, 0), (0, 0), (0, self.head_c - c4), (0, 0)))
                w["head_w"] = torch.from_numpy(np.ascontiguousarray(
                    weights_fold_w(wp_pad).reshape(self.head_kp, self.head_kp * self.head_c, -1))
                ).to(device=device, dtype=dtype)
            else:
                w["head_w"] = s2d_w(wp_head)
            w["head_b"] = vec(state["head.conv.conv.bias"].repeat(4))
            w["down0_w"] = s2d_w(conv_s2_weights_from_s2d_nopad(
                oihw_to_hwio(state["down.0.conv.conv.weight"])))
            w["down0_b"] = vec(state["down.0.conv.conv.bias"])
        for i in range(1, n_down):
            w[f"down{i}_w"] = cl(state[f"down.{i}.conv.conv.weight"])
            w[f"down{i}_b"] = vec(state[f"down.{i}.conv.conv.bias"])
        for i in range(self.n_res):
            for j in (1, 2):
                w[f"res{i}_w{j}"] = cl(state[f"res.{i}.conv{j}.conv.weight"])
                w[f"res{i}_b{j}"] = vec(state[f"res.{i}.conv{j}.conv.bias"])
        for i in range(self.n_mid_up):
            w[f"up{i}_w"] = vec(state[f"up.{i}.deconv.weight"])
            w[f"up{i}_b"] = vec(state[f"up.{i}.deconv.bias"])
        if self.has_back:
            # last upsample straight into s2d form: g is the effective correlation kernel,
            # the (in, out, kh, kw) ConvTranspose weight as (kh, kw, in, out), flipped
            wl = state[f"up.{n_down - 1}.deconv.weight"].detach().float().cpu().numpy()
            g = np.flip(wl.transpose(2, 3, 0, 1), axis=(0, 1))
            w["uplast_w"] = s2d_w(convT_s2_weights_to_s2d(np.ascontiguousarray(g)))
            w["uplast_b"] = vec(state[f"up.{n_down - 1}.deconv.bias"].repeat(4))
            w["tail_w"] = s2d_w(conv_s1_weights_to_s2d(oihw_to_hwio(state["tail.conv.weight"])))
            w["tail_b"] = vec(state["tail.conv.bias"].repeat(4))
        if self.binarize != "none":
            w["bin_w"] = cl(state["binarizer.conv.weight"])
        return w

    # -- stages -----------------------------------------------------------
    def _shard(self) -> Optional[spatial.SpatialShard]:
        """The active spatial shard, or None on one process; raises for a
        switch that forces K1, K2 or K4 on a rank's rows."""
        shard = spatial.current()
        if shard is not None:
            check_fast_shard(self.fp, shard.size)
        return shard

    def front(self, w: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
        """Fine input -> normal-domain tensor after down0 (H/2, W/2, C1).
        Under the spatial axis this rank computes its s2d rows ``[lo, hi)``
        of the H/2 the head gives (the split of H/2, whose fine rows
        ``[2 lo, 2 hi)`` need not be the rank's own rows of H), from the fine
        rows ``[2 lo - 3, 2 hi + 3)`` it takes from their owners."""
        x = spatial.like(x.to(self.dtype), x)
        shard = self._shard()
        if shard is not None:
            hg = spatial.global_h(x)
            hq, kp = hg // 2, self.head_kp
            b = shard.bounds(hq)
            n = b[shard.index + 1] - b[shard.index]
            fine = spatial.take_rows(x, hg, lambda s: _span(b, s, 2, kp - 1, kp - 1), "reflect")
            xp = space_to_depth(spatial.pad_w(spatial.at_least(fine, 2 * kp), kp - 1, "reflect"))
            h = spatial.mark(conv_valid(xp, w["head_w"], w["head_b"])[:, :n], hq)
        elif self.head_fold == "pallas":
            h = self._front_head_pallas(w, x)
        else:
            if self.fp.front_realign in ("auto", "pallas"):
                xp = s2d_pad3(x.contiguous())
            else:
                xp = space_to_depth(reflect_pad(x, 3))
            h = conv_valid(xp, w["head_w"], w["head_b"])
        h = relu(instance_norm_s2d(h, use_shift=self.fp.norm_shift))
        if shard is not None:
            # one s2d row above each rank's own (zero above global row 0)
            h = spatial.at_least(spatial.take_rows(h, hq, lambda s: _span(b, s, 1, 1, 0)), 2)
            h = spatial.mark(conv_valid(_pad_hw(h, 0, 0, 1, 0), w["down0_w"],
                                        w["down0_b"])[:, :n], hq)
        else:
            h = conv_valid(_pad_hw(h, 1, 0, 1, 0), w["down0_w"], w["down0_b"])
        return relu(instance_norm(h))

    def _front_head_pallas(self, w: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
        """The head conv as K4, with the JAX package's producer: plain
        space_to_depth, then the grid re-alignment (:meth:`_realign`, K1
        unless ``fused_realign`` says otherwise) with the extra rows K4's
        TPU form needed (fast_trunk.py:272-305) and zero channels up to the
        multiple of 8 that K4's TMA needs, then the bias."""
        kp = self.head_kp
        ho = x.shape[1] // 2
        xp = self._realign(space_to_depth(x), extra_rows=head_conv_extra_rows(ho, kp),
                           channels=self.head_c)
        return head_conv_s2d(xp, w["head_w"], kp, ho=ho) + w["head_b"]

    def mid_down(self, w: Dict[str, torch.Tensor], h: torch.Tensor) -> torch.Tensor:
        shard = self._shard()
        for i in range(1, self.n_down):
            if shard is not None:
                h = spatial.conv2d(h, w[f"down{i}_w"].to(h.dtype), w[f"down{i}_b"].to(h.dtype),
                                   2, 1, "zero")
            else:
                h = conv_valid(_pad_hw(h, 1, 1, 1, 1), w[f"down{i}_w"], w[f"down{i}_b"],
                               stride=2)
            h = relu(instance_norm(h))
        return h

    def apply_binarizer(self, w: Dict[str, torch.Tensor], h: torch.Tensor) -> torch.Tensor:
        return spatial.like(torch.sign(torch.tanh(conv_valid(h, w["bin_w"]))), h)

    def _conv3_reflect(self, h: torch.Tensor, wk: torch.Tensor, bk: torch.Tensor) -> torch.Tensor:
        if self._shard() is not None:
            return spatial.conv2d(h, wk.to(h.dtype), bk.to(h.dtype), 1, 1, "reflect")
        return conv_valid(reflect_pad(h, 1), wk, bk)

    def res_block(self, w: Dict[str, torch.Tensor], h: torch.Tensor, i: int) -> torch.Tensor:
        r = self._conv3_reflect(h, w[f"res{i}_w1"], w[f"res{i}_b1"])
        r = relu(instance_norm(r))
        r = self._conv3_reflect(r, w[f"res{i}_w2"], w[f"res{i}_b2"])
        return spatial.like(h + instance_norm(r), h)

    def res_blocks(self, w: Dict[str, torch.Tensor], h: torch.Tensor) -> torch.Tensor:
        for i in range(self.n_res):
            h = self.res_block(w, h, i)
        return h

    def mid_up(self, w: Dict[str, torch.Tensor], h: torch.Tensor) -> torch.Tensor:
        for i in range(self.n_mid_up):
            h = relu(instance_norm(conv_transpose_nhwc(h, w[f"up{i}_w"], w[f"up{i}_b"])))
        return h

    def _realign(self, y: torch.Tensor, extra_rows: int = 0,
                 channels: Optional[int] = None) -> torch.Tensor:
        """Grid re-alignment ``s2d(reflect_pad(d2s(y), 3))`` (with extra
        rows and zero channels for K4's producer), by ``fp.fused_realign``
        as the JAX package's ``_FastTrunk._realign`` picks (:341-375):
        'auto' / 'pallas' kernel K1, else the composition (JAX's '1' /
        'xla' slice form computes the same tensor bit for bit, so the port
        runs the composition for it too); under the spatial axis,
        :meth:`back` composes it on the rows it takes."""
        if self.fp.fused_realign in ("auto", "pallas"):
            return s2d_realign_pad3(y.contiguous(), extra_rows, channels)
        return s2d_realign_pad3_plain(y, extra_rows, channels)

    def back(self, w: Dict[str, torch.Tensor], h: torch.Tensor) -> torch.Tensor:
        """Normal-domain (H/2, W/2, C) -> fine output with tanh. Under the
        spatial axis the s2d rows of the last upsample are this rank's rows
        of H/2, and the tail's are the s2d rows ``[f0 // 2, ceil(f1 / 2))``
        that cover its fine output rows ``[f0, f1)`` of H, re-aligned from
        the fine rows they read (taken from their owners: rank s holds the
        fine rows ``2 [lo, hi)`` of its s2d rows), cropped to its own."""
        shard = self._shard()
        if shard is None:
            y = conv_valid(_pad_hw(h, 0, 1, 0, 1), w["uplast_w"], w["uplast_b"])
            y = torch.relu(instance_norm_s2d(y, use_shift=self.fp.norm_shift))
            yp = self._realign(y)
            return depth_to_space(torch.tanh(conv_valid(yp, w["tail_w"], w["tail_b"])))
        hq = spatial.global_h(h)
        b, i = shard.bounds(hq), shard.index
        # one row below each rank's own (zero below the global bottom)
        h = spatial.at_least(spatial.take_rows(h, hq, lambda s: _span(b, s, 1, 0, 1)), 2)
        y = spatial.mark(conv_valid(_pad_hw(h, 0, 0, 0, 1), w["uplast_w"],
                                    w["uplast_b"])[:, :b[i + 1] - b[i]], hq)
        y = relu(instance_norm_s2d(y, use_shift=self.fp.norm_shift))
        hg, fb = 2 * hq, shard.bounds(2 * hq)

        def want(s):  # the fine rows the tail's s2d rows read, reflected at the edges
            f0, f1 = fb[s], fb[s + 1]
            return range(2 * (f0 // 2) - 3, 2 * ((f1 + 1) // 2) + 3) if f1 > f0 else range(0)

        fine = spatial.take_rows(depth_to_space(y), hg, want, "reflect",
                                 owners=tuple(2 * v for v in b))
        yp = space_to_depth(spatial.pad_w(spatial.at_least(fine, 8), 3, "reflect"))
        out = depth_to_space(torch.tanh(conv_valid(yp, w["tail_w"], w["tail_b"])))
        f0 = fb[i] - 2 * (fb[i] // 2)
        return spatial.mark(out[:, f0:f0 + fb[i + 1] - fb[i]], hg)

    # -- full passes, on the trunk's own weights ----------------------------
    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weights
        h = self.front(w, x) if self.has_front else spatial.like(x.to(self.dtype), x)
        h = self.mid_down(w, h)
        if self.binarize in ("mid", "before_res"):
            h = self.apply_binarizer(w, h)
        h = self.res_blocks(w, h)
        if self.binarize == "after_res":
            h = self.apply_binarizer(w, h)
        h = self.mid_up(w, h)
        return self.back(w, h) if self.has_back else h

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """Fine input -> {-1, 0, +1} code (through the binarizer)."""
        if self.binarize == "none":
            raise ValueError("no binarizer in this trunk")
        w = self.weights
        h = self.mid_down(w, self.front(w, x))
        if self.binarize == "after_res":
            h = self.res_blocks(w, h)
        return self.apply_binarizer(w, h)

    def decode_from_code(self, code_pm1: torch.Tensor) -> torch.Tensor:
        """Resume after the binarizer from a {-1, +1} code."""
        if self.binarize == "none":
            raise ValueError("no binarizer in this trunk")
        w = self.weights
        h = spatial.like(code_pm1.to(self.dtype), code_pm1)
        if self.binarize == "before_res":
            h = self.res_blocks(w, h)
        return self.back(w, self.mid_up(w, h))


class _FastLocalG:
    """The LocalEnhancer pyramid over s2d trunks (``generator.py:181-261``):
    the global trunk without its tail on the input pooled n_local times,
    then per enhancer its front-only downsample trunk (``c7`` as the head,
    ``d1`` as down 0) on the input at its level, added to the previous
    output, through its back-only upsample trunk (its res blocks, ``up`` as
    up 0, and in the last enhancer the tail). ``state``: netG's state dict."""

    binarize = "none"

    def __init__(self, state: Dict[str, torch.Tensor], n_down: int, n_blocks: int,
                 n_local: int, n_blocks_local: int, dtype: torch.dtype, device,
                 fp: FastPathConfig):
        self.n_local, self.dtype = n_local, dtype
        self.glob = _FastTrunk(_sub(state, "global"), n_down, n_blocks, "none", dtype, device,
                               fp)
        self.downs = [_FastTrunk(_sub(state, f"local{n}_down", (("c7", "head"), ("d1", "down.0"))),
                                 1, 0, "none", dtype, device, fp)
                      for n in range(1, n_local + 1)]
        self.ups = [_FastTrunk(_sub(state, f"local{n}_up", (("up", "up.0"),)), 1,
                               n_blocks_local, "none", dtype, device, fp)
                    for n in range(1, n_local + 1)]

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        pyramid = [spatial.like(x.to(self.dtype), x)]
        for _ in range(self.n_local):
            pyramid.append(avg_pool_3s2(pyramid[-1]))
        h = self.glob(pyramid[-1])
        for n in range(self.n_local):
            down = self.downs[n]
            d = down.front(down.weights, pyramid[self.n_local - 1 - n])
            h = self.ups[n](spatial.like(d + h, d))
        return h
