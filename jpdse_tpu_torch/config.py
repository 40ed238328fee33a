"""Configuration of the port: its own copy of the ``jpdse_tpu.config``
fields the ported slice reads, with the same names and defaults.

Only the learned-code flagship family is ported (binarized ``netE4label``
and ``netE`` feeding an unbinarized global ``netG``); :meth:`Config.validate`
rejects the rest until it is ported.
"""

from __future__ import annotations

import copy
import dataclasses
import os
from dataclasses import dataclass, field

# jpdse_tpu/config.py DATASET_DEFAULTS["cityscapes"], the field the slice reads
CITYSCAPES_NUM_LABELS = 35


@dataclass
class DataConfig:
    num_labels: int = 182
    contain_dontcare_label: bool = False
    num_out_channels: int = 3

    @property
    def semantic_nc(self) -> int:
        """Channels of the one-hot label map."""
        return self.num_labels + 1 if self.contain_dontcare_label else self.num_labels


def _fp_field(default, env: str, help_: str):
    return field(default=default, metadata={"env": env, "help": help_})


@dataclass
class FastPathConfig:
    """The fast path's kernel switches, the port of
    ``jpdse_tpu/config.py::FastPathConfig`` for the two fields that pick
    kernels; names, values, defaults and ``JPDSE_*`` env overrides as there
    (the env beats the config when set; :meth:`resolved` applies it).

    The JAX package's other fields re-express TPU layouts and are not
    ported: the port's tail is the direct s2d conv (``tail_split=False``),
    its head is unfolded unless ``head_pallas`` picks kernel K4, and its
    grid re-alignment is always kernel K1."""

    head_pallas: str = _fp_field(
        "0", "JPDSE_HEAD_PALLAS",
        "'1': the 7x7 head conv of trunks whose s2d input has >= 64 channels "
        "runs as kernel K4 (ops/head_conv.py) fed by K1 with extra rows; "
        "'force': every trunk; '0': the convolution library's conv.")
    front_realign: str = _fp_field(
        "0", "JPDSE_FRONT_REALIGN",
        "'pallas' / 'auto': a front that does not run K4 enters the s2d "
        "domain through kernel K2 (ops/realign.py s2d_pad3), one pass for "
        "pad3 + s2d; '0': reflect pad, then space_to_depth.")

    VALID = {
        "head_pallas": ("0", "1", "force"),
        "front_realign": ("0", "auto", "pallas"),
    }

    def resolved(self) -> "FastPathConfig":
        """Copy with the JPDSE_* env overrides applied."""
        out = copy.copy(self)
        for f in dataclasses.fields(self):
            env = f.metadata.get("env")
            if env and env in os.environ:
                setattr(out, f.name, os.environ[env])
        return out

    def validate(self):
        for name, valid in self.VALID.items():
            if getattr(self, name) not in valid:
                raise ValueError(
                    f"model.fast.{name} must be one of {valid}, got {getattr(self, name)!r}")


@dataclass
class ModelConfig:
    no_instance: bool = False
    no_label: bool = False
    sem_masking: bool = False
    netE_groups: int = 1
    inst_wise_pool: bool = False
    norm: str = "instance"
    input_nc: int = 3
    netG: str = "global"
    ngf: int = 64
    n_downsample_global: int = 4
    n_blocks_global: int = 9
    no_feat_encoding: bool = False
    no_feat: bool = False
    feat_num: int = 3
    n_downsample_E: int = 4
    nef: int = 64
    no_label_encoding: bool = False
    label_encoder_out_channels: int = 36
    n_downsample_E4label: int = 4
    ne4lf: int = 64
    no_encoder_binarization: bool = False
    encoder_binarizer_out_channels: int = 128
    no_label_encoder_binarization: bool = False
    label_encoder_binarizer_out_channels: int = 128
    no_generator_binarization: bool = False
    compute_dtype: str = "float32"
    # InstanceNorm (+ReLU) (+residual) in one call to kernel K3
    # (ops/instance_norm.py) at every norm site of the standard path
    fused_instance_norm: bool = False
    # serve through the s2d fast path (models/fast_codec.py) rather than
    # the standard modules (serve.py)
    fast_inference: bool = False
    fast: FastPathConfig = field(default_factory=FastPathConfig)


@dataclass
class Config:
    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)

    def validate(self):
        """Raise unless this is the configuration family the port runs."""
        m = self.model
        if m.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"unknown compute_dtype {m.compute_dtype!r}")
        m.fast.validate()
        learned = (
            self.use_netE4label and not m.no_label_encoder_binarization
            and self.use_netE and not m.no_encoder_binarization
        )
        if (
            not learned or not m.no_generator_binarization or m.netG != "global"
            or m.norm != "instance" or m.netE_groups != 1 or m.inst_wise_pool
        ):
            raise ValueError(
                "jpdse_tpu_torch ports the learned-code configuration only: "
                "binarized netE4label and netE, unbinarized global netG, "
                "ungrouped instance-norm encoders"
            )

    @property
    def netG_input_nc(self) -> int:
        """netE4label's output beside netE's: the learned-code assembly."""
        return self.model.label_encoder_out_channels + self.model.feat_num

    @property
    def netE_input_nc(self) -> int:
        return self.model.input_nc

    @property
    def netE4label_input_nc(self) -> int:
        return self.data.semantic_nc + (0 if self.model.no_instance else 1)

    @property
    def use_netE(self) -> bool:
        m = self.model
        return (not m.no_feat) and (not m.no_feat_encoding)

    @property
    def use_netE4label(self) -> bool:
        m = self.model
        return (not m.no_label) and (not m.no_label_encoding) and (not m.sem_masking)


def flagship_config(tiny: bool = False, kernels: bool = False) -> Config:
    """Twin of ``__graft_entry__._flagship_cfg``: Cityscapes 1024x512,
    binarized netE4label + netE (128 code bits each at 1/16 resolution)
    feeding GlobalGenerator (ngf 64, 4 downsamples, 9 res blocks), bf16,
    served through the s2d fast path (``fast_inference``) as ``bench.py``
    serves it. The kernel switches keep the JAX package's defaults (off);
    ``kernels`` turns on the kernel configuration: K3 at the standard
    path's norm sites, K4 on the wide heads and K2 on the other fronts.
    ``tiny`` narrows it for tests."""
    cfg = Config()
    cfg.data.num_labels = CITYSCAPES_NUM_LABELS
    m = cfg.model
    m.no_generator_binarization = True  # binarize the encoders, not G
    m.compute_dtype = "bfloat16"
    m.fast_inference = True
    if kernels:
        m.fused_instance_norm = True
        m.fast.head_pallas = "1"
        m.fast.front_realign = "pallas"
    if tiny:
        m.ngf = m.nef = m.ne4lf = 8
        m.n_downsample_global = 2
        m.n_blocks_global = 2
        m.n_downsample_E = 2
        m.n_downsample_E4label = 2
        m.encoder_binarizer_out_channels = 16
        m.label_encoder_binarizer_out_channels = 16
        m.label_encoder_out_channels = 8
    cfg.validate()
    return cfg
