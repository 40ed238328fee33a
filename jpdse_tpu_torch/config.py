"""Configuration of the port: its own copy of the ``jpdse_tpu.config``
fields the ported slice reads, with the same names and defaults.

Only the learned-code flagship family is ported (binarized ``netE4label``
and ``netE`` feeding an unbinarized global ``netG``); :meth:`Config.validate`
rejects the rest until it is ported.
"""

from __future__ import annotations

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


@dataclass
class Config:
    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)

    def validate(self):
        """Raise unless this is the configuration family the port runs."""
        m = self.model
        if m.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"unknown compute_dtype {m.compute_dtype!r}")
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


def flagship_config(tiny: bool = False) -> Config:
    """Twin of ``__graft_entry__._flagship_cfg``: Cityscapes 1024x512,
    binarized netE4label + netE (128 code bits each at 1/16 resolution)
    feeding GlobalGenerator (ngf 64, 4 downsamples, 9 res blocks), bf16.
    ``tiny`` narrows it for tests."""
    cfg = Config()
    cfg.data.num_labels = CITYSCAPES_NUM_LABELS
    m = cfg.model
    m.no_generator_binarization = True  # binarize the encoders, not G
    m.compute_dtype = "bfloat16"
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
