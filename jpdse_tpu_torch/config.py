"""Typed configuration, the port of ``jpdse_tpu/config.py``: the same nested
dataclasses, field names, defaults, ``JPDSE_*`` env overrides, ``opt.json``
round trip, train -> val/test derivation and dataset defaults, so an
``opt.json`` written by either package loads in the other to the same
``to_dict()``.

:meth:`Config.validate` is the JAX package's consistency check. Whether the
port can run a configuration is a separate check, :func:`check_ported`,
made where a codec is built: a configuration that a later slice of the port
owns raises :class:`NotPorted`, naming its ROADMAP item.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os
from dataclasses import dataclass, field
from typing import Any, List, Optional, Tuple


def _tuple3(x) -> Tuple[float, float, float]:
    if isinstance(x, str):
        parts = [float(p) for p in x.split(",")]
    else:
        parts = [float(p) for p in x]
    if len(parts) == 1:
        parts = parts * 3
    if len(parts) != 3:
        raise ValueError(f"expected 3 values, got {parts}")
    return tuple(parts)  # type: ignore[return-value]


@dataclass
class PreprocessConfig:
    """Resize / crop / flip of the data pipeline (``data/transforms.py``)."""

    preprocess_mode: str = "scale_width_and_crop"
    load_size: int = 1024
    crop_size: int = 512
    aspect_ratio: float = 2.0

    VALID_MODES = (
        "resize_and_crop",
        "crop",
        "scale_width",
        "scale_width_and_crop",
        "scale_shortside",
        "scale_shortside_and_crop",
        "fixed",
        "none",
    )

    def __post_init__(self):
        if self.preprocess_mode not in self.VALID_MODES:
            raise ValueError(f"invalid preprocess_mode {self.preprocess_mode}")


@dataclass
class DataConfig:
    """Data pipeline: dataset, preprocessing, normalization, test noise."""

    root_dir: str = ""
    dataset: str = "cityscapes"  # ade20k | cityscapes | coco | custom | clic
    num_workers: int = 4
    max_dataset_size: int = 2**62
    num_labels: int = 182
    contain_dontcare_label: bool = False
    num_out_channels: int = 3
    no_flip: bool = False
    normalize_mean: Tuple[float, float, float] = (0.5, 0.5, 0.5)
    normalize_std: Tuple[float, float, float] = (0.5, 0.5, 0.5)
    use_gt_semantics: bool = True
    no_pairing_check: bool = False
    batch_size: int = 1
    # memoize decoded + resized samples ('fixed' / 'none' preprocessing only;
    # flip and normalization still run per call)
    cache_images: bool = False
    # the JAX package's device-resident training set (data/device_cache.py);
    # the port's training declines it with a printed reason (ROADMAP item 11)
    device_cache: bool = True
    preprocess: PreprocessConfig = field(default_factory=PreprocessConfig)
    val_preprocess: PreprocessConfig = field(
        default_factory=lambda: PreprocessConfig("none", 1024, 512, 2.0)
    )
    test_preprocess: PreprocessConfig = field(
        default_factory=lambda: PreprocessConfig("none", 1024, 512, 2.0)
    )
    # test-time noise injection (eval/harness.py add_noise)
    add_noise: bool = False
    noise_distribution: str = "normal_poisson"
    noise_std: float = 0.05
    noise_mean: float = 0.0
    poisson_lambda: float = 0.01

    def __post_init__(self):
        self.normalize_mean = _tuple3(self.normalize_mean)
        self.normalize_std = _tuple3(self.normalize_std)

    @property
    def semantic_nc(self) -> int:
        """Channels of the one-hot label map."""
        return self.num_labels + 1 if self.contain_dontcare_label else self.num_labels


def _fp_field(default, env: str, help_: str):
    return field(default=default, metadata={"env": env, "help": help_})


@dataclass
class FastPathConfig:
    """Switches of the s2d fast path (``models/fast_codec.py``), every field
    of the JAX package's, with its ``JPDSE_*`` env override (same value
    spellings; the env beats the config when set, :meth:`resolved` applies
    it).

    Three fields change what the port runs: ``head_pallas`` and
    ``front_realign`` pick kernels K4 and K2, ``norm_shift`` the shifted
    variance of the s2d InstanceNorm. The others re-express the same
    arithmetic in layouts that suit the TPU; the port carries them as data
    and computes the same function (``tests/test_torch_port_config_cli.py``
    holds the JAX package's output with each flipped against the port's)."""

    s2d_e2e: bool = _fp_field(
        False, "JPDSE_S2D_E2E",
        "JAX package: assemble the trunk inputs in the s2d domain end to end. "
        "A layout choice of the same function; the port carries it as data.")
    head_pallas: str = _fp_field(
        "0", "JPDSE_HEAD_PALLAS",
        "'1': the 7x7 head conv of trunks whose s2d input has >= 64 channels "
        "runs as kernel K4 (ops/head_conv.py) fed by K1 with extra rows; "
        "'force': every trunk; '0': the convolution library's conv.")
    head_fold: bool = _fp_field(
        False, "JPDSE_HEAD_FOLD",
        "JAX package: fold the head conv's taps into its contraction. A layout "
        "choice of the same function; the port carries it as data.")
    tail_split: bool = _fp_field(
        True, "JPDSE_TAIL_SPLIT",
        "JAX package: tap-split the 7x7 tail into a 1x1 conv and a shift-add. "
        "A layout choice of the same function; the port's tail is the direct "
        "s2d conv whatever the value.")
    tail_wgroup: int = _fp_field(
        2, "JPDSE_TAIL_WGROUP",
        "JAX package: width taps per group of the tail split. Carried as data.")
    fused_realign: str = _fp_field(
        "auto", "JPDSE_FUSED_REALIGN",
        "JAX package: how the back stage re-aligns the s2d grid (one-pass "
        "kernel, slice-concat or d2s/pad/s2d). All compute the same tensor; "
        "the port always runs kernel K1 (ops/realign.py).")
    front_realign: str = _fp_field(
        "0", "JPDSE_FRONT_REALIGN",
        "'pallas' / 'auto': a front that does not run K4 enters the s2d "
        "domain through kernel K2 (ops/realign.py s2d_pad3), one pass for "
        "pad3 + s2d; '0': reflect pad, then space_to_depth.")
    norm_shift: bool = _fp_field(
        False, "JPDSE_NORM_SHIFT",
        "subtract a sample of each fine channel before the one-pass moments "
        "of the s2d InstanceNorm (ops/s2d.py instance_norm_s2d), for inputs "
        "whose |mean|/std is large; default off.")

    VALID = {
        "head_pallas": ("0", "1", "force"),
        "fused_realign": ("auto", "0", "1", "xla", "pallas"),
        "front_realign": ("0", "auto", "pallas"),
    }

    def resolved(self) -> "FastPathConfig":
        """Copy with the JPDSE_* env overrides applied."""
        out = copy.copy(self)
        for f in dataclasses.fields(self):
            env = f.metadata.get("env")
            if not env or env not in os.environ:
                continue
            raw = os.environ[env]
            cur = getattr(self, f.name)
            if isinstance(cur, bool):
                setattr(out, f.name, raw == "1")
            elif isinstance(cur, int):
                setattr(out, f.name, int(raw))
            else:
                setattr(out, f.name, raw)
        return out

    def validate(self, check_combos: bool = True):
        """Domain checks always; the combination check only for values from
        the config (``check_combos=False`` is for the env-resolved copy)."""
        for name, valid in self.VALID.items():
            if getattr(self, name) not in valid:
                raise ValueError(
                    f"model.fast.{name} must be one of {valid}, "
                    f"got {getattr(self, name)!r}")
        if self.tail_wgroup < 1:
            raise ValueError("model.fast.tail_wgroup must be >= 1")
        if not check_combos:
            return
        if self.s2d_e2e and self.head_pallas == "force":
            raise ValueError(
                "model.fast.s2d_e2e cannot be combined with "
                "head_pallas='force' (the head kernel requires the "
                "fine-domain producer s2d_e2e eliminates)")


@dataclass
class ModelConfig:
    """Architecture."""

    model: str = "pix2pixHD"
    # discriminator
    num_D: int = 2
    n_layers_D: int = 3
    ndf: int = 64
    no_lsgan: bool = False
    pool_size: int = 0
    # semantics plumbing
    no_instance: bool = False
    no_label: bool = False
    sem_masking: bool = False
    binary_mask: bool = False
    netE_groups: int = 1
    inst_wise_pool: bool = False
    max_instance_id: int = 40960
    norm: str = "instance"  # instance | batch | identity
    use_dropout: bool = False
    # I/O channels
    input_nc: int = 3
    zero_sem: bool = False
    zero_ins: bool = False
    zero_vis: bool = False
    # generator
    netG: str = "global"  # global | local
    ngf: int = 64
    n_downsample_global: int = 4
    n_blocks_global: int = 9
    n_blocks_local: int = 3
    n_local_enhancers: int = 1
    niter_fix_global: int = 0
    # visual-feature encoder
    no_feat_encoding: bool = False
    no_feat: bool = False
    feat_num: int = 3
    n_downsample_E: int = 4
    nef: int = 64
    use_netE_output: bool = False
    # label encoder
    no_label_encoding: bool = False
    label_encoder_out_channels: int = 36
    n_downsample_E4label: int = 4
    ne4lf: int = 64
    # binarizers
    no_encoder_binarization: bool = False
    encoder_binarizer_out_channels: int = 128
    no_label_encoder_binarization: bool = False
    label_encoder_binarizer_out_channels: int = 128
    no_generator_binarization: bool = False
    bin_generator_before_res: bool = False
    generator_binarizer_out_channels: int = 128
    # precision: compute dtype for the nets ("float32" | "bfloat16")
    compute_dtype: str = "float32"
    # InstanceNorm (+ReLU) (+residual) in one call to kernel K3
    # (ops/instance_norm.py) at every norm site of the standard path
    fused_instance_norm: bool = False
    # the JAX package's phase-decomposed ConvTranspose: the same function in
    # another layout, carried as data
    phase_deconv: bool = False
    # serve deterministic inference through the s2d fast path
    # (models/fast_codec.py) rather than the standard modules
    fast_inference: bool = False
    fast: FastPathConfig = field(default_factory=FastPathConfig)


@dataclass
class LossConfig:
    """Objective (read by training, which a later slice ports)."""

    lambda_feat: float = 10.0
    lambda_distortion: float = 10.0
    anneal_lambda: bool = False
    anneal_interval: int = 5000
    anneal_factor: float = 5.0
    match_raw_feat: bool = False
    no_gan_feat_loss: bool = False
    no_vgg_loss: bool = False
    no_distortion_loss: bool = False
    no_g_gan_loss: bool = False
    no_d_gan_loss: bool = False
    distortion_loss_fn: str = "l1"  # l1 | mse
    vgg_weights_path: Optional[str] = None


@dataclass
class OptimConfig:
    """Training and optimization (``seed`` also seeds evaluation's noise and
    the loader's order)."""

    num_epochs: int = 100
    val_interval: int = 1
    beta1: float = 0.5
    beta2: float = 0.999
    lr: float = 0.0002
    schedule_lr: bool = False
    lr_decay_factor: float = 0.1
    lr_decay_patience: int = 5
    seed: Optional[int] = None
    fp16: bool = False  # selects bf16 compute
    remat: bool = False
    remat_granularity: str = "block"  # block | decode
    vgg_chunk: int = 0
    fast_train: bool = False
    vgg_bf16: bool = False
    latest_interval: int = 0
    max_host_rss_gb: float = 0.0


@dataclass
class CodecConfig:
    """External base codec and reduced-rate semantics."""

    use_compressed: bool = False
    ext: str = "jpg"  # jpg | j2k | bpg | webp | heif | avif
    quality: Tuple[int, ...] = (100,)
    sem_downsample: int = 1

    def __post_init__(self):
        if isinstance(self.quality, str):
            self.quality = tuple(int(q) for q in self.quality.split(","))
        elif isinstance(self.quality, int):
            self.quality = (self.quality,)
        else:
            self.quality = tuple(int(q) for q in self.quality)


@dataclass
class ParallelConfig:
    """Device mesh (read by the multi-device slice of the port)."""

    data_axis: int = -1
    spatial_axis: int = 1


@dataclass
class Config:
    """Top-level run configuration."""

    mode: str = "train"  # train | val | test
    is_train: bool = True
    save_dir: str = "./checkpoints"
    checkpoints_dir: Optional[str] = None
    always_save: bool = False
    load_model: bool = False
    do_not_get_codes: bool = False
    display_winsize: int = 512
    max_recon_dump: Optional[int] = None
    tf_log: bool = False
    profile_dir: Optional[str] = None

    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    codec: CodecConfig = field(default_factory=CodecConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)

    def validate(self):
        """The JAX package's consistency checks, made where a model is built."""
        m, c = self.model, self.codec
        enc_bin = (not m.no_feat_encoding and not m.no_encoder_binarization) or (
            not m.no_label_encoding and not m.no_label_encoder_binarization
        )
        if enc_bin and not m.no_generator_binarization:
            raise ValueError(
                "Binarize the encoders *or* the generator, not both "
                "(reference pix2pixHD_model.py:107-108)."
            )
        if m.sem_masking and (m.no_feat or m.no_label):
            raise ValueError("sem_masking requires features and labels (pix2pixHD_model.py:115)")
        if len(c.quality) > 1 and not m.sem_masking:
            raise ValueError(
                "per-channel quality list requires sem_masking (pix2pixHD_model.py:342-343)")
        if c.sem_downsample not in (1, 2, 4, 8):
            raise ValueError(
                f"codec.sem_downsample must be 1, 2, 4 or 8, got "
                f"{c.sem_downsample!r}"
            )
        m.fast.validate()
        if self.optim.remat_granularity not in ("block", "decode"):
            raise ValueError(
                f"optim.remat_granularity must be 'block' or 'decode', "
                f"got {self.optim.remat_granularity!r}"
            )

    # -- channel arithmetic ----------------------------------------------
    # The widths of the tensors the port assembles (models/codec.py). They
    # equal the JAX package's arithmetic, except where that arithmetic
    # leaves out a channel its Flax modules infer: the edge map of a
    # no_label configuration with instances.
    @property
    def raw_semantics_nc(self) -> int:
        """Channels of the prepared semantics: one-hot label and edge map."""
        m = self.model
        return (0 if m.no_label else self.data.semantic_nc) + (0 if m.no_instance else 1)

    @property
    def semantics_nc(self) -> int:
        """Channels of the label features netG and D see."""
        if self.use_netE4label:
            return self.model.label_encoder_out_channels
        return self.raw_semantics_nc

    @property
    def netG_input_nc(self) -> int:
        m = self.model
        if m.no_feat:
            return self.semantics_nc
        feat = m.feat_num if self.use_netE else self.netE_input_nc
        return feat if m.sem_masking else self.semantics_nc + feat

    @property
    def netD_input_nc(self) -> int:
        m = self.model
        out = self.data.num_out_channels
        if m.use_netE_output:  # the image D sees is netE's output, or the raw visuals
            out = m.feat_num if self.use_netE else self.netE_input_nc
        return self.semantics_nc + out

    @property
    def netE_input_nc(self) -> int:
        m = self.model
        return m.input_nc * self.raw_semantics_nc if m.sem_masking else m.input_nc

    @property
    def netE4label_input_nc(self) -> int:
        m, d = self.model, self.data
        return d.semantic_nc + (0 if m.no_instance else 1)

    @property
    def has_binary_codes(self) -> bool:
        """Whether any module produces a binary bottleneck code."""
        m = self.model
        return (
            (self.use_netE4label and not m.no_label_encoder_binarization)
            or (self.use_netE and not m.no_encoder_binarization)
            or (not m.no_generator_binarization)
        )

    @property
    def use_netE(self) -> bool:
        m = self.model
        return (not m.no_feat) and (not m.no_feat_encoding)

    @property
    def use_netE4label(self) -> bool:
        m = self.model
        return (not m.no_label) and (not m.no_label_encoding) and (not m.sem_masking)

    # -- serialization (opt.json) ------------------------------------------
    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def to_json(self, indent: int = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent, sort_keys=True)

    def save(self, path: str):
        with open(path, "w") as f:
            f.write(self.to_json())

    @classmethod
    def from_dict(cls, d: dict) -> "Config":
        return _dataclass_from_dict(cls, d)

    @classmethod
    def load(cls, path: str) -> "Config":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    def replace(self, **kwargs) -> "Config":
        return dataclasses.replace(self, **kwargs)


def _dataclass_from_dict(cls, d: dict):
    """Recursively build nested dataclasses, ignoring unknown keys (an
    ``opt.json`` from another version still loads)."""
    if not dataclasses.is_dataclass(cls):
        return d
    kwargs = {}
    fields = {f.name: f for f in dataclasses.fields(cls)}
    for k, v in d.items():
        if k not in fields:
            continue
        f = fields[k]
        ftype = f.type if isinstance(f.type, type) else None
        default = (f.default_factory()  # type: ignore[misc]
                   if f.default_factory is not dataclasses.MISSING else None)
        target = ftype or type(default)
        if dataclasses.is_dataclass(target) and isinstance(v, dict):
            kwargs[k] = _dataclass_from_dict(target, v)
        else:
            kwargs[k] = v
    return cls(**kwargs)


# nested-dataclass types keyed by field name
_NESTED = {
    "data": DataConfig,
    "model": ModelConfig,
    "loss": LossConfig,
    "optim": OptimConfig,
    "codec": CodecConfig,
    "parallel": ParallelConfig,
    "fast": FastPathConfig,
    "preprocess": PreprocessConfig,
    "val_preprocess": PreprocessConfig,
    "test_preprocess": PreprocessConfig,
}


def derive_eval_config(cfg: Config, mode: str = "val") -> Config:
    """Train config -> val/test config: the mode's preprocessing block and
    batch size 1."""
    if mode not in ("val", "test"):
        raise ValueError(f'mode must be "val" or "test", got {mode}')
    new = copy.deepcopy(cfg)
    new.mode = mode
    new.is_train = False
    src = cfg.data.val_preprocess if mode == "val" else cfg.data.test_preprocess
    new.data.preprocess = copy.deepcopy(src)
    new.data.batch_size = 1
    return new


# per-dataset config overrides (applied unless the user set the field)
DATASET_DEFAULTS = {
    "cityscapes": {
        "data.preprocess.preprocess_mode": "fixed",
        "data.preprocess.load_size": 512,
        "data.preprocess.crop_size": 512,
        "data.preprocess.aspect_ratio": 2.0,
        "data.num_labels": 35,
    },
    "ade20k": {
        "data.preprocess.preprocess_mode": "fixed",
        "data.preprocess.load_size": 512,
        "data.preprocess.crop_size": 512,
        "data.num_labels": 150,
        "data.contain_dontcare_label": True,
    },
    "clic": {
        "data.preprocess.preprocess_mode": "none",
        "data.num_labels": 54,
    },
    "custom": {
        "data.preprocess.preprocess_mode": "fixed",
        "data.preprocess.load_size": 512,
        "data.preprocess.crop_size": 512,
        "data.preprocess.aspect_ratio": 2.0,
        "data.normalize_mean": (0.0, 0.0, 0.0),
        "data.normalize_std": (1.0, 1.0, 1.0),
        "model.no_label": True,
        "model.no_instance": True,
    },
}


def set_by_path(cfg: Config, dotted: str, value: Any):
    """Set a nested config field by dotted path, e.g. 'data.num_labels'."""
    obj = cfg
    parts = dotted.split(".")
    for p in parts[:-1]:
        obj = getattr(obj, p)
    if not hasattr(obj, parts[-1]):
        raise AttributeError(f"no config field {dotted}")
    setattr(obj, parts[-1], value)


def get_by_path(cfg: Config, dotted: str) -> Any:
    obj = cfg
    for p in dotted.split("."):
        obj = getattr(obj, p)
    return obj


def apply_dataset_defaults(cfg: Config, explicitly_set: Optional[List[str]] = None) -> Config:
    """Apply the dataset's default overrides, skipping fields the user set."""
    explicitly_set = set(explicitly_set or [])
    for dotted, value in DATASET_DEFAULTS.get(cfg.data.dataset, {}).items():
        if dotted not in explicitly_set:
            set_by_path(cfg, dotted, value)
    return cfg


class NotPorted(NotImplementedError):
    """A configuration that a later slice of the port runs."""


def check_ported(cfg: Config) -> None:
    """Raise :class:`NotPorted`, naming the ROADMAP item (Queue 1) that
    ports it, unless the port runs this configuration: a global netG fed by
    any assembly of ``SemanticCodec._generator_input`` (learned, raw,
    no-label, no-feat, sem_masking, use_netE_output, zero_*), with the
    encoders or the generator binarized or neither, over ungrouped
    instance-norm encoders, without base-codec inputs or reduced-rate
    semantics."""
    m, c = cfg.model, cfg.codec
    if c.use_compressed:
        raise NotPorted("codec.use_compressed (base-codec inputs and their side info) "
                        "is ROADMAP Queue 1 item 5")
    if c.sem_downsample != 1:
        raise NotPorted("codec.sem_downsample > 1 (reduced-rate semantics) is ROADMAP "
                        "Queue 1 item 5")
    if m.netG != "global":
        raise NotPorted(f"netG {m.netG!r} (LocalEnhancer) is ROADMAP Queue 1 item 10")
    if m.norm != "instance" or m.netE_groups != 1 or m.inst_wise_pool:
        raise NotPorted("batch / identity norms, grouped encoders and instance-wise "
                        "pooling are ROADMAP Queue 1 item 10")
    if m.compute_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"unknown compute_dtype {m.compute_dtype!r}")


def check_train_ported(cfg: Config) -> None:
    """:func:`check_ported`, and beyond it raise :class:`NotPorted` for the
    training options the port's GAN step does not run, naming their ROADMAP
    item (Queue 1)."""
    check_ported(cfg)
    m, o = cfg.model, cfg.optim
    if o.fast_train:
        raise NotPorted("optim.fast_train (the differentiable s2d train decode) is ROADMAP "
                        "Queue 1 item 9")
    if m.niter_fix_global > 0:
        raise NotPorted("model.niter_fix_global (the LocalEnhancer's frozen global phase) is "
                        "ROADMAP Queue 1 item 10")
    if m.use_dropout:
        raise NotPorted("model.use_dropout (Dropout in the res blocks, with an explicit "
                        "generator) is ROADMAP Queue 1 item 7's remainder")
    if cfg.profile_dir:
        raise NotPorted("profile_dir (a profiler trace of the first epoch, "
                        "utils/profiling.py) is ROADMAP Queue 1 item 11")
    if o.vgg_bf16:
        raise NotPorted("optim.vgg_bf16 (the bf16 perceptual trunk) is ROADMAP Queue 1 "
                        "item 7's remainder")
    if o.remat_granularity not in ("block", "decode"):
        raise ValueError(f"unknown optim.remat_granularity {o.remat_granularity!r}")


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
    cfg.data.num_labels = DATASET_DEFAULTS["cityscapes"]["data.num_labels"]
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
    check_ported(cfg)
    return cfg
