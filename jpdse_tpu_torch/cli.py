"""Command-line flags, the port of ``jpdse_tpu/cli.py``: every config field
is a ``--flag`` named after its leaf (``--num_labels`` -> data.num_labels),
the preprocess blocks keep the ``--preprocess_mode`` / ``--val_*`` /
``--test_*`` prefixes, and ``--load_opt --opt_file run/opt.json`` reloads a
saved config as the defaults that explicit flags override. The same argv
gives the same ``Config.to_dict()`` in both packages.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
from typing import Dict, List, Optional, Tuple

from jpdse_tpu_torch.config import Config, apply_dataset_defaults, get_by_path, set_by_path


def str2bool(s) -> bool:
    if isinstance(s, bool):
        return s
    if s.lower() in ("true", "t", "yes", "y", "1"):
        return True
    if s.lower() in ("false", "f", "no", "n", "0"):
        return False
    raise argparse.ArgumentTypeError(f"cannot interpret {s} as bool")


def _leaf_fields(cls, prefix: str) -> List[Tuple[str, object, str, str]]:
    """(dotted path, default, type annotation, help) of every leaf field."""
    out = []
    for f in dataclasses.fields(cls):
        default = (
            f.default_factory()  # type: ignore[misc]
            if f.default_factory is not dataclasses.MISSING
            else f.default
        )
        if dataclasses.is_dataclass(default):
            out.extend(_leaf_fields(type(default), f"{prefix}{f.name}."))
        else:
            out.append((f"{prefix}{f.name}", default, str(f.type), f.metadata.get("help", "")))
    return out


def build_flag_index() -> Dict[str, Tuple[str, object, str, str]]:
    """flag name -> (dotted config path, default, type annotation, help)."""
    index: Dict[str, Tuple[str, object, str, str]] = {}
    for dotted, default, typestr, help_ in _leaf_fields(Config, ""):
        parts = dotted.split(".")
        name = parts[-1]
        if len(parts) >= 2 and parts[-2] in ("val_preprocess", "test_preprocess"):
            name = parts[-2].split("_")[0] + "_" + name
        if name in index:
            raise RuntimeError(f"ambiguous flag --{name}: {index[name][0]} vs {dotted}")
        index[name] = (dotted, default, typestr, help_)
    return index


def make_parser() -> Tuple[argparse.ArgumentParser, Dict[str, Tuple[str, object, str, str]]]:
    index = build_flag_index()
    parser = argparse.ArgumentParser(formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    for name, (dotted, default, typestr, help_) in sorted(index.items()):
        kwargs: dict = {"default": None, "help": f"{dotted} — {help_}" if help_ else dotted}
        if isinstance(default, bool):
            kwargs.update(type=str2bool, nargs="?", const=True)
        elif isinstance(default, int):
            kwargs.update(type=int)
        elif isinstance(default, float):
            kwargs.update(type=float)
        elif default is None and "int" in typestr:
            kwargs.update(type=int)
        elif default is None and "float" in typestr:
            kwargs.update(type=float)
        else:
            kwargs.update(type=str)  # strings, and tuples as comma-separated values
        parser.add_argument(f"--{name}", **kwargs)
    parser.add_argument("--load_opt", action="store_true", help="reload a saved config as defaults")
    parser.add_argument("--opt_file", type=str, default=None, help="saved config json")
    # flags of the original recipes that select nothing here, accepted so
    # those invocations run unchanged
    parser.add_argument("--gpu_ids", type=str, default=None,
                        help="ignored (the device is an argument of the entry points); kept "
                             "for recipe compatibility")
    parser.add_argument("--data_type", type=int, default=None,
                        help="ignored (compute_dtype selects the precision); kept for recipe "
                             "compatibility")
    parser.add_argument("--local_rank", type=int, default=None,
                        help="ignored (a dead flag of the original recipes); kept for recipe "
                             "compatibility")
    return parser, index


def parse_config(argv: Optional[List[str]] = None, is_train: bool = True) -> Config:
    argv = sys.argv[1:] if argv is None else argv
    parser, index = make_parser()
    args = parser.parse_args(argv)

    if args.load_opt:
        if not args.opt_file:
            raise SystemExit("--load_opt requires --opt_file")
        cfg = Config.load(args.opt_file)
    else:
        cfg = Config()

    explicitly_set = []
    for name, (dotted, _, _t, _h) in index.items():
        val = getattr(args, name)
        if val is not None:
            set_by_path(cfg, dotted, val)
            explicitly_set.append(dotted)
    if args.gpu_ids is not None:
        print("note: --gpu_ids is ignored; the device is an argument of the entry point")

    # parse the comma-separated tuples (quality, normalize_mean/std)
    cfg.data.__post_init__()
    cfg.codec.__post_init__()

    apply_dataset_defaults(cfg, explicitly_set)
    cfg.is_train = is_train
    if cfg.mode is None or "mode" not in explicitly_set:
        cfg.mode = "train" if is_train else "test"
    return cfg


def print_config(cfg: Config, title: str = "Options"):
    defaults = Config()
    lines = [f"----------------- {title} ---------------"]
    for dotted, _default, _t, _h in _leaf_fields(Config, ""):
        val = get_by_path(cfg, dotted)
        try:
            dflt = get_by_path(defaults, dotted)
        except AttributeError:
            dflt = None
        mark = "" if val == dflt else f"\t[default: {dflt}]"
        lines.append(f"{dotted:>40}: {str(val):<24}{mark}")
    lines.append("----------------- End -------------------")
    print("\n".join(lines))
