"""Config system: YAML composition with ``default_args`` include semantics.

Parity target: the reference's config loader (reference: tree_learn/util/parser.py:23-70).
A main YAML may contain ``default_args: [paths...]``; each listed YAML is loaded and
keys present in the main config recursively override the defaults, after which the
merged defaults are folded back into the main config.  The result is wrapped in an
attribute-accessible dict (the reference uses Munch; we ship our own to stay
dependency-light).
"""

from __future__ import annotations

import argparse
import os.path as osp
from typing import Any, Optional

import yaml


class ConfigDict(dict):
    """A dict with attribute access, recursively applied (Munch-equivalent)."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __delattr__(self, name: str) -> None:
        try:
            del self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    @classmethod
    def from_dict(cls, d: Any) -> Any:
        if isinstance(d, dict):
            return cls({k: cls.from_dict(v) for k, v in d.items()})
        if isinstance(d, (list, tuple)):
            return type(d)(cls.from_dict(v) for v in d)
        return d

    def to_dict(self) -> dict:
        return config_to_dict(self)

    def copy(self) -> "ConfigDict":
        return ConfigDict.from_dict(self)


def config_to_dict(obj: Any) -> Any:
    """Recursively convert ConfigDict trees back to plain dicts
    (parity: munch_to_dict, reference parser.py:62-70)."""
    if isinstance(obj, dict):
        return {k: config_to_dict(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [config_to_dict(v) for v in obj]
    if isinstance(obj, tuple):
        return tuple(config_to_dict(v) for v in obj)
    return obj


def load_yaml_file(filepath: str) -> dict:
    with open(filepath, "r") as f:
        return yaml.safe_load(f)


def _merge_overrides(default_config: dict, overrides: dict) -> None:
    """Recursively write override values into default_config
    (parity: modify_default_cfg, reference parser.py:55-60)."""
    for key, value in overrides.items():
        if (
            isinstance(value, dict)
            and key in default_config
            and isinstance(default_config[key], dict)
        ):
            _merge_overrides(default_config[key], value)
        else:
            default_config[key] = value


def get_config(config_path: str) -> ConfigDict:
    """Load a YAML config, resolving ``default_args`` includes.

    Matches the reference semantics exactly (parser.py:23-41): for every include,
    top-level keys shared with the main config are recursively overridden inside the
    include, then ``main_cfg.update(default_config)`` folds the (modified) include
    into the main config — i.e. an include's top-level keys win over identically
    named top-level keys of the main config, but the main config's *nested*
    modifications survive because they were merged into the include first.
    """
    return ConfigDict.from_dict(_load_resolved(config_path))


def _load_resolved(config_path: str) -> dict:
    main_cfg = load_yaml_file(config_path)
    default_args = main_cfg.pop("default_args", None)

    if default_args is not None:
        for path in default_args:
            if not osp.isabs(path) and not osp.exists(path):
                # allow resolution relative to the main config's repo root
                alt = osp.join(osp.dirname(osp.dirname(osp.dirname(osp.abspath(config_path)))), path)
                if osp.exists(alt):
                    path = alt
            # includes may themselves have default_args (an extension over the
            # reference's flat includes; lets user configs build on the
            # shipped task configs)
            default_config = _load_resolved(path)
            _merge_overrides(default_config,
                             {k: v for k, v in main_cfg.items()
                              if k in default_config})
            main_cfg.update(default_config)
    return main_cfg


def get_args(args=None) -> argparse.Namespace:
    """CLI flags (parity: reference parser.py:6-16)."""
    parser = argparse.ArgumentParser("treelearn_tpu_torch")
    parser.add_argument("--config", type=str, help="path to config file")
    parser.add_argument("--resume", type=str, help="path to resume from")
    parser.add_argument("--work_dir", type=str, help="working directory")
    parser.add_argument("--dist", action="store_true",
                        help="data-parallel training, one process per rank "
                             "(launch under torchrun; parallel/mesh.py)")
    parser.add_argument("--dist_url", type=str, default=None,
                        help="init method of the process group "
                             "(default env://, as torchrun sets it)")
    parser.add_argument("--device", type=str, default=None,
                        help="cuda (default) or cpu")
    return parser.parse_args(args)


def get_args_and_cfg(args=None):
    """Parse CLI args and load the config; derive work_dir
    (parity: reference parser.py:44-52)."""
    ns = get_args(args)
    cfg = get_config(ns.config)
    if ns.work_dir is not None:
        cfg.work_dir = osp.join("./work_dirs", ns.work_dir)
    else:
        cfg.work_dir = osp.join("./work_dirs", osp.splitext(osp.basename(ns.config))[0])
    return ns, cfg
