"""YAML config tree with dotted-path CLI overrides (the JAX package's
``configs/config.py``), on the port's own YAML reader and writer
(``utils/yaml_io.py``: the machine with the card has no PyYAML).

A config is a YAML file with sections ``model`` / ``loss`` /
``eval_metric`` / ``optimizer`` / ``lr_scheduler`` / ``trainer`` /
``loaders``, plus overrides addressed by dotted paths
(``--loaders.test.slice_builder.patch_shape [64,128,128]`` or
``loaders.train.file_paths=['/data/train']``); ``copy_config`` snapshots
the resolved config next to the checkpoints.
"""

from __future__ import annotations

import argparse
import ast
import copy
import os
import shutil
from typing import Any, Dict, List, Optional, Sequence

from ..utils import yaml_io


class Config(dict):
    """A dict with attribute access and recursive wrapping."""

    def __getattr__(self, name: str) -> Any:
        try:
            v = self[name]
        except KeyError:
            raise AttributeError(name) from None
        if isinstance(v, dict) and not isinstance(v, Config):
            # wrapped in place, so nested attribute writes reach this tree
            v = Config(v)
            self[name] = v
        return v

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value


def _parse_value(raw: str) -> Any:
    """A CLI override value: a Python literal if it is one, else YAML (so
    ``false`` / ``null`` / ``1.0e-3`` mean what they mean in the file they
    override), else the raw string."""
    try:
        return ast.literal_eval(raw)
    except (ValueError, SyntaxError):
        pass
    try:
        return yaml_io.loads(raw)
    except yaml_io.YAMLError:
        return raw


def _set_dotted(cfg: Dict[str, Any], dotted: str, value: Any) -> None:
    keys = dotted.split(".")
    node = cfg
    for k in keys[:-1]:
        node = node.setdefault(k, {})
        if not isinstance(node, dict):
            raise TypeError(f"cannot override {dotted}: {k} is not a mapping")
    node[keys[-1]] = value


def apply_overrides(cfg: Dict[str, Any],
                    overrides: Sequence[str]) -> Dict[str, Any]:
    """Apply ``["a.b.c=value", ...]`` or ``["--a.b.c", "value", ...]``."""
    i = 0
    toks = list(overrides)
    while i < len(toks):
        tok = toks[i]
        if "=" in tok:
            key, _, raw = tok.lstrip("-").partition("=")
            i += 1
        else:
            key = tok.lstrip("-")
            if i + 1 >= len(toks):
                raise ValueError(f"override {tok!r} missing a value")
            raw = toks[i + 1]
            i += 2
        _set_dotted(cfg, key, _parse_value(raw))
    return cfg


def load_config(argv: Optional[List[str]] = None, *,
                config_path: Optional[str] = None,
                overrides: Sequence[str] = ()) -> Config:
    """Load a YAML config with dotted overrides, programmatically
    (``load_config(config_path=..., overrides=...)``) or CLI-style
    (``load_config(sys.argv[1:])``: ``--config`` and free-form
    ``--dotted.path value`` pairs).  ``device`` defaults to ``"auto"``:
    the card."""
    if config_path is None:
        parser = argparse.ArgumentParser(description="tpuseg config loader")
        parser.add_argument("--config", type=str, required=True)
        args, unknown = parser.parse_known_args(argv)
        config_path = args.config
        overrides = list(overrides) + unknown
    cfg = yaml_io.load(config_path) or {}
    apply_overrides(cfg, overrides)
    cfg.setdefault("device", "auto")
    return Config(cfg)


def copy_config(config: Dict[str, Any], checkpoint_dir: str,
                config_path: Optional[str] = None) -> str:
    """Write the resolved config (after overrides) to
    ``<checkpoint_dir>/logs/config.yml``, and copy ``config_path`` beside
    it when given."""
    os.makedirs(os.path.join(checkpoint_dir, "logs"), exist_ok=True)
    out = os.path.join(checkpoint_dir, "logs", "config.yml")
    with open(out, "w", encoding="utf-8") as f:
        f.write(yaml_io.dumps(_plain(config)))
    if config_path is not None and os.path.exists(config_path):
        shutil.copy2(config_path, os.path.join(
            checkpoint_dir, "logs", os.path.basename(config_path)))
    return out


def _plain(obj: Any) -> Any:
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_plain(v) for v in obj]
    return copy.deepcopy(obj)
