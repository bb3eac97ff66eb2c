"""Reflection-based CLI flag system over the config dataclasses — the port's
copy of ``gs_tpu/apps/args.py``, over ``gs_tpu_torch.config``.

Port of the reference's ``ParamGroup`` machinery
(ref: arguments/__init__.py:16-45): dataclass fields become argparse
arguments, a shorthand table reproduces the reference's leading-underscore
convention (``--source_path/-s`` etc., ref: arguments/__init__.py:49-63), and
``get_combined_args`` merges CLI overrides on top of the training-time config
persisted in the model dir (ref: arguments/__init__.py:95-115 — we read the
JSON config first and fall back to parsing the reference-style ``cfg_args``).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
from typing import Optional

from ..config import (ModelConfig, OptimizationConfig, PipelineConfig,
                      RasterConfig, from_dict)

# ref: arguments/__init__.py:49-63 — fields with argparse shorthands
SHORTHANDS = {
    "source_path": "s",
    "model_path": "m",
    "images": "i",
    "depths": "d",
    "resolution": "r",
    "white_background": "w",
}


def add_dataclass_args(parser: argparse.ArgumentParser, cls, *,
                       fill_none: bool = False, prefix: str = ""):
    """Add one argparse argument per dataclass field
    (ref: arguments/__init__.py:19-38)."""
    group = parser.add_argument_group(cls.__name__)
    for f in dataclasses.fields(cls):
        names = [f"--{prefix}{f.name}"]
        if f.name in SHORTHANDS and not prefix:
            names.append(f"-{SHORTHANDS[f.name]}")
        default = None if fill_none else f.default
        if f.type in ("bool", bool):
            group.add_argument(*names, default=default, action="store_true")
        else:
            ftype = {"int": int, "float": float, "str": str}.get(
                f.type if isinstance(f.type, str) else f.type.__name__, str)
            group.add_argument(*names, default=default, type=ftype)
    return group


def extract_dataclass(cls, args: argparse.Namespace, prefix: str = ""):
    """Copy matching namespace entries into a dataclass
    (ref: arguments/__init__.py:40-45 extract)."""
    kwargs = {}
    for f in dataclasses.fields(cls):
        v = getattr(args, prefix + f.name, None)
        if v is not None:
            kwargs[f.name] = v
    return cls(**kwargs)


def make_parser(description: str, *, include_optimization: bool = True,
                fill_none: bool = False) -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=description)
    add_dataclass_args(parser, ModelConfig, fill_none=fill_none)
    add_dataclass_args(parser, PipelineConfig, fill_none=fill_none)
    if include_optimization:
        add_dataclass_args(parser, OptimizationConfig, fill_none=fill_none)
    add_dataclass_args(parser, RasterConfig, fill_none=fill_none)
    return parser


def parse_cfg_args_file(path: str) -> dict:
    """Parse a reference-style ``Namespace(a=1, b='x')`` cfg_args file without
    eval (the reference evals it, arguments/__init__.py:105 — we don't)."""
    import ast
    with open(path) as f:
        text = f.read().strip()
    inner = text[len("Namespace("):-1]
    node = ast.parse(f"dict({inner})", mode="eval")
    return {kw.arg: ast.literal_eval(kw.value)
            for kw in node.body.keywords}


def get_combined_args(parser: argparse.ArgumentParser,
                      argv: Optional[list] = None) -> argparse.Namespace:
    """CLI args merged over the model dir's persisted training config
    (ref: arguments/__init__.py:95-115)."""
    args_cmdline = parser.parse_args(argv)
    merged = {}
    model_path = getattr(args_cmdline, "model_path", None)
    if model_path:
        json_path = os.path.join(model_path, "config.json")
        cfg_path = os.path.join(model_path, "cfg_args")
        if os.path.exists(json_path):
            with open(json_path) as f:
                d = json.load(f)
            for section in d.values():
                merged.update(section)
        elif os.path.exists(cfg_path):
            merged.update(parse_cfg_args_file(cfg_path))
        else:
            print("Config file not found in model path")
    for k, v in vars(args_cmdline).items():
        if v is not None:
            merged[k] = v
    return argparse.Namespace(**merged)
