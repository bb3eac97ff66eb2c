"""What every run shares: finding a cell's files by name, the device's
description, the checks of ``correct`` with their limits, and the result's
last line.

A cell (an entry of ``workloads`` in ``BENCHMARK.json``) names a
configuration, found as ``configs[].file``, and a traffic mix, found as
``benchmark/traffic/<traffic>.json``; its limits for ``correct`` are
``benchmark/limits/<cell>.json``; each per-layer metric's reader is
``benchmark/metrics/<metric>.py``.
"""
from __future__ import annotations

import importlib.util
import json
import math
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]          # benchmark/
ROOT = BENCH.parent                                  # the checkout
# top-level modules that must not be loaded: the JAX package and JAX
FORBIDDEN = ("jax", "jaxlib", "flax", "gs_tpu")


class Cell:
    """A workload with its configuration, traffic, limits and metrics."""

    def __init__(self, name: str, bench: dict = None):
        bench = bench if bench is not None else load_benchmark()
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json; it has "
                           + ", ".join(sorted(cells)))
        entry = cells[name]
        conf = {c["name"]: c for c in bench["configs"]}[entry["config"]]
        path = BENCH / "limits" / f"{name}.json"
        self._set(name, json.loads((ROOT / conf["file"]).read_text()),
                  json.loads((BENCH / "traffic" / f"{entry['traffic']}.json")
                             .read_text()),
                  json.loads(path.read_text()) if path.exists() else {},
                  [m for m in bench["per_layer"] if applies(m, name)],
                  int(entry["chips"]))

    def _set(self, name, config, traffic, limits, per_layer, chips):
        self.name, self.config, self.traffic = name, config, traffic
        self.limits, self.per_layer, self.chips = limits, per_layer, chips

    @classmethod
    def of(cls, name: str, config: dict, traffic: dict, limits: dict,
           per_layer=(), chips: int = 1) -> "Cell":
        """A cell from its parts, not from BENCHMARK.json (the tests')."""
        c = cls.__new__(cls)
        c._set(name, config, traffic, limits, list(per_layer), chips)
        return c


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def reader(metric: str):
    """The ``read(trace)`` function of ``benchmark/metrics/<metric>.py``."""
    path = BENCH / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"bench_metric_{metric.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list[str]:
    """The loaded modules whose top-level name is JAX's or the JAX
    package's, compared whole (``gs_tpu_torch`` is not ``gs_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def device_info(torch, chips: int) -> dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips}


def power_limit() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        out = f"nvidia-smi unavailable: {e}"
    return out


class Checks:
    """The numbers that decide ``correct``, each against its limit: a
    number at or under its limit passes. A number the run could not
    produce is NaN and fails."""

    def __init__(self, limits: dict):
        self.limits = limits
        self.values: dict = {}
        self.notes: list = []

    def add(self, name: str, value: float):
        if name not in self.limits:
            raise KeyError(f"no limit for {name!r} in this cell's limits")
        self.values[name] = float(value)

    def fail(self, why: str):
        """A failure that no number carries (a wrong camera, a crash of
        the reference): recorded, and ``correct`` is false."""
        self.notes.append(why)

    @property
    def correct(self) -> bool:
        return not self.notes and bool(self.values) and all(
            math.isfinite(v) and v <= self.limits[k]
            for k, v in self.values.items())

    def as_dict(self) -> dict:
        out = {k: {"value": v, "limit": self.limits[k]}
               for k, v in self.values.items()}
        for i, why in enumerate(self.notes):
            out[f"failure{i}"] = why
        return out


def emit(result: dict, checks: dict):
    """Print the checks as the last lines of standard error and the result
    as the last line of standard output, ``checks`` its last key."""
    for k, v in checks.items():
        if isinstance(v, dict):
            print(f"check {k}: {v['value']!r} (limit {v['limit']!r})",
                  file=sys.stderr)
        else:
            print(f"check {k}: {v}", file=sys.stderr)
    sys.stderr.flush()
    line = dict(result)
    line["checks"] = checks
    print(json.dumps(line), flush=True)


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100) by linear interpolation between the
    closest ranks, over all values."""
    v = sorted(values)
    if not v:
        return float("nan")
    pos = (len(v) - 1) * q / 100.0
    lo = int(math.floor(pos))
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)
