"""Reading the device from ``torch.profiler``: what ran on the card, when,
and what the host did in the gaps.

The traced window runs under ``torch.profiler.profile`` (CPU and CUDA
activities; CUPTI sees the kernels inside CUDA-graph replays), whose
Chrome trace is written under the run's ``TMPDIR`` and read back here.
Device operations are the trace's kernels, copies and sets. Busy time is
the union of their intervals; an idle gap is an interval with none, named
by the innermost host event (the benchmark's own spans, operators,
runtime calls) that covers its middle.
"""
from __future__ import annotations

import json
import os
import tempfile
from collections import defaultdict

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
NAMED_GAPS = 200      # the longest gaps named one by one
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver",
             "python_function")


def profile():
    return torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])


def read(prof) -> dict:
    """The trace of a finished profile: device operations [(name, start
    us, end us)] in start order, host events [(name, start, end)]."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            doc = json.load(f)
    finally:
        os.remove(path)
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    dev, host = [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        ts, dur = float(e.get("ts", 0)), float(e.get("dur", 0))
        if cat in DEVICE_CATS:
            dev.append((e.get("name", ""), ts, ts + dur))
        elif cat in HOST_CATS:
            host.append((e.get("name", ""), ts, ts + dur))
    dev.sort(key=lambda x: x[1])
    return {"device": dev, "host": host}


def summarize(tr: dict, t0_us: float = None, t1_us: float = None) -> dict:
    """Busy seconds (the union of the device intervals inside [t0, t1],
    the whole trace when not given), the window's length, the device
    operations' seconds by name and the idle gaps' seconds by what the
    host was doing."""
    dev = tr["device"]
    if not dev:
        return {"busy_s": 0.0, "window_s": 0.0, "ops": {}, "gaps": {}}
    lo = dev[0][1] if t0_us is None else t0_us
    hi = max(e[2] for e in dev) if t1_us is None else t1_us
    busy, ops, gaps = 0.0, defaultdict(float), []
    cur_s, cur_e = None, None
    for name, s, e in dev:
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        ops[name] += (e - s) * 1e-6
        if cur_e is None:
            if s > lo:
                gaps.append((lo, s))
            cur_s, cur_e = s, e
        elif s > cur_e:
            busy += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
        if hi > cur_e:
            gaps.append((cur_e, hi))
    # name the longest gaps by the host; the rest are the short gaps
    # between back-to-back operations
    gaps.sort(key=lambda g: g[0] - g[1])
    host = sorted(tr["host"], key=lambda x: x[1])
    named = defaultdict(float)
    for i, (a, b) in enumerate(gaps):
        if i >= NAMED_GAPS:
            named["short gaps between device operations"] += (b - a) * 1e-6
            continue
        mid = 0.5 * (a + b)
        best = None
        for name, s, e in host:
            if s > mid:
                break
            if e >= mid and (best is None or e - s < best[1]):
                best = (name, e - s)
        named[best[0] if best else "no host event"] += (b - a) * 1e-6
    return {"busy_s": busy * 1e-6, "window_s": (hi - lo) * 1e-6,
            "ops": dict(ops), "gaps": dict(named)}


def kernels(tr: dict, pattern: str) -> list[float]:
    """The durations (s) of the device operations whose name holds
    ``pattern``, in start order."""
    return [(e - s) * 1e-6 for name, s, e in tr["device"] if pattern in name]


def short(name: str, width: int = 96) -> str:
    """A device operation's name without its return type and arguments,
    cut to ``width`` characters."""
    name = name[5:] if name.startswith("void ") else name
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i]
                break
    name = name.strip()
    return name if len(name) <= width else name[:width - 3] + "..."


def top(d: dict, n: int = 10) -> list:
    """The ``n`` largest entries, [[short name, seconds], ...]; entries
    whose short names agree are summed."""
    merged = defaultdict(float)
    for k, v in d.items():
        merged[short(k)] += v
    return [[k, v] for k, v in sorted(merged.items(),
                                      key=lambda kv: -kv[1])[:n]]


def span_bounds(tr: dict, name: str):
    """(start, end) in us of the host span ``name`` (the first)."""
    for n, s, e in tr["host"]:
        if n == name:
            return s, e
    return None
