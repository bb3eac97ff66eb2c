"""CUDA-graph capture and replay, shared by the training step's graphs
(``train/graph.py``) and the view's (``render.py::ViewGraph``).

A capture first runs the body once on a side stream, as ``torch.cuda.graphs``
requires, so that every first call (the kernels' C entries, cuBLAS, the
autograd engine's threads) happens before the capture; then it captures the
body into a graph, with a memory pool of its own or one that several graphs
share. The kernel wrappers' launch counters count Python calls, which a
replay does not make: a capture keeps the launches it made (and takes them
off the counters, since it ran no kernel) and :func:`replay` adds them
again at every replay.
"""
from __future__ import annotations

import time
from typing import Callable, NamedTuple, Optional

import torch


def launch_counters() -> tuple:
    """The kernel wrappers whose ``launches`` count their launches."""
    from ..ops.expand import expand_rows
    from ..ops.fold import fold_rows
    from ..ops.rasterize import (raster_tiles_bwd, raster_tiles_fwd,
                                 raster_tiles_fwd_save)
    return (expand_rows, raster_tiles_fwd, raster_tiles_fwd_save,
            raster_tiles_bwd, fold_rows)


class Capture(NamedTuple):
    graph: torch.cuda.CUDAGraph
    counts: dict                  # kernel wrapper -> launches per replay
    error: Optional[BaseException]  # what the capture raised, if it did
    pool_peak_bytes: int          # the capture's peak allocation
    reserved_growth_bytes: int    # what it added to the reserved memory
    start: float                  # time.perf_counter() when it began


def capture(device: torch.device, warm_up: Callable, body: Callable,
            capture_error_mode: str = "global", pool=None) -> Capture:
    """``warm_up()`` on a side stream, then ``body()`` captured, into
    ``pool`` (a ``torch.cuda.graph_pool_handle()`` that other graphs share)
    or a private pool of its own. An exception of the capture is returned,
    not raised, so that the ranks of a group can agree on it first
    (``train/graph.py``)."""
    t0 = time.perf_counter()
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        warm_up()
    torch.cuda.current_stream(device).wait_stream(side)
    torch.cuda.synchronize(device)
    counters = launch_counters()
    before = [f.launches for f in counters]
    torch.cuda.reset_peak_memory_stats(device)
    base = torch.cuda.memory_allocated(device)
    # torch.cuda.graph empties the cache before it captures: so does this,
    # so that the reserved memory before is what the capture starts from
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved(device)
    graph, error = torch.cuda.CUDAGraph(), None
    try:
        with torch.cuda.graph(graph, pool=pool,
                              capture_error_mode=capture_error_mode):
            body()
        torch.cuda.synchronize(device)
    except Exception as e:   # the caller raises it
        error = e
    counts = {f: f.launches - n for f, n in zip(counters, before)}
    for f, n in counts.items():
        f.launches -= n
    peak = torch.cuda.max_memory_allocated(device) - base
    return Capture(graph, counts, error, peak,
                   torch.cuda.memory_reserved(device) - reserved, t0)


def replay(graph: torch.cuda.CUDAGraph, counts: dict):
    """One replay of ``graph``, its launches added to the counters."""
    graph.replay()
    for f, n in counts.items():
        f.launches += n
