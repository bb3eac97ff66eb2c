"""CUDA-graph capture and replay, shared by the training step's and
density control's graphs (``train/graph.py``), the view's
(``render.py::ViewGraph``) and the metrics CLI's SSIM and LPIPS
(:class:`GraphedFunction`).

A capture first runs the body once on a side stream, as ``torch.cuda.graphs``
requires, so that every first call (the kernels' C entries, cuBLAS, the
autograd engine's threads) happens before the capture; then it captures the
body into a graph, with a memory pool of its own or one that several graphs
share. The kernel wrappers' launch counters count Python calls, which a
replay does not make: a capture keeps the launches it made (and takes them
off the counters, since it ran no kernel) and :func:`replay` adds them
again at every replay. The stage stamps the bodies make
(``utils/spans.py``) are captured with them; their ring is made before the
first capture.
"""
from __future__ import annotations

import time
from collections import OrderedDict
from typing import Callable, NamedTuple

import torch


def launch_counters() -> tuple:
    """The kernel wrappers whose ``launches`` count their launches: K2,
    K1, K1g, K3, K4, the preprocess's forward and backward, Adam's pass
    over the packed block, then SSIM's forward and backward."""
    from ..core.project import preprocess_bwd, preprocess_fwd
    from ..ops.adam import adam_packed
    from ..ops.expand import expand_rows
    from ..ops.fold import fold_rows
    from ..ops.rasterize import (raster_tiles_bwd, raster_tiles_fwd,
                                 raster_tiles_fwd_save)
    from ..ops.ssim import ssim_bwd, ssim_fwd
    return (expand_rows, raster_tiles_fwd, raster_tiles_fwd_save,
            raster_tiles_bwd, fold_rows, preprocess_fwd, preprocess_bwd,
            adam_packed, ssim_fwd, ssim_bwd)


class Capture(NamedTuple):
    graph: torch.cuda.CUDAGraph
    counts: dict                  # kernel wrapper -> launches per replay
    pool_peak_bytes: int          # the capture's peak allocation
    reserved_growth_bytes: int    # what it added to the reserved memory
    start: float                  # time.perf_counter() when it began


def capture(device: torch.device, warm_up: Callable, body: Callable,
            label: str, *, mesh=None, owner=None, pool=None) -> Capture:
    """``warm_up()`` on a side stream, then ``body()`` captured, into
    ``pool`` (a ``torch.cuda.graph_pool_handle()`` that other graphs share)
    or a private pool of its own. Raises if the capture failed.

    Under ``mesh`` (a group of ``parallel/mesh.py``) the body may hold the
    group's collectives: every rank captures at the same call, with the
    group's ``capture_error_mode``, and the ranks agree (``every``, an
    eager collective) that every capture succeeded before any rank raises
    ("on another rank" where its own succeeded). ``owner`` (what holds the
    graph, with a ``release()``) is then registered with a
    ``ProcessGroup``'s ``graphs``, which ``close`` releases before the
    group is destroyed."""
    t0 = time.perf_counter()
    from . import spans
    spans.ring(device)       # the stage stamps' ring, made outside a capture
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
    mode = "global" if mesh is None else mesh.capture_error_mode
    graph, error = torch.cuda.CUDAGraph(), None
    try:
        with torch.cuda.graph(graph, pool=pool, capture_error_mode=mode):
            body()
        torch.cuda.synchronize(device)
    except Exception as e:   # raised below, once the ranks agree
        error = e
    counts = {f: f.launches - n for f, n in zip(counters, before)}
    for f, n in counts.items():
        f.launches -= n
    ok = error is None
    if mesh is not None:
        ok = mesh.every(ok)      # a collective: every rank learns it
    if not ok:
        where = "" if error is not None else " on another rank"
        raise RuntimeError(f"capturing the {label} failed{where}") from error
    if owner is not None and getattr(mesh, "graphs", None) is not None:
        mesh.graphs.add(owner)    # released before the group is closed
    peak = torch.cuda.max_memory_allocated(device) - base
    return Capture(graph, counts, peak,
                   torch.cuda.memory_reserved(device) - reserved, t0)


def replay(graph: torch.cuda.CUDAGraph, counts: dict):
    """One replay of ``graph``, its launches added to the counters."""
    graph.replay()
    for f, n in counts.items():
        f.launches += n


class GraphCache:
    """Captured graphs by key, the least recently used released first once
    more than a limit are held, every one allocating from one shared
    memory pool: that is safe because they never run at once and each
    call copies its outputs out before the next replay. An entry has a
    ``graph`` (None where its body runs eagerly, on the CPU)."""

    def __init__(self):
        self.entries: OrderedDict = OrderedDict()   # key -> entry
        self.pool = None

    def release(self):
        """Destroy every captured graph (and so free their pool: the next
        capture makes one)."""
        for e in self.entries.values():
            if e.graph is not None:
                e.graph.reset()
        self.entries = OrderedDict()
        self.pool = None

    def pool_handle(self):
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        return self.pool

    def lookup(self, key):
        """The entry of ``key`` (now the most recently used), or None."""
        e = self.entries.get(key)
        if e is not None:
            self.entries.move_to_end(key)
        return e

    def insert(self, key, entry, limit: int):
        """``entry`` under ``key``; beyond ``limit`` entries the oldest
        are released (after the capture: the pool keeps a graph that uses
        it)."""
        self.entries[key] = entry
        while len(self.entries) > max(int(limit), 1):
            _, old = self.entries.popitem(last=False)
            if old.graph is not None:
                old.graph.reset()


# the keys a GraphedFunction keeps captured: the least recently used goes
# first
MAX_KEYS = 4


class _Entry(NamedTuple):
    inputs: list                  # the static inputs, copied into per call
    graph: torch.cuda.CUDAGraph
    counts: dict
    outputs: list                 # [the static outputs: a tensor or a tuple]


class GraphedFunction(GraphCache):
    """``fn`` of tensors as CUDA-graph replays: the port of a ``jax.jit``
    that is called once per input of the same shapes (the metrics CLI's
    ``jit_ssim``, ``gs_tpu/apps/metrics.py:47``; the LPIPS distance,
    ``gs_tpu/ops/lpips.py:110``).

    A call with CUDA tensors replays the graph captured for its inputs'
    shapes, dtypes and devices: the inputs are copied into the graph's
    static inputs, the graph replays, and copies of its outputs (a tensor
    or a tuple of tensors) are returned. A key's first call captures it.
    At most ``MAX_KEYS`` keys stay captured (a :class:`GraphCache`). With
    CPU tensors ``fn`` runs as it is. ``captures`` records each capture's
    shapes, ms, peak allocation and what it added to the memory the card
    reserves."""

    def __init__(self, fn: Callable, label: str = "fn"):
        super().__init__()
        self.fn = fn
        self.label = label
        self.captures: list = []

    @staticmethod
    def _graphed(args) -> bool:
        return args[0].is_cuda

    def __call__(self, *args: torch.Tensor):
        if not self._graphed(args):
            return self.fn(*args)
        key = tuple((tuple(a.shape), a.dtype, a.device) for a in args)
        e = self.lookup(key)
        if e is None:
            e = self._capture(key, args)
        else:
            for s, a in zip(e.inputs, args):
                s.copy_(a)
        replay(e.graph, e.counts)
        out = e.outputs[0]
        if isinstance(out, torch.Tensor):
            return out.clone()
        return tuple(x.clone() for x in out)

    def _capture(self, key, args) -> _Entry:
        inputs = [a.clone() for a in args]
        out = [None]

        def body():
            out[0] = self.fn(*inputs)

        cap = capture(args[0].device, lambda: self.fn(*inputs), body,
                      self.label, pool=self.pool_handle())
        e = _Entry(inputs, cap.graph, cap.counts, out)
        self.insert(key, e, MAX_KEYS)
        ms = 1e3 * (time.perf_counter() - cap.start)
        self.captures.append(dict(
            shapes=[k[0] for k in key], ms=ms,
            pool_peak_bytes=cap.pool_peak_bytes,
            pool_growth_bytes=cap.reserved_growth_bytes))
        return e
