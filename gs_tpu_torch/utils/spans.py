"""What each stage of the step and the view costs, and what the host does
around them: stage stamps inside the CUDA-graph replays, a counter beside
them, and host spans.

**Stages.** :func:`stage` marks the boundary where a stage of the step or the
view begins. On a CUDA device it launches the stage's stamp kernel
(``csrc/stage.cu``, ``gs_stage_<stage>``) on the current stream: one thread
that writes (stage id, the device's nanosecond clock) into a ring that this
module allocates once per device and never moves, so a captured graph keeps
the stamp and the ring's pointer, and every replay stamps again. A profiler
trace shows the stamp kernels by name between the stages' kernels, on the
trace's own clock. On the CPU the same call records the host clock and
launches nothing. :func:`mark` is an identity on a stage's outputs whose
backward stamps ``<stage>_bwd`` (or whatever it is given) when their
gradient arrives. Stamps change no value.

A unit of work opens at one of :data:`OPENERS` (``step``, ``frame``, and
density control's ``densify`` and ``reset_opacity``) and closes at ``end``
or at the next opener. A stage's
time runs from its stamp to the next stamp; a stage stamped several times in
a unit sums; what runs between an ``end`` and the next opener (the host
between replays) is in no stage. :func:`stage_ms` copies the ring back (a
wait for the device: call it on demand, never inside the hot loop) and
returns each stage's ms of the last units.

**Counters.** :func:`count` writes a device vector of int64 values into the
same ring, as entries tagged with the counter and the value's index, with no
readback (``parallel/render_mc.py`` writes ``band_work``, every band's
composited entries, once a step; ``train/step.py`` writes
``adam_columns``, the columns the sparse Adam writes, once a step under
``optimizer_type="sparse_adam"``); :func:`counter` reads them back, one
vector a unit.

**Host spans.** :class:`span` is a context manager that keeps, in a bounded
in-memory record, the span's name, start and end (``perf_counter_ns``), its
parent and the unit (the iteration or the frame) that the spans of one step
or frame share, and, only while a profiler is active, enters a
``torch.profiler.record_function`` of the same name, so that a trace puts
the host's time, and the device's idle gaps, down to a program call. Names
start with ``gs_tpu_torch.``. :func:`host_spans` returns the record.

What reads them: the train CLI's ``--profile`` window, ``chip_smoke.py``'s
[train stages], and the benchmark's per-layer metrics
(``benchmark/metrics/*_ms.*.py``, ``band_imbalance.mesh4.py``).
"""
from __future__ import annotations

import ctypes
import itertools
import threading
import time
from collections import deque
from typing import NamedTuple, Optional

import numpy as np
import torch

# the stages, in the order of their ids (csrc/stage.cu's GS_STAGES)
STAGES = ("step", "preprocess", "binning", "raster", "loss", "loss_bwd",
          "raster_bwd", "preprocess_bwd", "update", "end", "frame",
          "exchange", "exchange_bwd", "densify", "reset_opacity", "depth",
          "exposure")
OPENERS = ("step", "frame", "densify", "reset_opacity")
COUNTERS = ("band_work", "adam_columns")
# a counter's entries are tagged COUNTER_BASE + counter * COUNTER_SPAN + i
COUNTER_BASE = 1 << 20
COUNTER_SPAN = 1 << 16
RING = 1 << 14            # entries of each device's ring
HOST_SPANS = 1 << 16      # host spans the record keeps
PREFIX = "gs_tpu_torch."
SOURCE = "stage.cu"

_STAGE_ID = {s: i for i, s in enumerate(STAGES)}


class _Ring:
    """One device's ring: [RING, 2] int64 (tag, value) and a cursor that
    only grows; entry k sits at slot k mod RING. On CUDA both are device
    tensors the stamp kernels write; on the CPU a numpy array and an int."""

    def __init__(self, device: torch.device):
        self.device = device
        self.host = device.type != "cuda"
        if self.host:
            self.entries = np.zeros((RING, 2), np.int64)
            self.cursor = 0
        else:
            if torch.cuda.is_current_stream_capturing():
                raise RuntimeError("the stage ring of a device is made "
                                   "before a capture (utils/cuda_graphs.py)")
            self.entries = torch.zeros((RING, 2), dtype=torch.int64,
                                       device=device)
            self.cursor = torch.zeros((1,), dtype=torch.int64, device=device)

    def put(self, tag: int, values):
        """Host rings: ``values`` under tags tag, tag + 1, ..."""
        for i, v in enumerate(values):
            self.entries[self.cursor % RING] = (tag + i, v)
            self.cursor += 1

    def read(self) -> np.ndarray:
        """The entries the ring holds, oldest first, [m, 2]."""
        if self.host:
            entries, n = self.entries, self.cursor
        else:
            n = int(self.cursor.item())
            entries = self.entries.cpu().numpy()
        m = min(n, RING)
        return entries[(np.arange(n - m, n) % RING)]

    def clear(self):
        if self.host:
            self.entries[:] = 0
            self.cursor = 0
        else:
            self.entries.zero_()
            self.cursor.zero_()


_rings: dict = {}
_last: list = [None]      # the device stamped last


def _key(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def ring(device) -> _Ring:
    """The ring of ``device``, made at its first use (on CUDA, outside any
    capture: ``utils/cuda_graphs.py::capture`` asks for it first)."""
    device = _key(device)
    r = _rings.get(device)
    if r is None:
        r = _rings[device] = _Ring(device)
    _last[0] = device
    return r


_STAMP_ARGS = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
               ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
_COUNTER_ARGS = [ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong,
                 ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                 ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
_checked = [False]


def _entry(name: str, argtypes):
    """The C entry ``name`` of ``csrc/stage.cu``; at the first, the
    library's stage names are checked against :data:`STAGES`."""
    from ..ops import _cuda
    if not _checked[0]:
        names = _cuda.function(SOURCE, "gs_stage_names", [])
        names.restype = ctypes.c_char_p
        built = tuple(names().decode().rstrip(",").split(","))
        if built != STAGES:
            raise RuntimeError(f"csrc/stage.cu has the stages {built}, "
                               f"spans.py {STAGES}")
        _checked[0] = True
    return _cuda.function(SOURCE, name, argtypes)


def stage(name: str, device) -> None:
    """The boundary where stage ``name`` begins, on ``device``: a stamp
    kernel on the current stream (captured with it), or the host clock on
    the CPU."""
    sid = _STAGE_ID[name]
    r = ring(device)
    if r.host:
        r.put(sid, (time.perf_counter_ns(),))
        return
    from ..ops import _cuda
    err = _entry("gs_stage_stamp", _STAMP_ARGS)(
        sid, r.entries.data_ptr(), r.cursor.data_ptr(), RING,
        r.device.index, _cuda.stream_ptr(r.device))
    _cuda.check(SOURCE, err, f"the {name} stamp")


def count(name: str, values: torch.Tensor) -> None:
    """The int64 vector ``values`` (on its device, strided or not) into
    the ring as counter ``name``'s entries: no readback on CUDA."""
    if values.dtype != torch.int64 or values.dim() != 1:
        raise ValueError(f"counter {name}: an int64 vector, not "
                         f"{values.dtype} {tuple(values.shape)}")
    if values.shape[0] > COUNTER_SPAN:
        raise ValueError(f"counter {name}: at most {COUNTER_SPAN} values")
    tag0 = COUNTER_BASE + COUNTERS.index(name) * COUNTER_SPAN
    r = ring(values.device)
    if r.host:
        r.put(tag0, values.tolist())
        return
    from ..ops import _cuda
    err = _entry("gs_counter_write", _COUNTER_ARGS)(
        tag0, values.data_ptr(), values.stride(0), values.shape[0],
        r.entries.data_ptr(), r.cursor.data_ptr(), RING, r.device.index,
        _cuda.stream_ptr(r.device))
    _cuda.check(SOURCE, err, f"the {name} counter")


class _Mark(torch.autograd.Function):
    """Identity forward; the backward stamps its stage when the outputs'
    gradients have arrived, and passes them on unchanged."""

    @staticmethod
    def forward(ctx, name, device, *xs):
        ctx.stage, ctx.device = name, device
        ctx.set_materialize_grads(False)
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        stage(ctx.stage, ctx.device)
        return (None, None) + grads


def mark(name: str, *xs: torch.Tensor):
    """``xs`` as they are; where any requires a gradient, through an
    identity whose backward stamps ``name`` once all of theirs has
    arrived. Returns one tensor for one, else a tuple."""
    if torch.is_grad_enabled() and any(x.requires_grad for x in xs):
        xs = _Mark.apply(name, xs[0].device, *xs)
    return xs[0] if len(xs) == 1 else tuple(xs)


class Unit(NamedTuple):
    kind: str                # the opener: step, frame, densify, ...
    ms: dict                 # stage -> ms
    counters: dict           # counter -> [values]


def _units(device) -> list:
    r = _rings.get(_last[0] if device is None else _key(device))
    if r is None:
        return []
    units, cur, open_stage, t_open = [], None, None, 0
    for tag, value in r.read().tolist():
        if tag >= COUNTER_BASE:
            if cur is not None:
                c = COUNTERS[(tag - COUNTER_BASE) // COUNTER_SPAN]
                cur.counters.setdefault(c, []).append(value)
            continue
        name = STAGES[tag]
        if cur is not None and open_stage is not None:
            cur.ms[open_stage] = (cur.ms.get(open_stage, 0.0)
                                  + (value - t_open) * 1e-6)
        if name in OPENERS:
            if cur is not None:
                units.append(cur)
            cur = Unit(name, {}, {})
        elif name == "end":
            if cur is not None:
                units.append(cur)
            cur = None
        open_stage = name if cur is not None else None
        t_open = value
    return units             # a unit without its end yet is left out


def _last_units(last, unit, device) -> list:
    units = [u for u in _units(device) if unit is None or u.kind == unit]
    return units if last is None else units[max(len(units) - last, 0):]


def stage_ms(last: Optional[int] = None, unit: Optional[str] = None,
             device=None) -> list:
    """Each stage's ms, {stage: ms}, for each of the last ``last`` units
    (all the ring holds: None) of kind ``unit`` (an opener; None: any),
    oldest first, on ``device`` (None: the device stamped last). Copies
    the ring back."""
    return [u.ms for u in _last_units(last, unit, device)]


def stage_means(last: Optional[int] = None, unit: Optional[str] = None,
                device=None) -> dict:
    """Each stage's mean ms over the units :func:`stage_ms` returns (a
    stage a unit lacks counts 0 there); empty where there is none."""
    units = stage_ms(last, unit, device)
    out: dict = {}
    for u in units:
        for k, v in u.items():
            out[k] = out.get(k, 0.0) + v / len(units)
    return out


def counter(name: str, last: Optional[int] = None,
            unit: Optional[str] = None, device=None) -> list:
    """Counter ``name``'s values in each of the last ``last`` units of kind
    ``unit`` that wrote it, oldest first: one vector a unit."""
    return [u.counters[name] for u in _last_units(None, unit, device)
            if name in u.counters][-last if last else 0:]


# ------------------------------------------------------------ host spans

class Span(NamedTuple):
    id: int
    name: str                # gs_tpu_torch.<name>
    start_ns: int
    end_ns: int
    parent: Optional[int]    # the enclosing span's id
    unit: int                # the iteration or frame number


_record: deque = deque(maxlen=HOST_SPANS)
_ids = itertools.count()
_local = threading.local()
_frame = [0]


def _stack() -> list:
    s = getattr(_local, "stack", None)
    if s is None:
        s = _local.stack = []
    return s


class span:
    """``with span(name, unit=None, frame=False):`` a host span named
    ``gs_tpu_torch.<name>``. ``unit``: the iteration it belongs to; by
    default its parent's, else the current frame's; ``frame``: it opens a
    new frame, whose number is its unit. A span inside one of its own name
    is that span."""

    __slots__ = ("name", "unit", "frame", "entry", "rf")

    def __init__(self, name: str, unit: Optional[int] = None,
                 frame: bool = False):
        self.name, self.unit, self.frame = PREFIX + name, unit, frame
        self.entry = self.rf = None

    def __enter__(self):
        stack = _stack()
        if stack and stack[-1][1] == self.name:
            return self
        unit = self.unit
        if self.frame:
            _frame[0] += 1
            unit = _frame[0]
        elif unit is None:
            unit = stack[-1][2] if stack else _frame[0]
        if torch.autograd.profiler._is_profiler_enabled:
            self.rf = torch.autograd.profiler.record_function(self.name)
            self.rf.__enter__()
        self.entry = (next(_ids), self.name, unit,
                      stack[-1][0] if stack else None, time.perf_counter_ns())
        stack.append(self.entry)
        return self

    def __exit__(self, *exc):
        if self.entry is None:
            return False
        end = time.perf_counter_ns()
        _stack().pop()
        sid, name, unit, parent, start = self.entry
        _record.append(Span(sid, name, start, end, parent, unit))
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


def host_spans() -> list:
    """The host spans recorded, in the order they ended."""
    return list(_record)


def clear():
    """Empty every ring and the host record (the rings stay where they
    are: graphs hold them)."""
    for r in _rings.values():
        r.clear()
    _record.clear()
    _frame[0] = 0
