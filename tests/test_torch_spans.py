"""The stage stamps, the ``band_work`` counter and the host spans of
gs_tpu_torch (``utils/spans.py``) on the CPU, where a stamp records the host
clock, and on the card (``cuda``, skipped here), where it is a kernel inside
the CUDA-graph replays.

The scene is tests/test_torch_trainer.py's (four 64x48 views of uniform
noise, 50 points, capacity 256), made here with numpy alone.

* The eager step, the chain in block mode and step mode through the
  chain's graph (packed and tree), the banded step under
  ``LocalGroup(2)``, the view and the banded view each record their
  stages in order, once per step or frame, the backward's after every
  forward stage.
* Host spans nest under the right parent and share the step's or the
  frame's number; a span inside one of its own name is that span.
* The ring wraps: ``stage_ms(last=n)`` and ``counter(last=n)`` return the
  newest n units.
* ``band_work`` read back from the ring is ``render_multichip``'s.
* A step with the stamps, marks and counter is bitwise one without.
* Every per-layer metric of the benchmark that reads them
  (``benchmark/metrics``) returns a number from a recorded CPU run and None
  from an empty record.
* On the card: in a replayed chain step every stage's stamp kernel shows by
  name in a ``torch.profiler`` trace, and the stages sum to the replay's
  device span within 3 %; in a profiled graphed view frame every idle gap
  inside ``render_view`` or ``frame_bytes`` is named by a program span, or
  by a runtime call or an operator inside one, and program spans and
  runtime calls name most of that time
  (``benchmark/harness/trace.py::summarize``).
"""
import math
from collections import deque

import numpy as np
import pytest
import torch

from gs_tpu_torch.config import (ModelConfig, OptimizationConfig,
                                 PipelineConfig, RasterConfig)
from gs_tpu_torch.core.camera import focal2fov, make_camera
from gs_tpu_torch.data.camera_utils import LoadedCamera
from gs_tpu_torch.data.dataset_readers import CameraInfo
from gs_tpu_torch.parallel.mesh import LocalGroup
from gs_tpu_torch.parallel.render_mc import render_multichip
from gs_tpu_torch.train.graph import state_leaves
from gs_tpu_torch.train.loop import Trainer
from gs_tpu_torch.utils import spans
from gs_tpu_torch.viewer.server import frame_bytes

W, H = 64, 48
OPT = dict(iterations=30, position_lr_max_steps=30, densify_from_iter=5,
           densification_interval=10, densify_until_iter=25,
           opacity_reset_interval=1000, densify_grad_threshold=3.5e-4)

STEP = ["step", "preprocess", "binning", "raster", "loss", "loss_bwd",
        "raster_bwd", "preprocess_bwd", "update", "end"]
# two bands: the row costs' all-reduce between the binning's parts, and
# each band's binning and K1g
BANDS = ["exchange", "binning", "exchange", "binning", "raster", "binning",
         "raster", "exchange"]
MESH_STEP = (["step", "preprocess"] + BANDS
             + ["loss", "loss_bwd", "raster_bwd", "exchange_bwd",
                "preprocess_bwd", "update", "end"])
VIEW = ["frame", "preprocess", "binning", "raster", "end"]
MESH_VIEW = ["frame", "preprocess"] + BANDS + ["end"]
FORWARD = ("step", "preprocess", "binning", "raster", "loss", "exchange")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """At these shapes torch's thread pool gives nothing, and beside other
    test processes its threads oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    spans.clear()
    yield
    torch.set_num_threads(n)


def camera(device="cpu"):
    fovx = math.radians(60.0)
    return make_camera(np.eye(3), np.zeros(3), fovx,
                       focal2fov(W / (2 * math.tan(fovx / 2)), H), W, H,
                       device=device)


def trainer(device="cpu", mesh=None, packed=None, eager=False,
            white_background=False):
    rng = np.random.default_rng(42)
    images = [rng.uniform(0, 1, (3, H, W)).astype(np.float32)
              for _ in range(4)]
    pts = np.concatenate([rng.uniform(-1, 1, (50, 2)),
                          rng.uniform(3, 5, (50, 1))], axis=1)
    cols = rng.uniform(0, 1, (50, 3))
    cam = camera(device)
    views = [LoadedCamera(
        camera=cam, info=CameraInfo(
            uid=i, R=np.eye(3), T=np.zeros(3), fovx=1.0, fovy=0.8,
            image_path="", image_name=f"v{i}", width=W, height=H),
        image=img, alpha_mask=np.ones((1, H, W), np.float32), invdepth=None,
        depth_mask=None, depth_reliable=False)
        for i, img in enumerate(images)]
    tr = Trainer(views, (pts, cols, np.zeros_like(pts)), spatial_lr_scale=1.0,
                 model_cfg=ModelConfig(sh_degree=1,
                                       white_background=white_background,
                                       data_device=str(device)),
                 opt=OptimizationConfig(**OPT),
                 pipe=PipelineConfig(),
                 raster=RasterConfig(dup_capacity=4096, max_per_tile=512,
                                     chunk=32),
                 initial_capacity=256, seed=7, packed=packed, mesh=mesh)
    tr._eager_dispatch = eager
    return tr


def sequences(device="cpu"):
    """The stamps the ring holds, split into units at each opener: [(kind,
    [stage, ...])], repeats of one stage in a row written once."""
    out = []
    for tag, _ in spans.ring(device).read().tolist():
        if tag >= spans.COUNTER_BASE:
            continue
        name = spans.STAGES[tag]
        if name in spans.OPENERS:
            out.append((name, [name]))
        elif out and out[-1][1][-1] != name:
            out[-1][1].append(name)
    return out


# ----------------------------------------------------------------- stages

@pytest.mark.parametrize("mode", ["eager", "chain", "step"])
@pytest.mark.parametrize("packed", [True, False], ids=["packed", "tree"])
def test_step_records_its_stages_in_order(mode, packed):
    tr = trainer(packed=packed, eager=mode == "eager")
    spans.clear()
    tr.train(iterations=4, block_scan=mode == "chain")
    units = sequences()
    n = 4
    assert units == [("step", STEP)] * n
    for _, seq in units:
        last_forward = max(i for i, s in enumerate(seq) if s in FORWARD)
        assert all(i > last_forward for i, s in enumerate(seq)
                   if s.endswith("_bwd"))
    ms = spans.stage_ms(unit="step")
    assert len(ms) == n and spans.stage_ms() == ms
    assert all(set(u) == set(STEP[:-1]) for u in ms)
    assert all(v >= 0 for u in ms for v in u.values())
    assert spans.stage_ms(last=2) == ms[-2:]


def test_mesh_step_records_its_stages_in_order():
    tr = trainer(mesh=LocalGroup(2, "cpu"))
    spans.clear()
    tr.train(iterations=2, block_scan=True)
    assert sequences() == [("step", MESH_STEP)] * 2
    assert len(spans.counter("band_work", unit="step")) == 2


@pytest.mark.parametrize("mesh", [None, 2], ids=["one-device", "mesh"])
def test_view_records_its_stages_in_order(mesh):
    tr = trainer(mesh=None if mesh is None else LocalGroup(mesh, "cpu"))
    spans.clear()
    for _ in range(2):
        tr.render_view(camera())
    assert sequences() == [("frame", MESH_VIEW if mesh else VIEW)] * 2
    assert len(spans.stage_ms(unit="frame")) == 2


def test_density_control_stamps_its_own_units():
    tr = trainer(white_background=True)
    spans.clear()
    tr.train(iterations=10, block_scan=True)
    kinds = [k for k, _ in sequences()]
    # a white background resets opacities at densify_from_iter (5), and
    # the densify runs at 10
    assert kinds == ["step"] * 5 + ["reset_opacity"] + ["step"] * 5 \
        + ["densify"]
    assert [seq for k, seq in sequences() if k != "step"] == [
        ["reset_opacity", "end"], ["densify", "end"]]


# -------------------------------------------------------------- host spans

def _by_name(record):
    out = {}
    for s in record:
        out.setdefault(s.name.removeprefix(spans.PREFIX), []).append(s)
    return out


def test_host_spans_nest_and_share_the_step_and_frame():
    tr = trainer()
    spans.clear()
    tr.train(iterations=3, block_scan=True)
    rec = spans.host_spans()
    by_id = {s.id: s for s in rec}
    named = _by_name(rec)

    def parent(s):
        return by_id[s.parent].name.removeprefix(spans.PREFIX)

    (train,) = named["train"]
    assert train.parent is None and train.unit == 1
    assert [parent(s) for s in named["train.block"]] == ["train"]
    assert [parent(s) for s in named["train.load"]] == ["train.block"]
    steps = named["train.step"]
    assert [parent(s) for s in steps] == ["train.block"] * 3
    assert [s.unit for s in steps] == [1, 2, 3]
    assert {parent(s) for s in named["train.sync"]} == {"train"}
    assert {parent(s) for s in named["train.snapshot"]} == {"train.sync"}
    assert [parent(s) for s in named["train.schedule"]] == ["train"]
    for s in rec:
        assert s.start_ns <= s.end_ns
        if s.parent is not None:
            p = by_id[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns

    spans.clear()
    for _ in range(2):
        frame_bytes(tr.render_view(camera()).image)
    named = _by_name(spans.host_spans())
    # render_view, render_grown and the view graph's call are one span
    assert [s.unit for s in named["view"]] == [1, 2]
    assert [s.unit for s in named["frame_bytes"]] == [1, 2]
    views = {s.id: s.unit for s in named["view"]}
    for child in ("view.load", "view.replay", "view.copy_out",
                  "view.overflow_check"):
        assert [views[s.parent] for s in named[child]] == [1, 2]
        assert [s.unit for s in named[child]] == [1, 2]
    calls = {s.id for s in named["frame_bytes"]}
    for child in ("frame_bytes.convert", "frame_bytes.readback",
                  "frame_bytes.tobytes"):
        assert all(s.parent in calls for s in named[child])
        assert [s.unit for s in named[child]] == [1, 2]


def test_a_span_enters_the_profiler_only_while_it_runs():
    with spans.span("outer", unit=5):
        with spans.span("outer"):            # the same span
            pass
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with spans.span("traced"):
            torch.zeros(1)
    names = {e.key for e in prof.key_averages()}
    assert "gs_tpu_torch.traced" in names
    assert "gs_tpu_torch.outer" not in names
    assert [(s.name, s.unit) for s in spans.host_spans()] == [
        ("gs_tpu_torch.outer", 5), ("gs_tpu_torch.traced", 0)]


# --------------------------------------------------------- ring, counters

def test_the_ring_wraps_and_keeps_the_newest(monkeypatch):
    monkeypatch.setattr(spans, "RING", 64)
    monkeypatch.setattr(spans, "_rings", {})
    for i in range(20):        # four entries a unit: 80 in a ring of 64
        spans.stage("step", "cpu")
        spans.count("band_work", torch.tensor([i], dtype=torch.int64))
        spans.stage("update", "cpu")
        spans.stage("end", "cpu")
    assert spans.ring("cpu").cursor == 80
    assert spans.counter("band_work", last=3) == [[17], [18], [19]]
    assert len(spans.stage_ms()) == 16          # units 4..19
    assert spans.counter("band_work") == [[i] for i in range(4, 20)]
    newest = spans.stage_ms(last=2)
    assert len(newest) == 2 and set(newest[0]) == {"step", "update"}
    # one more stamp takes the oldest unit's first slot, and a unit without
    # its end is not yet a unit
    spans.stage("step", "cpu")
    assert spans.stage_ms() == spans.stage_ms(last=15) and len(
        spans.stage_ms()) == 15
    spans.clear()
    assert spans.stage_ms() == [] and spans.stage_means() == {}


def test_band_work_is_render_multichips():
    tr = trainer()
    st = tr.state
    from gs_tpu_torch.models.packed_state import unpack_state
    params = unpack_state(st).params
    for k in (2, 4):
        spans.stage("frame", "cpu")
        out = render_multichip(
            params, camera(), torch.zeros(3), LocalGroup(k, "cpu"),
            active_sh_degree=1, alive=unpack_state(st).alive,
            dup_capacity=4096, max_per_tile=512)
        spans.stage("end", "cpu")
        assert spans.counter("band_work", last=1) == [out.band_work.tolist()]
        assert len(out.band_work) == k and int(out.band_work.sum()) > 0


def test_count_takes_int64_vectors():
    with pytest.raises(ValueError, match="int64 vector"):
        spans.count("band_work", torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError, match="int64 vector"):
        spans.count("band_work", torch.zeros((2, 2), dtype=torch.int64))


# ------------------------------------------------------------- no values

@pytest.mark.parametrize("mesh", [None, 2], ids=["one-device", "mesh"])
@pytest.mark.parametrize("packed", [True, False], ids=["packed", "tree"])
def test_stamps_change_no_value(monkeypatch, packed, mesh):
    runs = []
    for stamped in (True, False):
        with monkeypatch.context() as m:
            if not stamped:
                m.setattr(spans, "stage", lambda name, device: None)
                m.setattr(spans, "count", lambda name, values: None)
                m.setattr(spans, "mark",
                          lambda name, *xs: xs[0] if len(xs) == 1 else xs)
            tr = trainer(packed=packed,
                         mesh=None if mesh is None else LocalGroup(mesh,
                                                                   "cpu"))
            losses = []
            tr.train(iterations=3, block_scan=True,
                     on_step=lambda i, mt, t: losses.append(float(mt.loss)))
            image = tr.render_view(camera()).image
            runs.append((losses, state_leaves(tr.state), image))
    (la, sa, ia), (lb, sb, ib) = runs
    assert la == lb and torch.equal(ia, ib)
    for x, y in zip(sa, sb):
        assert torch.equal(x, y)


# -------------------------------------------------------------- metrics

TRAIN_METRICS = ("preprocess_ms.train", "raster_ms.train", "loss_ms.train",
                 "update_ms.train", "loss_ms.mesh4", "raster_ms.mesh4",
                 "exchange_ms.mesh4", "band_imbalance.mesh4")
VIEW_METRICS = ("preprocess_ms.view", "raster_ms.view", "frame_host_ms.view")


@pytest.fixture(scope="module")
def recorded():
    """A banded training run of 3 iterations and 2 served frames: the CPU
    ring and the host record they left."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        spans.clear()
        tr = trainer(mesh=LocalGroup(2, "cpu"))
        tr.train(iterations=3, block_scan=True)
        for _ in range(2):
            frame_bytes(tr.render_view(camera()).image)
        r = spans.ring("cpu")
        return r.entries.copy(), r.cursor, list(spans._record)
    finally:
        torch.set_num_threads(n)


@pytest.mark.parametrize("metric", TRAIN_METRICS + VIEW_METRICS)
def test_metric_reads_the_record(monkeypatch, recorded, metric):
    from benchmark.harness.common import reader
    read = reader(metric)
    view = metric in VIEW_METRICS
    t = {"kind": "view" if view else "train", "units": 2 if view else 3,
         "chips": 1 if view else 4, "busy_s": [1.0], "window_s": [1.0],
         "nccl_s": [0.0]}
    entries, cursor, record = recorded
    r = spans.ring("cpu")
    r.entries[:], r.cursor = entries, cursor
    monkeypatch.setattr(spans, "_record", deque(record, spans.HOST_SPANS))
    value = read(t)
    assert isinstance(value, float) and math.isfinite(value) and value > 0
    if metric == "band_imbalance.mesh4":
        assert 1.0 <= value <= 2.0
    spans.clear()
    assert read(t) is None


# ----------------------------------------------------------------- card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the stamps are kernels)")
    return torch.device("cuda")


def _profiled(fn):
    from benchmark.harness import trace as TR
    with TR.profile() as prof:
        fn()
        torch.cuda.synchronize()
    return TR.read(prof)


@pytest.mark.cuda
def test_stamps_show_by_name_inside_replays(cuda_device):
    tr = trainer(cuda_device)
    tr.train(iterations=2, block_scan=True)       # captured
    spans.clear()
    events = _profiled(lambda: tr.train(iterations=5, block_scan=True))
    assert len(tr.captures) == 1
    names = [n for n, _, _ in events["device"]]
    for s in STEP:
        assert sum(f"gs_stage_{s}(" in n for n in names) == 3, s
    stamps = [(n, s, e) for n, s, e in events["device"] if "gs_stage_" in n]
    starts = [s for n, s, _ in stamps if "gs_stage_step(" in n]
    ends = [e for n, _, e in stamps if "gs_stage_end(" in n]
    units = spans.stage_ms(last=3, unit="step")
    assert len(units) == 3
    for u, a, b in zip(units, starts, ends):
        span_ms = (b - a) * 1e-3
        assert abs(sum(u.values()) - span_ms) <= 0.03 * span_ms, (u, span_ms)

    cam = camera(cuda_device)
    tr.render_view(cam)                           # captured
    events = _profiled(lambda: [tr.render_view(cam) for _ in range(2)])
    names = [n for n, _, _ in events["device"]]
    for s in VIEW:
        assert sum(f"gs_stage_{s}(" in n for n in names) == 2, s


@pytest.mark.cuda
def test_view_gaps_are_named_by_the_program(cuda_device):
    from benchmark.harness import trace as TR
    tr = trainer(cuda_device)
    cam = camera(cuda_device)
    for _ in range(3):
        frame_bytes(tr.render_view(cam).image)      # captured and warm
    events = _profiled(lambda: [frame_bytes(tr.render_view(cam).image)
                                for _ in range(3)])
    calls = [(s, e) for n, s, e in events["host"]
             if n in ("gs_tpu_torch.view", "gs_tpu_torch.frame_bytes")]
    assert len(calls) == 6
    named = {}
    for s, e in calls:
        for name, sec in TR.summarize(events, s, e)["gaps"].items():
            named[name] = named.get(name, 0.0) + sec
    print("idle gaps inside the program's calls:", named)
    # named by a program span, by a runtime call, or by an operator the
    # program called eagerly between replays: nothing of the caller's
    assert named and all(
        n.startswith(("gs_tpu_torch.", "cuda", "aten::"))
        or n == "short gaps between device operations" for n in named), named
    spans_and_runtime = sum(v for n, v in named.items()
                            if n.startswith(("gs_tpu_torch.", "cuda")))
    assert spans_and_runtime > 0.5 * sum(named.values()), named
