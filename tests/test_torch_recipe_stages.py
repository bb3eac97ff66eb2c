"""The stages and the counter that the 2024 release's training switches add
to gs_tpu_torch's step (``train/step.py``, ``utils/spans.py``), on the CPU,
where a stamp records the host clock.

* ``depth`` is stamped before the depth-L1 term only where the views carry
  depth priors, ``exposure`` before the exposure's Adam only under
  ``train_test_exp``; a step with neither stamps the plain step's stages,
  in the eager step, the chain (block mode) and step mode through the
  chain's graph.
* ``adam_columns`` is written once a step only under ``sparse_adam``, and
  equals the step's visible count (``StepMetrics.n_visible``), the columns
  the masked Adam writes; a block shorter than its bucket writes one entry
  a step it ran.
* The new stamps and the counter change no value.

The scene is tests/test_torch_spans.py's (four 64x48 views of uniform
noise, 50 points, capacity 256), with inverse-depth maps beside it.
"""
import math

import numpy as np
import pytest
import torch

from gs_tpu_torch.config import (ModelConfig, OptimizationConfig,
                                 PipelineConfig, RasterConfig)
from gs_tpu_torch.core.camera import focal2fov, make_camera
from gs_tpu_torch.data.camera_utils import LoadedCamera
from gs_tpu_torch.data.dataset_readers import CameraInfo
from gs_tpu_torch.parallel.mesh import LocalGroup
from gs_tpu_torch.train.graph import state_leaves
from gs_tpu_torch.train.loop import Trainer
from gs_tpu_torch.utils import spans

W, H = 64, 48
OPT = dict(iterations=30, position_lr_max_steps=30, densify_from_iter=5,
           densification_interval=10, densify_until_iter=25,
           opacity_reset_interval=1000, densify_grad_threshold=3.5e-4)
STEP = ["step", "preprocess", "binning", "raster", "loss", "loss_bwd",
        "raster_bwd", "preprocess_bwd", "update", "end"]


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    spans.clear()
    yield
    torch.set_num_threads(n)


def trainer(depth=False, exposure=False, sparse=False, antialiasing=False,
            mesh=None, eager=False):
    rng = np.random.default_rng(42)
    images = [rng.uniform(0, 1, (3, H, W)).astype(np.float32)
              for _ in range(4)]
    pts = np.concatenate([rng.uniform(-1, 1, (50, 2)),
                          rng.uniform(3, 5, (50, 1))], axis=1)
    cols = rng.uniform(0, 1, (50, 3))
    fovx = math.radians(60.0)
    cam = make_camera(np.eye(3), np.zeros(3), fovx,
                      focal2fov(W / (2 * math.tan(fovx / 2)), H), W, H,
                      device="cpu")
    views = []
    for i, img in enumerate(images):
        invd = (rng.uniform(0.2, 0.3, (H, W)).astype(np.float32)
                if depth else None)
        views.append(LoadedCamera(
            camera=cam, info=CameraInfo(
                uid=i, R=np.eye(3), T=np.zeros(3), fovx=1.0, fovy=0.8,
                image_path="", image_name=f"v{i}", width=W, height=H),
            image=img, alpha_mask=np.ones((1, H, W), np.float32),
            invdepth=invd,
            depth_mask=np.ones((H, W), np.float32) if depth else None,
            depth_reliable=depth and i != 2))
    opt = OptimizationConfig(**OPT, optimizer_type="sparse_adam"
                             if sparse else "default")
    tr = Trainer(views, (pts, cols, np.zeros_like(pts)), spatial_lr_scale=1.0,
                 model_cfg=ModelConfig(sh_degree=1, train_test_exp=exposure,
                                       data_device="cpu"),
                 opt=opt, pipe=PipelineConfig(antialiasing=antialiasing),
                 raster=RasterConfig(dup_capacity=4096, max_per_tile=512,
                                     chunk=32),
                 initial_capacity=256, seed=7, mesh=mesh)
    tr._eager_dispatch = eager
    return tr


def sequences():
    """The stamps of the CPU ring, split into units at each opener."""
    out = []
    for tag, _ in spans.ring("cpu").read().tolist():
        if tag >= spans.COUNTER_BASE:
            continue
        name = spans.STAGES[tag]
        if name in spans.OPENERS:
            out.append((name, [name]))
        elif out and out[-1][1][-1] != name:
            out[-1][1].append(name)
    return out


def expected(depth: bool, exposure: bool) -> list:
    seq = list(STEP)
    if depth:
        seq.insert(seq.index("loss") + 1, "depth")
    if exposure:
        seq.insert(seq.index("update") + 1, "exposure")
    return seq


def test_new_stages_keep_the_existing_ids():
    assert spans.STAGES[:15] == (
        "step", "preprocess", "binning", "raster", "loss", "loss_bwd",
        "raster_bwd", "preprocess_bwd", "update", "end", "frame",
        "exchange", "exchange_bwd", "densify", "reset_opacity")
    assert spans.STAGES[15:] == ("depth", "exposure")
    assert spans.COUNTERS == ("band_work", "adam_columns")


@pytest.mark.parametrize("mode", ["eager", "chain", "step"])
@pytest.mark.parametrize("depth,exposure", [
    (False, False), (True, False), (False, True), (True, True)],
    ids=["plain", "depth", "exposure", "both"])
def test_depth_and_exposure_stamp_only_under_their_switches(mode, depth,
                                                            exposure):
    tr = trainer(depth=depth, exposure=exposure, eager=mode == "eager")
    spans.clear()
    tr.train(iterations=4, block_scan=mode == "chain")
    seq = expected(depth, exposure)
    assert sequences() == [("step", seq)] * 4
    ms = spans.stage_ms(unit="step")
    assert len(ms) == 4 and all(set(u) == set(seq[:-1]) for u in ms)
    assert spans.counter("adam_columns", unit="step") == []


def test_mesh_step_stamps_the_recipe_stages():
    tr = trainer(depth=True, exposure=True, mesh=LocalGroup(2, "cpu"))
    spans.clear()
    tr.train(iterations=2, block_scan=True)
    for kind, seq in sequences():
        assert kind == "step"
        assert seq.index("depth") == seq.index("loss") + 1
        assert seq.index("exposure") == seq.index("update") + 1


@pytest.mark.parametrize("mode", ["eager", "chain", "step"])
@pytest.mark.parametrize("antialiasing", [False, True], ids=["", "aa"])
def test_adam_columns_is_the_visible_count(mode, antialiasing):
    tr = trainer(sparse=True, depth=True, exposure=True,
                 antialiasing=antialiasing, eager=mode == "eager")
    spans.clear()
    visible = []
    for it in range(1, 6):       # one step a call: its metrics each
        tr.train(iterations=it, block_scan=mode == "chain", log_every=1,
                 on_step=lambda i, mt, t: visible.append(int(mt.n_visible)))
    cols = spans.counter("adam_columns", unit="step")
    assert cols == [[v] for v in visible]
    assert len(cols) == 5 and all(0 < v[0] <= 256 for v in cols)


def test_partial_bucket_counts_only_its_steps():
    """A block of 3 steps in a bucket of 10 rows writes 3 entries, step
    mode's own."""
    counts = {}
    for block in (True, False):
        tr = trainer(sparse=True)
        spans.clear()
        tr.train(iterations=3, block_scan=block)
        assert tr._runner.bucket == OPT["densification_interval"]
        counts[block] = [c[0] for c in spans.counter("adam_columns",
                                                     unit="step")]
    assert len(counts[True]) == 3 and all(c > 0 for c in counts[True])
    assert counts[True] == counts[False]


def test_recipe_stamps_and_counter_change_no_value(monkeypatch):
    runs = []
    for stamped in (True, False):
        with monkeypatch.context() as m:
            if not stamped:
                m.setattr(spans, "stage", lambda name, device: None)
                m.setattr(spans, "count", lambda name, values: None)
                m.setattr(spans, "mark",
                          lambda name, *xs: xs[0] if len(xs) == 1 else xs)
            tr = trainer(depth=True, exposure=True, sparse=True,
                         antialiasing=True)
            losses = []
            tr.train(iterations=3, block_scan=True,
                     on_step=lambda i, mt, t: losses.append(float(mt.loss)))
            runs.append((losses, state_leaves(tr.state)))
    (la, sa), (lb, sb) = runs
    assert la == lb
    for x, y in zip(sa, sb):
        assert torch.equal(x, y)


@pytest.mark.parametrize("metric", ["adam_column_share.full",
                                    "exposure_depth_ms.full"])
def test_recipe_metrics_read_the_record(metric):
    """The benchmark's readers of the new stages and counter
    (``benchmark/metrics``): a number from a recorded recipe run, None
    from a plain one and from an empty record."""
    from benchmark.harness.common import reader
    read = reader(metric)
    t = {"kind": "train", "units": 3, "chips": 1, "capacity": 256,
         "busy_s": [1.0], "window_s": [1.0], "nccl_s": [0.0]}
    tr = trainer(depth=True, exposure=True, sparse=True, antialiasing=True)
    spans.clear()
    tr.train(iterations=3, block_scan=True)
    value = read(t)
    assert isinstance(value, float) and math.isfinite(value) and value > 0
    if metric == "adam_column_share.full":
        cols = spans.counter("adam_columns", unit="step")
        assert value == pytest.approx(100 * sum(c[0] for c in cols) / 3
                                      / 256)
    tr = trainer()
    spans.clear()
    tr.train(iterations=3, block_scan=True)
    assert read(t) is None
    spans.clear()
    assert read(t) is None
