"""Step mode through gs_tpu_torch.train.graph.ChainStep.step (the chain's
graph, its inputs given per call), the port of the JAX trainer's jitted
step dispatched once per iteration, on the CPU (and two cases on the
card).

The scene is tests/test_torch_trainer.py's: four 64x48 views of uniform
noise, 50 points, capacity 256, seed 7, a sync every 4. On the CPU the
step's body runs eagerly on the runner's static state, in place; the
Trainer's eager step (``_eager_dispatch``, the reference the card checks
use) runs the per-step wrapper of ``train/step.py``.

* The graphed step mode against the eager step mode, bitwise (every
  step's loss, the final state, the EMA): 12 iterations through an
  overflow replay (a 64-entry buffer overflows at the first sync), an
  opacity reset at 5 (a white background's) and a densify at 10, packed
  and tree, with and without a random background (the step's draw and the
  densify's noise share one generator).
* Each step's returned metrics are copies: they keep their values after
  the next step, and none is the runner's output.
* Against the JAX package: gs_tpu's Trainer in step mode (packed and
  tree) by tests/test_torch_trainer.py's rules (the same cameras, losses
  within 1e-5 relative, equal alive masks, ``assert_params_close``), and
  gs_tpu's mesh Trainer (``make_mesh(2)``) against the port's
  ``Trainer(mesh=LocalGroup(2))`` by tests/test_torch_mesh_block.py's.
* On the card (``cuda``, skipped here): the graphed step mode bitwise the
  eager step mode through the same schedule, one capture per step built
  and K2, K1g, K3, K4 and the preprocess pair once per replay; the metrics of a step unchanged
  after the next replay.
"""
import math

import numpy as np
import pytest
import torch

import jax
from gs_tpu.config import (ModelConfig as JModelConfig,
                           OptimizationConfig as JOptimizationConfig,
                           PipelineConfig as JPipelineConfig,
                           RasterConfig as JRasterConfig)
from gs_tpu.data.camera_utils import LoadedCamera as JLoadedCamera
from gs_tpu.data.dataset_readers import CameraInfo as JCameraInfo
from gs_tpu.parallel.mesh import make_mesh
from gs_tpu.train.loop import Trainer as JTrainer

from gs_tpu_torch.config import (ModelConfig, OptimizationConfig,
                                 PipelineConfig, RasterConfig)
from gs_tpu_torch.core.camera import focal2fov, make_camera
from gs_tpu_torch.data.camera_utils import LoadedCamera
from gs_tpu_torch.data.dataset_readers import CameraInfo
from gs_tpu_torch.parallel.mesh import LocalGroup
from gs_tpu_torch.train.graph import ChainStep, launch_counters, state_leaves
from gs_tpu_torch.train.loop import Trainer
from gs_tpu_torch.train.step import StepMetrics

from test_torch_trainer import (ITERS, OPT, H, W, _params, _record, _views,
                                assert_params_close, make_data)
from utils import default_camera

# on a white background an opacity reset at densify_from_iter (5), and a
# densify at 10, inside the 12 iterations
SCHEDULE = dict(densify_grad_threshold=2e-4)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """At these shapes torch's thread pool gives nothing, and beside other
    test processes its threads oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def trainer(device="cpu", eager=False, dup_capacity=4096, packed=None,
            mesh=None, white_background=False, **opt):
    """tests/test_torch_trainer.py's Trainer on ``device``; ``eager``: the
    eager step mode."""
    images, pts, cols = make_data()
    fovx = math.radians(60.0)
    cam = make_camera(np.eye(3), np.zeros(3), fovx,
                      focal2fov(W / (2 * math.tan(fovx / 2)), H), W, H,
                      device=device)
    tr = Trainer(_views(images, cam, CameraInfo, LoadedCamera),
                 (pts, cols, np.zeros_like(pts)), spatial_lr_scale=1.0,
                 model_cfg=ModelConfig(sh_degree=1,
                                       white_background=white_background,
                                       data_device=str(device)),
                 opt=OptimizationConfig(**dict(OPT, **opt)),
                 pipe=PipelineConfig(),
                 raster=RasterConfig(dup_capacity=dup_capacity,
                                     max_per_tile=512, chunk=32),
                 initial_capacity=256, seed=7, packed=packed, mesh=mesh)
    tr.sync_every = 4
    tr._eager_dispatch = eager
    return tr


def run(tr, iterations=ITERS):
    """Train in step mode; each step's loss, read when it is handed out."""
    losses = []
    tr.train(iterations=iterations, log_every=1,
             on_step=lambda i, m, t: losses.append(float(m.loss)))
    return losses


def assert_states_equal(a, b):
    for x, y in zip(state_leaves(a), state_leaves(b)):
        assert x.dtype == y.dtype and torch.equal(x, y)


@pytest.mark.parametrize("random_background", [False, True],
                         ids=["static-bg", "random-bg"])
@pytest.mark.parametrize("packed", [True, False], ids=["packed", "tree"])
def test_step_graph_equals_the_eager_step(packed, random_background):
    runs = {}
    for eager in (True, False):
        tr = trainer(eager=eager, dup_capacity=64, packed=packed,
                     white_background=True,
                     random_background=random_background, **SCHEDULE)
        runs[eager] = (tr, run(tr))
    (eager, el), (graph, gl) = runs[True], runs[False]
    assert isinstance(graph._runner, ChainStep) and graph.captures == []
    assert eager._runner is None            # the eager step builds none
    for tr in (eager, graph):
        assert tr.raster.dup_capacity > 64 and tr.overflow_exhausted == 0
        assert int(tr.state.alive.sum()) > 50, "no densify"
    assert gl == el and len(gl) == ITERS
    assert graph.ema_loss == eager.ema_loss
    assert_states_equal(graph.state, eager.state)


def test_step_metrics_are_copies():
    """What step() hands out keeps its values after the next step, and is
    none of the runner's output tensors (which the next replay
    overwrites)."""
    tr = trainer()
    tr.sync_every = 1000
    kept = []
    for _ in range(3):
        m = tr.step()
        kept.append((m, [x.clone() for x in m if x is not None]))
    out = tr._runner.out
    for m, values in kept:
        assert all(x is not y for x, y in zip(m, out) if x is not None)
        assert all(torch.equal(x, v) for x, v in
                   zip([x for x in m if x is not None], values))
    assert len({float(m.loss) for m, _ in kept}) == 3


# ------------------------------------------------- against the JAX package

def _jax_trainer(packed, mesh=None):
    images, pts, cols = make_data()
    tr = JTrainer(_views(images, default_camera(W, H), JCameraInfo,
                         JLoadedCamera),
                  (pts, cols, np.zeros_like(pts)), spatial_lr_scale=1.0,
                  model_cfg=JModelConfig(sh_degree=1),
                  opt=JOptimizationConfig(**OPT), pipe=JPipelineConfig(),
                  raster=JRasterConfig(backend="binned", dup_capacity=4096,
                                       max_per_tile=512, chunk=32),
                  initial_capacity=256, seed=7, mesh=mesh, packed=packed)
    tr.sync_every = 4
    log = {"cams": [], "losses": [], "noise": []}
    densify = tr._densify

    def record_densify(state, key, use_size_threshold):
        log["noise"].append(np.asarray(
            jax.random.normal(key, (state.capacity, 3))))
        return densify(state, key, use_size_threshold=use_size_threshold)

    tr._densify = record_densify
    tr.train(iterations=ITERS, on_step=_record(tr, log), log_every=1)
    return dict(log, alive=np.asarray(tr.state.alive), params=_params(tr),
                ema=tr.ema_loss)


@pytest.fixture(scope="module", params=[True, False], ids=["packed", "tree"])
def jax_step_run(request):
    """gs_tpu's Trainer in step mode (its jitted step once an iteration),
    its cameras, losses and split noise recorded."""
    return dict(_jax_trainer(request.param), packed=request.param)


def _port_against(ref, mesh=None):
    """The port's graphed and eager step mode, fed the JAX run's noise:
    each held to the JAX run, and the two bitwise equal."""
    assert len(ref["noise"]) == 1, "one densify, at iteration 10"
    runs = []
    for eager in (False, True):
        tr = trainer(eager=eager, packed=ref["packed"], mesh=mesh)
        noise = list(ref["noise"])
        tr._densify_noise = lambda c, _n=noise: torch.tensor(_n.pop(0))
        log = {"cams": [], "losses": []}
        tr.train(iterations=ITERS, on_step=_record(tr, log), log_every=1)
        assert not noise and log["cams"] == ref["cams"]
        np.testing.assert_allclose(log["losses"], ref["losses"], rtol=1e-5)
        assert math.isclose(tr.ema_loss, ref["ema"], rel_tol=1e-5)
        alive = tr.state.alive.numpy()
        np.testing.assert_array_equal(alive, ref["alive"])
        assert alive.sum() > 50 and tr.num_alive() == alive.sum()
        assert_params_close(_params(tr), ref["params"], steps=ITERS)
        runs.append((tr, log["losses"]))
    (graph, gl), (eager, el) = runs
    assert isinstance(graph._runner, ChainStep) and gl == el
    assert_states_equal(graph.state, eager.state)


def test_step_graph_trainer_matches_jax(jax_step_run):
    _port_against(jax_step_run)


@pytest.fixture(scope="module")
def jax_mesh_step_run():
    """gs_tpu's mesh Trainer (make_mesh(2), packed) in step mode."""
    return dict(_jax_trainer(True, mesh=make_mesh(2)), packed=True)


def test_mesh_step_graph_trainer_matches_jax(jax_mesh_step_run):
    _port_against(jax_mesh_step_run, mesh=LocalGroup(2, "cpu"))


# ------------------------------------------------------------- on the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (a CUDA graph has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_graphed_step_mode_equals_eager_step_mode(cuda_device):
    """Through an overflow replay, an opacity reset and a densify, with a
    random background: bitwise, and each replay launches K2, K1g, K3, K4,
    the preprocess pair and Adam once."""
    runs = {}
    for eager in (True, False):
        tr = trainer(cuda_device, eager=eager, dup_capacity=64,
                     white_background=True, random_background=True,
                     **SCHEDULE)
        runs[eager] = (tr, run(tr))
    (eager, el), (graph, gl) = runs[True], runs[False]
    assert gl == el and graph.ema_loss == eager.ema_loss
    assert_states_equal(graph.state, eager.state)
    assert len(graph.captures) >= 2 and not eager.captures
    counters = launch_counters()
    before = [f.launches for f in counters]
    for _ in range(3):
        graph._dispatch_step()
    torch.cuda.synchronize()
    assert [(f.launches - n) / 3 for f, n in zip(counters, before)] \
        == [1, 0, 1, 1, 1, 1, 1, 1, 1, 1]


@pytest.mark.cuda
def test_metrics_survive_the_next_replay(cuda_device):
    tr = trainer(cuda_device)
    tr.sync_every = 1000
    first = tr.step()
    kept = StepMetrics(*[x.clone() if x is not None else None
                         for x in first])
    for _ in range(2):
        tr.step()
    torch.cuda.synchronize()
    assert tr._runner.graph is not None
    for x, y in zip(first, kept):
        assert (x is None and y is None) or torch.equal(x, y)
    assert float(tr._runner.out.loss) != float(first.loss)
