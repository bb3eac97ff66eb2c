"""The multi-GPU Trainer in block mode: ``Trainer(mesh=...)`` through
``train/graph.py``'s chain, on the CPU (and one case on the card).

Sizes are tests/test_torch_sharding.py's: tests/test_torch_trainer.py's
scene (four 64x48 views, 50 points, 256 slots, seed 7, a sync every 4 in
step mode), 12 iterations with one densify at 10; in block mode the blocks
are 1..5, 6..10 and 11..12 (a sync after each), the chain's bucket the
densification interval, 10.

* Against the JAX package: gs_tpu's mesh Trainer in block mode
  (``make_mesh(2)``, ``train(block_scan=True)``, its chain, packed and
  tree) and the port's ``Trainer(mesh=LocalGroup(k, "cpu"))`` in the same
  mode for k = 2 and 4, fed the JAX run's split
  noise, by tests/test_torch_sharding.py's rules: the same cameras, losses
  at the syncs within 1e-5 relative, equal alive masks,
  ``assert_params_close``.
* The band fold: views 1-3 see all 50 points, view 0 (moved 4 units
  forward, into the points) 18 of them, and ``visible_capacity`` 32 lies
  between.
  The first bucket's cameras are 3, 1, 2, 0, 0, so its first steps
  overflow and its last does not: only the bucket's largest shard count
  grows the capacity. The mesh chain and the mesh step mode end bitwise
  equal, with no replay exhausted.
* Two gloo processes: the train CLI with ``--multihost --block_scan``
  against the same CLI with ``group=LocalGroup(2)`` in this process,
  within tests/test_torch_multihost.py's 5e-5 x max.
* ``ProcessGroup.close`` releases the group's step graphs before it
  destroys the group.
* On the card (``cuda``, skipped here): a ``LocalGroup(2)`` mesh chain,
  captured, replays three steps bitwise equal to three eager mesh steps,
  and the launch counters count two launches per step of each kernel of
  the step (one per band).
"""
import math
import os
import sys

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
from gs_tpu_torch.core.camera import focal2fov, make_camera, stack_cameras
from gs_tpu_torch.data.camera_utils import LoadedCamera
from gs_tpu_torch.data.dataset_readers import CameraInfo
from gs_tpu_torch.models.gaussian_model import create_from_pcd, init_state
from gs_tpu_torch.models.packed_state import pack_state
from gs_tpu_torch.parallel.mesh import LocalGroup
from gs_tpu_torch.train.graph import (ChainStep, TrainingData,
                                      launch_counters, make_train_step_chain,
                                      state_leaves)
from gs_tpu_torch.train.loop import Trainer
from gs_tpu_torch.train.step import make_train_step

from test_torch_multihost import _run_two, _train_args
from test_torch_sharding import port_trainer
from test_torch_trainer import (ITERS, OPT, W, H, _params, _record, _views,
                                assert_params_close, make_data)
from utils import default_camera

FOVX = math.radians(60.0)
FOVY = focal2fov(W / (2 * math.tan(FOVX / 2)), H)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def leaves_equal(a, b):
    for x, y in zip(state_leaves(a), state_leaves(b)):
        assert x.dtype == y.dtype and torch.equal(x, y)


# ------------------------------------------------- against the JAX package

@pytest.fixture(scope="module", params=[True, False],
                ids=["chain-packed", "chain-tree"])
def jax_block_run(request):
    """gs_tpu's Trainer on make_mesh(2) in block mode (its chain), its
    cameras, the losses after each block and the split noise recorded."""
    packed = request.param
    images, pts, cols = make_data()
    tr = JTrainer(_views(images, default_camera(W, H), JCameraInfo,
                         JLoadedCamera),
                  (pts, cols, np.zeros_like(pts)), spatial_lr_scale=1.0,
                  model_cfg=JModelConfig(sh_degree=1),
                  opt=JOptimizationConfig(**OPT), pipe=JPipelineConfig(),
                  raster=JRasterConfig(backend="binned", dup_capacity=4096,
                                       max_per_tile=512, chunk=32),
                  initial_capacity=256, seed=7, mesh=make_mesh(2),
                  packed=packed)
    tr.sync_every = 4
    log = {"cams": [], "losses": [], "noise": [], "its": []}
    densify = tr._densify

    def record_densify(state, key, use_size_threshold):
        log["noise"].append(np.asarray(
            jax.random.normal(key, (state.capacity, 3))))
        return densify(state, key, use_size_threshold=use_size_threshold)

    tr._densify = record_densify
    record = _record(tr, log)
    tr.train(iterations=ITERS, log_every=1, block_scan=True,
             on_step=lambda i, m, t: (log["its"].append(i), record(i, m, t)))
    return dict(log, packed=packed,
                alive=np.asarray(tr.state.alive), params=_params(tr),
                ema=tr.ema_loss)


@pytest.mark.parametrize("k", [2, 4])
def test_mesh_block_trainer_matches_jax(jax_block_run, k):
    ref = jax_block_run
    assert ref["its"] == [5, 10, 12], "blocks 1..5, 6..10, 11..12"
    assert len(ref["noise"]) == 1, "one densify, at iteration 10"
    tr = port_trainer(mesh=LocalGroup(k, "cpu"), packed=ref["packed"])
    noise = list(ref["noise"])
    tr._densify_noise = lambda c: torch.tensor(noise.pop(0))
    log = {"cams": [], "losses": []}
    tr.train(iterations=ITERS, on_step=_record(tr, log), log_every=1,
             block_scan=True)
    assert isinstance(tr._runner, ChainStep) and tr.captures == []
    assert not noise and log["cams"] == ref["cams"]
    np.testing.assert_allclose(log["losses"], ref["losses"], rtol=1e-5)
    assert math.isclose(tr.ema_loss, ref["ema"], rel_tol=1e-5)
    alive = tr.state.alive.numpy()
    np.testing.assert_array_equal(alive, ref["alive"])
    assert alive.sum() > 50 and tr.num_alive() == alive.sum()
    assert_params_close(_params(tr), ref["params"], steps=ITERS)


# ---------------------------------------------------------- the band fold

VCAP = 32                    # between view 0's 18 visible and the others' 50
NEAR_Z = -4.0                # view 0 moved forward into the points


def fold_trainer():
    """LocalGroup(2) on the scene with view 0 moved forward; step mode or
    block mode (the chain) by the caller's ``train``."""
    images, pts, cols = make_data()
    cams = [make_camera(np.eye(3), np.array([0.0, 0.0, NEAR_Z if i == 0
                                             else 0.0]),
                        FOVX, FOVY, W, H, device="cpu") for i in range(4)]
    views = [v._replace(camera=c) for v, c in zip(
        _views(images, cams[0], CameraInfo, LoadedCamera), cams)]
    tr = Trainer(views, (pts, cols, np.zeros_like(pts)), spatial_lr_scale=1.0,
                 model_cfg=ModelConfig(sh_degree=1, data_device="cpu"),
                 opt=OptimizationConfig(**OPT), pipe=PipelineConfig(),
                 raster=RasterConfig(dup_capacity=4096, max_per_tile=512,
                                     chunk=32, visible_capacity=VCAP),
                 initial_capacity=256, seed=7, mesh=LocalGroup(2, "cpu"))
    tr.sync_every = 4
    return tr


def test_fold_scene_overflows_before_the_bucket_ends():
    """The scene of test_band_fold_through_a_replay: view 0 alone stays
    under the cap, and it takes the first bucket's last step."""
    tr = fold_trainer()
    seen = [int(tr.render_view(v.camera).band_visible.max())
            for v in tr.train_cams]
    assert seen[0] == 18 and seen[1:] == [50] * 3 and 18 < VCAP < 50
    picks = [tr._next_camera() for _ in range(5)]
    assert picks == [3, 1, 2, 0, 0]


def test_band_fold_through_a_replay():
    """The chain and step mode end bitwise equal through a
    visible_capacity overflow that falls before the bucket's last step,
    and a second one after the densify."""
    runs = {}
    for mode in ("step", "chain"):
        tr = fold_trainer()
        grows = []
        grow = tr._grow_raster
        tr._grow_raster = lambda changes, will_replay, _g=grows, _f=grow: (
            _g.append(dict(changes)), _f(changes, will_replay))
        losses = {}
        tr.train(iterations=ITERS, block_scan=mode != "step", log_every=1,
                 on_step=lambda i, m, t, _l=losses: _l.__setitem__(
                     i, float(m.loss)))
        tr.sync_metrics()
        assert tr.overflow_exhausted == 0, mode
        assert grows and all(set(g) == {"visible_capacity"} for g in grows)
        runs[mode] = (tr, losses, grows)
    step, chain = (runs[m][0] for m in ("step", "chain"))
    # step mode's entry to the chain
    assert isinstance(chain._runner, ChainStep)
    assert isinstance(step._runner, ChainStep)
    assert step.raster.visible_capacity == chain.raster.visible_capacity \
        > VCAP
    assert int(step.state.alive.sum()) > 50, "no densify"
    leaves_equal(chain.state, step.state)
    # the losses of the iterations where both modes read them
    got = runs["chain"][1]
    assert sorted(got) == [5, 10, 12]
    for i in (10, 12):
        assert got[i] == runs["step"][1][i], i


# ---------------------------------------------------- two gloo processes

def test_two_process_block_cli_matches_local_group(tmp_path):
    """The train CLI in block mode over two gloo processes against the
    same run with LocalGroup(2) in this process."""
    from test_data import make_colmap_dataset
    from gs_tpu_torch.apps import train as train_app
    from gs_tpu_torch.data.ply import load_gaussian_ply

    root = str(tmp_path / "dataset")
    make_colmap_dataset(root, np.random.default_rng(11), n_images=4,
                        width=64, height=48)
    model_mh = str(tmp_path / "model_mh")
    _run_two(lambda rank: [sys.executable, "-m", "gs_tpu_torch.apps.train",
                           *_train_args(root, model_mh), "--multihost",
                           "--block_scan"], {}, tmp_path, "block")
    model_lg = str(tmp_path / "model_lg")
    trainer = train_app.main(_train_args(root, model_lg) + ["--block_scan"],
                             group=LocalGroup(2, "cpu"))
    assert isinstance(trainer._runner, ChainStep), \
        "the CLI did not run blocks"
    assert trainer.num_alive() > 50, "no densify"

    rel = os.path.join("point_cloud", "iteration_12", "point_cloud.ply")
    a = load_gaussian_ply(os.path.join(model_mh, rel))
    b = load_gaussian_ply(os.path.join(model_lg, rel))
    assert sorted(a) == sorted(b)
    for key in a:
        va, vb = np.asarray(a[key]), np.asarray(b[key])
        assert va.shape == vb.shape, key
        if va.dtype.kind == "f":
            scale = max(1.0, float(np.max(np.abs(vb))))
            assert np.max(np.abs(va - vb)) <= 5e-5 * scale, key
        else:
            assert np.array_equal(va, vb), key


def test_close_releases_the_graphs_first():
    """ProcessGroup.close releases the step graphs that captured the
    group's collectives before it destroys the group (NCCL destroys a
    communicator only once those graphs are gone); a released runner has
    no graph."""
    import socket
    import types
    import torch.distributed as dist
    from gs_tpu_torch.parallel.mesh import ProcessGroup
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=1, rank=0)
    group = ProcessGroup("cpu")
    events = []

    class Graph:
        def reset(self):
            events.append(("reset", dist.is_initialized()))

    step = types.SimpleNamespace(core=None, mesh=group, device="cpu",
                                 random_background=False)
    runner = make_train_step_chain(step, use_alpha=False, use_depth=False)
    runner.graph = Graph()
    group.graphs.add(runner)
    group.close()
    assert events == [("reset", True)] and runner.graph is None
    assert not dist.is_initialized()


# ------------------------------------------------------------- on the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (a CUDA graph has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_graphed_mesh_steps_equal_eager_mesh_steps(cuda_device):
    dev = cuda_device
    images, pts, cols = make_data()
    cams = [make_camera(np.eye(3), np.array([0.0, 0.0, -0.3 * i]), FOVX,
                        FOVY, W, H, device=dev) for i in range(4)]
    group = LocalGroup(2, dev)
    step = make_train_step(
        OptimizationConfig(**OPT), ModelConfig(sh_degree=1),
        PipelineConfig(), RasterConfig(dup_capacity=4096, max_per_tile=512,
                                       chunk=32, visible_capacity=64),
        stack_cameras(cams), spatial_lr_scale=1.0, max_sh_degree=1,
        mesh=group, packed=True)
    data = TrainingData(torch.tensor(np.stack(images), device=dev))

    def state0():
        params, alive = create_from_pcd(pts, cols, 1, capacity=256,
                                        device=dev)
        return pack_state(init_state(params, alive, num_images=4))

    picks, its = [2, 0, 3], [1, 2, 3]
    st, eager = state0(), []
    for c, i in zip(picks, its):
        st, m = step(st, c, data.images[c], iteration=i)
        eager.append((float(m.loss), int(m.max_band_visible)))
    chain = make_train_step_chain(step, use_alpha=False, use_depth=False,
                                  bucket=3)
    ints = torch.tensor(np.stack([picks, its], 1), dtype=torch.int64)
    floats = torch.zeros((3, 6))
    floats[:, :3] = torch.from_numpy(step.schedule(its))
    chain.load(ints, floats, its)
    gs = state0()
    chain.bind(gs, data)
    assert chain.graph is not None and chain.captures[0]["capacity"] == 256
    counters = launch_counters()
    before = [f.launches for f in counters]
    got = []
    for j in range(3):
        gs, m = chain(gs, data, j)
        got.append((float(m.loss), int(m.max_band_visible)))
    assert got == eager
    leaves_equal(gs, st)
    per_step = [(f.launches - n) / 3 for f, n in zip(counters, before)]
    # K2, K1g, K3 and K4 once per band and step, the preprocess pair once
    # per shard, Adam once over the process's shards; K1 not at all
    assert per_step == [2, 0, 2, 2, 2, 2, 2, 1]
