"""The block dispatch of gs_tpu_torch.train.graph (the chain) against the
eager step, against step mode and against gs_tpu's make_train_step_chain
and block Trainer, on the CPU.

The scene is tests/test_block_scan.py's: four 64x48 views of uniform
noise, 50 points, SH degree 1, capacity 256; here each view has its own
small camera offset, an alpha mask and a depth map, so the device index
picks something that differs. The JAX package runs its binned backend,
the port its kernel path (the plain versions on CPU tensors).

On the CPU the chain runs its body eagerly, in place on its static
state, and is held bitwise to the eager per-step wrapper (the same
arithmetic, picked by device index instead of a Python index), step by
step and over the first b rows of a loaded bucket with the bucket's folded
metrics; the block Trainer is held bitwise to the Trainer in step mode.
Against the JAX package: losses within 1e-5 relative and parameters under
tests/test_torch_trainer.py::assert_params_close, as the step tests hold
them; the block Trainers within test_block_scan.py's atol 5e-4. The CUDA
case holds three graphed steps bitwise to three eager ones and skips
without a card."""
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from gs_tpu.config import (ModelConfig as JModelConfig,
                           OptimizationConfig as JOptimizationConfig,
                           PipelineConfig as JPipelineConfig,
                           RasterConfig as JRasterConfig)
from gs_tpu.core.camera import make_camera as jax_make_camera
from gs_tpu.data.camera_utils import LoadedCamera as JLoadedCamera
from gs_tpu.data.dataset_readers import CameraInfo as JCameraInfo
from gs_tpu.models.gaussian_model import create_from_pcd as jax_create
from gs_tpu.models.gaussian_model import init_state as jax_init_state
from gs_tpu.models.packed_state import unpack_state as jax_unpack_state
from gs_tpu.train.loop import Trainer as JTrainer

from gs_tpu_torch.config import (ModelConfig, OptimizationConfig,
                                 PipelineConfig, RasterConfig)
from gs_tpu_torch.convert import state_from_numpy
from gs_tpu_torch.core.camera import focal2fov, make_camera, stack_cameras
from gs_tpu_torch.data.camera_utils import LoadedCamera
from gs_tpu_torch.data.dataset_readers import CameraInfo
from gs_tpu_torch.models.gaussian_model import exposure_lr, group_lrs
from gs_tpu_torch.models.packed_state import pack_state
from gs_tpu_torch.train.graph import (FOLDED, TrainingData,
                                      launch_counters, make_train_step_chain,
                                      state_leaves)
from gs_tpu_torch.train.loop import Trainer, _fold_window
from gs_tpu_torch.train.step import make_train_step, schedule_table
from gs_tpu_torch.utils.schedules import expon_lr

from test_torch_trainer import OPT, assert_params_close

W, H, V = 64, 48, 4
CAPACITY = 256
FOVX = math.radians(60.0)
FOVY = focal2fov(W / (2 * math.tan(FOVX / 2)), H)
RASTER = dict(dup_capacity=4096, max_per_tile=128, chunk=32)
# the Trainer rule's learning rates are OPT's; a lower threshold densifies
BLOCK_OPT = dict(OPT, densify_grad_threshold=2e-4)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """At these shapes torch's thread pool gives nothing, and beside other
    test processes its threads oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_data(seed=0):
    rng = np.random.default_rng(seed)
    return dict(
        images=rng.uniform(0, 1, (V, 3, H, W)).astype(np.float32),
        alphas=(rng.uniform(size=(V, 1, H, W)) < 0.9).astype(np.float32),
        invdepths=rng.uniform(0.1, 0.4, (V, H, W)).astype(np.float32),
        depth_masks=(rng.uniform(size=(V, H, W)) < 0.8).astype(np.float32),
        depth_oks=np.array([1, 1, 0, 1], np.float32),
        pts=np.concatenate([rng.uniform(-1, 1, (50, 2)),
                            rng.uniform(3, 5, (50, 1))], 1),
        cols=rng.uniform(0, 1, (50, 3)),
        offsets=[np.array([0.04 * i, -0.02 * i, 0.0]) for i in range(V)])


DATA = make_data()


def port_cameras():
    return [make_camera(np.eye(3), t, FOVX, FOVY, W, H, device="cpu")
            for t in DATA["offsets"]]


def jax_cameras():
    return [jax_make_camera(np.eye(3), t, FOVX, FOVY, W, H)
            for t in DATA["offsets"]]


def state0_numpy():
    """The initial state, made by the JAX package, as numpy."""
    p, alive = jax_create(DATA["pts"], DATA["cols"], 1, capacity=CAPACITY)
    st = jax_init_state(p, alive, num_images=V)
    return {k: ({f: np.asarray(x) for f, x in v._asdict().items()}
                if k in ("params", "m", "v") else np.asarray(v))
            for k, v in st._asdict().items()}


STATE0 = state0_numpy()


def port_state(packed):
    st = state_from_numpy(STATE0, "cpu")
    return pack_state(st) if packed else st


def port_data(**which) -> TrainingData:
    t = {k: torch.tensor(DATA[k]) for k in ("images", "alphas", "invdepths",
                                            "depth_masks", "depth_oks")}
    return TrainingData(t["images"],
                        t["alphas"] if which.get("alpha") else None,
                        *((t["invdepths"], t["depth_masks"], t["depth_oks"])
                          if which.get("depth") else ()))


def port_step(packed=True, opt=None, model=None, pipe=None):
    return make_train_step(
        OptimizationConfig(**(opt or BLOCK_OPT)),
        ModelConfig(sh_degree=1, **(model or {})),
        PipelineConfig(**(pipe or {})), RasterConfig(**RASTER),
        stack_cameras(port_cameras()), spatial_lr_scale=1.0, max_sh_degree=1,
        packed=packed)


def bucket(step, cams, its, bgs=None):
    """The bucket inputs the Trainer loads: [B, 2], [B, 6] and the
    iterations."""
    n = len(cams)
    ints = torch.tensor(np.stack([cams, its], 1), dtype=torch.int64)
    floats = torch.zeros((n, 6))
    floats[:, :3] = torch.from_numpy(step.schedule(its))
    if bgs is not None:
        floats[:, 3:] = bgs
    return ints, floats, list(its)


def leaves_equal(a, b):
    for x, y in zip(state_leaves(a), state_leaves(b)):
        assert x.dtype == y.dtype and torch.equal(x, y)


# ------------------------------------------- the device-indexed core, CPU

OPTIONS = {
    "plain": {}, "alpha": dict(data=dict(alpha=True)),
    "depth": dict(data=dict(depth=True)),
    "exposure": dict(model=dict(train_test_exp=True)),
    "sparse_adam": dict(opt=dict(optimizer_type="sparse_adam")),
    "antialiasing": dict(pipe=dict(antialiasing=True)),
    "random_background": dict(opt=dict(random_background=True)),
}
OPTIONS["all"] = {k: dict(kv for o in OPTIONS.values()
                          for kv in o.get(k, {}).items())
                  for k in ("data", "model", "opt", "pipe")}


@pytest.mark.parametrize("packed,option",
                         [(True, o) for o in sorted(OPTIONS)]
                         + [(False, "all"), (False, "plain")])
def test_chain_equals_the_eager_step(packed, option):
    """Two steps across the SH ramp's step at 1000, camera picked by a
    device index inside the chain, by a Python index in the wrapper: the
    states and metrics are bitwise equal. Each option alone in the packed
    layout (the Trainer's), all of them and none in the tree layout."""
    o = OPTIONS[option]
    step = port_step(packed, opt=dict(BLOCK_OPT, iterations=3000,
                                      position_lr_max_steps=3000,
                                      **o.get("opt", {})),
                     model=o.get("model"), pipe=o.get("pipe"))
    data = port_data(**o.get("data", {}))
    cams, its = [2, 3], [999, 1000]
    random_bg = step.random_background
    bgs = (torch.rand((2, 3), generator=torch.Generator().manual_seed(1))
           if random_bg else [None] * 2)

    st = port_state(packed)
    eager = []
    for j, (c, i) in enumerate(zip(cams, its)):
        depth = ((data.invdepths[c], data.depth_masks[c], data.depth_oks[c])
                 if data.invdepths is not None else (None, None, 0.0))
        st, m = step(st, c, data.images[c],
                     data.alphas[c] if data.alphas is not None else None,
                     *depth, iteration=i, bg=bgs[j])
        eager.append(m)

    chain = make_train_step_chain(step, use_alpha=data.alphas is not None,
                                  use_depth=data.invdepths is not None,
                                  bucket=2)
    chain.load(*bucket(step, cams, its, bgs=bgs if random_bg else None))
    start = port_state(packed)
    gs = start
    for j in range(2):
        gs, m = chain(gs, data, j)
        for f in ("loss", "l1", "ssim", "depth_l1", "num_duplicates",
                  "max_tile_len", "overflow", "n_visible"):
            assert torch.equal(getattr(m, f), getattr(eager[j], f)), (j, f)
    leaves_equal(gs, st)
    # the chain wrote into its own copy, never into the state it was given
    leaves_equal(start, port_state(packed))
    assert float(eager[-1].loss) > 0


def test_schedule_table_is_expon_lr():
    opt = OptimizationConfig(iterations=30_000, exposure_lr_delay_steps=500,
                             exposure_lr_delay_mult=0.1,
                             depth_l1_weight_init=1.0,
                             depth_l1_weight_final=0.01)
    its = [0, 1, 250, 999, 1000, 7000, 29_999, 30_000, 40_000]
    table = schedule_table(opt, 3.5, its)
    assert table.dtype == np.float32 and table.shape == (len(its), 3)
    for row, i in zip(table, its):
        want = (group_lrs(opt, i, 3.5).xyz, exposure_lr(opt, i),
                expon_lr(i, 1.0, 0.01, max_steps=30_000))
        assert [float(x) for x in row] == list(want), i


RUN_CAMS = [2, 0, 3, 1, 1, 3, 0, 2, 3, 1]       # a bucket of 10 rows


@pytest.mark.parametrize("b", [1, 9, 10])
def test_chain_run_equals_eager_steps(b):
    """``ChainStep.run(b)`` on a loaded bucket of 10 rows: the first b
    rows, one step each, bitwise ``b`` eager steps; its metrics the last
    step's, with the worst overflow and the largest counts over the b
    steps (the eager window's fold, ``train/loop.py::_fold_window``)."""
    step = port_step(True)
    data = port_data(alpha=True, depth=True)
    its = list(range(1, 11))
    st, window = port_state(True), None
    for c, i in zip(RUN_CAMS[:b], its[:b]):
        st, m = step(st, c, data.images[c], data.alphas[c],
                     data.invdepths[c], data.depth_masks[c],
                     data.depth_oks[c], iteration=i)
        window = _fold_window(m, window)
    chain = make_train_step_chain(step, use_alpha=True, use_depth=True,
                                  bucket=10)
    chain.load(*bucket(step, RUN_CAMS, its))
    gs, got = chain.run(port_state(True), data, b)
    leaves_equal(gs, st)
    assert int(gs.step) == b
    for f in ("loss", "l1", "ssim", "depth_l1", "n_visible") + FOLDED[:3]:
        assert torch.equal(getattr(got, f), getattr(window, f)), f
    # copies: the next run leaves them as they are
    kept = [x.clone() for x in got if x is not None]
    chain.run(gs, data, 1)
    assert all(torch.equal(x, y)
               for x, y in zip([x for x in got if x is not None], kept))


# ------------------------------------------------- against the JAX package

def _views(cameras, info_cls, loaded_cls):
    return [loaded_cls(camera=c, info=info_cls(
        uid=i, R=np.eye(3), T=np.zeros(3), fovx=FOVX, fovy=FOVY,
        image_path="", image_name=f"v{i}", width=W, height=H),
        image=DATA["images"][i], alpha_mask=np.ones((1, H, W), np.float32),
        invdepth=None, depth_mask=None, depth_reliable=False)
        for i, c in enumerate(cameras)]


def jax_params(state):
    return {k: np.asarray(v)
            for k, v in jax_unpack_state(state).params._asdict().items()}


def port_params(state):
    return {k: v.detach().numpy() for k, v in state.params._asdict().items()}


CAMS, ITS = [2, 0, 3, 3], [1, 2, 3, 4]


@pytest.fixture(scope="module")
def jax_run():
    """gs_tpu's block dispatch on the packed state of the scene's Trainer:
    its chain (``make_train_step_chain``, the Trainer's own executable)
    for three steps from the Trainer's initial state; then the Trainer in
    block mode (chain) for 12 iterations, blocks 0-5, 5-10 (densify at 10)
    and 10-12, its cameras and split noise recorded for the port."""
    tr = JTrainer(_views(jax_cameras(), JCameraInfo, JLoadedCamera),
                  (DATA["pts"], DATA["cols"], np.zeros_like(DATA["pts"])),
                  spatial_lr_scale=1.0, model_cfg=JModelConfig(sh_degree=1),
                  opt=JOptimizationConfig(**BLOCK_OPT), pipe=JPipelineConfig(),
                  raster=JRasterConfig(backend="binned", **RASTER),
                  initial_capacity=CAPACITY, seed=7)
    tr._ensure_device_data()
    d = tr._device_data
    data = (d["images"], d["alphas"], d["invd"], d["dmask"], d["dok"])
    keys = jax.random.split(jax.random.key(0), 4)
    st, losses = tr.state, []
    for j in range(3):
        st, m = tr._scan_step(st, *data, jnp.int32(ITS[j]),
                              jnp.int32(CAMS[j]), keys[j])
        losses.append(float(m.loss))
    out = dict(chain_losses=losses, chain_params=jax_params(st))

    log = {"cams": [], "noise": []}
    pick, densify = tr._next_camera, tr._densify

    def next_camera():
        log["cams"].append(pick())
        return log["cams"][-1]

    def record_densify(state, key, use_size_threshold):
        log["noise"].append(np.asarray(
            jax.random.normal(key, (state.capacity, 3))))
        return densify(state, key, use_size_threshold=use_size_threshold)

    tr._next_camera, tr._densify = next_camera, record_densify
    tr.train(iterations=12, block_scan=True)
    return dict(out, **log, alive=np.asarray(tr.state.alive),
                params=jax_params(tr.state), ema=tr.ema_loss)


def test_block_dispatch_matches_jax(jax_run):
    step = port_step(True)
    data = port_data()
    runner = make_train_step_chain(step, use_alpha=False, use_depth=False,
                                   bucket=4)
    runner.load(*bucket(step, CAMS, ITS))
    st, losses = port_state(True), []
    for j in range(3):
        st, m = runner(st, data, j)
        losses.append(float(m.loss))
    np.testing.assert_allclose(losses, jax_run["chain_losses"], rtol=1e-5)
    assert_params_close(port_params(st), jax_run["chain_params"], steps=3)


# ------------------------------------------------------- the block Trainer

def port_trainer(packed=True, dup_capacity=4096):
    tr = Trainer(_views(port_cameras(), CameraInfo, LoadedCamera),
                 (DATA["pts"], DATA["cols"], np.zeros_like(DATA["pts"])),
                 spatial_lr_scale=1.0,
                 model_cfg=ModelConfig(sh_degree=1, data_device="cpu"),
                 opt=OptimizationConfig(**BLOCK_OPT), pipe=PipelineConfig(),
                 raster=RasterConfig(**dict(RASTER,
                                            dup_capacity=dup_capacity)),
                 initial_capacity=CAPACITY, seed=7, packed=packed)
    return tr


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "tree"])
def test_trainer_chain_equals_step_mode(packed):
    """10 iterations through an overflow replay (a 64-entry buffer) and a
    densify at 10, in block mode (the chain over buckets of 5 steps with
    room for 10, a sync after each) and in step mode (the chain's graph
    through ``ChainStep.step``, a sync every 5): bitwise equal."""
    runs = []
    for block in (True, False):
        tr = port_trainer(packed, dup_capacity=64)
        tr.sync_every = 5
        tr.train(iterations=10, block_scan=block)
        assert tr.raster.dup_capacity > 64 and tr.overflow_exhausted == 0
        runs.append(tr)
    chain, step = runs
    assert chain.iteration == step.iteration == 10
    leaves_equal(chain.state, step.state)
    assert chain.ema_loss == step.ema_loss
    assert int(chain.state.alive.sum()) > 50, "no densify"
    assert chain.captures == step.captures == []    # nothing captured on CPU


def test_block_trainer_matches_jax(jax_run):
    ref = jax_run
    assert len(ref["noise"]) == 1, "one densify, at iteration 10"
    tr = port_trainer()
    noise = list(ref["noise"])
    tr._densify_noise = lambda c: torch.tensor(noise.pop(0))
    cams = []
    pick = tr._next_camera
    tr._next_camera = lambda: cams.append(pick()) or cams[-1]
    tr.train(iterations=12, block_scan=True)
    assert not noise and cams == ref["cams"]
    np.testing.assert_array_equal(tr.state.alive.numpy(), ref["alive"])
    assert int(tr.state.alive.sum()) > 50, "no densify"
    assert math.isclose(tr.ema_loss, ref["ema"], rel_tol=1e-5)
    got = port_params(tr.state)
    for k, r in ref["params"].items():
        np.testing.assert_allclose(got[k], r, atol=5e-4, err_msg=k)


# ------------------------------------------------------------- on the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (a CUDA graph has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_graphed_steps_equal_eager_steps(cuda_device):
    """Three replays of the captured chain step against three eager steps
    from one state: bitwise, and the launch counters count the replays."""
    dev = cuda_device
    step = make_train_step(
        OptimizationConfig(**BLOCK_OPT), ModelConfig(sh_degree=1),
        PipelineConfig(), RasterConfig(**RASTER), stack_cameras(
            [make_camera(np.eye(3), t, FOVX, FOVY, W, H, device=dev)
             for t in DATA["offsets"]]), spatial_lr_scale=1.0,
        max_sh_degree=1, packed=True)
    data = TrainingData(torch.tensor(DATA["images"], device=dev),
                        torch.tensor(DATA["alphas"], device=dev))
    cams, its = [2, 0, 3], [1, 2, 3]
    st = pack_state(state_from_numpy(STATE0, dev))
    eager = []
    for c, i in zip(cams, its):
        st, m = step(st, c, data.images[c], data.alphas[c], iteration=i)
        eager.append(float(m.loss))
    chain = make_train_step_chain(step, use_alpha=True, use_depth=False,
                                  bucket=3)
    chain.load(*bucket(step, cams, its))
    gs = pack_state(state_from_numpy(STATE0, dev))
    chain.bind(gs, data)
    assert chain.graph is not None and len(chain.captures) == 1
    counters = launch_counters()
    before = [f.launches for f in counters]
    losses = []
    for j in range(3):
        gs, m = chain(gs, data, j)
        losses.append(float(m.loss))
    assert losses == eager
    leaves_equal(gs, st)
    per_step = [(f.launches - n) / 3 for f, n in zip(counters, before)]
    # K2, K1g, K3, K4, the preprocess pair, Adam and the SSIM pair once
    # per step; K1 not at all
    assert per_step == [1, 0, 1, 1, 1, 1, 1, 1, 1, 1]
