"""Adam's pass over the packed block (``csrc/adam.cu``, the wrapper
``ops/adam.py::adam_packed``) against its twin,
``models/packed_state.py::adam_update_packed_plain``. This file imports no JAX: the twin's JAX
parity is ``tests/test_torch_packed.py``'s.

On the CPU:

* ``adam_update_packed`` runs the twin and launches nothing, and the
  kernel's wrapper refuses a block that is not on a CUDA device;
* the twin equals the tree layout's ``adam_update`` bit for bit, dense and
  column-masked, at Adam's first update, an early one and a late one, in
  place (into the state's own tensors) and not;
* a ``Trainer`` constructed from a packed start state that serves views
  through ``render_view`` and ``viewer/server.py::frame_bytes`` launches no
  Adam kernel and asks for no Adam library: the view's path runs nothing
  of the update.

On the card (``cuda``, skipped here), for each of those paths, on four
layouts: a column slice of odd width of a wider block (the vector loop and
its tail), a slice at an odd column offset and a whole block 342 columns
wide, a rank's share when three split 1,026 slots (the loop over single
columns alone), and a whole block 1,024 columns wide:

* the kernel's outputs equal the twin's bit for bit, the columns beside the
  slice untouched, and equal from run to run;
* a captured step replayed twice counts two launches and leaves the twin's
  state after two steps;
* the view's path, in a fresh process on the card, neither launches the
  kernel nor loads its library.
"""
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from gs_tpu_torch.config import (ModelConfig, OptimizationConfig,
                                 PipelineConfig, RasterConfig)
from gs_tpu_torch.core import packed as pk
from gs_tpu_torch.core.camera import make_camera
from gs_tpu_torch.models.gaussian_model import (adam_update, create_from_pcd,
                                                group_lrs, init_state)
from gs_tpu_torch.models.packed_state import (PackedState,
                                              adam_update_packed,
                                              adam_update_packed_plain,
                                              group_lr_rows, pack_state,
                                              unpack_state)
from gs_tpu_torch.ops import adam as adam_ops
from gs_tpu_torch.ops.adam import adam_packed

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SH = 3
N = 333                  # an odd width: the vector loop leaves a tail of 1
PAD = (8, 7)             # the slice's columns before and after, in the block
LR_SCALE = 1.5
MASKS = (False, True)
# Adam's count before the update: the first update's bias corrections, an
# early step's and a late one's
STEPS = (0, 7, 29_999)
INPLACE = (False, True)
CASES = [(m, t, i) for m in MASKS for t in STEPS for i in INPLACE]


def _ids(case):
    mask, step, inplace = case
    return (f"{'masked' if mask else 'dense'}-step_{step}-"
            f"{'inplace' if inplace else 'new'}")


def _inputs(device, n=N, seed=0, step=7):
    """(state, grad, lr [R, 1], visible mask [n]) of a degree-3 block."""
    rng = np.random.default_rng(seed)
    rows = pk.layout(SH).rows

    def t(x, dtype=torch.float32):
        return torch.tensor(np.asarray(x), dtype=dtype, device=device)

    grad = rng.normal(0, 1e-3, (rows, n)).astype(np.float32)
    grad[:, rng.random(n) < 0.1] = 0.0           # columns no view reached
    v = (rng.normal(0, 1e-3, (rows, n)) ** 2).astype(np.float32)
    v[:, :3] = 0.0                               # a fresh slot: v = g = 0
    grad[:, :2] = 0.0
    state = PackedState(
        packed=t(rng.normal(0, 1, (rows, n))), alive=t(rng.random(n) < 0.8,
                                                       torch.bool),
        m=t(rng.normal(0, 1e-3, (rows, n))), v=t(v),
        step=t(step, torch.int32), grad_accum=t(np.zeros(n)),
        denom=t(np.zeros(n)), max_radii2D=t(np.zeros(n), torch.int32),
        exposure=t(np.zeros((1, 3, 4))), exp_m=t(np.zeros((1, 3, 4))),
        exp_v=t(np.zeros((1, 3, 4))), exp_step=t(0, torch.int32))
    lr = group_lr_rows(pk.layout(SH), OptimizationConfig(), step + 1,
                       LR_SCALE, device=device)
    return state, t(grad), lr, t(rng.random(n) < 0.55, torch.bool)


def _args(case, mask):
    use_mask, _, inplace = case
    return dict(visible_mask=mask if use_mask else None, inplace=inplace)


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _same_bits(a, b) -> bool:
    return a.shape == b.shape and torch.equal(_bits(a), _bits(b))


def _clone(state: PackedState) -> PackedState:
    return PackedState(*[x.clone() for x in state])


# ----------------------------------------------------------------- CPU

def test_cpu_runs_the_twin_and_launches_nothing():
    state, grad, lr, mask = _inputs("cpu")
    before = adam_packed.launches
    got = adam_update_packed(state, grad, lr, mask)
    want = adam_update_packed_plain(state, grad, lr, mask)
    assert adam_packed.launches == before
    for x, y in zip(got, want):
        assert _same_bits(x, y)
    assert not torch.equal(got.packed, state.packed)
    with pytest.raises(ValueError, match="runs on cuda"):
        adam_packed(state.packed, state.m, state.v, grad, lr,
                    torch.ones(()), torch.ones(()))


@pytest.mark.parametrize("case", CASES, ids=[_ids(c) for c in CASES])
def test_twin_is_the_tree_layouts_adam_bitwise(case):
    """The packed twin against ``gaussian_model.adam_update`` on the same
    state, gradient and rates, leaf by leaf; in place, into the state's
    own tensors."""
    step = case[1]
    state, grad, lr, mask = _inputs("cpu", step=step)
    kw = _args(case, mask)
    tree0 = unpack_state(_clone(state))
    tree = adam_update(tree0, pk.unpack_params(grad, SH),
                       group_lrs(OptimizationConfig(), step + 1, LR_SCALE),
                       **kw)
    before = _clone(state)
    got = adam_update_packed(state, grad, lr, **kw)
    un = unpack_state(got)
    for name in ("params", "m", "v"):
        for x, y in zip(getattr(un, name), getattr(tree, name)):
            assert _same_bits(x, y), name
    assert int(got.step) == int(tree.step) == step + 1
    assert not _same_bits(got.packed, before.packed)
    if case[2]:
        assert all(getattr(got, k) is getattr(state, k)
                   for k in ("packed", "m", "v", "step"))
    else:
        assert all(_same_bits(x, y) for x, y in zip(state, before))


def _tiny_trainer(device):
    """A Trainer of 200 Gaussians in 1,024 slots at SH degree 1, built
    from a packed start state, as the view cell builds its own."""
    from gs_tpu_torch.data.camera_utils import LoadedCamera
    from gs_tpu_torch.train.loop import Trainer
    rng = np.random.default_rng(1)
    pts = np.concatenate([rng.uniform(-1, 1, (200, 2)),
                          rng.uniform(3, 5, (200, 1))], 1)
    params, alive = create_from_pcd(pts, rng.uniform(0, 1, (200, 3)), 1,
                                    capacity=1024, device=device)
    state = pack_state(init_state(params, alive, num_images=1))
    w, h = 64, 48
    cam = _view_camera(device, 0)
    placeholder = LoadedCamera(cam, None, np.zeros((3, h, w), np.float32),
                               np.ones((1, h, w), np.float32), None, None,
                               False)
    return Trainer([placeholder], None, 1.0,
                   ModelConfig(sh_degree=1, data_device=str(device)),
                   OptimizationConfig(), PipelineConfig(),
                   RasterConfig(dup_capacity=8192, max_per_tile=512),
                   start_state=state, start_iteration=1000, seed=0)


def _view_camera(device, k: int):
    return make_camera(np.eye(3), np.array([0.05 * k, 0.0, 0.0]),
                       math.radians(60.0), math.radians(47.0), 64, 48,
                       device=device)


def serve_views(device) -> dict:
    """Construct the tiny Trainer and serve three views through
    ``render_view`` and ``frame_bytes``: the Adam launches, the kernel
    sources asked of ``ops/_cuda.py::function`` and the libraries loaded
    meanwhile, and the bytes of each frame."""
    from gs_tpu_torch.ops import _cuda
    from gs_tpu_torch.viewer.server import frame_bytes
    asked, real = [], _cuda.function
    loaded = set(_cuda._libs)

    def spy(source, name, argtypes):
        asked.append(source)
        return real(source, name, argtypes)

    _cuda.function = spy
    try:
        before = adam_packed.launches
        tr = _tiny_trainer(device)
        sizes = [len(frame_bytes(tr.render_view(_view_camera(device, k))
                                 .image)) for k in range(3)]
        launches = adam_packed.launches - before
    finally:
        _cuda.function = real
    return {"launches": launches, "asked": sorted(set(asked)),
            "loaded": sorted(set(_cuda._libs) - loaded), "sizes": sizes}


def _assert_view_path_runs_no_adam(got: dict):
    assert got["sizes"] == [64 * 48 * 3] * 3
    assert got["launches"] == 0
    assert adam_ops.SOURCE not in got["asked"]
    assert adam_ops.SOURCE not in got["loaded"]


def test_view_path_runs_no_adam_on_cpu():
    _assert_view_path_runs_no_adam(serve_views("cpu"))


# ---------------------------------------------------------------- card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (the Adam kernel has no "
                    "CPU mode)")
    return torch.device("cuda")


def _wide(x: torch.Tensor, lo: int) -> torch.Tensor:
    """``x`` [R, n] as columns lo..lo+n of a block filled with 7.0, whose
    rows hold lo + n + PAD[1] columns."""
    wide = torch.full((x.shape[0], lo + x.shape[1] + PAD[1]), 7.0,
                      device=x.device)
    wide[:, lo:lo + x.shape[1]] = x
    return wide[:, lo:lo + x.shape[1]]


LAYOUTS = {   # name: (width, the column offset of the slice or None)
    "slice": (N, PAD[0]),    # rows on 16 bytes: in place the vector loop
                             # and its tail (new outputs' odd rows: scalar)
    "odd": (N, 3),           # an odd offset: single columns alone
    "shard": (342, None),    # a rank's 342 of 1,026 slots over three: rows
                             # 8 bytes off 16, single columns alone
    "whole": (1024, None),   # contiguous: the vector loop, no tail
}


@pytest.mark.cuda
@pytest.mark.parametrize("layout", tuple(LAYOUTS))
@pytest.mark.parametrize("case", CASES, ids=[_ids(c) for c in CASES])
def test_kernel_equals_its_twin_bitwise(case, layout, cuda_device):
    dev = cuda_device
    n, lo = LAYOUTS[layout]
    state, grad, lr, mask = _inputs(dev, n, step=case[1])
    kw = _args(case, mask)
    want = adam_update_packed_plain(_clone(state), grad, lr, **kw)
    runs = []
    for _ in range(2):
        placed, g = _clone(state), grad
        if lo is not None:
            placed = placed._replace(**{k: _wide(getattr(placed, k), lo)
                                        for k in ("packed", "m", "v")})
            g = _wide(grad, lo)
        before = adam_packed.launches
        got = adam_update_packed(placed, g, lr, **kw)
        torch.cuda.synchronize()
        assert adam_packed.launches == before + 1
        for name in ("packed", "m", "v", "step"):
            assert _same_bits(getattr(got, name), getattr(want, name)), name
        if case[2]:
            assert all(getattr(got, k) is getattr(placed, k)
                       for k in ("packed", "m", "v", "step"))
        if lo is not None:           # the columns beside the slice
            for name in ("packed", "m", "v"):
                base = getattr(placed, name)._base
                assert bool((base[:, :lo] == 7.0).all())
                assert bool((base[:, lo + n:] == 7.0).all())
        runs.append(got)
    for x, y in zip(runs[0], runs[1]):
        assert _same_bits(x, y)


@pytest.mark.cuda
def test_captured_step_counts_its_replays(cuda_device):
    from gs_tpu_torch.utils.cuda_graphs import capture, replay
    dev = cuda_device
    state, grad, lr, mask = _inputs(dev, n=4096)
    static = _clone(state)

    def warm_up():
        adam_update_packed(_clone(state), grad, lr, mask, inplace=True)

    def body():
        adam_update_packed(static, grad, lr, mask, inplace=True)

    cap = capture(dev, warm_up, body, "adam")
    assert cap.counts[adam_packed] == 1
    for x, y in zip(static, state):
        x.copy_(y)
    before = adam_packed.launches
    replay(cap.graph, cap.counts)
    replay(cap.graph, cap.counts)
    torch.cuda.synchronize()
    assert adam_packed.launches == before + 2
    want = state
    for _ in range(2):
        want = adam_update_packed_plain(want, grad, lr, mask)
    for x, y in zip(static, want):
        assert _same_bits(x, y)


@pytest.mark.cuda
def test_view_path_runs_no_adam_on_the_card(cuda_device):
    """In a fresh process, where no Adam library is loaded yet."""
    code = ("import json, sys\n"
            f"sys.path[:0] = [{ROOT!r}, {os.path.join(ROOT, 'tests')!r}]\n"
            "from test_torch_adam_kernel import serve_views\n"
            "print(json.dumps(serve_views('cuda')))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr
    _assert_view_path_runs_no_adam(json.loads(res.stdout.splitlines()[-1]))
