"""The view as a graph: gs_tpu_torch.render.ViewGraph, through which
``Trainer.render_view``, ``Trainer.evaluate`` and the render CLI render on
one device (on CUDA one captured graph replayed per view; on the CPU the
same body, eagerly), against gs_tpu's jitted ``_eval_render`` and against
the eager view.

The scene is tests/test_torch_trainer.py's (four 64x48 views, 50 points,
256 slots, SH degree 1), its state made by the JAX package with random
SH coefficients of degree 1 so that the SH ramp shows, on both sides.

* ``Trainer.render_view`` (packed and tree) equals gs_tpu's
  ``_eval_render`` image within tests/test_golden.py's 2e-5 absolute, at a
  base view and across a change of pose, of ``scaling_modifier`` and of
  the SH degree; each change changes the image, and none makes a new key
  (the inputs are the graph's static inputs, not part of its capture).
* The view through the graph equals the eager view (``_eager_dispatch``)
  bitwise for those changes, a change of resolution (a new key), a new
  state (every graph released) and a view that overflows its buffers (a
  grown key).
* ``Trainer.evaluate`` equals gs_tpu's ``evaluate`` (L1 within 2e-5,
  PSNR within 1e-3 dB).
* The render CLI's PNGs, through the graph, are byte for byte those of an
  eager ``render_grown`` of the same views, one of which overflows.
* A ViewGraph keeps at most ``max_views`` keys, releasing the least
  recently used; a released key renders the same view when asked again.
* On the card (``cuda``, skipped here): the graphed view bitwise
  ``render_grown`` for each changed input, with the captures each change
  should cause and K2 and K1 once per replay; the memory the card holds
  stays flat while more resolutions than ``max_views`` come and go.
"""
import dataclasses
import math
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from gs_tpu.config import (ModelConfig as JModelConfig,
                           OptimizationConfig as JOptimizationConfig,
                           PipelineConfig as JPipelineConfig,
                           RasterConfig as JRasterConfig)
from gs_tpu.core.camera import make_camera as jax_make_camera
from gs_tpu.data.camera_utils import LoadedCamera as JLoadedCamera
from gs_tpu.data.dataset_readers import CameraInfo as JCameraInfo
from gs_tpu.train.loop import Trainer as JTrainer

from gs_tpu_torch.apps import render as render_app
from gs_tpu_torch.apps import train as train_app
from gs_tpu_torch.apps.args import get_combined_args, make_parser
from gs_tpu_torch.config import (ModelConfig, OptimizationConfig,
                                 PipelineConfig, RasterConfig)
from gs_tpu_torch.convert import state_from_numpy
from gs_tpu_torch.core.camera import focal2fov, make_camera
from gs_tpu_torch.data.camera_utils import LoadedCamera
from gs_tpu_torch.data.dataset_readers import CameraInfo
from gs_tpu_torch.data.scene import Scene
from gs_tpu_torch.models.packed_state import pack_state
from gs_tpu_torch.render import MAX_VIEWS, ViewGraph, render, render_grown
from gs_tpu_torch.train.graph import clone_state, launch_counters
from gs_tpu_torch.train.loop import Trainer
from gs_tpu_torch.train.step import mask_sh_rest

from test_data import make_colmap_dataset
from test_torch_trainer import OPT, H, W, _views, make_data

FOVX = math.radians(60.0)
FOVY = focal2fov(W / (2 * math.tan(FOVX / 2)), H)
ANG = math.radians(8.0)
POSES = {   # (R, t): the base pose and a moved one
    "base": (np.eye(3), np.zeros(3)),
    "moved": (np.array([[math.cos(ANG), 0, math.sin(ANG)], [0, 1, 0],
                        [-math.sin(ANG), 0, math.cos(ANG)]]),
              np.array([0.3, -0.1, 0.2])),
}
# (pose, scaling_modifier, iteration: the SH degree is iteration // 1000)
VIEWS = {"base": ("base", 1.0, 1000), "pose": ("moved", 1.0, 1000),
         "scaling_modifier": ("base", 0.7, 1000),
         "sh_degree": ("base", 1.0, 0)}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cameras(device):
    return {k: make_camera(R, t, FOVX, FOVY, W, H, device=device)
            for k, (R, t) in POSES.items()}


@pytest.fixture(scope="module")
def jax_side():
    """gs_tpu's Trainer (tree layout, binned backend) on the scene, its
    SH coefficients of degree 1 drawn from a seed; its state as numpy and
    its ``_eval_render`` image of every view of VIEWS."""
    images, pts, cols = make_data()
    tr = JTrainer(_views(images, jax_make_camera(np.eye(3), np.zeros(3),
                                                 FOVX, FOVY, W, H),
                         JCameraInfo, JLoadedCamera),
                  (pts, cols, np.zeros_like(pts)), spatial_lr_scale=1.0,
                  model_cfg=JModelConfig(sh_degree=1),
                  opt=JOptimizationConfig(**OPT), pipe=JPipelineConfig(),
                  raster=JRasterConfig(backend="binned", dup_capacity=4096,
                                       max_per_tile=512, chunk=32),
                  initial_capacity=256, seed=7, packed=False)
    rest = np.random.default_rng(5).normal(
        0, 0.3, tr.state.params.sh_rest.shape).astype(np.float32)
    tr.state = tr.state._replace(params=tr.state.params._replace(
        sh_rest=jnp.asarray(rest)))
    state = {k: ({f: np.asarray(x) for f, x in v._asdict().items()}
                 if k in ("params", "m", "v") else np.asarray(v))
             for k, v in tr.state._asdict().items()}
    images = {}
    for name, (pose, sm, it) in VIEWS.items():
        R, t = POSES[pose]
        fn = tr._eval_render(min(it // 1000, 1), False)
        images[name] = np.asarray(fn(
            tr.state.params, tr.state.alive,
            jax_make_camera(R, t, FOVX, FOVY, W, H), sm))
    tr.iteration = 1000
    report = tr.evaluate(tr.train_cams)
    return dict(state=state, images=images, report=report)


def port_trainer(jax_side, packed=True, dup_capacity=4096):
    images, pts, cols = make_data()
    tr = Trainer(_views(images, cameras("cpu")["base"], CameraInfo,
                        LoadedCamera),
                 (pts, cols, np.zeros_like(pts)), spatial_lr_scale=1.0,
                 model_cfg=ModelConfig(sh_degree=1, data_device="cpu"),
                 opt=OptimizationConfig(**OPT), pipe=PipelineConfig(),
                 raster=RasterConfig(dup_capacity=dup_capacity,
                                     max_per_tile=512, chunk=32),
                 initial_capacity=256, seed=7, packed=packed)
    state = state_from_numpy(jax_side["state"], "cpu")
    tr.state = pack_state(state) if packed else state
    return tr


def port_views(tr):
    """render_view of every view of VIEWS (unclipped outputs)."""
    cams = cameras(tr.device)
    out = {}
    for name, (pose, sm, it) in VIEWS.items():
        tr.iteration = it
        out[name] = tr.render_view(cams[pose], sm)
    return out


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "tree"])
def test_render_view_matches_eval_render(jax_side, packed):
    tr = port_trainer(jax_side, packed)
    got = port_views(tr)
    for name, ref in jax_side["images"].items():
        img = torch.clamp(got[name].image, 0.0, 1.0).numpy()
        np.testing.assert_allclose(img, ref, atol=2e-5, rtol=0,
                                   err_msg=name)
        if name != "base":
            assert np.abs(img - jax_side["images"]["base"]).max() > 1e-3, \
                f"the {name} change left the image as it was"
    # pose, scaling_modifier and SH degree are inputs, not keys
    assert len(tr.views.views) == 1 and tr.views.captures == []


def _same(a, b):
    for f in ("image", "invdepth", "final_T", "radii", "visibility",
              "num_duplicates", "max_tile_len", "overflow", "num_valid"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and torch.equal(x, y), f


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "tree"])
def test_view_graph_equals_the_eager_view(jax_side, packed):
    tr = port_trainer(jax_side, packed)

    def both(cam, sm=1.0):
        tr._eager_dispatch = True
        eager = tr.render_view(cam, sm)
        tr._eager_dispatch = False
        graph = tr.render_view(cam, sm)
        _same(graph, eager)
        return graph

    cams = cameras("cpu")
    for name, (pose, sm, it) in VIEWS.items():
        tr.iteration = it
        both(cams[pose], sm)
    assert len(tr.views.views) == 1
    # another resolution: a second key
    half = make_camera(*POSES["moved"], FOVX, FOVY, W // 2, H // 2,
                       device="cpu")
    assert both(half).image.shape == (3, H // 2, W // 2)
    assert len(tr.views.views) == 2
    # another state (as a densify's result would be): every graph released
    tr.state = clone_state(tr.state)
    both(cams["base"])
    assert len(tr.views.views) == 1
    # a view that overflows renders again at grown buffers: a grown key
    tr.raster = dataclasses.replace(tr.raster, dup_capacity=64)
    out = both(cams["base"])
    assert not bool(out.overflow) and int(out.num_duplicates) > 64
    assert len(tr.views.views) == 3 and tr.raster.dup_capacity == 64


def test_evaluate_matches_jax(jax_side):
    tr = port_trainer(jax_side)
    tr.iteration = 1000
    got, ref = tr.evaluate(tr.train_cams), jax_side["report"]
    assert got["n_views"] == ref["n_views"] == 4
    assert abs(got["l1"] - ref["l1"]) <= 2e-5
    assert abs(got["psnr"] - ref["psnr"]) <= 1e-3
    assert len(tr.views.views) == 1


def test_view_graph_reads_a_packed_block_as_its_params(jax_side):
    """ViewGraph called directly: a packed [R, C] block (unpacked inside the
    view) and its unpacked params render the same view, bitwise; no mask
    (``sh_degree`` None) is the full degree's mask; through render_grown,
    a lower degree's mask is the eager mask's view."""
    state = state_from_numpy(jax_side["state"], "cpu")
    packed = pack_state(state)
    cam, bg = cameras("cpu")["moved"], torch.zeros(3)
    kw = dict(alive=state.alive, active_sh_degree=1, dup_capacity=4096,
              max_per_tile=512, chunk=32)
    outs = [ViewGraph()(cam, packed.packed, bg, sh_degree=1, **kw),
            ViewGraph()(cam, state.params, bg, sh_degree=1, **kw),
            ViewGraph()(cam, state.params, bg, **kw)]
    for o in outs[1:]:
        _same(o, outs[0])
    raster = RasterConfig(dup_capacity=4096, max_per_tile=512, chunk=32)
    masked, _ = render_grown(cam, packed.packed, bg, raster,
                             graph=ViewGraph(), sh_degree=0,
                             alive=state.alive, active_sh_degree=1)
    ref, _ = render_grown(cam, mask_sh_rest(state.params, 0), bg, raster,
                          alive=state.alive, active_sh_degree=1)
    _same(masked, ref)


def test_view_graph_keeps_the_last_views(jax_side):
    """Three resolutions through a ViewGraph of two views: the oldest key
    goes, a key used again moves to the back, and a released key's view,
    asked for again, is the view it rendered before, bitwise."""
    state = state_from_numpy(jax_side["state"], "cpu")
    bg = torch.zeros(3)
    kw = dict(alive=state.alive, active_sh_degree=1, sh_degree=1,
              dup_capacity=4096, max_per_tile=512, chunk=32)
    sizes = [(W, H), (W // 2, H // 2), (W // 4, H // 4)]
    cams = [make_camera(*POSES["moved"], FOVX, FOVY, w, h, device="cpu")
            for w, h in sizes]
    graph = ViewGraph(max_views=2)
    first = [graph(c, state.params, bg, **kw) for c in cams]
    assert [k[:2] for k in graph.views] == sizes[1:]
    graph(cams[1], state.params, bg, **kw)
    again = graph(cams[0], state.params, bg, **kw)
    assert [k[:2] for k in graph.views] == [sizes[1], sizes[0]]
    _same(again, first[0])
    assert ViewGraph().max_views == MAX_VIEWS >= 2


# ----------------------------------------------------------- the render CLI

@pytest.fixture(scope="module")
def trained_model(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("dataset"))
    make_colmap_dataset(root, np.random.default_rng(3), n_images=8,
                        width=64, height=48)
    model = str(tmp_path_factory.mktemp("model"))
    train_app.main(["-s", root, "-m", model, "--iterations", "6",
                    "--test_iterations", "6", "--save_iterations", "6",
                    "--densify_from_iter", "100",
                    "--opacity_reset_interval", "1000",
                    "--dup_capacity", "4096", "--max_per_tile", "64",
                    "--chunk", "32", "--disable_viewer", "--quiet", "--eval",
                    "--data_device", "cpu"])
    return model


def test_render_cli_pngs_equal_the_eager_views(trained_model, tmp_path):
    """The render CLI through its ViewGraph, at a dup_capacity that the
    first view overflows, against ``render_grown`` of each view without
    the graph: the same PNG bytes."""
    graph = render_app.main(["-m", trained_model, "--quiet",
                             "--dup_capacity", "64", "--max_per_tile", "64",
                             "--chunk", "32", "--data_device", "cpu"])
    assert isinstance(graph, ViewGraph) and len(graph.views) == 2
    parser = make_parser("", include_optimization=False, fill_none=True)
    args = get_combined_args(parser, ["-m", trained_model])
    scene = Scene(args.source_path, "", images=args.images,
                  resolution=args.resolution, eval_split=args.eval,
                  shuffle=False, device="cpu")
    scene.model_path = trained_model
    d, iteration = scene.load_ply(-1)
    params, alive = render_app.params_from_ply(d, device="cpu")
    raster = RasterConfig(dup_capacity=64, max_per_tile=64, chunk=32)
    n = 0
    for split, cams in (("train", scene.get_train_cameras()),
                        ("test", scene.get_test_cameras())):
        for idx, cam in enumerate(cams):
            out, raster = render_grown(cam.camera, params, torch.zeros(3),
                                       raster, active_sh_degree=d["sh_degree"],
                                       alive=alive)
            mine = str(tmp_path / f"{split}{idx}.png")
            render_app.save_png(mine, out.image.numpy())
            cli = os.path.join(trained_model, split, f"ours_{iteration}",
                               "renders", f"{idx:05d}.png")
            with open(mine, "rb") as a, open(cli, "rb") as b:
                assert a.read() == b.read(), (split, idx)
            n += 1
    assert n == 8 and raster.dup_capacity > 64


# ------------------------------------------------------------- on the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (a CUDA graph has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_graphed_view_equals_render_grown(jax_side, cuda_device):
    """Each changed input, bitwise the eager view, with the captures it
    should cause: none for pose, scaling_modifier and SH degree, one for a
    resolution, one for a new state, two for an overflowing view (its
    buffers, then the grown ones); K2 and K1 once per replay."""
    dev = cuda_device
    state = pack_state(state_from_numpy(jax_side["state"], dev))
    bg = torch.zeros(3, device=dev)
    cams = cameras(dev)
    graph = ViewGraph()
    raster = RasterConfig(dup_capacity=4096, max_per_tile=512, chunk=32)

    def both(cam, sm=1.0, deg=1, st=state, want=0):
        before = len(graph.captures)
        got, grown = render_grown(cam, st.packed, bg, raster, graph=graph,
                                  sh_degree=deg, scaling_modifier=sm,
                                  alive=st.alive, active_sh_degree=1)
        ref, ref_grown = render_grown(cam, mask_sh_rest(st.params, deg), bg,
                                      raster, scaling_modifier=sm,
                                      alive=st.alive, active_sh_degree=1)
        _same(got, ref)
        assert grown == ref_grown
        if want is not None:
            assert len(graph.captures) - before == want
        return got, grown

    base, _ = both(cams["base"], want=1)
    for out, _ in (both(cams["moved"]), both(cams["base"], sm=0.7),
                   both(cams["base"], deg=0)):
        assert not torch.equal(out.image, base.image)
    half = make_camera(*POSES["moved"], FOVX, FOVY, W // 2, H // 2,
                       device=dev)
    both(half, want=1)
    state = clone_state(state)
    both(cams["base"], st=state, want=1)
    raster = dataclasses.replace(raster, dup_capacity=64)
    out, grown = both(cams["base"], st=state, want=2)
    assert int(out.num_duplicates) > 64 and grown.dup_capacity > 64
    # the moved view: a replay at 64 entries and, if it overflows there,
    # one at its grown buffers, a new key (a capture, whose warm-up
    # launches too) unless they are the base view's grown ones
    counters = launch_counters()
    before = [f.launches for f in counters]
    n_captures = len(graph.captures)
    _, moved = both(cams["moved"], st=state, want=None)
    torch.cuda.synchronize()
    renders = 1 + (moved.dup_capacity != 64)
    captured = len(graph.captures) - n_captures
    assert captured == (moved.dup_capacity not in (64, grown.dup_capacity))
    # the graph's replays, the eager view's renders, the capture's warm-up;
    # the preprocess kernel in the graph's alone (the eager view is the
    # tree layout's); no Adam, no SSIM
    k = 2 * renders + captured
    assert [f.launches - n for f, n in zip(counters, before)] \
        == [k, k, 0, 0, 0, renders + captured, 0, 0, 0, 0]


@pytest.mark.cuda
def test_view_graph_memory_stays_flat(jax_side, cuda_device):
    """Six resolutions, three times round, through a ViewGraph of four
    views: every key is captured again each round (the least recently used
    went), every view bitwise the eager one, and the memory the card
    reserves grows after the first round by less than one capture's peak
    allocation: the graphs share one pool, and a released graph's memory
    serves the next capture."""
    dev = cuda_device
    state = state_from_numpy(jax_side["state"], dev)
    bg = torch.zeros(3, device=dev)
    kw = dict(alive=state.alive, active_sh_degree=1, dup_capacity=4096,
              max_per_tile=512, chunk=32)
    graph = ViewGraph(max_views=4)
    cams = [make_camera(*POSES["moved"], FOVX, FOVY, W - 8 * i, H - 4 * i,
                        device=dev) for i in range(6)]
    reserved = []
    for _ in range(3):
        for cam in cams:
            _same(graph(cam, state.params, bg, **kw),
                  render(cam, state.params, bg, **kw))
        torch.cuda.synchronize()
        reserved.append(torch.cuda.memory_reserved(dev))
    assert len(graph.captures) == 18 and len(graph.views) == 4
    peak = max(c["pool_peak_bytes"] for c in graph.captures)
    assert reserved[2] - reserved[0] < max(peak, 1), (reserved, peak)
