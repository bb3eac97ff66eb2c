"""The view under a mesh as a graph: ``Trainer(mesh=...)``'s ``render_view``
and ``evaluate`` through ``render.py::ViewGraph(mesh=...)`` (on CUDA one
captured graph of the banded view and its collectives, replayed per view;
on the CPU the same body, eagerly), against gs_tpu's jitted
``_eval_render`` and ``evaluate`` and against the eager banded view.

The scene and state are tests/test_torch_view_graph.py's (four 64x48
views, 50 points, 256 slots, SH degree 1 with random coefficients, made by
the JAX package), sharded over ``LocalGroup(k, "cpu")``.

* For k in {1, 2, 4}: ``render_view`` of the base view, a moved pose and a
  lower SH degree equals gs_tpu's ``_eval_render`` within
  tests/test_golden.py's 2e-5 absolute and the ``_eager_dispatch`` view
  bitwise, through one key that names the group's size;
  ``scaling_modifier`` still raises under a mesh; ``evaluate`` equals
  gs_tpu's (L1 within 2e-5, PSNR within 1e-3 dB).
* A densify between two views writes the step graph's static state in
  place: the mesh view keeps its graph.
* ``ProcessGroup.close`` releases the view and density graphs registered
  with it before it destroys the group (fake graphs, as
  tests/test_torch_mesh_block.py's).
* Two gloo processes: the train CLI with ``--multihost`` and test
  iterations reports the test views' L1 and PSNR of the same CLI run with
  ``group=LocalGroup(2)`` in this process, and exits.
* On the card (``cuda``, skipped here): the graphed mesh view of
  ``LocalGroup(2)`` bitwise the eager one through a pose change and an
  overflow, with the captures each should cause and K2 and K1 once per
  band and replay.
"""
import dataclasses
import re
import sys
import types

import numpy as np
import pytest
import torch

from gs_tpu_torch.config import (ModelConfig, OptimizationConfig,
                                 PipelineConfig, RasterConfig)
from gs_tpu_torch.convert import state_from_numpy
from gs_tpu_torch.data.camera_utils import LoadedCamera
from gs_tpu_torch.data.dataset_readers import CameraInfo
from gs_tpu_torch.models.packed_state import pack_state
from gs_tpu_torch.parallel.mesh import LocalGroup
from gs_tpu_torch.render import ViewGraph
from gs_tpu_torch.train.graph import DensityGraph, launch_counters
from gs_tpu_torch.train.loop import Trainer

from test_torch_trainer import OPT, _views, make_data
from test_torch_view_graph import VIEWS, _same, cameras, jax_side  # noqa: F401


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def mesh_trainer(jax_side, k, device="cpu", dup_capacity=4096):
    """tests/test_torch_view_graph.py::port_trainer under LocalGroup(k):
    its whole state is the JAX state (the shards of a LocalGroup are all
    local)."""
    images, pts, cols = make_data()
    tr = Trainer(_views(images, cameras(device)["base"], CameraInfo,
                        LoadedCamera),
                 (pts, cols, np.zeros_like(pts)), spatial_lr_scale=1.0,
                 model_cfg=ModelConfig(sh_degree=1, data_device=device),
                 opt=OptimizationConfig(**OPT), pipe=PipelineConfig(),
                 raster=RasterConfig(dup_capacity=dup_capacity,
                                     max_per_tile=512, chunk=32),
                 initial_capacity=256, seed=7,
                 mesh=LocalGroup(k, device))
    tr.state = pack_state(state_from_numpy(jax_side["state"], device))
    return tr


MESH_VIEWS = [v for v in VIEWS if v != "scaling_modifier"]


@pytest.mark.parametrize("k", [1, 2, 4])
def test_mesh_render_view_matches_eval_render(jax_side, k):
    tr = mesh_trainer(jax_side, k)
    cams = cameras("cpu")
    for name in MESH_VIEWS:
        pose, sm, it = VIEWS[name]
        tr.iteration = it
        tr._eager_dispatch = True
        eager = tr.render_view(cams[pose], sm)
        tr._eager_dispatch = False
        got = tr.render_view(cams[pose], sm)
        _same(got, eager)
        assert got.band_duplicates.shape == (k,)
        img = torch.clamp(got.image, 0.0, 1.0).numpy()
        np.testing.assert_allclose(img, jax_side["images"][name], atol=2e-5,
                                   rtol=0, err_msg=name)
    (key,) = tr.views.views
    assert key[3] == k and tr.views.mesh is tr.mesh
    with pytest.raises(ValueError, match="scaling_modifier"):
        tr.render_view(cams["base"], 0.7)


@pytest.mark.parametrize("k", [1, 2, 4])
def test_mesh_evaluate_matches_jax(jax_side, k):
    tr = mesh_trainer(jax_side, k)
    tr.iteration = 1000
    got, ref = tr.evaluate(tr.train_cams), jax_side["report"]
    assert got["n_views"] == ref["n_views"] == 4
    assert abs(got["l1"] - ref["l1"]) <= 2e-5
    assert abs(got["psnr"] - ref["psnr"]) <= 1e-3
    assert len(tr.views.views) == 1


def test_mesh_view_keeps_its_graph_through_a_densify(jax_side):
    """A view, a densify (through the step graph's static state, written in
    place), the same view again: the same captured view, and the image of
    the eager view of the densified state."""
    tr = mesh_trainer(jax_side, 2)
    cam = cameras("cpu")["base"]
    tr.iteration = 1000
    tr.step()              # the state is now the step graph's
    tr.render_view(cam)
    (view,) = tr.views.views.values()
    tr.state.grad_accum.fill_(1.0)
    tr.state.denom.fill_(1.0)
    tr.state, info = tr._densify(tr.state, False)
    assert int(info.n_cloned) + int(info.n_split) > 0
    assert tr._runner.owns(tr.state)
    got = tr.render_view(cam)
    assert list(tr.views.views.values()) == [view]
    tr._eager_dispatch = True
    _same(got, tr.render_view(cam))


def test_close_releases_view_and_density_graphs_first(jax_side):
    """ProcessGroup.close releases every graph that captured the group's
    collectives, the view's and density control's among them, before it
    destroys the group."""
    import socket
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
        def __init__(self, name):
            self.name = name

        def reset(self):
            events.append((self.name, dist.is_initialized()))

    views = ViewGraph(mesh=group)
    views.views["key"] = types.SimpleNamespace(graph=Graph("view"))
    density = DensityGraph(pack_state(state_from_numpy(
        jax_side["state"], "cpu")), group)
    density.graphs["densify"] = types.SimpleNamespace(graph=Graph("densify"))
    density.graphs["reset"] = types.SimpleNamespace(graph=Graph("reset"))
    group.graphs.add(views)
    group.graphs.add(density)
    group.close()
    assert sorted(events) == [("densify", True), ("reset", True),
                              ("view", True)]
    assert not views.views and not density.graphs
    assert not dist.is_initialized()


# ---------------------------------------------------- two gloo processes

TEST_LINE = re.compile(r"\[ITER (\d+)\] Evaluating (\w+): L1 ([\d.]+) "
                       r"PSNR ([\d.]+)")


def test_two_process_cli_test_views_match_local_group(tmp_path, capsys):
    from test_data import make_colmap_dataset
    from test_torch_multihost import _run_two, _train_args
    from gs_tpu_torch.apps import train as train_app

    root = str(tmp_path / "dataset")
    make_colmap_dataset(root, np.random.default_rng(11), n_images=4,
                        width=64, height=48)

    def model(name):
        """test_torch_multihost's run (a densify at 5), 8 iterations,
        test views at 6 and 8."""
        a = _train_args(root, str(tmp_path / name))
        a[a.index("--iterations") + 1] = "8"
        a[a.index("--save_iterations") + 1] = "8"
        i = a.index("--test_iterations")
        a[i + 1:i + 2] = ["6", "8"]
        return a

    outs = _run_two(lambda rank: [sys.executable, "-m",
                                  "gs_tpu_torch.apps.train", *model("mh"),
                                  "--multihost"], {}, tmp_path, "views")
    capsys.readouterr()
    train_app.main(model("lg"), group=LocalGroup(2, "cpu"))
    mine = TEST_LINE.findall(capsys.readouterr().out)
    theirs = TEST_LINE.findall(outs[0])
    assert [m[:2] for m in mine] == [t[:2] for t in theirs] == [
        ("6", "test"), ("6", "train_sample"), ("8", "test"),
        ("8", "train_sample")]
    for m, t in zip(mine, theirs):
        assert abs(float(m[2]) - float(t[2])) <= 1e-4, (m, t)
        assert abs(float(m[3]) - float(t[3])) <= 1e-2, (m, t)
    assert not TEST_LINE.findall(outs[1])     # rank 0 alone reports


# ------------------------------------------------------------- on the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (a CUDA graph has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_graphed_mesh_view_equals_the_eager_view(jax_side, cuda_device):
    tr = mesh_trainer(jax_side, 2, cuda_device)
    cams = cameras(cuda_device)
    tr.iteration = 1000
    counters = launch_counters()

    def both(cam, want):
        before = len(tr.views.captures)
        tr._eager_dispatch = True
        eager = tr.render_view(cam)
        tr._eager_dispatch = False
        n = [f.launches for f in counters]
        got = tr.render_view(cam)
        torch.cuda.synchronize()
        _same(got, eager)
        assert len(tr.views.captures) - before == want
        return got, [f.launches - c for f, c in zip(counters, n)]

    _, first = both(cams["base"], 1)
    # the warm-up's bands and a replay's; the graph's preprocess forward a
    # shard each (the eager view is the tree layout's)
    assert first == [4, 4, 0, 0, 0, 4, 0, 0, 0, 0]
    moved, launches = both(cams["moved"], 0)
    assert launches == [2, 2, 0, 0, 0, 2, 0, 0, 0, 0]
    tr.raster = dataclasses.replace(tr.raster, dup_capacity=64)
    out, _ = both(cams["base"], 2)
    assert int(out.band_duplicates.max()) > 64
