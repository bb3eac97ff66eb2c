"""The metrics CLI's SSIM and LPIPS as graphs: gs_tpu_torch.apps.metrics
through ``utils/cuda_graphs.py::GraphedFunction`` (on CUDA one captured
graph replayed per view and image size, as the JAX CLI jits ``ssim`` and
the LPIPS distance; on the CPU the functions themselves), against the JAX
package's metrics CLI.

* The CLI's ``results.json`` and ``per_view.json`` equal those of
  ``python -m gs_tpu.apps.metrics`` on the same PNGs (four views, one of
  another size): SSIM within 1e-6, PSNR within 1e-4 dB, and LPIPS (seeded
  random weights in the npz layout, as tests/test_torch_lpips.py's) within
  tests/test_torch_lpips.py's 1e-4 relative and 1e-6 absolute; with
  ``--no_lpips`` neither writes an LPIPS key.
* ``GraphedFunction`` keys on its inputs' shapes: a key's first call
  captures, a later call copies its inputs in and replays, and at most
  ``MAX_KEYS`` keys stay captured, the least recently used released (a
  stand-in capture records the body and replays it, as a CUDA graph
  would); outputs are copies, a tensor or a tuple.
* On the card (``cuda``, skipped here): graphed SSIM and LPIPS bitwise the
  eager functions at two sizes, and the CLI's files through the graphs
  bitwise those of the eager functions.
"""
import json
import os
import shutil
import time

import numpy as np
import pytest
import torch
from PIL import Image

from gs_tpu_torch.apps import metrics as metrics_app
from gs_tpu_torch.ops.lpips import lpips_vgg
from gs_tpu_torch.ops.ssim import ssim
from gs_tpu_torch.utils import cuda_graphs
from gs_tpu_torch.utils.cuda_graphs import Capture, GraphedFunction

from test_torch_lpips import random_weights

SIZES = [(64, 48), (64, 48), (64, 48), (48, 32)]   # (W, H) of each view


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights_npz(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("lpips") / "w.npz")
    np.savez(path, **random_weights(7))
    return path


def write_model(root: str, seed: int = 3):
    """``root``/test/ours_7/{renders,gt}/NNNNN.png: ground truths of noise,
    renders the truths plus noise."""
    rng = np.random.default_rng(seed)
    for sub in ("renders", "gt"):
        os.makedirs(os.path.join(root, "test", "ours_7", sub))
    for i, (w, h) in enumerate(SIZES):
        gt = rng.uniform(0, 1, (h, w, 3))
        out = np.clip(gt + rng.normal(0, 0.1, gt.shape), 0, 1)
        for sub, img in (("renders", out), ("gt", gt)):
            Image.fromarray((img * 255).round().astype(np.uint8)).save(
                os.path.join(root, "test", "ours_7", sub, f"{i:05d}.png"))


def read_results(root: str):
    with open(os.path.join(root, "results.json")) as f:
        results = json.load(f)
    with open(os.path.join(root, "per_view.json")) as f:
        return results, json.load(f)


RULES = {"SSIM": dict(rel=0, abs=1e-6), "PSNR": dict(rel=0, abs=1e-4),
         "LPIPS": dict(rel=1e-4, abs=1e-6)}


@pytest.mark.parametrize("lpips", [True, False], ids=["lpips", "no-lpips"])
def test_metrics_cli_matches_jax(tmp_path, weights_npz, monkeypatch, lpips):
    from gs_tpu.apps import metrics as jax_metrics
    monkeypatch.setenv("GS_TPU_LPIPS_WEIGHTS", weights_npz)
    mine, theirs = str(tmp_path / "port"), str(tmp_path / "jax")
    write_model(mine)
    shutil.copytree(mine, theirs)
    flags = [] if lpips else ["--no_lpips"]
    jax_metrics.main(["-m", theirs] + flags)
    metrics_app.main(["-m", mine, "--data_device", "cpu"] + flags)
    got, got_views = read_results(mine)
    ref, ref_views = read_results(theirs)
    keys = ["SSIM", "PSNR"] + (["LPIPS"] if lpips else [])
    assert list(got) == list(ref) == ["ours_7"]
    assert sorted(got["ours_7"]) == sorted(ref["ours_7"]) == sorted(keys)
    for k in keys:
        assert got["ours_7"][k] == pytest.approx(ref["ours_7"][k],
                                                 **RULES[k]), k
        views, ref_v = got_views["ours_7"][k], ref_views["ours_7"][k]
        assert sorted(views) == sorted(ref_v) == [
            f"{i:05d}.png" for i in range(len(SIZES))]
        for name, x in ref_v.items():
            assert views[name] == pytest.approx(x, **RULES[k]), (k, name)


def test_metric_functions_on_the_cpu(tmp_path, weights_npz, monkeypatch):
    """On the CPU the CLI's functions are the eager ones (a
    GraphedFunction calls its function there) and give their values;
    without LPIPS weights there is no LPIPS."""
    monkeypatch.setenv("GS_TPU_LPIPS_WEIGHTS", str(tmp_path / "absent.npz"))
    ssim_f, lpips_f = metrics_app.metric_functions("cpu", True)
    assert isinstance(ssim_f, GraphedFunction) and lpips_f is None
    monkeypatch.setenv("GS_TPU_LPIPS_WEIGHTS", weights_npz)
    ssim_f, lpips_f = metrics_app.metric_functions("cpu", True)
    assert ssim_f.fn is ssim and isinstance(lpips_f, GraphedFunction)
    rng = np.random.default_rng(0)
    a, b = (torch.tensor(rng.uniform(0, 1, (3, 32, 48)), dtype=torch.float32)
            for _ in range(2))
    assert torch.equal(ssim_f(a, b), ssim(a, b))
    assert torch.equal(lpips_f(a, b), lpips_vgg(device="cpu")(a, b))
    assert ssim_f.captures == [] and lpips_f.captures == []


# ------------------------------------------------- the graphed-function cache

class _Graph:
    """A stand-in CUDA graph: replays the captured body."""

    def __init__(self, body):
        self.body, self.resets = body, 0

    def replay(self):
        self.body()

    def reset(self):
        self.resets += 1


def _capture(device, warm_up, body, label, *, mesh=None, owner=None,
             pool=None):
    warm_up()
    body()
    return Capture(_Graph(body), {}, 0, 0, time.perf_counter())


class _Graphed(GraphedFunction):
    """A GraphedFunction that treats CPU tensors as it treats CUDA ones."""

    @staticmethod
    def _graphed(args) -> bool:
        return True


@pytest.fixture
def stand_in_capture(monkeypatch):
    monkeypatch.setattr(cuda_graphs, "capture", _capture)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: object())


def test_graphed_function_keys_on_shape(stand_in_capture, monkeypatch):
    rng = np.random.default_rng(1)

    def pair(w, h):
        return [torch.tensor(rng.uniform(0, 1, (3, h, w)),
                             dtype=torch.float32) for _ in range(2)]

    monkeypatch.setattr(cuda_graphs, "MAX_KEYS", 2)
    f = _Graphed(ssim, label="SSIM")
    order = [(64, 48), (32, 24), (64, 48), (16, 12), (32, 24), (32, 24)]
    graphs = {}
    for w, h in order:
        a, b = pair(w, h)
        assert torch.equal(f(a, b), ssim(a, b)), (w, h)
        key = next(k for k in f.entries if k[0][0] == (3, h, w))
        graphs.setdefault((w, h), []).append(f.entries[key].graph)
    # 64x48 and 32x24 captured, 64x48 replayed (now the newest), 16x12
    # captured (32x24, the oldest, released), 32x24 captured again (64x48
    # released) and then replayed
    assert [c["shapes"][0] for c in f.captures] == [
        (3, 48, 64), (3, 24, 32), (3, 12, 16), (3, 24, 32)]
    assert [k[0][0] for k in f.entries] == [(3, 12, 16), (3, 24, 32)]
    first_32, second_32 = graphs[(32, 24)][0], graphs[(32, 24)][1]
    assert first_32 is not second_32 and first_32.resets == 1
    assert graphs[(32, 24)][2] is second_32 and second_32.resets == 0
    assert graphs[(64, 48)][0] is graphs[(64, 48)][1]
    assert graphs[(64, 48)][0].resets == 1


def test_graphed_function_outputs_are_copies(stand_in_capture):
    f = _Graphed(lambda a, b: (a + b, a * b))
    x, y = torch.ones(3), torch.full((3,), 2.0)
    s, p = f(x, y)
    s += 10.0
    s2, p2 = f(torch.full((3,), 3.0), y)
    assert torch.equal(s2, torch.full((3,), 5.0))
    assert torch.equal(p2, torch.full((3,), 6.0))
    assert torch.equal(p, torch.full((3,), 2.0))
    assert len(f.captures) == 1
    f.release()
    assert not f.entries and f.pool is None


# ------------------------------------------------------------- on the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (a CUDA graph has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_graphed_metrics_equal_eager(tmp_path, weights_npz, monkeypatch,
                                     cuda_device):
    from gs_tpu_torch.ops.lpips import LPIPS
    dev = cuda_device
    lp = LPIPS(random_weights(7), device=dev).eval()
    s_g, l_g = GraphedFunction(ssim), GraphedFunction(lp)
    rng = np.random.default_rng(2)
    for w, h in ((96, 64), (64, 48), (96, 64)):
        a, b = (torch.tensor(rng.uniform(0, 1, (3, h, w)), dtype=torch.float32,
                             device=dev) for _ in range(2))
        assert torch.equal(s_g(a, b), ssim(a, b))
        assert torch.equal(l_g(a, b), lp(a, b))
    assert len(s_g.captures) == len(l_g.captures) == 2
    monkeypatch.setenv("GS_TPU_LPIPS_WEIGHTS", weights_npz)
    graphed, eager = str(tmp_path / "graphed"), str(tmp_path / "eager")
    write_model(graphed)
    shutil.copytree(graphed, eager)
    metrics_app.evaluate([graphed], device=dev)
    metrics_app.evaluate([eager], device=dev,
                         functions=(ssim, lpips_vgg(device=dev)))
    for name in ("results.json", "per_view.json"):
        with open(os.path.join(graphed, name), "rb") as f, \
                open(os.path.join(eager, name), "rb") as g:
            assert f.read() == g.read(), name
