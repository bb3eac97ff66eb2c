"""Density control as a graph: gs_tpu_torch.train.graph.DensityGraph, through
which the Trainer densifies and resets opacities (on CUDA one captured graph
replayed per call; on the CPU the same body, eagerly), against gs_tpu's
jitted ``densify_and_prune`` and ``reset_opacity`` and against the eager
functions.

* ``_nonzero_padded`` is ``jnp.nonzero(mask, size=c, fill_value=fill)``
  exactly: empty, full and random masks at three densities, c in {1, 1024,
  4099}, both fills.
* ``densify_and_prune`` and ``reset_opacity``, tree and packed, with
  ``use_size_threshold`` a 0-d bool tensor either way, run with
  ``torch.nonzero``, ``Tensor.item``, ``Tensor.__bool__`` and
  ``Tensor.__int__`` made to raise: nothing is read back to the host, so a
  CUDA graph can capture them. They equal the JAX package's functions given
  the same noise: alive masks, counts and moments equal, parameters within
  1e-6 (tests/test_torch_density.py's rules; the packed reset within 1e-5,
  tests/test_torch_packed.py's).
* A DensityGraph writes the functions' results into the state it was made
  with, bitwise, its tensors kept; a ``LocalGroup(2)`` DensityGraph
  (gather, the one-device pass, shard) equals the one-device one.
* The Trainer through its DensityGraph equals the Trainer under
  ``_eager_dispatch`` bitwise over 12 iterations with a densify and then an
  opacity reset at 10, packed and tree; the state stays the step graph's
  static state, whose runner holds the DensityGraph, and a view rendered
  before the densify keeps its graph after it.
* On the card (``cuda``, skipped here): the graphed densify and reset are
  bitwise the eager functions for both gates, one capture each.

The states are tests/test_torch_density.py's (a JAX ``create_from_pcd``
with random Adam moments), with clones, splits, a low-opacity prune and a
world-size prune that the size gate turns on, all at once."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from gs_tpu.models import gaussian_model as jgm
from gs_tpu.models import packed_state as jps

from gs_tpu_torch.convert import state_from_numpy, state_to_numpy
from gs_tpu_torch.models import gaussian_model as tgm
from gs_tpu_torch.models import packed_state as tps
from gs_tpu_torch.models.gaussian_model import _nonzero_padded
from gs_tpu_torch.parallel.mesh import LocalGroup
from gs_tpu_torch.train.graph import DensityGraph, clone_state, state_leaves

from test_torch_density import _to_jax, _to_numpy, make_state
from test_torch_trainer import ITERS, port_trainer

CAP = 64
KW = dict(grad_threshold=2e-4, min_opacity=0.005, extent=1.0,
          percent_dense=0.01)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------- _nonzero_padded

MASKS = ("empty", "full", "p0.01", "p0.5", "p0.99")


@pytest.mark.parametrize("fill", ["zero", "c"])
@pytest.mark.parametrize("c", [1, 1024, 4099])
@pytest.mark.parametrize("mask", MASKS)
def test_nonzero_padded_matches_jnp_nonzero(mask, c, fill):
    rng = np.random.default_rng(c)
    if mask == "empty":
        m = np.zeros(c, bool)
    elif mask == "full":
        m = np.ones(c, bool)
    else:
        m = rng.uniform(size=c) < float(mask[1:])
    f = 0 if fill == "zero" else c
    want = np.asarray(jnp.nonzero(jnp.asarray(m), size=c, fill_value=f)[0])
    got = _nonzero_padded(torch.from_numpy(m), f)
    assert got.dtype == torch.int64 and got.shape == (c,)
    np.testing.assert_array_equal(got.numpy(), want)
    # the values torch.nonzero gives, padded
    idx = torch.nonzero(torch.from_numpy(m)).squeeze(1)
    assert torch.equal(got[:idx.shape[0]], idx)
    assert bool((got[idx.shape[0]:] == f).all())


# ------------------------------------------------------ the state and rules

def gated_state() -> dict:
    """Rows 0-4 clone (scale e^-5 below 1 % of the extent), rows 5-9 split
    (scale e^-1) into children above a tenth of the extent, which the size
    gate prunes, row 12 is a world-size prune under the gate and row 15 a
    low-opacity prune."""
    d = make_state(n=20, capacity=CAP)
    d["grad_accum"][:10] = 10.0
    d["denom"][:20] = 1.0
    ls = d["params"]["log_scale"]
    ls[:5] = -5.0
    ls[5:10] = -1.0
    ls[12] = np.log(5.0)
    d["params"]["logit_opacity"][15] = np.log(0.001 / 0.999)
    return d


def noise_for(key) -> torch.Tensor:
    return torch.tensor(np.asarray(jax.random.normal(key, (CAP, 3))))


def tree_close(got, ref, atol=1e-6):
    """tests/test_torch_density.py's rules: alive, counters and moments
    equal, parameters within ``atol``."""
    got = state_to_numpy(got)
    ref = _to_numpy(ref)
    np.testing.assert_array_equal(got["alive"], ref["alive"])
    for k in ("grad_accum", "denom", "max_radii2D", "step", "exposure"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    for f, x in ref["params"].items():
        np.testing.assert_allclose(got["params"][f], x, rtol=0, atol=atol,
                                   err_msg=f)
    for k in ("m", "v"):
        for f, x in ref[k].items():
            np.testing.assert_array_equal(got[k][f], x, err_msg=f"{k}.{f}")


def packed_close(got, ref, atol=1e-6):
    """tests/test_torch_packed.py::_assert_packed_close's rule, moments
    equal."""
    for k, x in ref._asdict().items():
        x, y = np.asarray(x), getattr(got, k).numpy()
        assert y.shape == x.shape and y.dtype == x.dtype, k
        if k in ("packed",):
            np.testing.assert_allclose(y, x, atol=atol, rtol=0, err_msg=k)
        else:
            np.testing.assert_array_equal(y, x, err_msg=k)


def leaves_equal(a, b):
    for x, y in zip(state_leaves(a), state_leaves(b)):
        assert x.dtype == y.dtype and torch.equal(x, y)


def _refuse(name):
    def refuse(*args, **kwargs):
        raise AssertionError(f"{name} reads the device back")
    return refuse


@pytest.mark.parametrize("gate", [False, True], ids=["gate-off", "gate-on"])
@pytest.mark.parametrize("packed", [False, True], ids=["tree", "packed"])
def test_density_control_reads_nothing_back(packed, gate, monkeypatch):
    d = gated_state()
    key = jax.random.key(1)
    jstate = _to_jax(d)
    if packed:
        jstate = jps.pack_state(jstate)
        jdens, jreset = jps.densify_and_prune_packed, jps.reset_opacity_packed
        tdens, treset = tps.densify_and_prune_packed, tps.reset_opacity_packed
    else:
        jdens, jreset = jgm.densify_and_prune, jgm.reset_opacity
        tdens, treset = tgm.densify_and_prune, tgm.reset_opacity
    jd, jinfo = jdens(jstate, key, use_size_threshold=jnp.bool_(gate), **KW)
    jr = jreset(jd)

    state = state_from_numpy(d, "cpu")
    if packed:
        state = tps.pack_state(state)
    noise, flag = noise_for(key), torch.tensor(gate)
    with monkeypatch.context() as m:
        m.setattr(torch, "nonzero", _refuse("torch.nonzero"))
        for name in ("item", "__bool__", "__int__"):
            m.setattr(torch.Tensor, name, _refuse(f"Tensor.{name}"))
        td, tinfo = tdens(state, noise, use_size_threshold=flag, **KW)
        tr = treset(td)

    for f in tgm.DensifyInfo._fields:
        assert int(getattr(tinfo, f)) == int(getattr(jinfo, f)), f
    assert int(tinfo.n_cloned) == 5 and int(tinfo.n_split) == 5
    # the gate prunes rows 10-19 (scales above a tenth of the extent)
    assert int(tinfo.n_pruned) == (10 if gate else 1)
    if packed:
        packed_close(td, jd)
        packed_close(tr, jr, atol=1e-5)
    else:
        tree_close(td, jd)
        tree_close(tr, jr)


# -------------------------------------------------------- the DensityGraph

@pytest.mark.parametrize("packed", [False, True], ids=["tree", "packed"])
def test_density_graph_writes_in_place(packed):
    """The graph's body (eager on the CPU) writes the functions' results
    into the state it was made with: bitwise, its tensors kept. The noise
    drawn into the static buffer (``out=``) is the draw of a new
    tensor."""
    state = state_from_numpy(gated_state(), "cpu")
    if packed:
        state = tps.pack_state(state)
    dens = tps.densify_and_prune_packed if packed else tgm.densify_and_prune
    reset = tps.reset_opacity_packed if packed else tgm.reset_opacity
    for gate in (True, False):
        work = clone_state(state)
        leaves = state_leaves(work)
        graph = DensityGraph(work)
        assert graph.noise.shape == (CAP, 3)
        noise = graph.noise
        torch.randn((CAP, 3), generator=torch.Generator().manual_seed(4),
                    out=noise)
        assert torch.equal(noise, torch.randn(
            (CAP, 3), generator=torch.Generator().manual_seed(4)))
        ref, rinfo = dens(state, noise.clone(), use_size_threshold=gate, **KW)
        info = graph.densify(noise, torch.tensor(gate), **KW)
        assert graph.state is work
        assert all(a is b for a, b in zip(state_leaves(work), leaves))
        leaves_equal(work, ref)
        assert all(torch.equal(a, b) for a, b in zip(info, rinfo))
        graph.reset_opacity()
        leaves_equal(work, reset(ref))
    # a noise tensor of its own is copied into the static buffer
    other = torch.randn((CAP, 3), generator=torch.Generator().manual_seed(5))
    work = clone_state(state)
    graph = DensityGraph(work)
    graph.densify(other, True, **KW)
    assert torch.equal(graph.noise, other)
    leaves_equal(work, dens(state, other, use_size_threshold=True, **KW)[0])


@pytest.mark.parametrize("packed", [False, True], ids=["tree", "packed"])
def test_local_group_densify_equals_one_device(packed):
    state = state_from_numpy(gated_state(), "cpu")
    if packed:
        state = tps.pack_state(state)
    noise = noise_for(jax.random.key(2))
    one, two = clone_state(state), clone_state(state)
    g1, g2 = DensityGraph(one), DensityGraph(two, LocalGroup(2, "cpu"))
    assert g1.noise.shape == g2.noise.shape == (CAP, 3)
    a = g1.densify(noise, True, **KW)
    b = g2.densify(noise, True, **KW)
    leaves_equal(one, two)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    g2.reset_opacity()
    g1.reset_opacity()
    leaves_equal(one, two)


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "tree"])
def test_trainer_density_graph_equals_eager(packed):
    """12 iterations, a densify and then an opacity reset at 10: the
    graphed density control (its body, on the CPU) against
    ``_eager_dispatch``, bitwise; the state stays the step graph's static
    state, and a view rendered before the densify keeps its graph."""
    runs = {}
    for eager in (True, False):
        tr = port_trainer(packed=packed, opacity_reset_interval=10)
        tr._eager_dispatch = eager
        cam = tr.train_cams[0].camera
        seen = {}

        def on_step(i, m, t, _seen=seen, _cam=cam):
            if i == 9 and not t._eager_dispatch:
                t.render_view(_cam)
                _seen["view"] = list(t.views.views.values())

        calls = []
        densify = tr._densify
        tr._densify = lambda s, u, _d=densify, _c=calls: (
            _c.append(u), _d(s, u))[1]
        tr.train(iterations=ITERS, on_step=on_step, log_every=1)
        tr.sync_metrics()
        assert calls == [False]
        runs[eager] = tr
        if not eager:
            assert tr._runner.owns(tr.state)
            # the runner's density control, on its static state; the CPU
            # runs the bodies
            density = tr._runner.density
            assert tr._runner.owns(density.state)
            assert density.graphs == {} and tr.density_captures == []
            tr.render_view(cam)
            assert list(tr.views.views.values()) == seen["view"]
    a, b = runs[True], runs[False]
    assert int(b.state.alive.sum()) > 50
    leaves_equal(b.state, a.state)
    assert a.ema_loss == b.ema_loss


# ------------------------------------------------------------- on the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (a CUDA graph has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("packed", [False, True], ids=["tree", "packed"])
def test_graphed_density_control_equals_eager(packed, cuda_device):
    dev = cuda_device
    state = state_from_numpy(gated_state(), dev)
    if packed:
        state = tps.pack_state(state)
    dens = tps.densify_and_prune_packed if packed else tgm.densify_and_prune
    reset = tps.reset_opacity_packed if packed else tgm.reset_opacity
    work = clone_state(state)
    graph = DensityGraph(work)
    for gate in (True, False, True):
        noise = torch.randn((CAP, 3), device=dev)
        ref, rinfo = dens(work, noise, use_size_threshold=gate, **KW)
        info = graph.densify(noise, gate, **KW)
        leaves_equal(work, ref)
        assert all(torch.equal(x, y) for x, y in zip(info, rinfo))
        ref = reset(work)
        graph.reset_opacity()
        leaves_equal(work, ref)
    assert [c["what"] for c in graph.captures] == ["densify", "reset"]
