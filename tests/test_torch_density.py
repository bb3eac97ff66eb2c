"""gs_tpu_torch density control against gs_tpu's on the CPU: densify_and_prune
(clone, split, low-opacity prune, the gated world-size prune, and a full
state where new Gaussians find no free slot), reset_opacity, compact and
grow_capacity, from one state carried over as numpy.

The split noise is drawn by JAX (``jax.random.normal(key, (c, 3))``, as
gs_tpu draws it) and handed to the port. The Adam moments start from random
values so that the rows density control resets are seen to be zero. Alive
masks, counts and moments must be equal, parameters within 1e-6."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from gs_tpu.core.gaussians import GaussianParams as JGaussianParams
from gs_tpu.core.gaussians import inverse_sigmoid as jax_inverse_sigmoid
from gs_tpu.models import gaussian_model as jgm

from gs_tpu_torch.convert import state_from_numpy, state_to_numpy
from gs_tpu_torch.models import gaussian_model as tgm

PARAM_FIELDS = ("params", "m", "v")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """At these tiny shapes torch's thread pool gives nothing, and beside
    other test processes its threads oversubscribe the cores (a parallel
    region then waits on threads that are not running)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _to_numpy(state):
    return {k: ({f: np.array(x) for f, x in v._asdict().items()}
                if k in PARAM_FIELDS else np.array(v))
            for k, v in state._asdict().items()}


def _to_jax(d):
    return jgm.TrainState(**{
        k: JGaussianParams(**{f: jnp.asarray(x) for f, x in v.items()})
        if k in PARAM_FIELDS else jnp.asarray(v) for k, v in d.items()})


def make_state(n=8, capacity=32, opacity=0.5):
    """tests/test_model.py::make_state, with random Adam moments."""
    rng = np.random.default_rng(0)
    pts = rng.normal(0, 1, (n, 3))
    cols = rng.uniform(0, 1, (n, 3))
    params, alive = jgm.create_from_pcd(pts, cols, sh_degree=1,
                                        capacity=capacity)
    params = params._replace(logit_opacity=jnp.where(
        alive[:, None], jax_inverse_sigmoid(jnp.full((capacity, 1), opacity)),
        params.logit_opacity))
    d = _to_numpy(jgm.init_state(params, alive, num_images=3))
    for k in ("m", "v"):
        d[k] = {f: np.abs(rng.normal(0, 1, x.shape)).astype(np.float32)
                for f, x in d[k].items()}
    return d


def _clone(d):
    d = dict(d, grad_accum=d["grad_accum"].copy(), denom=d["denom"].copy())
    d["grad_accum"][:2] = 10.0
    d["denom"][:8] = 1.0
    d["params"] = dict(d["params"], log_scale=np.full_like(
        d["params"]["log_scale"], -5.0))
    return d, dict(extent=10.0)


def _split(d):
    d = dict(d, grad_accum=d["grad_accum"].copy(), denom=d["denom"].copy())
    d["grad_accum"][0] = 10.0
    d["denom"][:8] = 1.0
    ls = d["params"]["log_scale"].copy()
    ls[0] = 0.0
    d["params"] = dict(d["params"], log_scale=ls)
    return d, dict(extent=1.0)


def _prune(d):
    op = d["params"]["logit_opacity"].copy()
    op[3] = np.log(0.001 / 0.999)
    return dict(d, params=dict(d["params"], logit_opacity=op)), dict(extent=10.0)


def _world_size(d, gate):
    ls = d["params"]["log_scale"].copy()
    ls[2] = np.log(5.0)
    return (dict(d, params=dict(d["params"], log_scale=ls)),
            dict(extent=1.0, grad_threshold=1e9, use_size_threshold=gate))


def _full(d):
    """20 of 32 slots alive and every one splits: 40 children for 32 free
    slots, so 8 are dropped."""
    d = make_state(n=20, capacity=32)
    d["grad_accum"][:20] = 10.0
    d["denom"][:20] = 1.0
    d["params"]["log_scale"][:20] = 0.0
    return d, dict(extent=1.0)


CASES = {
    "clone": _clone,
    "split": _split,
    "prune-low-opacity": _prune,
    "world-size-gate-off": lambda d: _world_size(d, False),
    "world-size-gate-on": lambda d: _world_size(d, True),
    "full-capacity": _full,
}


@pytest.mark.parametrize("case", list(CASES))
def test_densify_and_prune_matches_jax(case):
    d, kw = CASES[case](make_state())
    kw = dict(dict(grad_threshold=0.0002, min_opacity=0.005,
                   percent_dense=0.01, use_size_threshold=False), **kw)
    key = jax.random.key(0)
    c = d["alive"].shape[0]
    j_state, j_info = jgm.densify_and_prune(_to_jax(d), key, **kw)
    noise = torch.tensor(np.asarray(jax.random.normal(key, (c, 3))))
    start = state_from_numpy(d, "cpu")
    before = state_to_numpy(start)
    t_state, t_info = tgm.densify_and_prune(start, noise, **kw)

    ref, got = _to_numpy(j_state), state_to_numpy(t_state)
    for f in tgm.DensifyInfo._fields:
        assert int(getattr(t_info, f)) == int(getattr(j_info, f)), f
    if case == "full-capacity":
        assert int(t_info.n_dropped) == 8 and int(t_info.n_alive) == 32
    np.testing.assert_array_equal(got["alive"], ref["alive"])
    for k in ("grad_accum", "denom", "max_radii2D", "step", "exposure"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    for f, x in ref["params"].items():
        np.testing.assert_allclose(got["params"][f], x, rtol=0, atol=1e-6,
                                   err_msg=f)
    for k in ("m", "v"):
        for f, x in ref[k].items():
            np.testing.assert_array_equal(got[k][f], x, err_msg=f"{k}.{f}")
    # the rows the pass changed have zero moments; the input is untouched
    changed = (got["alive"] != before["alive"]) | (
        before["alive"] & ~got["alive"])
    assert all((got[k][f][changed] == 0).all() for k in ("m", "v")
               for f in got[k])
    for f, x in state_to_numpy(start)["params"].items():
        np.testing.assert_array_equal(x, before["params"][f])


def test_densify_noise_from_generator():
    d, kw = _split(make_state())
    st = state_from_numpy(d, "cpu")
    args = dict(grad_threshold=0.0002, min_opacity=0.005, percent_dense=0.01,
                use_size_threshold=False, **kw)
    a, _ = tgm.densify_and_prune(st, generator=torch.Generator().manual_seed(3),
                                 **args)
    b, _ = tgm.densify_and_prune(
        st, torch.randn((32, 3), generator=torch.Generator().manual_seed(3)),
        **args)
    assert torch.equal(a.params.xyz, b.params.xyz)


def test_reset_opacity_matches_jax():
    d = make_state(opacity=0.9)
    ref = _to_numpy(jgm.reset_opacity(_to_jax(d)))
    got = state_to_numpy(tgm.reset_opacity(state_from_numpy(d, "cpu")))
    np.testing.assert_allclose(got["params"]["logit_opacity"],
                               ref["params"]["logit_opacity"], rtol=0,
                               atol=1e-6)
    for k in ("m", "v"):
        for f, x in ref[k].items():
            np.testing.assert_array_equal(got[k][f], x, err_msg=f"{k}.{f}")


@pytest.mark.parametrize("capacity", [None, 8])
def test_compact_matches_jax(capacity):
    d = make_state(n=20, capacity=32)
    d["alive"] = d["alive"].copy()
    d["alive"][1:20:3] = False
    d["grad_accum"] = np.arange(32, dtype=np.float32)
    if capacity is not None:
        d["alive"][8:] = False
        d["alive"][:4] = True
    ref = _to_numpy(jgm.compact(_to_jax(d), capacity))
    got = state_to_numpy(tgm.compact(state_from_numpy(d, "cpu"), capacity))
    assert got["alive"].shape == ref["alive"].shape
    for k, v in ref.items():
        for f, x in (v.items() if k in PARAM_FIELDS else [(k, v)]):
            y = got[k][f] if k in PARAM_FIELDS else got[k]
            np.testing.assert_array_equal(y, x, err_msg=f"{k}.{f}")


def test_grow_capacity_matches_jax():
    d = make_state(n=8, capacity=16)
    ref = _to_numpy(jgm.grow_capacity(_to_jax(d), 64))
    got = state_to_numpy(tgm.grow_capacity(state_from_numpy(d, "cpu"), 64))
    for k, v in ref.items():
        for f, x in (v.items() if k in PARAM_FIELDS else [(k, v)]):
            y = got[k][f] if k in PARAM_FIELDS else got[k]
            assert y.dtype == x.dtype, (k, f)
            np.testing.assert_array_equal(y, x, err_msg=f"{k}.{f}")
