"""The preprocess kernel pair of gs_tpu_torch (``csrc/preprocess.cu``)
against its twin, the flat-channel PyTorch preprocess of
``gs_tpu_torch/core/project.py``.

On the CPU (no JAX: the twin's JAX parity is ``tests/test_torch_packed.py``
and ``tests/test_torch_core.py``):

* ``preprocess_packed`` runs the twin and launches nothing; the kernel pair
  engages on a CUDA device only, and never with ``override_color`` or
  ``cov3d_precomp`` or above SH degree 3;
* its ``mask_degree`` equals ``mask_sh_rows`` followed by the unmasked
  call, values and gradient, bitwise;
* a ``ViewGraph`` given the packed block renders what it renders from the
  tree layout, bitwise, through pose, SH degree and ``scaling_modifier``.

On the card (``cuda``, skipped here), for SH degrees 0-3, a mask degree
below and at the maximum, antialiasing on and off, on a column slice of a
wider block whose slots include dead ones, ones behind the near plane, one
on it, one at the camera centre and one whose 2D covariance has a zero
determinant:

* forward: the int and bool fields equal to the twin's on every slot, the
  float fields within 1e-6 of each field's largest magnitude on the alive
  slots and zero on the dead ones;
* backward: the gradient block within 2e-4 of each row group's largest
  magnitude of the twin's autograd gradient, the padding rows and the
  masked rows exactly 0, and bitwise equal from run to run;
* a captured CUDA graph replayed with a second camera and a second mask
  degree gives the eager kernels' outputs, and the launch counters count
  one forward and one backward per replay.
"""
import math

import numpy as np
import pytest
import torch

from gs_tpu_torch.core import packed as pk
from gs_tpu_torch.core import project
from gs_tpu_torch.core.camera import (ZFAR, ZNEAR, Camera, make_camera,
                                      projection_matrix)
from gs_tpu_torch.core.gaussians import GaussianParams
from gs_tpu_torch.render import ViewGraph, render

S = 64                       # a square image: fx == fy, see _camera
FOV = math.radians(60.0)
PAD = (13, 24)               # the block is a column slice: columns before, after
FIELDS_F = ("mean2d", "conic", "depth", "rgb", "opacity")
FIELDS_I = ("radius", "visible", "radius_cull")


def _camera(device, z_shift=0.0, roll=math.pi / 4):
    """A camera rolled about its axis. At the 45 degree roll the two rows
    of its rotation share one float32 entry, so a slot on the axis with a
    needle covariance along world x has cxx = cxy = cyy exactly: the
    dilated determinant is 0 once they are past 2^23."""
    c, s = np.float32(math.cos(roll)), np.float32(math.sin(roll))
    if roll == math.pi / 4:
        c = s = np.float32(math.sqrt(0.5))
    V = np.eye(4, dtype=np.float32)
    V[:3, :3] = [[c, -s, 0], [s, c, 0], [0, 0, 1]]
    V[2, 3] = z_shift
    full = (projection_matrix(ZNEAR, ZFAR, FOV, FOV) @ V).astype(np.float32)
    centre = np.linalg.inv(V.astype(np.float64))[:3, 3].astype(np.float32)

    def f32(x):
        return torch.tensor(np.asarray(x, np.float32), device=device)

    t = math.tan(FOV / 2)
    return Camera(world_view=f32(V), full_proj=f32(full),
                  camera_center=f32(centre), tan_fovx=f32(t), tan_fovy=f32(t),
                  width=S, height=S)


def _scene(sh_degree: int, seed: int = 0, n: int = 400):
    """(block [R, PAD[0] + n + PAD[1]], alive [n], named slot indices):
    the slots, in view space around the rolled camera (its rotation maps
    view x, y onto world by its transpose), and the specials at the end."""
    rng = np.random.default_rng(seed)
    lay = pk.layout(sh_degree)
    a = np.float32(math.sqrt(0.5))
    Rv = np.array([[a, -a, 0], [a, a, 0], [0, 0, 1]], np.float32)
    z = rng.uniform(1.0, 8.0, n)
    view = np.stack([rng.uniform(-1.0, 1.0, n) * z,
                     rng.uniform(-1.0, 1.0, n) * z, z], 1)
    behind = np.arange(n - 40, n - 20)
    view[behind, 2] = rng.uniform(-2.0, 0.19, behind.size)
    xyz = (view @ Rv).astype(np.float32)        # Rv^T applied to each row
    rows = np.zeros((lay.rows, n), np.float32)
    rows[0:3] = xyz.T
    rows[3:6] = rng.normal(0, 1.0, (3, n))
    rows[6:lay.log_scale] = rng.normal(0, 0.3, (3 * lay.rest, n))
    rows[lay.log_scale:lay.quat] = rng.uniform(-4.0, -1.0, (3, n))
    rows[lay.quat:lay.logit_opacity] = (rng.normal(0, 1, (4, n))
                                        + [[1.5], [0], [0], [0]])
    rows[lay.logit_opacity] = rng.uniform(-7.0, 4.0, n)
    special = {"near_plane": n - 3, "centre": n - 2, "zero_det": n - 1}
    rows[0:3, n - 3] = [0.0, 0.0, 0.2]          # view z exactly 0.2
    rows[0:3, n - 2] = 0.0                      # the camera centre
    rows[0:3, n - 1] = [0.0, 0.0, 5.0]          # on the axis
    rows[lay.log_scale:lay.quat, n - 1] = [8.0, -200.0, -200.0]
    rows[lay.quat:lay.logit_opacity, n - 1] = [1.0, 0.0, 0.0, 0.0]
    alive = rng.uniform(0, 1, n) > 0.25
    alive[n - 3:] = True
    wide = rng.normal(0, 1, (lay.rows, PAD[0] + n + PAD[1])).astype(np.float32)
    wide[:, PAD[0]:PAD[0] + n] = rows
    special["behind"] = behind
    return wide, alive, special


def _slice(wide: torch.Tensor) -> torch.Tensor:
    return wide[:, PAD[0]:wide.shape[1] - PAD[1]]


def _cotangents(proj, alive: torch.Tensor, seed: int):
    """Seeded cotangents of the float fields: zero on the dead slots (as
    the render's are: it reads no invisible slot) and on a tenth of the
    alive ones."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    n = alive.shape[0]
    live = alive.cpu() & (torch.rand(n, generator=g) > 0.1)
    out = []
    for f in FIELDS_F:
        x = getattr(proj, f)
        c = torch.randn(x.shape, generator=g)
        c = c * live.reshape((n,) + (1,) * (c.dim() - 1))
        out.append(c.to(x.device))
    return out


def _grad(proj, block, cts):
    return torch.autograd.grad([getattr(proj, f) for f in FIELDS_F], [block],
                               grad_outputs=cts)[0]


# ------------------------------------------------------------- on the CPU

def test_cpu_runs_the_twin():
    wide, alive, _ = _scene(3)
    cam = make_camera(np.eye(3), np.zeros(3), FOV, FOV, S, S, device="cpu")
    block = _slice(torch.tensor(wide)).requires_grad_(True)
    al = torch.tensor(alive)
    before = (project.preprocess_fwd.launches,
              project.preprocess_bwd.launches)
    kw = dict(sh_degree=3, active_sh_degree=3, antialiasing=True, alive=al,
              mask_degree=torch.tensor(2))
    got = project.preprocess_packed(block, cam, **kw)
    want = project.preprocess_packed_plain(block, cam, **kw)
    for f in project.Projected._fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    cts = _cotangents(got, al, 1)
    assert torch.equal(_grad(got, block, cts), _grad(want, block, cts))
    assert (project.preprocess_fwd.launches,
            project.preprocess_bwd.launches) == before
    with pytest.raises(ValueError, match="run on cuda"):
        project.preprocess_fwd(block, [], al, None, None, project._Static(
            3, 3, False, S, S))


@pytest.mark.parametrize("device,sh_degree,override,cov3d,engages", [
    ("cuda", 3, False, False, True),
    ("cuda", 0, False, False, True),
    ("cuda", 3, True, False, False),
    ("cuda", 3, False, True, False),
    ("cuda", 4, False, False, "raises"),
    ("cuda", 4, True, False, False),
    ("cpu", 3, False, False, False),
    ("cpu", 4, False, False, False),
])
def test_the_kernel_engages_on_cuda_without_overrides(device, sh_degree,
                                                      override, cov3d,
                                                      engages):
    x = torch.zeros(1)
    args = (torch.device(device), sh_degree, x if override else None,
            x if cov3d else None)
    if engages == "raises":
        # a degree the kernels lack is refused, not left to the twin
        with pytest.raises(ValueError, match="SH degrees up to 3"):
            project.uses_kernel(*args)
    else:
        assert project.uses_kernel(*args) == engages


@pytest.mark.parametrize("sh_degree,mask", [
    (d, m) for d in range(4) for m in range(d + 1)])
def test_mask_degree_is_mask_sh_rows_then_the_unmasked_call(sh_degree, mask):
    wide, alive, _ = _scene(sh_degree, seed=sh_degree)
    cam = make_camera(np.eye(3), np.zeros(3), FOV, FOV, S, S, device="cpu")
    block = _slice(torch.tensor(wide)).requires_grad_(True)
    al = torch.tensor(alive)
    kw = dict(sh_degree=sh_degree, active_sh_degree=sh_degree, alive=al)
    # an int degree, and a 0-d tensor as the train step and the view pass it
    degree = mask if mask % 2 else torch.tensor(mask)
    got = project.preprocess_packed(block, cam, mask_degree=degree, **kw)
    masked = pk.mask_sh_rows(block, pk.layout(sh_degree), mask)
    want = project.preprocess_packed(masked, cam, **kw)
    for f in project.Projected._fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    cts = _cotangents(got, al, 2)
    g = _grad(got, block, cts)
    assert torch.equal(g, _grad(want, block, cts))
    rest = pk.layout(sh_degree).sh_rest
    assert not g[rest + 3 * ((mask + 1) ** 2 - 1):
                 pk.layout(sh_degree).log_scale].any()


def test_packed_view_is_the_tree_view_on_cpu():
    """Through ViewGraph's body on the CPU the packed block takes the
    kernel pair's path (preprocess_packed, its ramp as mask_degree) and
    the tree layout render(): the same frame, bitwise, whatever the pose,
    SH degree and scaling_modifier; and a debug switch still unpacks."""
    wide, alive, _ = _scene(2, seed=5, n=200)
    block = torch.tensor(wide[:, PAD[0]:PAD[0] + 200]).contiguous()
    tree = pk.unpack_params(block, 2)
    al = torch.tensor(alive)
    bg = torch.tensor([0.1, 0.2, 0.3])
    kw = dict(alive=al, active_sh_degree=2, antialiasing=True,
              dup_capacity=1 << 14, max_per_tile=512, chunk=32)
    graph = ViewGraph()
    for roll, sm, deg in ((math.pi / 4, 1.0, 2), (0.3, 1.0, 2),
                          (0.3, 0.7, 1), (0.3, 1.0, 0)):
        cam = _camera("cpu", roll=roll)
        got = graph(cam, block, bg, sh_degree=deg, scaling_modifier=sm, **kw)
        masked = GaussianParams(*tree)._replace(
            sh_rest=tree.sh_rest * (torch.arange(1, 9) < (deg + 1) ** 2)[
                None, :, None].float())
        want = render(cam, masked, bg, scaling_modifier=sm, **kw)
        for f in ("image", "invdepth", "final_T", "radii", "visibility"):
            assert torch.equal(getattr(got, f), getattr(want, f)), (roll, f)
        assert float(got.image.abs().sum()) > 0
    got = graph(cam, block, bg, sh_degree=0, compute_cov3D_python=True, **kw)
    assert torch.allclose(got.image, want.image, atol=1e-5)


# ------------------------------------------------------------- on the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _same(a, b) -> bool:
    """Bitwise, NaN where NaN (the zero-determinant slot's opacity under
    antialiasing is NaN, as the twin's)."""
    a, b = a.detach(), b.detach()
    if a.is_floating_point():
        return (torch.equal(a.isnan(), b.isnan())
                and torch.equal(a.nan_to_num(), b.nan_to_num()))
    return torch.equal(a, b)


def _row_groups(sh_degree: int) -> dict:
    lay = pk.layout(sh_degree)
    return {"xyz": (0, 3), "sh_dc": (3, 6), "sh_rest": (6, lay.log_scale),
            "log_scale": (lay.log_scale, lay.quat),
            "quat": (lay.quat, lay.logit_opacity),
            "logit": (lay.logit_opacity, lay.n_channels)}


def _close(got, want, rel, what):
    """NaN where the reference has NaN, elsewhere within rel of the
    reference's largest finite magnitude."""
    got, want = got.detach().double().cpu(), want.detach().double().cpu()
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan), what
    if bool(nan.all()):     # all NaN, or empty (no sh_rest at degree 0)
        return
    scale = float(want[~nan].abs().max())
    err = float((got[~nan] - want[~nan]).abs().max())
    assert err <= rel * scale or err == 0.0, (what, err, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("antialiasing", [False, True], ids=["aa0", "aa1"])
@pytest.mark.parametrize("sh_degree,mask", [
    (d, m) for d in range(4) for m in sorted({max(d - 1, 0), d})])
def test_kernel_pair_matches_its_twin(sh_degree, mask, antialiasing,
                                      cuda_device):
    dev = cuda_device
    wide, alive, special = _scene(sh_degree, seed=10 + sh_degree)
    cam = _camera(dev)
    block = _slice(torch.tensor(wide, device=dev)).requires_grad_(True)
    al = torch.tensor(alive, device=dev)
    kw = dict(sh_degree=sh_degree, active_sh_degree=sh_degree,
              antialiasing=antialiasing, alive=al,
              mask_degree=torch.tensor(mask, device=dev))
    launches = (project.preprocess_fwd.launches,
                project.preprocess_bwd.launches)
    got = project.preprocess_packed(block, cam, **kw)
    want = project.preprocess_packed_plain(block, cam, **kw)
    torch.cuda.synchronize()
    # the specials are what the scene says they are, on the twin's word
    z = special["zero_det"]
    assert int(want.radius[z]) == 0 and not bool(want.conic[z].any())
    assert bool(want.visible.any()) and bool((want.radius_cull == 0).any())
    for f in FIELDS_I:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    for f in FIELDS_F:
        g, w = getattr(got, f), getattr(want, f)
        _close(g[al], w[al], 1e-6, f)
        assert not bool(g[~al].any()), f
    cts = _cotangents(got, al, 3)
    g1 = _grad(got, block, cts)
    g2 = _grad(project.preprocess_packed(block, cam, **kw), block, cts)
    gw = _grad(want, block, cts)
    torch.cuda.synchronize()
    assert (project.preprocess_fwd.launches,
            project.preprocess_bwd.launches) == (launches[0] + 2,
                                                 launches[1] + 2)
    assert _same(g1, g2)
    lay = pk.layout(sh_degree)
    assert not bool(g1[lay.n_channels:].any())
    assert not bool(g1[3 + 3 * (mask + 1) ** 2:lay.log_scale].any())
    n = al.shape[0]
    specials = [special["near_plane"], special["centre"], z]
    ordinary = torch.ones(n, dtype=torch.bool)
    ordinary[specials] = False
    ordinary[special["behind"]] = False
    sets = {"ordinary": ordinary, "behind": special["behind"]}
    sets.update({k: [special[k]] for k in ("near_plane", "centre",
                                           "zero_det")})
    for name, (a, b) in _row_groups(sh_degree).items():
        for sname, cols in sets.items():
            _close(g1[a:b, cols], gw[a:b, cols], 2e-4, (name, sname))


@pytest.mark.cuda
def test_graph_replay_takes_camera_and_mask(cuda_device):
    from gs_tpu_torch.utils.cuda_graphs import capture, replay
    dev = cuda_device
    wide, alive, _ = _scene(3, seed=21)
    block = _slice(torch.tensor(wide, device=dev))
    al = torch.tensor(alive, device=dev)
    cams = [_camera(dev), _camera(dev, z_shift=0.5, roll=0.2)]
    static = _camera(dev)
    mask = torch.tensor(3, device=dev)
    kw = dict(sh_degree=3, active_sh_degree=3, antialiasing=True, alive=al)
    probe = project.preprocess_packed(block, cams[0], **kw)
    cts = _cotangents(probe, al, 4)
    out = {}

    def body():
        leaf = block.detach().requires_grad_(True)
        proj = project.preprocess_packed(leaf, static, mask_degree=mask, **kw)
        out["proj"], out["grad"] = proj, _grad(proj, leaf, cts)

    cap = capture(dev, body, body, "preprocess pair")
    counters = (project.preprocess_fwd, project.preprocess_bwd)
    for cam, deg in ((cams[1], 1), (cams[0], 2)):
        for k in project.CAMERA_TENSORS:
            getattr(static, k).copy_(getattr(cam, k))
        mask.fill_(deg)
        before = [f.launches for f in counters]
        replay(cap.graph, cap.counts)
        torch.cuda.synchronize()
        assert [f.launches - b for f, b in zip(counters, before)] == [1, 1]
        leaf = block.detach().requires_grad_(True)
        eager = project.preprocess_packed(leaf, cam, mask_degree=deg, **kw)
        for f in project.Projected._fields:
            assert _same(getattr(out["proj"], f), getattr(eager, f)), (deg, f)
        assert _same(out["grad"], _grad(eager, leaf, cts)), deg
