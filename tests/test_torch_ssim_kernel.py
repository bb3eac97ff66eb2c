"""SSIM's kernel pair (``csrc/ssim.cu``, the wrappers ``ops/ssim.py::
ssim_fwd`` and ``ssim_bwd``) against its twins, ``ssim_plain`` (the
forward, differentiated by autograd) and ``ssim_backward_plain`` (the
backward's formula). JAX is imported only by the test that compares with
it, so the ``cuda`` cases run on the card with ``--noconftest``.

On the CPU:

* the backward's formula equals autograd's gradient through the twin and
  ``jax.grad`` of ``gs_tpu.ops.ssim.ssim``, within 2e-4 of the largest, on
  ragged shapes (37x53, 1x1, 5x300; one and three channels);
* ``ssim`` on CPU tensors is the twin, bit for bit, and launches nothing;
* the wrappers refuse another dtype, rank or device;
* serving views from a Trainer asks for no SSIM library.

On the card (``cuda``, skipped here), at garden's, playroom's and truck's
frames and a small odd shape:

* the kernels' value within 1e-6 of the twin's and its gradient within
  2e-4 of the largest of autograd's through the twin; the forward's maps
  and the backward's gradient against the plain formula;
* the same bits from run to run;
* the pair captured in a CUDA graph and replayed equals eager;
* one forward and one backward launch a differentiated call, one forward
  a call without a gradient;
* a second image that requires a gradient raises;
* the view's path, in a fresh process, neither launches the pair nor loads
  its library.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from gs_tpu_torch.ops import ssim as S

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RAGGED = [(c, h, w) for c in (1, 3) for h, w in ((37, 53), (1, 1), (5, 300))]
FRAMES = {"garden": (3, 840, 1297), "playroom": (3, 832, 1264),
          "truck": (3, 546, 979), "odd": (3, 37, 53)}


def _pair(shape, seed=0, device="cpu"):
    """Two images in [0, 1]: a smooth field with noise, and it perturbed."""
    rng = np.random.default_rng(seed)
    c, h, w = shape
    yy, xx = np.meshgrid(np.linspace(0, 6, h), np.linspace(0, 9, w),
                         indexing="ij")
    base = 0.5 + 0.3 * np.sin(xx + yy)[None] * rng.uniform(0.5, 1, (c, 1, 1))
    a = np.clip(base + rng.normal(0, 0.05, shape), 0, 1).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, shape), 0, 1).astype(np.float32)
    return (torch.tensor(a, device=device), torch.tensor(b, device=device))


def _autograd(img1, img2, g=1.0):
    """The twin's value and autograd's gradient in img1 of g x the value."""
    x = img1.clone().requires_grad_(True)
    value = S.ssim_plain(x, img2)
    (grad,) = torch.autograd.grad(value * g, x)
    return value.detach(), grad


def _close(got, want, rel=2e-4):
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    assert err <= rel * scale, (err, scale)


def _ids(shape):
    return "x".join(map(str, shape))


# ----------------------------------------------------------------- CPU

@pytest.mark.parametrize("shape", RAGGED, ids=[_ids(s) for s in RAGGED])
def test_backward_formula_is_autograds_gradient(shape):
    img1, img2 = _pair(shape, seed=sum(shape))
    g = torch.tensor(-0.2)
    _, want = _autograd(img1, img2, g)
    _close(S.ssim_backward_plain(g, img1, img2), want)


@pytest.mark.parametrize("shape", RAGGED, ids=[_ids(s) for s in RAGGED])
def test_backward_formula_is_jax_gradient(shape):
    import jax
    import jax.numpy as jnp
    from gs_tpu.ops.ssim import ssim as jax_ssim
    img1, img2 = _pair(shape, seed=7 + sum(shape))
    ref, jgrad = jax.value_and_grad(jax_ssim)(jnp.asarray(img1.numpy()),
                                              jnp.asarray(img2.numpy()))
    _close(S.ssim_backward_plain(torch.tensor(1.0), img1, img2),
           torch.tensor(np.asarray(jgrad)))
    assert abs(float(S.ssim_plain(img1, img2)) - float(ref)) < 1e-6


def test_cpu_tensors_run_the_twin_and_launch_nothing():
    img1, img2 = _pair((3, 37, 53))
    n = (S.ssim_fwd.launches, S.ssim_bwd.launches)
    x = img1.clone().requires_grad_(True)
    got = S.ssim(x, img2)
    (grad,) = torch.autograd.grad(got, x)
    want, want_grad = _autograd(img1, img2)
    assert torch.equal(got.detach(), want)
    assert torch.equal(grad, want_grad)
    assert torch.equal(S.ssim(img1, img2), S.ssim_plain(img1, img2))
    assert (S.ssim_fwd.launches, S.ssim_bwd.launches) == n


def _bad_inputs():
    img1, img2 = _pair((3, 8, 9))
    return {
        "dtype": (img1.double(), img2.double(), "float32"),
        "rank": (img1[0], img2[0], r"\[C, H, W\]"),
        "device": (img1, img2, "run on cuda"),
    }


@pytest.mark.parametrize("case", ("dtype", "rank", "device"))
def test_forward_wrapper_refuses(case):
    img1, img2, msg = _bad_inputs()[case]
    with pytest.raises(ValueError, match=msg):
        S.ssim_fwd(img1, img2, maps=True)


@pytest.mark.parametrize("case", ("dtype", "rank", "device"))
def test_backward_wrapper_refuses(case):
    img1, img2, msg = _bad_inputs()[case]
    maps = torch.zeros((3,) + tuple(img1.shape), dtype=img1.dtype)
    with pytest.raises(ValueError, match=msg):
        S.ssim_bwd(torch.tensor(1.0), img1, img2, maps)


def test_view_path_asks_for_no_ssim_library_on_cpu():
    from test_torch_adam_kernel import serve_views
    got = serve_views("cpu")
    assert got["sizes"] == [64 * 48 * 3] * 3
    assert S.SOURCE not in got["asked"]
    assert S.SOURCE not in got["loaded"]


# ---------------------------------------------------------------- card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (the SSIM kernels have no "
                    "CPU mode)")
    return torch.device("cuda")


def _kernel(img1, img2, g):
    """The pair through ``ssim``: value and gradient in img1 of g x it."""
    x = img1.clone().requires_grad_(True)
    value = S.ssim(x, img2)
    (grad,) = torch.autograd.grad(value * g, x)
    return value.detach(), grad


@pytest.mark.cuda
@pytest.mark.parametrize("frame", tuple(FRAMES))
def test_kernels_match_the_twin(frame, cuda_device):
    img1, img2 = _pair(FRAMES[frame], seed=23, device=cuda_device)
    g = torch.tensor(-0.2, device=cuda_device)
    value, grad = _kernel(img1, img2, g)
    want, want_grad = _autograd(img1, img2, g)
    assert abs(float(value) - float(want)) <= 1e-6
    _close(grad, want_grad)
    # the backward kernel against its own formula, and the forward's maps
    _close(grad, S.ssim_backward_plain(g, img1, img2))
    _, maps = S.ssim_fwd(img1, img2, maps=True)
    for got, ref in zip(maps, S._derivatives(*S._moments(img1, img2))):
        _close(got, ref, rel=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("frame", ("garden", "odd"))
def test_kernels_are_the_same_bits_from_run_to_run(frame, cuda_device):
    img1, img2 = _pair(FRAMES[frame], seed=5, device=cuda_device)
    g = torch.tensor(0.7, device=cuda_device)
    runs = [_kernel(img1, img2, g) for _ in range(3)]
    for value, grad in runs[1:]:
        assert torch.equal(value.view(torch.int32),
                           runs[0][0].view(torch.int32))
        assert torch.equal(grad.view(torch.int32),
                           runs[0][1].view(torch.int32))


@pytest.mark.cuda
def test_captured_pair_replays_as_eager(cuda_device):
    from gs_tpu_torch.utils.cuda_graphs import capture, replay
    dev = cuda_device
    img1, img2 = _pair(FRAMES["truck"], seed=9, device=dev)
    g = torch.tensor(-0.2, device=dev)
    want = _kernel(img1, img2, g)
    x = img2.clone()             # captured on other inputs than replayed
    out = {}

    def body():
        out["value"], out["grad"] = _kernel(x, img2, g)

    cap = capture(dev, body, body, "ssim")
    assert cap.counts[S.ssim_fwd] == 1 and cap.counts[S.ssim_bwd] == 1
    x.copy_(img1)
    before = (S.ssim_fwd.launches, S.ssim_bwd.launches)
    replay(cap.graph, cap.counts)
    torch.cuda.synchronize()
    assert (S.ssim_fwd.launches, S.ssim_bwd.launches) == (before[0] + 1,
                                                          before[1] + 1)
    assert torch.equal(out["value"], want[0])
    assert torch.equal(out["grad"], want[1])


@pytest.mark.cuda
def test_launches_count_each_call(cuda_device):
    img1, img2 = _pair(FRAMES["odd"], device=cuda_device)
    n = (S.ssim_fwd.launches, S.ssim_bwd.launches)
    _kernel(img1, img2, torch.tensor(1.0, device=cuda_device))
    assert (S.ssim_fwd.launches, S.ssim_bwd.launches) == (n[0] + 1, n[1] + 1)
    with torch.no_grad():
        S.ssim(img1.clone().requires_grad_(True), img2)
    S.ssim(img1, img2)
    assert (S.ssim_fwd.launches, S.ssim_bwd.launches) == (n[0] + 3, n[1] + 1)


@pytest.mark.cuda
def test_second_image_with_a_gradient_raises(cuda_device):
    img1, img2 = _pair(FRAMES["odd"], device=cuda_device)
    with pytest.raises(ValueError, match="img1 only"):
        S.ssim(img1.requires_grad_(True), img2.requires_grad_(True))


@pytest.mark.cuda
def test_view_path_runs_no_ssim_on_the_card(cuda_device):
    """In a fresh process, where no SSIM library is loaded yet."""
    code = ("import json, sys\n"
            f"sys.path[:0] = [{ROOT!r}, {os.path.join(ROOT, 'tests')!r}]\n"
            "from gs_tpu_torch.ops import ssim as S\n"
            "from test_torch_adam_kernel import serve_views\n"
            "got = serve_views('cuda')\n"
            "got['ssim'] = [S.ssim_fwd.launches, S.ssim_bwd.launches]\n"
            "print(json.dumps(got))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr
    got = json.loads(res.stdout.splitlines()[-1])
    assert got["sizes"] == [64 * 48 * 3] * 3
    assert got["ssim"] == [0, 0]
    assert S.SOURCE not in got["asked"]
    assert S.SOURCE not in got["loaded"]
