"""The raster backward K3 and the grad variant K1g of the forward.

K3 writes entry e's 10 gradients as row ``dest[e]`` of a [D, 10] array
(``dest`` a permutation: the render passes the tile sort's, each entry's
position before the sort). On the CPU: K3's plain version, its rows moved
back by ``dest`` and transposed, against the JAX package's Pallas VJP
(``rasterize_pallas._raster_tiles`` in interpret mode) and against torch
autograd of the plain forward, on hand-built tiles — a translucent case,
an opaque case where pixels stop, and tiles that share 128-entry chunks —
at the JAX package's gradient rule, 2e-4 * max per feature row
(tests/test_golden.py:75-81); ``dest`` moves rows and changes no bit.
K1g's residual against a numpy walk of each pixel's entries. On a card
(marker ``cuda``): K1g's image bitwise equal to K1's, its residual equal
to the plain one, and K3 with a random ``dest`` against its plain version
and bitwise from run to run, on the hand-built tiles and on the
adversarial scenes of test_torch_raster_cull.py."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from gs_tpu.ops.rasterize_pallas import _raster_tiles, _Statics

from gs_tpu_torch.ops import rasterize as trast

from test_torch_raster_cull import SCENES, scene_tensors

GX, GY = 3, 2
MAX_CHUNKS = 8
# tile ranges: tiles 0-2 share chunk 0, tile 3 spans two chunks, tile 4 is
# empty, tile 5 starts mid-chunk; the tail past 700 is the padding
RANGES = [(0, 30), (30, 75), (75, 140), (140, 460), (460, 460), (460, 700)]
D = 768


def hand_built(seed, opaque):
    """[10, D] entries: each tile's Gaussians centred in or near it, with
    positive-definite conics; ``opaque`` makes them wide and near 0.99, so
    pixels reach T < 1e-4 and stop."""
    rng = np.random.default_rng(seed)
    f = np.zeros((10, D), np.float32)
    for t, (s, e) in enumerate(RANGES):
        n = e - s
        ox, oy = (t % GX) * 16, (t // GX) * 16
        f[0, s:e] = ox + rng.uniform(-6, 22, n)
        f[1, s:e] = oy + rng.uniform(-6, 22, n)
        sig = rng.uniform(2.0, 6.0, (n, 2)) * (2.0 if opaque else 0.7)
        rho = rng.uniform(-0.6, 0.6, n)
        det = (sig[:, 0] * sig[:, 1]) ** 2 * (1 - rho ** 2)
        f[2, s:e] = sig[:, 1] ** 2 / det
        f[3, s:e] = -rho * sig[:, 0] * sig[:, 1] / det
        f[4, s:e] = sig[:, 0] ** 2 / det
        f[5, s:e] = (rng.uniform(0.9, 1.0, n) if opaque
                     else rng.uniform(0.02, 0.3, n))
        f[6:9, s:e] = rng.uniform(0, 1, (3, n))
        f[9, s:e] = rng.uniform(0.1, 0.5, n)
    ts = np.array([r[0] for r in RANGES], np.int32)
    te = np.array([r[1] for r in RANGES], np.int32)
    dout = rng.normal(0, 1, (len(RANGES), 5, 256)).astype(np.float32)
    return f, ts, te, dout


STATICS = _Statics(num_tiles=len(RANGES), gx=GX, tile_x=16, tile_y=16,
                   max_chunks=MAX_CHUNKS, interpret=True, tiles_per_program=4)


@jax.jit
def _jax_out_and_vjp(feats, ts, te, d8):
    # jitted once for the cases' shared shapes: the interpreted kernel pair
    # compiles once per file instead of once per call
    fn = lambda x: _raster_tiles(x, ts, te, jnp.zeros((1,), jnp.int32),
                                 STATICS)
    out, vjp = jax.vjp(fn, feats)
    return out, vjp(d8)[0]


def jax_vjp(f, ts, te, dout):
    """The Pallas kernel pair's gradient of sum(out * dout): the port's
    rows (r, g, b, invdepth, final T) are the kernel's rows 0-3 and 5."""
    feats = jnp.concatenate([jnp.asarray(f), jnp.zeros((6, D), jnp.float32)])
    d8 = np.zeros((len(ts), 8, 256), np.float32)
    d8[:, 0:4] = dout[:, 0:4]
    d8[:, 5] = dout[:, 4]
    out, dfeats = _jax_out_and_vjp(feats, jnp.asarray(ts), jnp.asarray(te),
                                   jnp.asarray(d8))
    return np.asarray(out), np.asarray(dfeats)[:10]


def port_inputs(f, ts, te, device="cpu"):
    return (torch.tensor(f, device=device), torch.tensor(ts, device=device),
            torch.tensor(te, device=device), GX, MAX_CHUNKS)


def random_dest(d, seed, device="cpu"):
    """A seeded permutation of [0, d) for K3's ``dest``."""
    return torch.tensor(np.random.default_rng(seed).permutation(d),
                        dtype=torch.int32, device=device)


def sorted_rows(got, dest):
    """K3's [D, 10] output moved back to the entries' order, as [10, D]."""
    return got[dest.to(torch.int64)].T


def assert_grads_match(got, ref, what):
    for r in range(10):
        scale = max(float(np.abs(ref[r]).max()), 1e-6)
        err = float(np.abs(got[r] - ref[r]).max())
        assert err <= 2e-4 * scale, f"{what}: feature row {r}: {err} > 2e-4 * {scale}"


@pytest.mark.parametrize("opaque", [False, True], ids=["translucent", "opaque"])
def test_bwd_plain_matches_jax_vjp_and_autograd(opaque):
    f, ts, te, dout = hand_built(3 + opaque, opaque)
    args = port_inputs(f, ts, te)
    out, last = trast.raster_tiles_fwd_save(*args)
    jout, jgrad = jax_vjp(f, ts, te, dout)
    np.testing.assert_allclose(out[:, :4].numpy(), jout[:, :4], atol=2e-5)
    np.testing.assert_allclose(out[:, 4].numpy(), jout[:, 5], atol=2e-5)
    stopped = float((out[:, 4] < 2e-4).float().mean())
    assert (stopped > 0.2) == opaque, stopped

    dest = random_dest(D, 7 + opaque)
    got = trast.raster_tiles_bwd(*args, out, last, torch.tensor(dout), dest)
    assert got.shape == (D, 10)
    got = sorted_rows(got, dest).numpy()
    assert float(np.abs(got[:, 700:]).max()) == 0.0    # the padding tail
    assert_grads_match(got, jgrad, "plain vs Pallas VJP")

    feats = args[0].clone().requires_grad_(True)
    fwd = trast.raster_tiles_fwd_plain(feats, *args[1:])
    (ref,) = torch.autograd.grad((fwd * torch.tensor(dout)).sum(), feats)
    assert_grads_match(got, ref.numpy(), "plain vs autograd")


def test_bwd_dest_only_moves_rows():
    """With ``dest`` the identity K3's output is the [D, 10] rows in the
    entries' order (the transposed [10, D] gradients of ``feats``),
    bitwise; any other permutation moves those rows and changes no bit."""
    f, ts, te, dout = hand_built(3, False)
    args = port_inputs(f, ts, te)
    out, last = trast.raster_tiles_fwd_save(*args)
    d = torch.tensor(dout)
    rows = trast.raster_tiles_bwd_sorted_plain(*args, out, last, d)
    ident = torch.arange(D, dtype=torch.int32)
    assert torch.equal(trast.raster_tiles_bwd(*args, out, last, d, ident),
                       rows)
    dest = random_dest(D, 9)
    got = trast.raster_tiles_bwd(*args, out, last, d, dest)
    assert torch.equal(got[dest.to(torch.int64)], rows)
    with pytest.raises(ValueError):
        trast.raster_tiles_bwd(*args, out, last, d, dest.to(torch.int64))
    with pytest.raises(ValueError):
        trast.raster_tiles_bwd(*args, out, last, d, dest[:-1])


def numpy_last(f, ts, te):
    """One past the last entry each pixel composites: the sequential walk
    of csrc/rasterize_fwd.cu in float64."""
    last = np.zeros((len(ts), 256), np.int64)
    p = np.arange(256)
    for t, (s, e) in enumerate(zip(ts, te)):
        px = (t % GX) * 16 + p % 16
        py = (t // GX) * 16 + p // 16
        T = np.ones(256)
        live = np.ones(256, bool)
        last[t] = s
        for j in range(s, e):
            dx, dy = f[0, j] - px, f[1, j] - py
            power = -0.5 * (f[2, j] * dx * dx + f[4, j] * dy * dy) - f[3, j] * dx * dy
            alpha = np.minimum(0.99, f[5, j] * np.exp(np.minimum(power, 0)))
            hit = live & (power <= 0) & (alpha >= 1 / 255)
            stop = hit & (T * (1 - alpha) < 1e-4)
            live &= ~stop
            comp = hit & ~stop
            T = np.where(comp, T * (1 - alpha), T)
            last[t] = np.where(comp, j + 1, last[t])
    return last


@pytest.mark.parametrize("opaque", [False, True], ids=["translucent", "opaque"])
def test_fwd_save_residual(opaque):
    f, ts, te, _ = hand_built(3 + opaque, opaque)
    args = port_inputs(f, ts, te)
    out, last = trast.raster_tiles_fwd_save(*args)
    assert last.dtype == torch.int32 and last.shape == (len(ts), 256)
    torch.testing.assert_close(out, trast.raster_tiles_fwd(*args), rtol=0, atol=0)
    ref = numpy_last(f, ts, te)
    # float64 against float32 may flip a pixel at the T < 1e-4 cut
    assert (last.numpy() != ref).mean() < 2e-3
    assert (last.numpy() == np.array(ts)[:, None]).any()   # pixels that miss


def test_bwd_work_counts_what_the_loop_visits():
    f, ts, te, _ = hand_built(5, True)
    args = port_inputs(f, ts, te)
    _, last = trast.raster_tiles_fwd_save(*args)
    work = trast.raster_tiles_bwd_work(*args, last)
    ref = numpy_last(f, ts, te)
    assert work["composited"] > 0 and work["faint"] > 0 and work["culled"] == 0
    assert work["composited"] + work["faint"] == int(
        (ref - np.array(ts)[:, None]).sum())
    assert work["ops"] == sum(trast.K3_OPS[k] * work[k] for k in trast.K3_OPS)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("opaque", [False, True], ids=["translucent", "opaque"])
def test_cuda_fwd_save_is_bitwise_k1(cuda_device, opaque):
    f, ts, te, _ = hand_built(3 + opaque, opaque)
    args = port_inputs(f, ts, te, cuda_device)
    out, last = trast.raster_tiles_fwd_save(*args)
    ref = trast.raster_tiles_fwd(*args)
    torch.cuda.synchronize()
    assert torch.equal(out, ref)
    _, plain_last = trast.raster_tiles_fwd_plain(*args, save=True)
    assert (last != plain_last).float().mean() < 2e-3


@pytest.mark.cuda
@pytest.mark.parametrize("opaque", [False, True], ids=["translucent", "opaque"])
def test_cuda_bwd_matches_plain(cuda_device, opaque):
    f, ts, te, dout = hand_built(3 + opaque, opaque)
    args = port_inputs(f, ts, te, cuda_device)
    out, last = trast.raster_tiles_fwd_save(*args)
    d = torch.tensor(dout, device=cuda_device)
    dest = random_dest(D, 7 + opaque, cuda_device)
    got = trast.raster_tiles_bwd(*args, out, last, d, dest)
    torch.cuda.synchronize()
    ref = trast.raster_tiles_bwd_plain(*args, out, last, d, dest)
    assert_grads_match(got.T.cpu().numpy(), ref.T.cpu().numpy(),
                       "K3 vs plain")
    again = trast.raster_tiles_bwd(*args, out, last, d, dest)
    assert torch.equal(got, again)          # one writer per value


@pytest.mark.cuda
@pytest.mark.parametrize("kind", SCENES)
def test_cuda_adversarial_scenes(cuda_device, kind):
    """K1g bitwise K1 and within the backends' image rule of its plain
    version, its residual the plain one's but for pixels at the T < 1e-4
    cut; K3 within the gradient rule of its plain version and bitwise from
    run to run."""
    args, d = scene_tensors(kind, cuda_device)
    out, last = trast.raster_tiles_fwd_save(*args)
    assert torch.equal(out, trast.raster_tiles_fwd(*args))
    plain_out, plain_last = trast.raster_tiles_fwd_plain(*args, save=True)
    diff = (out - plain_out).abs()
    assert float(diff.max()) < 2e-2
    assert float((diff > 1e-5).float().mean()) < 2e-3
    assert float((last != plain_last).float().mean()) < 2e-3
    dest = random_dest(args[0].shape[1], 11, cuda_device)
    got = trast.raster_tiles_bwd(*args, out, last, d, dest)
    ref = trast.raster_tiles_bwd_plain(*args, out, last, d, dest)
    assert_grads_match(got.T.cpu().numpy(), ref.T.cpu().numpy(),
                       f"K3 on {kind}")
    assert torch.equal(got, trast.raster_tiles_bwd(*args, out, last, d, dest))
