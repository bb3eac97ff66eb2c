"""The tile rasterizers' two skips (csrc/raster.cuh), through their PyTorch
twins in gs_tpu_torch/ops/rasterize.py: the warp-block skip
(``block_misses``, ``block_cull_plain``) and the per-pair pre-filter
(``faint_by_power``) must never drop an (entry, pixel) pair whose plain
alpha (ops/composite.py) is >= 1/255. Checked with hypothesis over single
entries (near-degenerate and indefinite conics, opacities around 1/255 and
1, means inside, on the edge of and outside a block) and over whole
adversarial scenes, which the card tests in test_torch_raster_bwd.py and
test_torch_render.py also run through the kernels. The factored
``quad_min_rect`` is pinned to the binning cull's former inline code."""
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from gs_tpu_torch.ops import rasterize as trast
from gs_tpu_torch.ops.binning import quad_min_rect
from gs_tpu_torch.ops.composite import ALPHA_MIN, splat_alpha, splat_power

TILE_X, TILE_Y = 3, 2          # the tile the single-entry checks place


def binning_inline_qmin(ex, ey, ca, cb, cc, t_col, t_row, tile=16):
    """ops/binning.py's exact-cull quadratic minimum as it was written
    inline before it was factored out."""
    ca = ca + 1e-20
    cc = cc + 1e-20
    dx0 = (t_col * tile - 1).to(torch.float32) - ex
    dx1 = (t_col * tile + tile).to(torch.float32) - ex
    dy0 = (t_row * tile - 1).to(torch.float32) - ey
    dy1 = (t_row * tile + tile).to(torch.float32) - ey

    def q(dx, dy):
        return ca * dx * dx + 2.0 * cb * dx * dy + cc * dy * dy

    def clip(x, lo, hi):
        return torch.minimum(torch.maximum(x, lo), hi)

    cx0 = clip(-cb * dy0 / ca, dx0, dx1)
    cx1 = clip(-cb * dy1 / ca, dx0, dx1)
    cy0 = clip(-cb * dx0 / cc, dy0, dy1)
    cy1 = clip(-cb * dx1 / cc, dy0, dy1)
    qmin = torch.minimum(torch.minimum(q(cx0, dy0), q(cx1, dy1)),
                         torch.minimum(q(dx0, cy0), q(dx1, cy1)))
    inside = (dx0 <= 0) & (dx1 >= 0) & (dy0 <= 0) & (dy1 >= 0)
    return torch.where(inside, 0.0, qmin)


def test_quad_min_rect_is_the_binning_cull_bitwise():
    rng = np.random.default_rng(0)
    n = 20_000
    t_col = torch.tensor(rng.integers(0, 20, n), dtype=torch.int32)
    t_row = torch.tensor(rng.integers(0, 12, n), dtype=torch.int32)
    f = lambda a: torch.tensor(a, dtype=torch.float32)
    ex = f(t_col.numpy() * 16 + rng.uniform(-40, 56, n))
    ey = f(t_row.numpy() * 16 + rng.uniform(-40, 56, n))
    ca, cc = f(rng.uniform(-0.5, 3.4, n)), f(rng.uniform(-0.5, 3.4, n))
    cb = f(rng.uniform(-2, 2, n))
    ca[:50] = float("nan")
    cb[50:100] = 0.0
    ref = binning_inline_qmin(ex, ey, ca, cb, cc, t_col, t_row)
    got = quad_min_rect(ex, ey, ca, cb, cc,
                        (t_col * 16 - 1).to(torch.float32),
                        (t_col * 16 + 16).to(torch.float32),
                        (t_row * 16 - 1).to(torch.float32),
                        (t_row * 16 + 16).to(torch.float32))
    torch.testing.assert_close(got, ref, rtol=0, atol=0, equal_nan=True)


def pixel_blocks():
    """Pixel coordinates of the tile at (TILE_X, TILE_Y) and each pixel's
    8x4 block, in the [256] layout (pixel (x, y) at y * 16 + x)."""
    p = torch.arange(256)
    x, y = p % 16, p // 16
    return (TILE_X * 16 + x).float(), (TILE_Y * 16 + y).float(), \
        (y // 4) * 2 + x // 8


def block_origins():
    w = torch.arange(8)
    return TILE_X * 16 + (w % 2) * 8, TILE_Y * 16 + (w // 2) * 4


def assert_skips_conservative(packets):
    """packets [G, 10]: no pair of the tile at (TILE_X, TILE_Y) with plain
    alpha >= 1/255 lies in a skipped block or is pre-filtered."""
    px, py, block = pixel_blocks()
    alpha = splat_alpha(packets, px, py)                       # [G, 256]
    power = splat_power(packets, px, py)
    x0, y0 = block_origins()
    miss = trast.block_misses(packets.T[..., None], x0, y0)     # [G, 8]
    cut = trast.entry_cut(packets[:, 5:6])
    composited = alpha >= ALPHA_MIN
    bad_block = composited & miss[:, block]
    assert not bool(bad_block.any()), packets[bad_block.any(1)]
    bad_pair = composited & trast.faint_by_power(power, cut)
    assert not bool(bad_pair.any()), packets[bad_pair.any(1)]
    return miss, composited


def packet(mean, conic, opacity):
    row = torch.zeros(10)
    row[0:2] = torch.tensor(mean, dtype=torch.float32)
    row[2:5] = torch.tensor(conic, dtype=torch.float32)
    row[5] = float(np.float32(opacity))
    return row


# means relative to the tile's origin: anywhere from well outside to well
# inside, with the block edges (0, 8, 16 across, 0, 4, 8, 12, 16 down) and
# their one-pixel dilations drawn often
_edges = [-1.0, -0.5, 0.0, 3.0, 4.0, 7.0, 7.5, 8.0, 9.0, 15.0, 16.0, 17.0]
offsets = st.one_of(st.floats(-80, 96, width=32), st.sampled_from(_edges),
                    st.sampled_from(_edges).map(lambda e: e + 1e-3))
opacities = st.one_of(
    st.floats(0.0, 1.0, width=32),
    st.floats(1 / 255 * (1 - 1e-3), 1 / 255 * (1 + 1e-3)),
    st.sampled_from([float(np.float32(1 / 255)),
                     float(np.nextafter(np.float32(1 / 255), np.float32(1))),
                     float(np.nextafter(np.float32(1 / 255), np.float32(0))),
                     1.0, 0.99, float(np.nextafter(np.float32(1), np.float32(0)))]))


@st.composite
def conics(draw):
    """A projected conic (the inverse of a covariance, with or without the
    0.3 px low-pass, up to 10^5 : 1 elongated), or a raw (a, b, c) that may
    be indefinite or degenerate."""
    if draw(st.booleans()):
        s1 = draw(st.floats(-3.0, 5.0))
        s2 = draw(st.floats(-3.0, 5.0))
        th = draw(st.floats(0.0, np.pi))
        lowpass = draw(st.sampled_from([0.0, 0.3]))
        c, s = np.cos(th), np.sin(th)
        R = np.array([[c, -s], [s, c]])
        cov = R @ np.diag([10 ** s1, 10 ** s2]) @ R.T + lowpass * np.eye(2)
        inv = np.linalg.inv(cov)
        return float(inv[0, 0]), float(inv[0, 1]), float(inv[1, 1])
    a = draw(st.floats(-4.0, 4.0, width=32))
    c = draw(st.floats(-4.0, 4.0, width=32))
    if draw(st.booleans()):
        # det = a c - b^2 at or near zero, either side
        b = float(np.sqrt(abs(a * c))) * draw(st.sampled_from([1.0, 1 - 1e-6,
                                                               1 + 1e-6]))
        b = b * draw(st.sampled_from([1.0, -1.0]))
    else:
        b = draw(st.floats(-4.0, 4.0, width=32))
    return a, b, c


@settings(max_examples=400, deadline=None, derandomize=True)
@given(dx=offsets, dy=offsets, conic=conics(), opacity=opacities)
def test_skips_never_drop_a_composited_pair(dx, dy, conic, opacity):
    mean = (TILE_X * 16 + dx, TILE_Y * 16 + dy)
    assert_skips_conservative(packet(mean, conic, opacity)[None])


def test_skips_on_random_entries_and_they_do_skip():
    """A million-pair sweep of projected-like entries, and the skip's yield:
    it must drop most blocks of entries far from them and some near."""
    rng = np.random.default_rng(1)
    g = 4000
    sig = 10 ** rng.uniform(-0.5, 1.5, (g, 2))
    th = rng.uniform(0, np.pi, g)
    c, s = np.cos(th), np.sin(th)
    cov = np.empty((g, 2, 2))
    cov[:, 0, 0] = c * c * sig[:, 0] ** 2 + s * s * sig[:, 1] ** 2 + 0.3
    cov[:, 1, 1] = s * s * sig[:, 0] ** 2 + c * c * sig[:, 1] ** 2 + 0.3
    cov[:, 0, 1] = cov[:, 1, 0] = c * s * (sig[:, 0] ** 2 - sig[:, 1] ** 2)
    inv = np.linalg.inv(cov)
    pk = torch.zeros((g, 10))
    pk[:, 0] = torch.tensor(TILE_X * 16 + rng.uniform(-40, 56, g))
    pk[:, 1] = torch.tensor(TILE_Y * 16 + rng.uniform(-40, 56, g))
    pk[:, 2] = torch.tensor(inv[:, 0, 0])
    pk[:, 3] = torch.tensor(inv[:, 0, 1])
    pk[:, 4] = torch.tensor(inv[:, 1, 1])
    pk[:, 5] = torch.tensor(rng.uniform(0.0, 1.0, g))
    miss, composited = assert_skips_conservative(pk)
    _, _, block = pixel_blocks()
    reached = torch.zeros_like(miss)
    reached.index_put_((torch.arange(g)[:, None].expand(g, 256),
                        block.expand(g, 256)), composited, accumulate=True)
    # a block no pixel of which composites the entry: the skip should catch
    # most of them (the rest lie within the dilation and margin)
    unreached = ~reached
    assert float(miss.sum()) > 0.8 * float(unreached.sum()), (
        int(miss.sum()), int(unreached.sum()))


# ---------------------------------------------------------------- scenes

def _conic_rows(rng, n, sigma):
    sig = rng.uniform(*sigma, (n, 2))
    rho = rng.uniform(-0.6, 0.6, n)
    det = (sig[:, 0] * sig[:, 1]) ** 2 * (1 - rho ** 2)
    return (sig[:, 1] ** 2 / det, -rho * sig[:, 0] * sig[:, 1] / det,
            sig[:, 0] ** 2 / det)


def _fill(f, rng, s, e, tile, gx, sigma, opacity, spread=6.0, integer=False):
    n = e - s
    ox, oy = (tile % gx) * 16, (tile // gx) * 16
    if integer:       # means on pixel centres: alpha = opacity there
        f[0, s:e] = ox + rng.integers(0, 16, n)
        f[1, s:e] = oy + rng.integers(0, 16, n)
    else:
        f[0, s:e] = ox + rng.uniform(-spread, 16 + spread, n)
        f[1, s:e] = oy + rng.uniform(-spread, 16 + spread, n)
    f[2, s:e], f[3, s:e], f[4, s:e] = _conic_rows(rng, n, sigma)
    f[5, s:e] = opacity(n)
    f[6:9, s:e] = rng.uniform(0, 1, (3, n))
    f[9, s:e] = rng.uniform(0.1, 0.5, n)


SCENES = ("opacity-cut", "whole-tile", "long-window", "max-per-tile-960",
          "opaque")


def adversarial_scene(kind, seed=0):
    """(feats [10, D], tile_start, tile_end [T] int32, gx, max_chunks,
    dout [T, 5, 256]) as numpy arrays for the kernels' hard cases:
    - opacity-cut: opacities at and next to 1/255 on pixel-centred means;
    - whole-tile: one Gaussian much wider than its tile, in front of small
      ones, in each of four tiles;
    - long-window: a tile of 700 entries (three of K1's 256-entry batches,
      eleven of K3's 64);
    - max-per-tile-960: max_per_tile 960 (in [896, 1023]) and a tile of 950
      entries that starts late in its first 128-entry chunk;
    - opaque: wide opaque entries, most pixels stop before their last."""
    rng = np.random.default_rng(seed)
    gx, mpt = 2, 1024
    u = lambda lo, hi: (lambda n: rng.uniform(lo, hi, n))
    if kind == "opacity-cut":
        ranges = [(0, 150), (150, 300)]
        cut = np.float32(1 / 255)
        ops = np.array([cut, np.nextafter(cut, np.float32(1)),
                        np.nextafter(cut, np.float32(0)), cut * 1.001,
                        cut * 0.999, 0.3], np.float32)
        fill = [dict(sigma=(0.5, 6.0), opacity=lambda n: rng.choice(ops, n),
                     integer=True)] * 2
    elif kind == "whole-tile":
        ranges = [(0, 60), (60, 120), (120, 180), (180, 240)]
        fill = [dict(sigma=(1.0, 4.0), opacity=u(0.05, 0.5))] * 4
    elif kind == "long-window":
        ranges = [(0, 700), (700, 740)]
        fill = [dict(sigma=(2.0, 8.0), opacity=u(0.004, 0.03))] * 2
    elif kind == "max-per-tile-960":
        mpt = 960
        ranges = [(0, 100), (100, 1050), (1050, 1060)]
        fill = [dict(sigma=(1.0, 6.0), opacity=u(0.002, 0.02))] * 3
    elif kind == "opaque":
        ranges = [(0, 90), (90, 200), (200, 260), (260, 400)]
        fill = [dict(sigma=(4.0, 12.0), opacity=u(0.9, 1.0))] * 4
    else:
        raise ValueError(kind)
    num_tiles = -(-len(ranges) // gx) * gx
    ranges = ranges + [(ranges[-1][1],) * 2] * (num_tiles - len(ranges))
    d = -(-(ranges[-1][1] + 40) // 128) * 128          # a padding tail
    f = np.zeros((10, d), np.float32)
    for t, ((s, e), kw) in enumerate(zip(ranges, fill)):
        _fill(f, rng, s, e, t, gx, **kw)
    if kind == "whole-tile":
        for t, (s, _) in enumerate(ranges[:4]):
            f[0, s], f[1, s] = (t % gx) * 16 + 7.5, (t // gx) * 16 + 7.5
            f[2, s], f[3, s], f[4, s] = 1 / 200.0 ** 2, 0.0, 1 / 150.0 ** 2
            f[5, s] = 0.6
    ts = np.array([r[0] for r in ranges], np.int32)
    te = np.array([r[1] for r in ranges], np.int32)
    dout = rng.normal(0, 1, (num_tiles, 5, 256)).astype(np.float32)
    return f, ts, te, gx, trast.max_chunks_for(mpt), dout


def scene_tensors(kind, device="cpu"):
    f, ts, te, gx, mc, dout = adversarial_scene(kind)
    return ((torch.tensor(f, device=device), torch.tensor(ts, device=device),
             torch.tensor(te, device=device), gx, mc),
            torch.tensor(dout, device=device))


@pytest.mark.parametrize("kind", SCENES)
def test_block_cull_on_adversarial_scenes(kind):
    """Every composited pair of the scene (plain alpha >= 1/255 inside its
    tile's window) lies in a block block_cull_plain keeps, and the skip
    counts agree with it."""
    args, _ = scene_tensors(kind)
    feats, ts, te, gx, mc = args
    culled = trast.block_cull_plain(*args)
    assert culled.shape == (8, feats.shape[1])
    p = torch.arange(256)
    block = (p // 16 // 4) * 2 + (p % 16) // 8
    for t in range(ts.shape[0]):
        s, e = int(ts[t]), int(te[t])
        e = min(e, s // 128 * 128 + mc * 128)
        if e == s:
            continue
        px = ((t % gx) * 16 + p % 16).float()
        py = ((t // gx) * 16 + p // 16).float()
        alpha = splat_alpha(feats[:, s:e].T, px, py)             # [n, 256]
        assert not bool(((alpha > 0) & culled[:, s:e].T[:, block]).any()), t
    assert not bool(culled[:, int(te[-1]):].any())              # padding
    counts = trast.block_skip_counts(*args)
    assert counts["skipped"] == int(culled.sum())
    in_window = sum(min(int(e), int(s) // 128 * 128 + mc * 128) - int(s)
                    for s, e in zip(ts, te))
    assert counts["pairs"] == 8 * in_window


def test_block_skip_counts_behind_last():
    """With K1g's residual, only pairs in front of the block's largest
    `last` count, as K3's warps walk back from there."""
    args, _ = scene_tensors("opaque")
    _, last = trast.raster_tiles_fwd_save(*args)
    blast = trast.block_last(last)
    p = torch.arange(256)
    block = (p // 16 // 4) * 2 + (p % 16) // 8
    for w in range(8):
        torch.testing.assert_close(blast[:, w], last[:, block == w].amax(1))
    culled = trast.block_cull_plain(*args)
    ts = args[1]
    ref_pairs = ref_skipped = 0
    for t in range(ts.shape[0]):
        for w in range(8):
            s, e = int(ts[t]), int(blast[t, w])
            ref_pairs += e - s
            ref_skipped += int(culled[w, s:e].sum())
    counts = trast.block_skip_counts(*args, last=last)
    assert counts == {"pairs": ref_pairs, "skipped": ref_skipped}
    assert 0 < counts["skipped"] < counts["pairs"]


def test_adversarial_scenes_are_what_they_say():
    out = {}
    for kind in SCENES:
        args, _ = scene_tensors(kind)
        out[kind] = (args, trast.raster_tiles_fwd_plain(*args))
    (f, ts, te, _, _), img = out["opaque"]
    assert float((img[:, 4] < 2e-4).float().mean()) > 0.2       # pixels stop
    (f, ts, te, _, mc), _ = out["long-window"]
    assert int((te - ts).max()) > 2 * 256
    (f, ts, te, _, mc), _ = out["max-per-tile-960"]
    assert mc == trast.max_chunks_for(960) and int(ts[1]) % 128 == 100
    assert int(te[1] - ts[1]) == 950
    (f, ts, te, gx, _), _ = out["whole-tile"]
    p = torch.arange(256)
    for t in range(4):
        px, py = ((t % gx) * 16 + p % 16).float(), ((t // gx) * 16 + p // 16).float()
        alpha = splat_alpha(f[:, int(ts[t])][None], px, py)
        assert bool((alpha > 0.5).all())
    (f, ts, te, gx, _), _ = out["opacity-cut"]
    at_cut = f[5] == float(np.float32(1 / 255))
    assert int(at_cut.sum()) > 10
