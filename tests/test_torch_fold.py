"""The gradient fold K4 (``ops/fold.py``) and the run-end segment sum
(``ops/segment.py``), against the JAX package's ``fold_rows`` (Pallas,
interpret mode) and ``segment_sum_runend``, in the cases of
tests/test_fold.py:20-50: empty runs, one huge run, a sentinel tail and
entries arriving tile-ordered; and in the shape of the RAIN-GS init's
second iteration (23 visible Gaussians among 1,024 slots, one covering the
1080p screen's 8,160 tiles). The port's fold takes the entries
entry-major, each Gaussian's as one run, the runs in any (here a seeded
depth) order, each sum scattered to its Gaussian's row; the sums differ
only in summation order, so they are held to 1e-4 absolute on unit-normal
rows, as there. The render's backward zeroes the fold under capacity
overflow. On a card (marker ``cuda``): the kernel against its plain
version in float64, with a run of 8,160 entries (a splat covering the
1080p screen) among them, runs either side of the short kernel's limit
and of the long kernel's piece length, one run of every row, many long
runs, long runs that overlap and long runs among 500,000 short ones
(``torch_fold_cases.py``, which chip_smoke.py folds too), each bitwise
from run to run, and one call that makes no host synchronisation and
replays from a CUDA graph."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from gs_tpu.ops.fold_pallas import ROWS, fold_rows as jax_fold_rows
from gs_tpu.ops.segment import segment_sum_runend as jax_segment_sum_runend

from gs_tpu_torch.ops.fold import fold_rows, fold_rows_plain, piece_slots
from gs_tpu_torch.ops.segment import segment_sum_runend
from gs_tpu_torch.render import render

from test_torch_render import small_scene
from torch_fold_cases import LONG_RUN_CASES, long_run_case

CASES = [pytest.param(n, dcap, seed, None, id=f"{n}-{dcap}-{seed}")
         for n, dcap, seed in [(300, 2048, 0), (7, 128, 1), (1000, 8192, 2)]]
# [live rain] at iteration 2: 23 visible Gaussians among 1,024 slots, the
# longest a splat covering the 1080p screen (8,160 tiles)
CASES.append(pytest.param(1024, 65536, 5, 23, id="live-rain"))
# a run of 8,160 entries (a 1080p-screen splat) and ~22 % empty runs
LONG_CASES = [(3000, 32768, 3, 8160), (2000, 32768, 4, 8160)]


def fold_case(n, dcap, seed, giant=600, live=None):
    """Per-gaussian counts, and the entries' gids and rows in a random
    (tile) order, with a sentinel tail. With ``live``, only that many
    Gaussians have entries: one run of 8,160, the others 1-2,399 long."""
    rng = np.random.default_rng(seed)
    if live is None:
        counts = rng.poisson(3.0, n).astype(np.int32)
        counts[rng.integers(0, n, n // 5)] = 0          # empty runs
        counts[min(5, n - 1)] = min(giant, dcap // 3)   # one huge run
    else:
        counts = np.zeros(n, np.int32)
        visible = rng.choice(n, live, replace=False)
        counts[visible] = rng.integers(1, 2400, live)
        counts[visible[0]] = 8160
    total = int(counts.sum())
    assert total <= dcap
    gid = np.concatenate([np.repeat(np.arange(n, dtype=np.int32), counts),
                          np.full(dcap - total, n, np.int32)])
    cols = rng.standard_normal((10, dcap)).astype(np.float32)
    cols[:, total:] = 0.0                           # sentinel cotangents
    perm = rng.permutation(dcap)
    return counts, gid[perm], np.ascontiguousarray(cols[:, perm])


def run_layout(counts, gid_s, cols_s, order):
    """fold_case's entries as the render's backward hands them to the
    fold: entry-major [E, 10], Gaussian ``order[k]``'s entries the k-th
    run, the sentinel tail last. Returns (data, offsets, counts, gid) as
    numpy arrays, the runs in ``order``."""
    n = counts.shape[0]
    rank = np.empty(n + 1, np.int64)
    rank[order] = np.arange(n)
    rank[n] = n
    pos = np.argsort(rank[gid_s], kind="stable")
    run_counts = counts[order].astype(np.int32)
    return (np.ascontiguousarray(cols_s[:, pos].T),
            (np.cumsum(run_counts) - run_counts).astype(np.int32),
            run_counts, order.astype(np.int32))


def to_torch(arrays, device="cpu"):
    return tuple(torch.tensor(a, device=device) for a in arrays)


@pytest.mark.parametrize("n,dcap,seed,live", CASES)
def test_fold_matches_jax(n, dcap, seed, live):
    counts, gid_s, cols_s = fold_case(n, dcap, seed, live=live)
    ref = np.asarray(jax_segment_sum_runend(
        tuple(jnp.asarray(c) for c in cols_s), jnp.asarray(gid_s),
        jnp.asarray(counts), n))                    # [n, 10]
    ops = jax.lax.sort((jnp.asarray(gid_s),)
                       + tuple(jnp.asarray(c) for c in cols_s),
                       dimension=0, is_stable=False, num_keys=1)
    data = jnp.concatenate([jnp.stack(ops[1:], axis=0),
                            jnp.zeros((ROWS - 10, dcap), jnp.float32)], axis=0)
    cj = jnp.asarray(counts)
    pallas = np.asarray(jax_fold_rows(data, jnp.cumsum(cj) - cj, cj, n,
                                      interpret=True))[:10].T
    np.testing.assert_allclose(pallas, ref, rtol=0, atol=1e-4)

    # the port's run-end segment sum, from the tile-ordered rows
    seg = segment_sum_runend(torch.tensor(cols_s.T), torch.tensor(gid_s),
                             torch.tensor(counts), n)
    np.testing.assert_allclose(seg.numpy(), ref, rtol=0, atol=1e-4)
    # the fold of gid-ordered runs, as the JAX package's fold_rows takes
    # them (gid the identity)
    got = fold_rows(*to_torch(run_layout(counts, gid_s, cols_s,
                                         np.arange(n))))
    assert got.shape == (n, 10)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-4)
    # the runs in a depth order, each sum scattered to row gid[i], as the
    # render's backward hands them over
    order = np.random.default_rng(seed + 100).permutation(n)
    got = fold_rows(*to_torch(run_layout(counts, gid_s, cols_s, order)))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-4)


def test_fold_runs_in_any_order_and_cut_at_the_end():
    rng = np.random.default_rng(4)
    data = torch.tensor(rng.standard_normal((50, 3)).astype(np.float32))
    offsets = torch.tensor([40, 0, 10, 48, 60], dtype=torch.int32)
    counts = torch.tensor([10, 10, 0, 5, 3], dtype=torch.int32)
    gid = torch.tensor([3, 0, 4, 1, 2], dtype=torch.int32)
    got = fold_rows(data, offsets, counts, gid)
    ref = torch.stack([data[0:10].sum(0), data[48:50].sum(0), torch.zeros(3),
                       data[40:50].sum(0), torch.zeros(3)])
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-5)
    with pytest.raises(ValueError):
        fold_rows(data, offsets, counts.to(torch.int64), gid)
    with pytest.raises(ValueError):
        fold_rows(torch.zeros((4, 17)), offsets, counts, gid)
    with pytest.raises(ValueError):
        fold_rows(data, offsets, counts, gid[:4])
    with pytest.raises(ValueError):
        fold_rows(data.T.contiguous(), offsets, counts, gid)   # 50 rows > 16


@pytest.mark.parametrize("n,dcap,seed,giant", LONG_CASES)
def test_fold_long_runs_match_float64(n, dcap, seed, giant):
    """The plain fold on the cases with a run of 8,160 entries, against
    numpy's float64 sums, within 1e-6 of the largest sum."""
    counts, gid_s, cols_s = fold_case(n, dcap, seed, giant)
    assert (counts == 0).mean() >= 0.2 and counts.max() == giant
    order = np.random.default_rng(seed).permutation(n)
    args = run_layout(counts, gid_s, cols_s, order)
    ref = np.zeros((n + 1, 10))
    np.add.at(ref, gid_s, cols_s.T.astype(np.float64))
    got = fold_rows(*to_torch(args)).numpy()
    scale = np.abs(ref[:n]).max()
    assert np.abs(got - ref[:n]).max() <= 1e-6 * scale


def test_render_gradient_is_zero_on_overflow():
    _, _, tparams, tcam = small_scene()
    for capacity, overflow in ((1 << 14, False), (512, True)):
        leaves = [t.clone().requires_grad_(True) for t in tparams]
        out = render(tcam, type(tparams)(*leaves), torch.zeros(3),
                     active_sh_degree=2, backend="cuda",
                     dup_capacity=capacity, max_per_tile=256, exact_cull=True)
        assert bool(out.overflow) == overflow
        grads = torch.autograd.grad(out.image.sum() + out.invdepth.sum(),
                                    leaves, allow_unused=True)
        total = sum(float(g.abs().sum()) for g in grads if g is not None)
        assert (total == 0.0) == overflow, total


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


def assert_kernel_matches_float64(args):
    """K4 within 1e-6 of the largest sum of its plain version in float64,
    and bitwise from run to run."""
    got = fold_rows(*args)
    torch.cuda.synchronize()
    ref = fold_rows_plain(*[a.double() if a.is_floating_point() else a
                            for a in args])
    scale = float(ref.abs().max())
    assert float((got.double() - ref).abs().max()) <= 1e-6 * scale
    assert torch.equal(got, fold_rows(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("n,dcap,seed,live", CASES)
def test_cuda_fold_matches_plain(cuda_device, n, dcap, seed, live):
    counts, gid_s, cols_s = fold_case(n, dcap, seed, live=live)
    order = np.random.default_rng(seed + 100).permutation(n)
    assert_kernel_matches_float64(
        to_torch(run_layout(counts, gid_s, cols_s, order), cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize("n,dcap,seed,giant", LONG_CASES)
def test_cuda_fold_long_runs(cuda_device, n, dcap, seed, giant):
    counts, gid_s, cols_s = fold_case(n, dcap, seed, giant)
    order = np.random.default_rng(seed).permutation(n)
    assert_kernel_matches_float64(
        to_torch(run_layout(counts, gid_s, cols_s, order), cuda_device))


@pytest.mark.cuda
def test_cuda_fold_runs_in_any_order(cuda_device):
    """Runs that overlap, leave gaps, are empty or pass the end: the
    kernel's window then holds rows no run reads, and stays right."""
    rng = np.random.default_rng(8)
    e, n = 5000, 700
    counts = rng.integers(0, 40, n).astype(np.int32)
    offsets = rng.integers(-20, e + 20, n).astype(np.int32)
    counts[::7] = 0
    counts[3] = 4000                                # several stages long
    args = (rng.standard_normal((e, 10)).astype(np.float32), offsets, counts,
            rng.permutation(n).astype(np.int32))
    assert_kernel_matches_float64(to_torch(args, cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(LONG_RUN_CASES))
def test_cuda_fold_long_run_shapes(cuda_device, name):
    assert_kernel_matches_float64(to_torch(long_run_case(name), cuda_device))


@pytest.mark.cuda
def test_cuda_fold_does_not_synchronise(cuda_device):
    """One call on [live rain]'s shape: no host synchronisation that torch
    sees, one launch counted; and the call captured in a CUDA graph and
    replayed (the step is meant for capture, which refuses any
    synchronising or uncapturable call of the C entry too)."""
    counts, gid_s, cols_s = fold_case(1024, 65536, 5, live=23)
    order = np.random.default_rng(5).permutation(1024)
    args = to_torch(run_layout(counts, gid_s, cols_s, order), cuda_device)
    ref = fold_rows_plain(*args)
    torch.cuda.synchronize()
    before = fold_rows.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = fold_rows(*args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert fold_rows.launches == before + 1
    torch.testing.assert_close(got, ref, rtol=0,
                               atol=1e-6 * float(got.abs().max()))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = fold_rows(*args)
    captured.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, got)


@pytest.mark.parametrize("short_run_rows,piece_rows", [(256, 256), (1, 1),
                                                       (100, 7), (7, 100)])
def test_piece_slots_hold_every_piece_of_runs_that_do_not_overlap(
        short_run_rows, piece_rows):
    """The long kernel's scratch, sized from E alone, holds every piece of
    any runs that do not overlap: the worst case is all runs one row past
    the short kernel's limit, or a run of every row."""
    rng = np.random.default_rng(piece_rows)
    for e in (0, 1, 255, 256, 257, 1000, 8160, 100_003):
        assert piece_slots(e, short_run_rows, piece_rows) >= -(-e // piece_rows)
        k = e // (short_run_rows + 1)
        worst = k * -(-(short_run_rows + 1) // piece_rows)
        assert piece_slots(e, short_run_rows, piece_rows) >= worst
        for _ in range(20):
            cuts = np.sort(rng.integers(0, e + 1, rng.integers(0, 60)))
            lengths = np.diff(np.concatenate([[0], cuts, [e]]))
            long = lengths[lengths > short_run_rows]
            pieces = int((-(-long // piece_rows)).sum())
            assert pieces <= piece_slots(e, short_run_rows, piece_rows)


def test_run_sums_do_not_carry_the_prefix_rounding():
    """A run's sum must not depend on the entries in front of it: behind
    a long prefix of large values a float32 cumsum loses the run, the
    float64 one the plain fold uses keeps it to float32 rounding."""
    from gs_tpu_torch.ops.segment import run_sums
    rng = np.random.default_rng(6)
    data = rng.normal(0, 100.0, (1, 200_001)).astype(np.float32)
    data[0, -1] = 1e-3
    lo = torch.tensor([200_000])
    hi = torch.tensor([200_001])
    got = float(run_sums(torch.tensor(data), lo, hi)[0, 0])
    assert abs(got - 1e-3) <= 1e-9
    cum32 = np.cumsum(data[0], dtype=np.float32)
    assert abs(float(cum32[-1] - cum32[-2]) - 1e-3) > 1e-5
