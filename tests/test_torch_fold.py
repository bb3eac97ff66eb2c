"""The gradient fold K4 (``ops/fold.py``) and the run-end segment sum
(``ops/segment.py``), against the JAX package's ``fold_rows`` (Pallas,
interpret mode) and ``segment_sum_runend``, in the cases of
tests/test_fold.py:20-50: empty runs, one huge run, a sentinel tail and
entries arriving tile-ordered. The port's fold takes the entries
entry-major, each Gaussian's as one run, the runs in any (here a seeded
depth) order, each sum scattered to its Gaussian's row; the sums differ
only in summation order, so they are held to 1e-4 absolute on unit-normal
rows, as there. The render's backward zeroes the fold under capacity
overflow. On a card (marker ``cuda``): the kernel against its plain
version in float64, with a run of 8,160 entries (a splat covering the
1080p screen) among them, and bitwise from run to run."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from gs_tpu.ops.fold_pallas import ROWS, fold_rows as jax_fold_rows
from gs_tpu.ops.segment import segment_sum_runend as jax_segment_sum_runend

from gs_tpu_torch.ops.fold import fold_rows, fold_rows_plain
from gs_tpu_torch.ops.segment import segment_sum_runend
from gs_tpu_torch.render import render

from test_torch_render import small_scene

CASES = [(300, 2048, 0), (7, 128, 1), (1000, 8192, 2)]
# a run of 8,160 entries (a 1080p-screen splat) and ~22 % empty runs
LONG_CASES = [(3000, 32768, 3, 8160), (2000, 32768, 4, 8160)]


def fold_case(n, dcap, seed, giant=600):
    """Per-gaussian counts, and the entries' gids and rows in a random
    (tile) order, with a sentinel tail."""
    rng = np.random.default_rng(seed)
    counts = rng.poisson(3.0, n).astype(np.int32)
    counts[rng.integers(0, n, n // 5)] = 0          # empty runs
    counts[min(5, n - 1)] = min(giant, dcap // 3)   # one huge run
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


@pytest.mark.parametrize("n,dcap,seed", CASES)
def test_fold_matches_jax(n, dcap, seed):
    counts, gid_s, cols_s = fold_case(n, dcap, seed)
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
@pytest.mark.parametrize("n,dcap,seed", CASES)
def test_cuda_fold_matches_plain(cuda_device, n, dcap, seed):
    counts, gid_s, cols_s = fold_case(n, dcap, seed)
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
