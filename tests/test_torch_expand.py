"""Kernel K2 (gs_tpu_torch/ops/expand.py): the plain version bitwise against
the TPU kernel gs_tpu.ops.expand_pallas.expand_rows in interpret mode, on
the cases of tests/test_expand.py; on a card, the CUDA kernel bitwise
against the plain version."""
import numpy as np
import pytest
import torch

from gs_tpu.ops.expand_pallas import BLOCK, expand_rows as jax_expand_rows
from gs_tpu_torch.ops import expand as texpand

ROWS = texpand.ROWS


def _table(rng, counts, scale=3.0):
    n = counts.shape[0]
    offsets = (np.cumsum(counts) - counts).astype(np.int32)
    payload = rng.normal(0, scale, (ROWS - 2, n)).astype(np.float32)
    comb = np.concatenate([offsets[None].astype(np.float32),
                           counts[None].astype(np.float32), payload], axis=0)
    return comb, offsets


def _random_counts(n, capacity):
    """tests/test_expand.py::test_expand_rows_matches_repeat's counts."""
    rng = np.random.default_rng(5 + n)
    counts = rng.integers(1, 40, size=n).astype(np.int32)
    nz = int(n * 0.3)
    counts[n - nz:] = 0
    total = int(counts.sum())
    if total > capacity:
        counts = (counts * (capacity // 2) // max(total, 1)).astype(np.int32)
        counts = np.maximum(counts, np.where(np.arange(n) < n // 2, 1, 0))
    return rng, counts


def expand_cases():
    """(name, comb, offsets, capacity) for the three tests/test_expand.py
    cases: random counts, truncation at capacity, one giant run."""
    cases = []
    for n, capacity in [(37, 1024), (300, 4096), (64, 512)]:
        rng, counts = _random_counts(n, capacity)
        cases.append((f"random-{n}", *_table(rng, counts), capacity))
    rng = np.random.default_rng(11)
    counts = rng.integers(1, 12, size=200).astype(np.int32)
    assert counts.sum() > 512
    cases.append(("truncation", *_table(rng, counts, 1.0), 512))
    counts = np.array([3, 3 * BLOCK, 5, 0, 0, 0, 0, 0], np.int32)
    cases.append(("giant-run", *_table(np.random.default_rng(1), counts, 1.0),
                  4 * BLOCK))
    return cases


CASES = expand_cases()


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_plain_expand_matches_pallas_bitwise(case):
    _, comb, offsets, capacity = case
    ref = np.asarray(jax_expand_rows(comb, offsets, capacity, interpret=True))
    got = texpand.expand_rows(torch.from_numpy(comb), torch.from_numpy(offsets),
                              capacity)
    assert got.dtype == torch.float32 and got.shape == (ROWS, capacity)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_expand_rows_rejects_bad_arguments():
    comb = torch.zeros((ROWS, 4))
    with pytest.raises(ValueError):
        texpand.expand_rows(comb.double(), torch.zeros(4, dtype=torch.int32), 8)
    with pytest.raises(ValueError):
        texpand.expand_rows(comb, torch.zeros(4, dtype=torch.int64), 8)
    with pytest.raises(ValueError):
        texpand.expand_rows(comb[:, ::2], torch.zeros(2, dtype=torch.int32), 8)


def test_cpu_expand_launches_no_kernel():
    before = texpand.expand_rows.launches
    _, comb, offsets, capacity = CASES[0]
    texpand.expand_rows(torch.from_numpy(comb), torch.from_numpy(offsets),
                        capacity)
    assert texpand.expand_rows.launches == before


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_cuda_expand_matches_plain_bitwise(case, cuda_device):
    _, comb, offsets, capacity = case
    comb_t, off_t = torch.from_numpy(comb), torch.from_numpy(offsets)
    got = texpand.expand_rows(comb_t.to(cuda_device), off_t.to(cuda_device),
                              capacity)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), texpand.expand_rows_plain(comb_t, off_t,
                                                            capacity))
