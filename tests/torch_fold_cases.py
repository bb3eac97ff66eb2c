"""Inputs of the gradient fold K4 (``gs_tpu_torch/ops/fold.py``) around its
long-run path, as numpy (data [E, 10] float32, offsets, counts, gid [N]
int32), made from a seed. The card tests (``test_torch_fold.py``),
``chip_smoke.py``'s [K4 long] phase and ``tools/fold_speed.py`` take them
from here, so they fold the same runs. Imports numpy and the port's fold
constants only, no JAX."""
import numpy as np

from gs_tpu_torch.ops.fold import PIECE_ROWS, SHORT_RUN_ROWS


def tiled_runs(rng, counts, tail=37, rows=10):
    """``counts`` as the render lays runs out: back to back from row 0 in a
    seeded order, each scattered to a random Gaussian, ``tail`` rows of
    the buffer behind them. Returns numpy (data, offsets, counts, gid)."""
    counts = np.asarray(counts, np.int64)
    offsets = np.cumsum(counts) - counts
    e = int(counts.sum()) + tail
    return (rng.standard_normal((e, rows)).astype(np.float32),
            offsets.astype(np.int32), counts.astype(np.int32),
            rng.permutation(counts.shape[0]).astype(np.int32))


# runs around the kernels' split: SHORT_RUN_ROWS (L) rows or fewer go to
# the short kernel, longer runs in PIECE_ROWS (P) pieces to the long one
LONG_RUN_CASES = {"L": SHORT_RUN_ROWS, "L+1": SHORT_RUN_ROWS + 1,
                  "P": PIECE_ROWS, "P+1": PIECE_ROWS + 1,
                  "3P-1": 3 * PIECE_ROWS - 1, "all-rows": None,
                  "many-long": None, "overlapping": None, "mixed": None}


def long_run_case(name):
    """LONG_RUN_CASES[name] as numpy (data, offsets, counts, gid)."""
    rng = np.random.default_rng(sorted(LONG_RUN_CASES).index(name) + 20)
    length = LONG_RUN_CASES[name]
    if length is not None:              # five such runs among short ones
        counts = rng.integers(0, 12, 40)
        counts[::8] = length
        return tiled_runs(rng, counts)
    if name == "all-rows":              # one run of every row
        return tiled_runs(rng, [100_003], tail=0)
    if name == "many-long":
        return tiled_runs(rng, rng.integers(SHORT_RUN_ROWS + 1,
                                            5 * PIECE_ROWS, 2000))
    if name == "overlapping":           # more pieces than the scratch holds
        e, n = 50_000, 300
        return (rng.standard_normal((e, 10)).astype(np.float32),
                rng.integers(-100, e, n).astype(np.int32),
                rng.integers(SHORT_RUN_ROWS + 1, e // 2, n).astype(np.int32),
                rng.permutation(n).astype(np.int32))
    assert name == "mixed"              # long runs among 500,000 short ones
    counts = rng.poisson(5.6, 500_000)
    counts[rng.integers(0, 500_000, 200)] = rng.integers(
        SHORT_RUN_ROWS + 1, 8161, 200)
    return tiled_runs(rng, counts)


def rain_like_runs(seed=2):
    """The shape of the RAIN-GS init's second iteration: 1,024 runs of
    which 23 are non-empty, one of 8,160 rows (a splat covering the 1080p
    screen) and 22 of 5,000-8,160, back to back among the first 64."""
    rng = np.random.default_rng(seed)
    counts = np.zeros(1024, np.int64)
    visible = rng.choice(64, 23, replace=False)
    counts[visible] = rng.integers(5000, 8161, 23)
    counts[visible[0]] = 8160
    return tiled_runs(rng, counts, tail=4096)
