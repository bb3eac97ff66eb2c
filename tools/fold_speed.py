#!/usr/bin/env python3
"""Time the gradient fold K4 of this checkout against another checkout's,
both through the public wrapper ``gs_tpu_torch.ops.fold.fold_rows``, on the
bench frame's rows and on RAIN-like long runs.

Usage, from the repository root on a machine with one CUDA card and nvcc:

    git archive <commit> gs_tpu_torch | tar -x -C .ab_parent
    python3 tools/fold_speed.py --other .ab_parent [--iters 20]

``--other`` is a directory that holds another version's ``gs_tpu_torch/``
(for example the parent commit's); each version builds its own kernels
into its own ``gs_tpu_torch/_build/``. Inputs, made here with this
checkout: the bench frame (chip_smoke.py's ``bench_scene`` at 1920x1080,
K3's rows of one seeded upstream gradient, folded over the depth-ordered
runs of ``FoldPlan``) and ``tests/torch_fold_cases.py::rain_like_runs``
(1,024 runs of which 23 are non-empty, the longest 8,160 rows: the shape
of chip_smoke.py's [live rain] at iteration 2). Each version runs in its
own process, in turns (other, this, this, other); each holds its result to
``fold_rows_plain``'s float64 sums (within 1e-6 of the largest sum) and to
itself from run to run, and gives its CUDA-event time (the mean of
``--iters`` calls) and its device time by torch.profiler, kernel by
kernel. Then ``index_add_`` on the same rows and the bytes bound. Prints
the card's name and power limit first; exits 1 if this checkout's fold is
wrong or not deterministic.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(1, os.path.join(ROOT, "tests"))
import chip_smoke  # noqa: E402  (the scene and the timers)


def bench_frame_args(torch, dev):
    """K3's rows of the bench frame and its FoldPlan's runs."""
    from gs_tpu_torch.core.camera import focal2fov, make_camera
    from gs_tpu_torch.core.project import preprocess
    from gs_tpu_torch.ops.binning import bin_gaussians_payload, tile_grid
    from gs_tpu_torch.ops.rasterize import (max_chunks_for, raster_tiles_bwd,
                                            raster_tiles_fwd_save)
    from gs_tpu_torch.ops.rasterize_plain import pack_projected
    w, h = chip_smoke.W, chip_smoke.H
    _, _, params, alive = chip_smoke.bench_scene(torch, dev)
    fovx = math.radians(70.0)
    fovy = focal2fov(w / (2 * math.tan(fovx / 2)), h)
    cam = make_camera(np.eye(3), np.zeros(3), fovx, fovy, w, h, device=dev)
    with torch.no_grad():
        pr = preprocess(params, cam, active_sh_degree=3, alive=alive)
        bins, feats, plan = bin_gaussians_payload(
            pr, pack_projected(pr), w, h, 16, 16, chip_smoke.DUP_CAPACITY,
            exact_cull=True, fold_plan=True)
        gx, _ = tile_grid(w, h, 16, 16)
        args = (feats, bins.tile_start, bins.tile_end, gx,
                max_chunks_for(chip_smoke.MAX_PER_TILE))
        out_g, last = raster_tiles_fwd_save(*args)
        dout = torch.tensor(np.random.default_rng(11).normal(
            0, 1, tuple(out_g.shape)), dtype=torch.float32, device=dev)
        rows = raster_tiles_bwd(*args, out_g, last, dout, plan.dest)
    return rows, plan.offsets, plan.counts, plan.gid


def worker(pkg_root: str, inputs: str, iters: int) -> int:
    """One version's fold on the saved inputs: a JSON line of its errors,
    repeatability and times per input."""
    import torch
    sys.path.insert(0, os.path.abspath(pkg_root))
    import gs_tpu_torch
    from gs_tpu_torch.ops.fold import fold_rows
    package = os.path.dirname(os.path.abspath(gs_tpu_torch.__file__))
    assert package == os.path.join(os.path.abspath(pkg_root), "gs_tpu_torch")
    result = {}
    for name, saved in torch.load(inputs).items():
        args = tuple(saved[k].cuda() for k in ("data", "offsets", "counts",
                                               "gid"))
        ref = saved["ref"].cuda()
        got = fold_rows(*args)
        parts = {}
        result[name] = {
            "err": float((got.double() - ref).abs().max())
            / float(ref.abs().max()),
            "bitwise": torch.equal(got, fold_rows(*args)),
            "ms": chip_smoke.time_ms(torch, lambda: fold_rows(*args), iters),
            "device_ms": chip_smoke.device_ms(
                torch, lambda: fold_rows(*args), iters, parts),
            "parts": parts}
    print(json.dumps(result), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", help="a directory holding another "
                    "gs_tpu_torch/ to compare with")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--worker", nargs=2, metavar=("PKG_ROOT", "INPUTS"),
                    help=argparse.SUPPRESS)
    a = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("fold_speed: no CUDA device", file=sys.stderr)
        return 2
    if a.worker:
        return worker(*a.worker, a.iters)
    if a.other is None or not os.path.isdir(
            os.path.join(a.other, "gs_tpu_torch")):
        ap.error("--other must name a directory holding gs_tpu_torch/")
    from gs_tpu_torch.ops.fold import fold_rows_plain
    from torch_fold_cases import rain_like_runs
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    dev = torch.device("cuda", 0)
    cases = {"bench frame": bench_frame_args(torch, dev),
             "rain": tuple(torch.from_numpy(x).to(dev)
                           for x in rain_like_runs())}
    saved = {}
    for name, (data, offsets, counts, gid) in cases.items():
        saved[name] = {"data": data.cpu(), "offsets": offsets.cpu(),
                       "counts": counts.cpu(), "gid": gid.cpu(),
                       "ref": fold_rows_plain(data.double(), offsets, counts,
                                              gid).cpu()}
    turns = []
    with tempfile.TemporaryDirectory(dir=ROOT, prefix=".fold_speed_") as tmp:
        inputs = os.path.join(tmp, "inputs.pt")
        torch.save(saved, inputs)
        for who in ("other", "this", "this", "other"):
            pkg_root = os.path.abspath(a.other if who == "other" else ROOT)
            res = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--iters",
                 str(a.iters), "--worker", pkg_root, inputs],
                capture_output=True, text=True, timeout=900)
            if res.returncode:
                print(res.stdout + res.stderr, file=sys.stderr)
                print(f"fold_speed: the {who} version failed", file=sys.stderr)
                return 1
            turns.append((who, json.loads(res.stdout.strip().splitlines()[-1])))
    ok = True
    for name, (data, offsets, counts, gid) in cases.items():
        n, r = counts.shape[0], data.shape[1]
        c = counts.to(torch.int64)
        rows = int(c.sum())
        # index_add_ needs each row's Gaussian: the runs lie back to back
        # from row 0
        gid_rows = torch.repeat_interleave(gid.to(torch.int64), c)
        run_rows = data[:rows]

        def index_add():
            return torch.zeros((n, r), device=dev).index_add_(0, gid_rows,
                                                              run_rows)
        lib_ms = chip_smoke.time_ms(torch, index_add, a.iters)
        lib_dev = chip_smoke.device_ms(torch, index_add, a.iters)
        bound, by, _, _ = chip_smoke.bound_of(rows * 4 * r + n * (12 + 4 * r),
                                              rows * r)
        this = [t[name] for who, t in turns if who == "this"]
        ok = ok and all(t["err"] <= 1e-6 and t["bitwise"] for t in this)
        said = "; ".join(
            f"{who}: error {t[name]['err']:.3e} of the largest sum, bitwise "
            f"{t[name]['bitwise']}, {t[name]['ms']:.4f} ms, device "
            f"{t[name]['device_ms']:.4f} ms (" + ", ".join(
                f"{k[:40]} {v:.4f}" for k, v in t[name]["parts"].items())
            + ")" for who, t in turns)
        print(f"[{name}] {n} runs, {int((c > 0).sum())} non-empty, the "
              f"longest {int(c.max())}, {rows} rows; in turns {said}; "
              f"index_add_ {lib_ms:.4f} ms (device {lib_dev:.4f}); bound "
              f"{bound:.4f} ms ({by})", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
