#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (gs_tpu_torch) on one NVIDIA GPU and check it.

Usage, from the repository root on a machine with one CUDA card and nvcc:

    python3 chip_smoke.py

Phases (each failure exits non-zero):
 1. print the card's name and power limit; build every kernel from
    gs_tpu_torch/csrc (one nvcc per source, all at once);
 2. K2 (expansion) against its plain version, bitwise: the three
    expansion test cases and the bench scene's [16, N] table into
    3,072,000 entries; kernel, plain and torch.repeat_interleave times;
 3. K1 (forward raster) against its plain version under the JAX package's
    backend rule (max |diff| < 2e-2, < 0.2 % of values beyond 1e-5): a
    300-gaussian 128x96 scene and one 1920x1080 frame; kernel and plain
    times, and the work the frame's data needs (for the bound);
 4. serve: the 500,000-gaussian bench scene (bench.py build_scene
    "uniform", rebuilt with the port) written as a trained-model directory,
    loaded back, 8 frames at 1920x1080 through gs_tpu_torch.render.render
    with the launch counts read around them, then the orbit CLI
    (gs_tpu_torch.apps.view_orbit) for 2 frames; one profiled frame;
 5. a JSON line of the kernels' numbers, then the result line
    {"ok": true, "device": {...}}.

It exits non-zero without a CUDA device, or when run outside the repository.
"""
from __future__ import annotations

import contextlib
import io
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
W, H = 1920, 1080
N_GAUSS = 500_000
DUP_CAPACITY, MAX_PER_TILE = 3_072_000, 1024       # bench.py CAPS["uniform"]
TPU_NUM_DUPLICATES = 3_022_338                      # bench.py:100, same scene
FRAMES = 8
HBM_BYTES_PER_S = 3.35e12                           # H100 SXM data sheet
FP32_OPS_PER_S = 67e12


def fail(msg: str):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond, msg: str):
    if not cond:
        fail(msg)


def images_match(x, y, boundary_frac=2e-3, boundary_atol=2e-2, atol=1e-5):
    """tests/test_rasterize.py::assert_images_match as a predicate: the
    T < 1e-4 cut can flip on float-associativity differences, so a tiny
    fraction of values may differ. Returns (ok, max diff, fraction)."""
    diff = (x.double() - y.double()).abs()
    mx = float(diff.max()) if diff.numel() else 0.0
    frac = float((diff > atol).double().mean()) if diff.numel() else 0.0
    return mx < boundary_atol and frac < boundary_frac, mx, frac


def time_ms(torch, fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of one call, by CUDA events around ``iters`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def expand_cases(block=256):
    """The three cases of tests/test_expand.py: (name, comb, offsets, capacity)."""
    def table(rng, counts, scale):
        offsets = (np.cumsum(counts) - counts).astype(np.int32)
        payload = rng.normal(0, scale, (14, counts.shape[0])).astype(np.float32)
        comb = np.concatenate([offsets[None].astype(np.float32),
                               counts[None].astype(np.float32), payload], 0)
        return comb, offsets

    cases = []
    for n, capacity in [(37, 1024), (300, 4096), (64, 512)]:
        rng = np.random.default_rng(5 + n)
        counts = rng.integers(1, 40, size=n).astype(np.int32)
        counts[n - int(n * 0.3):] = 0
        total = int(counts.sum())
        if total > capacity:
            counts = (counts * (capacity // 2) // total).astype(np.int32)
            counts = np.maximum(counts, np.where(np.arange(n) < n // 2, 1, 0))
        cases.append((f"random-{n}", *table(rng, counts, 3.0), capacity))
    rng = np.random.default_rng(11)
    counts = rng.integers(1, 12, size=200).astype(np.int32)
    cases.append(("truncation", *table(rng, counts, 1.0), 512))
    counts = np.array([3, 3 * block, 5, 0, 0, 0, 0, 0], np.int32)
    cases.append(("giant-run", *table(np.random.default_rng(1), counts, 1.0),
                  4 * block))
    return cases


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    if not os.path.isfile(os.path.join(ROOT, "gs_tpu_torch", "render.py")):
        print("chip_smoke: run from a checkout of the repository "
              "(gs_tpu_torch/ not found beside this script)", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from gs_tpu_torch.apps import view_orbit
    from gs_tpu_torch.apps.render import params_from_ply
    from gs_tpu_torch.config import (ModelConfig, OptimizationConfig,
                                     PipelineConfig, save_config)
    from gs_tpu_torch.core.camera import focal2fov, make_camera
    from gs_tpu_torch.core.gaussians import GaussianParams, inverse_sigmoid
    from gs_tpu_torch.core.project import preprocess
    from gs_tpu_torch.core.sh import rgb2sh
    from gs_tpu_torch.data.ply import load_gaussian_ply, save_gaussian_ply
    from gs_tpu_torch.models.gaussian_model import create_from_pcd
    from gs_tpu_torch.ops import _cuda
    from gs_tpu_torch.ops.binning import (bin_gaussians_payload,
                                          expansion_table, tile_grid)
    from gs_tpu_torch.ops.expand import expand_rows, expand_rows_plain
    from gs_tpu_torch.ops.rasterize import (K1_OPS, max_chunks_for,
                                            raster_tiles_fwd,
                                            raster_tiles_fwd_plain,
                                            raster_tiles_fwd_work)
    from gs_tpu_torch.ops.rasterize_plain import pack_projected
    from gs_tpu_torch.render import render

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    # ---------------------------------------------------------------- 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    t0 = time.perf_counter()
    logs = _cuda.build()
    print(f"[build] {len(logs)} kernel libraries in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    for src, log in logs.items():
        for line in log.splitlines():
            if any(w in line for w in ("registers", "spill", "error", "warning")):
                print(f"[build] {src}: {line.strip()}")

    # the bench scene, rebuilt with the port, written and loaded back
    rng = np.random.default_rng(0)
    pts = np.concatenate([rng.uniform(-3.5, 3.5, (N_GAUSS, 1)),
                          rng.uniform(-2.0, 2.0, (N_GAUSS, 1)),
                          rng.uniform(2.5, 9.0, (N_GAUSS, 1))], axis=1)
    cols = rng.uniform(0, 1, (N_GAUSS, 3))
    cap = max(1024, -(-int(N_GAUSS * 1.02) // 1024) * 1024)
    t0 = time.perf_counter()
    p0, _ = create_from_pcd(pts, cols, sh_degree=3, capacity=cap, device=dev)
    p0 = p0._replace(log_scale=p0.log_scale + math.log(0.3))
    torch.cuda.synchronize()
    print(f"[scene] create_from_pcd of {N_GAUSS} points: "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    tmp = tempfile.TemporaryDirectory(dir=ROOT, prefix=".chip_smoke_")
    model_dir = tmp.name
    host = {k: getattr(p0, k)[:N_GAUSS].cpu().numpy() for k in p0._fields}
    ply = os.path.join(model_dir, "point_cloud", "iteration_30000",
                       "point_cloud.ply")
    save_gaussian_ply(ply, host["xyz"], host["sh_dc"], host["sh_rest"],
                      host["logit_opacity"], host["log_scale"], host["quat"])
    save_config(model_dir, ModelConfig(model_path=model_dir),
                PipelineConfig(), OptimizationConfig())
    d = load_gaussian_ply(ply)
    params, alive = params_from_ply(d, device=dev)
    check(all(np.array_equal(d[k], host[k]) for k in host), "PLY round trip")
    fovx = math.radians(70.0)
    fovy = focal2fov(W / (2 * math.tan(fovx / 2)), H)
    bg = torch.zeros(3, device=dev)

    def bench_camera(i):
        return make_camera(np.eye(3), np.array([2e-3 * i, 0.0, 0.0]), fovx,
                           fovy, W, H, device=dev)

    with torch.no_grad():
        cam0 = bench_camera(0)
        proj = preprocess(params, cam0, active_sh_degree=3, alive=alive)
        packets = pack_projected(proj)

        # ------------------------------------------------------------ 2
        k2_err = 0.0
        for name, comb, offsets, capacity in expand_cases():
            c, o = torch.from_numpy(comb).to(dev), torch.from_numpy(offsets).to(dev)
            got = expand_rows(c, o, capacity)
            torch.cuda.synchronize()
            ref = expand_rows_plain(c, o, capacity)
            check(torch.equal(got, ref), f"K2 != plain on case {name}")
            print(f"[K2] case {name}: bitwise equal", flush=True)
        comb, offsets, _, total = expansion_table(proj, packets, W, H, 16, 16)
        total = int(total)
        got = expand_rows(comb, offsets, DUP_CAPACITY)
        torch.cuda.synchronize()
        ref = expand_rows_plain(comb, offsets, DUP_CAPACITY)
        check(torch.equal(got, ref), "K2 != plain on the bench table")
        k2_err = float((got - ref).abs().max())
        del got, ref
        counts = comb[1].to(torch.int64)
        k2_ms = time_ms(torch, lambda: expand_rows(comb, offsets, DUP_CAPACITY), 20)
        k2_plain_ms = time_ms(torch, lambda: expand_rows_plain(
            comb, offsets, DUP_CAPACITY), 5)
        k2_lib_ms = time_ms(torch, lambda: torch.repeat_interleave(
            comb, counts, dim=1, output_size=total), 20)
        n_tab = comb.shape[1]
        k2_bytes = 16 * n_tab * 4 + n_tab * 4 + 16 * DUP_CAPACITY * 4
        k2_ops = DUP_CAPACITY * math.ceil(math.log2(n_tab + 1))
        k2_bound = max(k2_bytes / HBM_BYTES_PER_S, k2_ops / FP32_OPS_PER_S) * 1e3
        print(f"[K2] bench table [16, {n_tab}] -> {DUP_CAPACITY} entries "
              f"({total} owned): bitwise equal; kernel {k2_ms:.4f} ms, plain "
              f"{k2_plain_ms:.4f} ms, repeat_interleave {k2_lib_ms:.4f} ms, "
              f"bound {k2_bound:.4f} ms ({k2_bytes} bytes)", flush=True)
        del comb

        # ------------------------------------------------------------ 3
        srng = np.random.default_rng(5)
        n = 300
        small = GaussianParams(
            xyz=torch.tensor(np.concatenate([
                srng.uniform(-1, 1, (n, 2)), srng.uniform(3, 5, (n, 1))], 1),
                dtype=torch.float32, device=dev),
            sh_dc=rgb2sh(torch.tensor(srng.uniform(0, 1, (n, 1, 3)),
                                      dtype=torch.float32, device=dev)),
            sh_rest=torch.tensor(srng.normal(0, 0.02, (n, 15, 3)),
                                 dtype=torch.float32, device=dev),
            log_scale=torch.tensor(srng.uniform(-3.5, -1.5, (n, 3)),
                                   dtype=torch.float32, device=dev),
            quat=torch.tensor(srng.normal(0, 1, (n, 4)) + [2, 0, 0, 0],
                              dtype=torch.float32, device=dev),
            logit_opacity=inverse_sigmoid(torch.tensor(
                srng.uniform(0.2, 0.95, (n, 1)), dtype=torch.float32,
                device=dev)))
        sfovy = focal2fov(128 / (2 * math.tan(math.radians(30))), 96)
        scam = make_camera(np.eye(3), np.zeros(3), math.radians(60), sfovy,
                           128, 96, device=dev)
        k1_err = 0.0
        for label, pr, cam, capacity, mpt in (
                ("300 gaussians 128x96",
                 preprocess(small, scam, active_sh_degree=3), scam, 1 << 14, 512),
                (f"bench frame {W}x{H}", proj, cam0, DUP_CAPACITY, MAX_PER_TILE)):
            bins, feats = bin_gaussians_payload(
                pr, pack_projected(pr), cam.width, cam.height, 16, 16,
                capacity, exact_cull=True)
            check(not bool(bins.overflow), f"K1 {label}: binning overflow")
            gx, _ = tile_grid(cam.width, cam.height, 16, 16)
            args = (feats, bins.tile_start, bins.tile_end, gx, max_chunks_for(mpt))
            got = raster_tiles_fwd(*args)
            torch.cuda.synchronize()
            ref = raster_tiles_fwd_plain(*args)
            ok, mx, frac = images_match(got, ref)
            print(f"[K1] {label}: max |kernel - plain| {mx:.3e}, "
                  f"{frac:.4%} of values beyond 1e-5", flush=True)
            check(ok, f"K1 != plain on {label} (max {mx}, frac {frac})")
            k1_err = max(k1_err, mx)
        del got, ref
        k1_ms = time_ms(torch, lambda: raster_tiles_fwd(*args), 20)
        k1_plain_ms = time_ms(torch, lambda: raster_tiles_fwd_plain(*args), 3, 1)

        # work the frame's data needs: each pixel's pairs up to the one that
        # stops it, by where the kernel body drops them; each entry some
        # pixel reaches, read once
        work = raster_tiles_fwd_work(*args)
        k1_bound_b = work["bytes"] / HBM_BYTES_PER_S * 1e3
        k1_bound_o = work["ops"] / FP32_OPS_PER_S * 1e3
        k1_bound = max(k1_bound_b, k1_bound_o)
        pairs = ", ".join(f"{work[k]} {k} (x{K1_OPS[k]})" for k in K1_OPS)
        print(f"[K1] bench frame: {bins.tile_start.shape[0]} tiles, "
              f"{int(bins.num_valid)} entries in range, {work['entries']} "
              f"read, (entry, pixel) pairs reached: {pairs} = {work['ops']} "
              f"FP32 operations; kernel {k1_ms:.4f} ms, plain "
              f"{k1_plain_ms:.4f} ms, bound {k1_bound:.4f} ms (bytes "
              f"{k1_bound_b:.4f}, operations {k1_bound_o:.4f})", flush=True)
        del feats, bins, args, proj, packets

        # ------------------------------------------------------------ 4
        kw = dict(active_sh_degree=d["sh_degree"], alive=alive,
                  dup_capacity=DUP_CAPACITY, max_per_tile=MAX_PER_TILE,
                  exact_cull=True)
        render(bench_camera(0), params, bg, **kw)          # warm the caches
        torch.cuda.synchronize()
        expand_rows.launches = raster_tiles_fwd.launches = 0
        outs, frame_s = [], []
        for i in range(FRAMES):
            cam = bench_camera(i)
            t0 = time.perf_counter()
            out = render(cam, params, bg, **kw)
            torch.cuda.synchronize()
            frame_s.append(time.perf_counter() - t0)
            outs.append(out)
        launches = {"K2": expand_rows.launches, "K1": raster_tiles_fwd.launches}
        for i, out in enumerate(outs):
            check(not bool(out.overflow), f"frame {i}: overflow")
            check(out.image.shape == (3, H, W), f"frame {i}: image shape")
            check(bool(torch.isfinite(out.image).all()), f"frame {i}: non-finite")
            check(0.0 <= float(out.image.min()) and float(out.image.max()) < 1.5,
                  f"frame {i}: image out of range")
        o = outs[0]
        covered = float((o.final_T < 0.5).float().mean())
        print(f"[serve] {FRAMES} frames {W}x{H}: num_duplicates "
              f"{int(o.num_duplicates)} (the JAX package on TPU: "
              f"{TPU_NUM_DUPLICATES}), num_valid {int(o.num_valid)}, "
              f"max_tile_len {int(o.max_tile_len)}, overflow False, "
              f"{covered:.1%} of pixels below T 0.5", flush=True)
        print(f"[serve] ms per frame (host clock, synchronised): "
              + ", ".join(f"{1e3 * s:.2f}" for s in frame_s)
              + f"; mean {1e3 * sum(frame_s) / FRAMES:.3f}", flush=True)
        print(f"[serve] launches over the {FRAMES} frames: {launches}", flush=True)
        check(int(o.num_duplicates) > 0 and int(o.num_valid) > 0, "empty frame")
        check(covered > 0.5, "the bench frame should be mostly covered")
        check(all(v > 0 for v in launches.values()), f"launches {launches}")
        del outs, o

        # where a frame's time goes: each stage timed alone by CUDA events
        cam = bench_camera(0)
        pr = preprocess(params, cam, active_sh_degree=3, alive=alive)
        pk = pack_projected(pr)
        stage_ms = {
            "preprocess": time_ms(torch, lambda: preprocess(
                params, cam, active_sh_degree=3, alive=alive), 10),
            "pack": time_ms(torch, lambda: pack_projected(pr), 10),
            "binning incl. K2": time_ms(torch, lambda: bin_gaussians_payload(
                pr, pk, W, H, 16, 16, DUP_CAPACITY, exact_cull=True), 10),
            "K2": k2_ms, "K1": k1_ms,
            "render()": time_ms(torch, lambda: render(cam, params, bg, **kw), 10),
        }
        print("[stages] ms by CUDA events: " + ", ".join(
            f"{k} {v:.4f}" for k, v in stage_ms.items()), flush=True)
        del pr, pk

        # the whole slice on the card against its plain versions on the CPU
        for backend_dev in (dev, torch.device("cpu")):
            sp = GaussianParams(*[t.to(backend_dev) for t in small])
            sc = make_camera(np.eye(3), np.zeros(3), math.radians(60), sfovy,
                             128, 96, device=backend_dev)
            so = render(sc, sp, torch.full((3,), 0.3, device=backend_dev),
                        active_sh_degree=3, dup_capacity=1 << 14,
                        max_per_tile=512, exact_cull=True)
            if backend_dev == dev:
                card_out = so
        for k in ("image", "invdepth", "final_T"):
            ok, mx, frac = images_match(getattr(card_out, k).cpu(), getattr(so, k))
            check(ok, f"small-scene render {k}: card vs CPU max {mx} frac {frac}")
        print(f"[slice] 300-gaussian 128x96 render(): card matches the CPU "
              f"plain path (image, invdepth, final_T)", flush=True)

        # orbit CLI: caps from a generous render of its own two cameras
        center, radius = view_orbit.orbit_geometry(d["xyz"], 1.0)
        nd_max, ml_max = 0, 0
        for i in range(2):
            cam = view_orbit.orbit_camera(center, radius, 0.3, math.pi * i, W,
                                          H, math.radians(70.0), device=dev)
            out = render(cam, params, bg, active_sh_degree=3, alive=alive,
                         dup_capacity=(1 << 24) - 1, max_per_tile=1 << 20,
                         exact_cull=True)
            check(not bool(out.overflow), "orbit pre-check overflow")
            nd_max = max(nd_max, int(out.num_duplicates))
            ml_max = max(ml_max, int(out.max_tile_len))
        orbit_cap = -(-int(nd_max * 1.05) // 1024) * 1024
        orbit_mpt = -(-int(ml_max * 1.1) // 128) * 128
        print(f"[orbit] caps: --dup_capacity {orbit_cap} --max_per_tile "
              f"{orbit_mpt} (num_duplicates {nd_max}, max_tile_len {ml_max})",
              flush=True)
        del out
    expand_rows.launches = raster_tiles_fwd.launches = 0
    log = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        view_orbit.main(["-m", model_dir, "--data_device", "cuda", "--frames",
                         "2", "--width", str(W), "--height", str(H),
                         "--dup_capacity", str(orbit_cap), "--max_per_tile",
                         str(orbit_mpt)])
    orbit_s = time.perf_counter() - t0
    orbit_launches = {"K2": expand_rows.launches, "K1": raster_tiles_fwd.launches}
    print(log.getvalue().strip().splitlines()[-1])
    pngs = sorted(os.listdir(os.path.join(model_dir, "orbit_30000")))
    print(f"[orbit] 2 frames in {orbit_s:.2f} s, {pngs}, launches "
          f"{orbit_launches}", flush=True)
    check("overflow" not in log.getvalue(), "orbit CLI reported overflow")
    check(pngs == ["00000.png", "00001.png"], "orbit PNGs")
    check(all(v == 2 for v in orbit_launches.values()),
          f"orbit launches {orbit_launches}")

    # one profiled frame: device time by kernel, and the device's busy share
    # of the unprofiled frame time measured above
    with torch.no_grad():
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            render(bench_camera(0), params, bg, **kw)
            torch.cuda.synchronize()
    events = prof.key_averages()
    kernels_run = [e for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels_run) / 1e3
    frame_ms = 1e3 * sum(frame_s) / FRAMES
    print(f"[profile] one bench frame: device busy {busy_ms:.4f} ms in "
          f"{sum(e.count for e in kernels_run)} kernel launches; against the "
          f"{frame_ms:.3f} ms frame the device is idle "
          f"{1 - busy_ms / frame_ms:.1%}", flush=True)
    print(events.table(sort_by="cuda_time_total", row_limit=12,
                       max_name_column_width=60), flush=True)
    tmp.cleanup()

    # ---------------------------------------------------------------- 5
    kernels = [
        {"name": "expand_rows", "id": "K2", "route": "cuda",
         "source": "gs_tpu_torch/csrc/expand.cu",
         "replaces": "gs_tpu/ops/expand_pallas.py:61",
         "launches": launches["K2"], "max_abs_err": k2_err,
         "ms": k2_ms, "kernel_ms": k2_ms, "plain_ms": k2_plain_ms,
         "bound_ms": k2_bound, "bound_by": "bytes" if k2_bytes /
         HBM_BYTES_PER_S >= k2_ops / FP32_OPS_PER_S else "operations",
         "library_ms": k2_lib_ms},
        {"name": "raster_tiles_fwd", "id": "K1", "route": "cuda",
         "source": "gs_tpu_torch/csrc/rasterize_fwd.cu",
         "replaces": "gs_tpu/ops/rasterize_pallas.py:125",
         "launches": launches["K1"], "max_abs_err": k1_err,
         "ms": k1_ms, "kernel_ms": k1_ms, "plain_ms": k1_plain_ms,
         "bound_ms": k1_bound,
         "bound_by": "bytes" if k1_bound_b >= k1_bound_o else "operations",
         "library_ms": None},
    ]
    print(f"[done] {time.perf_counter() - t_start:.1f} s in all", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
