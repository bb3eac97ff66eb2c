#!/usr/bin/env python3
"""Time the packed bench training step of this checkout against another
checkout's, eager (step mode), and this checkout's step as a CUDA-graph
replay (``gs_tpu_torch.train.graph.make_train_step_chain``).

Usage, from the repository root on a machine with one CUDA card and nvcc:

    git archive <commit> gs_tpu_torch | tar -x -C .ab_parent
    python3 tools/step_speed.py --other .ab_parent [--steps 8]

``--other`` is a directory that holds another version's ``gs_tpu_torch/``
(for example the parent commit's); each version builds its own kernels
into its own ``gs_tpu_torch/_build/``. The step is chip_smoke.py's
[packed step]: the bench scene (``bench_scene``, 500,000 Gaussians in
510,976 slots) at 1920x1080 against a zero image, packed layout,
``OptimizationConfig(iterations=30000)``. Each version runs in its own
process, in turns (other, this, this, other): two warm-up steps, then
``--steps`` steps, each timed by the host clock between two
synchronisations, and three more steps profiled one by one
(torch.profiler: the device's busy time and the kernel count of one step).
Every run starts from the same state, so the losses of all runs must be
equal. Prints the card's name and power limit first, one JSON line per
run, and the medians; exits 1 if two runs' losses differ.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def worker(pkg_root: str, steps: int, graph: bool) -> int:
    import math
    import time
    sys.path.insert(0, os.path.abspath(pkg_root))
    sys.path.insert(1, ROOT)
    import torch
    import chip_smoke
    from torch.profiler import ProfilerActivity, profile
    from gs_tpu_torch.config import (ModelConfig, OptimizationConfig,
                                     PipelineConfig, RasterConfig)
    from gs_tpu_torch.core.camera import focal2fov, make_camera, stack_cameras
    from gs_tpu_torch.models.gaussian_model import init_state
    from gs_tpu_torch.models.packed_state import pack_state
    from gs_tpu_torch.train.step import make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    w, h = chip_smoke.W, chip_smoke.H
    _, _, p0, alive0 = chip_smoke.bench_scene(torch, dev)
    fovx = math.radians(70.0)
    cam = make_camera(np.eye(3), np.zeros(3), fovx,
                      focal2fov(w / (2 * math.tan(fovx / 2)), h), w, h,
                      device=dev)
    raster = RasterConfig(backend="auto",
                          dup_capacity=chip_smoke.DUP_CAPACITY,
                          max_per_tile=chip_smoke.MAX_PER_TILE, chunk=64,
                          exact_cull=True)
    step = make_train_step(OptimizationConfig(iterations=30_000),
                           ModelConfig(), PipelineConfig(), raster,
                           stack_cameras([cam]), 1.0, 3, packed=True)
    s0 = pack_state(init_state(p0, alive0, num_images=1))
    gt = torch.zeros((3, h, w), device=dev)
    n = steps + 2

    if graph:
        from gs_tpu_torch.train.graph import (TrainingData,
                                              make_train_step_chain)
        chain = make_train_step_chain(step, use_alpha=False,
                                      use_depth=False, bucket=n + 3)
        its = np.arange(1, n + 4)
        floats = torch.zeros((len(its), 6))
        floats[:, :3] = torch.from_numpy(step.schedule(its))
        chain.load(torch.from_numpy(np.stack([np.zeros_like(its), its], 1)),
                   floats, its)
        data = TrainingData(gt[None])
        chain.bind(s0, data)
        holder = [chain.state]

        def run(i):
            holder[0], m = chain(holder[0], data, i - 1)
            return m
    else:
        holder = [s0]

        def run(i):
            holder[0], m = step(holder[0], 0, gt, iteration=i)
            return m

    times, losses = [], []
    for i in range(1, n + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = run(i)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
        losses.append(float(m.loss))
    busy, kernels = [], 0
    for i in range(n + 1, n + 4):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run(i)
            torch.cuda.synchronize()
        ev = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
        busy.append(sum(e.self_device_time_total for e in ev) / 1e3)
        kernels = sum(e.count for e in ev)
    print(json.dumps({"ms": float(np.median(times[2:])), "times": times[2:],
                      "busy_ms": float(np.median(busy)), "kernels": kernels,
                      "losses": losses}))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True,
                    help="a directory that holds another gs_tpu_torch/")
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    ap.add_argument("--graph", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        return worker(args.worker, args.steps, args.graph)
    if not os.path.isdir(os.path.join(args.other, "gs_tpu_torch")):
        raise SystemExit(f"{args.other} holds no gs_tpu_torch/")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    runs = {"other": [], "this": [], "this graph": []}
    order = [("other", args.other, False), ("this", ROOT, False),
             ("this graph", ROOT, True), ("this graph", ROOT, True),
             ("this", ROOT, False), ("other", args.other, False)]
    for name, root, graph in order:
        cmd = [sys.executable, os.path.abspath(__file__), "--other",
               args.other, "--worker", root, "--steps", str(args.steps)]
        res = subprocess.run(cmd + (["--graph"] if graph else []),
                             capture_output=True, text=True, timeout=900)
        if res.returncode != 0:
            print(res.stdout[-3000:], res.stderr[-3000:], flush=True)
            return 1
        out = json.loads(res.stdout.strip().splitlines()[-1])
        runs[name].append(out)
        print(json.dumps({"version": name, **out}), flush=True)
    losses = [r["losses"] for v in runs.values() for r in v]
    same = all(x == losses[0] for x in losses)
    print(f"losses of every run equal: {same}", flush=True)
    for name, rs in runs.items():
        print(f"{name}: ms per step " + ", ".join(f"{r['ms']:.3f}" for r in rs)
              + "; device busy " + ", ".join(f"{r['busy_ms']:.4f}" for r in rs)
              + f" ms in {rs[0]['kernels']} kernels", flush=True)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
