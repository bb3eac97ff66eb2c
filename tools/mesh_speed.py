#!/usr/bin/env python3
"""Train one dataset through the training CLI on one device and sharded over
k ranks, and compare the two: the time per iteration and the saved
Gaussians.

Usage, from the repository root:

    python3 tools/mesh_speed.py [--ranks 4] [--iterations 200]

On a machine with k CUDA cards the sharded run is ``--mesh k`` (k ranks,
one per card, NCCL); with ``--device cpu`` it is k ``--multihost``
processes over gloo. The dataset is chip_smoke.py's [trainer] dataset: the
500,000-Gaussian bench scene's points and 8 views at 1920x1080 rendered by
K1 from the seed (``--points``/``--width``/``--height`` make it smaller).
Both runs train ``-r 1`` without densification (so both train the same
Gaussians), print ``[i/N] ... it/s`` every 100 iterations, and save the
point cloud at iteration HELD and at the last. Prints each run's iterations
per second over its last 100 iterations and how far the two point clouds
are apart, per field: the share of values beyond 2e-4 x the field's
largest magnitude and the largest difference. At HELD at most 1 % may lie
beyond (Adam's sign flips on gradients that are zero up to rounding, the
rule of tests/test_torch_trainer.py); later the sums' other order, through
Adam's normalised steps, carries the runs apart, so the last iteration's
gap is reported, not held. Exits non-zero if a run fails or the rule does
not hold.
"""
from __future__ import annotations

import argparse
import math
import os
import re
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HELD = 20          # the iteration whose point clouds are held to the rule


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run(cmds_envs, log_dir, name):
    """Start each (command, environment) at once; wait; rank 0's output."""
    procs = []
    for i, (cmd, env) in enumerate(cmds_envs):
        f = open(os.path.join(log_dir, f"{name}{i}.log"), "w")
        procs.append((subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=f,
                                       stderr=subprocess.STDOUT), f))
    rcs = []
    for p, f in procs:
        rcs.append(p.wait())
        f.close()
    outs = [open(os.path.join(log_dir, f"{name}{i}.log")).read()
            for i in range(len(procs))]
    for i, rc in enumerate(rcs):
        if rc:
            print(outs[i][-4000:], file=sys.stderr)
            raise SystemExit(f"{name}: process {i} exited with {rc}")
    return outs[0]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--iterations", type=int, default=200)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--points", type=int, default=500_000)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    args = ap.parse_args()

    import torch
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from gs_tpu_torch.core.camera import focal2fov, make_camera
    from gs_tpu_torch.data.ply import load_gaussian_ply
    from gs_tpu_torch.models.gaussian_model import create_from_pcd
    from gs_tpu_torch.ops import _cuda
    from gs_tpu_torch.render import render

    dev = torch.device(args.device)
    if dev.type == "cuda":
        cards = torch.cuda.device_count()
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip(), flush=True)
        if cards < args.ranks:
            raise SystemExit(f"{args.ranks} ranks need {args.ranks} cards; "
                             f"this machine has {cards}")
        _cuda.build()
    cs.W, cs.H, n = args.width, args.height, args.points
    rng = np.random.default_rng(0)
    pts = np.concatenate([rng.uniform(-3.5, 3.5, (n, 1)),
                          rng.uniform(-2.0, 2.0, (n, 1)),
                          rng.uniform(2.5, 9.0, (n, 1))], axis=1)
    cols = rng.uniform(0, 1, (n, 3))
    p0, alive0 = create_from_pcd(pts, cols, sh_degree=3, device=dev)
    p0 = p0._replace(log_scale=p0.log_scale + math.log(0.3))
    tmp, root, _ = cs.trainer_dataset(torch, dev, pts, cols, p0, alive0)
    # the frames' entries, for buffers no view overflows
    fovx = math.radians(70.0)
    cam = make_camera(np.eye(3), np.array([0.0, 0.0, cs.TRAINER_BACK]), fovx,
                      focal2fov(cs.W / (2 * math.tan(fovx / 2)), cs.H), cs.W,
                      cs.H, device=dev)
    with torch.no_grad():
        full, _ = create_from_pcd(pts, cols, sh_degree=3, device=dev)
        out = render(cam, full, torch.zeros(3, device=dev), active_sh_degree=3,
                     dup_capacity=(1 << 24) - 512, max_per_tile=1 << 16,
                     exact_cull=True)
    dup = -(-int(int(out.num_duplicates) * 1.5) // 512) * 512
    del p0, alive0, full, out
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    it = args.iterations
    common = ["-s", root, "-r", "1", "--iterations", str(it),
              "--densify_from_iter", str(10 * it), "--test_iterations",
              str(10 * it), "--save_iterations", str(HELD), str(it),
              "--dup_capacity", str(dup), "--max_per_tile", "4096",
              "--disable_viewer", "--data_device", args.device]
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="4")
    runs = {}
    for name, k in (("one device", 1), (f"{args.ranks} ranks", args.ranks)):
        model = os.path.join(tmp.name, f"model_{k}")
        cmd = [sys.executable, "-m", "gs_tpu_torch.apps.train", *common,
               "-m", model]
        t0 = time.perf_counter()
        if k == 1:
            out = _run([(cmd, env)], tmp.name, "one")
        elif dev.type == "cuda":
            out = _run([(cmd + ["--mesh", str(k)], env)], tmp.name, "mesh")
        else:
            port = _free_port()
            out = _run([(cmd + ["--multihost"],
                         dict(env, GS_TPU_COORD=f"127.0.0.1:{port}",
                              GS_TPU_NPROCS=str(k), GS_TPU_PROCID=str(r)))
                        for r in range(k)], tmp.name, "multihost")
        wall = time.perf_counter() - t0
        rates = re.findall(r"\[(\d+)/\d+\] loss=\S+ pts=\d+ ([\d.]+) it/s", out)
        sharded = re.findall(r"Sharding gaussians over .*", out)
        runs[name] = dict(
            its=float(rates[-1][1]) if rates else float("nan"), wall=wall,
            ply={i: load_gaussian_ply(os.path.join(
                model, "point_cloud", f"iteration_{i}", "point_cloud.ply"))
                for i in (HELD, it)})
        print(f"[mesh speed] {name}: {sharded[0] if sharded else 'one device'}; "
              f"{runs[name]['its']:.3f} it/s over iterations "
              f"{int(rates[-1][0]) - 99 if rates else '?'}..{it} "
              f"({1e3 / runs[name]['its']:.3f} ms per iteration); "
              f"{wall:.1f} s with start-up", flush=True)
    ok = True
    for i in (HELD, it):
        a, b = (runs[k]["ply"][i] for k in runs)
        worst = {}
        for key in a:
            va = np.asarray(a[key], np.float64)
            vb = np.asarray(b[key], np.float64)
            if va.shape != vb.shape:
                raise SystemExit(f"{key}: shapes {va.shape} and {vb.shape}")
            if va.dtype.kind != "f" or va.size == 0:
                continue
            diff = np.abs(va - vb)
            worst[key] = (float((diff > 2e-4 * np.abs(va).max()).mean()),
                          float(diff.max()))
        if i == HELD:
            ok = all(v[0] <= 0.01 for v in worst.values())
        print(f"[mesh speed] the two point clouds after {i} iterations, per "
              f"field (share beyond 2e-4 x max, max |diff|"
              f"{'; held: at most 1 %' if i == HELD else ''}): " + ", ".join(
                  f"{k} {v[0]:.3%} {v[1]:.3e}" for k, v in worst.items()),
              flush=True)
    one, many = (runs[k]["its"] for k in runs)
    print(f"[mesh speed] {args.ranks} ranks at {many / one:.3f}x one "
          f"device's iterations per second", flush=True)
    tmp.cleanup()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
