#!/usr/bin/env python3
"""Train one dataset through the training CLI on one device and sharded over
k ranks, and compare the two: the time per iteration and the saved
Gaussians.

Usage, from the repository root:

    python3 tools/mesh_speed.py [--ranks 4] [--iterations 200] [--block]
                                [--schedule]

On a machine with k CUDA cards the sharded run is ``--mesh k`` (k ranks,
one per card, NCCL); with ``--device cpu`` it is k ``--multihost``
processes over gloo. The dataset is chip_smoke.py's [trainer] dataset: the
500,000-Gaussian bench scene's points and 8 views at 1920x1080 rendered by
K1 from the seed (``--points``/``--width``/``--height`` make it smaller).
Both runs train ``-r 1`` without densification (so both train the same
Gaussians), in step mode, or with ``--block`` in block mode (the CLI's
default on CUDA); on CUDA both modes replay the chain's CUDA graph of the
step, one replay an iteration, under ``--mesh k`` with its NCCL
collectives captured. Each run prints ``[i/N] ... it/s`` every 100
iterations and saves the point cloud at iteration HELD and at the last. Prints each
run's iterations per second over its last 100 iterations and how far the
two point clouds are apart, per field: the share of values beyond 2e-4 x
the field's largest magnitude and the largest difference. At HELD at most
1 % may lie beyond (Adam's sign flips on gradients that are zero up to
rounding, the rule of tests/test_torch_trainer.py); later the sums' other
order, through Adam's normalised steps, carries the runs apart, so the
last iteration's gap is reported, not held. With ``--schedule`` both runs
also densify every 50 iterations from 50 (the graphed densify and its
gathers), reset the opacities at 100 and render their test and training
views after the last iteration (the banded view's graph under ``--mesh
k``), with the test views held out (``--eval``); the sharded run must
still exit, which it does only if the group's close released every graph
that captured its collectives. A third run then trains k ranks again with
the trainer's density control, step mode's step and views eager (its
``_eager_dispatch``, which no flag of the CLI sets: the ranks run
EAGER_CLI), and its point clouds at HELD, after the first densify (50)
and at the last iteration must be byte for byte the sharded run's: the
captured densify, with its gathers, is the eager one. Exits non-zero if a
run fails or a rule does not hold.
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
FIRST_DENSIFY = 50  # --schedule's first densify
# the train CLI with every Trainer's ``_eager_dispatch`` set
EAGER_CLI = """
import runpy
from gs_tpu_torch.train.loop import Trainer
init = Trainer.__init__
def eager(self, *args, **kwargs):
    init(self, *args, **kwargs)
    self._eager_dispatch = True
Trainer.__init__ = eager
runpy.run_module("gs_tpu_torch.apps.train", run_name="__main__")
"""


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


def _ranks(cmd, k, env):
    """``cmd`` as the k ranks of a --multihost group on this machine (rank
    r on card r)."""
    port = _free_port()
    return [(cmd + ["--multihost"],
             dict(env, GS_TPU_COORD=f"127.0.0.1:{port}",
                  GS_TPU_NPROCS=str(k), GS_TPU_PROCID=str(r)))
            for r in range(k)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--iterations", type=int, default=200)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--points", type=int, default=500_000)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--block", action="store_true",
                    help="train both runs in block mode (else step mode)")
    ap.add_argument("--schedule", action="store_true",
                    help="densify every 50 iterations from 50, reset the "
                    "opacities at 100 and evaluate the views at the end")
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
    events = (["--eval", "--densify_from_iter", "25",
               "--densification_interval", "50", "--densify_until_iter",
               str(it + 1), "--opacity_reset_interval", "100",
               "--test_iterations", str(it)] if args.schedule else
              ["--densify_from_iter", str(10 * it), "--test_iterations",
               str(10 * it)])
    saves = (HELD, FIRST_DENSIFY, it) if args.schedule else (HELD, it)
    common = ["-s", root, "-r", "1", "--iterations", str(it), *events,
              "--save_iterations", *map(str, saves),
              "--dup_capacity", str(dup), "--max_per_tile", "4096",
              "--disable_viewer", "--data_device", args.device,
              "--block_scan" if args.block else "--no_block_scan"]
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="4")
    runs = {}
    k = args.ranks
    sharded, eager = f"{k} ranks", f"{k} ranks, eager"
    plan = [("one device", 1), (sharded, k)]
    if args.schedule:
        plan.append((eager, k))
    for name, k in plan:
        model = os.path.join(tmp.name, f"model_{len(runs)}")
        cli = (["-c", EAGER_CLI] if name == eager
               else ["-m", "gs_tpu_torch.apps.train"])
        cmd = [sys.executable, *cli, *common, "-m", model]
        t0 = time.perf_counter()
        if k == 1:
            out = _run([(cmd, env)], tmp.name, "one")
        elif dev.type == "cuda" and name != eager:
            out = _run([(cmd + ["--mesh", str(k)], env)], tmp.name, "mesh")
        else:
            out = _run(_ranks(cmd, k, env), tmp.name, f"ranks{len(runs)}")
        wall = time.perf_counter() - t0
        rates = re.findall(r"\[(\d+)/\d+\] loss=\S+ pts=\d+ ([\d.]+) it/s", out)
        shard_line = re.findall(r"Sharding gaussians over .*", out)
        for line in re.findall(r"\[ITER \d+\] Evaluating .*|\[gs_tpu_torch\] "
                               r"captured the (?:densify|reset|\d+x\d+ view)"
                               r".*", out):
            print(f"[mesh speed] {name}: {line}", flush=True)
        plys = {i: os.path.join(model, "point_cloud", f"iteration_{i}",
                                "point_cloud.ply") for i in saves}
        runs[name] = dict(
            its=float(rates[-1][1]) if rates else float("nan"), wall=wall,
            ply={i: load_gaussian_ply(f) for i, f in plys.items()},
            bytes={i: open(f, "rb").read() for i, f in plys.items()})
        where = shard_line[0] if shard_line else "one device"
        print(f"[mesh speed] {name}: {where}; "
              f"{runs[name]['its']:.3f} it/s over iterations "
              f"{int(rates[-1][0]) - 99 if rates else '?'}..{it} "
              f"({1e3 / runs[name]['its']:.3f} ms per iteration); "
              f"{wall:.1f} s with start-up", flush=True)
    ok = True
    for i in (HELD, it):
        a, b = (runs[k]["ply"][i] for k in ("one device", sharded))
        if i != HELD and len(a["xyz"]) != len(b["xyz"]):
            # a densify's clone and split decisions sit on gradient
            # thresholds, which the sums' other order can cross
            print(f"[mesh speed] after {i} iterations the two runs keep "
                  f"{len(a['xyz'])} and {len(b['xyz'])} Gaussians",
                  flush=True)
            continue
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
    if args.schedule:
        same = {i: runs[sharded]["bytes"][i] == runs[eager]["bytes"][i]
                for i in saves}
        ok = ok and all(same.values())
        sizes = {i: len(runs[sharded]["ply"][i]["xyz"]) for i in saves}
        print(f"[mesh speed] {sharded} against {eager} (density control, "
              f"step and views eager), the PLYs byte for byte equal (held) "
              f"after " + ", ".join(
                  f"{i} iterations: {same[i]} ({sizes[i]} Gaussians)"
                  for i in saves), flush=True)
    one, many = (runs[k]["its"] for k in ("one device", sharded))
    print(f"[mesh speed] {args.ranks} ranks at {many / one:.3f}x one "
          f"device's iterations per second, both in "
          f"{'block' if args.block else 'step'} mode", flush=True)
    tmp.cleanup()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
