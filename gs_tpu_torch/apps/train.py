"""Offline training CLI — port of ``gs_tpu/apps/train.py``, the reference
``train.py`` (ref: train.py:43-273).

Usage: ``python -m gs_tpu_torch.apps.train -s <dataset> [-m <model_dir>] [...]``

Dataset load, the 30k-iteration schedule with densify/prune, periodic test
PSNR reports, PLY saves at --save_iterations, checkpoints at
--checkpoint_iterations (``chkpnt{i}.pth``), resume via --start_checkpoint
or --resume, TensorBoard scalars when ``torch.utils.tensorboard`` imports,
and a ``torch.profiler`` trace of warm iterations with --profile. The model
dir has the JAX package's layout (``cfg_args``, ``config.json``,
``cameras.json``, ``input.ply``, ``point_cloud/iteration_N/``).

Training runs on ``--data_device`` (``cuda`` by default), where the training
images live. On a CUDA device the default is block mode, as the JAX CLI's
on its accelerator (``gs_tpu/apps/train.py:340-341``): schedule-aligned
blocks with one sync each, dispatched as CUDA graphs of the step
(``train/graph.py``), under --mesh and --multihost too (the graphs then
hold the NCCL collectives); --no_block_scan keeps step mode, which on CUDA
replays one captured CUDA graph of the step per iteration
(``train/graph.py::ChainStep.step``), as the JAX CLI dispatches its
jitted step once per iteration. Elsewhere step mode is the default (the
step's body run eagerly) and --block_scan asks for blocks. Test views and
the viewer's frames replay a captured graph of the view on CUDA, banded
under a mesh (``render.py::ViewGraph``), and each densify and opacity
reset one of density control (``train/graph.py::DensityGraph``). Unless
--disable_viewer is given, a SIBR-protocol viewer server listens on
--ip:--port (``viewer/server.py``) and is polled after every iteration
(after every block in block mode, whose length is then capped to about a
second of iterations); a port that cannot be bound is reported and
training goes on. A checkpoint may be the port's or the
JAX package's (``train/checkpoint.py``).

Several devices (``gs_tpu/apps/train.py:75-151``): ``--mesh N`` (or
``auto``, every visible card) shards the Gaussians over N CUDA devices of
this machine, one process per card: the CLI starts N copies of itself with
a local ``torch.distributed`` rendezvous, unless a launcher (torchrun) has
set ``WORLD_SIZE``/``RANK`` already. ``--multihost`` forms the group from
the environment (``GS_TPU_COORD``/``GS_TPU_NPROCS``/``GS_TPU_PROCID``, or
torchrun's), NCCL on ``cuda`` and gloo on ``cpu``. A mesh larger than the
cards present raises; nothing falls back to one device. Rank 0 owns the
model dir (config, TensorBoard, snapshots, checkpoints, gathered from every
rank); the other ranks write nothing, and the viewer is off.
"""
from __future__ import annotations

import glob
import os
import random
import re
import socket
import subprocess
import sys
import time
import uuid

import torch

from ..config import (ModelConfig, OptimizationConfig, PipelineConfig,
                      RasterConfig, save_config)
from ..core.gaussians import get_opacity
from ..data.scene import Scene
from ..parallel.mesh import init_from_env
from ..train.checkpoint import load_checkpoint, save_checkpoint
from ..train.loop import Trainer
from ..viewer.server import ViewerServer
from .args import extract_dataclass, make_parser, resolve_data_device

SPAWNED = "spawned"    # make_group's answer when this process only launched
# the directory that holds gs_tpu_torch, for the ranks --mesh N starts
PACKAGE_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def prepare_output_dir(model_cfg: ModelConfig) -> str:
    """ref: train.py:185-205 (prepare_output_and_logger)."""
    path = model_cfg.model_path
    if not path:
        unique = os.getenv("OAR_JOB_ID") or str(uuid.uuid4())
        path = os.path.join("./output/", unique[:10])
    print(f"Output folder: {path}")
    os.makedirs(path, exist_ok=True)
    return path


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_ranks(n: int, cmd) -> None:
    """Run ``cmd`` (this CLI, by default) as ``n`` processes, rank i on card
    i, over a local ``torch.distributed`` rendezvous. Every rank is polled:
    the first that exits non-zero stops the others at once (they would wait
    in a collective for it) and raises."""
    port = _free_port()
    procs = []
    for rank in range(n):
        env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   WORLD_SIZE=str(n), RANK=str(rank), LOCAL_RANK=str(rank),
                   PYTHONPATH=os.pathsep.join(
                       [PACKAGE_ROOT] + os.environ.get("PYTHONPATH", "")
                       .split(os.pathsep)).rstrip(os.pathsep))
        procs.append(subprocess.Popen(cmd, env=env))
    failed = None
    try:
        while failed is None:
            codes = [proc.poll() for proc in procs]
            failed = next(((rank, code) for rank, code in enumerate(codes)
                           if code not in (None, 0)), None)
            if failed is None and all(code == 0 for code in codes):
                return
            time.sleep(0.1)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    raise RuntimeError(f"--mesh {n}: rank {failed[0]} exited with "
                       f"{failed[1]}; the other ranks were stopped")


def make_group(args, device_type: str, argv):
    """The group the flags ask for: None for one device; a ProcessGroup
    under --multihost, or for --mesh N in a process a launcher started;
    SPAWNED after running the N ranks of --mesh N as child processes."""
    launched = "WORLD_SIZE" in os.environ and "RANK" in os.environ
    single = args.mesh in ("", "0", "1")
    if args.multihost or (launched and not single):
        group = init_from_env(device_type)
        if args.mesh not in ("", "0", "1", "auto") and \
                int(args.mesh) != group.size:
            raise ValueError(f"--mesh {args.mesh} disagrees with the "
                             f"launcher's {group.size} ranks")
        return group
    if single:
        return None
    cards = torch.cuda.device_count() if device_type == "cuda" else 0
    n = cards if args.mesh == "auto" else int(args.mesh)
    if args.mesh == "auto" and n <= 1:
        return None
    if n > cards:
        raise RuntimeError(f"--mesh {args.mesh} needs {n} CUDA devices, and "
                           f"this machine has {cards} for --data_device "
                           f"{device_type}")
    spawn_ranks(n, [sys.executable, "-m", "gs_tpu_torch.apps.train", *argv])
    return SPAWNED


def main(argv=None, *, group=None):
    """Train. ``group``: shard over this group (``parallel/mesh.py``, e.g.
    a ``LocalGroup``) instead of what --mesh/--multihost ask for. Returns
    the Trainer (None in a process that only started the --mesh ranks)."""
    if argv is None:
        argv = sys.argv[1:]
    parser = make_parser("Training script parameters")
    parser.add_argument("--ip", type=str, default="127.0.0.1")
    parser.add_argument("--port", type=int, default=6009)
    parser.add_argument("--disable_viewer", action="store_true")
    parser.add_argument("--test_iterations", nargs="+", type=int,
                        default=[7_000, 30_000])
    parser.add_argument("--save_iterations", nargs="+", type=int,
                        default=[7_000, 30_000])
    parser.add_argument("--checkpoint_iterations", nargs="+", type=int,
                        default=[])
    parser.add_argument("--checkpoint_every", type=int, default=0,
                        help="periodic checkpoint interval (recovery story: "
                             "crash -> --resume restarts from the latest)")
    parser.add_argument("--start_checkpoint", type=str, default=None)
    parser.add_argument("--resume", action="store_true",
                        help="resume from the newest chkpnt*.pth in the "
                             "model dir, if any")
    parser.add_argument("--quiet", action="store_true")
    parser.add_argument("--detect_anomaly", action="store_true")
    parser.add_argument("--block_scan", action="store_true",
                        help="run schedule-aligned blocks of steps with one "
                             "sync each (the default on a CUDA device)")
    parser.add_argument("--no_block_scan", action="store_true",
                        help="step mode, on any device")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--profile", type=str, default="",
                        help="directory for a torch.profiler trace (Chrome "
                             "trace JSON) of --profile_steps iterations, "
                             "started once training is warm")
    parser.add_argument("--profile_steps", type=int, default=50)
    parser.add_argument("--initial_capacity", type=int, default=0,
                        help="starting gaussian capacity (0 = auto)")
    parser.add_argument("--mesh", type=str, default="0",
                        help="shard the gaussians over devices: 'auto' = "
                             "every visible CUDA card, an integer = that "
                             "many (one process each); 0/1 = one device")
    parser.add_argument("--multihost", action="store_true",
                        help="form the torch.distributed group from the "
                             "environment (GS_TPU_COORD/GS_TPU_NPROCS/"
                             "GS_TPU_PROCID, or torchrun's); one shard per "
                             "process, NCCL on cuda, gloo on cpu. Saves and "
                             "logs happen on rank 0 only")
    args = parser.parse_args(argv)

    if args.detect_anomaly:
        torch.autograd.set_detect_anomaly(True)   # ref: train.py:253,269

    model_cfg = extract_dataclass(ModelConfig, args)
    model_cfg.data_device = str(resolve_data_device(model_cfg.data_device))
    opt = extract_dataclass(OptimizationConfig, args)
    pipe = extract_dataclass(PipelineConfig, args)
    raster = extract_dataclass(RasterConfig, args)
    args.save_iterations.append(opt.iterations)

    own_group = group is None
    if own_group:
        group = make_group(args, torch.device(model_cfg.data_device).type,
                           argv)
        if group is SPAWNED:
            return None
    try:
        return _train(args, model_cfg, opt, pipe, raster, group)
    finally:
        if own_group and group is not None:
            group.close()


def _train(args, model_cfg, opt, pipe, raster, group):
    is_main = group is None or group.is_main
    # one process drives every shard: the viewer may run in it
    one_process = group is None or len(group.local) == group.size
    if is_main:
        model_cfg.model_path = prepare_output_dir(model_cfg)
        save_config(model_cfg.model_path, model_cfg, pipe, opt)
    if group is not None:
        model_cfg.data_device = str(group.device)
        if is_main:
            print(f"Sharding gaussians over {group.size} devices "
                  f"({group.size // len(group.local)} process(es))")

    tb_writer = None
    if is_main:
        try:
            from torch.utils.tensorboard import SummaryWriter
            tb_writer = SummaryWriter(model_cfg.model_path)
        except ImportError:
            print("Tensorboard not available: not logging progress")

    # the Scene's camera shuffle uses Python's global RNG
    random.seed(args.seed)

    print(f"Optimizing {model_cfg.model_path}")

    def open_scene():
        # only rank 0 writes the model dir (Scene writes nothing without one)
        return Scene(model_cfg.source_path,
                     model_cfg.model_path if is_main else "",
                     images=model_cfg.images, depths=model_cfg.depths,
                     resolution=model_cfg.resolution,
                     white_background=model_cfg.white_background,
                     eval_split=model_cfg.eval,
                     train_test_exp=model_cfg.train_test_exp,
                     device=model_cfg.data_device)

    if one_process:
        scene = open_scene()
    else:
        # the first open of a dataset writes its point cloud beside it
        # (points3D.bin -> .ply, or a Blender scene's random cloud): rank 0
        # writes it before the other ranks read it
        scene = open_scene() if is_main else None
        group.barrier()
        if scene is None:
            scene = open_scene()

    start_state, start_iter = None, 0
    ckpt_path = args.start_checkpoint
    if args.resume and not ckpt_path:
        cands = glob.glob(os.path.join(model_cfg.model_path, "chkpnt*.pth"))
        if cands:
            ckpt_path = max(cands, key=lambda p: int(
                re.search(r"chkpnt(\d+)", p).group(1)))
    if ckpt_path:
        start_state, start_iter, _ = load_checkpoint(
            ckpt_path, device=model_cfg.data_device)
        print(f"Resumed from {ckpt_path} at iteration {start_iter}")

    trainer = Trainer(
        scene.get_train_cameras(), scene.point_cloud,
        spatial_lr_scale=scene.cameras_extent,
        model_cfg=model_cfg, opt=opt, pipe=pipe, raster=raster,
        test_cams=scene.get_test_cameras(),
        start_state=start_state, start_iteration=start_iter, seed=args.seed,
        initial_capacity=args.initial_capacity or None, mesh=group)

    viewer = None
    if not one_process and not args.disable_viewer:
        # the viewer would render on rank 0 alone, and the banded render is
        # a collective of every rank
        if is_main:
            print("Viewer disabled with several processes")
    elif not args.disable_viewer:
        try:
            viewer = ViewerServer(args.ip, args.port, trainer=trainer,
                                  source_path=model_cfg.source_path)
            print(f"GUI server started at {args.ip}:{viewer.port}")
        except OSError as e:   # port in use etc.: train anyway
            print(f"Viewer server unavailable: {e}")

    save_at = set(args.save_iterations)
    ckpt_at = set(args.checkpoint_iterations)
    t_start = time.perf_counter()
    last_log = [t_start, start_iter]

    # while a viewer client is attached, cap block-scan blocks to ~1 s of
    # iterations so the client gets frames at interactive rates (the
    # reference drains its socket every iteration, train.py:72-86)
    rate = [t_start, start_iter, 8.0]   # [t_prev, i_prev, its_ema]

    def block_cap():
        if viewer is None:
            return None
        if viewer.conn is None:
            viewer.try_connect()
        if viewer.conn is None:
            return None
        return min(64, max(1, int(rate[2])))

    # a torch.profiler trace over a warm window of the run, so it shows
    # steady-state steps and not the first kernel build
    prof = {"profiler": None, "start": None}

    def stop_profile():
        prof["profiler"].stop()
        path = os.path.join(args.profile, "trace.json")
        prof["profiler"].export_chrome_trace(path)
        prof["profiler"] = None
        print(f"[profile] trace written to {path}")

    def profile_tick(i):
        if not args.profile:
            return
        if prof["profiler"] is None and prof["start"] is None \
                and i >= start_iter + 2:
            os.makedirs(args.profile, exist_ok=True)
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.device(model_cfg.data_device).type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof["profiler"] = torch.profiler.profile(activities=acts)
            prof["profiler"].start()
            prof["start"] = i
            print(f"[profile] tracing {args.profile_steps} iterations "
                  f"to {args.profile}")
        elif prof["profiler"] is not None \
                and i >= prof["start"] + args.profile_steps:
            stop_profile()

    def on_step(i, metrics, tr):
        profile_tick(i)
        if viewer is not None:
            viewer.poll()
            t = time.perf_counter()
            if i > rate[1] and t > rate[0]:
                its = (i - rate[1]) / (t - rate[0])
                rate[2] = 0.5 * rate[2] + 0.5 * its
            rate[0], rate[1] = t, i
        now = time.perf_counter()
        # the alive count is a collective under a group: every rank reads
        # it where any rank needs it
        n_alive = None
        if (i % 10 == 0 and (tb_writer is not None or group is not None)) \
                or (not args.quiet and i % 100 == 0):
            n_alive = tr.num_alive()
        if tb_writer is not None and i % 10 == 0:
            tb_writer.add_scalar("train_loss_patches/total_loss",
                                 float(metrics.loss), i)
            tb_writer.add_scalar("train_loss_patches/l1_loss",
                                 float(metrics.l1), i)
            tb_writer.add_scalar("total_points", n_alive, i)
            if tr.overflow_exhausted:
                tb_writer.add_scalar("overflow_replay_exhausted",
                                     tr.overflow_exhausted, i)
        if not args.quiet and i % 100 == 0 and is_main:
            its = (i - last_log[1]) / max(now - last_log[0], 1e-9)
            last_log[0], last_log[1] = now, i
            print(f"[{i}/{opt.iterations}] loss={tr.ema_loss:.5f} "
                  f"pts={n_alive} {its:.2f} it/s", flush=True)
        periodic = (args.checkpoint_every > 0 and
                    i % args.checkpoint_every == 0 and i != start_iter)
        if not (i in save_at or i in ckpt_at or periodic):
            return
        tr.sync_metrics()   # replay any overflow before saving
        state = tr.full_state()      # every rank takes part in the gather
        if not is_main:
            return
        if i in save_at:
            print(f"\n[ITER {i}] Saving Gaussians")
            scene.save(i, state.params, state.alive,
                       exposure=state.exposure
                       if model_cfg.train_test_exp else None)
        if i in ckpt_at or periodic:
            print(f"\n[ITER {i}] Saving Checkpoint")
            save_checkpoint(os.path.join(model_cfg.model_path,
                                         f"chkpnt{i}.pth"),
                            state, i, tr.spatial_lr_scale)

    def on_test(i, report, tr):
        state = tr.full_state()      # every rank takes part in the gather
        if not is_main:
            return
        for split, r in report.items():
            if not r:
                continue
            print(f"\n[ITER {i}] Evaluating {split}: L1 {r['l1']:.4f} "
                  f"PSNR {r['psnr']:.2f}")
            if tb_writer is not None:
                tb_writer.add_scalar(f"{split}/loss_viewpoint - l1_loss",
                                     r["l1"], i)
                tb_writer.add_scalar(f"{split}/loss_viewpoint - psnr",
                                     r["psnr"], i)
        if tb_writer is not None:
            # opacity histogram + total points (ref: train.py:239-241)
            alive = state.alive
            op = get_opacity(state.params)[alive]
            tb_writer.add_histogram("scene/opacity_histogram",
                                    op.cpu().numpy(), i)
            tb_writer.add_scalar("total_points", int(alive.sum()), i)

    boundaries = set(save_at) | set(ckpt_at)
    if args.checkpoint_every > 0:
        boundaries |= set(range(args.checkpoint_every, opt.iterations + 1,
                                args.checkpoint_every))
    block_scan = (args.block_scan or trainer.device.type == "cuda") \
        and not args.no_block_scan
    try:
        elapsed = trainer.train(
            test_iterations=set(args.test_iterations), on_step=on_step,
            on_test=on_test, log_every=1, block_scan=block_scan,
            boundary_iterations=boundaries, block_cap=block_cap)
    finally:
        if viewer is not None:
            viewer.close()
    print(f"\nTraining complete ({elapsed:.1f}s).")
    if prof["profiler"] is not None:   # the run ended inside the window
        stop_profile()
    if tb_writer is not None:
        tb_writer.close()
    return trainer


if __name__ == "__main__":
    main()
