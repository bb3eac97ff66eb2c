"""Live SLAM training CLI — port of ``gs_tpu/apps/train_live.py``, the
reference ``train_sdu6.py``.

Usage: ``python -m gs_tpu_torch.apps.train_live -m <model_dir> [--frame_port 6011]``

Mirrors the reference live loop (ref: train_sdu6.py:38-214): block collecting
up to ``--max_frames`` posed frames from the stream (the ROS
``/Visual_Merged`` replacement, ``io_live/stream.py``), bootstrap the scene
from streamed poses and a RAIN-GS random point-cloud init (or the frames'
local maps with ``--use_local_maps``), then run the standard optimizer in
step mode on ``--data_device`` (``cuda`` unless the caller asks for the
CPU) with a stat line every iteration, which reads the loss and the alive
count back from the device each time (``--quiet`` drops it). On CUDA each
iteration replays one captured CUDA graph of the step
(``train/graph.py::ChainStep.step``), as the JAX CLI dispatches its
jitted step; on the CPU the step's body runs eagerly. Pose estimation
itself is external (ORB-SLAM3 / GPS+IMU fusion), exactly as in the
reference.
"""
from __future__ import annotations

import random

from ..config import (ModelConfig, OptimizationConfig, PipelineConfig,
                      RasterConfig, save_config)
from ..data.scene import Scene
from ..io_live.ingest import scene_info_from_frames
from ..io_live.stream import FrameStreamServer
from ..train.loop import Trainer
from .args import extract_dataclass, make_parser, resolve_data_device
from .train import prepare_output_dir


def main(argv=None):
    parser = make_parser("Live training script parameters")
    parser.add_argument("--frame_host", type=str, default="127.0.0.1")
    parser.add_argument("--frame_port", type=int, default=6011)
    parser.add_argument("--max_frames", type=int, default=500)  # ref: train_sdu6.py:56
    parser.add_argument("--collect_timeout", type=float, default=120.0)
    parser.add_argument("--init_points", type=int, default=100)
    parser.add_argument("--use_local_maps", action="store_true")
    parser.add_argument("--test_iterations", nargs="+", type=int,
                        default=[7_000, 30_000])
    parser.add_argument("--save_iterations", nargs="+", type=int,
                        default=[7_000, 30_000])
    parser.add_argument("--quiet", action="store_true")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    model_cfg = extract_dataclass(ModelConfig, args)
    model_cfg.live = True
    model_cfg.data_device = str(resolve_data_device(model_cfg.data_device))
    opt = extract_dataclass(OptimizationConfig, args)
    pipe = extract_dataclass(PipelineConfig, args)
    raster = extract_dataclass(RasterConfig, args)
    model_cfg.model_path = prepare_output_dir(model_cfg)
    save_config(model_cfg.model_path, model_cfg, pipe, opt)

    print(f"Waiting for up to {args.max_frames} frames on "
          f"{args.frame_host}:{args.frame_port} ...")
    server = FrameStreamServer(args.frame_host, args.frame_port)
    try:
        frames = server.wait_for_frames(args.max_frames,
                                        timeout=args.collect_timeout)
    finally:
        server.close()
    print(f"Collected {len(frames)} frames")
    if not frames:
        raise SystemExit("no frames received")

    # the Scene's camera shuffle uses Python's global RNG, as in apps/train.py
    random.seed(args.seed)
    scene_info = scene_info_from_frames(
        frames, model_cfg.model_path, eval_split=model_cfg.eval,
        init_points=args.init_points, use_local_maps=args.use_local_maps,
        seed=args.seed)
    scene = Scene("", model_cfg.model_path, scene_info=scene_info,
                  resolution=model_cfg.resolution,
                  eval_split=model_cfg.eval, device=model_cfg.data_device)

    trainer = Trainer(
        scene.get_train_cameras(), scene.point_cloud,
        spatial_lr_scale=scene.cameras_extent,
        model_cfg=model_cfg, opt=opt, pipe=pipe, raster=raster,
        test_cams=scene.get_test_cameras(), seed=args.seed)

    save_at = set(args.save_iterations + [opt.iterations])

    def on_step(i, metrics, tr):
        if not args.quiet:
            # per-iteration stat print (ref: train_sdu6.py:130)
            print(f"iter {i}: loss={float(metrics.loss):.5f} "
                  f"pts={int(tr.state.num_alive)}", flush=True)
        if i in save_at:
            tr.sync_metrics()   # replay any overflow before saving
            scene.save(i, tr.state.params, tr.state.alive)

    trainer.train(test_iterations=set(args.test_iterations),
                  on_step=on_step, log_every=1)
    print("Live training complete.")
    return trainer


if __name__ == "__main__":
    main()
