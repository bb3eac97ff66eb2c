"""Full-evaluation orchestration — port of ``gs_tpu/apps/full_eval.py``, the
reference ``full_eval.py`` (ref: full_eval.py:15-105).

Usage: ``python -m gs_tpu_torch.apps.full_eval -m360 <dir> -tat <dir> -db <dir> [train flags]``

Trains the 13 standard scenes (9 MipNeRF360 + 2 Tanks&Temples + 2
DeepBlending) with per-dataset image directories, renders iterations 7000
and the last, then runs metrics, calling the port's train, render and
metrics apps in process instead of ``os.system``. Flags it does not know go
to the train CLI. ``--data_device`` (``cuda`` by default) goes to the train
CLI, which stores it in each model's config for the render CLI, and to the
metrics CLI.
"""
from __future__ import annotations

import argparse
import os
import time

# ref: full_eval.py:15-18
MIPNERF360_OUTDOOR = ["bicycle", "flowers", "garden", "stump", "treehill"]
MIPNERF360_INDOOR = ["room", "counter", "kitchen", "bonsai"]
TANKS_AND_TEMPLES = ["truck", "train"]
DEEP_BLENDING = ["drjohnson", "playroom"]


def main(argv=None):
    parser = argparse.ArgumentParser(description="Full evaluation script")
    parser.add_argument("--output_path", default="./eval")
    parser.add_argument("--mipnerf360", "-m360", default="")
    parser.add_argument("--tanksandtemples", "-tat", default="")
    parser.add_argument("--deepblending", "-db", default="")
    parser.add_argument("--skip_training", action="store_true")
    parser.add_argument("--skip_rendering", action="store_true")
    parser.add_argument("--skip_metrics", action="store_true")
    parser.add_argument("--use_depth", action="store_true")
    parser.add_argument("--use_expcomp", action="store_true")
    parser.add_argument("--aa", action="store_true")
    parser.add_argument("--fast", action="store_true")
    parser.add_argument("--iterations", type=int, default=30_000)
    parser.add_argument("--data_device", default="cuda",
                        help="device of all three stages")
    args, extra = parser.parse_known_args(argv)

    scenes = []  # (name, source, images_flag)
    if args.mipnerf360:
        for s in MIPNERF360_OUTDOOR:
            scenes.append((s, os.path.join(args.mipnerf360, s), "images_4"))
        for s in MIPNERF360_INDOOR:
            scenes.append((s, os.path.join(args.mipnerf360, s), "images_2"))
    if args.tanksandtemples:
        for s in TANKS_AND_TEMPLES:
            scenes.append((s, os.path.join(args.tanksandtemples, s), "images"))
    if args.deepblending:
        for s in DEEP_BLENDING:
            scenes.append((s, os.path.join(args.deepblending, s), "images"))
    if not scenes:
        parser.error("no dataset roots given (-m360/-tat/-db)")

    common = list(extra) + ["--data_device", args.data_device]
    if args.use_depth:
        common += ["-d", "depths2"]
    if args.use_expcomp:
        common += ["--train_test_exp"]
    if args.aa:
        common += ["--antialiasing"]
    if args.fast:
        common += ["--optimizer_type", "sparse_adam"]

    if not args.skip_training:
        from . import train as train_app
        t0 = time.time()
        for name, src, images in scenes:
            out = os.path.join(args.output_path, name)
            print(f"=== training {name} ===")
            train_app.main(["-s", src, "-i", images, "-m", out, "--eval",
                            "--quiet", "--iterations", str(args.iterations),
                            "--test_iterations", str(args.iterations),
                            "--save_iterations", "7000",
                            str(args.iterations),
                            "--disable_viewer"] + common)
        print(f"training total: {time.time() - t0:.1f} s")

    if not args.skip_rendering:
        from . import render as render_app
        t0 = time.time()
        for name, src, images in scenes:
            out = os.path.join(args.output_path, name)
            for it in (7000, args.iterations):
                pc = os.path.join(out, "point_cloud", f"iteration_{it}")
                if not os.path.isdir(pc):
                    continue
                render_app.main(["-m", out, "--iteration", str(it),
                                 "--skip_train", "--quiet"])
        print(f"rendering total: {time.time() - t0:.1f} s")

    if not args.skip_metrics:
        from . import metrics as metrics_app
        t0 = time.time()
        model_paths = [os.path.join(args.output_path, name)
                       for name, _, _ in scenes]
        metrics_app.main(["-m"] + model_paths +
                         ["--data_device", args.data_device])
        print(f"metrics total: {time.time() - t0:.1f} s")


if __name__ == "__main__":
    main()
