"""COLMAP ingestion pipeline — port of ``gs_tpu/apps/convert.py``, the
reference ``convert.py`` (ref: convert.py:1-124): feature extraction ->
exhaustive matching -> mapper (BA tolerance 1e-6) -> image undistortion,
reshuffling ``sparse/*`` into ``sparse/0``, plus optional 1/2, 1/4, 1/8
downscales into ``images_{2,4,8}``.

Usage: ``python -m gs_tpu_torch.apps.convert -s <dir> [--resize]``

Requires the ``colmap`` binary on PATH, and uses PIL instead of ImageMagick
for the resizes. It runs no torch.
"""
from __future__ import annotations

import argparse
import os
import shutil
import sys


def run(cmd: str):
    code = os.system(cmd)
    if code != 0:
        print(f"command failed with code {code}: {cmd}")
        sys.exit(code)


def main(argv=None):
    parser = argparse.ArgumentParser(description="COLMAP converter parameters")
    parser.add_argument("--no_gpu", action="store_true")
    parser.add_argument("--skip_matching", action="store_true")
    parser.add_argument("--source_path", "-s", required=True)
    parser.add_argument("--camera", default="OPENCV")
    parser.add_argument("--colmap_executable", default="")
    parser.add_argument("--resize", action="store_true")
    args = parser.parse_args(argv)

    colmap_cmd = (f'"{args.colmap_executable}"'
                  if args.colmap_executable else "colmap")
    if not args.colmap_executable and shutil.which("colmap") is None:
        raise SystemExit("colmap binary not found on PATH; install COLMAP or "
                         "pass --colmap_executable")
    use_gpu = 0 if args.no_gpu else 1
    src = args.source_path

    if not args.skip_matching:
        os.makedirs(os.path.join(src, "distorted", "sparse"), exist_ok=True)
        # ref: convert.py:39-50 (feature extraction)
        run(f"{colmap_cmd} feature_extractor"
            f" --database_path {src}/distorted/database.db"
            f" --image_path {src}/input"
            f" --ImageReader.single_camera 1"
            f" --ImageReader.camera_model {args.camera}"
            f" --SiftExtraction.use_gpu {use_gpu}")
        # ref: convert.py:52-58 (exhaustive matching)
        run(f"{colmap_cmd} exhaustive_matcher"
            f" --database_path {src}/distorted/database.db"
            f" --SiftMatching.use_gpu {use_gpu}")
        # ref: convert.py:60-70 (mapper, ba tolerance 1e-6)
        run(f"{colmap_cmd} mapper"
            f" --database_path {src}/distorted/database.db"
            f" --image_path {src}/input"
            f" --output_path {src}/distorted/sparse"
            f" --Mapper.ba_global_function_tolerance=0.000001")

    # ref: convert.py:72-82 (undistortion into the expected layout)
    run(f"{colmap_cmd} image_undistorter"
        f" --image_path {src}/input"
        f" --input_path {src}/distorted/sparse/0"
        f" --output_path {src}"
        f" --output_type COLMAP")

    # ref: convert.py:84-95 (move sparse/* into sparse/0)
    files = os.listdir(os.path.join(src, "sparse"))
    os.makedirs(os.path.join(src, "sparse", "0"), exist_ok=True)
    for f in files:
        if f == "0":
            continue
        shutil.move(os.path.join(src, "sparse", f),
                    os.path.join(src, "sparse", "0", f))

    if args.resize:
        # ref: convert.py:97-122 (1/2, 1/4, 1/8 copies; PIL instead of magick)
        from PIL import Image
        for scale, sub in ((2, "images_2"), (4, "images_4"), (8, "images_8")):
            os.makedirs(os.path.join(src, sub), exist_ok=True)
            for fname in os.listdir(os.path.join(src, "images")):
                with Image.open(os.path.join(src, "images", fname)) as im:
                    im.resize((im.width // scale, im.height // scale)).save(
                        os.path.join(src, sub, fname))

    print("Done.")


if __name__ == "__main__":
    main()
