"""Recorded-stream -> COLMAP-layout converter — port of
``gs_tpu/apps/convert_stream.py``; its outputs are the JAX CLI's, byte for
byte.

The framework's equivalent of the reference's offline bag converters
(ref: convert_orb_topic.py:100-198 — every-Nth-frame subsampling, cameras.txt
from K, points3D.ply from the map cloud; convert_visual_merged_msg.py:505-624
— initial-heading estimation from the position track, trajectory rotation,
c2w -> COLMAP w2c inversion, local-map merging with voxel downsampling). The
input is a stream file recorded with
``gs_tpu_torch.io_live.stream.write_stream_file`` or a ROS ``.bag``.

Usage: ``python -m gs_tpu_torch.apps.convert_stream --input run.gstream --output <dir>``
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from ..data import colmap
from ..data.ply import store_pointcloud
from ..io_live.ingest import qvec2rotmat
from ..io_live.pointcloud import (estimate_heading, rotation_x, rotation_z,
                                  transform_points, voxel_downsample)
from ..io_live.stream import read_stream_file


def load_frames(args) -> list:
    """``.gstream`` recording or a real ROS ``.bag`` -> list[Frame]."""
    if args.input.endswith(".bag") or args.bag_format != "auto":
        from ..io_live import rosbag
        fmt = args.bag_format
        if fmt == "auto":
            topics = {bm.topic for bm in
                      rosbag.read_bag_messages(args.input)}
            fmt = ("visual_merged" if args.merged_topic in topics
                   else "orb_topics")
            print(f"bag topics: {sorted(topics)} -> format {fmt}")
        if fmt == "visual_merged":
            return rosbag.frames_from_visual_merged(
                args.input, topic=args.merged_topic)
        return rosbag.frames_from_bag(
            args.input, image_topic=args.image_topic,
            pose_topic=args.pose_topic, info_topic=args.info_topic,
            points_topic=args.points_topic)
    return read_stream_file(args.input)


def main(argv=None):
    parser = argparse.ArgumentParser(description="Stream -> COLMAP converter")
    parser.add_argument("--input", required=True,
                        help=".gstream recording or a ROS .bag file")
    parser.add_argument("--output", required=True)
    parser.add_argument("--bag_format",
                        choices=["auto", "visual_merged", "orb_topics"],
                        default="auto",
                        help="bag layout: one /Visual_Merged topic "
                             "(ref: convert_visual_merged_msg.py) or "
                             "separate image/pose/cloud topics "
                             "(ref: convert_orb_topic.py)")
    parser.add_argument("--merged_topic", default="/Visual_Merged")
    parser.add_argument("--image_topic", default="/camera/color/image_raw")
    parser.add_argument("--pose_topic", default="/orb_slam3/camera_pose")
    parser.add_argument("--info_topic", default="/camera/color/camera_info")
    parser.add_argument("--points_topic", default="/orb_slam3/all_points")
    parser.add_argument("--every", type=int, default=4,
                        help="keep every Nth frame (ref: convert_orb_topic.py:137)")
    parser.add_argument("--align_heading", action="store_true",
                        help="rotate the trajectory by the initial-track "
                             "heading (GPS rigs; ref: convert_visual_merged_msg.py:540-546)")
    parser.add_argument("--voxel_size", type=float, default=0.05)
    parser.add_argument("--icp", action="store_true",
                        help="ICP-register each local cloud onto the "
                             "accumulated map before merging "
                             "(ref: convert_visual_merged_msg.py:393-432)")
    parser.add_argument("--max_points", type=int, default=2_000_000)
    args = parser.parse_args(argv)

    frames = load_frames(args)
    if not frames:
        raise SystemExit("empty stream file")
    frames = frames[::args.every]
    print(f"{len(frames)} frames after subsampling")

    out = args.output
    images_dir = os.path.join(out, "images")
    sparse_dir = os.path.join(out, "sparse", "0")
    os.makedirs(images_dir, exist_ok=True)
    os.makedirs(sparse_dir, exist_ok=True)

    # world alignment (ref: convert_visual_merged_msg.py:540-546,597-605):
    # z-rotation by the estimated heading, then x-rotation by 90 degrees
    align = np.eye(3)
    if args.align_heading:
        positions = []
        for f in frames:
            if f.pose_convention == "c2w":
                positions.append(np.asarray(f.tvec))
            else:
                R = qvec2rotmat(f.qvec)
                positions.append(-R.T @ np.asarray(f.tvec))
        heading = estimate_heading(np.stack(positions))
        align = rotation_x(np.pi / 2) @ rotation_z(-heading)
        print(f"heading: {np.degrees(heading):.1f} deg")

    intrinsics = {}
    extrinsics = {}
    clouds = []
    from PIL import Image
    for i, f in enumerate(frames):
        h, w = f.image.shape[:2]
        if 1 not in intrinsics:
            fx, fy = f.K[0, 0], f.K[1, 1]
            cx, cy = f.K[0, 2], f.K[1, 2]
            intrinsics[1] = colmap.Intrinsics(
                1, "PINHOLE", w, h, np.array([fx, fy, cx, cy]))
        name = f"frame_{i:05d}.jpg"
        Image.fromarray(f.image).save(os.path.join(images_dir, name),
                                      quality=95)
        # to COLMAP world->cam with alignment applied in world space
        Rp = qvec2rotmat(f.qvec)
        tp = np.asarray(f.tvec, np.float64)
        if f.pose_convention == "c2w":
            Rc2w, c = Rp, tp
        else:
            Rc2w, c = Rp.T, -Rp.T @ tp
        Rc2w = align @ Rc2w
        c = align @ c
        Rwc = Rc2w.T
        tvec = -Rwc @ c
        extrinsics[i + 1] = colmap.Extrinsics(
            i + 1, colmap.rotmat2qvec(Rwc), tvec, 1, name,
            np.zeros((0, 2)), np.zeros((0,), np.int64))
        if f.points is not None:
            clouds.append(transform_points(f.points.astype(np.float64),
                                           np.block([[align, np.zeros((3, 1))],
                                                     [np.zeros((1, 3)), 1.0]])))

    colmap.write_intrinsics_text(intrinsics,
                                 os.path.join(sparse_dir, "cameras.txt"))
    colmap.write_extrinsics_text(extrinsics,
                                 os.path.join(sparse_dir, "images.txt"))

    if clouds:
        if args.icp:
            # register each local cloud onto the accumulated map before
            # merging (ref: convert_visual_merged_msg.py:393-432) — plain
            # pose-transform merging smears the map under GPS/IMU drift
            from ..io_live.pointcloud import icp_point_to_point
            merged = voxel_downsample(clouds[0], args.voxel_size)
            for c in clouds[1:]:
                c = voxel_downsample(c, args.voxel_size)
                T, rmse, n_in = icp_point_to_point(
                    c, merged, max_corr_dist=5.0 * args.voxel_size)
                if n_in >= 20:                 # enough overlap to trust it
                    c = transform_points(c, T)
                merged = voxel_downsample(
                    np.concatenate([merged, c]), args.voxel_size)
            pts = merged
        else:
            pts = np.concatenate(clouds, axis=0)
            pts = voxel_downsample(pts, args.voxel_size)
        if len(pts) > args.max_points:
            sel = np.random.default_rng(0).choice(len(pts), args.max_points,
                                                  replace=False)
            pts = pts[sel]
        rgb = np.full((len(pts), 3), 255, np.uint8)  # white (ref: convert_orb_topic.py:155-198)
        store_pointcloud(os.path.join(sparse_dir, "points3D.ply"), pts, rgb)
        print(f"wrote {len(pts)} map points")
    else:
        print("no local maps in stream; skipping points3D.ply "
              "(training will fall back to random init)")
    print(f"COLMAP layout written to {out}")


if __name__ == "__main__":
    main()
