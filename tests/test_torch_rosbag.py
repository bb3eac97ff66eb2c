"""The port's rosbag v2.0 reader/writer and message codec
(gs_tpu_torch/io_live/rosbag.py) against gs_tpu's on the CPU:
tests/test_rosbag.py's cases, bags written by either BagWriter equal byte
for byte, the same decoded messages and frames, and the converter's outputs
from a .bag equal to the JAX CLI's."""
import os

import numpy as np
import pytest

from gs_tpu.apps import convert_stream as jax_convert_stream
from gs_tpu.io_live import rosbag as jrb

from gs_tpu_torch.apps import convert_stream
from gs_tpu_torch.data import colmap
from gs_tpu_torch.io_live import rosbag as rb
from gs_tpu_torch.io_live.stream import write_stream_file

from test_torch_live import _tree_bytes, make_frame


def header(i, stamp):
    return {"seq": i, "stamp": rb.RosTime(int(stamp), int((stamp % 1) * 1e9)),
            "frame_id": "cam"}


def image_msg(i, stamp, img):
    h, w = img.shape[:2]
    return {"header": header(i, stamp), "height": h, "width": w,
            "encoding": "rgb8", "is_bigendian": 0, "step": w * 3,
            "data": img.tobytes()}


def camera_info_msg(i, stamp, K, w, h):
    return {"header": header(i, stamp), "height": h, "width": w,
            "distortion_model": "plumb_bob", "D": np.zeros(5),
            "K": np.asarray(K).ravel(), "R": np.eye(3).ravel(),
            "P": np.zeros(12), "binning_x": 0, "binning_y": 0,
            "roi": {"x_offset": 0, "y_offset": 0, "height": 0, "width": 0,
                    "do_rectify": False}}


def pose_msg(i, stamp, qvec, tvec):
    return {"header": header(i, stamp),
            "pose": {"position": dict(zip("xyz", map(float, tvec))),
                     "orientation": {"x": float(qvec[1]), "y": float(qvec[2]),
                                     "z": float(qvec[3]),
                                     "w": float(qvec[0])}}}


def cloud_msg(i, stamp, pts):
    pts = np.asarray(pts, "<f4")
    fields = [{"name": n, "offset": 4 * k, "datatype": 7, "count": 1}
              for k, n in enumerate("xyz")]
    return {"header": header(i, stamp), "height": 1, "width": len(pts),
            "fields": fields, "is_bigendian": False, "point_step": 12,
            "row_step": 12 * len(pts), "data": pts.tobytes(),
            "is_dense": True}


def visual_merged_msg(i, stamp, frame):
    h, w = frame.image.shape[:2]
    return {"Image": image_msg(i, stamp, frame.image),
            "CameraInfo": camera_info_msg(i, stamp, frame.K, w, h),
            "CameraPose": {
                "header": header(i, stamp), "child_frame_id": "cam",
                "transform": {
                    "translation": dict(zip("xyz", map(float, frame.tvec))),
                    "rotation": {"x": float(frame.qvec[1]),
                                 "y": float(frame.qvec[2]),
                                 "z": float(frame.qvec[3]),
                                 "w": float(frame.qvec[0])}}},
            "Local_Map": cloud_msg(i, stamp,
                                   frame.points if frame.points is not None
                                   else np.zeros((0, 3)))}


def write_orb_bag(mod, path, frames):
    """tests/test_rosbag.py::_write_orb_bag through ``mod``'s BagWriter."""
    w = mod.BagWriter(path, compression="bz2")
    K = frames[0].K
    h, wd = frames[0].image.shape[:2]
    w.write("/camera/color/camera_info", "sensor_msgs/CameraInfo",
            mod.CAMERA_INFO_DEF, camera_info_msg(0, frames[0].stamp, K, wd, h),
            t=frames[0].stamp)
    pts = np.concatenate([f.points for f in frames if f.points is not None])
    for i, f in enumerate(frames):
        w.write("/camera/color/image_raw", "sensor_msgs/Image",
                mod.IMAGE_DEF, image_msg(i, f.stamp, f.image), t=f.stamp)
        # pose 5 ms later than the image (inside the 33 ms sync threshold)
        w.write("/orb_slam3/camera_pose", "geometry_msgs/PoseStamped",
                mod.POSE_STAMPED_DEF,
                pose_msg(i, f.stamp + 0.005, f.qvec, f.tvec),
                t=f.stamp + 0.005)
    w.write("/orb_slam3/all_points", "sensor_msgs/PointCloud2",
            mod.POINTCLOUD2_DEF, cloud_msg(0, frames[-1].stamp, pts),
            t=frames[-1].stamp)
    w.close()


def write_visual_merged_bag(mod, path, frames, compression="bz2"):
    w = mod.BagWriter(path, compression=compression)
    for i, f in enumerate(frames):
        w.write("/Visual_Merged", "gs_slam_msgs/visual_merged_msg",
                mod.VISUAL_MERGED_DEF, visual_merged_msg(i, f.stamp, f),
                t=f.stamp)
    w.close()


def read_bytes(path):
    with open(path, "rb") as f:
        return f.read()


def test_definitions_and_md5_match_jax():
    """The published ROS md5 constants (tests/test_rosbag.py), and every
    embedded definition text equal to gs_tpu's."""
    assert (rb.message_md5("std_msgs/Header", rb.HEADER_DEF)
            == "2176decaecbce78abc3b96ef049fabed")
    assert (rb.message_md5("sensor_msgs/Image", rb.IMAGE_DEF)
            == "060021388200f6f0f447d0fcd9c64743")
    assert (rb.message_md5("geometry_msgs/PoseStamped", rb.POSE_STAMPED_DEF)
            == "d3812c3cbc69362b77dc0b19b345f8f5")
    assert (rb.message_md5("sensor_msgs/PointCloud2", rb.POINTCLOUD2_DEF)
            == "1158d486dd51d683ce2f1be655c3c181")
    for name in ("HEADER_DEF", "IMAGE_DEF", "CAMERA_INFO_DEF",
                 "POSE_STAMPED_DEF", "TRANSFORM_STAMPED_DEF",
                 "POINTCLOUD2_DEF", "VISUAL_MERGED_DEF"):
        assert getattr(rb, name) == getattr(jrb, name), name
    assert (rb.message_md5("gs_slam_msgs/visual_merged_msg",
                           rb.VISUAL_MERGED_DEF)
            == jrb.message_md5("gs_slam_msgs/visual_merged_msg",
                               jrb.VISUAL_MERGED_DEF))


@pytest.mark.parametrize("compression", ["none", "bz2"])
def test_bag_roundtrip(tmp_path, rng, compression):
    """tests/test_rosbag.py::test_bag_roundtrip, and the same bag from the
    JAX writer byte for byte."""
    img = rng.integers(0, 255, (8, 6, 3), dtype=np.uint8)
    paths = []
    for mod in (rb, jrb):
        path = str(tmp_path / f"{mod.__name__}_{compression}.bag")
        w = mod.BagWriter(path, compression=compression)
        w.write("/camera/color/image_raw", "sensor_msgs/Image", mod.IMAGE_DEF,
                image_msg(0, 1.5, img), t=1.5)
        w.write("/orb_slam3/camera_pose", "geometry_msgs/PoseStamped",
                mod.POSE_STAMPED_DEF,
                pose_msg(0, 1.5, [1.0, 0, 0, 0], [4, 5, 6]), t=1.5)
        w.flush()       # second chunk
        w.write("/camera/color/image_raw", "sensor_msgs/Image", mod.IMAGE_DEF,
                image_msg(1, 1.6, img), t=1.6)
        w.close()
        paths.append(path)
    assert read_bytes(paths[0]) == read_bytes(paths[1])
    msgs = list(rb.read_bag_messages(paths[1]))
    assert [m.topic for m in msgs] == ["/camera/color/image_raw",
                                       "/orb_slam3/camera_pose",
                                       "/camera/color/image_raw"]
    m0 = rb.decode_message(msgs[0])
    assert (m0.height, m0.width, m0.encoding) == (8, 6, "rgb8")
    assert m0.header.stamp.to_sec() == pytest.approx(1.5)
    np.testing.assert_array_equal(np.asarray(m0.data).reshape(8, 6, 3), img)
    m1 = rb.decode_message(msgs[1])
    assert m1.pose.position.y == 5.0 and m1.pose.orientation.w == 1.0
    j1 = jrb.decode_message(list(jrb.read_bag_messages(paths[0]))[1])
    assert vars(m1.pose.position) == vars(j1.pose.position)
    only = list(rb.read_bag_messages(paths[0],
                                     topics=["/orb_slam3/camera_pose"]))
    assert len(only) == 1


def test_lz4_chunks_raise(tmp_path):
    """A chunk compressed with lz4 raises the JAX reader's clear error."""
    path = str(tmp_path / "lz4.bag")
    with open(path, "wb") as f:
        f.write(rb.MAGIC)
        hdr = rb._encode_header({"op": bytes([rb.OP_CHUNK]),
                                 "compression": b"lz4",
                                 "size": (0).to_bytes(4, "little")})
        f.write(len(hdr).to_bytes(4, "little") + hdr
                + (0).to_bytes(4, "little"))
    with pytest.raises(ValueError, match="unsupported chunk compression"):
        list(rb.read_bag_messages(path))
    with pytest.raises(ValueError, match="not a ROS bag"):
        list(rb.read_bag_messages(__file__))


def test_frames_from_orb_bag_pairing(tmp_path, rng):
    """tests/test_rosbag.py::test_frames_from_orb_bag_pairing, on a bag the
    JAX writer wrote, with the frames gs_tpu's reader gives."""
    frames = [make_frame(rng, i, with_points=(i == 0)) for i in range(6)]
    path = str(tmp_path / "orb.bag")
    write_orb_bag(jrb, path, frames)
    ours = str(tmp_path / "orb_port.bag")
    write_orb_bag(rb, ours, frames)
    assert read_bytes(path) == read_bytes(ours)
    got, want = rb.frames_from_bag(path), jrb.frames_from_bag(path)
    assert len(got) == len(want) == 6
    for f, g, w in zip(frames, got, want):
        np.testing.assert_array_equal(g.image, f.image)
        np.testing.assert_allclose(g.qvec, f.qvec, atol=1e-12)
        np.testing.assert_allclose(g.tvec, f.tvec, atol=1e-12)
        np.testing.assert_allclose(g.K, f.K)
        for k in ("image", "K", "qvec", "tvec"):
            np.testing.assert_array_equal(getattr(g, k), getattr(w, k))
    assert got[0].points is not None and got[1].points is None
    np.testing.assert_array_equal(got[0].points, want[0].points)


def test_visual_merged_bag(tmp_path, rng):
    """tests/test_rosbag.py::test_visual_merged_bag, bytes equal to the JAX
    writer's, and the converter's outputs equal to the JAX CLI's."""
    frames = [make_frame(rng, i, with_points=True) for i in range(4)]
    path = str(tmp_path / "vm.bag")
    write_visual_merged_bag(rb, path, frames)
    jpath = str(tmp_path / "vm_jax.bag")
    write_visual_merged_bag(jrb, jpath, frames)
    assert read_bytes(path) == read_bytes(jpath)
    got = rb.frames_from_visual_merged(path, points_every=2)
    assert len(got) == 4
    np.testing.assert_array_equal(got[2].image, frames[2].image)
    np.testing.assert_allclose(got[1].qvec, frames[1].qvec, atol=1e-12)
    np.testing.assert_allclose(got[3].tvec, frames[3].tvec, atol=1e-12)
    assert got[0].points is not None and got[1].points is None
    np.testing.assert_allclose(got[0].points, frames[0].points, atol=1e-6)

    out, ref = str(tmp_path / "p"), str(tmp_path / "j")
    flags = ["--every", "1", "--voxel_size", "0.25"]
    convert_stream.main(["--input", path, "--output", out] + flags)
    jax_convert_stream.main(["--input", path, "--output", ref] + flags)
    assert _tree_bytes(out) == _tree_bytes(ref)
    extr = colmap.read_extrinsics_text(os.path.join(out,
                                                    "sparse/0/images.txt"))
    assert len(extr) == 4


def test_convert_stream_bag_equals_gstream(tmp_path, rng):
    """tests/test_rosbag.py::test_convert_stream_bag_equals_gstream: a .bag
    converts to the same COLMAP layout as the equivalent .gstream, and both
    outputs equal the JAX CLI's byte for byte."""
    frames = [make_frame(rng, i, with_points=(i == 0)) for i in range(6)]
    gst = str(tmp_path / "run.gstream")
    write_stream_file(gst, frames, encoding="png")
    bag = str(tmp_path / "run.bag")
    write_orb_bag(rb, bag, frames)
    flags = ["--every", "2", "--voxel_size", "0.25"]
    outs = {}
    for name, src in (("gstream", gst), ("bag", bag)):
        outs[name] = str(tmp_path / f"from_{name}")
        convert_stream.main(["--input", src, "--output", outs[name]] + flags)
        ref = str(tmp_path / f"jax_from_{name}")
        jax_convert_stream.main(["--input", src, "--output", ref] + flags)
        assert _tree_bytes(outs[name]) == _tree_bytes(ref), name
    eg = colmap.read_extrinsics_text(os.path.join(outs["gstream"],
                                                  "sparse/0/images.txt"))
    eb = colmap.read_extrinsics_text(os.path.join(outs["bag"],
                                                  "sparse/0/images.txt"))
    assert len(eb) == len(eg) == 3
    for k in eg:
        np.testing.assert_allclose(eb[k].qvec, eg[k].qvec, atol=1e-9)
        np.testing.assert_allclose(eb[k].tvec, eg[k].tvec, atol=1e-9)
    ig = colmap.read_intrinsics_text(os.path.join(outs["gstream"],
                                                  "sparse/0/cameras.txt"))
    ib = colmap.read_intrinsics_text(os.path.join(outs["bag"],
                                                  "sparse/0/cameras.txt"))
    np.testing.assert_allclose(ib[1].params, ig[1].params)
    assert os.path.exists(os.path.join(outs["bag"], "sparse/0/points3D.ply"))


def test_cloud_field_offsets(rng):
    """tests/test_rosbag.py::test_cloud_field_offsets, the encoded bytes
    equal to gs_tpu's encode_message."""
    pts = rng.normal(size=(10, 3)).astype("<f4")
    raw = np.zeros((10, 8), "<f4")
    raw[:, 2:5] = pts      # x/y/z at byte offsets 8, 12, 16
    fields = [{"name": n, "offset": 8 + 4 * k, "datatype": 7, "count": 1}
              for k, n in enumerate("xyz")]
    msg = {"header": header(0, 0.0), "height": 1, "width": 10,
           "fields": fields, "is_bigendian": False, "point_step": 32,
           "row_step": 320, "data": raw.tobytes(), "is_dense": True}
    raw_bytes = rb.encode_message("sensor_msgs/PointCloud2",
                                  rb.POINTCLOUD2_DEF, msg)
    assert raw_bytes == jrb.encode_message("sensor_msgs/PointCloud2",
                                           jrb.POINTCLOUD2_DEF, msg)
    dec, off = rb._decode_struct(
        rb.MessageSchema("sensor_msgs/PointCloud2", rb.POINTCLOUD2_DEF),
        "sensor_msgs/PointCloud2", raw_bytes, 0)
    assert off == len(raw_bytes)
    np.testing.assert_allclose(rb._cloud_to_xyz(dec), pts, atol=1e-7)
