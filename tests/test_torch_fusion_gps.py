"""The port's sensor-fusion helpers, ICP, SBP/GPS reader and publisher and
ROS bridge (gs_tpu_torch/io_live/{fusion,pointcloud,gps}.py,
apps/{gps_pub,ros_bridge}.py) against gs_tpu's on the CPU:
tests/test_fusion.py's and tests/test_io_live.py's GPS cases run against
both packages, with their results equal."""
import io
import socket
import struct
import threading
from types import SimpleNamespace

import msgpack
import numpy as np
import pytest

from gs_tpu.apps import gps_pub as jax_gps_pub
from gs_tpu.apps import ros_bridge as jax_ros_bridge
from gs_tpu.io_live import fusion as jfusion
from gs_tpu.io_live import gps as jgps
from gs_tpu.io_live import pointcloud as jpc

from gs_tpu_torch.apps import gps_pub, ros_bridge
from gs_tpu_torch.io_live import fusion, gps
from gs_tpu_torch.io_live import pointcloud as pc
from gs_tpu_torch.io_live.rosbag import RosTime


@pytest.mark.parametrize("mod", [fusion, jfusion], ids=["port", "jax"])
def test_nearest_within(mod):
    stamps = [0.0, 0.1, 0.2, 0.3]
    assert mod.nearest_within(stamps, 0.11, tol=0.05) == 1
    assert mod.nearest_within(stamps, 0.16, tol=0.05) == 2   # 0.04 from 0.2
    assert mod.nearest_within(stamps, 0.4, tol=0.05) is None
    assert mod.nearest_within(stamps, 0.29, tol=0.05) == 3
    assert mod.nearest_within([], 0.1) is None


def test_pair_streams_drops_unmatched():
    cams = [fusion.Stamped(t, f"img{i}") for i, t in enumerate([0.0, 0.1, 0.5])]
    gps_s = [fusion.Stamped(t + 0.01, f"gps{i}")
             for i, t in enumerate([0.0, 0.1])]
    imu = [fusion.Stamped(t - 0.02, f"imu{i}")
           for i, t in enumerate([0.0, 0.1, 0.5])]
    fused = fusion.pair_streams(cams, gps_s, imu, tol=0.05)
    assert fused == [("img0", "gps0", "imu0"), ("img1", "gps1", "imu1")]
    assert fused == jfusion.pair_streams(cams, gps_s, imu, tol=0.05)
    rng = np.random.default_rng(4)
    streams = [[fusion.Stamped(float(t), i) for i, t in
                enumerate(np.sort(rng.uniform(0, 2, 40)))] for _ in range(3)]
    assert (fusion.pair_streams(*streams, tol=0.03)
            == jfusion.pair_streams(*streams, tol=0.03))


def test_yaw_correction_matches_jax():
    ident = np.array([1.0, 0, 0, 0])
    q = fusion.imu_yaw_correction(ident, t=0.0, t0=0.0)
    np.testing.assert_allclose(q, fusion.yaw_quaternion(-np.pi / 2),
                               atol=1e-12)
    q2 = fusion.imu_yaw_correction(ident, t=10.0, t0=0.0, static_offset=0.0,
                                   drift_rate=0.01)
    np.testing.assert_allclose(q2, fusion.yaw_quaternion(0.1), atol=1e-12)
    a, b = fusion.yaw_quaternion(0.3), fusion.yaw_quaternion(0.5)
    np.testing.assert_allclose(fusion.quat_multiply(a, b),
                               fusion.yaw_quaternion(0.8), atol=1e-12)
    rng = np.random.default_rng(5)
    for _ in range(5):
        qa, qb = rng.normal(size=4), rng.normal(size=4)
        np.testing.assert_array_equal(fusion.quat_multiply(qa, qb),
                                      jfusion.quat_multiply(qa, qb))
        np.testing.assert_array_equal(
            fusion.imu_yaw_correction(qa, 3.0, 1.0, drift_rate=0.02),
            jfusion.imu_yaw_correction(qa, 3.0, 1.0, drift_rate=0.02))


def test_icp_recovers_perturbed_pose_as_jax(rng):
    """tests/test_fusion.py::test_icp_recovers_perturbed_pose, and the
    transform, RMSE and inlier count gs_tpu's ICP gives, to 1e-9."""
    g = np.stack(np.meshgrid(np.linspace(0, 2, 12), np.linspace(0, 1, 8),
                             np.linspace(0, 1.5, 10)), -1).reshape(-1, 3)
    target = g + rng.normal(0, 0.002, g.shape)
    ang = 0.04                                  # ~2.3 deg drift
    R = np.array([[np.cos(ang), -np.sin(ang), 0],
                  [np.sin(ang), np.cos(ang), 0], [0, 0, 1.0]])
    t = np.array([0.05, -0.03, 0.02])
    source = target @ R.T + t                   # drifted copy
    T, rmse, n_in = pc.icp_point_to_point(source, target, max_corr_dist=0.25)
    JT, jrmse, jn = jpc.icp_point_to_point(source, target, max_corr_dist=0.25)
    assert n_in > 800 and n_in == jn
    aligned = pc.transform_points(source, T)
    assert np.abs(aligned - target).max() < 0.01
    assert rmse < 0.01
    np.testing.assert_allclose(T, JT, rtol=0, atol=1e-9)
    assert abs(rmse - jrmse) <= 1e-9


# ------------------------------------------------------------------- GPS

def test_sbp_roundtrip_and_resync():
    """tests/test_io_live.py::test_sbp_roundtrip_and_resync: valid frames
    parse exactly, garbage and a corrupted CRC are skipped; the frames and
    messages are gs_tpu's."""
    f1 = gps.encode_baseline_ned(1000, n_mm=1219, e_mm=-9304, d_mm=-483)
    f2 = gps.encode_baseline_ned(1100, n_mm=-3091, e_mm=-11695, d_mm=-434)
    assert f1 == jgps.encode_baseline_ned(1000, n_mm=1219, e_mm=-9304,
                                          d_mm=-483)
    corrupted = bytearray(gps.encode_baseline_ned(1050, 1, 2, 3))
    corrupted[10] ^= 0xFF   # payload bit flip -> CRC mismatch
    blob = b"\x00\x55\x13garbage" + f1 + bytes(corrupted) + b"\x55" + f2
    msgs = list(gps.iter_sbp(io.BytesIO(blob)))
    assert msgs == list(jgps.iter_sbp(io.BytesIO(blob)))
    assert [m[0] for m in msgs] == [gps.SBP_MSG_BASELINE_NED] * 2
    a = gps.parse_baseline_ned(msgs[0][2])
    b = gps.parse_baseline_ned(msgs[1][2])
    assert a.enu_meters() == pytest.approx((-9.304, 1.219, 0.483))
    assert b.enu_meters() == pytest.approx((-11.695, -3.091, 0.434))
    assert gps.crc16_ccitt(blob) == jgps.crc16_ccitt(blob)


def _replay(main, cap, csv_path, n):
    """Run a gps_pub ``main`` on the capture with a TCP receiver; returns
    (its count, the raw messages received)."""
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    got = []

    def receiver():
        conn, _ = srv.accept()
        with conn:
            while len(got) < n:
                size = struct.unpack("<I", conn.recv(4, socket.MSG_WAITALL))[0]
                got.append(conn.recv(size, socket.MSG_WAITALL))

    t = threading.Thread(target=receiver, daemon=True)
    t.start()
    count = main(["-p", str(cap), "--csv", str(csv_path), "--quiet",
                  "--publish", f"127.0.0.1:{srv.getsockname()[1]}"])
    t.join(timeout=10)
    srv.close()
    assert not t.is_alive()
    return count, got


def test_gps_pub_replay_matches_jax(tmp_path, monkeypatch):
    """tests/test_io_live.py::test_gps_pub_cli_replay_and_publish: the CSV
    log in the reference schema and msgpack points on the TCP channel; with
    one clock for both, the port's messages and CSV equal the JAX CLI's
    byte for byte."""
    cap = tmp_path / "capture.sbp"
    cap.write_bytes(b"".join(
        gps.encode_baseline_ned(1000 + 100 * i, n_mm=100 * i, e_mm=-200 * i,
                                d_mm=50 * i) for i in range(5)))
    runs = {}
    for name, main, mod in (("port", gps_pub.main, gps),
                            ("jax", jax_gps_pub.main, jgps)):
        ticks = iter(1.7e9 + 0.25 * k for k in range(100))
        orig = mod.publish_stream

        def publish(stream, on_point, csv_path=None, orig=orig, ticks=ticks):
            return orig(stream, on_point, csv_path=csv_path,
                        clock=lambda: next(ticks))
        monkeypatch.setattr(mod, "publish_stream", publish)
        if name == "port":
            monkeypatch.setattr(gps_pub, "publish_stream", publish)
        csv_path = tmp_path / f"{name}.csv"
        runs[name] = _replay(main, cap, csv_path, 5) + (csv_path.read_text(),)
    n, got, csv_text = runs["port"]
    assert n == 5 and runs["jax"][0] == 5
    assert got == runs["jax"][1]
    assert csv_text == runs["jax"][2]
    lines = csv_text.strip().splitlines()
    assert lines[0] == "TS,X,Y,Z" and len(lines) == 6
    msgs = [msgpack.unpackb(b) for b in got]
    assert msgs[2]["topic"] == "/rtk_gps_pos"
    assert msgs[2]["x"] == pytest.approx(-0.4)   # e=-400mm
    assert msgs[2]["y"] == pytest.approx(0.2)
    assert msgs[2]["z"] == pytest.approx(-0.1)
    assert [m["seq"] for m in msgs] == list(range(5))


# ----------------------------------------------------------- ROS bridge

def _visual_merged(rng, w=6, h=4, n_pts=5):
    """A visual_merged_msg as rospy would hand it over: nested attribute
    objects, with an XYZ cloud."""
    img = rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
    pts = rng.normal(size=(n_pts, 3)).astype("<f4")
    ns = SimpleNamespace
    return img, pts, ns(
        Image=ns(header=ns(stamp=RosTime(12, 500_000_000)), height=h, width=w,
                 encoding="rgb8", step=w * 3, data=img.tobytes()),
        CameraInfo=ns(K=np.array([50.0, 0, w / 2, 0, 50.0, h / 2, 0, 0, 1])),
        CameraPose=ns(transform=ns(
            translation=ns(x=1.0, y=-2.0, z=0.5),
            rotation=ns(x=0.1, y=0.2, z=0.3, w=0.927))),
        Local_Map=ns(width=n_pts, height=1, point_step=12,
                     data=pts.tobytes(),
                     fields=[ns(name=c, offset=4 * k)
                             for k, c in enumerate("xyz")]))


def test_ros_bridge_msg_to_frame_matches_jax(rng):
    img, pts, msg = _visual_merged(rng)
    got = ros_bridge.msg_to_frame(msg)
    want = jax_ros_bridge.msg_to_frame(msg)
    assert got.stamp == want.stamp == pytest.approx(12.5)
    assert got.pose_convention == want.pose_convention == "c2w"
    np.testing.assert_array_equal(got.image, img)
    np.testing.assert_array_equal(got.points, pts)
    for k in ("image", "K", "qvec", "tvec", "points"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k))
    np.testing.assert_array_equal(got.qvec, [0.927, 0.1, 0.2, 0.3])


def test_ros_bridge_main_needs_ros():
    """Without rospy, ``main`` exits with the JAX CLI's pointer to the
    offline converter, and importing the module loaded no rospy."""
    import sys
    with pytest.raises(SystemExit, match="convert_stream"):
        ros_bridge.main(["--port", "1"])
    assert "rospy" not in sys.modules
