"""The port's live-capture stack (gs_tpu_torch/io_live, apps/train_live,
apps/convert_stream, utils/msgpack_codec) against gs_tpu's on the CPU: the
MessagePack writer against ``msgpack`` byte for byte, the frame wire format
and ``.gstream`` files byte for byte in both directions, a JAX client
feeding the port's server and the reverse, the scene bootstrap, the
converter's outputs, the point-cloud tools, and a live training run fed by a
publisher thread (tests/test_io_live.py's cases, run against both)."""
import os
import socket
import threading

import msgpack
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from gs_tpu.apps import convert_stream as jax_convert_stream
from gs_tpu.io_live import pointcloud as jpc
from gs_tpu.io_live import stream as jstream
from gs_tpu.io_live.ingest import scene_info_from_frames as jax_scene_info

from gs_tpu_torch.apps import convert_stream
from gs_tpu_torch.io_live import pointcloud as pc
from gs_tpu_torch.io_live.ingest import qvec2rotmat, scene_info_from_frames
from gs_tpu_torch.io_live.stream import (Frame, FrameStreamClient,
                                         FrameStreamServer, decode_frame,
                                         encode_frame, read_stream_file,
                                         write_stream_file)
from gs_tpu_torch.utils.msgpack_codec import packb
from gs_tpu_torch.utils.msgpack_reader import unpackb


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Socket tests beside other test processes: one torch thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_frame(rng, i, with_points=False, w=64, h=48):
    """tests/test_io_live.py::make_frame."""
    img = rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
    K = np.array([[50.0, 0, w / 2], [0, 50.0, h / 2], [0, 0, 1]])
    q = rng.normal(size=4)
    q[0] += 3
    q /= np.linalg.norm(q)
    t = rng.normal(size=3)
    pts = rng.normal(size=(20, 3)).astype(np.float32) if with_points else None
    return Frame(stamp=float(i) / 30, image=img, K=K, qvec=q, tvec=t,
                 pose_convention="c2w", points=pts)


@pytest.fixture
def frames(rng):
    return [make_frame(rng, i, with_points=(i % 2 == 0)) for i in range(10)]


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# ----------------------------------------------------------- the codec

INT_EDGES = [0, 1, 0x7f, 0x80, 0xff, 0x100, 0xffff, 0x10000, 0xffffffff,
             0x100000000, (1 << 64) - 1, -1, -0x20, -0x21, -0x80, -0x81,
             -0x8000, -0x8001, -(1 << 31), -(1 << 31) - 1, -(1 << 63)]


@pytest.mark.parametrize("v", INT_EDGES)
def test_packb_ints_take_msgpacks_encoding(v):
    assert packb(v) == msgpack.packb(v, use_bin_type=True)
    assert unpackb(packb(v)) == v


def test_packb_lengths_and_float_runs():
    """Every length header at its edges, str kept apart from bin, and a
    long float list (a frame's local map) or a float64 ndarray through the
    structured-array path, byte for byte msgpack's list of floats."""
    for n in (0, 15, 16, 31, 32, 255, 256, 65535, 65536):
        for v in ("a" * n, b"b" * n, [1] * n, {str(k): k for k in range(n)}
                  if n < 300 else {}):
            assert packb(v) == msgpack.packb(v, use_bin_type=True), n
    rng = np.random.default_rng(3)
    vals = rng.normal(size=62_500)
    want = msgpack.packb(vals.tolist(), use_bin_type=True)
    assert packb(vals.tolist()) == want
    assert packb(vals) == want
    assert packb(vals.astype(np.float32).astype(np.float64)) == msgpack.packb(
        [float(x) for x in vals.astype(np.float32)], use_bin_type=True)
    # a float list with an int inside is not a float run
    mixed = [0.5] * 20 + [1]
    assert packb(mixed) == msgpack.packb(mixed, use_bin_type=True)
    got = unpackb(want)
    assert isinstance(got, list) and got == vals.tolist()
    assert unpackb(packb(mixed)) == mixed
    with pytest.raises(TypeError):
        packb(np.float32(1.0))


_leaf = (st.none() | st.booleans()
         | st.integers(min_value=-(1 << 63), max_value=(1 << 64) - 1)
         | st.floats(allow_nan=False) | st.text(max_size=40)
         | st.binary(max_size=300))
_values = st.recursive(
    _leaf, lambda kids: st.lists(kids, max_size=20)
    | st.dictionaries(st.text(max_size=8), kids, max_size=20), max_leaves=60)


@settings(max_examples=150, deadline=None)
@given(_values)
def test_packb_matches_msgpack(v):
    """Nested values of the frame message's kinds: packb is msgpack.packb
    with use_bin_type=True, byte for byte, and the reader inverts it."""
    blob = packb(v)
    assert blob == msgpack.packb(v, use_bin_type=True)
    back = unpackb(blob)
    want = msgpack.unpackb(blob, raw=False, strict_map_key=False)
    assert _plain(back) == want


def _plain(v):
    """The reader's bin values are memoryviews: compare them as bytes."""
    if isinstance(v, memoryview):
        return bytes(v)
    if isinstance(v, list):
        return [_plain(x) for x in v]
    if isinstance(v, dict):
        return {k: _plain(x) for k, x in v.items()}
    return v


# ---------------------------------------------------- frames on the wire

@pytest.mark.parametrize("encoding", ["rgb8", "png", "jpeg"])
def test_encode_frame_matches_jax(frames, encoding):
    for f in frames[:2]:
        blob = encode_frame(f, encoding)
        assert blob == jstream.encode_frame(f, encoding)
        got = decode_frame(blob[4:])
        want = jstream.decode_frame(blob[4:])
        for k in Frame._fields:
            a, b = getattr(got, k), getattr(want, k)
            if isinstance(b, np.ndarray):
                assert a.dtype == b.dtype and np.array_equal(a, b), k
            else:
                assert a == b, k


def test_frame_codec(frames):
    """tests/test_io_live.py::test_frame_codec."""
    for enc in ("rgb8", "png"):
        blob = encode_frame(frames[0], enc)
        n = int.from_bytes(blob[:4], "little")
        f2 = decode_frame(blob[4:4 + n])
        np.testing.assert_array_equal(f2.image, frames[0].image)
        np.testing.assert_allclose(f2.K, frames[0].K)
        np.testing.assert_allclose(f2.qvec, frames[0].qvec)
        np.testing.assert_allclose(f2.tvec, frames[0].tvec)
    f3 = decode_frame(encode_frame(frames[0], "jpeg")[4:])
    assert f3.image.shape == frames[0].image.shape
    np.testing.assert_allclose(f3.points, frames[0].points)


@pytest.mark.parametrize("direction", ["jax client -> port server",
                                       "port client -> jax server"])
def test_stream_tcp_across_packages(frames, direction):
    """A JAX publisher feeds the port's server, and the port's publisher the
    JAX server: the frames arrive in order, equal to what was sent."""
    port_server = direction.startswith("jax")
    server = (FrameStreamServer if port_server else jstream.FrameStreamServer)(
        "127.0.0.1", 0)
    client_cls = jstream.FrameStreamClient if port_server else FrameStreamClient
    try:
        def publish():
            client = client_cls("127.0.0.1", server.port)
            for f in frames:
                client.send(f, encoding="png")
            client.close()

        t = threading.Thread(target=publish, daemon=True)
        t.start()
        got = server.wait_for_frames(len(frames), timeout=20, poll=0.02)
        t.join(timeout=10)
        assert not t.is_alive()
    finally:
        server.close()
    assert len(got) == len(frames)
    for f, g in zip(frames, got):
        assert g.stamp == f.stamp
        np.testing.assert_array_equal(g.image, f.image)
        np.testing.assert_array_equal(g.qvec, f.qvec)
        if f.points is None:
            assert g.points is None
        else:
            np.testing.assert_array_equal(g.points, f.points)


def test_stream_file_matches_jax(frames, tmp_path):
    """A .gstream written by either package is the other's byte for byte,
    and each reads the other's."""
    ours, theirs = str(tmp_path / "p.gstream"), str(tmp_path / "j.gstream")
    write_stream_file(ours, frames, encoding="jpeg")
    jstream.write_stream_file(theirs, frames, encoding="jpeg")
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    got, want = read_stream_file(theirs), jstream.read_stream_file(ours)
    assert len(got) == len(want) == len(frames)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.image, w.image)
        np.testing.assert_array_equal(g.K, w.K)


# ------------------------------------------------------------ bootstrap

@pytest.mark.parametrize("local_maps", [False, True])
def test_scene_info_matches_jax(frames, tmp_path, local_maps):
    """Cameras, init points (same seed), normalization and the saved images
    and PLY equal gs_tpu's."""
    kw = dict(eval_split=True, llffhold=5, init_points=50,
              use_local_maps=local_maps, seed=3)
    got = scene_info_from_frames(frames, str(tmp_path / "p"), **kw)
    want = jax_scene_info(frames, str(tmp_path / "j"), **kw)
    assert len(got.test_cameras) == 2 and len(got.train_cameras) == 8
    for a, b in zip(got.train_cameras + got.test_cameras,
                    want.train_cameras + want.test_cameras):
        assert (a.uid, a.image_name, a.width, a.height, a.is_test) == \
            (b.uid, b.image_name, b.width, b.height, b.is_test)
        np.testing.assert_array_equal(a.R, b.R)
        np.testing.assert_array_equal(a.T, b.T)
        assert (a.fovx, a.fovy) == (b.fovx, b.fovy)
        with open(a.image_path, "rb") as fa, open(b.image_path, "rb") as fb:
            assert fa.read() == fb.read()
    for x, y in zip(got.point_cloud, want.point_cloud):
        np.testing.assert_array_equal(x, y)
    assert got.point_cloud[0].shape == ((5 * 20, 3) if local_maps else (50, 3))
    np.testing.assert_array_equal(got.nerf_normalization["translate"],
                                  want.nerf_normalization["translate"])
    assert got.nerf_normalization["radius"] == want.nerf_normalization["radius"]
    with open(got.ply_path, "rb") as fa, open(want.ply_path, "rb") as fb:
        assert fa.read() == fb.read()
    # pose roundtrip: CameraInfo.R/T invert back to the c2w input
    ci = sorted(got.train_cameras + got.test_cameras,
                key=lambda c: c.image_name)[0]
    Rc2w = qvec2rotmat(frames[0].qvec)
    np.testing.assert_allclose(ci.R, Rc2w, atol=1e-9)
    np.testing.assert_allclose(ci.T, -Rc2w.T @ frames[0].tvec, atol=1e-9)


# ------------------------------------------------------------- converter

def _tree_bytes(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            p = os.path.join(d, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, root)] = f.read()
    return out


@pytest.mark.parametrize("flags", [
    ["--every", "2", "--voxel_size", "0.5"],
    ["--every", "1", "--voxel_size", "0.25", "--align_heading", "--icp"]])
def test_convert_stream_gstream_matches_jax(frames, tmp_path, flags):
    """tests/test_io_live.py::test_convert_stream, and every file the two
    CLIs write is the same, byte for byte."""
    path = str(tmp_path / "run.gstream")
    write_stream_file(path, frames, encoding="png")
    out, ref = str(tmp_path / "p"), str(tmp_path / "j")
    convert_stream.main(["--input", path, "--output", out] + flags)
    jax_convert_stream.main(["--input", path, "--output", ref] + flags)
    got, want = _tree_bytes(out), _tree_bytes(ref)
    assert set(got) == set(want) and got == want
    n = 10 // int(flags[1])
    assert len(os.listdir(os.path.join(out, "images"))) == n
    assert "sparse/0/points3D.ply" in got


# ------------------------------------------------------- point clouds

def test_pointcloud_tools_match_jax(rng):
    """tests/test_io_live.py::test_pointcloud_utils against gs_tpu's
    functions to 1e-9."""
    pts = rng.normal(size=(1000, 3))
    cols = rng.uniform(size=(1000, 3))
    down = pc.voxel_downsample(pts, 0.5)
    assert len(down) < len(pts)
    np.testing.assert_allclose(down, jpc.voxel_downsample(pts, 0.5),
                               rtol=0, atol=1e-9)
    for a, b in zip(pc.voxel_downsample(pts, 0.5, cols),
                    jpc.voxel_downsample(pts, 0.5, cols)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-9)
    pts2 = np.concatenate([pts, np.array([[100.0, 100, 100]])])
    kept, mask = pc.remove_statistical_outliers(pts2, nb_neighbors=10)
    jkept, jmask = jpc.remove_statistical_outliers(pts2, nb_neighbors=10)
    assert not mask[-1]
    np.testing.assert_array_equal(mask, jmask)
    np.testing.assert_allclose(kept, jkept, rtol=0, atol=1e-9)
    M = np.eye(4)
    M[:3, :3] = pc.rotation_x(0.2) @ pc.rotation_z(0.3)
    M[:3, 3] = [1, 2, 3]
    np.testing.assert_allclose(pc.transform_points(pts, M),
                               jpc.transform_points(pts, M), rtol=0, atol=1e-9)
    np.testing.assert_allclose(
        pc.transform_points(pc.transform_points(pts, M), np.linalg.inv(M)),
        pts, atol=1e-9)
    np.testing.assert_allclose(pc.rotation_z(0.3), jpc.rotation_z(0.3),
                               rtol=0, atol=1e-9)
    np.testing.assert_allclose(pc.rotation_x(0.3), jpc.rotation_x(0.3),
                               rtol=0, atol=1e-9)
    track = np.stack([np.linspace(0, 10, 50), np.linspace(0, 10, 50),
                      np.zeros(50)], 1)
    assert pc.estimate_heading(track) == pytest.approx(np.pi / 4)
    assert pc.estimate_heading(track) == jpc.estimate_heading(track)


# ---------------------------------------------------------- live training

def test_train_live_end_to_end(rng, tmp_path):
    """A publisher thread streams 6 frames of 64x48 to the live CLI, which
    bootstraps the scene and trains 3 iterations on the CPU: every frame
    arrives in order, each Scene camera is the one its frame's pose gives,
    the loss is finite, and the PLY is written."""
    from gs_tpu_torch.apps import train_live
    from gs_tpu_torch.core.camera import make_camera
    frames = [make_frame(rng, i) for i in range(6)]
    port = free_port()
    sent = []

    def publish():
        for _ in range(400):
            try:
                client = FrameStreamClient("127.0.0.1", port)
                break
            except OSError:
                threading.Event().wait(0.05)
        for f in frames:
            client.send(f, encoding="png")
            sent.append(f.stamp)
        client.close()

    t = threading.Thread(target=publish, daemon=True)
    t.start()
    model = str(tmp_path / "live_model")
    trainer = train_live.main([
        "-m", model, "--frame_port", str(port), "--max_frames", "6",
        "--collect_timeout", "30", "--iterations", "3", "--test_iterations",
        "3", "--save_iterations", "3", "--dup_capacity", "4096",
        "--max_per_tile", "128", "--chunk", "32", "--init_points", "50",
        "--eval", "--data_device", "cpu"])
    t.join(timeout=10)
    assert not t.is_alive() and len(sent) == 6
    assert trainer.iteration == 3 and np.isfinite(trainer.ema_loss)
    assert trainer.device == torch.device("cpu")
    assert os.path.exists(os.path.join(
        model, "point_cloud", "iteration_3", "point_cloud.ply"))
    cams = trainer.train_cams + trainer.test_cams
    assert sorted(c.info.image_name for c in cams) == [
        f"frame_{i:05d}" for i in range(6)]
    for c in cams:
        f = frames[int(c.info.image_name.split("_")[1])]
        R = qvec2rotmat(f.qvec)         # c2w rotation
        want = make_camera(R, -R.T @ f.tvec, c.info.fovx, c.info.fovy, 64,
                           48, device="cpu")
        np.testing.assert_allclose(c.camera.world_view.numpy(),
                                   want.world_view.numpy(), rtol=0,
                                   atol=1e-6)
