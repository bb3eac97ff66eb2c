"""The port's viewer (gs_tpu_torch/viewer) against gs_tpu's on the CPU: the
camera decode, the wire bytes of tests/test_apps.py's two viewer tests (a
protocol client and a stock SIBR client's raw bytes), the pause of a client
that sends ``train: false``, a server attached to a Trainer, and the
Trainer's block cap against the JAX Trainer's loop."""
import socket
import threading

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from gs_tpu.config import OptimizationConfig as JOptimizationConfig
from gs_tpu.data.scene import Scene as JScene
from gs_tpu.models.gaussian_model import create_from_pcd as jax_create_from_pcd
from gs_tpu.render import render as jax_render
from gs_tpu.train.loop import Trainer as JTrainer
from gs_tpu.viewer.server import ViewerServer as JViewerServer
from gs_tpu.viewer.server import decode_camera as jax_decode_camera

from gs_tpu_torch.config import (ModelConfig, OptimizationConfig,
                                 PipelineConfig, RasterConfig)
from gs_tpu_torch.data.scene import Scene
from gs_tpu_torch.models.gaussian_model import create_from_pcd
from gs_tpu_torch.render import render
from gs_tpu_torch.train.loop import Trainer
from gs_tpu_torch.viewer.client import ViewerClient, encode_request
from gs_tpu_torch.viewer.server import ViewerServer, decode_camera, frame_bytes

from test_data import make_colmap_dataset


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Socket tests beside other test processes: one torch thread, so a
    parallel region never waits on threads that are not running."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny_scene(tmp_path_factory):
    rng = np.random.default_rng(3)
    root = str(tmp_path_factory.mktemp("dataset"))
    make_colmap_dataset(root, rng, n_images=8, width=64, height=48)
    return root


@pytest.fixture(scope="module")
def port_scene(tiny_scene):
    scene = Scene(tiny_scene, "", shuffle=False, device="cpu")
    pts, cols, _ = scene.point_cloud
    params, alive = create_from_pcd(pts, cols, sh_degree=1, capacity=64,
                                    device="cpu")

    def render_fn(camera, scaling_modifier):
        return render(camera, params, torch.zeros(3), active_sh_degree=0,
                      scaling_modifier=scaling_modifier, alive=alive,
                      dup_capacity=4096, max_per_tile=64, chunk=32).image

    return scene, render_fn


def _serve(server, requests, in_training=True, polls=2000):
    """Run ``requests(port)`` in a client thread while polling."""
    done = threading.Event()
    out = {}

    def client():
        try:
            out.update(requests(server.port))
        finally:
            done.set()

    t = threading.Thread(target=client, daemon=True)
    t.start()
    for _ in range(polls):
        server.poll(in_training=in_training)
        if done.wait(0.01):
            break
    t.join(timeout=30)
    server.close()
    assert done.is_set(), "client never completed"
    return out


def _sibr_message(cam, W, H, train=False, keep_alive=False):
    """What the stock C++ client puts on the wire (tests/test_apps.py::
    test_viewer_stock_sibr_bytes): glm-transposed matrices, with the
    columns the server flips back."""
    wv = np.asarray(cam.world_view).T.copy()
    wv[:, 1] = -wv[:, 1]
    wv[:, 2] = -wv[:, 2]
    fp = np.asarray(cam.full_proj).T.copy()
    fp[:, 1] = -fp[:, 1]
    return {
        "resolution_x": W, "resolution_y": H, "train": train,
        "fov_y": 2.0 * float(np.arctan(cam.tan_fovy)),
        "fov_x": 2.0 * float(np.arctan(cam.tan_fovx)),
        "z_near": 0.01, "z_far": 100.0,
        "shs_python": False, "rot_scale_python": False,
        "keep_alive": keep_alive, "scaling_modifier": 1.0,
        "view_matrix": [float(v) for v in wv.reshape(-1)],
        "view_projection_matrix": [float(v) for v in fp.reshape(-1)],
    }


def test_decode_camera_matches_jax(tiny_scene):
    cam = JScene(tiny_scene, "", shuffle=False).get_train_cameras()[2].camera
    msg = _sibr_message(cam, 64, 48)
    ref = jax_decode_camera(msg)
    got = decode_camera(msg, "cpu")
    assert (got.width, got.height) == (ref.width, ref.height) == (64, 48)
    for f in ("world_view", "full_proj", "camera_center", "tan_fovx",
              "tan_fovy"):
        g = getattr(got, f)
        assert g.dtype == torch.float32 and g.device == torch.device("cpu")
        np.testing.assert_allclose(g.numpy(), np.asarray(getattr(ref, f)),
                                   rtol=0, atol=1e-6, err_msg=f)
    assert decode_camera(dict(msg, resolution_x=0), "cpu") is None


def test_viewer_roundtrip(tiny_scene, port_scene):
    """tests/test_apps.py::test_viewer_roundtrip: frames for a protocol
    client equal a direct render, bitwise."""
    scene, render_fn = port_scene
    cam = scene.get_train_cameras()[0].camera
    server = ViewerServer("127.0.0.1", 0, render_fn=render_fn,
                          source_path=tiny_scene, device="cpu")

    def requests(port):
        c = ViewerClient("127.0.0.1", port)
        img, src = c.request_frame(cam)
        img2, _ = c.request_frame(None)   # resolution 0 -> no image
        c.close()
        return {"img": img, "src": src, "img2": img2}

    out = _serve(server, requests)
    assert out["src"] == tiny_scene
    assert out["img"].shape == (cam.height, cam.width, 3)
    assert out["img2"] is None
    direct = np.clip(render_fn(cam, 1.0).numpy(), 0, 1)
    direct8 = (direct * 255).astype(np.uint8).transpose(1, 2, 0)
    np.testing.assert_array_equal(out["img"], direct8)
    assert out["img"].tobytes() == frame_bytes(render_fn(cam, 1.0))


def _raw_exchange(port, wire, H, W):
    s = socket.create_connection(("127.0.0.1", port), timeout=30)
    s.sendall(wire)
    buf = b""
    want = H * W * 3 + 4
    while len(buf) < want:
        chunk = s.recv(65536)
        if not chunk:
            break
        buf += chunk
    n = int.from_bytes(buf[H * W * 3:want], "little")
    while len(buf) < want + n:
        buf += s.recv(65536)
    s.close()
    return {"rgb": buf[:H * W * 3], "path": buf[want:want + n].decode("ascii")}


def test_viewer_stock_sibr_bytes(tiny_scene, port_scene):
    """tests/test_apps.py::test_viewer_stock_sibr_bytes: the raw bytes of a
    stock SIBR client get H*W*3 RGB bytes, then a 4-byte LE length and the
    ASCII source path; the port's frame is within one level per byte of
    the JAX server's frame of the same scene and message."""
    import json
    _, render_fn = port_scene
    jscene = JScene(tiny_scene, "", shuffle=False)
    pts, cols, _ = jscene.point_cloud
    jparams, jalive = jax_create_from_pcd(pts, cols, sh_degree=1, capacity=64)
    cam = jscene.get_train_cameras()[0].camera
    W, H = 64, 48
    payload = json.dumps(_sibr_message(cam, W, H)).encode("utf-8")
    wire = len(payload).to_bytes(4, "little") + payload

    def jax_render_fn(camera, scaling_modifier):
        return jax_render(camera, jparams, jnp.zeros(3), active_sh_degree=0,
                          scaling_modifier=scaling_modifier, alive=jalive,
                          backend="binned", dup_capacity=4096,
                          max_per_tile=64, chunk=32).image

    replies = []
    for server in (ViewerServer("127.0.0.1", 0, render_fn=render_fn,
                                source_path="/data/truck", device="cpu"),
                   JViewerServer("127.0.0.1", 0, render_fn=jax_render_fn,
                                 source_path="/data/truck")):
        if not hasattr(server, "port"):
            server.port = server.listener.getsockname()[1]
        replies.append(_serve(
            server, lambda port: _raw_exchange(port, wire, H, W),
            in_training=False))
    got, ref = replies
    assert got["path"] == ref["path"] == "/data/truck"
    img = np.frombuffer(got["rgb"], np.uint8).reshape(H, W, 3)
    want = np.frombuffer(ref["rgb"], np.uint8).reshape(H, W, 3)
    assert img.max() > 0
    assert np.abs(img.astype(int) - want.astype(int)).max() <= 1
    # and the port's frame is its own direct render, bitwise
    assert got["rgb"] == frame_bytes(render_fn(decode_camera(
        _sibr_message(cam, W, H), "cpu"), 1.0))


@pytest.mark.parametrize("train", [False, True])
def test_viewer_pause(port_scene, train):
    """Two requests sent together: with ``train: false`` (a paused client)
    one poll serves both before training resumes; with ``train: true`` the
    poll returns after the first, so training runs between frames."""
    scene, render_fn = port_scene
    cam = scene.get_train_cameras()[1].camera
    server = ViewerServer("127.0.0.1", 0, render_fn=render_fn,
                          source_path="p", device="cpu")
    served = []   # the poll that served each frame
    n_polls = 0

    def counting(camera, sm):
        served.append(n_polls)
        return render_fn(camera, sm)

    server.render_fn = counting
    sent = threading.Event()
    out = {}

    def client():
        c = ViewerClient("127.0.0.1", server.port)
        wire = b"".join(encode_request(cam, train=train, keep_alive=True)[0]
                        for _ in range(2))
        c.sock.sendall(wire)
        sent.set()
        out["frames"] = [c.read_reply(cam.width, cam.height)[0]
                         for _ in range(2)]
        c.close()

    t = threading.Thread(target=client, daemon=True)
    t.start()
    while server.conn is None:
        server.try_connect()
    assert sent.wait(30)
    while len(served) < 2 and n_polls < 50:
        n_polls += 1
        server.poll()
    t.join(timeout=30)
    server.close()
    assert [f.shape for f in out["frames"]] == [(cam.height, cam.width, 3)] * 2
    assert served == ([1, 1] if not train else [1, 2])


def _tiny_trainer(tiny_scene, iters=20):
    scene = Scene(tiny_scene, "", shuffle=False, device="cpu")
    opt = OptimizationConfig(iterations=iters, position_lr_max_steps=iters,
                             densify_from_iter=5, densification_interval=10,
                             densify_until_iter=15,
                             opacity_reset_interval=1000)
    return Trainer(scene.get_train_cameras(), scene.point_cloud,
                   spatial_lr_scale=scene.cameras_extent,
                   model_cfg=ModelConfig(sh_degree=1, data_device="cpu"),
                   opt=opt, pipe=PipelineConfig(),
                   raster=RasterConfig(dup_capacity=4096, max_per_tile=64,
                                       chunk=32), seed=1)


def test_server_attached_to_a_trainer(tiny_scene):
    """A server given the Trainer renders through ``Trainer.render_view``:
    the wire frame is its bytes, bitwise, at a scaling modifier too."""
    tr = _tiny_trainer(tiny_scene)
    tr.train(iterations=3)
    cam = tr.train_cams[0].camera
    server = ViewerServer("127.0.0.1", 0, trainer=tr, source_path="s")
    assert server.device == torch.device("cpu")

    def requests(port):
        c = ViewerClient("127.0.0.1", port)
        a, _ = c.request_frame(cam)
        b, _ = c.request_frame(cam, scaling_modifier=0.5)
        c.close()
        return {"a": a, "b": b}

    out = _serve(server, requests)
    assert out["a"].tobytes() == frame_bytes(tr.render_view(cam).image)
    assert out["b"].tobytes() == frame_bytes(tr.render_view(cam, 0.5).image)
    assert out["a"].tobytes() != out["b"].tobytes()


def test_block_cap_matches_jax_loop(tiny_scene):
    """``Trainer.train(block_scan=True, block_cap=...)`` calls on_step at
    the iterations the JAX Trainer's loop gives for the same schedule and
    cap (gs_tpu/train/loop.py:756-761). The JAX loop runs with its blocks
    stubbed to advance the iteration, so only its arithmetic runs."""
    seq = [3, 0, 4] + [2] * 37     # 0: no cap for that block

    def cap_fn(caps):
        return lambda: caps.pop(0)

    test_its = {12}
    tr = _tiny_trainer(tiny_scene)
    port_its = []
    tr.train(iterations=20, block_scan=True, test_iterations=test_its,
             on_step=lambda i, m, t: port_its.append(i),
             on_test=lambda *a: None, block_cap=cap_fn(list(seq)))

    jtr = JTrainer.__new__(JTrainer)
    jtr.opt = JOptimizationConfig(**{
        k: getattr(tr.opt, k) for k in ("iterations", "densify_from_iter",
                                        "densification_interval",
                                        "densify_until_iter",
                                        "opacity_reset_interval")})
    jtr.iteration = 0

    def run_block(k):
        jtr.iteration += k
        return None

    jtr.run_block = run_block
    jtr._apply_schedule = lambda i: None
    jtr.sync_metrics = lambda: None
    jtr.evaluate = lambda cams: {}
    jtr.test_cams = jtr.train_cams = []
    jax_its = []
    jtr.train(iterations=20, block_scan=True, test_iterations=test_its,
              on_step=lambda i, m, t: jax_its.append(i),
              on_test=lambda *a: None, block_cap=cap_fn(list(seq)))
    assert port_its == jax_its
    assert port_its[:3] == [3, 5, 9] and port_its[-1] == 20
    assert tr.iteration == 20
