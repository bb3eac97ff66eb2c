"""Remote-viewer TCP server — port of ``gs_tpu/viewer/server.py``, wire
compatible with the reference protocol so stock SIBR remote viewers connect.

Protocol (ref: gaussian_renderer/network_gui.py:26-86):
  in : 4-byte LE length + JSON {resolution_x/y, train, fov_y/x, z_near/far,
       shs_python, rot_scale_python, keep_alive, scaling_modifier,
       view_matrix (16 floats), view_projection_matrix (16 floats)}
       — matrix columns 1, 2 arrive sign-flipped and in the reference's
       transposed (glm) layout.
  out: raw RGB bytes (H*W*3, row-major) + 4-byte LE length + source_path.

The training loop drains the socket between iterations (ref: train.py:72-86);
``poll()`` plays that role. A frame is one no-grad render through
``Trainer.render_view`` (one K2 and one K1 launch; two of each when the view
overflows the trainer's buffers), turned into bytes on the render's device,
so 3 bytes a pixel cross to the host, not 12. A failure while serving a
client closes that client's connection and training goes on.
"""
from __future__ import annotations

import json
import math
import socket
import traceback
from typing import Optional

import numpy as np
import torch

from ..core.camera import Camera


def _recv_exact(conn: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = conn.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed")
        buf += chunk
    return buf


def decode_camera(message: dict, device="cuda") -> Optional[Camera]:
    """Rebuild a Camera on ``device`` from a viewer message (ref:
    network_gui.py:57-82); None for a zero resolution.

    The viewer sends the reference's transposed (glm) matrices with columns
    1, 2 sign-flipped; the Camera stores math-normal orientation, so the
    matrices are transposed after the flips (in float32 numpy, as the JAX
    package decodes them).
    """
    width = int(message["resolution_x"])
    height = int(message["resolution_y"])
    if width == 0 or height == 0:
        return None
    wv = np.array(message["view_matrix"], np.float32).reshape(4, 4)
    wv[:, 1] = -wv[:, 1]
    wv[:, 2] = -wv[:, 2]
    fp = np.array(message["view_projection_matrix"], np.float32).reshape(4, 4)
    fp[:, 1] = -fp[:, 1]
    V = wv.T
    P = fp.T
    cam_center = np.linalg.inv(V)[:3, 3]

    def f32(x):
        return torch.tensor(np.asarray(x, np.float32), device=device)

    return Camera(
        world_view=f32(V), full_proj=f32(P), camera_center=f32(cam_center),
        tan_fovx=f32(math.tan(message["fov_x"] * 0.5)),
        tan_fovy=f32(math.tan(message["fov_y"] * 0.5)),
        width=width, height=height)


def frame_bytes(image: torch.Tensor) -> bytes:
    """[3, H, W] float image -> H*W*3 RGB bytes by the JAX server's formula,
    ``(clip(img, 0, 1) * 255).astype(uint8)`` (truncating), computed on the
    image's device."""
    rgb = (torch.clamp(image, 0.0, 1.0) * 255).to(torch.uint8)
    return rgb.permute(1, 2, 0).contiguous().cpu().numpy().tobytes()


class ViewerServer:
    """Non-blocking listener + per-iteration drain (ref: network_gui.py:24-55).

    Frames come from ``render_fn(camera, scaling_modifier) -> [3, H, W]``
    when given, else from ``trainer.render_view``. Cameras are decoded onto
    ``device``: the trainer's when there is one, else ``cuda`` unless the
    caller asks for the CPU."""

    def __init__(self, host: str, port: int, *, trainer=None,
                 source_path: str = "", render_fn=None, device=None):
        self.trainer = trainer
        self.source_path = source_path
        self.render_fn = render_fn
        if device is None:
            device = trainer.device if trainer is not None else "cuda"
        self.device = torch.device(device)
        self.listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        try:
            self.listener.bind((host, port))
            self.listener.listen()
        except OSError:
            self.listener.close()
            raise
        self.listener.settimeout(0)
        self.conn: Optional[socket.socket] = None

    @property
    def port(self) -> int:
        return self.listener.getsockname()[1]

    def try_connect(self):
        try:
            self.conn, addr = self.listener.accept()
            print(f"\nConnected by {addr}")
            self.conn.settimeout(None)
        except (BlockingIOError, socket.timeout, OSError):
            pass

    def _read(self) -> dict:
        length = int.from_bytes(_recv_exact(self.conn, 4), "little")
        return json.loads(_recv_exact(self.conn, length).decode("utf-8"))

    def _send(self, image_bytes: Optional[bytes]):
        if image_bytes is not None:
            self.conn.sendall(image_bytes)
        verify = self.source_path
        self.conn.sendall(len(verify).to_bytes(4, "little"))
        self.conn.sendall(verify.encode("ascii"))

    @torch.no_grad()
    def _render_view(self, cam: Camera, scaling_modifier: float) -> bytes:
        if self.render_fn is not None:
            img = self.render_fn(cam, scaling_modifier)
        else:
            img = self.trainer.render_view(cam, scaling_modifier).image
        return frame_bytes(img)

    def poll(self, in_training: bool = True) -> None:
        """Drain the pending viewer requests (ref: train.py:72-86): return
        when none is waiting, or after a request that lets training go on
        (``train`` true, and ``in_training`` or not ``keep_alive``). A
        paused client's requests (``train`` false) are all served before
        training resumes."""
        if self.conn is None:
            self.try_connect()
        while self.conn is not None:
            try:
                # anything waiting?
                self.conn.settimeout(0)
                try:
                    peek = self.conn.recv(1, socket.MSG_PEEK)
                    if not peek:
                        raise ConnectionError("peer closed")
                except (BlockingIOError, socket.timeout):
                    return
                finally:
                    self.conn.settimeout(None)
                message = self._read()
                cam = decode_camera(message, self.device)
                image_bytes = None
                if cam is not None:
                    image_bytes = self._render_view(
                        cam, float(message.get("scaling_modifier", 1.0)))
                self._send(image_bytes)
                do_training = bool(message.get("train", True))
                keep_alive = bool(message.get("keep_alive", False))
                if do_training and (in_training or not keep_alive):
                    return
            except Exception as e:
                if isinstance(e, ConnectionError):   # the client went away
                    print(f"\nViewer client disconnected: {e}")
                else:
                    traceback.print_exc()
                try:
                    self.conn.close()
                except OSError:
                    pass
                self.conn = None

    def close(self):
        if self.conn is not None:
            try:
                self.conn.close()
            except OSError:
                pass
        self.listener.close()
