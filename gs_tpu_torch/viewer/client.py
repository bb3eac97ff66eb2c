"""Remote-viewer TCP client — port of ``gs_tpu/viewer/client.py``: the SIBR
remote viewer's side of the protocol (ref: gaussian_renderer/network_gui.py
:43-86 from the server's side).

Useful for scripted frame grabs from a live training process and as the test
harness for :class:`gs_tpu_torch.viewer.server.ViewerServer`. A request may
be sent ahead of reading the previous reply (``send_request`` /
``read_reply``); ``request_frame`` does both.
"""
from __future__ import annotations

import json
import math
import socket

import numpy as np

from .server import _recv_exact


def encode_request(camera, *, width: int = 0, height: int = 0,
                   train: bool = True, keep_alive: bool = True,
                   scaling_modifier: float = 1.0, shs_python: bool = False,
                   rot_scale_python: bool = False) -> tuple[bytes, int, int]:
    """The wire bytes of a request for ``camera`` (a gs_tpu_torch Camera,
    or None for no image), and the image size the reply will carry."""
    if camera is not None:
        width = width or camera.width
        height = height or camera.height
        # math-normal matrices -> the reference's transposed layout with
        # columns 1,2 sign-flipped (the inverse of the server's decode)
        wv = camera.world_view.detach().cpu().numpy().T.copy()
        wv[:, 1] = -wv[:, 1]
        wv[:, 2] = -wv[:, 2]
        fp = camera.full_proj.detach().cpu().numpy().T.copy()
        fp[:, 1] = -fp[:, 1]
        fovx = 2 * math.atan(float(camera.tan_fovx))
        fovy = 2 * math.atan(float(camera.tan_fovy))
    else:
        width = height = 0
        wv = np.zeros((4, 4)); fp = np.zeros((4, 4))
        fovx = fovy = 0.0
    message = {
        "resolution_x": width, "resolution_y": height,
        "train": train, "fov_y": fovy, "fov_x": fovx,
        "z_near": 0.01, "z_far": 100.0,
        "shs_python": shs_python, "rot_scale_python": rot_scale_python,
        "keep_alive": keep_alive, "scaling_modifier": scaling_modifier,
        "view_matrix": [float(x) for x in wv.reshape(-1)],
        "view_projection_matrix": [float(x) for x in fp.reshape(-1)],
    }
    payload = json.dumps(message).encode("utf-8")
    return len(payload).to_bytes(4, "little") + payload, width, height


class ViewerClient:
    def __init__(self, host: str = "127.0.0.1", port: int = 6009,
                 timeout: float = 30.0):
        self.sock = socket.create_connection((host, port), timeout=timeout)

    def send_request(self, camera, **kwargs) -> tuple[int, int]:
        """Send a request (``encode_request``'s arguments); returns the
        (width, height) to pass to ``read_reply``."""
        wire, width, height = encode_request(camera, **kwargs)
        self.sock.sendall(wire)
        return width, height

    def read_reply(self, width: int, height: int) -> tuple:
        """(image [H, W, 3] uint8 or None, source_path str)."""
        image = None
        if width and height:
            raw = _recv_exact(self.sock, width * height * 3)
            image = np.frombuffer(raw, np.uint8).reshape(height, width, 3)
        n = int.from_bytes(_recv_exact(self.sock, 4), "little")
        source_path = _recv_exact(self.sock, n).decode("ascii")
        return image, source_path

    def request_frame(self, camera, **kwargs) -> tuple:
        """Request a render of ``camera``; returns (image [H, W, 3] uint8 or
        None, source_path str)."""
        return self.read_reply(*self.send_request(camera, **kwargs))

    def close(self):
        self.sock.close()
