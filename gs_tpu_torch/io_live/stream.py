"""Live posed-frame stream — the port's copy of ``gs_tpu/io_live/stream.py``,
the framework's replacement for the ROS ``/Visual_Merged`` topic (ref:
SURVEY.md §2.2; submodules/ros_workspace/src/gs_slam_msgs/msg/
visual_merged_msg.msg:1-4).

A frame message carries the same four payloads as ``visual_merged_msg``
(Image + CameraInfo + CameraPose + optional local point cloud), serialized as
a 4-byte-LE-length-prefixed msgpack map over TCP:

  {
    "stamp":  float seconds,
    "width":  int, "height": int,
    "encoding": "jpeg" | "png" | "rgb8",
    "image":  bytes,
    "K":      [9 floats]  row-major 3x3 intrinsics (CameraInfo.K),
    "qvec":   [w, x, y, z]   camera pose rotation,
    "tvec":   [x, y, z]      camera pose translation,
    "pose_convention": "c2w" | "w2c",
    "points": optional [N*3 floats] local map points (PointCloud2),
  }

The bytes on the wire and in a ``.gstream`` file are the JAX package's,
byte for byte: the map goes through the port's standard-library codec
(``utils/msgpack_codec.py``, ``utils/msgpack_reader.py``) in place of
``msgpack``, and PIL is imported only to encode or decode an image.
"""
from __future__ import annotations

import socket
import threading
import time
from typing import NamedTuple, Optional

import numpy as np

from ..utils.msgpack_codec import packb
from ..utils.msgpack_reader import unpackb


class Frame(NamedTuple):
    stamp: float
    image: np.ndarray        # [H, W, 3] uint8
    K: np.ndarray            # [3, 3]
    qvec: np.ndarray         # (w, x, y, z)
    tvec: np.ndarray         # [3]
    pose_convention: str     # "c2w" | "w2c"
    points: Optional[np.ndarray]  # [N, 3] or None


def decode_image(payload, encoding: str, width: int,
                 height: int) -> np.ndarray:
    """rgb8/jpeg/png -> [H, W, 3] uint8 (ref: dataset_readers.py:278-309
    imgmsg_to_pli handles rgb8/bgr8/mono8)."""
    if encoding == "rgb8":
        return np.frombuffer(payload, np.uint8).reshape(height, width, 3)
    if encoding == "bgr8":
        arr = np.frombuffer(payload, np.uint8).reshape(height, width, 3)
        return arr[:, :, ::-1]
    if encoding == "mono8":
        arr = np.frombuffer(payload, np.uint8).reshape(height, width)
        return np.repeat(arr[:, :, None], 3, axis=2)
    if encoding in ("jpeg", "png"):
        import io
        from PIL import Image
        with Image.open(io.BytesIO(payload)) as im:
            return np.asarray(im.convert("RGB"))
    raise ValueError(f"unknown image encoding {encoding!r}")


def encode_frame(frame: Frame, encoding: str = "jpeg") -> bytes:
    if encoding == "rgb8":
        payload = frame.image.tobytes()
    else:
        import io
        from PIL import Image
        buf = io.BytesIO()
        Image.fromarray(frame.image).save(buf, format=encoding.upper())
        payload = buf.getvalue()
    msg = {
        "stamp": frame.stamp,
        "width": int(frame.image.shape[1]),
        "height": int(frame.image.shape[0]),
        "encoding": encoding,
        "image": payload,
        "K": [float(x) for x in np.asarray(frame.K).ravel()],
        "qvec": [float(x) for x in frame.qvec],
        "tvec": [float(x) for x in frame.tvec],
        "pose_convention": frame.pose_convention,
    }
    if frame.points is not None:
        # float64 values, packed as the list of floats the JAX package sends
        msg["points"] = np.asarray(frame.points, np.float64).ravel()
    blob = packb(msg)
    return len(blob).to_bytes(4, "little") + blob


def decode_frame(blob: bytes) -> Frame:
    msg = unpackb(blob)
    image = decode_image(msg["image"], msg["encoding"], msg["width"],
                         msg["height"])
    pts = None
    if msg.get("points"):
        pts = np.asarray(msg["points"], np.float32).reshape(-1, 3)
    return Frame(
        stamp=float(msg["stamp"]),
        image=image,
        K=np.asarray(msg["K"], np.float64).reshape(3, 3),
        qvec=np.asarray(msg["qvec"], np.float64),
        tvec=np.asarray(msg["tvec"], np.float64),
        pose_convention=msg.get("pose_convention", "c2w"),
        points=pts,
    )


def _recv_exact(conn: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = conn.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed")
        buf += chunk
    return bytes(buf)


class FrameStreamServer:
    """Collects frames from one TCP publisher; the live trainer's stand-in
    for ``rospy.wait_for_message('/Visual_Merged', ...)``
    (ref: train_sdu6.py:56-67)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 6011):
        self.listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.listener.bind((host, port))
        self.listener.listen()
        self.frames: list[Frame] = []
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()

    @property
    def port(self) -> int:
        return self.listener.getsockname()[1]

    def _serve(self):
        self.listener.settimeout(0.2)
        conn = None
        while not self._stop.is_set():
            if conn is None:
                try:
                    conn, _ = self.listener.accept()
                    conn.settimeout(0.5)
                except (socket.timeout, OSError):
                    continue
            try:
                n = int.from_bytes(_recv_exact(conn, 4), "little")
                frame = decode_frame(_recv_exact(conn, n))
                with self._lock:
                    self.frames.append(frame)
            except socket.timeout:
                continue
            except (ConnectionError, OSError):
                conn.close()
                conn = None
        if conn is not None:
            conn.close()

    def wait_for_frames(self, count: int, timeout: float = 60.0,
                        poll: float = 0.2) -> list[Frame]:
        """Block until ``count`` frames arrived (or timeout); returns a copy.
        Mirrors the reference's bounded collect loop (train_sdu6.py:56-67)."""
        deadline = time.time() + timeout
        while time.time() < deadline:
            with self._lock:
                if len(self.frames) >= count:
                    return list(self.frames[:count])
            time.sleep(poll)
        with self._lock:
            return list(self.frames)

    def close(self):
        self._stop.set()
        self._thread.join(timeout=2)
        self.listener.close()


def write_stream_file(path: str, frames, encoding: str = "jpeg"):
    """Record frames to disk — the framework's 'rosbag': a concatenation of
    the same length-prefixed msgpack messages used on the wire."""
    with open(path, "wb") as f:
        for frame in frames:
            f.write(encode_frame(frame, encoding))


def read_stream_file(path: str) -> list:
    frames = []
    with open(path, "rb") as f:
        while True:
            head = f.read(4)
            if len(head) < 4:
                break
            n = int.from_bytes(head, "little")
            frames.append(decode_frame(f.read(n)))
    return frames


class FrameStreamClient:
    """Publisher side (sensor rig / test harness)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 6011,
                 timeout: float = 10.0):
        self.sock = socket.create_connection((host, port), timeout=timeout)

    def send(self, frame: Frame, encoding: str = "jpeg"):
        self.sock.sendall(encode_frame(frame, encoding))

    def close(self):
        self.sock.close()
