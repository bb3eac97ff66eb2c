"""COLMAP sparse-model I/O (binary and text), readers + writers — the
port's own copy of ``gs_tpu/data/colmap.py`` (numpy and the standard library
only). The binary readers dispatch to the native C++ parser
(``gs_tpu_torch/native``, built at first use) when it is available, as
``gs_tpu/data/colmap.py:88-160`` does; their per-record Python loops are the
fallback.

Behavioral port of the reference loaders (ref: scene/colmap_loader.py:1-295
and utils/read_write_model.py:106-523): cameras.bin / images.bin /
points3D.bin struct layouts, the text variants, quaternion<->rotation
conversions, and writers so dataset converters can emit COLMAP layouts.
"""
from __future__ import annotations

import os
import struct
from typing import NamedTuple

import numpy as np


class CameraModel(NamedTuple):
    model_id: int
    model_name: str
    num_params: int


# ref: scene/colmap_loader.py:24-36
CAMERA_MODELS = [
    CameraModel(0, "SIMPLE_PINHOLE", 3),
    CameraModel(1, "PINHOLE", 4),
    CameraModel(2, "SIMPLE_RADIAL", 4),
    CameraModel(3, "RADIAL", 5),
    CameraModel(4, "OPENCV", 8),
    CameraModel(5, "OPENCV_FISHEYE", 8),
    CameraModel(6, "FULL_OPENCV", 12),
    CameraModel(7, "FOV", 5),
    CameraModel(8, "SIMPLE_RADIAL_FISHEYE", 4),
    CameraModel(9, "RADIAL_FISHEYE", 5),
    CameraModel(10, "THIN_PRISM_FISHEYE", 12),
]
CAMERA_MODEL_IDS = {m.model_id: m for m in CAMERA_MODELS}
CAMERA_MODEL_NAMES = {m.model_name: m for m in CAMERA_MODELS}


class Intrinsics(NamedTuple):
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray


class Extrinsics(NamedTuple):
    id: int
    qvec: np.ndarray   # (w, x, y, z) world->cam rotation
    tvec: np.ndarray   # world->cam translation
    camera_id: int
    name: str
    xys: np.ndarray
    point3D_ids: np.ndarray


def qvec2rotmat(qvec):
    """(w,x,y,z) -> 3x3 (ref: scene/colmap_loader.py:43-54)."""
    w, x, y, z = qvec
    return np.array([
        [1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * w * z, 2 * x * z + 2 * w * y],
        [2 * x * y + 2 * w * z, 1 - 2 * x * x - 2 * z * z, 2 * y * z - 2 * w * x],
        [2 * x * z - 2 * w * y, 2 * y * z + 2 * w * x, 1 - 2 * x * x - 2 * y * y]])


def rotmat2qvec(R):
    """3x3 -> (w,x,y,z) (ref: scene/colmap_loader.py:56-66)."""
    Rxx, Ryx, Rzx, Rxy, Ryy, Rzy, Rxz, Ryz, Rzz = R.flat
    K = np.array([
        [Rxx - Ryy - Rzz, 0, 0, 0],
        [Ryx + Rxy, Ryy - Rxx - Rzz, 0, 0],
        [Rzx + Rxz, Rzy + Ryz, Rzz - Rxx - Ryy, 0],
        [Ryz - Rzy, Rzx - Rxz, Rxy - Ryx, Rxx + Ryy + Rzz]]) / 3.0
    eigvals, eigvecs = np.linalg.eigh(K)
    qvec = eigvecs[[3, 0, 1, 2], np.argmax(eigvals)]
    if qvec[0] < 0:
        qvec *= -1
    return qvec


def _read_next_bytes(fid, num_bytes, format_char_sequence, endian="<"):
    return struct.unpack(endian + format_char_sequence, fid.read(num_bytes))


# --------------------------------------------------------------- binary
# The binary readers dispatch to the native C++ parser when available
# (gs_tpu_torch/native — the per-record Python loops below are the fallback).

def read_intrinsics_binary(path: str) -> dict[int, Intrinsics]:
    """ref: scene/colmap_loader.py:216-242"""
    from .. import native
    rows = native.read_cameras_bin(path) if native.available() else None
    if rows is not None:
        return {r["id"]: Intrinsics(
            id=r["id"], model=CAMERA_MODEL_IDS[r["model_id"]].model_name,
            width=r["width"], height=r["height"],
            params=np.asarray(r["params"])) for r in rows}
    cameras = {}
    with open(path, "rb") as f:
        num = _read_next_bytes(f, 8, "Q")[0]
        for _ in range(num):
            cam_id, model_id, width, height = _read_next_bytes(f, 24, "iiQQ")
            model = CAMERA_MODEL_IDS[model_id]
            params = _read_next_bytes(f, 8 * model.num_params,
                                      "d" * model.num_params)
            cameras[cam_id] = Intrinsics(
                id=cam_id, model=model.model_name, width=int(width),
                height=int(height), params=np.array(params))
    return cameras


def read_extrinsics_binary(path: str) -> dict[int, Extrinsics]:
    """ref: scene/colmap_loader.py:181-213"""
    from .. import native
    rows = native.read_images_bin(path) if native.available() else None
    if rows is not None:
        empty_xy = np.zeros((0, 2))
        empty_ids = np.zeros((0,), np.int64)
        return {r["id"]: Extrinsics(
            id=r["id"], qvec=r["qvec"], tvec=r["tvec"],
            camera_id=r["camera_id"], name=r["name"],
            xys=empty_xy, point3D_ids=empty_ids) for r in rows}
    images = {}
    with open(path, "rb") as f:
        num = _read_next_bytes(f, 8, "Q")[0]
        for _ in range(num):
            props = _read_next_bytes(f, 64, "idddddddi")
            image_id = props[0]
            qvec = np.array(props[1:5])
            tvec = np.array(props[5:8])
            camera_id = props[8]
            name = b""
            c = f.read(1)
            while c != b"\x00":
                name += c
                c = f.read(1)
            n2d = _read_next_bytes(f, 8, "Q")[0]
            data = _read_next_bytes(f, 24 * n2d, "ddq" * n2d)
            xys = np.column_stack([np.array(data[0::3]), np.array(data[1::3])])
            pids = np.array(data[2::3], dtype=np.int64)
            images[image_id] = Extrinsics(
                id=image_id, qvec=qvec, tvec=tvec, camera_id=camera_id,
                name=name.decode("utf-8"), xys=xys, point3D_ids=pids)
    return images


def read_points3D_binary(path: str):
    """(xyz [N,3], rgb [N,3] uint8, errors [N,1]); ref: scene/colmap_loader.py:125-154"""
    from .. import native
    if native.available():
        out = native.read_points3d_bin(path)
        if out is not None:
            return out
    with open(path, "rb") as f:
        num = _read_next_bytes(f, 8, "Q")[0]
        xyz = np.empty((num, 3))
        rgb = np.empty((num, 3), dtype=np.uint8)
        err = np.empty((num, 1))
        for i in range(num):
            props = _read_next_bytes(f, 43, "QdddBBBd")
            xyz[i] = props[1:4]
            rgb[i] = props[4:7]
            err[i] = props[7]
            track_len = _read_next_bytes(f, 8, "Q")[0]
            f.seek(8 * track_len, 1)
    return xyz, rgb, err


# ----------------------------------------------------------------- text

def read_intrinsics_text(path: str) -> dict[int, Intrinsics]:
    """ref: scene/colmap_loader.py:70-95"""
    cameras = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            elems = line.split()
            cam_id = int(elems[0])
            cameras[cam_id] = Intrinsics(
                id=cam_id, model=elems[1], width=int(elems[2]),
                height=int(elems[3]),
                params=np.array(tuple(map(float, elems[4:]))))
    return cameras


def read_extrinsics_text(path: str) -> dict[int, Extrinsics]:
    """ref: scene/colmap_loader.py:98-123"""
    images = {}
    with open(path) as f:
        lines = [ln.strip() for ln in f]
    i = 0
    while i < len(lines):
        line = lines[i]
        i += 1
        if not line or line.startswith("#"):
            continue
        elems = line.split()
        image_id = int(elems[0])
        qvec = np.array(tuple(map(float, elems[1:5])))
        tvec = np.array(tuple(map(float, elems[5:8])))
        camera_id = int(elems[8])
        name = elems[9]
        pts_line = lines[i] if i < len(lines) else ""
        i += 1
        elems2 = pts_line.split()
        if elems2:
            xys = np.column_stack([np.array(tuple(map(float, elems2[0::3]))),
                                   np.array(tuple(map(float, elems2[1::3])))])
            pids = np.array(tuple(map(int, elems2[2::3])), dtype=np.int64)
        else:
            xys = np.zeros((0, 2))
            pids = np.zeros((0,), dtype=np.int64)
        images[image_id] = Extrinsics(
            id=image_id, qvec=qvec, tvec=tvec, camera_id=camera_id,
            name=name, xys=xys, point3D_ids=pids)
    return images


def read_points3D_text(path: str):
    """ref: scene/colmap_loader.py:157-178"""
    xyzs, rgbs, errs = [], [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            elems = line.split()
            xyzs.append(tuple(map(float, elems[1:4])))
            rgbs.append(tuple(map(int, elems[4:7])))
            errs.append(float(elems[7]))
    return (np.array(xyzs), np.array(rgbs, dtype=np.uint8),
            np.array(errs)[:, None])


# -------------------------------------------------------------- writers
# (behavioral port of utils/read_write_model.py:223-332 — needed by the
# dataset converters and for test round-trips)

def write_intrinsics_text(cameras: dict[int, Intrinsics], path: str):
    with open(path, "w") as f:
        f.write("# Camera list with one line of data per camera:\n"
                "#   CAMERA_ID, MODEL, WIDTH, HEIGHT, PARAMS[]\n"
                f"# Number of cameras: {len(cameras)}\n")
        for cam in cameras.values():
            params = " ".join(map(str, cam.params))
            f.write(f"{cam.id} {cam.model} {cam.width} {cam.height} {params}\n")


def write_extrinsics_text(images: dict[int, Extrinsics], path: str):
    with open(path, "w") as f:
        f.write("# Image list with two lines of data per image:\n"
                "#   IMAGE_ID, QW, QX, QY, QZ, TX, TY, TZ, CAMERA_ID, NAME\n"
                "#   POINTS2D[] as (X, Y, POINT3D_ID)\n")
        for im in images.values():
            q = " ".join(map(str, im.qvec))
            t = " ".join(map(str, im.tvec))
            f.write(f"{im.id} {q} {t} {im.camera_id} {im.name}\n")
            pts = " ".join(f"{x} {y} {p}" for (x, y), p
                           in zip(im.xys, im.point3D_ids))
            f.write(pts + "\n")


def write_intrinsics_binary(cameras: dict[int, Intrinsics], path: str):
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(cameras)))
        for cam in cameras.values():
            model = CAMERA_MODEL_NAMES[cam.model]
            f.write(struct.pack("<iiQQ", cam.id, model.model_id,
                                cam.width, cam.height))
            f.write(struct.pack("<" + "d" * len(cam.params), *cam.params))


def write_extrinsics_binary(images: dict[int, Extrinsics], path: str):
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(images)))
        for im in images.values():
            f.write(struct.pack("<idddddddi", im.id, *im.qvec, *im.tvec,
                                im.camera_id))
            f.write(im.name.encode("utf-8") + b"\x00")
            f.write(struct.pack("<Q", len(im.point3D_ids)))
            for (x, y), p in zip(im.xys, im.point3D_ids):
                f.write(struct.pack("<ddq", x, y, int(p)))


def write_points3D_binary(xyz: np.ndarray, rgb: np.ndarray,
                          err: np.ndarray, path: str):
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(xyz)))
        for i in range(len(xyz)):
            f.write(struct.pack("<QdddBBBd", i + 1, *xyz[i],
                                *np.asarray(rgb[i], np.uint8),
                                float(np.ravel(err)[i] if err is not None else 0)))
            f.write(struct.pack("<Q", 0))
