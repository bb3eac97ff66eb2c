"""Self-contained PLY codec + the reference Gaussian PLY schema — the port's
own copy of ``gs_tpu/data/ply.py`` (numpy only), plus
``search_max_iteration`` from ``gs_tpu/data/scene.py``.

The PLY file is the interchange format with viewers and pretrained models, so
the Gaussian schema must stay byte-compatible with the reference
(ref: scene/gaussian_model.py:193-272 — fields
x,y,z,nx,ny,nz,f_dc_0..2,f_rest_0..(3*(K-1)-1),opacity,scale_0..2,rot_0..3,
all float32, binary_little_endian). ``plyfile`` is not vendored here; this is
a from-scratch reader/writer covering binary-LE and ascii, element "vertex".
"""
from __future__ import annotations

import io
import os
from typing import Optional

import numpy as np

_PLY_DTYPES = {
    "char": "i1", "uchar": "u1", "short": "i2", "ushort": "u2",
    "int": "i4", "uint": "u4", "float": "f4", "double": "f8",
    "int8": "i1", "uint8": "u1", "int16": "i2", "uint16": "u2",
    "int32": "i4", "uint32": "u4", "float32": "f4", "float64": "f8",
}


def search_max_iteration(folder: str) -> int:
    """Largest N of the ``iteration_N`` snapshots in ``folder``
    (ref: utils/system_utils.py:26-30, searchForMaxIteration)."""
    saved = [int(f.split("_")[-1]) for f in os.listdir(folder)
             if f.split("_")[-1].isdigit()]
    return max(saved)


def read_ply(path: str) -> dict[str, np.ndarray]:
    """Read the 'vertex' element of a PLY file into {property: array}."""
    with open(path, "rb") as f:
        magic = f.readline().strip()
        if magic != b"ply":
            raise ValueError(f"{path}: not a PLY file")
        fmt = None
        elements = []  # (name, count, [(prop, np dtype str)])
        cur = None
        while True:
            line = f.readline()
            if not line:
                raise ValueError(f"{path}: unexpected EOF in header")
            tokens = line.decode("ascii", "replace").strip().split()
            if not tokens:
                continue
            if tokens[0] == "format":
                fmt = tokens[1]
            elif tokens[0] == "element":
                cur = (tokens[1], int(tokens[2]), [])
                elements.append(cur)
            elif tokens[0] == "property":
                if tokens[1] == "list":
                    cur[2].append((tokens[4], "list", tokens[2], tokens[3]))
                else:
                    cur[2].append((tokens[2], _PLY_DTYPES[tokens[1]]))
            elif tokens[0] == "end_header":
                break
        out: dict[str, np.ndarray] = {}
        for name, count, props in elements:
            if any(p[1] == "list" for p in props):
                if name == "vertex":
                    raise ValueError(f"{path}: list properties unsupported")
                break  # faces etc. after vertex — ignore
            if fmt == "ascii":
                rows = np.loadtxt(
                    io.StringIO("\n".join(
                        f.readline().decode("ascii") for _ in range(count))),
                    ndmin=2)
                if name == "vertex":
                    for i, (pname, dt) in enumerate(props):
                        out[pname] = rows[:, i].astype(dt)
            else:
                order = "<" if fmt == "binary_little_endian" else ">"
                dtype = np.dtype([(p, order + dt) for p, dt in props])
                data = np.frombuffer(f.read(count * dtype.itemsize),
                                     dtype=dtype, count=count)
                if name == "vertex":
                    for pname, _ in props:
                        out[pname] = np.ascontiguousarray(data[pname])
            if name == "vertex":
                return out
    return out


def write_ply(path: str, props: list[tuple[str, np.ndarray]],
              element: str = "vertex"):
    """Write one element of named float32/uint8 columns, binary-LE."""
    n = len(props[0][1])
    names = {"f4": "float", "u1": "uchar", "f8": "double", "i4": "int"}
    dtype = np.dtype([(p, "<" + a.dtype.str[-2:]) for p, a in props])
    rec = np.empty(n, dtype=dtype)
    header = ["ply", "format binary_little_endian 1.0",
              f"element {element} {n}"]
    for p, a in props:
        assert len(a) == n, f"length mismatch for {p}"
        header.append(f"property {names[a.dtype.str[-2:]]} {p}")
        rec[p] = a
    header.append("end_header")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        f.write(rec.tobytes())


# ------------------------------------------------ point clouds (init data)

def fetch_pointcloud(path: str):
    """(points [N,3], colors [N,3] in [0,1], normals [N,3]) from a PLY.

    ref: scene/dataset_readers.py:114-124 (fetchPly)
    """
    v = read_ply(path)
    pts = np.stack([v["x"], v["y"], v["z"]], axis=1).astype(np.float32)
    if "red" in v:
        cols = np.stack([v["red"], v["green"], v["blue"]], axis=1)
        cols = cols.astype(np.float32)
        if cols.max() > 1.0 + 1e-6:
            cols = cols / 255.0
    else:
        cols = np.full_like(pts, 0.5)
    if "nx" in v:
        normals = np.stack([v["nx"], v["ny"], v["nz"]], axis=1).astype(np.float32)
    else:
        normals = np.zeros_like(pts)
    return pts, cols, normals


def store_pointcloud(path: str, xyz: np.ndarray, rgb: np.ndarray):
    """Write an x,y,z,nx,ny,nz,red,green,blue PLY (rgb uint8 0..255).

    ref: scene/dataset_readers.py:126-138 (storePly)
    """
    normals = np.zeros_like(xyz, dtype=np.float32)
    rgb = np.asarray(rgb)
    if rgb.dtype != np.uint8:
        rgb = np.clip(rgb * 255.0 if rgb.max() <= 1.0 + 1e-6 else rgb,
                      0, 255).astype(np.uint8)
    xyz = xyz.astype(np.float32)
    write_ply(path, [
        ("x", xyz[:, 0]), ("y", xyz[:, 1]), ("z", xyz[:, 2]),
        ("nx", normals[:, 0]), ("ny", normals[:, 1]), ("nz", normals[:, 2]),
        ("red", rgb[:, 0]), ("green", rgb[:, 1]), ("blue", rgb[:, 2]),
    ])


# ------------------------------------------------- Gaussian model snapshot

def save_gaussian_ply(path: str, xyz: np.ndarray, sh_dc: np.ndarray,
                      sh_rest: np.ndarray, logit_opacity: np.ndarray,
                      log_scale: np.ndarray, quat: np.ndarray):
    """Reference-schema model snapshot; inputs are the RAW (pre-activation)
    parameters, shapes [N,3], [N,1,3], [N,K-1,3], [N,1], [N,3], [N,4].

    Field order and f_rest channel-major flattening match
    ref: scene/gaussian_model.py:193-224 (save_ply + construct_list_of_attributes).
    """
    n = xyz.shape[0]
    props: list[tuple[str, np.ndarray]] = []
    f32 = lambda a: np.ascontiguousarray(a, dtype=np.float32)
    for i, name in enumerate("xyz"):
        props.append((name, f32(xyz[:, i])))
    zeros = np.zeros(n, np.float32)
    for name in ("nx", "ny", "nz"):
        props.append((name, zeros))
    # f_dc: [N,1,3] -> transpose(1,2).flatten -> 3 columns
    dc = np.transpose(sh_dc, (0, 2, 1)).reshape(n, -1)
    for i in range(dc.shape[1]):
        props.append((f"f_dc_{i}", f32(dc[:, i])))
    # f_rest: [N,K-1,3] -> [N,3,K-1] -> flatten (channel-major)
    rest = np.transpose(sh_rest, (0, 2, 1)).reshape(n, -1)
    for i in range(rest.shape[1]):
        props.append((f"f_rest_{i}", f32(rest[:, i])))
    props.append(("opacity", f32(logit_opacity[:, 0])))
    for i in range(log_scale.shape[1]):
        props.append((f"scale_{i}", f32(log_scale[:, i])))
    for i in range(quat.shape[1]):
        props.append((f"rot_{i}", f32(quat[:, i])))
    write_ply(path, props)


def load_gaussian_ply(path: str):
    """Inverse of :func:`save_gaussian_ply`; infers the SH degree from the
    number of f_rest_* fields (ref: scene/gaussian_model.py:231-272)."""
    v = read_ply(path)
    n = len(v["x"])
    xyz = np.stack([v["x"], v["y"], v["z"]], axis=1).astype(np.float32)
    logit_opacity = v["opacity"].astype(np.float32)[:, None]
    dc_names = sorted((k for k in v if k.startswith("f_dc_")),
                      key=lambda s: int(s.split("_")[-1]))
    sh_dc = np.stack([v[k] for k in dc_names], axis=1).astype(np.float32)
    sh_dc = sh_dc.reshape(n, 3, 1).transpose(0, 2, 1)       # [N,1,3]
    rest_names = sorted((k for k in v if k.startswith("f_rest_")),
                        key=lambda s: int(s.split("_")[-1]))
    k_rest = len(rest_names) // 3
    if rest_names:
        rest = np.stack([v[k] for k in rest_names], axis=1).astype(np.float32)
        sh_rest = rest.reshape(n, 3, k_rest).transpose(0, 2, 1)  # [N,K-1,3]
    else:
        sh_rest = np.zeros((n, 0, 3), np.float32)
    scale_names = sorted((k for k in v if k.startswith("scale_")),
                         key=lambda s: int(s.split("_")[-1]))
    log_scale = np.stack([v[k] for k in scale_names], axis=1).astype(np.float32)
    rot_names = sorted((k for k in v if k.startswith("rot_")),
                       key=lambda s: int(s.split("_")[-1]))
    quat = np.stack([v[k] for k in rot_names], axis=1).astype(np.float32)
    sh_degree = int(round((k_rest + 1) ** 0.5)) - 1
    return dict(xyz=xyz, sh_dc=sh_dc, sh_rest=sh_rest,
                logit_opacity=logit_opacity, log_scale=log_scale, quat=quat,
                sh_degree=sh_degree)
