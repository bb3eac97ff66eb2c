"""The native (C++) COLMAP parser, loaded through ctypes — the port's copy of
``gs_tpu/native``, with its own copy of the source beside this file
(``colmap_io.cpp``).

The reference parses COLMAP's binary models with per-record Python struct
loops (scene/colmap_loader.py:125-242), as ``data/colmap.py``'s fallback
does. Here the parse is host C++, compiled at first use with
``g++ -O2 -shared -fPIC -std=c++17`` into ``gs_tpu_torch/_build/``, named by
a hash of the source and the flags (as ``ops/_cuda.py`` names the kernel
libraries), so an edited source is rebuilt and an unchanged one reused.
Without a compiler, or when the build fails, :func:`available` is False
(said once on stderr) and ``data/colmap.py`` reads with its Python loops.
``reads`` counts the files the native route parsed.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SOURCE = Path(__file__).resolve().parent / "colmap_io.cpp"
BUILD = Path(__file__).resolve().parent.parent / "_build"
FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")

_LOCK = threading.Lock()
_state = {"lib": None, "tried": False}
reads = 0          # files parsed by the native route


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(FLAGS).encode())
    return BUILD / f"colmap_io-{h.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> str:
    """Compile the library if it is missing. Returns its path; raises when
    there is no ``g++`` or the compile fails."""
    out = library_path()
    if out.exists():
        return str(out)
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found on PATH")
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [cxx, *FLAGS, "-o", str(tmp), str(SOURCE)]
    if verbose:
        print("[gs_tpu_torch.native]", " ".join(cmd))
    subprocess.run(cmd, check=True, capture_output=not verbose)
    os.replace(tmp, out)   # atomic: concurrent builders never see half a file
    return str(out)


def _load() -> Optional[ctypes.CDLL]:
    with _LOCK:
        if _state["lib"] is not None or _state["tried"]:
            return _state["lib"]
        _state["tried"] = True
        try:
            lib = ctypes.CDLL(build())
        except (OSError, RuntimeError, subprocess.CalledProcessError) as e:
            print(f"[gs_tpu_torch.native] native build unavailable ({e}); "
                  "using pure-Python loaders", file=sys.stderr)
            return None
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.gs_free.argtypes = [ctypes.c_void_p]
        lib.gs_free.restype = None
        lib.gs_read_points3d_bin.argtypes = [
            ctypes.c_char_p, i64p,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_double)),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_double))]
        lib.gs_read_images_bin.argtypes = [
            ctypes.c_char_p, i64p,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_int32)),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_double)),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_double)),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_int32)),
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.POINTER(i64p), i64p]
        lib.gs_read_cameras_bin.argtypes = [
            ctypes.c_char_p, i64p,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_int32)),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_int32)),
            ctypes.POINTER(i64p),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_double)),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_int32))]
        for fn in (lib.gs_read_points3d_bin, lib.gs_read_images_bin,
                   lib.gs_read_cameras_bin):
            fn.restype = ctypes.c_int
        _state["lib"] = lib
        return lib


def available() -> bool:
    return _load() is not None


def _copy_free(lib, ptr, shape, nptype):
    arr = np.ctypeslib.as_array(ptr, shape=shape).copy()
    lib.gs_free(ptr)
    return arr.astype(nptype, copy=False)


def _call(lib, fn, path: str, *outs):
    global reads
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    rc = fn(path.encode(), *(ctypes.byref(o) for o in outs))
    if rc != 0:
        raise IOError(f"{fn.__name__}({path}) failed with code {rc}")
    reads += 1


def read_points3d_bin(path: str):
    """(xyz [N,3] f64, rgb [N,3] u8, err [N,1] f64) or None if unavailable."""
    lib = _load()
    if lib is None:
        return None
    n = ctypes.c_int64()
    xyz = ctypes.POINTER(ctypes.c_double)()
    rgb = ctypes.POINTER(ctypes.c_uint8)()
    err = ctypes.POINTER(ctypes.c_double)()
    _call(lib, lib.gs_read_points3d_bin, path, n, xyz, rgb, err)
    count = n.value
    return (_copy_free(lib, xyz, (count, 3), np.float64),
            _copy_free(lib, rgb, (count, 3), np.uint8),
            _copy_free(lib, err, (count, 1), np.float64))


def read_images_bin(path: str):
    """list of dicts {id, qvec, tvec, camera_id, name} or None."""
    lib = _load()
    if lib is None:
        return None
    n = ctypes.c_int64()
    ids = ctypes.POINTER(ctypes.c_int32)()
    qvecs = ctypes.POINTER(ctypes.c_double)()
    tvecs = ctypes.POINTER(ctypes.c_double)()
    cam_ids = ctypes.POINTER(ctypes.c_int32)()
    names = ctypes.c_char_p()
    name_off = ctypes.POINTER(ctypes.c_int64)()
    names_len = ctypes.c_int64()
    _call(lib, lib.gs_read_images_bin, path, n, ids, qvecs, tvecs, cam_ids,
          names, name_off, names_len)
    count = n.value
    ids_a = _copy_free(lib, ids, (count,), np.int32)
    q_a = _copy_free(lib, qvecs, (count, 4), np.float64)
    t_a = _copy_free(lib, tvecs, (count, 3), np.float64)
    c_a = _copy_free(lib, cam_ids, (count,), np.int32)
    off_a = np.ctypeslib.as_array(name_off, shape=(count + 1,)).copy()
    blob = ctypes.string_at(names, names_len.value)
    lib.gs_free(name_off)
    lib.gs_free(ctypes.cast(names, ctypes.c_void_p))
    return [dict(id=int(ids_a[i]), qvec=q_a[i], tvec=t_a[i],
                 camera_id=int(c_a[i]),
                 name=blob[off_a[i]:off_a[i + 1]].decode("utf-8"))
            for i in range(count)]


def read_cameras_bin(path: str):
    """list of dicts {id, model_id, width, height, params} or None."""
    lib = _load()
    if lib is None:
        return None
    n = ctypes.c_int64()
    ids = ctypes.POINTER(ctypes.c_int32)()
    models = ctypes.POINTER(ctypes.c_int32)()
    wh = ctypes.POINTER(ctypes.c_int64)()
    params = ctypes.POINTER(ctypes.c_double)()
    pcounts = ctypes.POINTER(ctypes.c_int32)()
    _call(lib, lib.gs_read_cameras_bin, path, n, ids, models, wh, params,
          pcounts)
    count = n.value
    ids_a = _copy_free(lib, ids, (count,), np.int32)
    m_a = _copy_free(lib, models, (count,), np.int32)
    wh_a = _copy_free(lib, wh, (count, 2), np.int64)
    pc_a = _copy_free(lib, pcounts, (count,), np.int32)
    total = int(pc_a.sum())
    p_a = _copy_free(lib, params, (total,), np.float64)
    out, off = [], 0
    for i in range(count):
        k = int(pc_a[i])
        out.append(dict(id=int(ids_a[i]), model_id=int(m_a[i]),
                        width=int(wh_a[i, 0]), height=int(wh_a[i, 1]),
                        params=p_a[off:off + k]))
        off += k
    return out
