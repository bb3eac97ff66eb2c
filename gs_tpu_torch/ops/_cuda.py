"""Build and load the port's CUDA kernels.

Each source under ``gs_tpu_torch/csrc/`` is compiled by ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface, and loaded with
``ctypes``. Libraries go to ``gs_tpu_torch/_build/``, named by a hash of the
source, the shared headers and the flags, so an edited kernel is rebuilt and
an unchanged one is reused. :func:`build` starts one ``nvcc`` per missing
library, all at once. A missing ``nvcc`` or a failed compile raises.

Every C entry point returns ``cudaGetLastError()`` after its launch;
:func:`check` raises on anything but 0. :func:`function` looks each entry
up once and keeps it, with its argument types set, so a launch costs one
dictionary lookup and the ctypes call.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD = PKG / "_build"
SOURCES = ("expand.cu", "rasterize_fwd.cu", "rasterize_bwd.cu", "fold.cu",
           "preprocess.cu", "adam.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
NVCC_CANDIDATES = ("/usr/local/cuda/bin/nvcc",)

_libs: dict[str, ctypes.CDLL] = {}
_entries: dict[tuple[str, str], ctypes._CFuncPtr] = {}


def find_nvcc() -> str:
    """Path of ``nvcc``: on PATH, under $CUDA_HOME, or the toolkit default."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME")
    candidates = ((os.path.join(home, "bin", "nvcc"),) if home else ()) \
        + NVCC_CANDIDATES
    for cand in candidates:
        if os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "CUDA kernels of gs_tpu_torch are built at first use and need the "
        "CUDA toolkit")


def library_path(source: str) -> Path:
    h = hashlib.sha256()
    for path in sorted(CSRC.glob("*.cuh")) + [CSRC / source]:
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD / f"{Path(source).stem}-{h.hexdigest()[:16]}.so"


def build(sources=SOURCES) -> dict[str, str]:
    """Compile every source in ``sources`` whose library is missing, one
    ``nvcc`` each, in parallel. Returns {source: compiler output} for what
    it compiled (``-Xptxas -v`` reports registers, shared memory, spills)."""
    todo = [(s, library_path(s)) for s in sources if not library_path(s).exists()]
    if not todo:
        return {}
    nvcc = find_nvcc()
    BUILD.mkdir(parents=True, exist_ok=True)
    procs = []
    for source, out in todo:
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)]
        procs.append((source, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, failed = {}, []
    for source, out, tmp, proc in procs:
        log, _ = proc.communicate()
        logs[source] = log
        if proc.returncode != 0:
            failed.append(f"{source} (exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, out)   # atomic: concurrent builders never see half a file
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def function(source: str, name: str, argtypes) -> ctypes._CFuncPtr:
    """The C entry ``name`` of ``source``'s library (built if missing),
    with its argument types set and an ``int`` (cudaError_t) result. The
    first call per (source, name) looks it up and sets ``argtypes``; later
    calls return the same entry."""
    fn = _entries.get((source, name))
    if fn is not None:
        return fn
    lib = _libs.get(source)
    if lib is None:
        path = library_path(source)
        if not path.exists():
            build([source])
        lib = ctypes.CDLL(str(path))
        lib.gs_cuda_error_string.argtypes = [ctypes.c_int]
        lib.gs_cuda_error_string.restype = ctypes.c_char_p
        _libs[source] = lib
    fn = getattr(lib, name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    _entries[(source, name)] = fn
    return fn


def check(source: str, err: int, what: str):
    if err != 0:
        msg = _libs[source].gs_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def stream_ptr(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
