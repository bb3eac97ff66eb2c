"""gs_tpu_torch — the PyTorch/CUDA port of gs_tpu for NVIDIA Hopper.

The layout mirrors ``gs_tpu`` module for module (``core/``, ``ops/``,
``data/``, ``apps/``, ``render.py``, ``config.py``), so each part has a named
counterpart that the tests hold it against. Plain tensor math is PyTorch;
every Pallas TPU kernel on the ported path is a CUDA C++ kernel under
``csrc/``, built with ``nvcc`` for ``sm_90a`` at first use into ``_build/``
and loaded through ``ctypes`` (``ops/_cuda.py``).

Entry points run on ``device="cuda"`` unless the caller passes
``device="cpu"``. A kernel wrapper given CPU tensors runs its plain PyTorch
version; given CUDA tensors it launches the kernel or raises.

Ported so far: the serving path (load a PLY, preprocess, bin, expand, raster
forward, image). Training (the backward kernels) is not ported yet.
"""
