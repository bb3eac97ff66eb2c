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

Ported: the serving path (load a PLY, preprocess, bin, expand, raster
forward, image); the training step (``train/step.py``: the render's gradient
through the raster backward and the gradient fold, L1 + SSIM, densification
statistics, Adam); the training driver (``train/loop.py``: density control,
overflow replay, checkpoints, the dataset readers and ``Scene``) with the
``train``, ``render`` and ``metrics`` CLIs; the SIBR viewer (``viewer/``),
LPIPS and the offline tools; live capture (``io_live/``: the frame stream,
scene bootstrap, point-cloud tools, rosbag, GPS and fusion, with the
``train_live``, ``convert_stream``, ``gps_pub`` and ``ros_bridge`` CLIs);
and the native COLMAP parser (``native/``, host C++ built by ``g++``); and
training on several GPUs (``parallel/``: the Gaussians sharded over a
``torch.distributed`` group, the image's tile rows banded across it, the
kernels given each band's row map; ``--mesh`` and ``--multihost`` of the
train CLI); the packed [R, C] training layout (``core/packed.py``,
``models/packed_state.py``, the Trainer's default) and ``bf16_features``
(bf16 colour streaming through the tile sort).
"""
