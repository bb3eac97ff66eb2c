"""Adam's pass over the packed block: the kernel of ``csrc/adam.cu``.

``adam_packed(packed, m, v, grad, lr, bc1, bc2, visible_mask, inplace)``
takes one Adam step of a channel-major ``[R, C]`` block with its
moments, in one pass that reads the block, ``m``, ``v`` and the gradient
and writes the block, ``m`` and ``v``. It replaces no TPU kernel: the JAX
package's update is jnp, which XLA fuses. Its twin, the same arithmetic as
PyTorch elementwise passes, is ``models/packed_state.py::
adam_update_packed_plain``, which runs on the CPU; the tests hold the
kernel to it bit for bit. ``adam_update_packed`` chooses between the two by
the block's device. Each call counts one launch in ``adam_packed.launches``.
"""
from __future__ import annotations

import ctypes

import torch

from . import _cuda

SOURCE = "adam.cu"
_PTR, _INT, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _rows(t: torch.Tensor, name: str, rows: int, n: int, dev):
    if (t.dtype != torch.float32 or t.device != dev
            or tuple(t.shape) != (rows, n) or (n > 1 and t.stride(1) != 1)):
        raise ValueError(f"{name} must be float32 [{rows}, {n}] on {dev} "
                         f"with contiguous rows, got {t.dtype} "
                         f"{tuple(t.shape)} strides {t.stride()} on "
                         f"{t.device}")
    return [t.data_ptr(), t.stride(0)]


def adam_packed(packed, m, v, grad, lr, bc1, bc2, visible_mask=None,
                inplace: bool = False) -> tuple:
    """The kernel: one Adam step of the block ``packed`` [R, C] with its
    moments ``m`` and ``v`` (each may be a column slice of a wider block),
    from ``grad`` [R, C], the row rates ``lr`` [R, 1] and the 0-d bias
    corrections ``bc1`` and ``bc2``; ``visible_mask`` [C] bool on the
    device or None. Returns (packed, m, v): the inputs, written, when
    ``inplace``; else new tensors, an unmasked column giving the old
    values."""
    dev = packed.device
    if dev.type != "cuda":
        raise ValueError(f"the Adam kernel runs on cuda, not {dev}")
    rows, n = packed.shape if packed.dim() == 2 else (0, 0)
    if not 0 < rows < 2 ** 16 or n >= 2 ** 30:
        raise ValueError(f"the block must be [R, C] with 0 < R < 2^16 and "
                         f"C < 2^30, got {tuple(packed.shape)}")
    args = []
    for name, t in (("packed", packed), ("m", m), ("v", v), ("grad", grad)):
        args += _rows(t, name, rows, n, dev)
    if inplace:
        out = (packed, m, v)
    else:
        out = tuple(torch.empty((rows, n), dtype=torch.float32, device=dev)
                    for _ in range(3))
    for name, t in zip(("packed", "m", "v"), out):
        args += _rows(t, name, rows, n, dev)
    for name, t, numel in (("lr", lr, rows), ("bc1", bc1, 1), ("bc2", bc2, 1)):
        if (t.dtype != torch.float32 or t.numel() != numel or t.device != dev
                or not t.is_contiguous()):
            raise ValueError(f"{name} must be {numel} contiguous float32 on "
                             f"{dev}")
        args.append(t.data_ptr())
    if visible_mask is not None and (
            visible_mask.dtype != torch.bool or visible_mask.device != dev
            or tuple(visible_mask.shape) != (n,)
            or not visible_mask.is_contiguous()):
        raise ValueError(f"visible_mask must be a contiguous bool [{n}] on "
                         f"{dev}")
    args.append(None if visible_mask is None else visible_mask.data_ptr())
    if n == 0:
        return out
    fn = _cuda.function(SOURCE, "gs_adam_packed",
                        [_PTR, _LL] * 7 + [_PTR] * 4 + [_INT] * 3 + [_PTR])
    err = fn(*args, rows, n, dev.index, _cuda.stream_ptr(dev))
    _cuda.check(SOURCE, err, "adam_packed")
    adam_packed.launches += 1
    return out


adam_packed.launches = 0
