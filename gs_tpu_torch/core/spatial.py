"""kNN initial-scale estimation — port of ``gs_tpu/core/spatial.py``.

``mean_sq_dist_to_3nn`` stands in for the simple-knn CUDA extension's
``distCUDA2`` (ref: scene/gaussian_model.py:140-141): mean squared distance
to the 3 nearest neighbors, clamped to 1e-7. Like the upstream kernel it is
approximate: sort by Morton code and scan a +/-window in code order. The
window and masking are the JAX package's, so both give the same values.
"""
from __future__ import annotations

import torch


def _morton3d(q: torch.Tensor) -> torch.Tensor:
    """Interleave 10-bit quantized coords -> 30-bit Morton code. q: [N,3] int32."""
    def split3(x):
        x = x & 0x3FF
        x = (x | (x << 16)) & 0x30000FF
        x = (x | (x << 8)) & 0x300F00F
        x = (x | (x << 4)) & 0x30C30C3
        x = (x | (x << 2)) & 0x9249249
        return x
    return split3(q[:, 0]) | (split3(q[:, 1]) << 1) | (split3(q[:, 2]) << 2)


def mean_sq_dist_to_3nn(points: torch.Tensor, window: int = 24) -> torch.Tensor:
    """[N,3] float32 -> [N] mean squared distance to 3 approximate nearest
    neighbors, on the points' device."""
    n = points.shape[0]
    lo = torch.amin(points, dim=0)
    hi = torch.amax(points, dim=0)
    scale = torch.clamp_min(hi - lo, 1e-9)
    q = ((points - lo) / scale * 1023.0).to(torch.int32)
    code = _morton3d(q)
    order = torch.argsort(code, stable=True)
    ps = points[order]                                   # [N,3] in Morton order

    idx = torch.arange(n, device=points.device)
    best = torch.full((n, 3), float("inf"), device=points.device)
    for shift in range(1, window + 1):
        for sgn in (1, -1):
            nb = torch.roll(ps, sgn * shift, dims=0)
            d2 = torch.sum((ps - nb) ** 2, dim=1)
            # roll wraps around — mask the wrapped ends
            ok = (idx >= shift) if sgn == 1 else (idx < n - shift)
            d2 = torch.where(ok, d2, float("inf"))
            worst = torch.argmax(best, dim=1)
            cur = best[idx, worst]
            best[idx, worst] = torch.where(d2 < cur, d2, cur)
    finite = torch.isfinite(best)
    mean3 = torch.sum(torch.where(finite, best, 0.0), dim=1) / torch.clamp_min(
        torch.sum(finite, dim=1), 1)
    out = torch.zeros(n, device=points.device)
    out[order] = mean3
    return torch.clamp_min(out, 1e-7)                    # ref: gaussian_model.py:140
