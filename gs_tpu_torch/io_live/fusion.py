"""Sensor-fusion helpers: timestamp pairing and heading-drift correction —
the port's copy of ``gs_tpu/io_live/fusion.py``.

Behavioral port of the reference's fusion node core
(ref: submodules/.../camera_info_real_env_optimized.py:92-234 — the node
pairs RTK-GPS positions, IMU orientations, and camera frames within a 50 ms
window, applies a -90 degree IMU yaw correction plus a linear drift
compensation, and publishes fused frames). The transport (serial GPS, ROS
topics) stays outside; these are the pure algorithms, fed by any source.
"""
from __future__ import annotations

from bisect import bisect_left
from typing import NamedTuple, Optional, Sequence

import numpy as np

PAIR_TOLERANCE_S = 0.050   # ref: camera_info_real_env_optimized.py:92-122


class Stamped(NamedTuple):
    stamp: float
    value: object


def nearest_within(stamps: Sequence[float], t: float,
                   tol: float = PAIR_TOLERANCE_S) -> Optional[int]:
    """Index of the stamp nearest to t if within tol, else None."""
    if not stamps:
        return None
    i = bisect_left(stamps, t)
    best, best_dt = None, tol
    for j in (i - 1, i):
        if 0 <= j < len(stamps):
            dt = abs(stamps[j] - t)
            if dt <= best_dt:
                best, best_dt = j, dt
    return best


def pair_streams(primary: Sequence[Stamped], *others: Sequence[Stamped],
                 tol: float = PAIR_TOLERANCE_S) -> list[tuple]:
    """For each primary sample, attach the nearest sample of every other
    stream within ``tol``; drop primaries that miss any stream
    (the node drops unpaired camera frames)."""
    other_stamps = [[s.stamp for s in stream] for stream in others]
    out = []
    for p in primary:
        row = [p.value]
        ok = True
        for stream, stamps in zip(others, other_stamps):
            j = nearest_within(stamps, p.stamp, tol)
            if j is None:
                ok = False
                break
            row.append(stream[j].value)
        if ok:
            out.append(tuple(row))
    return out


def yaw_quaternion(yaw: float) -> np.ndarray:
    """(w, x, y, z) rotation about +z."""
    return np.array([np.cos(yaw / 2), 0.0, 0.0, np.sin(yaw / 2)])


def quat_multiply(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    w1, x1, y1, z1 = a
    w2, x2, y2, z2 = b
    return np.array([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ])


def imu_yaw_correction(quat: np.ndarray, t: float, t0: float,
                       static_offset: float = -np.pi / 2,
                       drift_rate: float = 0.0) -> np.ndarray:
    """IMU orientation corrected by the mounting yaw offset (-90 deg in the
    reference rig) plus a linear drift term
    (ref: camera_info_real_env_optimized.py:197-234)."""
    yaw = static_offset + drift_rate * (t - t0)
    return quat_multiply(yaw_quaternion(yaw), np.asarray(quat, np.float64))
