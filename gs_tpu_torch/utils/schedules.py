"""Learning-rate schedules — port of ``gs_tpu/utils/schedules.py``
(ref: utils/general_utils.py:29-62, Plenoxels-style).

The step is a Python number: the port's training step runs eagerly and
knows its iteration on the host, so the rate is a float computed there in
float32, as the JAX package computes it on the device.
"""
from __future__ import annotations

import numpy as np


def expon_lr(step, lr_init: float, lr_final: float,
             lr_delay_steps: int = 0, lr_delay_mult: float = 1.0,
             max_steps: int = 1000000) -> float:
    """Log-linear interpolation with optional sin-eased delay."""
    f32 = np.float32
    if lr_init == 0.0 and lr_final == 0.0:
        return 0.0
    step = f32(step)
    if lr_delay_steps > 0:
        delay_rate = f32(lr_delay_mult) + f32(1 - lr_delay_mult) * np.sin(
            f32(0.5 * np.pi) * np.clip(step / f32(lr_delay_steps), f32(0),
                                       f32(1)))
    else:
        delay_rate = f32(1.0)
    t = np.clip(step / f32(max_steps), f32(0), f32(1))
    log_lerp = np.exp(np.log(f32(lr_init)) * (f32(1) - t)
                      + np.log(f32(lr_final)) * t)
    lr = f32(delay_rate * log_lerp)
    return 0.0 if step < 0 else float(lr)
