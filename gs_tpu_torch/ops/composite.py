"""Shared alpha-compositing math — port of ``gs_tpu/ops/composite.py``.

Reference blend semantics (ref: SURVEY.md §2.3-N1 render stage): front to
back ``C += c * alpha * T; T *= (1 - alpha)`` with
``alpha = min(0.99, opacity * exp(power))``, skip when ``power > 0`` or
``alpha < 1/255``, and per-pixel termination *before* adding the
contribution that would push T below 1e-4 (the pre-update T is kept for the
background blend).

Because transmittance is non-increasing, the frozen T is recoverable
without sequential control flow:

  U_g        = T0 * prod_{h<=g} (1 - alpha_h)        (unfrozen running T)
  w_g        = alpha_g * U_{g-1} * [U_g >= 1e-4]     (contribution weight)
  T_final    = min{ U_g : U_g >= 1e-4 } (incl. U_{-1}=T0)

These functions are the plain versions every backend and kernel is held to.
"""
from __future__ import annotations

import torch

ALPHA_MAX = 0.99
ALPHA_MIN = 1.0 / 255.0
T_EPS = 1e-4


def splat_power(packets, px, py):
    """Per-(entry, pixel) Gaussian exponent.

    packets: [..., G, 10] rows (x, y, ca, cb, cc, opacity, r, g, b, invd)
    px, py: [..., P] pixel coordinates
    Returns power [..., G, P].
    """
    dx = packets[..., :, 0:1] - px[..., None, :]
    dy = packets[..., :, 1:2] - py[..., None, :]
    ca = packets[..., :, 2:3]
    cb = packets[..., :, 3:4]
    cc = packets[..., :, 4:5]
    return -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy


def alpha_from_power(packets, power):
    """Alpha [..., G, P] of :func:`splat_power`'s exponent: 0 where the
    entry is skipped (power > 0 or alpha < 1/255)."""
    op = packets[..., :, 5:6]
    alpha = torch.clamp_max(op * torch.exp(power), ALPHA_MAX)
    alpha = torch.where(power > 0.0, 0.0, alpha)
    alpha = torch.where(alpha < ALPHA_MIN, 0.0, alpha)
    return alpha


def splat_alpha(packets, px, py):
    """Per-(entry, pixel) alpha [..., G, P] (see :func:`splat_power`)."""
    return alpha_from_power(packets, splat_power(packets, px, py))


def transmittance(alpha, carry_U):
    """Running (unfrozen) transmittance through a depth-ordered chunk.

    alpha: [..., G, P]; carry_U: [..., P] entering the chunk.
    Returns (U_before, U) [..., G, P]: T before and after each entry.
    """
    lg = torch.log1p(-alpha)
    cum = torch.cumsum(lg, dim=-2)
    U = carry_U[..., None, :] * torch.exp(cum)
    U_before = carry_U[..., None, :] * torch.exp(cum - lg)
    return U_before, U


def composite_chunk(alpha, rgb, invd, carry_U, carry_Tmin):
    """Composite one depth-ordered chunk of entries into all pixels.

    alpha: [..., G, P] (already masked to 0 for skipped entries)
    rgb:   [..., G, 3]
    invd:  [..., G]
    carry_U:    [..., P] running (unfrozen) transmittance entering the chunk
    carry_Tmin: [..., P] running frozen-T tracker
    Returns (color [..., P, 3], invdepth [..., P], new_U, new_Tmin).
    """
    U_before, U = transmittance(alpha, carry_U)       # [..., G, P]
    live = U >= T_EPS
    w = alpha * U_before * live                       # [..., G, P]
    color = torch.einsum('...gp,...gc->...pc', w, rgb)
    invdepth = torch.einsum('...gp,...g->...p', w, invd)
    new_U = U[..., -1, :]
    new_Tmin = torch.minimum(
        carry_Tmin,
        torch.amin(torch.where(live, U, float("inf")), dim=-2))
    return color, invdepth, new_U, new_Tmin
