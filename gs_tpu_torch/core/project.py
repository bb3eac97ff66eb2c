"""EWA projection (the rasterizer "preprocess" stage) — port of
``gs_tpu/core/project.py``, batched over N as flat float32 channels.

Behavioral spec (ref: gaussian_renderer/__init__.py:32-109):

* frustum cull at view z <= 0.2
* perspective division with +1e-7 guard
* EWA: cov2d = J W Sigma W^T J^T with the Jacobian's (x,y)/z clamped to
  1.3*tan(fov); +0.3 px low-pass on the diagonal
* antialiasing (Mip-Splatting) rescales opacity by
  sqrt(max(2.5e-5, det(cov)/det(cov+0.3 I)))
* conic = inverse of the dilated 2x2 covariance
* radius = ceil(3 * sqrt(max eigenvalue)), eigen-discriminant clamped at 0.1
* pixel coords: ((ndc + 1) * S - 1) / 2
* SH -> RGB for the active degree with clamp at max(c + 0.5, 0)

Over the packed block on a CUDA device (:func:`preprocess_packed` with no
``override_color`` and no ``cov3d_precomp``; a block of SH degree above 3
is refused there) one hand-written kernel pair runs it,
``csrc/preprocess.cu``: a forward that reads each alive slot's rows and
writes every ``Projected`` field, and a backward that recomputes from the
block and writes every row of the block's gradient; the camera, the SH
ramp's degree and the scaling modifier reach them as device tensors, so a
graph replays them with new values. A ``torch.autograd.Function`` holds
the two, and the
wrappers :func:`preprocess_fwd` and :func:`preprocess_bwd` count their
launches. The flat-channel PyTorch code below is the kernels' twin: it
runs on the CPU and with either override, and the tests hold the kernels
to it. The rules the pair keeps: FP32, the twin's operations in its order
and rounding in the forward (so every output is the twin's bit for bit on
the card), the twin's guards and clamps, and the twin's autograd gradient
in the backward. Two things the twin computes and the kernels do not: a
dead slot's float fields are zeros and carry no gradient (the twin
computes them from the slot's rows; no consumer reads them, since the
slot is invisible), and a column whose cotangents are all zero gets a zero
gradient without reading its rows.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from ..ops import _cuda
from .camera import Camera
from .gaussians import GaussianParams, unpack_symmetric
from .sh import eval_sh_channels

NEAR_CULL_Z = 0.2
LOWPASS = 0.3
AA_DET_CLAMP = 0.000025
# the camera's tensors, as the kernels take them
CAMERA_TENSORS = ("world_view", "full_proj", "camera_center", "tan_fovx",
                 "tan_fovy")


class Projected(NamedTuple):
    """Per-Gaussian screen-space quantities (all [N, ...])."""
    mean2d: torch.Tensor    # [N, 2] pixel coordinates
    conic: torch.Tensor     # [N, 3] inverse 2D covariance (a, b, c)
    depth: torch.Tensor     # [N] view-space z
    radius: torch.Tensor    # [N] int32, 0 => invisible
    rgb: torch.Tensor       # [N, 3]
    opacity: torch.Tensor   # [N] effective opacity (sigmoid, AA-scaled)
    visible: torch.Tensor   # [N] bool (radius > 0)
    radius_cull: Optional[torch.Tensor] = None  # [N, 2] int32 (rx, ry), each
    # <= radius: opacity-aware binning half-widths (beyond them alpha < 1/255
    # everywhere, so culling those tiles is exact). ``radius`` keeps the
    # reference's 3-sigma value for the densification semantics.


def project_points(camera: Camera, xyz: torch.Tensor):
    """Returns (p_view [N,3], pix [N,2]) for the camera's matrix chain."""
    hom = torch.cat([xyz, torch.ones_like(xyz[:, :1])], dim=1)   # [N,4]
    p_view = hom @ camera.world_view.T
    p_hom = hom @ camera.full_proj.T
    p_w = 1.0 / (p_hom[:, 3] + 1e-7)
    ndc = p_hom[:, :3] * p_w[:, None]
    pix_x = ((ndc[:, 0] + 1.0) * float(camera.width) - 1.0) * 0.5
    pix_y = ((ndc[:, 1] + 1.0) * float(camera.height) - 1.0) * 0.5
    return p_view[:, :3], torch.stack([pix_x, pix_y], dim=-1)


def _project_channels(camera: Camera, x, y, z):
    """View-space position and pixel coordinates as flat [N] channels."""
    V = camera.world_view
    P = camera.full_proj
    vx = V[0, 0] * x + V[0, 1] * y + V[0, 2] * z + V[0, 3]
    vy = V[1, 0] * x + V[1, 1] * y + V[1, 2] * z + V[1, 3]
    vz = V[2, 0] * x + V[2, 1] * y + V[2, 2] * z + V[2, 3]
    hx = P[0, 0] * x + P[0, 1] * y + P[0, 2] * z + P[0, 3]
    hy = P[1, 0] * x + P[1, 1] * y + P[1, 2] * z + P[1, 3]
    hw = P[3, 0] * x + P[3, 1] * y + P[3, 2] * z + P[3, 3]
    p_w = 1.0 / (hw + 1e-7)
    W = float(camera.width)
    H = float(camera.height)
    pix_x = ((hx * p_w + 1.0) * W - 1.0) * 0.5
    pix_y = ((hy * p_w + 1.0) * H - 1.0) * 0.5
    return vx, vy, vz, pix_x, pix_y


def _cov3d_channels(ls, scaling_modifier, q):
    """3D covariance as 6 flat channels (xx, xy, xz, yy, yz, zz) from
    log-scale channels ``ls`` (3-tuple) and quat channels ``q`` (4-tuple).
    Same math as build_scaling_rotation + L L^T (utils/general_utils.py)."""
    qn = torch.sqrt(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3])
    r = q[0] / qn
    qx = q[1] / qn
    qy = q[2] / qn
    qz = q[3] / qn
    r00 = 1 - 2 * (qy * qy + qz * qz)
    r01 = 2 * (qx * qy - r * qz)
    r02 = 2 * (qx * qz + r * qy)
    r10 = 2 * (qx * qy + r * qz)
    r11 = 1 - 2 * (qx * qx + qz * qz)
    r12 = 2 * (qy * qz - r * qx)
    r20 = 2 * (qx * qz - r * qy)
    r21 = 2 * (qy * qz + r * qx)
    r22 = 1 - 2 * (qx * qx + qy * qy)
    s0 = scaling_modifier * torch.exp(ls[0])
    s1 = scaling_modifier * torch.exp(ls[1])
    s2 = scaling_modifier * torch.exp(ls[2])
    a0, a1, a2 = s0 * s0, s1 * s1, s2 * s2   # Sigma = R diag(s^2) R^T
    xx = a0 * r00 * r00 + a1 * r01 * r01 + a2 * r02 * r02
    xy = a0 * r00 * r10 + a1 * r01 * r11 + a2 * r02 * r12
    xz = a0 * r00 * r20 + a1 * r01 * r21 + a2 * r02 * r22
    yy = a0 * r10 * r10 + a1 * r11 * r11 + a2 * r12 * r12
    yz = a0 * r10 * r20 + a1 * r11 * r21 + a2 * r12 * r22
    zz = a0 * r20 * r20 + a1 * r21 * r21 + a2 * r22 * r22
    return xx, xy, xz, yy, yz, zz


def _cov2d_channels(camera: Camera, vx, vy, vz, sig):
    """EWA projection as flat channels; ``sig`` = 6-tuple (xx..zz).
    cov2d = (J W) Sigma (J W)^T with the clamped Jacobian, +0.3 px low-pass."""
    limx = 1.3 * camera.tan_fovx
    limy = 1.3 * camera.tan_fovy
    # anything at or behind the near plane is frustum-culled, so clamping z
    # is exact for every visible gaussian and keeps culled slots NaN-free
    vz = torch.clamp_min(vz, NEAR_CULL_Z)
    txtz = vx / vz
    tytz = vy / vz
    tx = torch.minimum(torch.maximum(txtz, -limx), limx) * vz
    ty = torch.minimum(torch.maximum(tytz, -limy), limy) * vz
    fx = camera.focal_x
    fy = camera.focal_y
    inv_z = 1.0 / vz
    inv_z2 = inv_z * inv_z
    # J rows: [fx/z, 0, -fx*x/z^2], [0, fy/z, -fy*y/z^2]
    j00 = fx * inv_z
    j02 = -fx * tx * inv_z2
    j11 = fy * inv_z
    j12 = -fy * ty * inv_z2
    Wr = camera.world_view[:3, :3]
    u0 = j00 * Wr[0, 0] + j02 * Wr[2, 0]
    u1 = j00 * Wr[0, 1] + j02 * Wr[2, 1]
    u2 = j00 * Wr[0, 2] + j02 * Wr[2, 2]
    v0 = j11 * Wr[1, 0] + j12 * Wr[2, 0]
    v1 = j11 * Wr[1, 1] + j12 * Wr[2, 1]
    v2 = j11 * Wr[1, 2] + j12 * Wr[2, 2]
    xx, xy, xz, yy, yz, zz = sig
    su0 = xx * u0 + xy * u1 + xz * u2
    su1 = xy * u0 + yy * u1 + yz * u2
    su2 = xz * u0 + yz * u1 + zz * u2
    sv0 = xx * v0 + xy * v1 + xz * v2
    sv1 = xy * v0 + yy * v1 + yz * v2
    sv2 = xz * v0 + yz * v1 + zz * v2
    cxx = u0 * su0 + u1 * su1 + u2 * su2
    cxy = v0 * su0 + v1 * su1 + v2 * su2
    cyy = v0 * sv0 + v1 * sv1 + v2 * sv2
    det_orig = cxx * cyy - cxy * cxy
    cxx = cxx + LOWPASS
    cyy = cyy + LOWPASS
    det_dilated = cxx * cyy - cxy * cxy
    return cxx, cxy, cyy, det_orig, det_dilated


def compute_cov2d(camera: Camera, p_view: torch.Tensor,
                  cov3d_packed: torch.Tensor):
    """EWA projection of the 3D covariance to 2D, in matrix form.

    Returns (cov2d [N,3] = (xx, xy, yy) after low-pass, det_orig,
    det_dilated)."""
    tz = torch.clamp_min(p_view[:, 2], NEAR_CULL_Z)  # see _cov2d_channels
    limx = 1.3 * camera.tan_fovx
    limy = 1.3 * camera.tan_fovy
    tx = torch.minimum(torch.maximum(p_view[:, 0] / tz, -limx), limx) * tz
    ty = torch.minimum(torch.maximum(p_view[:, 1] / tz, -limy), limy) * tz
    fx = camera.focal_x
    fy = camera.focal_y
    inv_z = 1.0 / tz
    inv_z2 = inv_z * inv_z
    zeros = torch.zeros_like(tz)
    J = torch.stack([
        torch.stack([fx * inv_z, zeros, -fx * tx * inv_z2], dim=-1),
        torch.stack([zeros, fy * inv_z, -fy * ty * inv_z2], dim=-1),
    ], dim=-2)                                           # [N,2,3]
    JW = J @ camera.world_view[:3, :3]                   # [N,2,3]
    cov = JW @ unpack_symmetric(cov3d_packed) @ JW.transpose(-1, -2)
    cxx = cov[:, 0, 0]
    cxy = cov[:, 0, 1]
    cyy = cov[:, 1, 1]
    det_orig = cxx * cyy - cxy * cxy
    cxx = cxx + LOWPASS
    cyy = cyy + LOWPASS
    det_dilated = cxx * cyy - cxy * cxy
    return torch.stack([cxx, cxy, cyy], dim=-1), det_orig, det_dilated


def preprocess(params: GaussianParams, camera: Camera, *,
               active_sh_degree: int,
               scaling_modifier: float = 1.0,
               antialiasing: bool = False,
               alive: Optional[torch.Tensor] = None,
               override_color: Optional[torch.Tensor] = None,
               cov3d_precomp: Optional[torch.Tensor] = None) -> Projected:
    """Full per-Gaussian preprocess: cull, project, EWA, SH shading.

    Dead (padding) slots are forced invisible via ``alive``.
    """
    x, y, z = params.xyz[:, 0], params.xyz[:, 1], params.xyz[:, 2]
    ls = tuple(params.log_scale[:, i] for i in range(3))
    quat = tuple(params.quat[:, i] for i in range(4))
    lop = params.logit_opacity[:, 0]
    coeffs = None
    if override_color is None:
        coeffs = ([params.sh_dc[:, 0, c] for c in range(3)] +
                  [params.sh_rest[:, k, c]
                   for k in range(params.sh_rest.shape[1])
                   for c in range(3)])
    return _preprocess_from_channels(
        camera, x, y, z, ls, quat, lop, coeffs,
        active_sh_degree=active_sh_degree,
        scaling_modifier=scaling_modifier, antialiasing=antialiasing,
        alive=alive, override_color=override_color,
        cov3d_precomp=cov3d_precomp)


def preprocess_packed(packed: torch.Tensor, camera: Camera, *,
                      sh_degree: int, active_sh_degree: int,
                      scaling_modifier=1.0,
                      antialiasing: bool = False,
                      alive: Optional[torch.Tensor] = None,
                      override_color: Optional[torch.Tensor] = None,
                      cov3d_precomp: Optional[torch.Tensor] = None,
                      mask_degree=None) -> Projected:
    """:func:`preprocess` over the channel-major packed block [R, C]
    (``core/packed.py``), the training layout; ``packed`` may be a column
    slice of a wider block. ``mask_degree`` (an int or a 0-d integer
    tensor; None: no mask) applies the SH ramp: the coefficients above that
    degree read as zero and get a zero gradient, as ``mask_sh_rows``
    followed by the unmasked call gives. ``scaling_modifier`` may be a 0-d
    tensor.

    On a CUDA device with no override (:func:`uses_kernel`) it is the
    kernel pair of ``csrc/preprocess.cu``; otherwise the twin,
    :func:`preprocess_packed_plain`."""
    if uses_kernel(packed.device, sh_degree, override_color, cov3d_precomp):
        return _preprocess_kernel(packed, camera, sh_degree, active_sh_degree,
                                  scaling_modifier, antialiasing, alive,
                                  mask_degree)
    return preprocess_packed_plain(
        packed, camera, sh_degree=sh_degree,
        active_sh_degree=active_sh_degree, scaling_modifier=scaling_modifier,
        antialiasing=antialiasing, alive=alive, override_color=override_color,
        cov3d_precomp=cov3d_precomp, mask_degree=mask_degree)


def uses_kernel(device: torch.device, sh_degree: int, override_color=None,
                cov3d_precomp=None) -> bool:
    """Whether :func:`preprocess_packed` runs the kernel pair: on a CUDA
    device with neither override. A block of an SH degree above the
    kernels' on a CUDA device with no override is an error: the twin
    would run there unseen."""
    if (torch.device(device).type != "cuda" or override_color is not None
            or cov3d_precomp is not None):
        return False
    if sh_degree > KERNEL_MAX_SH_DEGREE:
        raise ValueError(
            f"the preprocess kernels take SH degrees up to "
            f"{KERNEL_MAX_SH_DEGREE}, not {sh_degree}, on a CUDA device")
    return True


def preprocess_packed_plain(packed: torch.Tensor, camera: Camera, *,
                            sh_degree: int, active_sh_degree: int,
                            scaling_modifier=1.0,
                            antialiasing: bool = False,
                            alive: Optional[torch.Tensor] = None,
                            override_color: Optional[torch.Tensor] = None,
                            cov3d_precomp: Optional[torch.Tensor] = None,
                            mask_degree=None) -> Projected:
    """The kernel pair's twin: ``mask_sh_rows`` (with ``mask_degree``),
    then one differentiable read of every channel row feeding the same
    channel math as :func:`preprocess`, so the block's gradient is one
    [R, C] stack, not a zero-filled tensor and an add per row."""
    from .packed import all_channels, layout, mask_sh_rows
    if mask_degree is not None:
        packed = mask_sh_rows(packed, layout(sh_degree), mask_degree)
    ch = all_channels(packed, sh_degree)
    coeffs = None
    if override_color is None:
        coeffs = list(ch["sh_dc"]) + list(ch["sh_rest"])
    return _preprocess_from_channels(
        camera, ch["x"], ch["y"], ch["z"], ch["ls"], ch["quat"], ch["lop"],
        coeffs, active_sh_degree=active_sh_degree,
        scaling_modifier=scaling_modifier, antialiasing=antialiasing,
        alive=alive, override_color=override_color,
        cov3d_precomp=cov3d_precomp)


# ------------------------------------------------------------ the kernels

KERNEL_SOURCE = "preprocess.cu"
KERNEL_MAX_SH_DEGREE = 3
_PTR, _INT, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# the arguments the two entries share: the block, its stride and width, the
# layout's and the evaluated SH degree, antialiasing, alive, the camera's
# five tensors and its size, the mask degree, the scaling modifier
_COMMON_ARGS = [_PTR, _LL, _INT, _INT, _INT, _INT, _PTR, _PTR, _PTR, _PTR,
                _PTR, _PTR, _INT, _INT, _PTR, _PTR]


class _Static(NamedTuple):
    """What a launch takes as plain values: fixed per capture."""
    sh_degree: int
    active_sh_degree: int
    antialiasing: bool
    width: int
    height: int


def _check_inputs(packed, cam_tensors, alive, mask, scale, st: _Static):
    from .packed import layout
    dev = packed.device
    if dev.type != "cuda":
        raise ValueError(f"the preprocess kernels run on cuda, not {dev}")
    rows = layout(st.sh_degree).rows
    if (packed.dtype != torch.float32 or packed.dim() != 2
            or packed.shape[0] != rows or packed.stride(1) != 1):
        raise ValueError(f"the block must be float32 [{rows}, C] with "
                         f"contiguous rows, got {packed.dtype} "
                         f"{tuple(packed.shape)} strides {packed.stride()}")
    n = packed.shape[1]
    if 3 * n >= 2 ** 31:
        raise ValueError(f"{n} slots are out of the kernels' int32 range")
    if not 0 <= st.active_sh_degree <= st.sh_degree <= KERNEL_MAX_SH_DEGREE:
        raise ValueError(f"SH degrees {st.active_sh_degree} <= "
                         f"{st.sh_degree} <= {KERNEL_MAX_SH_DEGREE} expected")
    for name, t, numel in zip(CAMERA_TENSORS, cam_tensors, (16, 16, 3, 1, 1)):
        if (t.dtype != torch.float32 or t.numel() != numel
                or t.device != dev or not t.is_contiguous()):
            raise ValueError(f"camera {name} must be {numel} contiguous "
                             f"float32 on {dev}")
    if alive is not None and (alive.dtype != torch.bool
                              or tuple(alive.shape) != (n,)
                              or alive.device != dev
                              or not alive.is_contiguous()):
        raise ValueError(f"alive must be a contiguous bool [{n}] on {dev}")
    for name, t, dtype in (("mask_degree", mask, torch.int64),
                           ("scaling_modifier", scale, torch.float32)):
        if (not isinstance(t, torch.Tensor) or t.dtype != dtype
                or t.numel() != 1 or t.device != dev):
            raise ValueError(f"{name} must be a 0-d {dtype} on {dev}")


def _common_args(packed, cam_tensors, alive, mask, scale, st: _Static):
    return [packed.data_ptr(), packed.stride(0), packed.shape[1],
            st.sh_degree, st.active_sh_degree, int(st.antialiasing),
            _ptr(alive), *[t.data_ptr() for t in cam_tensors], st.width,
            st.height, mask.data_ptr(), scale.data_ptr()]


def _ptr(t):
    return None if t is None else t.data_ptr()


def _device_scalar(x, dtype, device) -> torch.Tensor:
    """``x`` (a number or a tensor of one element) as a 0-d ``dtype`` tensor
    on ``device``; a number is filled there, which a graph captures."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype).reshape(())
    return torch.full((), x, dtype=dtype, device=device)


def preprocess_fwd(packed, cam_tensors, alive, mask, scale,
                   st: _Static) -> tuple:
    """The forward kernel: the ``Projected`` fields of the block's columns
    (mean2d, conic, depth, radius, rgb, opacity, visible, radius_cull), as
    a tuple. ``cam_tensors``: the camera's ``CAMERA_TENSORS``; ``mask``
    and ``scale``: the SH ramp's degree (int64) and the scaling modifier
    (float32), 0-d tensors on the block's device."""
    _check_inputs(packed, cam_tensors, alive, mask, scale, st)
    n, dev = packed.shape[1], packed.device

    def empty(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=dev)

    out = (empty(n, 2), empty(n, 3), empty(n), empty(n, dtype=torch.int32),
           empty(n, 3), empty(n), empty(n, dtype=torch.bool),
           empty(n, 2, dtype=torch.int32))
    if n == 0:
        return out
    fn = _cuda.function(KERNEL_SOURCE, "gs_preprocess_fwd",
                        _COMMON_ARGS + [_PTR] * 8 + [_INT, _PTR])
    err = fn(*_common_args(packed, cam_tensors, alive, mask, scale, st),
             *[t.data_ptr() for t in out], dev.index, _cuda.stream_ptr(dev))
    _cuda.check(KERNEL_SOURCE, err, "preprocess_fwd")
    preprocess_fwd.launches += 1
    return out


preprocess_fwd.launches = 0


def preprocess_bwd(packed, cam_tensors, alive, mask, scale, st: _Static,
                   cotangents) -> torch.Tensor:
    """The backward kernel: the [R, n] gradient of the block's columns
    from the cotangents of (mean2d, conic, depth, rgb, opacity), each None
    for zero; every row written, the padding and the masked rows 0."""
    _check_inputs(packed, cam_tensors, alive, mask, scale, st)
    n, dev = packed.shape[1], packed.device
    grad = torch.empty((packed.shape[0], n), dtype=torch.float32, device=dev)
    if n == 0:
        return grad
    args = []
    for name, g, width in zip(("mean2d", "conic", "depth", "rgb", "opacity"),
                              cotangents, (2, 3, 0, 3, 0)):
        if g is None:
            args += [None, 0]
            continue
        shape = (n, width) if width else (n,)
        if (tuple(g.shape) != shape or g.dtype != torch.float32
                or g.device != dev):
            raise ValueError(f"the {name} cotangent must be float32 "
                             f"{list(shape)} on {dev}")
        if width and g.stride(1) != 1:
            g = g.contiguous()
        args += [g.data_ptr(), g.stride(0)]
    fn = _cuda.function(KERNEL_SOURCE, "gs_preprocess_bwd",
                        _COMMON_ARGS + [_PTR, _LL] * 5 + [_PTR, _INT, _INT,
                                                          _PTR])
    err = fn(*_common_args(packed, cam_tensors, alive, mask, scale, st),
             *args, grad.data_ptr(), grad.shape[0], dev.index,
             _cuda.stream_ptr(dev))
    _cuda.check(KERNEL_SOURCE, err, "preprocess_bwd")
    preprocess_bwd.launches += 1
    return grad


preprocess_bwd.launches = 0


class _PreprocessKernel(torch.autograd.Function):
    """The kernel pair as one differentiable function of the block: the
    forward saves only its inputs, the backward recomputes from them."""

    @staticmethod
    def forward(ctx, packed, world_view, full_proj, camera_center, tan_fovx,
                tan_fovy, alive, mask, scale, st):
        cam = (world_view, full_proj, camera_center, tan_fovx, tan_fovy)
        out = preprocess_fwd(packed, cam, alive, mask, scale, st)
        ctx.save_for_backward(packed, *cam, alive, mask, scale)
        ctx.st = st
        ctx.mark_non_differentiable(out[3], out[6], out[7])
        ctx.set_materialize_grads(False)
        return out

    @staticmethod
    def backward(ctx, g_mean2d, g_conic, g_depth, _radius, g_rgb, g_opacity,
                 _visible, _radius_cull):
        packed, *cam, alive, mask, scale = ctx.saved_tensors
        grad = preprocess_bwd(packed, cam, alive, mask, scale, ctx.st,
                              (g_mean2d, g_conic, g_depth, g_rgb, g_opacity))
        return (grad,) + (None,) * 9


def _preprocess_kernel(packed, camera: Camera, sh_degree, active_sh_degree,
                       scaling_modifier, antialiasing, alive, mask_degree
                       ) -> Projected:
    mask = _device_scalar(sh_degree if mask_degree is None else mask_degree,
                          torch.int64, packed.device)
    scale = _device_scalar(scaling_modifier, torch.float32, packed.device)
    st = _Static(int(sh_degree), int(active_sh_degree), bool(antialiasing),
                 camera.width, camera.height)
    cam = [getattr(camera, k).contiguous() for k in CAMERA_TENSORS]
    out = _PreprocessKernel.apply(packed, *cam, alive, mask, scale, st)
    return Projected(mean2d=out[0], conic=out[1], depth=out[2],
                     radius=out[3], rgb=out[4], opacity=out[5],
                     visible=out[6], radius_cull=out[7])


def _preprocess_from_channels(camera: Camera, x, y, z, ls, quat, lop,
                              coeffs, *, active_sh_degree: int,
                              scaling_modifier, antialiasing: bool,
                              alive, override_color,
                              cov3d_precomp) -> Projected:
    """Shared flat-channel preprocess core. ``coeffs`` is the SH coefficient
    channel list ordered (band, color) with band 0 = DC; may be None when
    ``override_color`` is given."""
    vx, vy, vz, pix_x, pix_y = _project_channels(camera, x, y, z)
    depth = vz
    in_front = depth > NEAR_CULL_Z

    if cov3d_precomp is None:
        sig = _cov3d_channels(ls, scaling_modifier, quat)
    else:
        sig = tuple(cov3d_precomp[:, i] for i in range(6))
    cxx, cxy, cyy, det_orig, det = _cov2d_channels(camera, vx, vy, vz, sig)

    det_ok = det != 0.0
    inv_det = torch.where(det_ok, 1.0 / torch.where(det_ok, det, 1.0), 0.0)
    pix = torch.stack([pix_x, pix_y], dim=-1)
    conic = torch.stack([cyy * inv_det,
                         -cxy * inv_det,
                         cxx * inv_det], dim=-1)

    mid = 0.5 * (cxx + cyy)
    disc = torch.sqrt(torch.clamp_min(mid * mid - det, 0.1))
    lambda1 = mid + disc
    lambda2 = mid - disc
    radius_f = torch.ceil(3.0 * torch.sqrt(torch.maximum(lambda1, lambda2)))

    opacity = torch.sigmoid(lop)
    if antialiasing:
        h_scale = torch.sqrt(torch.clamp_min(det_orig / det, AA_DET_CLAMP))
        opacity = opacity * h_scale

    visible = in_front & det_ok
    if alive is not None:
        visible = visible & alive
    radius = torch.where(visible, radius_f, 0.0).to(torch.int32)
    visible = radius > 0

    # opacity-aware per-axis cull radii: alpha >= 1/255 only inside the
    # ellipse d^T Sigma^-1 d <= 2 ln(255 op), whose bounding box has
    # half-widths sqrt(2 ln(255 op) * Sigma_xx|yy); +1 px guards the
    # tile_rect max-side convention and f32 rounding at tangency
    log_term = torch.log(torch.clamp_min(255.0 * opacity, 1e-12))
    two_l = 2.0 * torch.clamp_min(log_term, 0.0)
    rcx = torch.ceil(torch.sqrt(two_l * torch.clamp_min(cxx, 0.0))) + 1.0
    rcy = torch.ceil(torch.sqrt(two_l * torch.clamp_min(cyy, 0.0))) + 1.0
    keep = visible & (log_term > 0.0)
    radius_cull = torch.stack([
        torch.where(keep, torch.minimum(rcx, radius_f), 0.0),
        torch.where(keep, torch.minimum(rcy, radius_f), 0.0)], dim=-1
    ).to(torch.int32)

    if override_color is not None:
        rgb = override_color
    else:
        cc = camera.camera_center
        dx, dy, dz = x - cc[0], y - cc[1], z - cc[2]
        # padding slots can sit exactly at the camera center; the guard
        # keeps their direction finite and is inert for real gaussians
        inv_n = 1.0 / torch.sqrt(torch.clamp_min(dx * dx + dy * dy + dz * dz,
                                                 1e-18))
        dx, dy, dz = dx * inv_n, dy * inv_n, dz * inv_n
        rgb = torch.stack([
            eval_sh_channels(active_sh_degree, coeffs[c::3], dx, dy, dz)
            for c in range(3)], dim=-1)
        rgb = torch.clamp_min(rgb + 0.5, 0.0)

    return Projected(
        mean2d=pix,
        conic=conic,
        depth=depth,
        radius=radius,
        rgb=rgb,
        opacity=opacity,
        visible=visible,
        radius_cull=radius_cull,
    )


def mark_visible(camera: Camera, xyz: torch.Tensor) -> torch.Tensor:
    """Frustum-visibility mask without a render: the rasterizer's
    ``markVisible``, whose in-frustum test is view-space z > 0.2, the
    preprocess's ``NEAR_CULL_Z``."""
    p_view, _ = project_points(camera, xyz)
    return p_view[:, 2] > NEAR_CULL_Z


def tile_rect(mean2d: torch.Tensor, radius: torch.Tensor,
              grid_x: int, grid_y: int, tile_x: int, tile_y: int,
              radius_y: Optional[torch.Tensor] = None):
    """Tile-span rectangle per Gaussian, clamped to the tile grid.

    Matches the CUDA getRect math; returns (rx0, ry0, rx1, ry1) int32
    half-open ranges. ``radius_y`` (defaults to ``radius``) allows an
    anisotropic span for the opacity-aware cull bbox.
    """
    rx = radius.to(torch.float32)
    ry = rx if radius_y is None else radius_y.to(torch.float32)

    def span(v, n):
        # clamp before the cast: XLA's float->int32 saturates, torch's
        # cast of an out-of-range float is undefined
        return torch.clamp(torch.floor(v), 0, n).to(torch.int32)

    rx0 = span((mean2d[:, 0] - rx) / tile_x, grid_x)
    ry0 = span((mean2d[:, 1] - ry) / tile_y, grid_y)
    rx1 = span((mean2d[:, 0] + rx + tile_x - 1) / tile_x, grid_x)
    ry1 = span((mean2d[:, 1] + ry + tile_y - 1) / tile_y, grid_y)
    return rx0, ry0, rx1, ry1
