"""Plain PyTorch reference of the 3DGS release's 2024 training recipe
(graphdeco-inria/gaussian-splatting, October 2024: ``train.py``,
``gaussian_renderer/__init__.py``, ``scene/gaussian_model.py`` and the
README's "Depth regularization", "Exposure compensation", "Anti-aliasing"
and "Faster training") with its four switches on. It extends ``render.py``
and ``train.py`` by import and imports nothing of the program under test.

* Antialiasing (Mip-Splatting's EWA filter): each Gaussian's opacity times
  ``sqrt(max(det(cov) / det(cov + 0.3 I), 0.000025))``, the covariance
  before and after the low-pass, before the binning (whose per-tile cut
  reads the opacity).
* The inverse depth ``sum(w_i / z_i)`` composited beside the colour, with
  the same weights, z the Gaussian's view-space depth; no background term.
* Exposure: the rendered image through its view's 3x4 affine,
  ``image[c] -> sum_k image[k] E[k, c] + E[c, 3]`` (the release's
  ``matmul(image.permute(1, 2, 0), E[:3, :3]) + E[:3, 3]``), before L1 and
  SSIM.
* The depth term ``w(it) * mean(|invdepth - prior| * mask) * depth_ok``, w
  log-linear from ``depth_l1_weight_init`` to ``_final`` over the run.
* Sparse Adam: each step updates only the Gaussians whose radius is above 0
  in that step's projection; the others keep their parameters and both
  moments.
* The exposures' own Adam (eps 1e-8, its own step count) on the delayed
  log-linear rate (``get_expon_lr_func`` with ``lr_delay_steps`` and
  ``lr_delay_mult``), over the whole [V, 3, 4] tensor every step.

Departures from the release:

* The release clamps the exposed image to [0, 1] before the loss; the
  program under test (as the JAX package it ports) does not, and this
  reference follows the program: with the clamp every pixel the exposure
  takes past 1 would read as a fault.
* The release's sparse Adam (``SparseGaussianAdam``) applies no bias
  correction; the Gaussians' Adam here applies none either, and the
  program does. From iteration 20,000 the correction is 1 - 2e-9 or
  nearer, below float32's resolution.
* Adam's step count is one per iteration for every group, the exposures'
  too: it starts at ``first_iteration - 1`` (the release's exposure
  optimizer counts its own steps, the same number when it has stepped
  every iteration).
"""
from __future__ import annotations

import math

import torch

from . import render as R
from . import train as RT

AA_DET_MIN = 0.000025
EXPOSURE_EPS = 1e-8
GROUPS = ("xyz", "sh_dc", "sh_rest", "log_scale", "quat", "logit",
          "exposure")


def expon_lr_delay(step: int, lr_init: float, lr_final: float,
                   max_steps: int, delay_steps: int = 0,
                   delay_mult: float = 1.0) -> float:
    """The release's ``get_expon_lr_func``: log-linear from ``lr_init`` to
    ``lr_final`` over ``max_steps``, times a delay ramp that rises from
    ``delay_mult`` to 1 as a quarter sine over ``delay_steps``."""
    if step < 0 or (lr_init == 0.0 and lr_final == 0.0):
        return 0.0
    if delay_steps > 0:
        delay = delay_mult + (1 - delay_mult) * math.sin(
            0.5 * math.pi * min(max(step / delay_steps, 0.0), 1.0))
    else:
        delay = 1.0
    return delay * RT.expon_lr(step, lr_init, lr_final, max_steps)


def project(params: dict, cam: R.Camera, antialiasing: bool = True):
    """``render.project`` with the antialiasing opacity scale."""
    proj = R.project(params, cam)
    if not antialiasing:
        return proj
    cxx, cxy, cyy = proj.cov.unbind(-1)
    det = cxx * cyy - cxy * cxy
    det0 = (cxx - R.LOWPASS) * (cyy - R.LOWPASS) - cxy * cxy
    scale = torch.sqrt(torch.clamp_min(det0 / det, AA_DET_MIN))
    return proj._replace(opacity=proj.opacity * scale)


def packets(proj) -> torch.Tensor:
    """[N, 10]: x, y, conic a/b/c, opacity, r, g, b, 1 / z."""
    z = proj.depth
    invd = 1.0 / torch.where(z > 0, z, torch.ones_like(z))
    return torch.cat([proj.mean2d, proj.conic, proj.opacity[:, None],
                      proj.rgb, invd[:, None]], dim=1)


def _composite_block(packets, bins, tiles, starts, lens, longest: int):
    """``render._composite_block`` with a fourth channel: colour and
    inverse depth [Tb, 256, 4] and final T [Tb, 256]."""
    dtype = packets.dtype
    px, py = R._tile_pixels(tiles, bins.gx, dtype)
    tb = tiles.shape[0]
    T = torch.ones((tb, R.TILE * R.TILE), dtype=dtype, device=packets.device)
    out = torch.zeros((tb, R.TILE * R.TILE, 4), dtype=dtype,
                      device=packets.device)
    lane = torch.arange(R.CHUNK, device=packets.device)
    done = torch.zeros_like(T, dtype=torch.bool)
    for k0 in range(0, longest, R.CHUNK):
        idx = k0 + lane
        valid = idx[None, :] < lens[:, None]
        pos = torch.where(valid, starts[:, None] + idx, 0)
        g = torch.where(valid, bins.gid[pos], 0)
        pk = packets[g]
        dx = pk[..., 0:1] - px[:, None, :]
        dy = pk[..., 1:2] - py[:, None, :]
        power = (-0.5 * (pk[..., 2:3] * dx * dx + pk[..., 4:5] * dy * dy)
                 - pk[..., 3:4] * dx * dy)
        alpha = torch.clamp_max(
            pk[..., 5:6] * torch.exp(torch.clamp_max(power, 0.0)),
            R.ALPHA_MAX)
        skip = (power > 0) | (alpha < R.ALPHA_MIN) | ~valid[..., None]
        alpha = torch.where(skip, torch.zeros_like(alpha), alpha)
        lg = torch.log1p(-alpha)
        cum = torch.cumsum(lg, dim=1)
        t_after = T[:, None, :] * torch.exp(cum)
        t_before = T[:, None, :] * torch.exp(cum - lg)
        live = (t_after >= R.T_EPS) & ~done[:, None, :]
        w = torch.where(live, alpha * t_before, torch.zeros_like(alpha))
        out = out + torch.einsum("tkp,tkc->tpc", w, pk[..., 6:10])
        T = T * torch.exp(torch.where(live, lg, torch.zeros_like(lg)).sum(1))
        done = done | (~live & ~skip).any(1)
        if bool(done.all()):
            break
    return out, T


def _frame(proj, bins, width: int, height: int, bg: torch.Tensor):
    """The image [3, H, W] and inverse depth [H, W] (no autograd)."""
    with torch.no_grad():
        pk = packets(proj).detach()
        n_t = bins.gx * bins.gy
        out = torch.zeros((n_t, R.TILE * R.TILE, 4), dtype=pk.dtype,
                          device=pk.device)
        T = torch.ones((n_t, R.TILE * R.TILE), dtype=pk.dtype,
                       device=pk.device)
        for tiles, starts, lens, longest in R._blocks(bins):
            o, t = _composite_block(pk, bins, tiles, starts, lens, longest)
            out[tiles] = o
            T[tiles] = t
        rgb = out[..., :3] + T[..., None] * bg.to(pk.dtype)
        full = torch.cat([rgb, out[..., 3:]], -1)
        frame = R._untile(full, bins, width, height)
    return frame[:3], frame[3]


def render(params: dict, cam: R.Camera, bg: torch.Tensor,
           antialiasing: bool = True):
    """(image [3, H, W], inverse depth [H, W]) of ``params`` from ``cam``
    (no autograd)."""
    with torch.no_grad(), R.fp32():
        proj = project(params, cam, antialiasing)
        bins = R.bin_tiles(proj, cam.width, cam.height)
        return _frame(proj, bins, cam.width, cam.height, bg)


def render_backward(params: dict, cam: R.Camera, bg: torch.Tensor,
                    loss_fn, antialiasing: bool = True, depth_of=None):
    """``render.render_backward`` of the image and the inverse depth:
    ``loss_fn(image, invdepth)``, its gradient left in each ``params``
    leaf's ``.grad`` (and in any leaf ``loss_fn`` closes over). Returns
    (loss, radius [N], depth), the first two detached; ``depth`` is None,
    or, given ``depth_of`` (a dict of leaves), the part of their gradient
    that comes through the inverse depth alone (the colour's cotangent
    zeroed), by name."""
    proj = project(params, cam, antialiasing)
    bins = R.bin_tiles(proj, cam.width, cam.height)
    image, invd = _frame(proj, bins, cam.width, cam.height, bg)
    img = image.detach().requires_grad_(True)
    dep = invd.detach().requires_grad_(True)
    loss = loss_fn(img, dep)
    # into the image, the inverse depth and the leaves loss_fn closes over
    loss.backward()
    d_img = img.grad
    d_dep = dep.grad if dep.grad is not None else torch.zeros_like(dep)
    gx, gy = bins.gx, bins.gy
    pad = torch.zeros((4, gy * R.TILE, gx * R.TILE), dtype=d_img.dtype,
                      device=d_img.device)
    pad[:3, :cam.height, :cam.width] = d_img
    pad[3, :cam.height, :cam.width] = d_dep
    d_tiles = pad.reshape(4, gy, R.TILE, gx, R.TILE).permute(1, 3, 2, 4, 0) \
        .reshape(gx * gy, R.TILE * R.TILE, 4)
    pk = packets(proj)
    leaf = pk.detach().requires_grad_(True)
    bg4 = torch.cat([bg.to(leaf.dtype), bg.new_zeros(1).to(leaf.dtype)])

    def packets_grad(d):
        leaf.grad = None
        for tiles, starts, lens, longest in R._blocks(bins, R.GRAD_PAIRS):
            o, t = _composite_block(leaf, bins, tiles, starts, lens, longest)
            # the background adds to the colour, not to the inverse depth
            torch.autograd.backward(o + t[..., None] * bg4, d[tiles])
        return leaf.grad if leaf.grad is not None else torch.zeros_like(leaf)

    depth = None
    if depth_of is not None:
        only = torch.zeros_like(d_tiles)
        only[..., 3] = d_tiles[..., 3]
        names = list(depth_of)
        got = torch.autograd.grad(pk, [depth_of[k] for k in names],
                                  packets_grad(only), retain_graph=True,
                                  allow_unused=True)
        depth = {k: torch.zeros_like(depth_of[k]) if g is None else g
                 for k, g in zip(names, got)}
    torch.autograd.backward(pk, packets_grad(d_tiles))
    return loss.detach(), proj.radius.detach(), depth


def apply_exposure(image: torch.Tensor, exposure: torch.Tensor):
    """[3, H, W] through a [3, 4] affine, as the release's renderer."""
    return (torch.einsum("chw,ck->khw", image, exposure[:3, :3])
            + exposure[:3, 3, None, None])


def loss_fn(gt, exposure, prior, mask, depth_ok, lambda_dssim: float,
            depth_weight: float):
    """The release's loss of an exposed image and its inverse depth
    against a photo and a depth prior (``prior`` None: no depth term)."""
    def f(image, invdepth):
        image = apply_exposure(image, exposure)
        l1 = (image - gt).abs().mean()
        loss = (1.0 - lambda_dssim) * l1 + lambda_dssim * (
            1.0 - R.ssim(image, gt))
        if prior is not None and depth_ok:
            loss = loss + depth_weight * ((invdepth - prior).abs()
                                          * mask).mean()
        return loss
    return f


def train_steps(params: dict, exposure: torch.Tensor, images: list,
                cams: list, photos: list, priors: list, bg: torch.Tensor,
                opt: dict, first_iteration: int, spatial_lr_scale: float,
                v_rms: dict = None, dtype=torch.float32,
                antialiasing: bool = True, loss=loss_fn) -> dict:
    """The recipe's steps from ``params`` (generation-order leaves, as
    ``train.train_steps`` takes them) and the exposures ``exposure``
    [V, 3, 4]: iteration ``first_iteration + j`` trains on ``cams[j]``,
    the view of index ``images[j]``, against ``photos[j]`` and
    ``priors[j]`` ((inverse depth [H, W], mask [H, W], depth_ok) or None).
    Adam's first moments start at zero, its second at ``v_rms[group]**2``,
    its step count at ``first_iteration - 1``. Returns the losses, the
    first step's gradient norm per group and each group's change over the
    steps, its norm per group; the exposure's over the rows of
    ``images``. At the first step whose prior is reliable
    (``depth_step``, None where no step's is), also the Gaussians' first
    moments after its update (``depth_m``) and what the depth term added
    to them there (``depth_add``: (1 - beta1) times its own gradient, in
    the Gaussians that step updates), by group."""
    with R.fp32():
        return _train_steps(params, exposure, images, cams, photos, priors,
                            bg, opt, first_iteration, spatial_lr_scale,
                            v_rms or {}, dtype, antialiasing, loss)


def _train_steps(params, exposure, images, cams, photos, priors, bg, opt,
                 first_iteration, spatial_lr_scale, v_rms, dtype,
                 antialiasing, loss_of) -> dict:
    p = {k: v.detach().to(dtype).clone() for k, v in RT.split(params).items()}
    p["exposure"] = exposure.detach().to(dtype).clone()
    start = {k: v.clone() for k, v in p.items()}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.full_like(v, v_rms.get(k, 0.0) ** 2)
          for k, v in p.items()}
    rows = torch.as_tensor(images, device=p["exposure"].device)
    losses, first_grad = [], None
    depth_step, depth_m, depth_add = None, None, None
    for j, (k_img, cam, gt, prior) in enumerate(zip(images, cams, photos,
                                                    priors)):
        it = first_iteration + j
        leaves = {k: t.detach().requires_grad_(True) for k, t in p.items()}
        full = {"xyz": leaves["xyz"], "log_scale": leaves["log_scale"],
                "quat": leaves["quat"], "logit": leaves["logit"],
                "sh": torch.cat([leaves["sh_dc"], leaves["sh_rest"]], 1)}
        cam = cam._replace(R=cam.R.to(dtype), t=cam.t.to(dtype),
                           center=cam.center.to(dtype))
        inv, mask, ok = prior if prior is not None else (None, None, 0.0)
        watch = depth_step is None and inv is not None and bool(ok)
        f = loss_of(gt.to(dtype), leaves["exposure"][k_img],
                    None if inv is None else inv.to(dtype),
                    None if mask is None else mask.to(dtype), ok,
                    opt["lambda_dssim"],
                    expon_lr_delay(it, opt["depth_l1_weight_init"],
                                   opt["depth_l1_weight_final"],
                                   opt["iterations"]))
        gaussians = {k: v for k, v in leaves.items() if k != "exposure"}
        loss, radius, depth = render_backward(
            full, cam, bg.to(dtype), f, antialiasing,
            depth_of=gaussians if watch else None)
        losses.append(float(loss))
        grads = {k: (t.grad if t.grad is not None else torch.zeros_like(t))
                 for k, t in leaves.items()}
        if first_grad is None:
            first_grad = {k: float(g.float().norm()) for k, g in
                          grads.items() if k != "exposure"}
            first_grad["exposure"] = float(
                grads["exposure"][rows].float().norm())
        lrs = RT.group_lrs(opt, it, spatial_lr_scale)
        lrs["exposure"] = expon_lr_delay(
            it, opt["exposure_lr_init"], opt["exposure_lr_final"],
            opt["iterations"], opt["exposure_lr_delay_steps"],
            opt["exposure_lr_delay_mult"])
        visible = radius > 0
        with torch.no_grad():
            for k in p:
                g = grads[k]
                m_new = RT.B1 * m[k] + (1 - RT.B1) * g
                v_new = RT.B2 * v2[k] + (1 - RT.B2) * g * g
                if k == "exposure":
                    bc1, bc2 = 1.0 - RT.B1 ** it, 1.0 - RT.B2 ** it
                    p[k] = p[k] - lrs[k] * (m_new / bc1) / (
                        torch.sqrt(v_new / bc2) + EXPOSURE_EPS)
                    m[k], v2[k] = m_new, v_new
                    continue
                keep = visible.reshape((-1,) + (1,) * (g.dim() - 1))
                m[k] = torch.where(keep, m_new, m[k])
                v2[k] = torch.where(keep, v_new, v2[k])
                p[k] = torch.where(keep, p[k] - lrs[k] * m_new / (
                    torch.sqrt(v_new) + RT.EPS), p[k])
            if watch:
                depth_step, depth_m = j, {k: m[k].clone() for k in depth}
                depth_add = {k: torch.where(
                    visible.reshape((-1,) + (1,) * (g.dim() - 1)),
                    (1 - RT.B1) * g, torch.zeros_like(g))
                    for k, g in depth.items()}
        del leaves, full, grads, gaussians, depth
    change = {k: float((p[k].float() - start[k].float()).norm())
              for k in p if k != "exposure"}
    change["exposure"] = float((p["exposure"][rows].float()
                                - start["exposure"][rows].float()).norm())
    return {"losses": losses, "grad_norm": first_grad,
            "change_norm": change, "depth_step": depth_step,
            "depth_m": depth_m, "depth_add": depth_add}
