"""The benchmark's scenes, cameras, states and photos, made from seeds.

A configuration (``benchmark/configs/<name>.json``) states a scene's sizes:
its Gaussian count, SH degree, capacity, image size, views and the
capture's geometry. From its fixed ``scene.seed`` this module makes, on
the device and in a few large calls:

* the "ground-truth" scene: a ground disk, blobs on it and a far shell
  around it, each a surface of flat Gaussians facing out, with colours,
  view-dependent SH and mostly opaque opacities (what a trained 3DGS
  model of a 360-degree capture holds);
* the capture: cameras on a ring around the scene looking at its centre,
  every ``holdout_every``-th image held out as 3DGS's evaluation split
  does, and the training photos, rendered from the ground truth by the
  benchmark's own reference renderer and cached once per checkout;
* the alive slots: a seeded permutation places the Gaussians in the
  capacity, as density control leaves a trained state's slots.

From ``--seed``: the trained state (the ground truth, perturbed) and the
viewer's orbit. Gaussians are in generation order in every dict here;
``alive_idx[i]`` is Gaussian i's slot in the program's state.
"""
from __future__ import annotations

import hashlib
import json
import math
import os
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from ..reference import render as R

# bump when the generator below changes what it makes
GENERATOR = "scene-v2"
ROOT = Path(__file__).resolve().parents[2]       # the checkout
CACHE = ROOT / ".bench_cache"
SH0 = R.SH_C0


class View(NamedTuple):
    center: np.ndarray     # [3]
    R: np.ndarray          # [3, 3] world -> view (rows right, down, forward)
    fovx: float
    fovy: float
    width: int
    height: int


def look_at(center, target) -> np.ndarray:
    f = np.asarray(target, np.float64) - np.asarray(center, np.float64)
    f /= np.linalg.norm(f)
    right = np.cross(f, [0.0, 0.0, 1.0])
    right /= np.linalg.norm(right)
    down = np.cross(f, right)
    return np.stack([right, down, f])


def fovs(width: int, height: int, focal: float):
    return (2 * math.atan(width / (2 * focal)),
            2 * math.atan(height / (2 * focal)))


def capture_views(cfg: dict) -> list[View]:
    """Every image of the capture, on the ring, in capture order."""
    s = cfg["scene"]
    n = cfg["images"]
    fx, fy = fovs(cfg["width"], cfg["height"], cfg["focal"])
    out = []
    for k in range(n):
        a = 2 * math.pi * k / n
        c = np.array([s["ring_radius"] * math.cos(a),
                      s["ring_radius"] * math.sin(a),
                      s["ring_height"] + s["height_wobble"] * math.sin(3 * a)])
        out.append(View(c, look_at(c, s["target"]), fx, fy, cfg["width"],
                        cfg["height"]))
    return out


def train_views(cfg: dict) -> list[View]:
    """The training split: every ``holdout_every``-th image held out."""
    views = [v for k, v in enumerate(capture_views(cfg))
             if k % cfg["holdout_every"]]
    if len(views) != cfg["train_views"]:
        raise ValueError(f"{cfg['name']}: {len(views)} training views, the "
                         f"file says {cfg['train_views']}")
    return views


def orbit_view(cfg: dict, viewer: dict, phase: float, k: int) -> View:
    """Frame k of a viewer's orbit at the ring's radius: a full turn every
    ``frames_per_turn`` frames, the height and the aim swaying as a hand on
    a mouse makes them. The path is one closed curve; ``phase`` (from the
    seed) picks where on it the viewer starts, so every seed renders the
    same poses in another order."""
    s = cfg["scene"]
    a = phase + 2 * math.pi * k / viewer["frames_per_turn"]
    r = s["ring_radius"] * (1 + 0.04 * math.sin(5 * a))
    c = np.array([r * math.cos(a), r * math.sin(a),
                  s["ring_height"] + 0.25 * math.sin(2 * a)])
    target = np.asarray(s["target"]) + 0.2 * np.array(
        [math.sin(3 * a), math.cos(2 * a), 0.5 * math.sin(a)])
    fx, fy = fovs(viewer["width"], viewer["height"], viewer["focal"])
    return View(c, look_at(c, target), fx, fy, viewer["width"],
                viewer["height"])


def ref_camera(v: View, device, dtype=torch.float32) -> R.Camera:
    return R.make_camera(v.center, v.R, v.fovx, v.fovy, v.width, v.height,
                         device, dtype)


def port_camera(v: View, device):
    """The program's camera of a view: its ``make_camera`` takes the
    camera-to-world rotation and the world-to-camera translation."""
    from gs_tpu_torch.core.camera import make_camera
    return make_camera(v.R.T.copy(), -(v.R @ v.center), v.fovx, v.fovy,
                       v.width, v.height, device=device)


def _quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack([aw * bw - ax * bx - ay * by - az * bz,
                        aw * bx + ax * bw + ay * bz - az * by,
                        aw * by - ax * bz + ay * bw + az * bx,
                        aw * bz + ax * by - ay * bx + az * bw], -1)


def _facing(normal: torch.Tensor, g: torch.Generator) -> torch.Tensor:
    """Quaternions that turn +z onto ``normal`` [N, 3] (unit), after a
    random turn about z."""
    n = normal
    q = torch.stack([1 + n[:, 2], -n[:, 1], n[:, 0], torch.zeros_like(n[:, 0])],
                    -1)
    flip = q[:, 0] < 1e-6                       # normal = -z
    q[flip] = torch.tensor([0.0, 1.0, 0.0, 0.0], device=n.device)
    q = q / q.norm(dim=-1, keepdim=True)
    psi = torch.rand(n.shape[0], generator=g, device=n.device) * math.pi
    spin = torch.stack([torch.cos(psi), torch.zeros_like(psi),
                        torch.zeros_like(psi), torch.sin(psi)], -1)
    return _quat_mul(q, spin)


def ground_truth(cfg: dict, device) -> dict:
    """The scene's Gaussians (generation order) and their slots."""
    s = cfg["scene"]
    n = cfg["gaussians"]
    g = torch.Generator(device=device)
    g.manual_seed(int(s["seed"]))

    def rand(*shape):
        return torch.rand(shape, generator=g, device=device)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=device)

    n_ground = int(n * s["ground_share"])
    n_shell = int(n * s["shell_share"])
    n_blob = n - n_ground - n_shell
    xyz, normal, sigma, base = [], [], [], []

    # the ground: a disk
    r = s["ground_radius"] * torch.sqrt(rand(n_ground))
    a = 2 * math.pi * rand(n_ground)
    xyz.append(torch.stack([r * torch.cos(a), r * torch.sin(a),
                            torch.full_like(r, s["ground_z"])], -1))
    normal.append(torch.tensor([0.0, 0.0, 1.0], device=device).expand(
        n_ground, 3))
    area = math.pi * s["ground_radius"] ** 2
    sigma.append(torch.full((n_ground,), 0.7 * math.sqrt(area / n_ground),
                            device=device))
    base.append(torch.tensor([0.35, 0.45, 0.2], device=device).expand(
        n_ground, 3))

    # blobs on the ground: spheres, their points by area
    nb = s["blobs"]
    lo, hi = s["blob_radius"]
    br = torch.exp(math.log(lo) + (math.log(hi) - math.log(lo)) * rand(nb))
    bc_r = s["blob_region"] * torch.sqrt(rand(nb))
    bc_a = 2 * math.pi * rand(nb)
    bc = torch.stack([bc_r * torch.cos(bc_a), bc_r * torch.sin(bc_a),
                      s["ground_z"] + br + rand(nb) * s["blob_lift"]], -1)
    share = br * br / (br * br).sum()
    counts = torch.floor(share * n_blob).to(torch.int64)
    counts[0] += n_blob - int(counts.sum())
    owner = torch.repeat_interleave(torch.arange(nb, device=device), counts,
                                    output_size=n_blob)
    d = randn(n_blob, 3)
    d = d / d.norm(dim=-1, keepdim=True)
    xyz.append(bc[owner] + br[owner, None] * d)
    normal.append(d)
    blob_area = 4 * math.pi * br * br
    sigma.append(0.7 * torch.sqrt(blob_area / counts.clamp_min(1))[owner])
    base.append((0.15 + 0.7 * rand(nb, 3))[owner])

    # the far shell: what a 360 capture sees behind the scene
    rlo, rhi = s["shell_radius"]
    elo, ehi = (math.radians(e) for e in s["shell_elevation_deg"])
    rr = rlo + (rhi - rlo) * rand(n_shell)
    el = torch.asin(math.sin(elo) + (math.sin(ehi) - math.sin(elo))
                    * rand(n_shell))
    az = 2 * math.pi * rand(n_shell)
    dirs = torch.stack([torch.cos(el) * torch.cos(az),
                        torch.cos(el) * torch.sin(az), torch.sin(el)], -1)
    xyz.append(rr[:, None] * dirs)
    normal.append(-dirs)
    area = 2 * math.pi * ((rlo + rhi) / 2) ** 2 * (math.sin(ehi)
                                                   - math.sin(elo))
    sigma.append(torch.full((n_shell,), 0.7 * math.sqrt(area / n_shell),
                            device=device))
    sky = torch.clamp(el / ehi, 0, 1)[:, None]
    base.append((1 - sky) * torch.tensor([0.25, 0.35, 0.2], device=device)
                + sky * torch.tensor([0.6, 0.7, 0.85], device=device))

    xyz = torch.cat(xyz)
    normal = torch.cat(normal)
    sig = torch.cat(sigma) * torch.exp(s["scale_jitter"] * randn(n))
    log_scale = torch.log(torch.stack(
        [sig * torch.exp(0.2 * randn(n)), sig * torch.exp(0.2 * randn(n)),
         sig * s["flatness"]], -1))
    quat = _facing(normal, g)
    rgb = torch.clamp(torch.cat(base) + 0.08 * randn(n, 3), 0.02, 0.98)
    sh = torch.cat([((rgb - 0.5) / SH0)[:, None, :],
                    s["sh_rest_std"] * randn(n, 15, 3)], 1)
    logit = s["logit_mean"] + s["logit_std"] * randn(n)
    slots = torch.randperm(cfg["capacity"], generator=g, device=device)[:n]
    return {"xyz": xyz, "sh": sh, "log_scale": log_scale, "quat": quat,
            "logit": logit, "alive_idx": slots}


def perturbed(gt: dict, seed: int, p: dict) -> dict:
    """The trained state of a run: the ground truth moved by noise drawn
    from ``seed``, as far as a late phase of training leaves a model from
    its photos (``p``: the traffic's standard deviations)."""
    dev = gt["xyz"].device
    g = torch.Generator(device=dev)
    g.manual_seed(int(seed) % (1 << 63))
    n = gt["xyz"].shape[0]

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev)

    sig = torch.exp(gt["log_scale"][:, :2].mean(1, keepdim=True))
    return {
        "xyz": gt["xyz"] + p["xyz_by_scale"] * sig * randn(n, 3),
        "sh": gt["sh"] + torch.cat([p["sh_dc"] * randn(n, 1, 3),
                                    p["sh_rest"] * randn(n, 15, 3)], 1),
        "log_scale": gt["log_scale"] + p["log_scale"] * randn(n, 3),
        "quat": gt["quat"] + p["quat"] * randn(n, 4),
        "logit": gt["logit"] + p["logit"] * randn(n),
        "alive_idx": gt["alive_idx"],
    }


def config_key(cfg: dict) -> str:
    body = json.dumps(cfg, sort_keys=True) + GENERATOR
    return hashlib.sha256(body.encode()).hexdigest()[:16]


def cache_dir(cfg: dict) -> Path:
    return CACHE / f"{cfg['name']}-{config_key(cfg)}"


def photos(cfg: dict, gt: dict, device, group=None) -> np.ndarray:
    """The training photos [V, H, W, 3] uint8: the ground truth rendered by
    the reference from every training view on a black background, rounded
    to bytes, made once per checkout and read back after. With ``group``
    (a ``torch.distributed`` group of ranks) rank 0 makes them and the
    others wait."""
    d = cache_dir(cfg)
    path = d / "photos.u8"
    views = train_views(cfg)
    shape = (len(views), cfg["height"], cfg["width"], 3)
    rank = 0 if group is None else group.rank
    if not path.exists() and rank == 0:
        d.mkdir(parents=True, exist_ok=True)
        tmp = d / f"photos.u8.{os.getpid()}.tmp"
        bg = torch.zeros(3, device=device)
        stats = []
        with open(tmp, "wb") as f:
            for v in views:
                cam = ref_camera(v, device)
                img = R.render(gt, cam, bg)
                f.write((torch.clamp(img, 0, 1) * 255 + 0.5).to(torch.uint8)
                        .permute(1, 2, 0).contiguous().cpu().numpy().tobytes())
                stats.append(R.entries_of(gt, cam))
        (d / "train_entries.json").write_text(json.dumps(stats))
        os.replace(tmp, path)
    if group is not None:
        group.barrier()
    return np.fromfile(path, dtype=np.uint8).reshape(shape)


def entry_stats(cfg: dict, gt: dict, views: list[View], name: str,
                device) -> list[dict]:
    """Each view's binning needs (``reference.render.entries_of``) of the
    ground truth, cached once per checkout under ``name``."""
    path = cache_dir(cfg) / f"{name}_entries.json"
    if path.exists():
        return json.loads(path.read_text())
    stats = [R.entries_of(gt, ref_camera(v, device)) for v in views]
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    tmp.write_text(json.dumps(stats))
    os.replace(tmp, path)
    return stats


def buffers(stats: list[dict], margin: float, max_dup: int) -> tuple[int, int]:
    """The binning buffers no view of ``stats`` overflows, with ``margin``
    for the perturbed states: (dup_capacity, max_per_tile)."""
    dup = max(s["duplicates"] for s in stats)
    longest = max(s["longest"] for s in stats)
    dup_capacity = min(-(-int(dup * margin) // 512) * 512, max_dup)
    max_per_tile = 1 << int(math.ceil(math.log2(max(longest * margin, 2))))
    return dup_capacity, max_per_tile
