"""The training driver of the 3DGS release's 2024 recipe: a traffic mix of
``"kind": "train_full"``, on one card.

As ``harness/train.py`` (its state, camera picks, followed steps, window
and traced chunk), with the configuration's switches on: antialiasing
(``pipeline``), an exposure per image and depth priors (``model``), and the
traffic's optimizer (sparse Adam, the exposures' delayed rate, the depth
weight). From the configuration's scene seed, once per checkout and cached
beside the photos (``scene.cache_dir``):

* the exposed photos: each cached photo (``scene.photos``) through its
  view's seeded 3x4 affine (:func:`exposures`), clamped and rounded to
  bytes: what a capture whose exposure varies from photo to photo holds;
* the depth priors: each training view's inverse depth of the ground truth
  by the reference, times a seeded log-normal scale, plus an offset, with
  per-pixel noise, quantized to 16 bits as the release reads a monocular
  estimate's PNG; a seeded tenth of the views marked unreliable
  (``depth_ok`` 0), as the release's scale fit rejects some; masks of ones.

From ``--seed``: the trained state (``scene.perturbed``) and the exposures'
start, each view's affine plus seeded noise (``perturb["exposure"]``), so
the exposures' group is mid-optimization like the others; Adam's second
moments at ``adam_v_rms``, the exposures' too.

The checks follow the three steps with ``reference/full.py`` and compare
the first and the last step's loss, the first gradient and the change over
the steps of seven groups: the six of ``train.py`` and the exposures, over
the picked views' rows; and, at the first followed step whose prior is
reliable, the Gaussians' first moments projected on what the depth term
added to them (:func:`depth_grad_gap`): the inverse depth's cotangent
through the rasterizer's backward, which the losses and the norms hardly
see.
"""
from __future__ import annotations

import gc
import os
import time

import numpy as np
import torch

from ..reference import full as F
from ..reference import render as R
from ..reference import train as RT
from . import scene as S
from . import trace as TR
from . import work as W
from .common import Checks, reader
from .train import (_alive_rows, camera_order, from_rows, group_norms,
                    packed_rows, port_state, spatial_extent)

# bump when what this module makes from a configuration changes
GENERATOR = "full-v1"
QUANT = float(1 << 16)      # the release reads a 16-bit depth PNG / 2^16


def exposures(cfg: dict) -> np.ndarray:
    """Each training view's true exposure [V, 3, 4] float32, from the
    scene seed: the affine that takes the clean render to its photo,
    ``photo[c] = sum_k clean[k] E[k, c] + E[c, 3]``."""
    e = cfg["exposure"]
    n = cfg["train_views"]
    rng = np.random.default_rng([int(cfg["scene"]["seed"]), 0xE1])
    gain = 1.0 + rng.uniform(-e["gain"], e["gain"], (n, 3))
    mix = rng.uniform(-e["cross"], e["cross"], (n, 3, 3))
    offset = rng.uniform(-e["offset"], e["offset"], (n, 3))
    idx = np.arange(3)
    mix[:, idx, idx] = gain
    return np.concatenate([mix, offset[:, :, None]], 2).astype(np.float32)


def start_exposures(cfg: dict, seed: int, sigma: float) -> np.ndarray:
    """The run's exposures: the true ones plus noise from ``seed``."""
    rng = np.random.default_rng([int(seed) % (1 << 63), 0xE2])
    e = exposures(cfg)
    return (e + sigma * rng.standard_normal(e.shape)).astype(np.float32)


def _cached(path, make):
    """``make(tmp)`` writes the file once per checkout; later runs read."""
    if not path.exists():
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        make(tmp)
        os.replace(tmp, path)
    return path


def exposed_photos(cfg: dict, photos: np.ndarray, device) -> np.ndarray:
    """[V, H, W, 3] uint8: ``photos`` through :func:`exposures`."""
    ex = torch.from_numpy(exposures(cfg)).to(device)

    def make(tmp):
        with open(tmp, "wb") as f:
            for k in range(photos.shape[0]):
                img = torch.from_numpy(photos[k]).to(device).permute(
                    2, 0, 1).float() / 255.0
                out = F.apply_exposure(img, ex[k])
                f.write((torch.clamp(out, 0, 1) * 255 + 0.5).to(torch.uint8)
                        .permute(1, 2, 0).contiguous().cpu().numpy()
                        .tobytes())

    path = _cached(S.cache_dir(cfg) / f"exposed-{GENERATOR}.u8", make)
    return np.fromfile(path, dtype=np.uint8).reshape(photos.shape)


def depth_priors(cfg: dict, gt: dict, views, device):
    """(inverse-depth priors [V, H, W] float32, depth_ok [V] bool)."""
    d = cfg["depth_prior"]
    n = len(views)
    rng = np.random.default_rng([int(cfg["scene"]["seed"]), 0xD1])
    scale = np.exp(d["scale_log_sigma"] * rng.standard_normal(n))
    offset = rng.uniform(-d["offset"], d["offset"], n)
    bad = rng.choice(n, size=int(round(d["unreliable_share"] * n)),
                     replace=False)
    ok = np.ones(n, bool)
    ok[bad] = False
    top = (1 << int(d["quantization_bits"])) - 1

    def make(tmp):
        g = torch.Generator(device=device)
        g.manual_seed(int(cfg["scene"]["seed"]))
        bg = torch.zeros(3, device=device)
        with open(tmp, "wb") as f:
            for k, v in enumerate(views):
                _, invd = F.render(gt, S.ref_camera(v, device), bg,
                                   antialiasing=False)
                noise = torch.randn(invd.shape, generator=g, device=device)
                prior = (invd * float(scale[k]) + float(offset[k])) * (
                    1.0 + d["noise"] * noise)
                q = torch.clamp(torch.round(prior * QUANT), 0, top)
                f.write(q.to(torch.int32).cpu().numpy().astype(np.uint16)
                        .tobytes())

    path = _cached(S.cache_dir(cfg) / f"priors-{GENERATOR}.u16", make)
    q = np.fromfile(path, dtype=np.uint16).reshape(n, cfg["height"],
                                                   cfg["width"])
    return q.astype(np.float32) / QUANT, ok


def split_rows(g: dict) -> torch.Tensor:
    """Adam groups (``reference/train.py::split``) -> [59, N] packed rows."""
    return packed_rows({"xyz": g["xyz"],
                        "sh": torch.cat([g["sh_dc"], g["sh_rest"]], 1),
                        "log_scale": g["log_scale"], "quat": g["quat"],
                        "logit": g["logit"]})


def depth_grad_gap(m_rows: torch.Tensor, ref: dict) -> float:
    """The share of the depth term's gradient that the first moments
    ``m_rows`` [59, N] miss or add, at the reference's first step with a
    reliable prior: their gap to the reference's moments, projected on
    what the depth term added there, over that addition's squared norm.
    0 where no followed step has a reliable prior."""
    if ref["depth_step"] is None:
        return 0.0
    add = split_rows(ref["depth_add"]).double()
    gap = m_rows.to(add.device).double() - split_rows(
        ref["depth_m"]).double()
    return abs(float((gap * add).sum() / (add * add).sum()))


def first_reliable(picks, depth_ok):
    """The index of the first of ``picks`` whose prior is reliable."""
    return next((j for j, c in enumerate(picks) if depth_ok[c]), None)


def frame_work(params: dict, cam) -> dict:
    """``work.frame_work`` of the recipe's frame: its projection with the
    antialiasing opacity scale, binned and counted by ``harness/work.py``."""
    with torch.no_grad():
        proj = F.project(params, cam)
        bins = R.bin_tiles(proj, cam.width, cam.height)
        g = bins.gid
        feats = F.packets(proj)[g].T.contiguous().float()
        work = W.raster_work(feats, bins.tile_start, bins.tile_end, bins.gx)
    work["entries"] = int(g.numel())
    return work


def _exposure_rows(state) -> tuple[torch.Tensor, torch.Tensor]:
    """Copies of the exposures and their first moment (the graphs write
    the state in place)."""
    return (state.exposure.to("cpu", copy=True),
            state.exp_m.to("cpu", copy=True))


def run(cell, seed: int, seconds: float, traced: bool, device,
        group=None, raster_kw: dict = None) -> dict:
    """One run of a ``train_full`` cell (one rank). Returns the partial
    result, as ``harness/train.py::run``."""
    from gs_tpu_torch.config import (ModelConfig, OptimizationConfig,
                                     PipelineConfig, RasterConfig)
    from gs_tpu_torch.data.camera_utils import LoadedCamera
    from gs_tpu_torch.render import MAX_DUP_CAPACITY
    from gs_tpu_torch.train.loop import Trainer

    if group is not None:
        raise ValueError(f"{cell.name}: a train_full cell runs on one rank")
    cfg, tf = cell.config, cell.traffic
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda:
        from gs_tpu_torch.ops import _cuda
        _cuda.build()
    gt = S.ground_truth(cfg, dev)
    views = S.train_views(cfg)
    shots = exposed_photos(cfg, S.photos(cfg, gt, dev), dev)
    priors, depth_ok = depth_priors(cfg, gt, views, dev)
    stats = S.entry_stats(cfg, gt, views, "train", dev)
    dup, mpt = S.buffers(stats, tf["buffer_margin"], MAX_DUP_CAPACITY)
    start_it = int(tf["start_iteration"])
    start = S.perturbed(gt, seed, tf["perturb"])
    idx = gt["alive_idx"]
    del gt
    v_rms = tf.get("adam_v_rms") or {}
    e0 = torch.from_numpy(start_exposures(cfg, seed,
                                          tf["perturb"]["exposure"]))
    state = port_state(start, cfg, start_it, len(views), v_rms)
    state = state._replace(
        exposure=e0.to(dev),
        exp_v=torch.full_like(state.exp_v, v_rms.get("exposure", 0.0) ** 2),
        exp_step=state.step.clone())
    del start
    ones = np.ones((1, cfg["height"], cfg["width"]), np.float32)
    cams = [LoadedCamera(S.port_camera(v, dev), None,
                         np.ascontiguousarray(shots[k].transpose(2, 0, 1),
                                              dtype=np.float32) / 255.0,
                         ones, priors[k], ones[0], bool(depth_ok[k]))
            for k, v in enumerate(views)]
    extent = spatial_extent(views)
    opt = OptimizationConfig(**tf["optimization"])
    model = cfg["model"]
    tr = Trainer(cams, None, extent,
                 ModelConfig(sh_degree=cfg["sh_degree"],
                             train_test_exp=bool(model["train_test_exp"]),
                             data_device=str(dev)),
                 opt, PipelineConfig(**cfg["pipeline"]),
                 RasterConfig(dup_capacity=dup, max_per_tile=mpt,
                              **(raster_kw or {})),
                 start_state=state, start_iteration=start_it, seed=seed)
    del cams, state
    gc.collect()

    # the followed steps, as train.py: the first alone, the rest as one
    # block, cut after the first step with a reliable prior; the
    # exposures' first moment and values beside the rows'
    follow = int(tf["follow_steps"])
    picks = camera_order(seed, len(views), follow)
    k_depth = first_reliable(picks, depth_ok)
    ends = sorted({start_it + 1, start_it + follow} | (
        set() if k_depth is None else {start_it + 1 + k_depth}))
    losses, seen, m1, p_last, e_m1, e_last = [], [], None, None, None, None
    m_depth = None

    def on_step(i, metrics, trainer):
        losses.append(float(metrics.loss))
        seen.append(int(trainer._last_cam))

    for end in ends:
        tr.train(iterations=end, block_scan=True, on_step=on_step)
        full = tr.full_state()
        p, m = _alive_rows(full, idx)
        e, em = _exposure_rows(full)
        if m1 is None:
            m1, e_m1 = m.cpu(), em
        if k_depth is not None and end == start_it + 1 + k_depth:
            m_depth = m.cpu()
        p_last, e_last = p.cpu(), e
        del full
    tr.train(iterations=tr.iteration + int(tf["warm_iterations"]),
             block_scan=True)
    done = tr.iteration - start_it
    if cuda:
        torch.cuda.synchronize(dev)

    out = {"correct": None, "attempted": 0, "failed": 0, "metrics": {},
           "breakdown": None}
    chunk = int(tf["chunk"])
    if not traced:
        t0 = time.perf_counter()
        out["window_start"] = time.time()
        iters, chunk_s = 0, []
        while True:
            chunk_s.append(tr.train(iterations=tr.iteration + chunk,
                                    block_scan=True))
            iters += chunk
            if time.perf_counter() - t0 >= seconds:
                break
        window = time.perf_counter() - t0
        out["metrics"][tf["rate_metric"]] = {"value": iters / window,
                                             "unit": "it/s"}
        out["attempted"] = iters
        out["window_s"] = window
        out["chunk_s"] = chunk_s
    else:
        n_trace = int(tf["trace_iterations"])
        snap = _alive_rows(tr.full_state(), idx)[0].cpu()
        first = done
        out["window_start"] = time.time()
        with TR.profile() as prof:
            with torch.profiler.record_function("bench.chunk"):
                tr.train(iterations=tr.iteration + n_trace, block_scan=True)
            if cuda:
                torch.cuda.synchronize(dev)
        out["attempted"] = n_trace
    out["failed"] = int(tr.overflow_exhausted)
    out["captures"] = {"step": len(tr.captures),
                       "density": len(tr.density_captures)}
    last_cam = int(tr._last_cam)
    out["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(dev)
                                if cuda else 0)
    summary = None
    if traced:
        tr_events = TR.read(prof)
        bounds = TR.span_bounds(tr_events, "bench.chunk")
        summary = TR.summarize(tr_events, *(bounds or (None, None)))
        s_n = int(tf["roofline_samples"])
        summary.update(
            k1g=TR.kernels(tr_events, "raster_fwd_kernel<true>")[:s_n],
            k3=TR.kernels(tr_events, "raster_bwd_kernel")[:s_n])
        del prof, tr_events
    del tr
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # the checks, once the window has closed and the program is gone
    checks = Checks(cell.limits)
    gt = S.ground_truth(cfg, dev)
    start = S.perturbed(gt, seed, tf["perturb"])
    del gt
    sel = {k: v for k, v in start.items() if k != "alive_idx"}
    want = [picks[e - start_it - 1] for e in ends]
    if seen != want or len(set(picks)) < follow:
        checks.fail(f"the followed steps ended on cameras {seen}, not "
                    f"{want} of {picks}, all different")
    bg = torch.zeros(3, device=dev)
    ref = F.train_steps(
        sel, e0.to(dev), picks, [S.ref_camera(views[c], dev) for c in picks],
        [torch.from_numpy(shots[c]).to(dev).permute(2, 0, 1).float() / 255.0
         for c in picks],
        [(torch.from_numpy(priors[c]).to(dev),
          torch.ones(priors.shape[1:], device=dev), bool(depth_ok[c]))
         for c in picks], bg, tf["optimization"], start_it + 1, extent,
        v_rms=v_rms, antialiasing=bool(cfg["pipeline"]["antialiasing"]))
    rows = torch.as_tensor(picks)
    p0 = packed_rows(sel).cpu()
    prog_grad = group_norms(m1 / (1 - RT.B1))
    prog_grad["exposure"] = float((e_m1[rows] / (1 - RT.B1)).double().norm())
    prog_change = group_norms(p_last - p0)
    prog_change["exposure"] = float((e_last[rows] - e0[rows]).double().norm())
    loss1_gap = abs(losses[0] - ref["losses"][0]) / abs(ref["losses"][0])
    # the last step's loss too: its depth term is there whenever its view's
    # prior is reliable, also where the first view's is not
    loss_last_gap = abs(losses[-1] - ref["losses"][-1]) / abs(
        ref["losses"][-1])
    grad_gap, grad_at = RT.worst_gap(prog_grad, ref["grad_norm"])
    change_gap, change_at = RT.worst_gap(prog_change, ref["change_norm"])
    checks.add("loss1_gap", loss1_gap)
    checks.add("loss_last_gap", loss_last_gap)
    checks.add("grad_gap", grad_gap)
    checks.add("change_gap", change_gap)
    if ref["depth_step"] != k_depth:
        checks.fail(f"the reference's first step with a reliable prior is "
                    f"{ref['depth_step']}, not {k_depth}")
    checks.add("depth_grad_gap", depth_grad_gap(m_depth, ref)
               if k_depth is not None else 0.0)
    out["readings"] = {"losses": losses, "ref_losses": ref["losses"],
                       "depth_step": k_depth,
                       "cameras": picks, "depth_ok": [bool(depth_ok[c])
                                                      for c in picks],
                       "grad_worst": grad_at, "change_worst": change_at,
                       "grad_norm": prog_grad,
                       "ref_grad_norm": ref["grad_norm"],
                       "change_norm": prog_change,
                       "ref_change_norm": ref["change_norm"]}
    del ref, m_depth

    if traced:
        order = camera_order(seed, len(views), first + n_trace)
        window_cams = order[first:first + n_trace]
        t = {"kind": "train", "units": n_trace, "chips": 1,
             "capacity": cfg["capacity"], "busy_s": [summary["busy_s"]],
             "window_s": [summary["window_s"]], "nccl_s": [0.0]}
        s_n = min(len(summary["k1g"]), len(summary["k3"]))
        if window_cams[-1] == last_cam and s_n:
            snap_p = from_rows(snap.to(dev))
            frames = [frame_work(snap_p, S.ref_camera(views[c], dev))
                      for c in window_cams[:s_n]]
            del snap_p
            t.update(
                k1g_bound_s=sum(W.bound_s(dict(
                    f["fwd"], bytes=f["fwd"]["bytes"] + 4 * f["fwd"]["tiles"]
                    * W.PIX)) for f in frames),
                k3_bound_s=sum(W.bound_s(f["bwd"]) for f in frames),
                k1g_s=sum(summary["k1g"][:s_n]), k3_s=sum(summary["k3"][:s_n]))
        metrics = {}
        for m in cell.per_layer:
            v = reader(m["name"])(t)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        out["metrics"] = metrics
        out["busy_s"] = summary["busy_s"]
        out["traced_window_s"] = summary["window_s"]
        out["breakdown"] = {"device_ops": TR.top(summary["ops"]),
                            "idle_gaps": TR.top(summary["gaps"])}
    out["checks"] = checks
    return out

