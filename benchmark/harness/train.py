"""The training driver: a traffic mix of ``"kind": "train"``.

Set-up builds one ``Trainer`` on the seeded trained state and the cached
photos, drives it through ``follow_steps`` iterations of the window's own
call (``Trainer.train(iterations=..., block_scan=True)``: the first step
alone, the rest as one block), keeping what the reference will check (the
first and the last step's loss, the Adam moment after the first step, the
parameters after the last), and warms it up. The window then calls it in
``chunk``-iteration chunks until ``--seconds`` have passed, each chunk
ending at its sync. A traced run profiles one chunk of
``trace_iterations`` instead. Under ``ranks`` > 1 every rank runs this
with its ``ProcessGroup``; rank 0 decides when the window ends and checks
the result.
"""
from __future__ import annotations

import gc
import time

import numpy as np
import torch

from ..reference import train as RT
from . import scene as S
from . import trace as TR
from . import work as W
from .common import Checks, reader

# the packed state's rows of each Adam group, SH degree 3
# (gs_tpu_torch/core/packed.py): xyz, DC, the 15 rest bands by colour,
# log-scale, quaternion, opacity logit
GROUP_ROWS = {"xyz": (0, 3), "sh_dc": (3, 6), "sh_rest": (6, 51),
              "log_scale": (51, 54), "quat": (54, 58), "logit": (58, 59)}
ROWS = 59


def packed_rows(p: dict) -> torch.Tensor:
    """Generation-order leaves -> [59, N] rows in the packed order."""
    n = p["xyz"].shape[0]
    return torch.cat([p["xyz"].T, p["sh"][:, 0].T,
                      p["sh"][:, 1:].reshape(n, 45).T, p["log_scale"].T,
                      p["quat"].T, p["logit"][None]], 0)


def from_rows(rows: torch.Tensor) -> dict:
    """[59, N] packed rows -> generation-order leaves."""
    n = rows.shape[1]
    sh = torch.cat([rows[3:6].T[:, None, :],
                    rows[6:51].T.reshape(n, 15, 3)], 1)
    return {"xyz": rows[0:3].T.contiguous(), "sh": sh.contiguous(),
            "log_scale": rows[51:54].T.contiguous(),
            "quat": rows[54:58].T.contiguous(), "logit": rows[58].clone()}


def group_norms(rows: torch.Tensor) -> dict:
    rows = rows.double()
    return {k: float(rows[a:b].norm()) for k, (a, b) in GROUP_ROWS.items()}


def port_state(start: dict, cfg: dict, iteration: int, num_images: int,
               v_rms: dict = None):
    """The program's TrainState of ``start`` at ``iteration``: each
    Gaussian in its slot, dead slots as the program pads them, Adam's
    count at ``iteration``, its first moment at zero and its second at
    ``v_rms[group]**2`` in the alive slots (zero without ``v_rms``)."""
    from gs_tpu_torch.core.gaussians import GaussianParams
    from gs_tpu_torch.models.gaussian_model import init_state
    cap = cfg["capacity"]
    idx = start["alive_idx"]
    dev = idx.device

    def put(x, fill, shape):
        out = torch.full((cap,) + shape, fill, dtype=torch.float32,
                         device=dev)
        out[idx] = x.reshape((-1,) + shape)
        return out

    quat = put(start["quat"], 0.0, (4,))
    dead = torch.ones(cap, dtype=torch.bool, device=dev)
    dead[idx] = False
    quat[dead, 0] = 1.0
    params = GaussianParams(
        xyz=put(start["xyz"], 0.0, (3,)),
        sh_dc=put(start["sh"][:, :1], 0.0, (1, 3)),
        sh_rest=put(start["sh"][:, 1:], 0.0, (15, 3)),
        log_scale=put(start["log_scale"], -10.0, (3,)),
        quat=quat, logit_opacity=put(start["logit"], -10.0, (1,)))
    state = init_state(params, ~dead, num_images=num_images)
    if v_rms:
        fields = {"xyz": "xyz", "sh_dc": "sh_dc", "sh_rest": "sh_rest",
                  "log_scale": "log_scale", "quat": "quat",
                  "logit": "logit_opacity"}
        v = state.v._replace(**{
            f: torch.where(~dead.reshape((-1,) + (1,) * (
                getattr(state.v, f).dim() - 1)),
                torch.full_like(getattr(state.v, f), v_rms[g] ** 2),
                getattr(state.v, f)) for g, f in fields.items()})
        state = state._replace(v=v)
    return state._replace(step=torch.full((), iteration, dtype=torch.int32,
                                          device=dev))


def camera_order(seed: int, n_views: int, count: int) -> list[int]:
    """The training cameras of the first ``count`` iterations from a
    ``Trainer(seed=seed)``: random picks without replacement, a fresh
    permutation of the views each time they run out."""
    rng = np.random.default_rng(seed)
    stack, out = [], []
    for _ in range(count):
        if not stack:
            stack = list(rng.permutation(n_views))
        out.append(int(stack.pop()))
    return out


def spatial_extent(views) -> float:
    """3DGS's scene extent: 1.1 x the largest distance of a training
    camera from their mean (its ``getNerfppNorm``)."""
    c = np.stack([v.center for v in views])
    return float(1.1 * np.linalg.norm(c - c.mean(0), axis=1).max())


def _alive_rows(state, idx) -> tuple[torch.Tensor, torch.Tensor]:
    """(parameters, first moment) rows [59, N] of the alive slots."""
    return (state.packed.index_select(1, idx)[:ROWS],
            state.m.index_select(1, idx)[:ROWS])


def run(cell, seed: int, seconds: float, traced: bool, device,
        group=None, raster_kw: dict = None) -> dict:
    """One run of a training cell. Returns the partial result: metrics,
    counts, the device's numbers and, on rank 0, the checks."""
    from gs_tpu_torch.config import (ModelConfig, OptimizationConfig,
                                     PipelineConfig, RasterConfig)
    from gs_tpu_torch.data.camera_utils import LoadedCamera
    from gs_tpu_torch.render import MAX_DUP_CAPACITY
    from gs_tpu_torch.train.loop import Trainer

    cfg, tf = cell.config, cell.traffic
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    main = group is None or group.rank == 0
    if cuda:
        from gs_tpu_torch.ops import _cuda
        _cuda.build()
    gt = S.ground_truth(cfg, dev)
    photos = S.photos(cfg, gt, dev, group)
    views = S.train_views(cfg)
    stats = S.entry_stats(cfg, gt, views, "train", dev)
    dup, mpt = S.buffers(stats, tf["buffer_margin"], MAX_DUP_CAPACITY)
    start_it = int(tf["start_iteration"])
    start = S.perturbed(gt, seed, tf["perturb"])
    idx = gt["alive_idx"]
    del gt
    v_rms = tf.get("adam_v_rms")
    state = port_state(start, cfg, start_it, len(views), v_rms)
    del start
    ones = np.ones((1, cfg["height"], cfg["width"]), np.float32)
    cams = [LoadedCamera(S.port_camera(v, dev), None,
                         np.ascontiguousarray(photos[k].transpose(2, 0, 1),
                                              dtype=np.float32) / 255.0,
                         ones, None, None, False)
            for k, v in enumerate(views)]
    extent = spatial_extent(views)
    opt = OptimizationConfig(**tf["optimization"])
    tr = Trainer(cams, None, extent,
                 ModelConfig(sh_degree=cfg["sh_degree"], data_device=str(dev)),
                 opt, PipelineConfig(),
                 RasterConfig(dup_capacity=dup, max_per_tile=mpt,
                              **(raster_kw or {})),
                 start_state=state, start_iteration=start_it, seed=seed,
                 mesh=group)
    del cams, state
    gc.collect()

    # the steps the reference follows, through the window's own call: the
    # first alone (its loss, and its gradient from Adam's first moment),
    # the rest as one block, so that they run at positions of the bucket
    # above 0 (its camera indices, iterations and schedule rows)
    follow = int(tf["follow_steps"])
    picks = camera_order(seed, len(views), follow)
    losses, seen, m1, p_last = [], [], None, None

    def on_step(i, metrics, trainer):
        losses.append(float(metrics.loss))
        seen.append(int(trainer._last_cam))

    for end in sorted({start_it + 1, start_it + follow}):
        tr.train(iterations=end, block_scan=True, on_step=on_step)
        full = tr.full_state()
        if main:
            p, m = _alive_rows(full, idx)
            if m1 is None:
                m1 = m.cpu()
            p_last = p.cpu()
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
            # each chunk's seconds, to its sync (Trainer.train's return)
            chunk_s.append(tr.train(iterations=tr.iteration + chunk,
                                    block_scan=True))
            iters += chunk
            go = time.perf_counter() - t0 < seconds
            if group is not None:
                go = group.every(go)      # rank 0's clock decides for all
            if not go:
                break
        window = time.perf_counter() - t0
        out["metrics"][tf["rate_metric"]] = {"value": iters / window,
                                             "unit": "it/s"}
        out["attempted"] = iters
        out["window_s"] = window
        out["chunk_s"] = chunk_s
    else:
        n_trace = int(tf["trace_iterations"])
        full = tr.full_state()
        snap = _alive_rows(full, idx)[0].cpu() if main else None
        del full
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
            units=n_trace,
            k1g=TR.kernels(tr_events, "raster_fwd_kernel<true>")[:s_n],
            k3=TR.kernels(tr_events, "raster_bwd_kernel")[:s_n],
            nccl_s=sum(v for k, v in summary["ops"].items()
                       if k.lower().startswith("nccl")))
        del prof, tr_events
    if group is not None:
        import torch.distributed as dist
        gathered = [None] * group.size
        dist.all_gather_object(gathered, (summary, out["memory_peak_bytes"]))
        out["memory_peak_bytes"] = max(g[1] for g in gathered)
        summaries = [g[0] for g in gathered]
        group.close()
    else:
        summaries = [summary]
    del tr
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    if not main:
        return out

    # the checks, once the window has closed and the program is gone
    checks = Checks(cell.limits)
    gt = S.ground_truth(cfg, dev)
    start = S.perturbed(gt, seed, tf["perturb"])
    del gt
    sel = {k: v for k, v in start.items() if k != "alive_idx"}
    ends = [picks[0], picks[-1]] if follow > 1 else picks
    if seen != ends or len(set(picks)) < follow:
        checks.fail(f"the followed steps ended on cameras {seen}, not the "
                    f"first and last of {picks}, all different")
    bg = torch.zeros(3, device=dev)
    ref = RT.train_steps(
        sel, [S.ref_camera(views[c], dev) for c in picks],
        [torch.from_numpy(photos[c]).to(dev).permute(2, 0, 1).float() / 255.0
         for c in picks], bg, tf["optimization"], start_it + 1, extent,
        v_rms=v_rms)
    p0 = packed_rows(sel).cpu()
    prog_grad = group_norms(m1 / (1 - RT.B1))
    prog_change = group_norms(p_last - p0)
    # the first step's loss: the later steps' carry Adam's normalised
    # steps on gradients that differ by rounding (readings, PERF.md)
    loss1_gap = abs(losses[0] - ref["losses"][0]) / abs(ref["losses"][0])
    grad_gap, grad_at = RT.worst_gap(prog_grad, ref["grad_norm"])
    change_gap, change_at = RT.worst_gap(prog_change, ref["change_norm"])
    checks.add("loss1_gap", loss1_gap)
    checks.add("grad_gap", grad_gap)
    checks.add("change_gap", change_gap)
    out["readings"] = {"losses": losses, "ref_losses": ref["losses"],
                       "loss_gap": max(abs(a - b) / abs(b) for a, b in
                                       zip(losses, [ref["losses"][0],
                                                    ref["losses"][-1]])),
                       "cameras": picks, "grad_worst": grad_at,
                       "change_worst": change_at,
                       "grad_norm": prog_grad, "ref_grad_norm":
                       ref["grad_norm"], "change_norm": prog_change,
                       "ref_change_norm": ref["change_norm"]}
    del ref

    if traced:
        order = camera_order(seed, len(views), first + n_trace)
        window_cams = order[first:first + n_trace]
        t = {"kind": "train", "units": n_trace, "chips": cell.chips,
             "busy_s": [s["busy_s"] for s in summaries],
             "window_s": [s["window_s"] for s in summaries],
             "nccl_s": [s["nccl_s"] for s in summaries]}
        s_n = min(min(len(s["k1g"]), len(s["k3"])) for s in summaries)
        if window_cams[-1] == last_cam and s_n:
            snap_p = from_rows(snap.to(dev))
            frames = [W.frame_work(snap_p, S.ref_camera(views[c], dev))
                      for c in window_cams[:s_n]]
            del snap_p
            k1g_bound = sum(W.bound_s(dict(
                f["fwd"], bytes=f["fwd"]["bytes"] + 4 * f["fwd"]["tiles"]
                * W.PIX)) for f in frames)
            k3_bound = sum(W.bound_s(f["bwd"]) for f in frames)
            pixels = cfg["width"] * cfg["height"]
            t.update(
                k1g_bound_s=k1g_bound, k3_bound_s=k3_bound,
                k1g_s=sum(sum(s["k1g"][:s_n]) for s in summaries),
                k3_s=sum(sum(s["k3"][:s_n]) for s in summaries),
                needed_ops=float(np.mean([
                    W.iteration_ops(len(idx), pixels, f) for f in frames])),
                peak=W.PEAK_FP32)
        metrics = {}
        for m in cell.per_layer:
            v = reader(m["name"])(t)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        out["metrics"] = metrics
        out["busy_s"] = float(np.mean(t["busy_s"]))
        out["traced_window_s"] = float(np.mean(t["window_s"]))
        out["breakdown"] = {"device_ops": TR.top(summaries[0]["ops"]),
                            "idle_gaps": TR.top(summaries[0]["gaps"])}
    out["checks"] = checks
    return out
