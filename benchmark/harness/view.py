"""The viewing driver: a traffic mix of ``"kind": "view"``.

One client in a closed loop: each frame hands a new pose on the seeded
orbit to ``Trainer.render_view`` and turns the image into the bytes a
viewer is sent (``gs_tpu_torch/viewer/server.py::frame_bytes``); the next
pose follows once the bytes are on the host. A frame's latency runs from
the pose to the bytes. The Trainer holds the run's trained state and one
placeholder training view; it never trains. A traced run profiles
``trace_frames`` frames instead of the window.
"""
from __future__ import annotations

import gc
import math
import time

import numpy as np
import torch

from ..reference import render as R
from . import scene as S
from . import trace as TR
from . import work as W
from .common import Checks, percentile, reader


def _phase(seed: int) -> float:
    return float(np.random.default_rng(seed).uniform(0, 2 * math.pi))


def run(cell, seed: int, seconds: float, traced: bool, device,
        group=None, raster_kw: dict = None) -> dict:
    from gs_tpu_torch.config import (ModelConfig, OptimizationConfig,
                                     PipelineConfig, RasterConfig)
    from gs_tpu_torch.data.camera_utils import LoadedCamera
    from gs_tpu_torch.render import MAX_DUP_CAPACITY
    from gs_tpu_torch.train.loop import Trainer
    from gs_tpu_torch.viewer import server

    from .train import port_state, spatial_extent

    cfg, tf = cell.config, cell.traffic
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda:
        from gs_tpu_torch.ops import _cuda
        _cuda.build()
    phase = _phase(seed)
    gt = S.ground_truth(cfg, dev)
    # the buffers no pose of any orbit overflows: poses all round the ring
    probe = [S.orbit_view(cfg, tf, 2 * math.pi * k / tf["buffer_poses"], 0)
             for k in range(int(tf["buffer_poses"]))]
    stats = S.entry_stats(cfg, gt, probe, "view", dev)
    dup, mpt = S.buffers(stats, tf["buffer_margin"], MAX_DUP_CAPACITY)
    start_it = int(tf["start_iteration"])
    start = S.perturbed(gt, seed, tf["perturb"])
    del gt
    views = S.train_views(cfg)
    state = port_state(start, cfg, start_it, 1)
    del start
    placeholder = LoadedCamera(
        S.port_camera(views[0], dev), None,
        np.zeros((3, cfg["height"], cfg["width"]), np.float32),
        np.ones((1, cfg["height"], cfg["width"]), np.float32), None, None,
        False)
    tr = Trainer([placeholder], None, spatial_extent(views),
                 ModelConfig(sh_degree=cfg["sh_degree"], data_device=str(dev)),
                 OptimizationConfig(), PipelineConfig(),
                 RasterConfig(dup_capacity=dup, max_per_tile=mpt,
                              **(raster_kw or {})),
                 start_state=state, start_iteration=start_it, seed=seed)
    del state
    gc.collect()

    def frame(k: int) -> bytes:
        cam = S.port_camera(S.orbit_view(cfg, tf, phase, k), dev)
        return server.frame_bytes(tr.render_view(cam).image)

    first = int(tf["warm_frames"])
    for k in range(first):
        frame(k)
    out = {"correct": None, "attempted": 0, "failed": 0, "metrics": {},
           "breakdown": None}
    # the frames the checks compare: a seeded sample of the first
    # ``sample_from`` and the last; the others' bytes are dropped
    rng = np.random.default_rng(seed)
    sample = set(rng.choice(int(tf["sample_from"]),
                            int(tf["check_frames"]) - 1,
                            replace=False).tolist())
    kept, last, n_bytes_bad = {}, None, 0
    nbytes = 3 * tf["width"] * tf["height"]

    def serve(j: int):
        nonlocal last, n_bytes_bad
        b = frame(first + j)
        n_bytes_bad += len(b) != nbytes
        if j in sample:
            kept[j] = b
        last = (j, b)

    done = 0
    if not traced:
        lat = []
        out["window_start"] = time.time()
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            t = time.perf_counter()
            serve(done)
            lat.append(time.perf_counter() - t)
            done += 1
        window = time.perf_counter() - t0
        out["metrics"]["view_fps"] = {"value": len(lat) / window,
                                      "unit": "frames/s"}
        out["metrics"]["view_ms_p95"] = {"value": 1e3 * percentile(lat, 95),
                                         "unit": "ms"}
        out["latency_ms_median"] = 1e3 * percentile(lat, 50)
        out["window_s"] = window
    else:
        n_trace = int(tf["trace_frames"])
        out["window_start"] = time.time()
        with TR.profile() as prof:
            with torch.profiler.record_function("bench.frames"):
                for _ in range(n_trace):
                    with torch.profiler.record_function("bench.frame"):
                        serve(done)
                    done += 1
    out["attempted"] = done
    kept[last[0]] = last[1]
    out["captures"] = {"view": len(tr.views.captures)}
    out["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(dev)
                                if cuda else 0)
    out["failed"] = n_bytes_bad
    summary = None
    if traced:
        events = TR.read(prof)
        bounds = TR.span_bounds(events, "bench.frames")
        summary = TR.summarize(events, *(bounds or (None, None)))
        s_n = int(tf["roofline_samples"])
        summary["k1"] = TR.kernels(events, "raster_fwd_kernel<false>")[:s_n]
        del prof, events
    del tr
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # the checks: a sample of the window's frames drawn from the seed,
    # rendered again by the reference from the same state and pose
    checks = Checks(cell.limits)
    gt = S.ground_truth(cfg, dev)
    start = S.perturbed(gt, seed, tf["perturb"])
    del gt
    params = {k2: v for k2, v in start.items() if k2 != "alive_idx"}
    bg = torch.zeros(3, device=dev)
    worst, shares = 0.0, []
    picks = sorted(kept)
    for j in picks:
        v = S.orbit_view(cfg, tf, phase, first + j)
        want = R.frame_bytes(R.render(params, S.ref_camera(v, dev), bg))
        got = torch.frombuffer(bytearray(kept[j]), dtype=torch.uint8)
        if got.numel() != want.numel():
            checks.fail(f"frame {first + j} has {got.numel()} bytes, not "
                        f"{want.numel()}")
            continue
        share = R.bytes_off(got.reshape(want.shape).to(dev), want)
        shares.append(share)
        worst = max(worst, share)
    checks.add("bytes_off", worst if shares else float("nan"))
    out["readings"] = {"frames_checked": [first + j for j in picks],
                       "bytes_off": shares}

    if traced:
        t = {"kind": "view", "units": n_trace, "chips": 1,
             "busy_s": [summary["busy_s"]], "window_s": [summary["window_s"]]}
        s_n = len(summary["k1"])
        if s_n:
            works = [W.frame_work(params, S.ref_camera(
                S.orbit_view(cfg, tf, phase, first + j), dev))
                for j in range(s_n)]
            t.update(k1_bound_s=sum(W.bound_s(w["fwd"]) for w in works),
                     k1_s=sum(summary["k1"]),
                     needed_ops=float(np.mean([
                         W.view_ops(params["xyz"].shape[0], w)
                         for w in works])),
                     peak=W.PEAK_FP32)
        metrics = {}
        for m in cell.per_layer:
            val = reader(m["name"])(t)
            if val is not None:
                metrics[m["name"]] = {"value": val, "unit": m["unit"]}
        out["metrics"] = metrics
        out["busy_s"] = summary["busy_s"]
        out["traced_window_s"] = summary["window_s"]
        out["breakdown"] = {"device_ops": TR.top(summary["ops"]),
                            "idle_gaps": TR.top(summary["gaps"])}
    out["checks"] = checks
    return out
