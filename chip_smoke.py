#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (gs_tpu_torch) on one NVIDIA GPU and check it.

Usage, from the repository root on a machine with one CUDA card and nvcc:

    python3 chip_smoke.py

Phases (each failure exits non-zero):
 1. print the card's name and power limit; build every kernel from
    gs_tpu_torch/csrc (one nvcc per source, all at once) and the native
    COLMAP parser (g++); static SASS counts of K1, K1g, K3 and K4
    (shuffles, shared loads and stores; K4's short-run and long-run
    kernels each);
 2. K2 (expansion) against its plain version, bitwise: the three
    expansion test cases and the bench scene's [16, N] table into
    3,072,000 entries; kernel, plain and torch.repeat_interleave times;
 3. K1 (forward raster) against its plain version under the JAX package's
    backend rule (max |diff| < 2e-2, < 0.2 % of values beyond 1e-5): a
    300-gaussian 128x96 scene and one 1920x1080 frame; kernel and plain
    times, and the work the frame's data needs (for the bound); the
    (8x4 pixel block, entry) pairs the block skip removes on the frame,
    and K1's and K1g's registers, shared memory and spills;
 4. serve: the 500,000-gaussian bench scene (bench.py build_scene
    "uniform", rebuilt with the port) written as a trained-model directory,
    loaded back, 8 frames at 1920x1080 through gs_tpu_torch.render.render
    with the launch counts read around them, then the orbit CLI
    (gs_tpu_torch.apps.view_orbit) for 2 frames; one profiled frame;
    [bf16 serve]: the 8 frames again with bf16_features (colours and
    invdepth through the tile sort as bf16 pairs), each within 1e-2 of the
    f32 frame, K2 and K1 of one bf16 frame against their plain versions on
    their inputs, a zero-green copy of the scene whose sorted pair rows on
    the card are bitwise the CPU binning's (red survives), ms per frame
    against the f32 frame's, and the orbit CLI with --bf16_features;
 5. [K1g] K1's grad variant on the 300-gaussian scene, an opaque version of
    it where pixels stop, and the bench frame: its image bitwise K1's, its
    residual (one past each pixel's last composited entry) the plain
    version's but for at most 0.2 % of pixels at the T < 1e-4 cut;
 6. [K3] the raster backward against its plain version on the same three
    inputs with one upstream gradient drawn from a seed, each entry's row
    written where the binning's FoldPlan.dest puts it (its position before
    the tile sort), per feature row within 2e-4 * max |plain| (the JAX
    package's gradient rule) and bitwise from run to run; times, the work
    for the bound, the pairs the skip removes, and K3's registers, shared
    memory and spills;
 7. [K4] the gradient fold of the bench frame's K3 rows over the
    depth-ordered runs against segment_sum_runend (in float64) within
    1e-6 of the largest sum, and bitwise from run to run; a render under
    capacity overflow folds to zero; kernel, plain and torch index_add_
    times, the bytes bound, K3 and K4 back to back, and the registers,
    shared memory and spills of K4's two kernels; [K4 long]: K4 against
    its plain version in float64 (within 1e-6 of the largest sum, bitwise
    from run to run) on runs either side of its short-run limit and piece
    length, one run of every row, many long runs, long runs that overlap
    and long runs among 500,000 short ones; kernel, device (torch.profiler),
    plain and index_add_ times and the bound on the last two; one call
    on RAIN-like runs under torch.cuda.set_sync_debug_mode("error"), and
    the same call captured in a CUDA graph and replayed; [preprocess]: the
    preprocess kernel pair (csrc/preprocess.cu) against its twin at the
    train.m360-garden cell's 4,194,304 slots (70.6 % alive): the forward's
    fields (ints equal, floats within 1e-6, how many bitwise), the
    backward's gradient within 2e-4 of each row group's largest and
    bitwise from run to run, each kernel's and the twin's ms by CUDA
    events against the bytes bound, registers and spills; [adam]: Adam's
    kernel (csrc/adam.cu) against its twin at 4,194,304 slots, bitwise,
    dense and column-masked, in place and not; its ms and the twin's by
    CUDA events against the bytes bound; [ssim]: SSIM's kernel pair
    (csrc/ssim.cu) against its twins at garden's, playroom's and truck's
    frames, the value within 1e-6 and the gradient within 2e-4 of the
    largest, the same bits from run to run; each kernel's device ms and
    the twin's against the bytes and operations bounds, registers and
    spills;
 8. [train] 8 steps of the bench training configuration (bench.py's train
    probe: OptimizationConfig(iterations=30000), L1 + SSIM, Adam, a zero
    ground truth) through gs_tpu_torch.train.step.make_train_step after 2
    warm-up steps: the loss finite, falling and equal to REFERENCE_LOSSES
    to 5 significant digits, no overflow, K1g, K2, K3 and K4 launched once
    per step each; ms per step by host clock; stage times; the device's
    busy time per step, the median of 5 steps profiled one by one;
    [packed step]: the same step from one state in the packed [R, C] and
    the tree layout, 8 steps each in turns: losses within rtol 1e-5, the
    unpacked state within atol 2e-5 + rtol 1e-3, K1g, K2, K3 and K4 once
    per packed step and each held to its plain version on one step's
    inputs; ms per step, device busy, launches and the profiler's
    SelectBackward0, aten::add_, aten::stack and Adam rows of both;
    [bf16 step]: one packed step with bf16_features against f32 (loss
    within 5e-3, gradients within 5 % of the maximum for geometry, 2 % for
    SH); [packed mesh]: the packed step in MESH_K column shards against
    one device, each band's K2, K1g, K3 and K4 against plain;
 9. [grad] one step's parameter gradients on a 20,000-gaussian 256x192
    scene through the kernels against the plain binned path on the card,
    under the gradient rule;
10. [trainer] the training driver at full width: a COLMAP dataset of the
    bench scene (its 500,000 centres and colours in points3D.bin, 8 views
    at 1920x1080 around the bench camera's axis, 3 units behind it, each
    image the port's own K1 render of the scene) trained for 300 iterations
    through gs_tpu_torch.apps.train.main (-r 1, --eval, two densifies, one
    opacity reset, a --dup_capacity far below the frame's so the first
    sync overflows, grows the buffer and replays its window); checks: losses
    finite at every sync, the test PSNR up, a densify cloned or split,
    one launch each of K1g, K2, K3 and K4 per iteration over a steady
    window, the PLY and the checkpoint written, the checkpoint bitwise the
    trained state, a --start_checkpoint resume, the render and metrics
    CLIs' outputs; prints ms per iteration beside the bare step's, one
    profiled iteration's device busy time, the densify and replay times;
    [render CLI default]: the render CLI at its default --dup_capacity,
    which the test view overflows, renders it again (K2 and K1 twice) and
    writes the PNG an ample render writes, byte for byte; then the
    20,000-gaussian scene of [grad] trained twice, with an ample and a
    too-small --dup_capacity, to the same state; the CLI trains the packed
    layout, its default, and says so; [packed trainer]:
    Trainer(packed=True) against Trainer(packed=False) on the [trainer]
    dataset for 60 iterations through an overflow replay and a densify at
    50: equal alive masks, parameters under the Trainer rule, test PSNR
    within 1e-3 dB; ms per iteration, device busy and the profiler rows of
    both;
11. the multi-GPU path on this card, through an in-process group of
    MESH_K = 4 shards (gs_tpu_torch.parallel.mesh.LocalGroup): [mesh
    kernels] the bench frame through render_multichip under the "stride",
    "cost" and "cost" with split_rows 2 band assignments, the reassembled
    frame against the one-device K1 frame (bitwise expected: every tile
    composites the same entries in the same order), K2 and K1 launched once
    per band, each band's K1, K1g and K3 on its own inputs against their
    plain versions under the rules of phases 3-6, timed beside their bounds,
    and band_work max/mean per assignment, and K1, K1g and K3 of the full
    bench frame with the identity row map bitwise those without a map;
    [mesh step] the bench step with
    the state in 4 shards against the one-device step on the same state
    (loss, Adam's first moments and the densification statistics under the
    gradient rule), both timed in turns; [mesh trainer]
    Trainer(mesh=LocalGroup(4)) on the [trainer] dataset for 24 iterations
    through a densify and a visible_capacity overflow, growth and replay,
    against the one-device Trainer (equal alive masks, parameters under
    the Trainer rule of tests/test_torch_trainer.py, test PSNR), its launch
    counts read around the run, then [mesh trainer kernels] every K2 and
    K1 launch of one banded render_view and every K2, K1g, K3 and K4 launch
    of one more training step, each on the inputs (the band's row map
    among them) that the mesh Trainer gave it, against its plain version
    under the rules of phases 3-6; [mesh graph trainer]
    Trainer(mesh=LocalGroup(4)) on the [trainer] dataset for 30 iterations
    in step mode and in block mode through the chain (CUDA graphs of the
    banded step and its collectives), through a visible_capacity
    overflow, its replay and the capture its growth causes, and a
    densify: the graphed step mode and the chain bitwise the eager step
    mode in the losses
    at the syncs and the final state; host ms, device busy and idle,
    launches per iteration over one more block, every capture's ms and
    graph-pool peak; [mesh CLI] the training CLI over a real NCCL group
    (--mesh N with N cards, else --multihost with a group of one, saying
    which ran), in step mode and in its default block mode, whose NCCL
    collectives are captured: the two PLYs byte for byte equal, and (group
    of one) the densifies and test views through their graphs, which the
    group's close released before the run returned; [mesh view graph] the
    bench frame through Trainer.render_view under LocalGroup(4) (the
    banded view's CUDA graph, render.py::ViewGraph(mesh=...)) bitwise the
    eager view for the base view, a pose, an SH degree, a densify's state
    (then a second densify) and a visible_capacity and a dup_capacity
    overflow, each with the captures it should cause; host ms each way in
    turns, busy, idle, K2 and K1 per view (one per band), each capture;
12. [viewer], the viewer's path: the training CLI on the [trainer]
    dataset for 80 iterations with its viewer server on a free local port,
    and a client thread asking for 1920x1080 frames (two sent together
    with train=false, served before training resumes, then 8 more); every
    frame's shape and source path, one K2 and one K1 launch per frame and
    evaluated view beyond the trainer's own, the last iteration reached,
    and after training a frame over the wire bitwise Trainer.render_view;
    ms per frame on the client's clock, ms per iteration with the client
    attached and idle, the bytes per frame, a poll's cost with no client
    and with the client attached and idle; [viewer kernels]: at the run's
    shapes (the trained state, ~10 M entries), K2 and K1 of a render_view
    of the client's pose and K2, K1g, K3 and K4 of one more training step,
    each on the inputs it was given there, against its plain version
    under the rules of phases 2-7;
13. [lpips]: seeded random weights in the npz layout; LPIPS on the card
    against the same module on the CPU for a 256x192 pair (rel 1e-4, abs
    1e-6; an identical pair 0 within 1e-8), one 1080p pair timed against
    its FP32 bound, and the metrics CLI on the [trainer] model with a
    finite LPIPS; [metrics graph]: the metrics CLI's SSIM and LPIPS as
    CUDA graphs (utils/cuda_graphs.py::GraphedFunction) on 8 1080p views of
    the [trainer] model: results.json and per_view.json byte for byte the
    eager CLI's; ms per view each way in turns, busy, kernels, each
    function's CUDA-event ms, each capture's pool;
14. [full_eval]: gs_tpu_torch.apps.full_eval -tat over two scene folders
    that link to the [trainer] dataset, 30 iterations each at 1920x1080:
    each scene's cfg_args, PLY, test renders and results.json (SSIM, PSNR,
    LPIPS), and the wall time of each stage;
15. [native]: the [trainer] dataset's points3D.bin (500,000 records) read
    by the native C++ parser (gs_tpu_torch/native, built by g++ in phase 1)
    and by the per-record Python loop: equal arrays, the native route
    taken, both times;
16. [live], the live-capture path: 24 posed 1920x1080 frames (K1 renders
    of the bench scene from a helix through the [trainer] ellipse, each
    with a disjoint 1/24 of the bench centres as its local map) sent as
    JPEG by a publisher thread through FrameStreamClient to
    gs_tpu_torch.apps.train_live.main on a free local port
    (--use_local_maps --eval -r 1, 300 iterations, [trainer]'s densify
    schedule and grown --dup_capacity); checks: every frame arrives in
    order, each Scene camera's world_view is its rendering camera's within
    1e-5 of its largest entry, finite losses, the test PSNR up, a densify
    cloned or split, one launch each of K2, K1g, K3 and K4 per iteration
    over 252..299, the PLY written; prints frames per second received and
    decoded, the bootstrap's seconds, ms per iteration over 252..299 beside
    [trainer]'s and again with --quiet (the stat line's read-back);
    [live kernels]: K2 and K1 of a render_view and K2, K1g, K3 and K4 of one
    more step of the trained state against their plain versions;
17. [live rain]: the same frames without local maps, --init_points 100
    (the reference's RAIN-GS init: a few Gaussians each covering up to the
    whole frame), 300 iterations; checks the loss falls and the alive count
    rises at each densify; [live kernels] on iteration 2's inputs, and K4's
    (with torch index_add_ on the same rows, whose device time by
    torch.profiler K4's must not exceed) and K2's times there beside the
    bench frame's;
18. [convert_stream]: the [live] frames as a .gstream and as a
    visual_merged .bag, both converted by gs_tpu_torch.apps.convert_stream
    to the same cameras.txt and images.txt, the first trained 30 iterations
    through gs_tpu_torch.apps.train.main;
19. the block dispatch (gs_tpu_torch/train/graph.py, CUDA graphs of the
    step), after [bf16 step] and [packed trainer]: [graph step] the packed
    bench step eager twice and through the chain graph from one state for
    8 steps, the graph bitwise the eager run (or within the eager run's
    own run-to-run spread, if it has one), host ms, device busy, launches,
    the capture's ms and its graph pool's peak; [graph trainer] the
    [trainer] dataset through the training CLI's default block mode on
    CUDA (the chain) against --no_block_scan, 200 iterations from
    524,288 slots through the first sync's overflow replay and a growth
    to 4x at the densify at 100 (captured again): the losses at the syncs
    and the final states bitwise, ms per iteration, busy, idle, every
    capture, launches; [graph options] 30 iterations in block mode each
    with -d depths (K1-rendered inverse depths), --train_test_exp,
    --antialiasing, --optimizer_type sparse_adam, --random_background and
    views of unequal size: finite losses, the training views' L1 falling,
    one more step through the graph bitwise the eager step. Every earlier
    phase that trains through the CLI passes --no_block_scan, so it runs
    and measures step mode, which on CUDA replays one captured graph of
    the step per iteration (train/graph.py::ChainStep.step);
    [view graph], after [graph step]: the bench frame through the view's
    CUDA graph (render.py::ViewGraph, which Trainer.render_view, evaluate
    and the render CLI use on one device) bitwise every output of the
    eager render(), timed both ways, then a change of pose,
    scaling_modifier, SH degree, resolution, a densify's state and an
    overflowing view, each bitwise the eager view, each changing the image
    (but the overflow's), with the captures each should cause; [step
    graph], after [graph options]: the [trainer] dataset through the CLI's
    step mode, graphed against eager (the Trainer's private
    _eager_dispatch), 60 iterations through an opacity reset, a densify and
    an overflow replay with its recapture, and a --random_background pair:
    losses at every sync and the final state bitwise, ms, busy, idle,
    launches per iteration, captures, and a step's metrics unchanged after
    the next. The step-mode runs of [graph trainer] and [mesh graph
    trainer] are the eager step mode (the reference), the others replay;
    [live eager] and [live rain eager] run the trained live Trainer's step
    mode eager and graphed in turns, with the stat line's read-back; [viewer kernels], [live kernels] and
    [mesh trainer kernels] hold the kernels of an eager view and step, and
    the graphed view equal to that eager view bitwise; [render CLI default]
    also holds the CLI's PNG to an eager render_grown's and times the view
    graphed and eager; [density graph], after [step graph]: density
    control as CUDA graphs (train/graph.py::DensityGraph) on [trainer]'s
    checkpoint at 1,048,576 slots, packed and tree, one device and
    LocalGroup(4): densify and reset bitwise the eager functions for both
    use_size_threshold values, each timed both ways in turns, busy,
    kernels, captures; then the CLI in block mode for 60 iterations with a
    view after each densify and after the next block, density control
    eager (the parent's) against graphed: bitwise, and the view captures
    per densify of each;
20. a JSON line of the kernels' numbers (with each kernel's launches on
    every path, the mesh trainer's, the packed step's, the bf16 frames',
    the graph phases', the mesh graph trainer's, the step graph's, the
    view graph's and the mesh view graph's timed frames' among them), then
    the card's name and power limit, then the result line {"ok": true,
    "device": {...}}.

It exits non-zero without a CUDA device, or when run outside the repository.
"""
from __future__ import annotations

import contextlib
import ctypes
import io
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
W, H = 1920, 1080
N_GAUSS = 500_000
DUP_CAPACITY, MAX_PER_TILE = 3_072_000, 1024       # bench.py CAPS["uniform"]
TPU_NUM_DUPLICATES = 3_022_338                      # bench.py:100, same scene
FRAMES = 8
TRAIN_STEPS = 8
# [packed step]: the tree's Adam first moment, as a share of the quaternion
# group's largest, below which the kernel path's quaternions may leave the
# packed-against-tree rule after TRAIN_STEPS steps
QUAT_M_SHARE = 1e-2
# the preprocess kernel pair's launch counters (core/project.py), forward
# and backward, in main's counters beside K1..K4
PRE_IDS = ("PRE", "PRE_bwd")
# SSIM's kernel pair (ops/ssim.py), forward and backward: once a training
# step or replay, never in a view
SSIM_IDS = ("SSIM", "SSIM_bwd")
PROFILED_STEPS = 5
STAGE_REPLAYS = 5              # [train stages]: replays of the graphed step
HBM_BYTES_PER_S = 3.35e12                           # H100 SXM data sheet
FP32_OPS_PER_S = 67e12
# the bench training steps' losses on an NVIDIA H100 80GB HBM3 (700 W);
# the steps must give them again to 5 significant digits
REFERENCE_LOSSES = (0.560034, 0.552260, 0.544501, 0.536781, 0.529114,
                    0.521514, 0.513999, 0.506575)


def fail(msg: str):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond, msg: str):
    if not cond:
        fail(msg)


def images_match(x, y, boundary_frac=2e-3, boundary_atol=2e-2, atol=1e-5):
    """tests/test_rasterize.py::assert_images_match as a predicate: the
    T < 1e-4 cut can flip on float-associativity differences, so a tiny
    fraction of values may differ. Returns (ok, max diff, fraction)."""
    diff = (x.double() - y.double()).abs()
    mx = float(diff.max()) if diff.numel() else 0.0
    frac = float((diff > atol).double().mean()) if diff.numel() else 0.0
    return mx < boundary_atol and frac < boundary_frac, mx, frac


def busy_per_call(torch, fn, n: int = 1) -> tuple:
    """Device busy ms and kernels per call of ``fn``, over ``n`` calls
    under torch.profiler with device records only (the host records of a
    trainer's steps run to ~10^6 events): the sum of every kernel's and
    memset's time, and their count, over ``n``."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    kern = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    return (sum(e.self_device_time_total for e in kern) / 1e3 / n,
            sum(e.count for e in kern) / n)


def idle_text(busy: float, ms: float) -> str:
    return (f"idle {1 - busy / ms:.1%}" if busy > 0 else
            "the profiler saw no kernel (busy not measured)")


def host_ms_in_turns(torch, ways: dict, rounds: int) -> dict:
    """Host ms of each call of ``ways`` (name -> fn(i), i the call's count
    for that way), synchronised at both ends, in turns: each round calls
    the ways in order and then in reverse. Returns name -> [ms, ...]."""
    times = {k: [] for k in ways}
    order = list(ways) + list(ways)[::-1]
    for _ in range(rounds):
        for k in order:
            torch.cuda.synchronize()
            t = time.perf_counter()
            ways[k](len(times[k]))
            torch.cuda.synchronize()
            times[k].append(1e3 * (time.perf_counter() - t))
    return times


def time_ms(torch, fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of one call, by CUDA events around ``iters`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def expand_cases(block=256):
    """The three cases of tests/test_expand.py: (name, comb, offsets, capacity)."""
    def table(rng, counts, scale):
        offsets = (np.cumsum(counts) - counts).astype(np.int32)
        payload = rng.normal(0, scale, (14, counts.shape[0])).astype(np.float32)
        comb = np.concatenate([offsets[None].astype(np.float32),
                               counts[None].astype(np.float32), payload], 0)
        return comb, offsets

    cases = []
    for n, capacity in [(37, 1024), (300, 4096), (64, 512)]:
        rng = np.random.default_rng(5 + n)
        counts = rng.integers(1, 40, size=n).astype(np.int32)
        counts[n - int(n * 0.3):] = 0
        total = int(counts.sum())
        if total > capacity:
            counts = (counts * (capacity // 2) // total).astype(np.int32)
            counts = np.maximum(counts, np.where(np.arange(n) < n // 2, 1, 0))
        cases.append((f"random-{n}", *table(rng, counts, 3.0), capacity))
    rng = np.random.default_rng(11)
    counts = rng.integers(1, 12, size=200).astype(np.int32)
    cases.append(("truncation", *table(rng, counts, 1.0), 512))
    counts = np.array([3, 3 * block, 5, 0, 0, 0, 0, 0], np.int32)
    cases.append(("giant-run", *table(np.random.default_rng(1), counts, 1.0),
                  4 * block))
    return cases


def grads_match(got, ref, rel=2e-4):
    """The JAX package's gradient rule, per row of [R, ...] arrays: max
    |got - ref| <= rel * max |ref|. Returns (ok, worst ratio of error to
    max |ref|, max abs error)."""
    diff = (got.double() - ref.double()).abs().reshape(got.shape[0], -1)
    scale = ref.double().abs().reshape(ref.shape[0], -1).amax(1).clamp_min(1e-30)
    ratio = float((diff.amax(1) / scale).max())
    return ratio <= rel, ratio, float(diff.max())


def sass_counts(path: str) -> dict:
    """Static SASS instruction counts of the tile rasterizers and the fold
    in the kernel library at ``path`` (``cuobjdump -sass``): per kernel
    (K1, K1g, K3, the 10-row variants of K4's short-run kernel "K4" and
    long-run kernel "K4 long") the instructions in all, warp
    shuffles (SHFL), shared loads (LDS, of them 128-bit), shared stores
    (STS) and special-function ops (MUFU, expf and the reciprocal's seed).
    {} when the toolkit has no cuobjdump."""
    from gs_tpu_torch.ops import _cuda
    tool = os.path.join(os.path.dirname(_cuda.find_nvcc()), "cuobjdump")
    if not os.path.isfile(tool):
        return {}
    sass = subprocess.run([tool, "-sass", path], capture_output=True,
                          text=True, timeout=120).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            name = ("K1" if "raster_fwd_kernelILb0" in fn else
                    "K1g" if "raster_fwd_kernelILb1" in fn else
                    "K3" if "raster_bwd_kernel" in fn else
                    "K4" if "fold_short_kernelILi10E" in fn else
                    "K4 long" if "fold_long_kernelILi10E" in fn else None)
            if name:
                counts[name] = dict.fromkeys(
                    ("instructions", "SHFL", "LDS", "LDS.128", "STS", "MUFU"), 0)
            continue
        if name is None or "/*" not in line or ";" not in line:
            continue
        ins = line.split("*/", 1)[1].strip().split(";")[0].split()
        if not ins:
            continue
        op = ins[1] if ins[0].startswith("@") and len(ins) > 1 else ins[0]
        c = counts[name]
        c["instructions"] += 1
        for key in ("SHFL", "LDS", "STS", "MUFU"):
            if op.split(".")[0] == key:
                c[key] += 1
        if op.startswith("LDS.128"):
            c["LDS.128"] += 1
    return counts


def attributes_line(attrs, names):
    return "; ".join(
        f"{k}: {attrs[k]['registers']} registers, {attrs[k]['shared_bytes']} "
        f"B shared per CTA, {attrs[k]['local_bytes']} B local (spills) per "
        f"thread, {attrs[k]['ctas_per_sm']} CTAs of {attrs[k]['threads']} "
        f"threads per SM"
        for k in names)


def device_ms(torch, fn, iters: int, parts: dict | None = None) -> float:
    """Device time of one call, by torch.profiler over ``iters`` calls: the
    sum of the kernels and memsets it launched (each one's into ``parts``
    if given). Free of the host's launch rate, which sets CUDA-event times
    of calls shorter than their launch overhead. A profile that recorded
    no device activity at all (seen once for K4's 20 calls of a few us at
    [live rain]) is taken again, up to three times in all; none fails."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        rows = {e.key: e.self_device_time_total / 1e3 / iters
                for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA}
        if sum(rows.values()) > 0:
            break
    check(sum(rows.values()) > 0,
          "torch.profiler recorded no device activity in three profiles")
    if parts is not None:
        parts.update(rows)
    return sum(rows.values())


def bench_scene(torch, dev):
    """The bench scene: N_GAUSS seeded points in the camera's view, as
    create_from_pcd makes them, at 0.3 of its scales. Returns (points,
    colours, params, alive)."""
    from gs_tpu_torch.models.gaussian_model import create_from_pcd
    rng = np.random.default_rng(0)
    pts = np.concatenate([rng.uniform(-3.5, 3.5, (N_GAUSS, 1)),
                          rng.uniform(-2.0, 2.0, (N_GAUSS, 1)),
                          rng.uniform(2.5, 9.0, (N_GAUSS, 1))], axis=1)
    cols = rng.uniform(0, 1, (N_GAUSS, 3))
    cap = max(1024, -(-int(N_GAUSS * 1.02) // 1024) * 1024)
    params, alive = create_from_pcd(pts, cols, sh_degree=3, capacity=cap,
                                    device=dev)
    return (pts, cols, params._replace(
        log_scale=params.log_scale + math.log(0.3)), alive)


def bound_of(work_bytes, work_ops):
    b = work_bytes / HBM_BYTES_PER_S * 1e3
    o = work_ops / FP32_OPS_PER_S * 1e3
    return max(b, o), ("bytes" if b >= o else "operations"), b, o


def train_phases(torch, dev, small, scam, p0, alive0, bench_camera):
    """Phases 5-9: the training slice's kernels against their plain
    versions, the bench training steps and the gradient check. Returns the
    K1g, K3 and K4 entries of the kernels line, the bare step's median ms
    and the [grad] phase's 20,000-gaussian scene."""
    from gs_tpu_torch.config import (ModelConfig, OptimizationConfig,
                                     PipelineConfig, RasterConfig)
    from gs_tpu_torch.core.camera import make_camera, stack_cameras
    from gs_tpu_torch.core.gaussians import GaussianParams, inverse_sigmoid
    from gs_tpu_torch.core.project import preprocess
    from gs_tpu_torch.core.sh import rgb2sh
    from gs_tpu_torch.models.gaussian_model import init_state
    from gs_tpu_torch.ops.binning import bin_gaussians_payload, tile_grid
    from gs_tpu_torch.ops.expand import expand_rows
    from gs_tpu_torch.ops.fold import fold_rows, fold_rows_plain
    from gs_tpu_torch.ops.losses import l1_loss
    from gs_tpu_torch.ops.rasterize import (K3_OPS, block_skip_counts,
                                            kernel_attributes, max_chunks_for,
                                            raster_tiles_bwd,
                                            raster_tiles_bwd_plain,
                                            raster_tiles_bwd_work,
                                            raster_tiles_fwd,
                                            raster_tiles_fwd_plain,
                                            raster_tiles_fwd_save,
                                            raster_tiles_fwd_work)
    from gs_tpu_torch.ops.rasterize_plain import pack_projected
    from gs_tpu_torch.ops.segment import segment_sum_runend
    from gs_tpu_torch.ops.ssim import ssim
    from gs_tpu_torch.render import render
    from gs_tpu_torch.train.graph import TrainingData, make_train_step_chain
    from gs_tpu_torch.train.step import make_train_step
    from gs_tpu_torch.utils import spans

    counters = {"K2": expand_rows, "K1": raster_tiles_fwd,
                "K1g": raster_tiles_fwd_save, "K3": raster_tiles_bwd,
                "K4": fold_rows}

    def binned_inputs(params, cam, capacity, mpt, alive=None):
        with torch.no_grad():
            pr = preprocess(params, cam, active_sh_degree=3, alive=alive)
            bins, feats, plan = bin_gaussians_payload(
                pr, pack_projected(pr), cam.width, cam.height, 16, 16,
                capacity, exact_cull=True, fold_plan=True)
        check(not bool(bins.overflow), "binning overflow")
        gx, _ = tile_grid(cam.width, cam.height, 16, 16)
        return bins, plan, (feats, bins.tile_start, bins.tile_end, gx,
                            max_chunks_for(mpt))

    opaque = small._replace(
        logit_opacity=small.logit_opacity + 6.0,
        log_scale=small.log_scale + math.log(2.0))
    inputs = [("300 gaussians 128x96", small, scam, 1 << 14, 512, None),
              ("opaque 300 gaussians 128x96", opaque, scam, 1 << 14, 512, None),
              (f"bench frame {W}x{H}", p0, bench_camera(0), DUP_CAPACITY,
               MAX_PER_TILE, alive0)]
    k1g_err = k3_err = k3_ratio = 0.0
    with torch.no_grad():
        for label, params, cam, capacity, mpt, alive in inputs:
            bins, plan, args = binned_inputs(params, cam, capacity, mpt, alive)
            out_g, last = raster_tiles_fwd_save(*args)
            out = raster_tiles_fwd(*args)
            torch.cuda.synchronize()
            check(torch.equal(out_g, out), f"K1g image != K1 on {label}")
            out_p, last_p = raster_tiles_fwd_plain(*args, save=True)
            ok, mx, frac = images_match(out_g, out_p)
            differ = float((last != last_p).double().mean())
            stopped = float((out_g[:, 4] < 2e-4).double().mean())
            print(f"[K1g] {label}: image bitwise K1's; against the plain "
                  f"version max {mx:.3e}; residual differs on {differ:.4%} "
                  f"of pixels; {stopped:.1%} of pixels stopped", flush=True)
            check(ok and differ <= 2e-3, f"K1g residual on {label}")
            k1g_err = max(k1g_err, mx)
            del out_p, last_p, out
            rng = np.random.default_rng(11)
            dout = torch.tensor(rng.normal(0, 1, tuple(out_g.shape)),
                                dtype=torch.float32, device=dev)
            got = raster_tiles_bwd(*args, out_g, last, dout, plan.dest)
            torch.cuda.synchronize()
            again = raster_tiles_bwd(*args, out_g, last, dout, plan.dest)
            ref = raster_tiles_bwd_plain(*args, out_g, last, dout, plan.dest)
            ok, ratio, mx = grads_match(got.T, ref.T)
            print(f"[K3] {label}: worst row max |kernel - plain| / max "
                  f"|plain| {ratio:.3e} (rule 2e-4), max abs {mx:.3e}; "
                  f"repeat bitwise {torch.equal(got, again)}", flush=True)
            check(ok, f"K3 != plain on {label} (ratio {ratio})")
            check(torch.equal(got, again), f"K3 not deterministic on {label}")
            k3_err, k3_ratio = max(k3_err, mx), max(k3_ratio, ratio)
            del got, again, ref
        # the bench frame's inputs stay for the timings and for K4
        k1g_ms = time_ms(torch, lambda: raster_tiles_fwd_save(*args), 20)
        k1g_plain_ms = time_ms(torch, lambda: raster_tiles_fwd_plain(
            *args, save=True), 3, 1)
        w1 = raster_tiles_fwd_work(*args)
        num_tiles = args[1].shape[0]
        k1g_bound, k1g_by, _, _ = bound_of(w1["bytes"] + 4 * num_tiles * 256,
                                           w1["ops"])
        print(f"[K1g] bench frame: kernel {k1g_ms:.4f} ms, plain "
              f"{k1g_plain_ms:.4f} ms, bound {k1g_bound:.4f} ms ({k1g_by})",
              flush=True)
        bwd_args = (*args, out_g, last, dout, plan.dest)
        k3_ms = time_ms(torch, lambda: raster_tiles_bwd(*bwd_args), 20)
        k3_plain_ms = time_ms(torch, lambda: raster_tiles_bwd_plain(
            *bwd_args), 2, 1)
        w3 = raster_tiles_bwd_work(*args, last)
        k3_bound, k3_by, k3_b, k3_o = bound_of(w3["bytes"], w3["ops"])
        pairs = ", ".join(f"{w3[k]} {k} (x{K3_OPS[k]})" for k in K3_OPS)
        print(f"[K3] bench frame: {w3['entries']} entries read, pairs "
              f"visited: {pairs} = {w3['ops']} FP32 operations, "
              f"{w3['bytes']} bytes; kernel {k3_ms:.4f} ms, plain "
              f"{k3_plain_ms:.4f} ms, bound {k3_bound:.4f} ms (bytes "
              f"{k3_b:.4f}, operations {k3_o:.4f})", flush=True)
        skip = block_skip_counts(*args, last=last)
        attrs = kernel_attributes(dev)
        print(f"[K3] bench frame: the block skip removes "
              f"{skip['skipped']} of the {skip['pairs']} (8x4 block, entry) "
              f"pairs in front of each block's last composited entry "
              f"({skip['skipped'] / max(skip['pairs'], 1):.2%}; "
              f"ops/rasterize.py::block_skip_counts on the card); "
              + attributes_line(attrs, ["K3"]), flush=True)

        # ------------------------------------------------------------ 7
        # K3's rows sit at each entry's position before the tile sort: one
        # run per Gaussian, the runs in depth order
        d_entries = raster_tiles_bwd(*bwd_args)
        counts = bins.gauss_counts
        n = counts.shape[0]
        fold_args = (d_entries, plan.offsets, plan.counts, plan.gid)
        got = fold_rows(*fold_args)
        torch.cuda.synchronize()
        d_sorted = d_entries[plan.dest.to(torch.int64)]      # tile order
        ref64 = segment_sum_runend(d_sorted.double(), bins.entry_gid,
                                   counts, n)
        ref32 = segment_sum_runend(d_sorted, bins.entry_gid, counts, n)
        del d_sorted
        scale = float(ref64.abs().max())
        k4_err = float((got.double() - ref64).abs().max())
        err32 = float((ref32.double() - ref64).abs().max())
        again = fold_rows(*fold_args)
        print(f"[K4] bench frame: {n} gaussians, {int(bins.num_duplicates)} "
              f"entries, runs of up to {int(plan.counts.max())}; max |kernel "
              f"- segment_sum_runend (float64)| {k4_err:.3e} = "
              f"{k4_err / scale:.3e} of the largest sum (rule 1e-6); the "
              f"float32 segment_sum_runend is {err32 / scale:.3e} off; "
              f"repeat bitwise {torch.equal(got, again)}", flush=True)
        check(k4_err <= 1e-6 * scale, f"K4 != segment_sum_runend ({k4_err})")
        check(torch.equal(got, again), "K4 not deterministic")
        # index_add_ needs each entry's Gaussian in K3's row order
        gid_e = torch.full((d_entries.shape[0],), n, dtype=torch.int64,
                           device=dev)
        gid_e[plan.dest.to(torch.int64)] = bins.entry_gid.to(torch.int64)
        k4_ms = time_ms(torch, lambda: fold_rows(*fold_args), 20)
        k4_dev_ms = device_ms(torch, lambda: fold_rows(*fold_args), 20)
        k4_plain_ms = time_ms(torch, lambda: fold_rows_plain(*fold_args), 5)
        k4_lib_ms = time_ms(torch, lambda: torch.zeros(
            (n + 1, 10), device=dev).index_add_(0, gid_e, d_entries), 20)
        k34_ms = time_ms(torch, lambda: fold_rows(
            raster_tiles_bwd(*bwd_args), *fold_args[1:]), 20)
        # each row of a run read once, 12 B of offset, count and gid and
        # 40 B of sums per Gaussian; the index layout read 44 B per entry
        # and 48 B per Gaussian
        in_runs = min(int(bins.num_duplicates), d_entries.shape[0])
        k4_bound, k4_by, _, _ = bound_of(in_runs * 40 + n * (12 + 40),
                                         in_runs * 10)
        k4_index_bound = (in_runs * 44 + n * 48) / HBM_BYTES_PER_S * 1e3
        print(f"[K4] bench frame: kernel {k4_ms:.4f} ms (device "
              f"{k4_dev_ms:.4f} ms by torch.profiler), plain "
              f"{k4_plain_ms:.4f} ms, index_add_ {k4_lib_ms:.4f} ms, bound "
              f"{k4_bound:.4f} ms ({k4_by}; {k4_bound / k4_ms:.1%} of it; "
              f"the index layout's bytes {k4_index_bound:.4f} ms); K3 then "
              f"K4 {k34_ms:.4f} ms (K3 {k3_ms:.4f} + K4 {k4_ms:.4f}); "
              + attributes_line(attrs, ["K4", "K4 long"]), flush=True)
        del (got, again, ref64, ref32, d_entries, fold_args, gid_e, bins,
             plan, args, bwd_args, out_g, last, dout)

    # a render under capacity overflow: the fold runs and returns zeros
    leaves = [t.clone().requires_grad_(True) for t in small]
    before = fold_rows.launches
    out = render(scam, GaussianParams(*leaves), torch.zeros(3, device=dev),
                 active_sh_degree=3, dup_capacity=512, max_per_tile=512,
                 exact_cull=True)
    grads = torch.autograd.grad(out.image.sum(), leaves, allow_unused=True)
    total = sum(float(g.abs().sum()) for g in grads if g is not None)
    print(f"[K4] overflow render: overflow {bool(out.overflow)}, fold "
          f"launches {fold_rows.launches - before}, |parameter gradients| "
          f"{total}", flush=True)
    check(bool(out.overflow) and total == 0.0
          and fold_rows.launches - before == 1, "overflow gradients")

    # ---------------------------------------------------------------- 8
    opt = OptimizationConfig(iterations=30_000)
    raster = RasterConfig(backend="auto", dup_capacity=DUP_CAPACITY,
                          max_per_tile=MAX_PER_TILE, chunk=64, exact_cull=True)
    cams = stack_cameras([bench_camera(0)])
    step = make_train_step(opt, ModelConfig(), PipelineConfig(), raster, cams,
                           spatial_lr_scale=1.0, max_sh_degree=3)
    state = init_state(p0, alive0, num_images=1)
    gt = torch.zeros((3, H, W), device=dev)
    for it in (1, 2):                                   # warm-up
        state, _ = step(state, 0, gt, iteration=it)
    torch.cuda.synchronize()
    for c in counters.values():
        c.launches = 0
    metrics, step_s = [], []
    for it in range(3, 3 + TRAIN_STEPS):
        t0 = time.perf_counter()
        state, m = step(state, 0, gt, iteration=it)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        metrics.append(m)
    launches = {k: c.launches for k, c in counters.items()}
    losses = [float(m.loss) for m in metrics]
    print(f"[train] {TRAIN_STEPS} steps at {W}x{H}, {N_GAUSS} gaussians: loss "
          + ", ".join(f"{x:.6f}" for x in losses), flush=True)
    print(f"[train] ms per step (host clock, synchronised): "
          + ", ".join(f"{1e3 * x:.2f}" for x in step_s)
          + f"; median {1e3 * float(np.median(step_s)):.3f}, max "
          f"{1e3 * max(step_s):.3f}", flush=True)
    print(f"[train] launches over the {TRAIN_STEPS} steps: {launches}; "
          f"num_duplicates {int(metrics[-1].num_duplicates)}, max_tile_len "
          f"{int(metrics[-1].max_tile_len)}, visible "
          f"{int(metrics[-1].n_visible)}", flush=True)
    check(all(math.isfinite(x) for x in losses), "non-finite loss")
    check(all(b < a for a, b in zip(losses, losses[1:])), "loss not falling")
    check(all(abs(x - r) <= 1e-5 * r for x, r in zip(losses, REFERENCE_LOSSES)),
          f"losses {losses} != REFERENCE_LOSSES to 5 significant digits")
    check(not any(bool(m.overflow) for m in metrics), "training overflow")
    check(all(launches[k] == TRAIN_STEPS for k in ("K1g", "K2", "K3", "K4"))
          and launches["K1"] == 0, f"train launches {launches}")

    # where a step's time goes: the program's stage stamps inside a
    # graphed step (utils/spans.py), the chain's replay of this step
    chain = make_train_step_chain(step, use_alpha=False, use_depth=False)
    row = np.concatenate([step.schedule(11)[0], np.zeros(3, np.float32)])
    chain.load(torch.tensor([[0, 11]]), torch.from_numpy(row)[None], [11])
    data = TrainingData(gt[None])
    chain(state, data, 0)                              # the capture
    for _ in range(STAGE_REPLAYS):
        chain(chain.state, data, 0)
    stages = spans.stage_means(last=STAGE_REPLAYS, unit="step")
    print(f"[train stages] ms per stage of the graphed step by its stage "
          f"stamps (the mean of {STAGE_REPLAYS} replays): " + ", ".join(
              f"{k} {v:.4f}" for k, v in stages.items())
          + f"; all {sum(stages.values()):.4f}; the bench frame's K1g "
          f"{k1g_ms:.4f}, K3 {k3_ms:.4f}, K4 {k4_ms:.4f} by CUDA events",
          flush=True)
    check(list(stages) == ["step", "preprocess", "binning", "raster", "loss",
                           "loss_bwd", "raster_bwd", "preprocess_bwd",
                           "update"], f"train stages {list(stages)}")
    chain.release()
    del chain, data

    from torch.profiler import ProfilerActivity, profile
    # one step's device time moves by ~2 % from run to run: profile several
    # steps one by one and take the median
    busy = []
    for _ in range(PROFILED_STEPS):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            step(state, 0, gt, iteration=11)
            torch.cuda.synchronize()
        events = prof.key_averages()
        run = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA]
        busy.append(sum(e.self_device_time_total for e in run) / 1e3)
    busy_ms = float(np.median(busy))
    step_ms = 1e3 * float(np.median(step_s))
    print(f"[train profile] one step: device busy {busy_ms:.4f} ms, the "
          f"median of {PROFILED_STEPS} steps profiled one by one ("
          + ", ".join(f"{x:.4f}" for x in busy) + f"), in "
          f"{sum(e.count for e in run)} kernel launches; against the "
          f"{step_ms:.3f} ms median step the device is idle "
          f"{1 - busy_ms / step_ms:.1%}; the table is the last step's",
          flush=True)
    print(events.table(sort_by="cuda_time_total", row_limit=15,
                       max_name_column_width=60), flush=True)
    del state, leaves

    # ---------------------------------------------------------------- 9
    rng = np.random.default_rng(9)
    n = 20_000
    mid = GaussianParams(
        xyz=torch.tensor(np.concatenate([rng.uniform(-2, 2, (n, 1)),
                                         rng.uniform(-1.5, 1.5, (n, 1)),
                                         rng.uniform(3, 6, (n, 1))], 1),
                         dtype=torch.float32, device=dev),
        sh_dc=rgb2sh(torch.tensor(rng.uniform(0, 1, (n, 1, 3)),
                                  dtype=torch.float32, device=dev)),
        sh_rest=torch.tensor(rng.normal(0, 0.02, (n, 15, 3)),
                             dtype=torch.float32, device=dev),
        log_scale=torch.tensor(rng.uniform(-4.5, -2.5, (n, 3)),
                               dtype=torch.float32, device=dev),
        quat=torch.tensor(rng.normal(0, 1, (n, 4)) + [2, 0, 0, 0],
                          dtype=torch.float32, device=dev),
        logit_opacity=inverse_sigmoid(torch.tensor(
            rng.uniform(0.2, 0.95, (n, 1)), dtype=torch.float32, device=dev)))
    mcam = make_camera(np.eye(3), np.zeros(3), math.radians(60),
                       2 * math.atan(math.tan(math.radians(30)) * 192 / 256),
                       256, 192, device=dev)
    mgt = torch.tensor(rng.uniform(0, 1, (3, 192, 256)), dtype=torch.float32,
                       device=dev)

    def step_grads(backend):
        leaves = [t.clone().requires_grad_(True) for t in mid]
        out = render(mcam, GaussianParams(*leaves),
                     torch.zeros(3, device=dev), active_sh_degree=3,
                     backend=backend, dup_capacity=1 << 20, max_per_tile=4096,
                     exact_cull=True)
        check(not bool(out.overflow), f"[grad] {backend} overflow")
        loss = 0.8 * l1_loss(out.image, mgt) + 0.2 * (1.0 - ssim(out.image, mgt))
        return float(loss.detach()), torch.autograd.grad(loss, leaves)

    before = {k: c.launches for k, c in counters.items()}
    loss_k, g_k = step_grads("cuda")
    ran = {k: c.launches - before[k] for k, c in counters.items()}
    loss_p, g_p = step_grads("binned")
    worst = 0.0
    for name, a, b in zip(GaussianParams._fields, g_k, g_p):
        ok, ratio, _ = grads_match(a[None], b[None])
        worst = max(worst, ratio)
        check(ok, f"[grad] {name}: kernels vs plain {ratio} > 2e-4")
    print(f"[grad] 20000 gaussians 256x192, L1 + SSIM: loss {loss_k:.7f} "
          f"through the kernels ({ran}), {loss_p:.7f} through the plain binned "
          f"path; worst parameter group max |diff| / max |plain| "
          f"{worst:.3e} (rule 2e-4)", flush=True)
    check(abs(loss_k - loss_p) <= 1e-5 * abs(loss_p), "[grad] loss")

    return step_ms, mid, [
        {"name": "raster_tiles_fwd_save", "id": "K1g", "route": "cuda",
         "source": "gs_tpu_torch/csrc/rasterize_fwd.cu",
         "replaces": "gs_tpu/ops/rasterize_pallas.py:125",
         "launches": launches["K1g"], "max_abs_err": k1g_err,
         "ms": k1g_ms, "kernel_ms": k1g_ms, "plain_ms": k1g_plain_ms,
         "bound_ms": k1g_bound, "bound_by": k1g_by, "library_ms": None},
        {"name": "raster_tiles_bwd", "id": "K3", "route": "cuda",
         "source": "gs_tpu_torch/csrc/rasterize_bwd.cu",
         "replaces": "gs_tpu/ops/rasterize_pallas.py:243",
         "launches": launches["K3"], "max_abs_err": k3_err,
         "ms": k3_ms, "kernel_ms": k3_ms, "plain_ms": k3_plain_ms,
         "bound_ms": k3_bound, "bound_by": k3_by, "library_ms": None},
        {"name": "fold_rows", "id": "K4", "route": "cuda",
         "source": "gs_tpu_torch/csrc/fold.cu",
         "replaces": "gs_tpu/ops/fold_pallas.py:50",
         "launches": launches["K4"], "max_abs_err": k4_err,
         "ms": k4_ms, "kernel_ms": k4_ms, "device_ms": k4_dev_ms,
         "plain_ms": k4_plain_ms, "bound_ms": k4_bound, "bound_by": k4_by,
         "library_ms": k4_lib_ms},
    ]


def k4_long_phase(torch, dev):
    """[K4 long]: K4 on tests/torch_fold_cases.py's LONG_RUN_CASES (the
    card tests' shapes) against fold_rows_plain in float64 (within 1e-6 of
    the largest sum) and bitwise from run to run; kernel, device, plain and
    index_add_ times and the bytes bound on "many-long" and "mixed"; on
    the RAIN-like runs, one call that must not synchronise the host and
    the call captured in a CUDA graph, replayed to the same bits. Returns
    K4's largest error and the "mixed" numbers for the kernels line."""
    from gs_tpu_torch.ops.fold import (PIECE_ROWS, SHORT_RUN_ROWS, fold_rows,
                                       fold_rows_plain)
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from torch_fold_cases import (LONG_RUN_CASES, long_run_case,
                                  rain_like_runs)
    worst, numbers = 0.0, {}
    for name in LONG_RUN_CASES:
        args = tuple(torch.from_numpy(a).to(dev) for a in long_run_case(name))
        data, offsets, counts, gid = args
        got = fold_rows(*args)
        torch.cuda.synchronize()
        ref = fold_rows_plain(data.double(), offsets, counts, gid)
        scale = float(ref.abs().max())
        err = float((got.double() - ref).abs().max())
        same = torch.equal(got, fold_rows(*args))
        e = data.shape[0]
        lo = offsets.to(torch.int64).clamp(0, e)
        c = ((offsets.to(torch.int64) + counts).clamp(0, e) - lo).clamp_min(0)
        n_long = int((c > SHORT_RUN_ROWS).sum())
        pieces = int(((c[c > SHORT_RUN_ROWS] + PIECE_ROWS - 1)
                      // PIECE_ROWS).sum())
        line = (f"[K4 long] {name}: {c.shape[0]} runs, {n_long} longer than "
                f"{SHORT_RUN_ROWS} rows in {pieces} pieces of up to "
                f"{PIECE_ROWS}, the longest {int(c.max())}, {data.shape[0]} "
                f"rows; max |kernel - plain (float64)| {err:.3e} = "
                f"{err / scale:.3e} of the largest sum (rule 1e-6); repeat "
                f"bitwise {same}")
        check(err <= 1e-6 * scale, f"[K4 long] {name}: K4 != plain ({err})")
        check(same, f"[K4 long] {name}: K4 not deterministic")
        worst = max(worst, err)
        if name in ("many-long", "mixed"):
            n, rows = c.shape[0], int(c.sum())
            k4_ms = time_ms(torch, lambda: fold_rows(*args), 20)
            k4_dev = device_ms(torch, lambda: fold_rows(*args), 20)
            plain_ms = time_ms(torch, lambda: fold_rows_plain(*args), 5)
            # index_add_ needs each row's Gaussian: the runs lie back to
            # back from row 0
            gid_rows = torch.repeat_interleave(gid.to(torch.int64), c)
            run_rows = data[:rows]
            lib_ms = time_ms(torch, lambda: torch.zeros(
                (n, 10), device=dev).index_add_(0, gid_rows, run_rows), 20)
            bound, by, _, _ = bound_of(rows * 40 + n * (12 + 40), rows * 10)
            line += (f"; kernel {k4_ms:.4f} ms (device {k4_dev:.4f} ms by "
                     f"torch.profiler), plain {plain_ms:.4f} ms, index_add_ "
                     f"{lib_ms:.4f} ms, bound {bound:.4f} ms ({by}, "
                     f"{bound / k4_dev:.1%} of the device time)")
            numbers = {"long_ms": k4_ms, "long_device_ms": k4_dev,
                       "long_plain_ms": plain_ms, "long_bound_ms": bound,
                       "long_library_ms": lib_ms}
        print(line, flush=True)
    # no host synchronisation: the step is meant for CUDA-graph capture,
    # which also refuses a synchronising or uncapturable call of the C entry
    args = tuple(torch.from_numpy(a).to(dev) for a in rain_like_runs())
    got = fold_rows(*args)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fold_rows(*args)
    except RuntimeError as exc:
        fail(f"[K4 long] fold_rows synchronised the host: {exc}")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph):
            captured = fold_rows(*args)
    except RuntimeError as exc:
        fail(f"[K4 long] fold_rows cannot be captured in a CUDA graph: {exc}")
    captured.zero_()
    graph.replay()
    torch.cuda.synchronize()
    check(torch.equal(captured, got),
          "[K4 long] fold_rows replayed from a CUDA graph != its launch")
    print("[K4 long] RAIN-like runs: fold_rows under set_sync_debug_mode("
          "'error'): no synchronisation; captured in a CUDA graph and "
          "replayed: bitwise the launch", flush=True)
    del graph, captured
    return worst, numbers


# [preprocess]: the train.m360-garden cell's slots, alive share, image and
# focal length (benchmark/configs/m360-garden.json)
PRE_SLOTS, PRE_ALIVE = 4_194_304, 2_960_000
PRE_W, PRE_H, PRE_FOCAL = 1297, 840, 1040.0


def preprocess_phase(torch, dev):
    """[preprocess]: the kernel pair of csrc/preprocess.cu against its twin
    (core/project.py::preprocess_packed_plain) at PRE_SLOTS slots of SH
    degree 3, PRE_ALIVE alive, seeded Gaussians in front of a PRE_W x PRE_H
    camera, antialiasing on, the SH ramp at degree 3. The forward's fields
    against the twin's (ints and bools equal, floats within 1e-6 of each
    field's largest on the alive slots; how many are bitwise), the
    backward's gradient from the cotangents a render gives (seeded, on the
    visible slots only) within 2e-4 of each row group's largest and
    bitwise from run to run; each kernel's time by CUDA events against the
    twin's (its backward alone: autograd over one retained graph) and the
    bytes bound; the kernels' registers and spills. Returns the numbers."""
    from gs_tpu_torch.core import packed as pk
    from gs_tpu_torch.core import project
    from gs_tpu_torch.core.camera import focal2fov, make_camera
    lay = pk.layout(3)
    c, n_alive = PRE_SLOTS, PRE_ALIVE
    n0 = (project.preprocess_fwd.launches, project.preprocess_bwd.launches)
    g = torch.Generator(device=dev).manual_seed(18)

    def uniform(lo, hi, *shape):
        return torch.rand(shape, generator=g, device=dev) * (hi - lo) + lo

    z = uniform(1.5, 13.5, c)
    block = torch.zeros((lay.rows, c), device=dev)
    block[0] = uniform(-0.75, 0.75, c) * z
    block[1] = uniform(-0.5, 0.5, c) * z
    block[2] = z
    block[3:6] = torch.randn((3, c), generator=g, device=dev) * 0.5
    block[6:lay.log_scale] = torch.randn((3 * lay.rest, c), generator=g,
                                         device=dev) * 0.1
    block[lay.log_scale:lay.quat] = uniform(-6.0, -3.0, 3, c)
    block[lay.quat:lay.logit_opacity] = torch.randn((4, c), generator=g,
                                                    device=dev)
    block[lay.quat] += 1.5
    block[lay.logit_opacity] = uniform(-4.0, 4.0, c)
    alive = torch.zeros(c, dtype=torch.bool, device=dev)
    alive[torch.randperm(c, generator=g, device=dev)[:n_alive]] = True
    cam = make_camera(np.eye(3), np.zeros(3), focal2fov(PRE_FOCAL, PRE_W),
                      focal2fov(PRE_FOCAL, PRE_H), PRE_W, PRE_H, device=dev)
    mask = torch.tensor(3, device=dev)
    kw = dict(sh_degree=3, active_sh_degree=3, antialiasing=True,
              alive=alive, mask_degree=mask)
    fields = ("mean2d", "conic", "depth", "rgb", "opacity")
    with torch.no_grad():
        got = project.preprocess_packed(block, cam, **kw)
        want = project.preprocess_packed_plain(block, cam, **kw)
    torch.cuda.synchronize()
    for f in ("radius", "visible", "radius_cull"):
        check(torch.equal(getattr(got, f), getattr(want, f)),
              f"[preprocess] {f} != the twin's")
    bitwise, worst_f = [], 0.0
    for f in fields:
        a, b = getattr(got, f)[alive], getattr(want, f)[alive]
        scale = float(b.abs().max())
        err = float((a - b).abs().max())
        check(err <= 1e-6 * scale, f"[preprocess] {f}: {err} of {scale}")
        check(not bool(getattr(got, f)[~alive].any()),
              f"[preprocess] {f} not zero on the dead slots")
        worst_f = max(worst_f, err / scale)
        if torch.equal(a, b):
            bitwise.append(f)
    visible = got.visible
    n_vis = int(visible.sum())
    cts = []
    for f in fields:
        x = getattr(got, f)
        v = visible.reshape((c,) + (1,) * (x.dim() - 1))
        cts.append(torch.randn(x.shape, generator=g, device=dev) * v)
    leaf = block.clone().requires_grad_(True)
    outs = project.preprocess_packed(leaf, cam, **kw)
    grad = torch.autograd.grad([getattr(outs, f) for f in fields], [leaf],
                               grad_outputs=cts)[0]
    outs = project.preprocess_packed(leaf, cam, **kw)
    again = torch.autograd.grad([getattr(outs, f) for f in fields], [leaf],
                                grad_outputs=cts)[0]
    twin = project.preprocess_packed_plain(leaf, cam, **kw)
    twin_grad = torch.autograd.grad([getattr(twin, f) for f in fields],
                                    [leaf], grad_outputs=cts,
                                    retain_graph=True)[0]
    torch.cuda.synchronize()
    differ = grad.ne(again) & ~(grad.isnan() & again.isnan())
    check(not bool(differ.any()),
          f"[preprocess] backward not deterministic: {int(differ.sum())} "
          f"entries in rows {differ.any(1).nonzero().flatten().tolist()}, "
          f"columns {differ.any(0).nonzero().flatten()[:8].tolist()}; NaN "
          f"{int(grad.isnan().sum())} / {int(again.isnan().sum())}")
    check(not bool(grad.isnan().any()), "[preprocess] NaN in the gradient")
    check(not bool(grad[lay.n_channels:].any()),
          "[preprocess] padding rows of the gradient not zero")
    worst_g = 0.0
    for a, b in ((0, 3), (3, 6), (6, lay.log_scale),
                 (lay.log_scale, lay.quat), (lay.quat, lay.logit_opacity),
                 (lay.logit_opacity, lay.n_channels)):
        ref = twin_grad[a:b]
        scale = float(ref.abs().max())
        err = float((grad[a:b] - ref).abs().max())
        check(err <= 2e-4 * scale,
              f"[preprocess] gradient rows {a}:{b}: {err} of {scale}")
        worst_g = max(worst_g, err / scale)

    cam_t = [getattr(cam, k).contiguous() for k in project.CAMERA_TENSORS]
    st = project._Static(3, 3, True, PRE_W, PRE_H)
    one = torch.ones((), device=dev)
    with torch.no_grad():
        fwd_ms = time_ms(torch, lambda: project.preprocess_fwd(
            block, cam_t, alive, mask, one, st), 20)
        bwd_ms = time_ms(torch, lambda: project.preprocess_bwd(
            block, cam_t, alive, mask, one, st, cts), 20)
        twin_fwd_ms = time_ms(torch, lambda: project.preprocess_packed_plain(
            block, cam, **kw), 5)
    twin_bwd_ms = time_ms(torch, lambda: torch.autograd.grad(
        [getattr(twin, f) for f in fields], [leaf], grad_outputs=cts,
        retain_graph=True), 5)
    nonzero = int(torch.stack([t.reshape(c, -1).ne(0).any(1)
                               for t in cts]).any(0).sum())
    rows_b = lay.n_channels * 4
    fwd_bytes = c + n_alive * rows_b + c * 53
    bwd_bytes = c + n_alive * 40 + nonzero * rows_b + c * lay.rows * 4
    fwd_bound = fwd_bytes / HBM_BYTES_PER_S * 1e3
    bwd_bound = bwd_bytes / HBM_BYTES_PER_S * 1e3
    attrs = (ctypes.c_int * 10)()
    fn = project._cuda.function(project.KERNEL_SOURCE,
                                "gs_preprocess_kernel_attributes",
                                [ctypes.c_int, ctypes.c_void_p])
    project._cuda.check(project.KERNEL_SOURCE,
                        fn(dev.index or 0, ctypes.addressof(attrs)),
                        "attributes")
    a = list(attrs)
    print(f"[preprocess] {c} slots ({n_alive} alive, {n_vis} visible, "
          f"{nonzero} with a cotangent), SH 3, {PRE_W}x{PRE_H}: fields "
          f"bitwise the twin's: {', '.join(bitwise) or 'none'} (ints and "
          f"bools equal; worst float {worst_f:.3e} of its field's largest); "
          f"gradient worst {worst_g:.3e} of its row group's largest, bitwise "
          f"from run to run", flush=True)
    print(f"[preprocess] forward: kernel {fwd_ms:.4f} ms, twin "
          f"{twin_fwd_ms:.4f} ms, bound {fwd_bound:.4f} ms ({fwd_bytes} "
          f"bytes, {fwd_bound / fwd_ms:.1%}); backward: kernel {bwd_ms:.4f} "
          f"ms, twin {twin_bwd_ms:.4f} ms, bound {bwd_bound:.4f} ms "
          f"({bwd_bytes} bytes, {bwd_bound / bwd_ms:.1%}); forward "
          f"{a[0]} registers, {a[2]} B spills, {a[3]} CTAs of {a[4]} per "
          f"SM; backward {a[5]} registers, {a[7]} B spills, {a[8]} CTAs of "
          f"{a[9]} per SM", flush=True)
    del twin, outs, leaf
    return {"fwd_ms": fwd_ms, "bwd_ms": bwd_ms, "twin_fwd_ms": twin_fwd_ms,
            "twin_bwd_ms": twin_bwd_ms, "fwd_bound_ms": fwd_bound,
            "bwd_bound_ms": bwd_bound, "max_rel_err": max(worst_f, worst_g),
            "fwd_launches": project.preprocess_fwd.launches - n0[0],
            "bwd_launches": project.preprocess_bwd.launches - n0[1]}


ADAM_SLOTS = 4_194_304


def adam_phase(torch, dev):
    """[adam]: the kernel of csrc/adam.cu against its twin
    (models/packed_state.py::adam_update_packed_plain) at ADAM_SLOTS slots
    of SH degree 3, from seeded parameters, moments and gradient at Adam's
    step 20,000: every output bitwise the twin's, dense and column-masked
    (about half the columns), out of place and in place; the in-place
    kernel's time by CUDA events, dense and masked,
    against the twin's and the bytes bound (7 x 4 B x R x C); the kernel's
    registers. Returns the numbers."""
    from gs_tpu_torch.config import OptimizationConfig
    from gs_tpu_torch.core import packed as pk
    from gs_tpu_torch.models import packed_state as P
    from gs_tpu_torch.ops import _cuda
    from gs_tpu_torch.ops import adam as A
    lay, c = pk.layout(3), ADAM_SLOTS
    g = torch.Generator(device=dev).manual_seed(21)

    def randn(scale):
        return torch.randn((lay.rows, c), generator=g, device=dev) * scale

    zeros = torch.zeros(c, device=dev)
    ps = P.PackedState(
        packed=randn(1.0), alive=torch.ones(c, dtype=torch.bool, device=dev),
        m=randn(1e-4), v=randn(1e-4) ** 2,
        step=torch.tensor(20_000, dtype=torch.int32, device=dev),
        grad_accum=zeros, denom=zeros,
        max_radii2D=zeros.to(torch.int32),
        exposure=torch.zeros((1, 3, 4), device=dev),
        exp_m=torch.zeros((1, 3, 4), device=dev),
        exp_v=torch.zeros((1, 3, 4), device=dev),
        exp_step=torch.zeros((), dtype=torch.int32, device=dev))
    grad = randn(1e-4)
    lr = P.group_lr_rows(lay, OptimizationConfig(), 20_001, 1.0, device=dev)
    half = torch.rand(c, generator=g, device=dev) < 0.535
    n0 = A.adam_packed.launches

    def bitwise(a, b):
        return all(torch.equal(x.view(torch.int32), y.view(torch.int32))
                   for x, y in ((a.packed, b.packed), (a.m, b.m),
                                (a.v, b.v))) and torch.equal(a.step, b.step)

    def fresh():
        return ps._replace(packed=ps.packed.clone(), m=ps.m.clone(),
                           v=ps.v.clone(), step=ps.step.clone())

    for mask in (None, half):
        want = P.adam_update_packed_plain(ps, grad, lr, mask)
        got = P.adam_update_packed(ps, grad, lr, mask)
        inplace = P.adam_update_packed(fresh(), grad, lr, mask, inplace=True)
        what = "dense" if mask is None else "masked"
        check(bitwise(got, want), f"[adam] {what}: kernel != twin")
        check(bitwise(inplace, want), f"[adam] {what} in place: kernel != twin")
        del want, got, inplace
    work = fresh()
    dense_ms = time_ms(torch, lambda: P.adam_update_packed(
        work, grad, lr, inplace=True), 20)
    masked_ms = time_ms(torch, lambda: P.adam_update_packed(
        work, grad, lr, half, inplace=True), 20)
    twin_ms = time_ms(torch, lambda: P.adam_update_packed_plain(
        work, grad, lr, inplace=True), 5)
    twin_masked_ms = time_ms(torch, lambda: P.adam_update_packed_plain(
        work, grad, lr, half, inplace=True), 5)
    work_bytes = 7 * 4 * lay.rows * c
    bound = work_bytes / HBM_BYTES_PER_S * 1e3
    attrs = (ctypes.c_int * 5)()
    fn = _cuda.function(A.SOURCE, "gs_adam_packed_attributes",
                        [ctypes.c_int, ctypes.c_void_p])
    _cuda.check(A.SOURCE, fn(dev.index or 0, ctypes.addressof(attrs)),
                "attributes")
    a = list(attrs)
    print(f"[adam] {c} slots, SH 3: the kernel bitwise the twin, dense and "
          f"masked ({int(half.sum())} columns), out of place and in place",
          flush=True)
    print(f"[adam] in place: dense kernel {dense_ms:.4f} ms, masked "
          f"{masked_ms:.4f} ms; twin dense {twin_ms:.4f} ms, masked "
          f"{twin_masked_ms:.4f} ms; bound {bound:.4f} ms ({work_bytes} "
          f"bytes; dense {bound / dense_ms:.1%}, masked "
          f"{bound / masked_ms:.1%}); {a[0]} registers, {a[2]} B spills, "
          f"{a[3]} CTAs of {a[4]} per SM", flush=True)
    del work, ps, grad
    return {"dense_ms": dense_ms, "masked_ms": masked_ms, "twin_ms": twin_ms,
            "twin_masked_ms": twin_masked_ms, "bound_ms": bound,
            "launches": A.adam_packed.launches - n0}


# the training cells' frames, [C, H, W]: m360-garden, db-playroom, tandt-truck
SSIM_FRAMES = {"garden": (3, 840, 1297), "playroom": (3, 832, 1264),
               "truck": (3, 546, 979)}


def ssim_phase(torch, dev):
    """[ssim]: the kernel pair of csrc/ssim.cu against its twins
    (ops/ssim.py::ssim_plain under autograd, ssim_backward_plain) at the
    SSIM_FRAMES, from seeded image pairs (a photo and a render near it):
    the value within 1e-6 of the twin's, the gradient within 2e-4 of the
    largest of autograd's, both the same bits from run to run, and how far
    the gradient is from the plain formula's; at garden's frame each
    kernel's device time by torch.profiler against the twin's (its forward
    without autograd, its backward alone over a retained graph) and the
    bytes and operations bounds; the kernels' registers and spills.
    Returns the numbers."""
    from gs_tpu_torch.ops import _cuda
    from gs_tpu_torch.ops import ssim as S
    g = torch.Generator(device=dev).manual_seed(23)
    n0 = (S.ssim_fwd.launches, S.ssim_bwd.launches)
    cot = torch.tensor(-0.2, device=dev)      # lambda_dssim's cotangent
    worst_v = worst_g = worst_p = 0.0
    out = {}

    def grad_of(fn, img1, img2):
        x = img1.clone().requires_grad_(True)
        value = fn(x, img2)
        return value.detach(), torch.autograd.grad(value * cot, x)[0]

    def ratio(a, b):
        return float((a - b).abs().max()) / float(b.abs().max())

    for name, shape in SSIM_FRAMES.items():
        photo = S._blur(torch.rand(shape, generator=g, device=dev),
                        S._gaussian_window()).mul_(2.0).sub_(0.5).clamp_(0, 1)
        render = (photo + 0.05 * torch.randn(shape, generator=g, device=dev)
                  ).clamp_(0, 1)
        value, grad = grad_of(S.ssim, render, photo)
        again = grad_of(S.ssim, render, photo)
        check(torch.equal(value.view(torch.int32), again[0].view(torch.int32))
              and torch.equal(grad.view(torch.int32),
                              again[1].view(torch.int32)),
              f"[ssim] {name}: not the same bits from run to run")
        want, want_grad = grad_of(S.ssim_plain, render, photo)
        plain = S.ssim_backward_plain(cot, render, photo)
        err_v = abs(float(value) - float(want))
        err_g, err_p = ratio(grad, want_grad), ratio(grad, plain)
        check(err_v <= 1e-6, f"[ssim] {name}: value {float(value)!r} against "
              f"the twin's {float(want)!r}")
        check(err_g <= 2e-4, f"[ssim] {name}: gradient {err_g:.3e} of the "
              f"largest of the twin's")
        worst_v, worst_g = max(worst_v, err_v), max(worst_g, err_g)
        worst_p = max(worst_p, err_p)
        print(f"[ssim] {name} {shape[2]}x{shape[1]}x{shape[0]}: value "
              f"{float(value):.8f} (twin {float(want):.8f}, off "
              f"{err_v:.2e}); gradient off {err_g:.3e} of autograd's largest "
              f"through the twin, {err_p:.3e} of the plain formula's "
              f"({'bitwise' if torch.equal(grad, plain) else 'not bitwise'}); "
              f"the same bits from run to run", flush=True)
        if name == "garden":
            out["images"] = (render, photo)
    render, photo = out.pop("images")
    _, maps = S.ssim_fwd(render, photo, maps=True)
    with torch.no_grad():
        fwd_ms = device_ms(torch, lambda: S.ssim_fwd(render, photo,
                                                     maps=True), 20)
        value_ms = device_ms(torch, lambda: S.ssim_fwd(render, photo), 20)
        bwd_ms = device_ms(torch, lambda: S.ssim_bwd(cot, render, photo,
                                                     maps), 20)
        twin_fwd_ms = device_ms(torch, lambda: S.ssim_plain(render, photo), 5)
    x = render.clone().requires_grad_(True)
    twin = S.ssim_plain(x, photo) * cot
    twin_bwd_ms = device_ms(torch, lambda: torch.autograd.grad(
        twin, x, retain_graph=True), 5)
    n = render.numel()
    # bytes: both images in and three maps out; the maps and both images
    # in and the gradient out. Operations: harness/work.py's SSIM_OPS (245
    # a pixel and channel) and twice that for the backward
    fwd_bound, fwd_by, _, _ = bound_of(5 * 4 * n, 245 * n)
    bwd_bound, bwd_by, _, _ = bound_of(6 * 4 * n, 2 * 245 * n)
    attrs = (ctypes.c_int * 10)()
    fn = _cuda.function(S.SOURCE, "gs_ssim_kernel_attributes",
                        [ctypes.c_int, ctypes.c_void_p])
    _cuda.check(S.SOURCE, fn(dev.index or 0, ctypes.addressof(attrs)),
                "attributes")
    a = list(attrs)
    print(f"[ssim] garden's frame, device ms by torch.profiler: forward "
          f"{fwd_ms:.4f} (with its mean; {value_ms:.4f} without the maps), "
          f"twin {twin_fwd_ms:.4f}, bound {fwd_bound:.4f} ({fwd_by}, "
          f"{fwd_bound / fwd_ms:.1%}); backward {bwd_ms:.4f}, twin "
          f"{twin_bwd_ms:.4f}, bound {bwd_bound:.4f} ({bwd_by}, "
          f"{bwd_bound / bwd_ms:.1%}); forward {a[0]} registers, {a[1]} B "
          f"shared, {a[2]} B spills, {a[3]} CTAs of {a[4]} per SM; backward "
          f"{a[5]} registers, {a[6]} B shared, {a[7]} B spills, {a[8]} CTAs "
          f"of {a[9]} per SM", flush=True)
    del twin, x, maps
    return {"fwd_ms": fwd_ms, "bwd_ms": bwd_ms, "value_ms": value_ms,
            "twin_fwd_ms": twin_fwd_ms, "twin_bwd_ms": twin_bwd_ms,
            "fwd_bound_ms": fwd_bound, "bwd_bound_ms": bwd_bound,
            "fwd_bound_by": fwd_by, "bwd_bound_by": bwd_by,
            "max_value_err": worst_v, "max_rel_err": worst_g,
            "max_plain_rel_err": worst_p,
            "fwd_launches": S.ssim_fwd.launches - n0[0],
            "bwd_launches": S.ssim_bwd.launches - n0[1]}


TRAINER_ITERS = 300
TRAINER_DUP = 262_144          # far below the ~3 M entries a view needs
STEADY = (251, 299)            # no densify, sync or eval in 252..299
TRAINER_BACK = 3.0             # the views' distance behind the bench camera


@contextlib.contextmanager
def probe_trainer(torch, counters, steady=STEADY, capture_at=None):
    """Record what a Trainer run does, by wrapping the Trainer's methods for
    the run: the host time and launch counts of iterations steady[0]+1 ..
    steady[1] (synchronised at both ends), each densify's DensifyInfo and
    ms, the capacity after each, each replayed window, the loss and entry
    count at each sync and the test PSNR at each evaluation; with
    ``capture_at``, the inputs and outputs of every kernel launched in the
    step that reaches that iteration (``kernel_calls``; that step runs
    eagerly, through the Trainer's private ``_eager_dispatch``, since a
    graph's replay calls no kernel wrapper)."""
    from gs_tpu_torch.train import loop
    T = loop.Trainer
    names = ("step", "_densify", "_maybe_grow", "_replay_window",
             "sync_metrics", "evaluate")
    orig = {k: getattr(T, k) for k in names}
    rec = dict(steady={}, densify=[], grow=[], replay=[], syncs=[], evals=[],
               calls=None)

    def counts():
        return {k: c.launches for k, c in counters.items()}

    def step(self, sync=False):
        if self.iteration == steady[0]:
            torch.cuda.synchronize()
            rec["steady"].update(t0=time.perf_counter(), c0=counts())
        if capture_at is not None and self.iteration == capture_at - 1:
            eager, self._eager_dispatch = self._eager_dispatch, True
            try:
                with kernel_calls() as calls:
                    out = orig["step"](self, sync)
            finally:
                self._eager_dispatch = eager
            rec["calls"] = dict(calls)
        else:
            out = orig["step"](self, sync)
        if self.iteration == steady[1]:
            torch.cuda.synchronize()
            rec["steady"].update(t1=time.perf_counter(), c1=counts())
        return out

    def densify(self, state, use_size_threshold):
        torch.cuda.synchronize()
        t = time.perf_counter()
        new, info = orig["_densify"](self, state, use_size_threshold)
        torch.cuda.synchronize()
        rec["densify"].append(dict(
            iteration=self.iteration, replay=self._replaying,
            ms=1e3 * (time.perf_counter() - t), capacity=state.capacity,
            use_size=bool(use_size_threshold),
            **{k: int(v) for k, v in info._asdict().items()}))
        return new, info

    def maybe_grow(self, *a, **kw):
        orig["_maybe_grow"](self, *a, **kw)
        rec["grow"].append((self.iteration, self.state.capacity))

    def replay(self):
        torch.cuda.synchronize()
        t = time.perf_counter()
        start = self._snapshot["iteration"]
        out = orig["_replay_window"](self)
        torch.cuda.synchronize()
        rec["replay"].append(dict(window=(start, self.iteration),
                                  ms=1e3 * (time.perf_counter() - t),
                                  dup_capacity=self.raster.dup_capacity))
        return out

    def sync(self):
        orig["sync_metrics"](self)
        if self._last_metrics is not None and (
                not rec["syncs"] or rec["syncs"][-1][0] != self.iteration):
            m = self._last_metrics
            rec["syncs"].append((self.iteration, float(m.loss),
                                 int(m.num_duplicates)))

    def evaluate(self, cams, max_views=None):
        out = orig["evaluate"](self, cams, max_views)
        if cams is self.test_cams:
            rec["evals"].append((self.iteration, out["psnr"]))
        return out

    for k, f in zip(names, (step, densify, maybe_grow, replay, sync,
                            evaluate)):
        setattr(T, k, f)
    try:
        yield rec
    finally:
        for k, f in orig.items():
            setattr(T, k, f)


def adam_per_step(launches, tag, steps, shards):
    """Adam's kernel once a packed training step or replay, over the
    process's ``shards`` shards in one pass: at least ``steps`` launches,
    and one for each ``shards`` launches of the preprocess backward (one a
    shard a step)."""
    check(launches["ADAM"] >= steps
          and launches["ADAM"] * shards == launches["PRE_bwd"],
          f"{tag} Adam launches {launches['ADAM']}, preprocess backward "
          f"{launches['PRE_bwd']} over {shards} shards, {steps} steps")


def steady_window(rec, counters, steady=STEADY):
    """(ms per iteration, launches per iteration) over a probed run's
    steady window."""
    st = rec["steady"]
    n = steady[1] - steady[0]
    return (1e3 * (st["t1"] - st["t0"]) / n,
            {k: (st["c1"][k] - st["c0"][k]) / n for k in counters})


# the port's hand-written kernels by a fragment of their names
PORT_KERNELS = {"K2": "expand_rows_kernel", "K1/K1g": "raster_fwd_kernel",
                "K3": "raster_bwd_kernel", "K4 short": "fold_short_kernel",
                "K4 long": "fold_long_kernel"}


def profile_iterations(torch, trainer, iteration_ms, tag, table=True):
    """The device's busy time in one trainer iteration, the median of
    PROFILED_STEPS iterations profiled one by one, and its idle share of
    ``iteration_ms``; the last one's device time in each hand-written
    kernel (K4 in its two); with ``table``, its kernels by time."""
    from torch.profiler import ProfilerActivity, profile
    busy = []
    for _ in range(PROFILED_STEPS):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            trainer.step()
            torch.cuda.synchronize()
        busy.append(sum(e.self_device_time_total for e in prof.key_averages()
                        if e.device_type == torch.autograd.DeviceType.CUDA)
                    / 1e3)
    busy_ms = float(np.median(busy))
    events = prof.key_averages()
    n_launch = sum(e.count for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    print(f"[{tag}] one trainer iteration: device busy {busy_ms:.4f} ms, "
          f"the median of {PROFILED_STEPS} profiled one by one ("
          + ", ".join(f"{x:.4f}" for x in busy) + f"), in {n_launch} kernel "
          f"launches; against the {iteration_ms:.3f} ms iteration the device "
          f"is idle {1 - busy_ms / iteration_ms:.1%}"
          + ("; the table is the last iteration's" if table else ""),
          flush=True)
    ours = {name: 0.0 for name in PORT_KERNELS}
    for e in events:
        for name, fragment in PORT_KERNELS.items():
            if (e.device_type == torch.autograd.DeviceType.CUDA
                    and fragment in e.key):
                ours[name] += e.self_device_time_total / 1e3
    print(f"[{tag}] the last iteration's device ms in the port's kernels: "
          + ", ".join(f"{k} {v:.4f}" for k, v in ours.items()), flush=True)
    if table:
        print(events.table(sort_by="cuda_time_total", row_limit=15,
                           max_name_column_width=60), flush=True)


def trainer_dataset(torch, dev, pts, cols, p0, alive0):
    """The [trainer] dataset: a COLMAP scene of the bench points and 8
    views rendered by K1. Returns the temporary directory that holds it
    (and later the trained model) and the dataset's and model's paths."""
    from gs_tpu_torch.apps.render import save_png
    from gs_tpu_torch.core.camera import focal2fov, make_camera
    from gs_tpu_torch.data import colmap
    from gs_tpu_torch.render import render

    tmp = tempfile.TemporaryDirectory(dir=ROOT, prefix=".chip_smoke_")
    root = os.path.join(tmp.name, "dataset")
    model = os.path.join(tmp.name, "model")
    sparse = os.path.join(root, "sparse", "0")
    os.makedirs(sparse)
    os.makedirs(os.path.join(root, "images"))

    # ------------------------------------------------------ the dataset
    # camera centres on an ellipse around the bench camera's axis, each
    # looking down +z as it does, TRAINER_BACK behind it: from the bench
    # camera's own position the trainer's first render (create_from_pcd's
    # scales, 3.3x the bench scene's) needs 17.2 M entries, past the
    # binning's 2^24 limit with the trainer's 1.2x headroom; from 3 units
    # back, 10.2-10.5 M. The extent (1.1 x the largest distance from the
    # centres' mean, ~1.65) keeps the world-size prune to splats larger
    # than ~0.17
    fovx = math.radians(70.0)
    focal = W / (2 * math.tan(fovx / 2))
    fovy = focal2fov(focal, H)
    centres = [np.array([1.5 * math.cos(2 * math.pi * i / 8),
                         0.75 * math.sin(2 * math.pi * i / 8), -TRAINER_BACK])
               for i in range(8)]
    t0 = time.perf_counter()
    extr = {}
    with torch.no_grad():
        for i, c in enumerate(centres):
            cam = make_camera(np.eye(3), -c, fovx, fovy, W, H, device=dev)
            out = render(cam, p0, torch.zeros(3, device=dev),
                         active_sh_degree=3, alive=alive0,
                         dup_capacity=1 << 23, max_per_tile=4096,
                         exact_cull=True)
            check(not bool(out.overflow), f"[trainer] view {i} overflow")
            name = f"view_{i:02d}.png"
            save_png(os.path.join(root, "images", name),
                     out.image.cpu().numpy())
            extr[i + 1] = colmap.Extrinsics(
                i + 1, np.array([1.0, 0.0, 0.0, 0.0]), -c, 1, name,
                np.zeros((0, 2)), np.zeros((0,), np.int64))
            del out
    colmap.write_intrinsics_binary(
        {1: colmap.Intrinsics(1, "PINHOLE", W, H,
                              np.array([focal, focal, W / 2, H / 2]))},
        os.path.join(sparse, "cameras.bin"))
    colmap.write_extrinsics_binary(extr, os.path.join(sparse, "images.bin"))
    images_s = time.perf_counter() - t0
    rgb = np.clip(np.round(cols * 255.0), 0, 255).astype(np.uint8)
    bin_path = os.path.join(sparse, "points3D.bin")
    t0 = time.perf_counter()
    colmap.write_points3D_binary(pts, rgb, np.zeros((len(pts), 1)), bin_path)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    xyz_r, rgb_r, _ = colmap.read_points3D_binary(bin_path)
    read_s = time.perf_counter() - t0
    check(np.array_equal(xyz_r, pts) and np.array_equal(rgb_r, rgb),
          "points3D.bin round trip")
    print(f"[trainer] dataset: 8 views {W}x{H} rendered by K1 and written "
          f"as PNG in {images_s:.2f} s; points3D.bin of {len(pts)} points "
          f"written in {write_s:.2f} s and read back by "
          f"colmap.read_points3D_binary (the native parser) in "
          f"{read_s:.2f} s", flush=True)
    return tmp, root, model


def render_cli_eager(torch, dev, root, model, cli_png):
    """[render CLI default], continued: the CLI's test view rendered
    eagerly by ``render_grown`` at the CLI's default buffers (no graph)
    writes the CLI's PNG byte for byte; then the view at the grown buffers
    through a ViewGraph and eagerly, in turns: host ms (median of 10,
    synchronised) and device busy (torch.profiler, one view each)."""
    from gs_tpu_torch.apps.render import params_from_ply, save_png
    from gs_tpu_torch.config import RasterConfig
    from gs_tpu_torch.data.scene import Scene
    from gs_tpu_torch.render import ViewGraph, render_grown

    scene = Scene(root, "", resolution=1, eval_split=True, shuffle=False,
                  device=dev)
    scene.model_path = model
    d, _ = scene.load_ply(-1)
    params, alive = params_from_ply(d, device=dev)
    cam = scene.get_test_cameras()[0].camera
    bg = torch.zeros(3, device=dev)
    kw = dict(active_sh_degree=d["sh_degree"], alive=alive)
    with torch.no_grad(), contextlib.redirect_stdout(io.StringIO()):
        out, grown = render_grown(cam, params, bg, RasterConfig(), **kw)
    path = os.path.join(os.path.dirname(model), "eager_view.png")
    save_png(path, out.image.cpu().numpy())
    with open(path, "rb") as f:
        check(f.read() == cli_png, "[render CLI default] the CLI's PNG != "
              "an eager render_grown's")
    graph = ViewGraph()
    ways = {"eager": lambda i=0: render_grown(cam, params, bg, grown,
                                              **kw)[0],
            "graph": lambda i=0: render_grown(cam, params, bg, grown,
                                              graph=graph, **kw)[0]}
    with torch.no_grad(), contextlib.redirect_stdout(io.StringIO()):
        check(torch.equal(ways["graph"]().image, ways["eager"]().image),
              "[render CLI default] the graphed view != the eager one")
        times = host_ms_in_turns(torch, ways, 5)
        busy = {k: busy_per_call(torch, fn) for k, fn in ways.items()}
    host = {k: float(np.median(v)) for k, v in times.items()}
    print(f"[render CLI default] an eager render_grown of the test view "
          f"writes the CLI's PNG byte for byte; the view at the grown "
          f"buffers ({grown.dup_capacity}), graphed and eager in turns: host "
          f"ms (median of 10, synchronised) graph {host['graph']:.3f}, eager "
          f"{host['eager']:.3f}; device busy graph {busy['graph'][0]:.4f} ms "
          f"({busy['graph'][1]:.0f} kernels), eager {busy['eager'][0]:.4f} "
          f"ms ({busy['eager'][1]:.0f} kernels); graph "
          f"{idle_text(busy['graph'][0], host['graph'])}, eager "
          f"{idle_text(busy['eager'][0], host['eager'])}", flush=True)
    del graph, params, alive


def trainer_phase(torch, dev, pts, cols, p0, alive0, bare_step_ms, mid):
    """Phase 10: the training driver through its CLIs. Returns the kernel
    launch counts of the training CLI's run, the temporary directory that
    holds the dataset and the trained model (for the later phases), their
    paths, and the trainer's grown dup_capacity."""
    from gs_tpu_torch.apps import metrics as metrics_app
    from gs_tpu_torch.apps import render as render_app
    from gs_tpu_torch.apps import train as train_app
    from gs_tpu_torch.config import (ModelConfig, OptimizationConfig,
                                     PipelineConfig, RasterConfig)
    from gs_tpu_torch.core.camera import make_camera
    from gs_tpu_torch.core.sh import sh2rgb
    from gs_tpu_torch.data.camera_utils import LoadedCamera
    from gs_tpu_torch.data.dataset_readers import CameraInfo
    from gs_tpu_torch.ops.adam import adam_packed
    from gs_tpu_torch.ops.expand import expand_rows
    from gs_tpu_torch.ops.fold import fold_rows
    from gs_tpu_torch.ops.rasterize import (raster_tiles_bwd,
                                            raster_tiles_fwd,
                                            raster_tiles_fwd_save)
    from gs_tpu_torch.render import MAX_DUP_CAPACITY, render
    from gs_tpu_torch.models.packed_state import PackedState, unpack_state
    from gs_tpu_torch.train import loop
    from gs_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint

    counters = {"K2": expand_rows, "K1": raster_tiles_fwd,
                "K1g": raster_tiles_fwd_save, "K3": raster_tiles_bwd,
                "K4": fold_rows, "ADAM": adam_packed}

    def counts():
        return {k: c.launches for k, c in counters.items()}

    def leaves(state):
        return [t for x in state for t in (x if isinstance(x, tuple) else (x,))]

    tmp, root, model = trainer_dataset(torch, dev, pts, cols, p0, alive0)

    # ------------------------------------------- train through the CLI
    args = ["-s", root, "-m", model, "-r", "1", "--eval",
            "--iterations", str(TRAINER_ITERS),
            "--densify_from_iter", "50", "--densification_interval", "50",
            "--densify_until_iter", "160", "--opacity_reset_interval", "100",
            "--test_iterations", "10", str(TRAINER_ITERS),
            "--save_iterations", str(TRAINER_ITERS),
            "--checkpoint_iterations", str(TRAINER_ITERS),
            "--dup_capacity", str(TRAINER_DUP), "--disable_viewer",
            "--data_device", dev.type, "--no_block_scan"]
    log = io.StringIO()
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    try:
        with probe_trainer(torch, counters) as rec, \
                contextlib.redirect_stdout(log):
            trainer = train_app.main(args)
        torch.cuda.synchronize()
    finally:
        print("\n".join(ln for ln in log.getvalue().splitlines()
                        if any(w in ln for w in (
                            "overflow", "capacity", "Evaluating",
                            "Converting", "Training complete", "WARNING"))),
              flush=True)
    run_s = time.perf_counter() - t0
    launches = counts()
    print(f"[trainer] {TRAINER_ITERS} iterations through "
          f"gs_tpu_torch.apps.train.main in {run_s:.2f} s (dataset load, "
          f"replays and evals included); launches {launches}; "
          f"dup_capacity {TRAINER_DUP} -> {trainer.raster.dup_capacity}; "
          f"{int(trainer.state.num_alive)} alive of {trainer.state.capacity}; "
          f"layout {'packed' if trainer.packed else 'tree'} (the CLI's "
          f"default)", flush=True)
    check(trainer.packed and isinstance(trainer.state, PackedState),
          "[trainer] the CLI's default is the packed layout")
    for d in rec["densify"]:
        print(f"[trainer] densify at {d['iteration']}"
              f"{' (replayed)' if d['replay'] else ''}: DensifyInfo("
              f"n_cloned={d['n_cloned']}, n_split={d['n_split']}, "
              f"n_pruned={d['n_pruned']}, n_dropped={d['n_dropped']}, "
              f"n_alive={d['n_alive']}) of capacity {d['capacity']}, "
              f"size prune {d['use_size']}; {d['ms']:.3f} ms", flush=True)
    print(f"[trainer] capacity after each densify: {rec['grow']}", flush=True)
    for r in rec["replay"]:
        n = r["window"][1] - r["window"][0]
        print(f"[trainer] replayed iterations {r['window'][0] + 1}.."
              f"{r['window'][1]} ({n}) with dup_capacity "
              f"{r['dup_capacity']} in {r['ms']:.2f} ms "
              f"({r['ms'] / max(n, 1):.3f} ms per iteration)", flush=True)
    print(f"[trainer] loss at each sync (the window's largest entry "
          f"count): " + ", ".join(f"{i}: {x:.6f} ({d})"
                                  for i, x, d in rec["syncs"]), flush=True)
    print(f"[trainer] test PSNR: " + ", ".join(
        f"{i}: {x:.4f}" for i, x in rec["evals"]), flush=True)
    steady_ms, per_it = steady_window(rec, counters)
    check(all(math.isfinite(x) for _, x, _ in rec["syncs"]) and rec["syncs"],
          "[trainer] non-finite loss at a sync")
    check(len(rec["evals"]) == 2 and rec["evals"][1][1] > rec["evals"][0][1],
          f"[trainer] test PSNR did not rise: {rec['evals']}")
    check(any(d["n_cloned"] + d["n_split"] > 0 for d in rec["densify"]),
          "[trainer] densify neither cloned nor split")
    check(rec["replay"] and trainer.raster.dup_capacity > TRAINER_DUP,
          "[trainer] no overflow replay")
    check(trainer.overflow_exhausted == 0, "[trainer] replay exhausted")
    check(all(per_it[k] == 1 for k in ("K1g", "K2", "K3", "K4", "ADAM"))
          and per_it["K1"] == 0, f"[trainer] launches per iteration {per_it}")

    # the bare step at the trainer's own shapes, and one profiled iteration
    bare = []
    for _ in range(7):
        torch.cuda.synchronize()
        t = time.perf_counter()
        trainer.train_step(trainer.state, 0, trainer.images[0], None, None,
                           None, 0.0, 280, generator=trainer.generator)
        torch.cuda.synchronize()
        bare.append(1e3 * (time.perf_counter() - t))
    own_bare_ms = float(np.median(bare[2:]))
    print(f"[trainer] ms per iteration over iterations {STEADY[0] + 1}.."
          f"{STEADY[1]} (host clock, synchronised at both ends): "
          f"{steady_ms:.3f}; launches per iteration {per_it}; the bare step "
          f"at the trainer's capacity {trainer.state.capacity}: "
          f"{own_bare_ms:.3f} ms (median of 5), so the trainer adds "
          f"{steady_ms - own_bare_ms:.3f} ms per iteration; [train]'s bare "
          f"step at 510976 slots: {bare_step_ms:.3f} ms "
          f"(difference {steady_ms - bare_step_ms:.3f} ms)", flush=True)

    # the checkpoint is the trained state, bitwise, and survives a round trip
    ckpt = os.path.join(model, f"chkpnt{TRAINER_ITERS}.pth")
    ply = os.path.join(model, "point_cloud", f"iteration_{TRAINER_ITERS}",
                       "point_cloud.ply")
    check(os.path.isfile(ply) and os.path.isfile(ckpt),
          "[trainer] PLY snapshot or checkpoint missing")
    state, it, slrs = load_checkpoint(ckpt, device=dev)
    trained = (unpack_state(trainer.state) if trainer.packed
               else trainer.state)
    check(it == TRAINER_ITERS and all(
        torch.equal(a, b) for a, b in zip(leaves(state), leaves(trained))),
          "[trainer] checkpoint != trained state")
    del trained
    again_path = os.path.join(tmp.name, "again.pth")
    save_checkpoint(again_path, state, it, slrs)
    again, _, _ = load_checkpoint(again_path, device=dev)
    check(all(torch.equal(a, b) for a, b in zip(leaves(state), leaves(again))),
          "[trainer] checkpoint round trip")
    del state, again

    profile_iterations(torch, trainer, steady_ms, "trainer profile")
    dup = trainer.raster.dup_capacity
    del trainer

    # resume, then the render and metrics CLIs
    model2 = os.path.join(tmp.name, "resumed")
    with contextlib.redirect_stdout(io.StringIO()):
        resumed = train_app.main([
            "-s", root, "-m", model2, "-r", "1", "--eval",
            "--iterations", str(TRAINER_ITERS + 5),
            "--start_checkpoint", ckpt, "--densify_until_iter", "160",
            "--opacity_reset_interval", "100",
            "--test_iterations", str(TRAINER_ITERS + 5),
            "--save_iterations", str(TRAINER_ITERS + 5),
            "--dup_capacity", str(dup), "--disable_viewer", "--quiet",
            "--data_device", dev.type, "--no_block_scan"])
    check(resumed.iteration == TRAINER_ITERS + 5 and os.path.isfile(
        os.path.join(model2, "point_cloud",
                     f"iteration_{TRAINER_ITERS + 5}", "point_cloud.ply")),
          "[trainer] resume")
    print(f"[trainer] resumed from chkpnt{TRAINER_ITERS}.pth for 5 "
          f"iterations: loss {resumed.ema_loss:.6f}, Adam step "
          f"{int(resumed.state.step)}", flush=True)
    del resumed

    # [render CLI default]: the render CLI at its default --dup_capacity
    # (1,048,576), which the test view overflows: it must render the view
    # again at grown buffers and write the PNG of an ample render
    out_dir = os.path.join(model, "test", f"ours_{TRAINER_ITERS}")
    png = os.path.join(out_dir, "renders", "00000.png")
    runs = {}
    for name, extra in (("default", []),
                        ("ample", ["--dup_capacity", str(MAX_DUP_CAPACITY)])):
        for c in counters.values():
            c.launches = 0
        log = io.StringIO()
        with contextlib.redirect_stdout(log):
            graph = render_app.main(["-m", model, "--skip_train"] + extra)
        with open(png, "rb") as f:
            runs[name] = dict(launches=counts(), png=f.read(),
                              log=log.getvalue(), captures=graph.captures)
    outs = {k: sorted(os.listdir(os.path.join(out_dir, k)))
            for k in ("renders", "gt")}
    check(outs["renders"] == outs["gt"] == ["00000.png"],
          f"[render CLI default] wrote {outs}")
    regrow = [ln.strip() for ln in runs["default"]["log"].splitlines()
              if "rendering again" in ln]
    print(f"[render CLI default] {regrow[0] if regrow else 'no regrow'}; "
          f"launches {runs['default']['launches']}; at --dup_capacity "
          f"{MAX_DUP_CAPACITY}: launches {runs['ample']['launches']}; the PNGs "
          f"{'are' if runs['default']['png'] == runs['ample']['png'] else 'are NOT'}"
          f" byte for byte equal ({len(runs['ample']['png'])} bytes); view "
          f"captures " + ", ".join(
              f"{name}: " + ", ".join(
                  f"dup_capacity {c['dup_capacity']} {c['ms']:.1f} ms pool "
                  f"peak {c['pool_peak_bytes']}" for c in r["captures"])
              for name, r in runs.items()), flush=True)
    check(len(regrow) == 1 and "WARNING" not in runs["default"]["log"],
          "[render CLI default] the test view did not regrow once")
    # one replay of each view graph, and each capture's warm-up: the
    # default run captures the overflowing view and the grown one
    for name, views in (("default", 2), ("ample", 1)):
        r = runs[name]
        check(len(r["captures"]) == views and r["launches"]["K2"]
              == r["launches"]["K1"] == 2 * views,
              f"[render CLI default] {name}: launches {r['launches']}, "
              f"captures {r['captures']}")
    check(runs["default"]["png"] == runs["ample"]["png"],
          "[render CLI default] PNG differs from the ample render's")
    render_cli_eager(torch, dev, root, model, runs["default"]["png"])
    with contextlib.redirect_stdout(io.StringIO()):
        metrics_app.main(["-m", model, "--no_lpips", "--data_device",
                          dev.type])
    with open(os.path.join(model, "results.json")) as f:
        results = json.load(f)[f"ours_{TRAINER_ITERS}"]
    check(results["PSNR"] > 0, f"[trainer] metrics {results}")
    print(f"[trainer] metrics CLI: {results}", flush=True)

    # ------------------- overflow replay leaves the state of no overflow
    n = mid.capacity
    mfovx = math.radians(60)
    mfovy = 2 * math.atan(math.tan(mfovx / 2) * 192 / 256)
    views = []
    with torch.no_grad():
        for i in range(4):
            c = np.array([0.3 * math.cos(math.pi * i / 2),
                          0.2 * math.sin(math.pi * i / 2), 0.0])
            cam = make_camera(np.eye(3), -c, mfovx, mfovy, 256, 192,
                              device=dev)
            img = render(cam, mid, torch.zeros(3, device=dev),
                         active_sh_degree=3, dup_capacity=1 << 20,
                         max_per_tile=4096, exact_cull=True).image
            views.append(LoadedCamera(
                camera=cam, info=CameraInfo(
                    uid=i, R=np.eye(3), T=-c, fovx=mfovx, fovy=mfovy,
                    image_path="", image_name=f"v{i}", width=256,
                    height=192),
                image=img.clamp(0, 1).cpu().numpy(),
                alpha_mask=np.ones((1, 192, 256), np.float32), invdepth=None,
                depth_mask=None, depth_reliable=False))
    pcd = (mid.xyz.cpu().numpy(),
           sh2rgb(mid.sh_dc[:, 0]).clamp(0, 1).cpu().numpy(),
           np.zeros((n, 3), np.float32))
    runs = []
    for dup_cap in (1 << 20, 8192):
        tr = loop.Trainer(
            views, pcd, spatial_lr_scale=1.0,
            model_cfg=ModelConfig(sh_degree=3, data_device=dev.type),
            opt=OptimizationConfig(
                iterations=30, position_lr_max_steps=30, densify_from_iter=5,
                densification_interval=10, densify_until_iter=25,
                opacity_reset_interval=1000),
            pipe=PipelineConfig(),
            raster=RasterConfig(dup_capacity=dup_cap, max_per_tile=4096),
            seed=7)
        tr.sync_every = 10
        with contextlib.redirect_stdout(io.StringIO()):
            tr.train(iterations=30)
        runs.append(tr)
    ctl, ovf = runs
    check(ctl.raster.dup_capacity == 1 << 20 and ovf.raster.dup_capacity > 8192,
          "[trainer replay] the small buffer never overflowed")
    check(torch.equal(ctl.state.alive, ovf.state.alive),
          "[trainer replay] alive masks differ")
    worst = 0.0
    for name, a, b in zip(ctl.state.params._fields, ovf.state.params,
                          ctl.state.params):
        ratio = float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
        worst = max(worst, ratio)
        check(ratio <= 2e-4, f"[trainer replay] {name}: {ratio} > 2e-4")
    print(f"[trainer replay] 20000 gaussians, 4 views 256x192, 30 "
          f"iterations: dup_capacity 8192 grew to {ovf.raster.dup_capacity} "
          f"and replayed; {int(ctl.state.num_alive)} alive in both, equal "
          f"masks; worst parameter leaf max |diff| / max |ample| {worst:.3e} "
          f"(rule 2e-4)", flush=True)
    del ctl, ovf, runs, views
    return launches, tmp, root, model, dup, steady_ms


VIEWER_ITERS = 80             # the [viewer] run's iterations
VIEWER_IDLE = (50, 79)         # client attached and idle in 51..79
VIEWER_FRAMES = 8              # frames requested while training, besides
#                                the two of the pause


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def kernel_calls():
    """Record the arguments (keywords, a band's ``row_map`` among them) and
    the result of every launch of each kernel the render and training paths
    make, in order, by wrapping the names those paths call (K2 in
    ops/binning.py, K1, K1g, K3 and K4 in ops/rasterize.py). A kernel
    defined in ops/rasterize.py counts its launches by its module name, so
    these land on the wrapper's own count, not the path's."""
    from gs_tpu_torch.ops import binning, rasterize
    names = [(binning, "expand_rows", "K2"),
             (rasterize, "raster_tiles_fwd", "K1"),
             (rasterize, "raster_tiles_fwd_save", "K1g"),
             (rasterize, "raster_tiles_bwd", "K3"),
             (rasterize, "fold_rows", "K4")]
    seen = {k: [] for _, _, k in names}
    orig = {k: getattr(mod, name) for mod, name, k in names}

    def wrap(k):
        def call(*args, **kw):
            out = orig[k](*args, **kw)
            seen[k].append((args, kw, out))
            return out
        call.launches = 0
        return call

    for mod, name, k in names:
        setattr(mod, name, wrap(k))
    try:
        yield seen
    finally:
        for mod, name, k in names:
            setattr(mod, name, orig[k])


def rows_as_given(calls, kernels, bands, tag):
    """Every captured launch of ``kernels`` had a band's row map on a path
    of ``bands`` > 0 bands (a mesh), and none on a one-device path
    (``bands`` 0, a full frame)."""
    banded = bands > 0
    for k in kernels:
        check(bool(calls[k]), f"[{tag}] no launch of {k} was captured")
        for _, kw, _ in calls[k]:
            has = kw.get("row_map") is not None
            check(has == banded, f"[{tag}] {k} ran "
                  + ("a full frame on a mesh path" if banded
                     else "a band on a one-device path"))


def k2_matches(torch, calls, tag, label, bands=0):
    """K2 of every captured launch against its plain version, bitwise, and
    the last round's launches (one, or one per band of ``bands``) within
    their capacity: an overflowed round before it was rendered again.
    Returns the last round's table shapes for the report."""
    from gs_tpu_torch.ops.expand import expand_rows_plain
    check(bool(calls["K2"]), f"[{tag}] no launch of K2 was captured")
    shapes = []
    last = len(calls["K2"]) - max(bands, 1)
    for i, ((comb, offsets, capacity), kw, got) in enumerate(calls["K2"]):
        check(torch.equal(got, expand_rows_plain(comb, offsets, capacity,
                                                 **kw)),
              f"[{tag}] K2 != plain on {label}")
        if i >= last:
            entries = int(comb[1].to(torch.int64).sum())
            check(entries <= capacity, f"[{tag}] {label} overflowed")
            shapes.append(f"[16, {comb.shape[1]}] -> {capacity} entries "
                          f"({entries} owned)")
    return "; ".join(shapes)


def step_kernels_match(torch, calls, tag, label, bands=0):
    """K2, K1g, K3 and K4 of every launch in one captured training step
    (``kernel_calls``: one of each on one device, one per band of
    ``bands`` on a mesh, more after a replay)
    against their plain versions on the inputs each was given, and K1 on
    K1g's inputs, under the rules of the bench-frame checks (K2 bitwise; K1
    and K1g the backend rule, K1g's image bitwise K1's and its residual off
    on at most 0.2 % of pixels; K3 the gradient rule and K3 and K4 bitwise
    from run to run; K4 within 1e-6 of the largest sum, against
    fold_rows_plain's float64 run sums). Returns each kernel's largest
    absolute error."""
    from gs_tpu_torch.ops.fold import fold_rows, fold_rows_plain
    from gs_tpu_torch.ops.rasterize import (raster_tiles_bwd,
                                            raster_tiles_bwd_plain,
                                            raster_tiles_fwd,
                                            raster_tiles_fwd_plain)
    rows_as_given(calls, ("K1g", "K3"), bands, tag)
    check(bool(calls["K4"]), f"[{tag}] no launch of K4 was captured")
    errs = {k: 0.0 for k in ("K2", "K1", "K1g", "K3", "K4")}
    differ = ratio = k4_rel = 0.0
    with torch.no_grad():
        shape = k2_matches(torch, calls, tag, label, bands)
        for args, kw, (out_g, last) in calls["K1g"]:
            out_p, last_p = raster_tiles_fwd_plain(*args, save=True, **kw)
            ok, err, _ = images_match(out_g, out_p)
            d = float((last != last_p).double().mean())
            check(ok and d <= 2e-3, f"[{tag}] K1g != plain")
            out_k1 = raster_tiles_fwd(*args, **kw)
            check(torch.equal(out_k1, out_g), f"[{tag}] K1g image != K1")
            ok, err1, _ = images_match(out_k1, out_p)
            check(ok, f"[{tag}] K1 != plain")
            errs["K1g"] = max(errs["K1g"], err)
            errs["K1"] = max(errs["K1"], err1)
            differ = max(differ, d)
            del out_p, last_p, out_k1
        for args, kw, got in calls["K3"]:
            ok, r, err = grads_match(
                got.T, raster_tiles_bwd_plain(*args, **kw).T)
            check(ok, f"[{tag}] K3 != plain (ratio {r})")
            check(torch.equal(raster_tiles_bwd(*args, **kw), got),
                  f"[{tag}] K3 not deterministic")
            ratio = max(ratio, r)
            errs["K3"] = max(errs["K3"], err)
        for args, kw, got in calls["K4"]:
            ref = fold_rows_plain(*args, **kw)
            err = float((got - ref).abs().max())
            scale = float(ref.abs().max())
            check(err <= 1e-6 * scale, f"[{tag}] K4 != plain")
            check(torch.equal(fold_rows(*args, **kw), got),
                  f"[{tag}] K4 not deterministic")
            errs["K4"] = max(errs["K4"], err)
            k4_rel = max(k4_rel, err / max(scale, 1e-30))
    n = {k: len(calls[k]) for k in ("K2", "K1g", "K3", "K4")}
    maps = ", each band on its row map" if bands else ""
    print(f"[{tag}] {label}: launches {n}{maps}; K2 {shape}, "
          f"bitwise equal; K1g max |kernel - plain| {errs['K1g']:.3e}, image "
          f"bitwise K1's, residual differs on at most {differ:.4%} of "
          f"pixels; K3 worst row {ratio:.3e} of max |plain| (rule 2e-4), max "
          f"abs {errs['K3']:.3e}, repeat bitwise; K4 max |kernel - plain| "
          f"{errs['K4']:.3e}, at most {k4_rel:.3e} of the largest sum (rule "
          f"1e-6), repeat bitwise", flush=True)
    return errs


def path_kernels_match(torch, trainer, cam, tag="viewer kernels"):
    """Each kernel against its plain version at the shapes a run gives it:
    K2 and K1 as they ran in ``Trainer.render_view`` of ``cam``, K2, K1g, K3
    and K4 as they ran in one more training step, each on the inputs it was
    given there (``step_kernels_match``'s rules); under a mesh, every
    band's launch on its own row map. The view and the step run eagerly
    (the Trainer's private ``_eager_dispatch``: a graph's replay calls no
    kernel wrapper), and on one device the graphed view must equal that
    eager view bitwise. Returns each kernel's largest absolute error."""
    from gs_tpu_torch.ops.rasterize import raster_tiles_fwd_plain
    bands = 0 if trainer.mesh is None else trainer.mesh.size
    eager = trainer._eager_dispatch
    with torch.no_grad():
        trainer._eager_dispatch = True
        try:
            with kernel_calls() as calls:
                out = trainer.render_view(cam)
        finally:
            trainer._eager_dispatch = eager
        check(not bool(out.overflow), f"[{tag}] the view overflowed")
        if bands == 0:
            graphed = trainer.render_view(cam)
            check(all(torch.equal(getattr(graphed, f), getattr(out, f))
                      for f in ("image", "invdepth", "final_T")),
                  f"[{tag}] the graphed view != the eager view, bitwise")
        rows_as_given(calls, ("K1",), bands, tag)
        shape = k2_matches(torch, calls, tag, "a view", bands)
        k1_err = frac = 0.0
        for args, kw, got in calls["K1"]:
            ok, err, f = images_match(got, raster_tiles_fwd_plain(*args, **kw))
            check(ok, f"[{tag}] K1 != plain (max {err}, frac {f})")
            k1_err, frac = max(k1_err, err), max(frac, f)
        tiles = [args[1].shape[0] for args, _, _ in calls["K1"]]
        chunks = max(args[4] for args, _, _ in calls["K1"])
        print(f"[{tag}] a view of the trained state "
              f"({trainer.state.capacity} slots"
              f"{f' in {bands} shards' if bands else ''}): K2 "
              f"{shape}, bitwise equal; K1 x{len(tiles)} over {tiles} tiles, "
              f"windows of up to {chunks} chunks: max |kernel - plain| "
              f"{k1_err:.3e}, at most {frac:.4%} of values beyond 1e-5"
              + ("; the graphed view bitwise this eager view" if bands == 0
                 else ""), flush=True)
        del calls, out

    trainer._eager_dispatch = True
    try:
        with kernel_calls() as calls:
            m = trainer.step(sync=True)
    finally:
        trainer._eager_dispatch = eager
    check(not bool(m.overflow), f"[{tag}] the training step overflowed")
    errs = step_kernels_match(torch, calls, tag,
                              f"training step {trainer.iteration} on the "
                              f"same state", bands)
    errs["K1"] = max(errs["K1"], k1_err)
    return errs


def viewer_phase(torch, dev, root, dup, steady_ms, counters):
    """[viewer], the slice's main path: the training CLI on the [trainer]
    dataset with its viewer server on, and a client thread that requests
    1080p frames from the dataset's central pose and poses around it.
    Returns the launch counts of the run."""
    import threading
    from gs_tpu_torch.apps import train as train_app
    from gs_tpu_torch.core.camera import focal2fov, make_camera
    from gs_tpu_torch.train import loop
    from gs_tpu_torch.viewer.client import ViewerClient
    from gs_tpu_torch.viewer.server import ViewerServer, frame_bytes

    fovx = math.radians(70.0)
    fovy = focal2fov(W / (2 * math.tan(fovx / 2)), H)
    # the [trainer] views look down +z from an ellipse TRAINER_BACK behind
    # the bench camera; the client asks for the ellipse's centre and poses
    # around it (from the bench camera itself the untrained Gaussians need
    # 17.2 M entries, past the binning's limit)
    poses = [np.array([0.0, 0.0, -TRAINER_BACK])] + [
        np.array([0.75 * math.cos(2 * math.pi * k / 7),
                  0.4 * math.sin(2 * math.pi * k / 7), -TRAINER_BACK])
        for k in range(7)]
    cams = [make_camera(np.eye(3), -c, fovx, fovy, W, H, device=dev)
            for c in poses]
    port = free_port()

    T, S = loop.Trainer, ViewerServer
    orig = {"step": T.step, "render_view": T.render_view,
            "_render_view": S._render_view}
    rec = dict(idle={}, served=[], views=0)

    def step(self, sync=False):
        if self.iteration == VIEWER_IDLE[0]:
            torch.cuda.synchronize()
            rec["idle"]["t0"] = time.perf_counter()
        out = orig["step"](self, sync)
        if self.iteration == VIEWER_IDLE[1]:
            torch.cuda.synchronize()
            rec["idle"]["t1"] = time.perf_counter()
        return out

    def render_view(self, cam, scaling_modifier=1.0):
        rec["views"] += 1
        return orig["render_view"](self, cam, scaling_modifier)

    def serve(self, cam, scaling_modifier):
        t = time.perf_counter()
        out = orig["_render_view"](self, cam, scaling_modifier)
        rec["served"].append(dict(
            iteration=self.trainer.iteration, bytes=len(out),
            ms=1e3 * (time.perf_counter() - t)))
        return out

    client = dict(frames=[], ms=[], error=None)
    frames_done, training_done = threading.Event(), threading.Event()

    def client_thread():
        try:
            deadline = time.time() + 300
            while True:
                try:
                    c = ViewerClient("127.0.0.1", port, timeout=300)
                    break
                except OSError:
                    if time.time() > deadline:
                        raise
                    time.sleep(0.05)
            # a paused client: two train=false requests sent together are
            # both served before training resumes
            t = time.perf_counter()
            sizes = [c.send_request(cams[0], train=False, keep_alive=True)
                     for _ in range(2)]
            client["pause"] = [c.read_reply(*s) for s in sizes]
            client["pause_ms"] = 1e3 * (time.perf_counter() - t)
            for k in range(VIEWER_FRAMES):
                t = time.perf_counter()
                img, src = c.request_frame(cams[k % len(cams)])
                client["ms"].append(1e3 * (time.perf_counter() - t))
                client["frames"].append((img, src))
            frames_done.set()
            training_done.wait(600)     # attached and idle until the end
            c.close()
        except Exception as e:          # reported and failed below
            client["error"] = repr(e)
            frames_done.set()

    model = os.path.join(os.path.dirname(root), "viewer_model")
    args = ["-s", root, "-m", model, "-r", "1", "--eval",
            "--iterations", str(VIEWER_ITERS),
            "--test_iterations", str(VIEWER_ITERS),
            "--save_iterations", str(VIEWER_ITERS),
            "--dup_capacity", str(dup), "--ip", "127.0.0.1",
            "--port", str(port), "--data_device", dev.type,
            "--no_block_scan"]
    T.step, T.render_view, S._render_view = step, render_view, serve
    th = threading.Thread(target=client_thread, daemon=True)
    for c in counters.values():
        c.launches = 0
    th.start()
    log = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(log):
            trainer = train_app.main(args)
        torch.cuda.synchronize()
    finally:
        training_done.set()
        T.step, T.render_view = orig["step"], orig["render_view"]
        S._render_view = orig["_render_view"]
        th.join(timeout=60)
    run_s = time.perf_counter() - t0
    launches = {k: c.launches for k, c in counters.items()}
    text = log.getvalue()
    print("\n".join(ln for ln in text.splitlines() if any(
        w in ln for w in ("GUI server", "Connected", "overflow", "WARNING",
                          "Evaluating", "unavailable", "Traceback"))),
          flush=True)
    check(client["error"] is None, f"[viewer] client: {client['error']}")
    check(not th.is_alive(), "[viewer] the client thread did not end")
    check(trainer.iteration == VIEWER_ITERS,
          f"[viewer] training stopped at {trainer.iteration}")
    frames = [f for f, _ in client["pause"]] + [f for f, _ in client["frames"]]
    srcs = {s for _, s in client["pause"]} | {s for _, s in client["frames"]}
    check(len(frames) == VIEWER_FRAMES + 2 and all(
        f is not None and f.shape == (H, W, 3) for f in frames),
        "[viewer] frames missing or misshapen")
    check(srcs == {root}, f"[viewer] source paths {srcs}")
    served = rec["served"]
    check(len(served) == VIEWER_FRAMES + 2, f"[viewer] served {len(served)}")
    check(served[0]["iteration"] == served[1]["iteration"],
          "[viewer] training ran between the two paused frames")
    check(served[-1]["iteration"] < VIEWER_IDLE[0],
          f"[viewer] frames served as late as iteration "
          f"{served[-1]['iteration']}")
    n_views = rec["views"]
    evals = n_views - len(served)
    # each served frame and each evaluated view: one K2 and one K1 (a
    # replay of the view's graph) beyond the trainer's one K2, K1g, K3 and
    # K4 per iteration (a replay of the step's), and each capture's
    # warm-up once more (no regrow, no replay at this dup_capacity)
    steps, views = len(trainer.captures), len(trainer.views.captures)
    check(steps >= 1 and views >= 1, f"[viewer] captures: step "
          f"{trainer.captures}, view {trainer.views.captures}")
    want = {"K1": n_views + views, "K2": VIEWER_ITERS + steps + n_views
            + views, "K1g": VIEWER_ITERS + steps,
            "K3": VIEWER_ITERS + steps, "K4": VIEWER_ITERS + steps}
    # the preprocess forward with each K2 (a step's or a view's of the
    # packed block), its backward and Adam with each K3
    want.update(PRE=want["K2"], PRE_bwd=want["K3"], ADAM=want["K3"],
                SSIM=want["K3"], SSIM_bwd=want["K3"])
    check(launches == want, f"[viewer] launches {launches}, want {want}")
    ms = client["ms"]
    idle = rec["idle"]
    idle_ms = 1e3 * (idle["t1"] - idle["t0"]) / (VIEWER_IDLE[1] - VIEWER_IDLE[0])
    print(f"[viewer] {VIEWER_ITERS} iterations through "
          f"gs_tpu_torch.apps.train.main with the viewer on port {port} in "
          f"{run_s:.2f} s; {len(served)} frames {W}x{H} served at iterations "
          f"{[s['iteration'] for s in served]}; {evals} evaluated views; "
          f"launches {launches} (K2 and K1 once per frame and view, each "
          f"capture's warm-up once); captures: the step "
          + ", ".join(f"{c['ms']:.1f} ms pool peak {c['pool_peak_bytes']}"
                      for c in trainer.captures) + "; the view "
          + ", ".join(f"{c['width']}x{c['height']} {c['ms']:.1f} ms pool "
                      f"peak {c['pool_peak_bytes']}"
                      for c in trainer.views.captures), flush=True)
    print(f"[viewer] ms per frame on the client's clock, request to last "
          f"byte: median {float(np.median(ms)):.3f}, largest {max(ms):.3f} "
          f"(" + ", ".join(f"{x:.2f}" for x in ms) + f"); the two paused "
          f"frames {client['pause_ms']:.2f} ms together; on the server, "
          f"render + bytes + send: median "
          f"{float(np.median([s['ms'] for s in served])):.3f} ms; "
          f"{served[0]['bytes']} bytes to the host per frame", flush=True)
    print(f"[viewer] ms per iteration over {VIEWER_IDLE[0] + 1}.."
          f"{VIEWER_IDLE[1]} with the client attached and idle (host clock, "
          f"synchronised at both ends): {idle_ms:.3f}; [trainer]'s steady "
          f"window: {steady_ms:.3f}", flush=True)

    # the cost of a poll with no client: a non-blocking accept
    server = ViewerServer("127.0.0.1", 0, trainer=trainer, source_path=root)
    t = time.perf_counter()
    for _ in range(1000):
        server.poll()
    poll_us = 1e3 * (time.perf_counter() - t)
    # after training: one frame over the wire, bitwise a direct render_view;
    # then the client stays attached and idle while polls are timed
    got, release = {}, threading.Event()

    def one_frame():
        c = ViewerClient("127.0.0.1", server.port)
        got["img"], _ = c.request_frame(cams[0])
        release.wait(60)
        c.close()

    th = threading.Thread(target=one_frame, daemon=True)
    th.start()
    for c in counters.values():
        c.launches = 0
    with contextlib.redirect_stdout(io.StringIO()):
        for _ in range(20000):
            server.poll()
            if "img" in got:
                break
            time.sleep(0.001)
        # the cost of a poll with the client attached and idle: one
        # non-blocking MSG_PEEK
        t = time.perf_counter()
        for _ in range(1000):
            server.poll()
        idle_poll_us = 1e3 * (time.perf_counter() - t)
        attached = server.conn is not None
    release.set()
    th.join(timeout=60)
    server.close()
    after = {k: c.launches for k, c in counters.items()}
    check(attached, "[viewer] the idle client was dropped while polled")
    direct = frame_bytes(trainer.render_view(cams[0]).image)
    check("img" in got and got["img"].tobytes() == direct,
          "[viewer] a frame over the wire != Trainer.render_view, bitwise")
    check(after["K2"] == after["K1"] == 1 and after["ADAM"] == 0
          and all(after[k] == 0 for k in SSIM_IDS),
          f"[viewer] one frame {after}")
    print(f"[viewer] a poll (mean of 1000): with no client {poll_us:.3f} "
          f"us, with the client attached and idle {idle_poll_us:.3f} us; "
          f"after training, a frame over the wire equals Trainer.render_view "
          f"of the same state and pose bitwise (launches {after})", flush=True)
    errs = path_kernels_match(torch, trainer, cams[0])
    del trainer
    return launches, errs


LIVE_FRAMES = 24               # posed frames streamed to train_live
LIVE_DEPTH = 1.0               # the trajectory's advance along z
LIVE_TARGET = np.array([0.0, 0.0, 6.0])   # where every frame looks
RAIN_POINTS = 100              # the reference's RAIN-GS init
RAIN_CAPTURE = 2               # the [live rain] step whose kernels are kept


def look_at(centre, target):
    """The c2w rotation of a camera at ``centre`` looking at ``target``
    (COLMAP axes: x right, y down, z forward; identity looks down +z)."""
    f = target - centre
    f = f / np.linalg.norm(f)
    x = np.cross([0.0, 1.0, 0.0], f)
    x = x / np.linalg.norm(x)
    return np.stack([x, np.cross(f, x), f], axis=1)


def live_frames(torch, dev, p0, alive0, pts):
    """The [live] stream: LIVE_FRAMES posed 1920x1080 frames, each the
    port's K1 render of the bench scene from a pose on a helix through the
    [trainer] ellipse (TRAINER_BACK behind the bench camera, advancing
    LIVE_DEPTH along z), looking at LIVE_TARGET, with a centred K and a
    disjoint 1/LIVE_FRAMES slice of the bench centres as its local map.
    Returns the frames and their rendering cameras."""
    from gs_tpu_torch.core.camera import focal2fov, make_camera
    from gs_tpu_torch.data.colmap import rotmat2qvec
    from gs_tpu_torch.io_live.stream import Frame
    from gs_tpu_torch.render import render
    from gs_tpu_torch.viewer.server import frame_bytes
    fovx = math.radians(70.0)
    focal = W / (2 * math.tan(fovx / 2))
    fovy = focal2fov(focal, H)
    K = np.array([[focal, 0.0, W / 2], [0.0, focal, H / 2], [0.0, 0.0, 1.0]])
    slices = np.array_split(pts, LIVE_FRAMES)
    frames, cams = [], []
    t0 = time.perf_counter()
    with torch.no_grad():
        for i in range(LIVE_FRAMES):
            a = 2 * math.pi * i / LIVE_FRAMES
            c = np.array([1.5 * math.cos(a), 0.75 * math.sin(a),
                          -TRAINER_BACK + LIVE_DEPTH * (
                              i / (LIVE_FRAMES - 1) - 0.5)])
            R = look_at(c, LIVE_TARGET)
            cam = make_camera(R, -R.T @ c, fovx, fovy, W, H, device=dev)
            out = render(cam, p0, torch.zeros(3, device=dev),
                         active_sh_degree=3, alive=alive0,
                         dup_capacity=1 << 23, max_per_tile=4096,
                         exact_cull=True)
            check(not bool(out.overflow), f"[live] view {i} overflow")
            img = np.frombuffer(frame_bytes(out.image), np.uint8).reshape(
                H, W, 3)
            frames.append(Frame(stamp=i / 30.0, image=img, K=K,
                                qvec=rotmat2qvec(R), tvec=c,
                                pose_convention="c2w", points=slices[i]))
            cams.append(cam)
            del out
    print(f"[live] {LIVE_FRAMES} frames {W}x{H} rendered by K1 in "
          f"{time.perf_counter() - t0:.2f} s; {len(slices[0])} local-map "
          f"points each", flush=True)
    return frames, cams


def run_live(torch, dev, tmpdir, name, frames, extra, counters,
             capture_at=None):
    """One run of gs_tpu_torch.apps.train_live.main on a free local port,
    fed by a publisher thread that sends ``frames`` through
    FrameStreamClient (JPEG, the client's default), with the Trainer
    probed (``probe_trainer``), each frame's decode timed on the server and
    the bootstrap (ingest, Scene, Trainer) timed. The launch counts are set
    to 0 just before the run and read just after. Returns the trainer and
    the record."""
    import threading
    from gs_tpu_torch.apps import train_live
    from gs_tpu_torch.io_live import stream
    port = free_port()
    pub = dict(error=None)
    decoded, boot = [], {}

    def publisher():
        try:
            deadline = time.time() + 300
            while True:
                try:
                    client = stream.FrameStreamClient("127.0.0.1", port,
                                                      timeout=300)
                    break
                except OSError:
                    if time.time() > deadline:
                        raise
                    time.sleep(0.02)
            pub["t0"] = time.perf_counter()
            for f in frames:
                client.send(f)
            pub["t1"] = time.perf_counter()
            client.close()
        except Exception as e:          # reported and failed below
            pub["error"] = repr(e)

    orig_decode = stream.decode_frame

    def decode(blob):
        f = orig_decode(blob)
        decoded.append((time.perf_counter(), f.stamp))
        return f

    def timed(key, fn):
        def call(*a, **kw):
            t = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            boot[key] = time.perf_counter() - t
            return out
        return call

    wrapped = ("scene_info_from_frames", "Scene", "Trainer")
    orig = {k: getattr(train_live, k) for k in wrapped}
    model = os.path.join(tmpdir, name.replace(" ", "_"))
    args = ["-m", model, "--frame_port", str(port), "--max_frames",
            str(LIVE_FRAMES), "--collect_timeout", "300", "-r", "1",
            "--eval", "--iterations", str(TRAINER_ITERS),
            "--densify_from_iter", "50", "--densification_interval", "50",
            "--densify_until_iter", "160",
            "--save_iterations", str(TRAINER_ITERS),
            "--data_device", dev.type] + extra
    stream.decode_frame = decode
    for k in wrapped:
        setattr(train_live, k, timed(k, orig[k]))
    th = threading.Thread(target=publisher, daemon=True)
    log = io.StringIO()
    for c in counters.values():
        c.launches = 0
    th.start()
    t0 = time.perf_counter()
    try:
        with probe_trainer(torch, counters, capture_at=capture_at) as rec, \
                contextlib.redirect_stdout(log):
            trainer = train_live.main(args)
        torch.cuda.synchronize()
    finally:
        stream.decode_frame = orig_decode
        for k in wrapped:
            setattr(train_live, k, orig[k])
        th.join(timeout=60)
    rec.update(run_s=time.perf_counter() - t0, log=log.getvalue(),
               launches={k: c.launches for k, c in counters.items()},
               decoded=decoded, boot=boot, pub=pub, model=model)
    text = rec["log"]
    print("\n".join(ln for ln in text.splitlines() if any(w in ln for w in (
        "Collected", "overflow", "capacity", "WARNING", "ITER", "Traceback",
        "complete"))), flush=True)
    check(pub["error"] is None and not th.is_alive(),
          f"[{name}] publisher: {pub['error']}")
    check([s for _, s in decoded] == [i / 30.0 for i in range(LIVE_FRAMES)],
          f"[{name}] frames arrived {[s for _, s in decoded]}")
    check(f"Collected {LIVE_FRAMES} frames" in text, f"[{name}] collected")
    check(trainer.iteration == TRAINER_ITERS and os.path.isfile(os.path.join(
        model, "point_cloud", f"iteration_{TRAINER_ITERS}",
        "point_cloud.ply")), f"[{name}] PLY snapshot missing")
    check(trainer.overflow_exhausted == 0, f"[{name}] replay exhausted")
    check(all(math.isfinite(x) for _, x, _ in rec["syncs"]) and rec["syncs"],
          f"[{name}] non-finite loss at a sync")
    fps = LIVE_FRAMES / (decoded[-1][0] - pub["t0"])
    print(f"[{name}] {LIVE_FRAMES} frames received and decoded at "
          f"{fps:.2f} frames/s (first send to last decode; the publisher's "
          f"JPEG encode and send {pub['t1'] - pub['t0']:.2f} s in all); "
          f"bootstrap: ingest (JPEG at quality 95, PLY) "
          f"{boot['scene_info_from_frames']:.2f} s, Scene "
          f"{boot['Scene']:.2f} s, Trainer {boot['Trainer']:.2f} s; "
          f"{TRAINER_ITERS} iterations in {rec['run_s']:.2f} s from the "
          f"call; launches {rec['launches']}; "
          f"{int(trainer.state.num_alive)} alive of "
          f"{trainer.state.capacity}; replays {len(rec['replay'])}",
          flush=True)
    for d in rec["densify"]:
        print(f"[{name}] densify at {d['iteration']}"
              f"{' (replayed)' if d['replay'] else ''}: DensifyInfo("
              f"n_cloned={d['n_cloned']}, n_split={d['n_split']}, "
              f"n_pruned={d['n_pruned']}, n_dropped={d['n_dropped']}, "
              f"n_alive={d['n_alive']}) of capacity {d['capacity']}; "
              f"{d['ms']:.3f} ms", flush=True)
    return trainer, rec


EAGER_PASS = 16                # iterations in each turn of eager_pass


def eager_pass(torch, trainer, tag):
    """The trained live Trainer's step mode graphed and eager (its private
    ``_eager_dispatch``) in turns (eager, graph, graph, eager), EAGER_PASS
    iterations each, each iteration ``Trainer.step`` and the stat line's
    read-back of the loss and the alive count: ms per iteration (host
    clock, synchronised at both ends of each turn); then the eager step's
    device busy and idle share (profile_iterations)."""
    times = {True: [], False: []}
    try:
        for eager in (True, False, False, True):
            trainer._eager_dispatch = eager
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(EAGER_PASS):
                m = trainer.step()
                float(m.loss), int(trainer.state.num_alive)
            torch.cuda.synchronize()
            times[eager].append(1e3 * (time.perf_counter() - t0) / EAGER_PASS)
        trainer._eager_dispatch = True
        eager_ms = float(np.mean(times[True]))
        print(f"[{tag}] {EAGER_PASS} more iterations a turn with the stat "
              f"line's read-back, in turns: eager "
              + ", ".join(f"{x:.3f}" for x in times[True]) + ", graphed "
              + ", ".join(f"{x:.3f}" for x in times[False])
              + " ms per iteration (host clock, synchronised)", flush=True)
        profile_iterations(torch, trainer, eager_ms, f"{tag} profile",
                           table=False)
    finally:
        trainer._eager_dispatch = False


def live_phase(torch, dev, tmpdir, frames, cams, dup, steady_ms, counters):
    """[live], the live-capture path: train_live on the streamed frames
    with their local maps, then the same with --quiet for the per-iteration
    print's cost, and [live kernels] at the run's shapes. Returns the run's
    launch counts and the kernels' errors."""
    extra = ["--use_local_maps", "--opacity_reset_interval", "100",
             "--test_iterations", "10", str(TRAINER_ITERS), "--dup_capacity",
             str(dup)]
    trainer, rec = run_live(torch, dev, tmpdir, "live", frames, extra,
                            counters)
    launches = rec["launches"]
    live_ms, per_it = steady_window(rec, counters)
    # each Scene camera is its rendering camera: c2w poses inverted to
    # COLMAP's w2c and stored transposed, as the loaders store them
    worst = 0.0
    loaded = trainer.train_cams + trainer.test_cams
    for lc in loaded:
        i = int(lc.info.image_name.split("_")[1])
        want = cams[i].world_view
        err = float((lc.camera.world_view - want).abs().max())
        worst = max(worst, err / float(want.abs().max()))
        check(err <= 1e-5 * float(want.abs().max()),
              f"[live] camera {i}: world_view off by {err}")
    check(sorted(lc.info.image_name for lc in loaded) == [
        f"frame_{i:05d}" for i in range(LIVE_FRAMES)], "[live] cameras")
    check(len(rec["evals"]) == 2 and rec["evals"][1][1] > rec["evals"][0][1],
          f"[live] test PSNR did not rise: {rec['evals']}")
    check(any(d["n_cloned"] + d["n_split"] > 0 for d in rec["densify"]),
          "[live] densify neither cloned nor split")
    check(all(per_it[k] == 1 for k in ("K1g", "K2", "K3", "K4", "ADAM"))
          and per_it["K1"] == 0, f"[live] launches per iteration {per_it}")
    print(f"[live] {len(trainer.train_cams)} train and "
          f"{len(trainer.test_cams)} test cameras, each world_view its "
          f"rendering camera's within {worst:.3e} of its largest entry "
          f"(rule 1e-5); {trainer.state.capacity} slots from the "
          f"concatenated local maps; "
          f"test PSNR " + ", ".join(f"{i}: {x:.4f}" for i, x in rec["evals"])
          + "; loss at each sync " + ", ".join(
              f"{i}: {x:.6f} ({d})" for i, x, d in rec["syncs"]), flush=True)
    print(f"[live] ms per iteration over {STEADY[0] + 1}..{STEADY[1]} (host "
          f"clock, synchronised at both ends; the stat line reads the loss "
          f"and alive count back every iteration): {live_ms:.3f}; "
          f"launches per iteration {per_it}; [trainer]'s window: "
          f"{steady_ms:.3f}", flush=True)
    profile_iterations(torch, trainer, live_ms, "live profile")
    errs = path_kernels_match(torch, trainer, cams[1], "live kernels")
    print(f"[live] captures: the step " + ", ".join(
        f"capacity {c['capacity']} {c['ms']:.1f} ms pool peak "
        f"{c['pool_peak_bytes']}" for c in trainer.captures)
        + "; the view " + ", ".join(
            f"{c['width']}x{c['height']} {c['ms']:.1f} ms pool peak "
            f"{c['pool_peak_bytes']}" for c in trainer.views.captures),
        flush=True)
    check(trainer.captures, "[live] step mode did not capture its step")
    eager_pass(torch, trainer, "live eager")
    del trainer

    # the stat line's cost: the same run with --quiet, then without it
    # again, so the two windows without --quiet give the spread
    quiet, qrec = run_live(torch, dev, tmpdir, "live quiet", frames,
                           extra + ["--quiet"], counters)
    check(not any(ln.startswith("iter ") for ln in qrec["log"].splitlines()),
          "[live quiet] printed the stat line")
    quiet_ms, _ = steady_window(qrec, counters)
    del quiet
    again, arec = run_live(torch, dev, tmpdir, "live again", frames, extra,
                           counters)
    again_ms, _ = steady_window(arec, counters)
    del again
    print(f"[live quiet] ms per iteration over {STEADY[0] + 1}..{STEADY[1]} "
          f"with the stat line, with --quiet, with the stat line again: "
          f"{live_ms:.3f}, {quiet_ms:.3f}, {again_ms:.3f} (--quiet less the "
          f"mean of the two: {quiet_ms - (live_ms + again_ms) / 2:.3f} ms)",
          flush=True)
    return launches, errs


def live_rain_phase(torch, dev, tmpdir, frames, dup, bench, counters):
    """[live rain]: the reference's default init, RAIN_POINTS random points
    in 3x the cameras' box, from the same frames without local maps, with
    [live]'s densify schedule and the default opacity reset (every 3000:
    a reset at 100 turns on the world-size prune at 150, which removes
    every Gaussian of this init, each far above a tenth of the extent); the
    kernels of iteration RAIN_CAPTURE held to their plain versions and K4
    and K2 timed on them beside the bench frame's; K4's device time must
    not exceed index_add_'s on the same rows. Returns the kernels' errors
    and K4's numbers there for the kernels line."""
    from gs_tpu_torch.ops.expand import expand_rows, expand_rows_plain
    from gs_tpu_torch.ops.fold import (PIECE_ROWS, SHORT_RUN_ROWS, fold_rows,
                                       fold_rows_plain)
    bare = [f._replace(points=None) for f in frames]
    extra = ["--init_points", str(RAIN_POINTS), "--test_iterations",
             str(TRAINER_ITERS), "--dup_capacity", str(dup)]
    trainer, rec = run_live(torch, dev, tmpdir, "live rain", bare, extra,
                            counters, capture_at=RAIN_CAPTURE)
    stats = {}
    for ln in rec["log"].splitlines():
        if ln.startswith("iter "):
            i, rest = ln[5:].split(": ", 1)
            loss, pts = rest.split()
            stats[int(i)] = (float(loss[5:]), int(pts[4:]))
    check(sorted(stats) == list(range(1, TRAINER_ITERS + 1)),
          "[live rain] a stat line per iteration")
    first = float(np.mean([stats[i][0] for i in range(1, 11)]))
    last = float(np.mean([stats[i][0] for i in range(TRAINER_ITERS - 9,
                                                     TRAINER_ITERS + 1)]))
    check(last < first, f"[live rain] loss {first} -> {last} did not fall")
    densified = [d["iteration"] for d in rec["densify"] if not d["replay"]]
    rises = [(i, stats[i - 1][1], stats[i][1]) for i in densified]
    check(densified and all(b > a for _, a, b in rises),
          f"[live rain] the alive count at each densify {rises}")
    print(f"[live rain] {RAIN_POINTS} random points: capacity "
          f"{rec['densify'][0]['capacity'] if rec['densify'] else '?'} at "
          f"the first densify, {trainer.state.capacity} at the end (grows "
          f"only past 85 %); capacity after each densify {rec['grow']}; "
          f"alive before -> after each densify "
          + ", ".join(f"{i}: {a} -> {b}" for i, a, b in rises)
          + f"; loss (mean of 10 iterations) {first:.6f} -> {last:.6f}; "
          f"test PSNR {rec['evals']}", flush=True)
    rain_ms, per_it = steady_window(rec, counters)
    print(f"[live rain] ms per iteration over {STEADY[0] + 1}..{STEADY[1]} "
          f"(host clock, with the stat line): {rain_ms:.3f}; launches per "
          f"iteration {per_it}", flush=True)
    profile_iterations(torch, trainer, rain_ms, "live rain profile")
    calls = rec["calls"]
    errs = step_kernels_match(torch, calls, "live kernels",
                              f"[live rain] iteration {RAIN_CAPTURE}")
    (comb, offsets, capacity), _, _ = calls["K2"][-1]
    fold_args, _, _ = calls["K4"][-1]
    data, _, counts, _ = fold_args
    n = counts.shape[0]
    rows = int(counts.to(torch.int64).sum())
    owned = int(comb[1].to(torch.int64).sum())
    k4_ms = time_ms(torch, lambda: fold_rows(*fold_args), 20)
    k4_dev_ms = device_ms(torch, lambda: fold_rows(*fold_args), 20)
    k4_plain_ms = time_ms(torch, lambda: fold_rows_plain(*fold_args), 5)
    # index_add_ needs each row's Gaussian: the runs lie in order, run i at
    # rows [offsets[i], offsets[i] + counts[i]); it reads the runs' rows
    # only, as K4 does
    gid_rows = torch.repeat_interleave(fold_args[3].to(torch.int64),
                                       counts.to(torch.int64))
    run_rows = data[:rows]

    def index_add():
        return torch.zeros((n, 10), device=dev).index_add_(0, gid_rows,
                                                           run_rows)
    k4_lib_ms = time_ms(torch, index_add, 20)
    lib_dev_ms = device_ms(torch, index_add, 20)
    check(torch.allclose(
        torch.zeros((n, 10), device=dev).index_add_(0, gid_rows, run_rows),
        fold_rows(*fold_args), rtol=1e-4,
        atol=1e-6 * float(data.abs().max()) * int(counts.max())),
        "[live rain] index_add_ computes another function than K4")
    c = counts.to(torch.int64)
    long_runs = c[c > SHORT_RUN_ROWS]
    pieces = int(((long_runs + PIECE_ROWS - 1) // PIECE_ROWS).sum())
    k4_bound, k4_by, _, _ = bound_of(min(rows, data.shape[0]) * 40
                                     + n * (12 + 40), rows * 10)
    k2_ms = time_ms(torch, lambda: expand_rows(comb, offsets, capacity), 20)
    k2_plain_ms = time_ms(torch, lambda: expand_rows_plain(
        comb, offsets, capacity), 5)
    n_tab = comb.shape[1]
    k2_bound, k2_by, _, _ = bound_of(
        16 * n_tab * 4 + n_tab * 4 + 16 * capacity * 4,
        capacity * math.ceil(math.log2(n_tab + 1)))
    print(f"[live rain] iteration {RAIN_CAPTURE}'s inputs: K4 folds {rows} "
          f"rows into {n} slots, {int((counts > 0).sum())} runs, the longest "
          f"{int(counts.max())} rows, {long_runs.shape[0]} longer than "
          f"{SHORT_RUN_ROWS} in {pieces} pieces of up to {PIECE_ROWS}: "
          f"kernel {k4_ms:.4f} ms (device {k4_dev_ms:.4f} ms by "
          f"torch.profiler; bench frame {bench['K4']:.4f}), plain "
          f"{k4_plain_ms:.4f} ms, index_add_ {k4_lib_ms:.4f} ms (device "
          f"{lib_dev_ms:.4f} ms), bound {k4_bound:.4f} ms ({k4_by}, "
          f"{k4_bound / k4_dev_ms:.1%} of the device time); K2 "
          f"[16, {n_tab}] -> {capacity} entries ({owned} owned): kernel "
          f"{k2_ms:.4f} ms (bench frame {bench['K2']:.4f}), plain "
          f"{k2_plain_ms:.4f} ms, bound {k2_bound:.4f} ms ({k2_by})",
          flush=True)
    # on the device: K4's CUDA-event time here is its wrapper's launch rate
    check(k4_dev_ms <= lib_dev_ms,
          f"[live rain] K4 (device {k4_dev_ms:.4f} ms) slower than "
          f"index_add_ (device {lib_dev_ms:.4f} ms)")
    eager_pass(torch, trainer, "live rain eager")
    del trainer, calls, rec
    return errs, {"live_rain_ms": k4_ms, "live_rain_device_ms": k4_dev_ms,
                  "live_rain_plain_ms": k4_plain_ms,
                  "live_rain_bound_ms": k4_bound,
                  "live_rain_library_ms": k4_lib_ms}


def visual_merged_record(i, frame):
    """A gs_slam_msgs/visual_merged_msg of ``frame`` (an rgb8 Image, its
    CameraInfo, the c2w pose as a TransformStamped and its local map as an
    XYZ PointCloud2), as the BagWriter takes it."""
    from gs_tpu_torch.io_live.rosbag import RosTime
    h, w = frame.image.shape[:2]
    stamp = RosTime(int(frame.stamp), int(round((frame.stamp % 1) * 1e9)))
    header = {"seq": i, "stamp": stamp, "frame_id": "cam"}
    pts = np.asarray(frame.points, "<f4")
    q, t = frame.qvec, frame.tvec
    return {
        "Image": {"header": header, "height": h, "width": w,
                  "encoding": "rgb8", "is_bigendian": 0, "step": w * 3,
                  "data": frame.image.tobytes()},
        "CameraInfo": {"header": header, "height": h, "width": w,
                       "distortion_model": "plumb_bob", "D": np.zeros(5),
                       "K": frame.K.ravel(), "R": np.eye(3).ravel(),
                       "P": np.zeros(12), "binning_x": 0, "binning_y": 0,
                       "roi": {"x_offset": 0, "y_offset": 0, "height": 0,
                               "width": 0, "do_rectify": False}},
        "CameraPose": {"header": header, "child_frame_id": "cam",
                       "transform": {
                           "translation": dict(zip("xyz", map(float, t))),
                           "rotation": {"x": float(q[1]), "y": float(q[2]),
                                        "z": float(q[3]), "w": float(q[0])}}},
        "Local_Map": {"header": header, "height": 1, "width": len(pts),
                      "fields": [{"name": n, "offset": 4 * k, "datatype": 7,
                                  "count": 1} for k, n in enumerate("xyz")],
                      "is_bigendian": False, "point_step": 12,
                      "row_step": 12 * len(pts), "data": pts.tobytes(),
                      "is_dense": True}}


def convert_stream_phase(torch, dev, tmpdir, frames, dup):
    """[convert_stream]: the [live] frames recorded as a .gstream and as a
    visual_merged .bag, both converted to COLMAP layouts by
    gs_tpu_torch.apps.convert_stream with the same cameras.txt and
    images.txt, and the .gstream's trained 30 iterations through
    gs_tpu_torch.apps.train.main."""
    from gs_tpu_torch.apps import convert_stream
    from gs_tpu_torch.apps import train as train_app
    from gs_tpu_torch.io_live import rosbag
    from gs_tpu_torch.io_live.stream import write_stream_file
    t0 = time.perf_counter()
    gst = os.path.join(tmpdir, "run.gstream")
    write_stream_file(gst, frames)
    gst_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    bag = os.path.join(tmpdir, "run.bag")
    w = rosbag.BagWriter(bag)
    for i, f in enumerate(frames):
        w.write("/Visual_Merged", "gs_slam_msgs/visual_merged_msg",
                rosbag.VISUAL_MERGED_DEF, visual_merged_record(i, f),
                t=f.stamp)
    w.close()
    bag_s = time.perf_counter() - t0
    outs, secs = {}, {}
    for name, src in (("gstream", gst), ("bag", bag)):
        outs[name] = os.path.join(tmpdir, f"colmap_{name}")
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            convert_stream.main(["--input", src, "--output", outs[name],
                                 "--every", "2", "--voxel_size", "0.05"])
        secs[name] = time.perf_counter() - t0
    for f in ("cameras.txt", "images.txt"):
        texts = []
        for name in ("gstream", "bag"):
            with open(os.path.join(outs[name], "sparse", "0", f)) as fh:
                texts.append(fh.read())
        check(texts[0] == texts[1], f"[convert_stream] {f} differs")
    n_images = len(os.listdir(os.path.join(outs["gstream"], "images")))
    check(n_images == LIVE_FRAMES // 2, "[convert_stream] images")
    model = os.path.join(tmpdir, "convert_model")
    log = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        trainer = train_app.main([
            "-s", outs["gstream"], "-m", model, "-r", "1", "--iterations",
            "30", "--test_iterations", "30", "--save_iterations", "30",
            "--dup_capacity", str(dup), "--disable_viewer", "--quiet",
            "--data_device", dev.type, "--no_block_scan"])
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    check(trainer.iteration == 30 and math.isfinite(trainer.ema_loss)
          and trainer.ema_loss > 0, "[convert_stream] training loss")
    print(f"[convert_stream] {LIVE_FRAMES} frames written as a .gstream "
          f"(JPEG) in {gst_s:.2f} s ({os.path.getsize(gst)} bytes) and as a "
          f"visual_merged .bag (rgb8) in {bag_s:.2f} s "
          f"({os.path.getsize(bag)} bytes); converted with --every 2 in "
          f"{secs['gstream']:.2f} / {secs['bag']:.2f} s to identical "
          f"cameras.txt and images.txt ({n_images} images); 30 iterations "
          f"of the .gstream's layout through gs_tpu_torch.apps.train.main "
          f"({int(trainer.state.num_alive)} Gaussians from its "
          f"points3D.ply) in {train_s:.2f} s, loss {trainer.ema_loss:.6f}",
          flush=True)
    del trainer


def native_phase(root):
    """[native]: the [trainer] dataset's points3D.bin read by the native
    parser and by the per-record Python loop: equal arrays, the native
    route taken, both times."""
    from gs_tpu_torch import native
    from gs_tpu_torch.data import colmap
    path = os.path.join(root, "sparse", "0", "points3D.bin")
    check(native.available(), "[native] the native parser did not build")
    before = native.reads
    t0 = time.perf_counter()
    got = colmap.read_points3D_binary(path)
    native_s = time.perf_counter() - t0
    check(native.reads == before + 1, "[native] the native route did not run")
    available = native.available
    native.available = lambda: False
    try:
        t0 = time.perf_counter()
        want = colmap.read_points3D_binary(path)
        python_s = time.perf_counter() - t0
    finally:
        native.available = available
    check(native.reads == before + 1, "[native] the Python route ran native")
    check(all(a.dtype == b.dtype and np.array_equal(a, b)
              for a, b in zip(got, want)), "[native] arrays differ")
    print(f"[native] points3D.bin of {len(got[0])} records "
          f"({os.path.getsize(path)} bytes): native parser {native_s:.4f} s, "
          f"Python record loop {python_s:.4f} s ({python_s / native_s:.1f}x); "
          f"xyz, rgb and error arrays equal", flush=True)


def lpips_weights(path: str, seed: int = 123):
    """Seeded random LPIPS weights in the npz layout (the JAX package's
    tests/utils.py::lpips_random_weights draws, made here with numpy)."""
    from gs_tpu_torch.ops.lpips import TAP_CHANNELS, VGG16_CFG
    rng = np.random.default_rng(seed)
    arrays, cin, i = {}, 3, 0
    for c in VGG16_CFG:
        if c == "M":
            continue
        arrays[f"conv{i}_w"] = rng.normal(0, 0.05, (c, cin, 3, 3)).astype(
            np.float32)
        arrays[f"conv{i}_b"] = rng.normal(0, 0.05, (c,)).astype(np.float32)
        cin, i = c, i + 1
    for k, nc in enumerate(TAP_CHANNELS):
        arrays[f"lin{k}"] = np.abs(rng.normal(0, 0.1, (1, nc))).astype(
            np.float32)
    np.savez(path, **arrays)


def lpips_phase(torch, dev, tmpdir, model):
    """[lpips]: the port's LPIPS on the card against the same module on the
    CPU, one 1080p pair timed, and the metrics CLI with a weights file."""
    from gs_tpu_torch.apps import metrics as metrics_app
    from gs_tpu_torch.ops.lpips import lpips_vgg
    path = os.path.join(tmpdir, "lpips_vgg.npz")
    lpips_weights(path)
    os.environ["GS_TPU_LPIPS_WEIGHTS"] = path
    on_card, on_cpu = lpips_vgg(device=dev), lpips_vgg(device="cpu")
    rng = np.random.default_rng(9)
    a = rng.uniform(0, 1, (3, 192, 256)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    got = float(on_card(ta.to(dev), tb.to(dev)))
    want = float(on_cpu(ta, tb))
    same = float(on_card(ta.to(dev), ta.to(dev)))
    err = abs(got - want)
    print(f"[lpips] 256x192 pair, seeded random weights: card {got:.9f}, "
          f"CPU {want:.9f}, |diff| {err:.3e} (rule rel 1e-4, abs 1e-6); "
          f"identical pair {same:.3e}", flush=True)
    check(err <= 1e-6 + 1e-4 * abs(want), "[lpips] card != CPU")
    check(abs(same) <= 1e-8, "[lpips] identical pair != 0")
    big = torch.rand((2, 3, H, W), generator=torch.Generator().manual_seed(1))
    x, y = big[0].to(dev), big[1].to(dev)
    ms = time_ms(torch, lambda: on_card(x, y), 5, 1)
    # two VGG16 conv trunks: 2 FLOP per multiply-add over every conv's
    # output pixels, at the data sheet's FP32 rate (TF32 off)
    flops, cin, h, w = 0, 3, H, W
    from gs_tpu_torch.ops.lpips import VGG16_CFG
    for c in VGG16_CFG:
        if c == "M":
            h, w = h // 2, w // 2
            continue
        flops += 2 * 2 * 9 * cin * c * h * w
        cin = c
    bound = flops / FP32_OPS_PER_S * 1e3
    print(f"[lpips] one {W}x{H} pair on the card: {ms:.3f} ms (CUDA events, "
          f"mean of 5); {flops / 1e12:.3f} TFLOP of convolution, bound "
          f"{bound:.3f} ms at {FP32_OPS_PER_S / 1e12:.0f} TFLOP/s "
          f"({bound / ms:.1%})", flush=True)
    del on_card, on_cpu, big, x, y
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        metrics_app.main(["-m", model, "--data_device", dev.type])
    with open(os.path.join(model, "results.json")) as f:
        results = json.load(f)[f"ours_{TRAINER_ITERS}"]
    check("LPIPS" in results and math.isfinite(results["LPIPS"]),
          f"[lpips] metrics CLI {results}")
    print(f"[lpips] metrics CLI on the [trainer] model with "
          f"GS_TPU_LPIPS_WEIGHTS set: {results}", flush=True)
    return ms


FULL_EVAL_ITERS = 30


def full_eval_phase(torch, dev, tmpdir, root, dup, counters):
    """[full_eval]: gs_tpu_torch.apps.full_eval over two Tanks&Temples
    scene folders that link to the [trainer] dataset, at full width."""
    from gs_tpu_torch.apps import full_eval
    tat = os.path.join(tmpdir, "tandt")
    os.makedirs(tat)
    for name in ("truck", "train"):
        os.symlink(root, os.path.join(tat, name))
    out = os.path.join(tmpdir, "eval")
    for c in counters.values():
        c.launches = 0
    log = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        full_eval.main(["-tat", tat, "--output_path", out, "--iterations",
                        str(FULL_EVAL_ITERS), "--data_device", dev.type,
                        "-r", "1", "--dup_capacity", str(dup),
                        "--no_block_scan"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: c.launches for k, c in counters.items()}
    stages = [ln.strip() for ln in log.getvalue().splitlines()
              if " total:" in ln]
    results = {}
    for name in ("truck", "train"):
        m = os.path.join(out, name)
        renders = os.path.join(m, "test", f"ours_{FULL_EVAL_ITERS}",
                               "renders")
        check(os.path.isfile(os.path.join(m, "cfg_args")) and os.path.isfile(
            os.path.join(m, "point_cloud", f"iteration_{FULL_EVAL_ITERS}",
                         "point_cloud.ply")), f"[full_eval] {name}: outputs")
        check(os.listdir(renders) == ["00000.png"],
              f"[full_eval] {name}: renders {os.listdir(renders)}")
        with open(os.path.join(m, "results.json")) as f:
            results[name] = json.load(f)[f"ours_{FULL_EVAL_ITERS}"]
        check(set(results[name]) == {"SSIM", "PSNR", "LPIPS"} and all(
            math.isfinite(v) for v in results[name].values()),
            f"[full_eval] {name}: {results[name]}")
    print(f"[full_eval] two scenes of {FULL_EVAL_ITERS} iterations at "
          f"{W}x{H} in {wall:.2f} s: " + "; ".join(stages) + f"; launches "
          f"{launches}; results {results}", flush=True)


MESH_K = 4                 # shards of the in-process group on the card
MESH_ITERS = 24            # [mesh trainer]: a densify at 20, syncs every 5
MESH_VCAP = 65_536         # its first visible_capacity, below the visible
# Gaussians of the full shards (the 500,000 points fill the first two of
# four 262,144-slot shards): the first sync overflows, grows it and replays
MESH_ASSIGNS = (("stride", dict(band_assign="stride")),
                ("cost", dict(band_assign="cost")),
                ("cost, split_rows 2", dict(band_assign="cost", split_rows=2)))


def identity_row_map_is_the_full_frame(torch, dev, p0, alive0, cam):
    """K1, K1g and K3 of the full bench frame with the identity row map
    against the same kernels with none (the one-device path), bit for
    bit: the map only renames the tile row the kernels already had."""
    from gs_tpu_torch.core.project import preprocess
    from gs_tpu_torch.ops.binning import bin_gaussians_payload, tile_grid
    from gs_tpu_torch.ops.rasterize import (max_chunks_for, raster_tiles_bwd,
                                            raster_tiles_fwd,
                                            raster_tiles_fwd_save)
    from gs_tpu_torch.ops.rasterize_plain import pack_projected
    proj = preprocess(p0, cam, active_sh_degree=3, alive=alive0)
    bins, feats, plan = bin_gaussians_payload(
        proj, pack_projected(proj), W, H, 16, 16, DUP_CAPACITY,
        exact_cull=True, fold_plan=True)
    gx, gy = tile_grid(W, H, 16, 16)
    args = (feats, bins.tile_start, bins.tile_end, gx,
            max_chunks_for(MAX_PER_TILE))
    ident = torch.arange(gy, dtype=torch.int32, device=dev)
    out0, last0 = raster_tiles_fwd_save(*args)
    out1, last1 = raster_tiles_fwd_save(*args, row_map=ident)
    same = {"K1g": torch.equal(out0, out1) and torch.equal(last0, last1),
            "K1": torch.equal(raster_tiles_fwd(*args, row_map=ident),
                              raster_tiles_fwd(*args))}
    dout = torch.tensor(np.random.default_rng(5).normal(
        0, 1, tuple(out0.shape)), dtype=torch.float32, device=dev)
    same["K3"] = torch.equal(
        raster_tiles_bwd(*args, out0, last0, dout, plan.dest),
        raster_tiles_bwd(*args, out0, last0, dout, plan.dest, row_map=ident))
    check(all(same.values()), f"[mesh kernels] the identity row map changed "
          f"the full frame: {same}")
    print(f"[mesh kernels] the full bench frame ({int(bins.num_valid)} "
          f"entries) with the identity row map: K1, K1g and K3 bitwise "
          f"without one", flush=True)


def mesh_kernels_phase(torch, dev, p0, alive0, bench_camera, counters):
    """[mesh kernels]: the bench frame through render_multichip on
    LocalGroup(MESH_K) (every shard and band on this card, K2 and K1 per
    band) under each band assignment, against the one-device K1 frame; each
    band's K1, K1g and K3 on its own inputs against their plain versions,
    timed beside the work their data needs. Returns the kernels' largest
    errors and the per-assignment band numbers."""
    from gs_tpu_torch.core.project import preprocess
    from gs_tpu_torch.ops.binning import bin_gaussians_payload, tile_grid
    from gs_tpu_torch.ops.rasterize import (kernel_row_map, max_chunks_for,
                                            raster_tiles_bwd,
                                            raster_tiles_bwd_plain,
                                            raster_tiles_bwd_work,
                                            raster_tiles_fwd,
                                            raster_tiles_fwd_plain,
                                            raster_tiles_fwd_save,
                                            raster_tiles_fwd_work)
    from gs_tpu_torch.ops.rasterize_plain import pack_projected
    from gs_tpu_torch.parallel.mesh import LocalGroup
    from gs_tpu_torch.parallel.render_mc import (_rows_projected, _shard_rows,
                                                 band_assignment, band_layout,
                                                 render_multichip)
    from gs_tpu_torch.render import render

    group = LocalGroup(MESH_K, dev)
    cam = bench_camera(0)
    bg = torch.zeros(3, device=dev)
    kw = dict(active_sh_degree=3, alive=alive0, dup_capacity=DUP_CAPACITY,
              max_per_tile=MAX_PER_TILE, exact_cull=True)
    gx, _ = tile_grid(W, H, 16, 16)
    mc = max_chunks_for(MAX_PER_TILE)
    errs = {"K1": 0.0, "K1g": 0.0, "K3": 0.0}
    bands = {}
    with torch.no_grad():
        ref = render(cam, p0, bg, **kw)
        full_ms = time_ms(torch, lambda: render(cam, p0, bg, **kw), 5)
        identity_row_map_is_the_full_frame(torch, dev, p0, alive0, cam)
        n = p0.capacity // MESH_K
        projs = [preprocess(p0.__class__(*[t[d * n:(d + 1) * n] for t in p0]),
                            cam, active_sh_degree=3,
                            alive=alive0[d * n:(d + 1) * n])
                 for d in range(MESH_K)]
        proj_all = _rows_projected(torch.cat([_shard_rows(p) for p in projs]))
        packets = pack_projected(proj_all)
        for label, assign in MESH_ASSIGNS:
            torch.cuda.synchronize()
            for c in counters.values():
                c.launches = 0
            out = render_multichip(p0, cam, bg, group, **kw, **assign)
            torch.cuda.synchronize()
            launches = {k: c.launches for k, c in counters.items()}
            mesh_ms = time_ms(torch, lambda: render_multichip(
                p0, cam, bg, group, **kw, **assign), 5)
            check(not bool(out.overflow), f"[mesh kernels] {label} overflow")
            check(launches["K2"] == launches["K1"] == MESH_K,
                  f"[mesh kernels] {label} launches {launches}")
            same = {k: torch.equal(getattr(out, k), getattr(ref, k))
                    for k in ("image", "invdepth", "final_T")}
            diff = max(float((getattr(out, k) - getattr(ref, k)).abs().max())
                       for k in same)
            ok = all(images_match(getattr(out, k), getattr(ref, k))[0]
                     for k in same)
            check(ok, f"[mesh kernels] {label}: the reassembled frame differs "
                      f"from the one-device K1 frame by {diff}")
            work = out.band_work.double()
            dups = out.band_duplicates.double()
            print(f"[mesh kernels] {label}, {MESH_K} shards of {n}: the "
                  f"reassembled frame is the one-device K1 frame "
                  f"{'bitwise' if all(same.values()) else f'within {diff:.3e}'} "
                  f"(image, invdepth, final_T: {same}); band_work "
                  f"{out.band_work.tolist()} (max/mean "
                  f"{float(work.max() / work.mean()):.4f}), band_duplicates "
                  f"{out.band_duplicates.tolist()} (max/mean "
                  f"{float(dups.max() / dups.mean()):.4f}; the frame's "
                  f"{int(ref.num_duplicates)}); launches {launches}; "
                  f"render_multichip {mesh_ms:.4f} ms, render() "
                  f"{full_ms:.4f} ms (CUDA events)", flush=True)
            kws, _, _ = band_assignment(projs, group, W, H, **assign)
            _, _, _, rows, _ = band_layout(W, H, MESH_K, **assign)
            per_band = []
            for d in range(MESH_K):
                bins, feats, plan = bin_gaussians_payload(
                    proj_all, packets, W, rows * 16, 16, 16, DUP_CAPACITY,
                    exact_cull=True, fold_plan=True, **kws[d])
                check(not bool(bins.overflow), f"[mesh kernels] band {d}")
                kmap = kernel_row_map(kws[d]["row_map"], dev)
                args = (feats, bins.tile_start, bins.tile_end, gx, mc)
                got = raster_tiles_fwd(*args, row_map=kmap)
                out_g, last = raster_tiles_fwd_save(*args, row_map=kmap)
                torch.cuda.synchronize()
                check(torch.equal(got, out_g), f"[mesh kernels] band {d}: "
                      "K1g image != K1")
                plain, last_p = raster_tiles_fwd_plain(*args, save=True,
                                                       row_map=kmap)
                ok, mx, frac = images_match(got, plain)
                differ = float((last != last_p).double().mean())
                check(ok and differ <= 2e-3, f"[mesh kernels] {label} band "
                      f"{d}: K1 vs plain max {mx}, frac {frac}, last {differ}")
                errs["K1"] = max(errs["K1"], mx)
                errs["K1g"] = max(errs["K1g"], mx)
                dout = torch.tensor(np.random.default_rng(11 + d).normal(
                    0, 1, tuple(out_g.shape)), dtype=torch.float32, device=dev)
                bwd = (*args, out_g, last, dout, plan.dest)
                g = raster_tiles_bwd(*bwd, row_map=kmap)
                torch.cuda.synchronize()
                g_ref = raster_tiles_bwd_plain(*bwd, row_map=kmap)
                ok3, ratio, mx3 = grads_match(g.T, g_ref.T)
                check(ok3, f"[mesh kernels] {label} band {d}: K3 vs plain "
                      f"{ratio} > 2e-4")
                errs["K3"] = max(errs["K3"], mx3)
                w1 = raster_tiles_fwd_work(*args, row_map=kmap)
                w3 = raster_tiles_bwd_work(*args, last, row_map=kmap)
                per_band.append(dict(
                    entries=int(bins.num_valid),
                    K1=time_ms(torch, lambda: raster_tiles_fwd(
                        *args, row_map=kmap), 10),
                    K1g=time_ms(torch, lambda: raster_tiles_fwd_save(
                        *args, row_map=kmap), 10),
                    K3=time_ms(torch, lambda: raster_tiles_bwd(
                        *bwd, row_map=kmap), 10),
                    K1_bound=bound_of(w1["bytes"], w1["ops"])[0],
                    K3_bound=bound_of(w3["bytes"], w3["ops"])[0],
                    K1_err=mx, K3_ratio=ratio))
                del bins, feats, plan, got, out_g, last, plain, last_p, g, g_ref
            bands[label] = dict(
                work=out.band_work.tolist(), dups=out.band_duplicates.tolist(),
                work_ratio=float(work.max() / work.mean()), per_band=per_band,
                mesh_ms=mesh_ms, full_ms=full_ms)
            print(f"[mesh kernels] {label}, per band (entries; K1, K1g, K3 "
                  f"ms; K1 and K3 bounds ms; K1 max |kernel - plain|, K3 worst "
                  f"row ratio): " + "; ".join(
                      f"{b['entries']}: {b['K1']:.4f}, {b['K1g']:.4f}, "
                      f"{b['K3']:.4f}; {b['K1_bound']:.4f}, "
                      f"{b['K3_bound']:.4f}; {b['K1_err']:.2e}, "
                      f"{b['K3_ratio']:.2e}" for b in per_band)
                  + f"; summed K1 {sum(b['K1'] for b in per_band):.4f}, K1g "
                  f"{sum(b['K1g'] for b in per_band):.4f}, K3 "
                  f"{sum(b['K3'] for b in per_band):.4f} ms", flush=True)
        del projs, proj_all, packets, ref, out
    return errs, bands


def mesh_step_phase(torch, dev, p0, alive0, bench_camera, counters):
    """[mesh step]: the bench training step ([train]'s configuration) with
    the state sharded over LocalGroup(MESH_K) against the one-device step on
    the same state: the loss, and each Adam first moment (0.1 x the
    gradient after one step) and the densification statistics within 2e-4
    x their largest magnitude; ms per step of both, in turns, and the mesh
    step's launches."""
    from gs_tpu_torch.config import (ModelConfig, OptimizationConfig,
                                     PipelineConfig, RasterConfig)
    from gs_tpu_torch.core.camera import stack_cameras
    from gs_tpu_torch.models.gaussian_model import init_state
    from gs_tpu_torch.parallel.mesh import LocalGroup
    from gs_tpu_torch.train.step import make_train_step

    opt = OptimizationConfig(iterations=30_000)
    raster = RasterConfig(backend="auto", dup_capacity=DUP_CAPACITY,
                          max_per_tile=MAX_PER_TILE, chunk=64, exact_cull=True)
    cams = stack_cameras([bench_camera(0)])
    args = (opt, ModelConfig(), PipelineConfig(), raster, cams, 1.0, 3)
    one = make_train_step(*args)
    mesh = make_train_step(*args, mesh=LocalGroup(MESH_K, dev))
    state = init_state(p0, alive0, num_images=1)
    gt = torch.zeros((3, H, W), device=dev)
    s1, m1 = one(state, 0, gt, iteration=1)
    torch.cuda.synchronize()
    for c in counters.values():
        c.launches = 0
    s4, m4 = mesh(state, 0, gt, iteration=1)
    torch.cuda.synchronize()
    launches = {k: c.launches for k, c in counters.items()}
    check(not bool(m4.overflow), "[mesh step] overflow")
    check(all(launches[k] == MESH_K for k in ("K2", "K1g", "K3", "K4"))
          and launches["K1"] == launches["ADAM"] == 0
          and all(launches[k] == 1 for k in SSIM_IDS),
          f"[mesh step] launches {launches}")
    l1, l4 = float(m1.loss), float(m4.loss)
    check(abs(l1 - l4) <= 1e-6 * abs(l1), f"[mesh step] loss {l4} != {l1}")
    worst = 0.0
    for name, a, b in zip(s1.m._fields, s1.m, s4.m):
        ok, ratio, _ = grads_match(b[None], a[None])
        worst = max(worst, ratio)
        check(ok, f"[mesh step] {name}: {ratio} > 2e-4")
    ok, ratio, _ = grads_match(s4.grad_accum[None], s1.grad_accum[None])
    check(ok, f"[mesh step] grad_accum: {ratio} > 2e-4")
    del s1, s4
    times = {"one device": [], f"{MESH_K} shards": []}
    for it in range(2, 8):
        for label, fn in (("one device", one), (f"{MESH_K} shards", mesh)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(state, 0, gt, iteration=it)
            torch.cuda.synchronize()
            if it > 2:
                times[label].append(1e3 * (time.perf_counter() - t0))
    med = {k: float(np.median(v)) for k, v in times.items()}
    print(f"[mesh step] bench step, {MESH_K} shards of "
          f"{state.capacity // MESH_K} on this card against one device: loss "
          f"{l4:.7f} vs {l1:.7f}; worst Adam first-moment leaf max |diff| / "
          f"max |one device| {worst:.3e}, densification statistics "
          f"{ratio:.3e} (rule 2e-4); launches per mesh step {launches}; ms "
          f"per step (host clock, synchronised, in turns, median of 5): "
          + ", ".join(f"{k} {v:.3f}" for k, v in med.items())
          + " (the shards run one after another: not a speed-up)", flush=True)
    return med


def gap_threshold(state):
    """A densify threshold in the widest relative gap among the top 5 % of
    the alive Gaussians' mean gradients (past the 100 largest), so that
    rounding cannot carry a Gaussian across it."""
    torch = sys.modules["torch"]
    g = state.grad_accum / state.denom
    g = torch.where(torch.isnan(g), 0.0, g)[state.alive]
    g = torch.sort(g, descending=True).values.double().cpu().numpy()
    top = g[100:max(len(g) // 20, 102)]
    rel = (top[:-1] - top[1:]) / top[:-1]
    i = int(np.argmax(rel))
    return float((top[i] + top[i + 1]) / 2), float(rel[i])


def mesh_trainer_phase(torch, dev, root, dup, counters):
    """[mesh trainer]: Trainer(mesh=LocalGroup(MESH_K)) on the [trainer]
    dataset for MESH_ITERS iterations through a densify (at a threshold in a
    gap of the one-device run's gradients, the same for both) and a
    visible_capacity growth with replay, against the one-device Trainer at
    the same iteration; then the training CLI over a real NCCL group:
    --mesh N when this machine has N >= 2 cards, else --multihost with a
    group of one ([mesh CLI], step and block mode). Returns the mesh run's
    kernel launches, and each kernel's largest error on the inputs the mesh
    Trainer gave it."""
    import dataclasses
    import random
    from gs_tpu_torch.apps import train as train_app
    from gs_tpu_torch.config import (ModelConfig, OptimizationConfig,
                                     PipelineConfig, RasterConfig)
    from gs_tpu_torch.data.scene import Scene
    from gs_tpu_torch.models.gaussian_model import group_lrs
    from gs_tpu_torch.parallel.mesh import LocalGroup
    from gs_tpu_torch.train.loop import Trainer

    random.seed(0)
    scene = Scene(root, "", resolution=1, eval_split=True, device=dev)
    opt = OptimizationConfig(iterations=300, densify_from_iter=10,
                             densification_interval=10, densify_until_iter=25,
                             opacity_reset_interval=1000)
    band_dup = -(-dup // 2 // 512) * 512
    thresholds, densify_ms = {}, {}

    def make(mesh, raster):
        tr = Trainer(scene.get_train_cameras(), scene.point_cloud,
                     spatial_lr_scale=scene.cameras_extent,
                     model_cfg=ModelConfig(data_device=str(dev)), opt=opt,
                     pipe=PipelineConfig(), raster=raster,
                     test_cams=scene.get_test_cameras(), seed=0, mesh=mesh)
        tr.sync_every = 5
        densify = tr._densify

        def at_threshold(state, use_size_threshold):
            if tr.iteration not in thresholds:
                thresholds[tr.iteration] = gap_threshold(state)
            tr.opt = dataclasses.replace(
                tr.opt, densify_grad_threshold=thresholds[tr.iteration][0])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = densify(state, use_size_threshold)
            torch.cuda.synchronize()
            densify_ms.setdefault("one device" if mesh is None
                                  else f"{MESH_K} shards", []).append(
                1e3 * (time.perf_counter() - t0))
            return out

        tr._densify = at_threshold
        return tr

    t0 = time.perf_counter()
    one = make(None, RasterConfig(dup_capacity=dup))
    one.train(iterations=MESH_ITERS)
    psnr_one = one.evaluate(one.test_cams)["psnr"]
    torch.cuda.synchronize()
    one_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    mesh = make(LocalGroup(MESH_K, dev),
                RasterConfig(dup_capacity=band_dup, visible_capacity=MESH_VCAP))
    grows = []
    grow = mesh._grow_raster
    mesh._grow_raster = lambda changes, will_replay: (
        grows.append(dict(changes)), grow(changes, will_replay))
    torch.cuda.synchronize()
    for c in counters.values():
        c.launches = 0
    mesh.train(iterations=MESH_ITERS)
    psnr_mesh = mesh.evaluate(mesh.test_cams)["psnr"]
    torch.cuda.synchronize()
    launches = {k: c.launches for k, c in counters.items()}
    mesh_s = time.perf_counter() - t0
    check(any("visible_capacity" in g for g in grows),
          f"[mesh trainer] visible_capacity never grew: {grows}")
    check(mesh.overflow_exhausted == 0, "[mesh trainer] replay exhausted")
    check(all(launches[k] >= MESH_K * MESH_ITERS
              for k in ("K2", "K1g", "K3", "K4")) and launches["K1"] > 0,
          f"[mesh trainer] launches {launches}")
    adam_per_step(launches, "[mesh trainer]", MESH_ITERS, MESH_K)
    check(torch.equal(mesh.state.alive, one.state.alive),
          f"[mesh trainer] alive masks differ in "
          f"{int((mesh.state.alive != one.state.alive).sum())} slots")
    worst = {}
    for name in one.state.params._fields:
        a = getattr(one.state.params, name)
        b = getattr(mesh.state.params, name)
        diff = (a - b).abs()
        beyond = float((diff > 2e-4 * a.abs().max()).double().mean())
        lr = max(getattr(group_lrs(opt, 1, one.spatial_lr_scale), name),
                 getattr(group_lrs(opt, MESH_ITERS, one.spatial_lr_scale),
                         name))
        worst[name] = (beyond, float(diff.max()) / lr)
        check(beyond <= 0.01 and float(diff.max()) <= 2.01 * MESH_ITERS * lr,
              f"[mesh trainer] {name}: {beyond:.2%} beyond 2e-4 x max, max "
              f"diff {float(diff.max())} ({float(diff.max()) / lr:.2f} lr)")
    check(abs(psnr_mesh - psnr_one) < 0.01,
          f"[mesh trainer] test PSNR {psnr_mesh} vs {psnr_one}")
    print(f"[mesh trainer] {MESH_ITERS} iterations of the [trainer] dataset, "
          f"{mesh.capacity} slots: LocalGroup({MESH_K}) {mesh_s:.2f} s, one "
          f"device {one_s:.2f} s (evaluations included); densify thresholds "
          f"(iteration: value, relative gap) {thresholds}; grown buffers "
          f"{grows}; visible_capacity {MESH_VCAP} -> "
          f"{mesh.raster.visible_capacity}, dup_capacity per band "
          f"{band_dup} -> {mesh.raster.dup_capacity}; alive "
          f"{mesh.num_alive()} = one device's {one.num_alive()}, masks "
          f"equal; per parameter (share beyond 2e-4 x max, max diff in lr): "
          + ", ".join(f"{k} {v[0]:.3%} {v[1]:.3f}" for k, v in worst.items())
          + f"; test PSNR {psnr_mesh:.4f} vs {psnr_one:.4f} dB; launches "
          f"{launches}", flush=True)
    # a densify under a mesh gathers every sharded field to each rank and
    # keeps its shard of the result: in a LocalGroup both are no-ops, so
    # what it costs beyond one device is these bytes over the interconnect
    from gs_tpu_torch.parallel.mesh import _map_sharded
    state = mesh.state
    sizes = []
    _map_sharded(lambda t, axis: sizes.append(t.numel() * t.element_size()),
                 state)
    shard_bytes = sum(sizes)
    print(f"[mesh trainer] densify_and_prune ms (host clock, synchronised): "
          + "; ".join(f"{k} " + ", ".join(f"{x:.3f}" for x in v)
                      for k, v in densify_ms.items())
          + f"; the gathered state is {shard_bytes} bytes "
          f"({shard_bytes // MESH_K} per shard; on k cards each rank "
          f"receives (k-1)/k of it)", flush=True)
    # every kernel of the mesh path on the inputs that path gave it: the
    # bands of one render_view and of one more training step
    errs = path_kernels_match(torch, mesh, mesh.test_cams[0].camera,
                              "mesh trainer kernels")
    del one, mesh, state

    mesh_cli_phase(torch, dev, root, band_dup)
    return launches, errs


def mesh_cli_phase(torch, dev, root, band_dup):
    """[mesh CLI]: the training CLI over a real NCCL group (--mesh N with N
    >= 2 cards, else --multihost with a group of one), 10 iterations with
    two densifies and a test evaluation, in step mode (--no_block_scan:
    its collectives captured in the step-mode graph) and in the CLI's
    default block mode on CUDA (captured in the chain's graphs): the two
    gathered PLYs byte for byte equal, and each run's log shows its
    captures (in this process: --mesh N's ranks print to their own
    output)."""
    from gs_tpu_torch.apps import train as train_app
    cards = torch.cuda.device_count()
    plys = {}
    for mode, extra in (("step mode", ["--no_block_scan"]),
                        ("block mode", [])):
        model = os.path.join(os.path.dirname(root),
                             "model_mesh_" + mode.split()[0])
        args = ["-s", root, "-m", model, "-r", "1", "--eval", "--iterations",
                "10", "--densify_from_iter", "4",
                "--densification_interval", "5", "--test_iterations", "10",
                "--save_iterations", "10", "--dup_capacity", str(band_dup),
                "--disable_viewer", "--quiet", "--data_device",
                dev.type] + extra
        log = io.StringIO()
        t0 = time.perf_counter()
        if cards >= 2:
            how = f"--mesh {cards}: {cards} processes, one per card, NCCL"
            train_app.main(args + ["--mesh", str(cards)])
        else:
            how = ("--multihost with a group of one (this machine has one "
                   "card), NCCL")
            env = {"GS_TPU_COORD": f"127.0.0.1:{free_port()}",
                   "GS_TPU_NPROCS": "1", "GS_TPU_PROCID": "0"}
            os.environ.update(env)
            try:
                with contextlib.redirect_stdout(log):
                    tr = train_app.main(args + ["--multihost"])
            finally:
                for k in env:
                    os.environ.pop(k)
            want = "nccl" if dev.type == "cuda" else "gloo"
            check(tr.mesh.backend == want and tr.mesh.size == 1,
                  f"[mesh CLI] group {tr.mesh.backend} of {tr.mesh.size}")
            check("Sharding gaussians over 1 devices" in log.getvalue(),
                  "[mesh CLI] no sharding line")
            # step mode replays the chain's graph too (ChainStep.step);
            # the densifies and the test views replay theirs, which the
            # group's close released before NCCL's destroy (else the run
            # would not have returned)
            check(len(tr.captures) >= 1
                  and "captured the chain step" in log.getvalue(),
                  f"[mesh CLI] {mode} captured {tr.captures}")
            held = tr._runner.density if tr._runner else None
            check(len(tr.views.captures) >= 1
                  and {c["what"] for c in tr.density_captures}
                  == {"densify"} and not tr.views.views and held is None,
                  f"[mesh CLI] {mode}: view captures {tr.views.captures}, "
                  f"density captures {tr.density_captures}, still held "
                  f"{list(tr.views.views)} {held}")
            del tr
        ply = os.path.join(model, "point_cloud", "iteration_10",
                           "point_cloud.ply")
        check(os.path.exists(ply), f"[mesh CLI] {mode}: no PLY")
        with open(ply, "rb") as f:
            plys[mode] = f.read()
        print(f"[mesh CLI] {mode}, ran {how}: 10 iterations with two "
              f"densifies (graphed), a test evaluation (its views graphed) "
              f"and a gathered PLY in {time.perf_counter() - t0:.2f} s, and "
              f"the run returned after the group's close; " + " | ".join(
                  ln for ln in log.getvalue().splitlines()
                  if "Sharding" in ln or "Evaluating" in ln
                  or "captured" in ln), flush=True)
    check(plys["block mode"] == plys["step mode"],
          "[mesh CLI] the block-mode PLY differs from the step-mode PLY")
    print(f"[mesh CLI] the block-mode PLY ({len(plys['block mode'])} bytes) "
          f"is byte for byte the step-mode PLY", flush=True)


MESH_GRAPH_ITERS = 30     # [mesh graph trainer]: syncs at 10, 20 (densify), 30
MESH_GRAPH_EXTRA = 10     # the timed block after the run, and the profiled one


def mesh_graph_trainer_phase(torch, dev, root, dup, counters):
    """[mesh graph trainer]: Trainer(mesh=LocalGroup(MESH_K)) on the
    [trainer] dataset for MESH_GRAPH_ITERS iterations in eager step mode
    (the Trainer's private ``_eager_dispatch``, the reference), in step
    mode through its graph (one replay an iteration), then in block mode
    through the chain (buckets of 10): the first sync's visible_capacity
    overflow (MESH_VCAP), its replay and the capture its growth causes, a
    densify at 20, syncs at 10, 20 and 30 in every mode. The graphed step
    mode and the chain must be bitwise the eager step-mode run: the losses
    at the syncs and the final state. Then, on the trained state,
    one more block of MESH_GRAPH_EXTRA iterations timed by host clock
    (synchronised at both ends) with the launch counters read around it,
    and one more profiled with device records only: device busy and idle
    share per iteration, kernels per iteration. Prints each capture's ms
    and graph-pool peak. Returns the chain run's launches."""
    from gs_tpu_torch.config import (ModelConfig, OptimizationConfig,
                                     PipelineConfig, RasterConfig)
    from gs_tpu_torch.data.scene import Scene
    from gs_tpu_torch.parallel.mesh import LocalGroup
    from gs_tpu_torch.train.graph import state_leaves
    from gs_tpu_torch.train.loop import Trainer

    scene = Scene(root, "", resolution=1, eval_split=True, device=dev)
    opt = OptimizationConfig(iterations=300, densify_from_iter=10,
                             densification_interval=10, densify_until_iter=25,
                             opacity_reset_interval=1000)
    band_dup = -(-dup // 2 // 512) * 512
    n = MESH_GRAPH_EXTRA
    ref, launches_chain = None, None
    for mode in ("step", "step graph", "chain"):
        t0 = time.perf_counter()
        tr = Trainer(scene.get_train_cameras(), scene.point_cloud,
                     spatial_lr_scale=scene.cameras_extent,
                     model_cfg=ModelConfig(data_device=str(dev)), opt=opt,
                     pipe=PipelineConfig(),
                     raster=RasterConfig(dup_capacity=band_dup,
                                         visible_capacity=MESH_VCAP),
                     seed=0, mesh=LocalGroup(MESH_K, dev))
        tr.sync_every = 10
        blocks = mode == "chain"
        tr._eager_dispatch = mode == "step"
        grows, syncs = [], {}
        grow = tr._grow_raster
        tr._grow_raster = lambda changes, will_replay: (
            grows.append(dict(changes)), grow(changes, will_replay))

        def on_step(i, m, t):
            if i % tr.sync_every == 0:
                syncs[i] = float(m.loss)

        for c in counters.values():
            c.launches = 0
        tr.train(iterations=MESH_GRAPH_ITERS, block_scan=blocks,
                 log_every=1, on_step=on_step)
        tr.sync_metrics()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: c.launches for k, c in counters.items()}
        check(tr.iteration == MESH_GRAPH_ITERS and tr.overflow_exhausted == 0,
              f"[mesh graph trainer] {mode}: iteration {tr.iteration}, "
              f"replay exhausted {tr.overflow_exhausted}")
        check(any("visible_capacity" in g for g in grows),
              f"[mesh graph trainer] {mode}: visible_capacity never grew "
              f"({grows})")
        check(sorted(syncs) == [10, 20, 30]
              and all(math.isfinite(x) for x in syncs.values()),
              f"[mesh graph trainer] {mode}: syncs {syncs}")
        check(all(launches[k] >= MESH_K * MESH_GRAPH_ITERS
                  for k in ("K2", "K1g", "K3", "K4") + PRE_IDS),
              f"[mesh graph trainer] {mode}: launches {launches}")
        adam_per_step(launches, f"[mesh graph trainer] {mode}:",
                      MESH_GRAPH_ITERS, MESH_K)
        if mode == "step":
            check(not tr.captures, "[mesh graph trainer] the eager step "
                  "mode captured")
        else:
            check(len(tr.captures) >= 2 and tr._runner is not None,
                  f"[mesh graph trainer] {mode}: captures {tr.captures}")
        state = [t.clone() for t in state_leaves(tr.state)]
        if ref is None:
            ref = dict(state=state, syncs=syncs, grows=grows)
            verdict = "the reference"
        else:
            bitwise = [torch.equal(a, b) for a, b in zip(state, ref["state"])]
            check(syncs == ref["syncs"] and all(bitwise),
                  f"[mesh graph trainer] {mode} against step mode: losses "
                  f"{syncs} vs {ref['syncs']}, state leaves equal {bitwise}, "
                  f"spread {[float((a - b).abs().max()) for a, b in zip(state, ref['state']) if a.is_floating_point()]}")
            verdict = ("losses at the syncs and final state bitwise step "
                       "mode's")
        del state

        # one more block on the trained state: host ms, launches
        def block():
            if not blocks:
                for _ in range(n):
                    tr._dispatch_step()
            else:
                tr.run_block(n)

        c0 = {k: c.launches for k, c in counters.items()}
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        block()
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t1) / n
        per_it = {k: (c.launches - c0[k]) / n for k, c in counters.items()}
        # the preprocess pair once a shard an iteration, Adam and the SSIM
        # pair (the gathered frame's) once over the shards
        check(all(per_it[k] == MESH_K for k in PRE_IDS)
              and all(per_it[k] == 1 for k in ("ADAM",) + SSIM_IDS),
              f"[mesh graph trainer] {mode}: launches per iteration "
              f"{per_it}, want {MESH_K} of each of {PRE_IDS} and 1 of each "
              f"of ADAM, {SSIM_IDS}")
        # and one more, profiled
        busy, n_k = (x / n for x in busy_per_call(torch, block))
        print(f"[mesh graph trainer] {mode}: {MESH_GRAPH_ITERS} iterations "
              f"of the [trainer] dataset, {tr.capacity} slots in {MESH_K} "
              f"shards, in {wall:.2f} s; grown buffers {grows}; syncs "
              + ", ".join(f"{i}: {x:.7f}" for i, x in sorted(syncs.items()))
              + f" ({verdict}); launches {launches}; captures "
              + (", ".join(f"capacity {c['capacity']} {c['ms']:.1f} ms pool "
                           f"peak {c['pool_peak_bytes']}"
                           for c in tr.captures) or "none")
              + f"; one more block of {n}: {ms:.3f} ms per iteration (host "
              f"clock, synchronised), kernel wrappers' launches per "
              f"iteration {per_it}; device busy {busy:.4f} ms per iteration "
              f"over one more profiled block ({n_k:.1f} kernels each), "
              + idle_text(busy, ms), flush=True)
        if mode == "chain":
            launches_chain = launches
        del tr
        torch.cuda.empty_cache()
    return launches_chain


PACKED_ITERS = 60              # [packed trainer]: a densify at 50
PACKED_STEADY = (20, 49)       # no densify, replay or eval in 21..49
PROFILE_ROWS = ("SelectBackward0", "aten::add_", "aten::stack")


def profiled_steps(torch, fn):
    """``fn`` (one step) profiled PROFILED_STEPS times one by one: the median
    device busy ms, the kernel launches of one step, and the device ms of
    PROFILE_ROWS in the last one (an autograd node or an annotation counts
    the kernels of everything under it; an annotation's device-side span,
    a second event of the same name, is not counted again), and its
    ``update`` stage (densification statistics, Adam, exposure) by the
    program's stage stamps (``utils/spans.py``)."""
    from gs_tpu_torch.utils import spans
    from torch.profiler import ProfilerActivity, profile
    busy = []
    for _ in range(PROFILED_STEPS):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        events = prof.key_averages()
        run = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA]
        busy.append(sum(e.self_device_time_total for e in run) / 1e3)
    rows = {}
    for name in PROFILE_ROWS:
        hit = [e for e in events if e.key == name
               and e.device_type == torch.autograd.DeviceType.CPU]
        rows[name] = (sum(getattr(e, "device_time_total", None)
                          or getattr(e, "cuda_time_total", 0.0) for e in hit)
                      / 1e3, sum(e.count for e in hit))
    rows["update stage"] = (
        spans.stage_means(last=1, unit="step").get("update", 0.0), 1)
    return float(np.median(busy)), sum(e.count for e in run), rows


@contextlib.contextmanager
def twin_preprocess(on: bool = True):
    """Inside, preprocess_packed runs its PyTorch twin on the card too (the
    kernel pair's engagement, core/project.py::uses_kernel, patched)."""
    from gs_tpu_torch.core import project
    engages = project.uses_kernel
    if on:
        project.uses_kernel = lambda *a, **k: False
    try:
        yield
    finally:
        project.uses_kernel = engages


def packed_step_phase(torch, dev, p0, alive0, bench_camera, counters):
    """[packed step]: the bench step ([train]'s configuration) from one
    initial state, TRAIN_STEPS steps in the tree layout, in the packed
    layout and in the packed layout with the preprocess's twin ("packed
    twin"), in turns: each packed loss within rtol 1e-5 of the tree step's;
    the packed twin's unpacked final state within JAX's packed-against-tree
    rule (atol 2e-5, rtol 1e-3, tests/test_packed.py:103-141), the two
    layouts' arithmetic being the same op for op; the packed state (the
    preprocess kernel pair's gradient, which agrees with the twin's to
    rounding) within the same rule after the first step, and after the last
    on every leaf but the quaternions, whose entries beyond it must each be
    one where the tree's Adam first moment is below QUAT_M_SHARE of the
    group's largest: Adam's normalised step turns a rounding's sign flip of
    a near-zero gradient (a nearly isotropic Gaussian's quaternion) into a
    whole learning rate. No overflow, K1g, K2, K3 and K4, the preprocess
    forward and backward and Adam's kernel once per packed step; every
    launch of one more packed step against its plain version on its inputs,
    Adam's kernel bitwise its twin on the last packed state, dense and
    column-masked (the alive slots), with a seeded gradient. Reports ms
    per step (host, median), the device's busy time (median of
    PROFILED_STEPS profiled steps), the launches per step and the
    PROFILE_ROWS of both layouts. Returns the packed launches and each
    kernel's largest error."""
    from gs_tpu_torch.config import (ModelConfig, OptimizationConfig,
                                     PipelineConfig, RasterConfig)
    from gs_tpu_torch.core.camera import stack_cameras
    from gs_tpu_torch.core.packed import layout
    from gs_tpu_torch.models.gaussian_model import init_state
    from gs_tpu_torch.models.packed_state import (adam_update_packed,
                                                  adam_update_packed_plain,
                                                  group_lr_rows, pack_state,
                                                  unpack_state)
    from gs_tpu_torch.train.step import make_train_step

    opt = OptimizationConfig(iterations=30_000)
    raster = RasterConfig(backend="auto", dup_capacity=DUP_CAPACITY,
                          max_per_tile=MAX_PER_TILE, chunk=64, exact_cull=True)
    cams = stack_cameras([bench_camera(0)])
    args = (opt, ModelConfig(), PipelineConfig(), raster, cams, 1.0, 3)
    steps = {"tree": make_train_step(*args),
             "packed": make_train_step(*args, packed=True),
             "packed twin": make_train_step(*args, packed=True)}
    tree0 = init_state(p0, alive0, num_images=1)
    states = {"tree": tree0, "packed": pack_state(tree0),
              "packed twin": pack_state(tree0)}
    gt = torch.zeros((3, H, W), device=dev)
    losses = {k: [] for k in steps}
    times = {k: [] for k in steps}
    launches = {k: 0 for k in counters}
    first = {}
    for it in range(1, TRAIN_STEPS + 1):
        for name in steps:
            torch.cuda.synchronize()
            before = {k: c.launches for k, c in counters.items()}
            t0 = time.perf_counter()
            with twin_preprocess(name == "packed twin"):
                states[name], m = steps[name](states[name], 0, gt,
                                              iteration=it)
            torch.cuda.synchronize()
            times[name].append(1e3 * (time.perf_counter() - t0))
            check(not bool(m.overflow), f"[packed step] {name} overflow")
            losses[name].append(float(m.loss))
            if name == "packed":
                for k, c in counters.items():
                    launches[k] += c.launches - before[k]
            if it == 1:
                first[name] = (unpack_state(states[name]) if name != "tree"
                               else states[name])
    for name in ("packed", "packed twin"):
        for a, b in zip(losses[name], losses["tree"]):
            check(abs(a - b) <= 1e-5 * abs(b),
                  f"[packed step] {name} loss {a} != {b}")
    check(all(launches[k] == TRAIN_STEPS for k in ("K1g", "K2", "K3", "K4")
              + PRE_IDS + ("ADAM",)) and launches["K1"] == 0,
          f"[packed step] launches {launches}")
    ps = states["packed"]
    adam_grad = 1e-4 * torch.randn(ps.packed.shape, device=dev,
                                   generator=torch.Generator(
                                       device=dev).manual_seed(21))
    adam_lr = group_lr_rows(layout(3), opt, TRAIN_STEPS + 1, 1.0, device=dev)
    for mask in (None, ps.alive):
        got = adam_update_packed(ps, adam_grad, adam_lr, mask)
        want = adam_update_packed_plain(ps, adam_grad, adam_lr, mask)
        check(all(torch.equal(x.view(torch.int32), y.view(torch.int32))
                  for x, y in ((got.packed, want.packed), (got.m, want.m),
                               (got.v, want.v)))
              and torch.equal(got.step, want.step),
              f"[packed step] Adam's kernel != its twin "
              f"({'dense' if mask is None else 'masked'})")
    del got, want, adam_grad

    def excess(got, ref, tag, skip=()):
        """The worst |got - ref| - 1e-3 |ref| per leaf; the rule checked
        on every leaf not in ``skip``."""
        worst, leaves = 0.0, {}
        for name, a, b in zip(got._fields, got, ref):
            pairs = (zip(a._fields, a, b) if isinstance(a, tuple)
                     else [(name, a, b)])
            for leaf, x, y in pairs:
                key = leaf if leaf == name else f"{name}.{leaf}"
                if not x.is_floating_point():
                    check(key in skip or torch.equal(x, y),
                          f"[packed step] {tag}: {key} differs")
                    continue
                e = float(((x - y).abs() - 1e-3 * y.abs()).max())
                worst, leaves[key] = max(worst, e), e
                check(key in skip or e <= 2e-5,
                      f"[packed step] {tag}: {key} beyond atol 2e-5 + rtol "
                      "1e-3")
        return worst, leaves

    worst, _ = excess(unpack_state(states["packed twin"]), states["tree"],
                      "packed twin")
    worst_first, _ = excess(first["packed"], first["tree"], "packed, step 1")
    last = unpack_state(states["packed"])
    _, kernel_last = excess(last, states["tree"], f"packed, step {TRAIN_STEPS}",
                            skip=("params.quat",))
    # the quaternions' misses: each where the tree's first moment is small
    q, q_ref, m_ref = (last.params.quat, states["tree"].params.quat,
                       states["tree"].m.quat.abs())
    beyond = (q - q_ref).abs() > 2e-5 + 1e-3 * q_ref.abs()
    m_share = float(m_ref[beyond].max() / m_ref.max()) if beyond.any() else 0.0
    check(m_share < QUAT_M_SHARE,
          f"[packed step] packed, step {TRAIN_STEPS}: a quaternion beyond "
          f"the rule where the tree's first moment is {m_share:.3e} of its "
          f"largest (rule < {QUAT_M_SHARE})")
    un = unpack_state(states["packed twin"])
    bitwise = all(torch.equal(x, y) for a, b in zip(un, states["tree"])
                  for x, y in (zip(a, b) if isinstance(a, tuple)
                               else [(a, b)]))
    with kernel_calls() as calls:
        states["packed"], m = steps["packed"](states["packed"], 0, gt,
                                              iteration=TRAIN_STEPS + 1)
    check(not bool(m.overflow), "[packed step] checked step overflow")
    errs = step_kernels_match(torch, calls, "packed step",
                              f"packed step {TRAIN_STEPS + 1} of the bench "
                              f"state")
    del calls
    prof = {name: profiled_steps(torch, lambda n=name: steps[n](
        states[n], 0, gt, iteration=TRAIN_STEPS + 2))
        for name in ("tree", "packed")}
    med = {k: float(np.median(v)) for k, v in times.items()}
    print(f"[packed step] {TRAIN_STEPS} bench steps per layout from one "
          f"state, in turns: losses packed "
          + ", ".join(f"{x:.7f}" for x in losses["packed"]) + " vs tree "
          + ", ".join(f"{x:.7f}" for x in losses["tree"])
          + f" (rtol 1e-5); the packed twin's unpacked final state "
          f"{'bitwise the tree state' if bitwise else 'within the rule'} "
          f"(worst |diff| - 1e-3 |tree| {worst:.3e}, rule 2e-5); the packed "
          f"state after step 1 within it ({worst_first:.3e}), after step "
          f"{TRAIN_STEPS} per leaf "
          + ", ".join(f"{k[7:]} {v:.3e}" for k, v in kernel_last.items()
                      if k.startswith("params."))
          + f" (quat: {int(beyond.sum())} of {beyond.numel()} entries beyond "
          f"the rule, each where the tree's first moment is at most "
          f"{m_share:.3e} of its largest, rule < {QUAT_M_SHARE})"
          + f"; packed launches {launches}; Adam's kernel bitwise its twin "
          f"on the last packed state, dense and masked", flush=True)
    for name in ("tree", "packed"):
        busy, n_launch, rows = prof[name]
        print(f"[packed step] {name}: ms per step (host clock, synchronised, "
              f"median of {TRAIN_STEPS}) {med[name]:.3f}; device busy "
              f"{busy:.4f} ms (median of {PROFILED_STEPS} profiled one by "
              f"one) in {n_launch} kernel launches; "
              + ", ".join(f"{k} {v[0]:.4f} ms ({v[1]} calls)"
                          for k, v in rows.items()), flush=True)
    return launches, errs


def packed_mesh_phase(torch, dev, p0, alive0, bench_camera):
    """[packed mesh]: one packed bench step with the state in
    LocalGroup(MESH_K) column shards against the one-device packed step on
    the same state (the loss within 1e-6 relative, each row of Adam's
    first moments and the densification statistics within 2e-4 x their
    largest magnitude), and every K2, K1g, K3 and K4 launch of the banded
    step against its plain version on its inputs. Returns each kernel's
    largest error."""
    from gs_tpu_torch.config import (ModelConfig, OptimizationConfig,
                                     PipelineConfig, RasterConfig)
    from gs_tpu_torch.core.camera import stack_cameras
    from gs_tpu_torch.models.gaussian_model import init_state
    from gs_tpu_torch.models.packed_state import pack_state
    from gs_tpu_torch.parallel.mesh import LocalGroup
    from gs_tpu_torch.train.step import make_train_step

    raster = RasterConfig(backend="auto", dup_capacity=DUP_CAPACITY,
                          max_per_tile=MAX_PER_TILE, chunk=64, exact_cull=True)
    args = (OptimizationConfig(iterations=30_000), ModelConfig(),
            PipelineConfig(), raster, stack_cameras([bench_camera(0)]), 1.0,
            3)
    state = pack_state(init_state(p0, alive0, num_images=1))
    gt = torch.zeros((3, H, W), device=dev)
    t0 = time.perf_counter()
    s1, m1 = make_train_step(*args, packed=True)(state, 0, gt, iteration=1)
    with kernel_calls() as calls:
        s4, m4 = make_train_step(*args, packed=True,
                                 mesh=LocalGroup(MESH_K, dev))(
            state, 0, gt, iteration=1)
    check(not bool(m4.overflow), "[packed mesh] overflow")
    l1, l4 = float(m1.loss), float(m4.loss)
    check(abs(l1 - l4) <= 1e-6 * abs(l1), f"[packed mesh] loss {l4} != {l1}")
    ok, ratio_m, _ = grads_match(s4.m, s1.m)
    check(ok, f"[packed mesh] Adam first moments: {ratio_m} > 2e-4")
    ok, ratio_g, _ = grads_match(s4.grad_accum[None], s1.grad_accum[None])
    check(ok, f"[packed mesh] grad_accum: {ratio_g} > 2e-4")
    check(torch.equal(s4.denom, s1.denom)
          and torch.equal(s4.max_radii2D, s1.max_radii2D),
          "[packed mesh] visibility statistics differ")
    print(f"[packed mesh] the packed bench step, {MESH_K} column shards of "
          f"{state.capacity // MESH_K} against one device: loss {l4:.7f} vs "
          f"{l1:.7f}; worst row of Adam's first moments {ratio_m:.3e}, "
          f"grad_accum {ratio_g:.3e} of max (rule 2e-4); "
          f"{time.perf_counter() - t0:.2f} s for both", flush=True)
    errs = step_kernels_match(torch, calls, "packed mesh",
                              f"the packed {MESH_K}-shard bench step",
                              bands=MESH_K)
    del calls, s1, s4, state
    return errs


def bf16_step_phase(torch, dev, p0, alive0, bench_camera):
    """[bf16 step]: one packed bench step with bf16_features against the
    f32 step on the same state, under JAX's envelope
    (tests/test_pallas.py:110-151): the loss within 5e-3; the gradients
    (Adam's first moments, 0.1 x the gradient) within 5 % of the f32
    maximum for geometry and 2 % for SH."""
    from gs_tpu_torch.config import (ModelConfig, OptimizationConfig,
                                     PipelineConfig, RasterConfig)
    from gs_tpu_torch.core.camera import stack_cameras
    from gs_tpu_torch.models.gaussian_model import init_state
    from gs_tpu_torch.models.packed_state import pack_state, unpack_state
    from gs_tpu_torch.train.step import make_train_step

    state = pack_state(init_state(p0, alive0, num_images=1))
    gt = torch.zeros((3, H, W), device=dev)
    out, ms = {}, {}
    for bf16 in (False, True):
        raster = RasterConfig(backend="auto", dup_capacity=DUP_CAPACITY,
                              max_per_tile=MAX_PER_TILE, chunk=64,
                              exact_cull=True, bf16_features=bf16)
        step = make_train_step(OptimizationConfig(iterations=30_000),
                               ModelConfig(), PipelineConfig(), raster,
                               stack_cameras([bench_camera(0)]), 1.0, 3,
                               packed=True)
        out[bf16] = step(state, 0, gt, iteration=1)
        check(not bool(out[bf16][1].overflow), "[bf16 step] overflow")
        t = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(state, 0, gt, iteration=1)
            torch.cuda.synchronize()
            t.append(1e3 * (time.perf_counter() - t0))
        ms[bf16] = float(np.median(t))
    l32, l16 = float(out[False][1].loss), float(out[True][1].loss)
    check(abs(l16 - l32) < 5e-3, f"[bf16 step] loss {l16} vs {l32}")
    m32 = unpack_state(out[False][0]).m
    m16 = unpack_state(out[True][0]).m
    rel = {}
    for name, a, b in zip(m32._fields, m32, m16):
        rel[name] = float((b - a).abs().max()) / max(
            float(a.abs().max()), 1e-30)
        tol = 2e-2 if name.startswith("sh") else 5e-2
        check(rel[name] <= tol or float(a.abs().max()) == 0.0,
              f"[bf16 step] {name}: {rel[name]} > {tol}")
    check(any(v > 0 for v in rel.values()), "[bf16 step] nothing quantised")
    print(f"[bf16 step] the packed bench step with bf16_features against "
          f"f32 on one state: loss {l16:.7f} vs {l32:.7f} (within 5e-3); "
          f"gradient max |diff| / max |f32| per group: "
          + ", ".join(f"{k} {v:.3e}" for k, v in rel.items())
          + f" (rules 5e-2 geometry, 2e-2 SH); ms per step (host clock, "
          f"synchronised, median of 5) bf16 {ms[True]:.3f}, f32 "
          f"{ms[False]:.3f}", flush=True)
    del out, state


def bf16_serve_phase(torch, dev, params, alive, bg, bench_camera, kw,
                     model_dir, orbit_args, counters):
    """[bf16 serve]: FRAMES bench frames through render() with
    bf16_features, each within 1e-2 absolute of the f32 frame (image and
    invdepth; JAX's envelope); K2 and K1 of one bf16 frame against their
    plain versions on their inputs; a zero-green copy of the scene whose
    sorted bf16 pair rows on the card are bitwise the same binning's on
    the CPU, its red surviving; ms per frame, host and device, against the
    f32 frame's; the orbit CLI with --bf16_features. Returns the launches
    of the FRAMES frames and K2's and K1's largest errors."""
    from gs_tpu_torch.apps import view_orbit
    from gs_tpu_torch.core.project import Projected, preprocess
    from gs_tpu_torch.core.sh import C0
    from gs_tpu_torch.ops.binning import (bin_gaussians_payload,
                                          unpack_bf16_pair)
    from gs_tpu_torch.ops.rasterize import raster_tiles_fwd_plain
    from gs_tpu_torch.ops.rasterize_plain import pack_projected
    from gs_tpu_torch.render import render

    kw16 = dict(kw, bf16_features=True)
    host = {"bf16": [], "f32": []}
    with torch.no_grad():
        render(bench_camera(0), params, bg, **kw16)           # warm
        torch.cuda.synchronize()
        launches = dict.fromkeys(counters, 0)
        worst = {"image": 0.0, "invdepth": 0.0}
        for i in range(FRAMES):
            # the two in turns; the launches counted around the bf16 frames
            out = {}
            for name, a in (("f32", kw), ("bf16", kw16)):
                before = {k: c.launches for k, c in counters.items()}
                t0 = time.perf_counter()
                out[name] = render(bench_camera(i), params, bg, **a)
                torch.cuda.synchronize()
                host[name].append(1e3 * (time.perf_counter() - t0))
                if name == "bf16":
                    for k, c in counters.items():
                        launches[k] += c.launches - before[k]
            check(not bool(out["bf16"].overflow),
                  f"[bf16 serve] frame {i} overflow")
            for k in worst:
                worst[k] = max(worst[k], float(
                    (getattr(out["bf16"], k) - getattr(out["f32"], k))
                    .abs().max()))
        check(max(worst.values()) <= 1e-2 and worst["image"] > 0,
              f"[bf16 serve] bf16 frames vs f32: {worst}")
        check(launches["K2"] == launches["K1"] == FRAMES
              and launches["K1g"] == launches["K3"] == launches["ADAM"] == 0
              and all(launches[k] == 0 for k in SSIM_IDS),
              f"[bf16 serve] launches {launches}")
        del out
        cam = bench_camera(0)
        dev_ms = {k: time_ms(torch, lambda a=a: render(cam, params, bg, **a),
                             10) for k, a in (("bf16", kw16), ("f32", kw))}
        busy = {k: profiled_steps(torch, lambda a=a: render(cam, params, bg,
                                                             **a))[:2]
                for k, a in (("bf16", kw16), ("f32", kw))}
        with kernel_calls() as calls:
            render(cam, params, bg, **kw16)
        rows_as_given(calls, ("K1",), 0, "bf16 serve")
        shape = k2_matches(torch, calls, "bf16 serve", "a bf16 frame")
        k1_err = 0.0
        for args, akw, got in calls["K1"]:
            ok, err, frac = images_match(got, raster_tiles_fwd_plain(
                *args, **akw))
            check(ok, f"[bf16 serve] K1 != plain ({err}, {frac})")
            k1_err = max(k1_err, err)
        del calls

        # a zero-green copy: green 0 before the clamp, so every (r, g) pair
        # reads as a float32 denormal
        sh_dc = params.sh_dc.clone()
        sh_dc[:, :, 1] = -0.5 / C0
        sh_rest = params.sh_rest.clone()
        sh_rest[:, :, 1] = 0.0
        green0 = params._replace(sh_dc=sh_dc, sh_rest=sh_rest)
        proj = preprocess(green0, cam, active_sh_degree=3, alive=alive)
        pk = pack_projected(proj)
        bins, cols = bin_gaussians_payload(proj, pk, W, H, 16, 16,
                                           DUP_CAPACITY, bf16_pairs=True)
        projc = Projected(*[None if t is None else t.cpu() for t in proj])
        bins_c, cols_c = bin_gaussians_payload(projc, pk.cpu(), W, H, 16, 16,
                                               DUP_CAPACITY, bf16_pairs=True)
        same = torch.equal(cols.cpu().view(torch.int32),
                           cols_c.view(torch.int32))
        check(same and torch.equal(bins.entry_gid.cpu(), bins_c.entry_gid),
              "[bf16 serve] zero-green sorted payload: card != CPU")
        valid = bins.entry_valid
        r, g = unpack_bf16_pair(cols[6])
        bits = cols[6].view(torch.int32)
        denormal = int((((bits & 0x7F800000) == 0)
                        & ((bits & 0x7FFFFFFF) != 0) & valid).sum())
        check(not bool(g[valid].any()) and bool(r[valid].any()),
              "[bf16 serve] zero-green: red lost or green not zero")
        o16 = render(cam, green0, bg, **kw16)
        o32 = render(cam, green0, bg, **kw)
        red = float((o16.image[0] - o32.image[0]).abs().max())
        check(red <= 1e-2 and float(o16.image[0].max()) > 0.1,
              f"[bf16 serve] zero-green red {red}")
        n_valid = int(valid.sum())
        del proj, pk, bins, cols, projc, bins_c, cols_c, o16, o32, green0
    print(f"[bf16 serve] {FRAMES} bench frames with bf16_features: max "
          f"|bf16 - f32| image {worst['image']:.3e}, invdepth "
          f"{worst['invdepth']:.3e} (rule 1e-2); launches {launches}; K2 "
          f"{shape}, bitwise; K1 max |kernel - plain| {k1_err:.3e}; ms per "
          f"frame, host (synchronised, in turns): "
          + "; ".join(f"{k} " + ", ".join(f"{x:.2f}" for x in v)
                      + f", median {float(np.median(v)):.3f}"
                      for k, v in host.items())
          + f"; render() on the device stream (CUDA events, mean of 10): "
          f"bf16 {dev_ms['bf16']:.4f}, f32 {dev_ms['f32']:.4f}; device busy "
          f"(median of {PROFILED_STEPS} profiled frames) and launches: "
          + ", ".join(f"{k} {v[0]:.4f} ms in {v[1]}" for k, v in busy.items()),
          flush=True)
    print(f"[bf16 serve] zero-green scene: the sorted payload on the card is "
          f"bitwise the CPU binning's ({n_valid} entries, {denormal} pairs "
          f"that read as float32 denormals); red within {red:.3e} of the "
          f"f32 frame's", flush=True)
    for c in counters.values():
        c.launches = 0
    log = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        view_orbit.main(orbit_args + ["--bf16_features"])
    orbit = {k: counters[k].launches for k in ("K2", "K1")}
    check("overflow" not in log.getvalue(), "[bf16 serve] orbit overflow")
    check(all(v == 2 for v in orbit.values()),
          f"[bf16 serve] orbit launches {orbit}")
    check(sorted(os.listdir(os.path.join(model_dir, "orbit_30000")))
          == ["00000.png", "00001.png"], "[bf16 serve] orbit PNGs")
    print(f"[bf16 serve] orbit CLI --bf16_features: 2 frames in "
          f"{time.perf_counter() - t0:.2f} s, launches {orbit}", flush=True)
    return launches, {"K2": 0.0, "K1": k1_err}


def packed_trainer_phase(torch, dev, root, counters):
    """[packed trainer]: Trainer(packed=True) against Trainer(packed=False)
    on the [trainer] dataset (1,048,576 slots), PACKED_ITERS iterations
    through an overflow replay (TRAINER_DUP, syncs every 10) and a densify
    at 50 (at a threshold in a gap of the packed run's gradients, the same
    for both): equal alive masks, parameters within the Trainer rule of
    tests/test_torch_trainer.py, test PSNR equal within 1e-3 dB; ms and
    launches per iteration over PACKED_STEADY."""
    import dataclasses
    import random
    from gs_tpu_torch.config import (ModelConfig, OptimizationConfig,
                                     PipelineConfig, RasterConfig)
    from gs_tpu_torch.data.scene import Scene
    from gs_tpu_torch.models.gaussian_model import group_lrs
    from gs_tpu_torch.models.packed_state import PackedState
    from gs_tpu_torch.train.loop import Trainer

    random.seed(0)
    scene = Scene(root, "", resolution=1, eval_split=True, device=dev)
    opt = OptimizationConfig(iterations=300, densify_from_iter=10,
                             densification_interval=50, densify_until_iter=60,
                             opacity_reset_interval=1000)
    thresholds, runs = {}, {}
    for packed in (True, False):
        # made inside the probe, so that the threshold's wrapper calls the
        # probe's densify
        with contextlib.redirect_stdout(io.StringIO()), \
                probe_trainer(torch, counters, steady=PACKED_STEADY) as rec:
            tr = Trainer(scene.get_train_cameras(), scene.point_cloud,
                         spatial_lr_scale=scene.cameras_extent,
                         model_cfg=ModelConfig(data_device=str(dev)),
                         opt=opt, pipe=PipelineConfig(),
                         raster=RasterConfig(dup_capacity=TRAINER_DUP),
                         test_cams=scene.get_test_cameras(), seed=0,
                         packed=packed)
            tr.sync_every = 10
            check(isinstance(tr.state, PackedState) == packed,
                  f"[packed trainer] packed={packed}: the other layout")
            densify = tr._densify

            def at_threshold(state, use_size_threshold, _tr=tr, _d=densify):
                if _tr.iteration not in thresholds:
                    thresholds[_tr.iteration] = gap_threshold(state)
                _tr.opt = dataclasses.replace(
                    _tr.opt,
                    densify_grad_threshold=thresholds[_tr.iteration][0])
                return _d(state, use_size_threshold)

            tr._densify = at_threshold
            tr.train(iterations=PACKED_ITERS)
        torch.cuda.synchronize()
        ms, per_it = steady_window(rec, counters, PACKED_STEADY)
        check(rec["replay"] and tr.overflow_exhausted == 0,
              f"[packed trainer] packed={packed}: no replay")
        check(len(rec["densify"]) >= 1, "[packed trainer] no densify")
        check(all(per_it[k] == 1 for k in ("K1g", "K2", "K3", "K4"))
              and all(per_it[k] == int(packed)
                      for k in PRE_IDS + ("ADAM",)),
              f"[packed trainer] packed={packed}: launches per iteration "
              f"{per_it}")
        runs[packed] = dict(tr=tr, ms=ms, per_it=per_it,
                            psnr=tr.evaluate(tr.test_cams)["psnr"],
                            densify=rec["densify"][-1])
    pk, tree = runs[True]["tr"], runs[False]["tr"]
    check(torch.equal(pk.state.alive, tree.state.alive),
          f"[packed trainer] alive masks differ in "
          f"{int((pk.state.alive != tree.state.alive).sum())} slots")
    worst = {}
    for name, a, b in zip(tree.state.params._fields, tree.state.params,
                          pk.state.params):
        diff = (a - b).abs()
        beyond = float((diff > 2e-4 * a.abs().max()).double().mean())
        lr = max(getattr(group_lrs(opt, 1, tree.spatial_lr_scale), name),
                 getattr(group_lrs(opt, PACKED_ITERS, tree.spatial_lr_scale),
                         name))
        worst[name] = (beyond, float(diff.max()) / lr)
        check(beyond <= 0.01 and float(diff.max()) <= 2.01 * PACKED_ITERS * lr,
              f"[packed trainer] {name}: {beyond:.2%} beyond 2e-4 x max, "
              f"{float(diff.max()) / lr:.2f} lr")
    dpsnr = abs(runs[True]["psnr"] - runs[False]["psnr"])
    check(dpsnr < 1e-3, f"[packed trainer] test PSNR differs by {dpsnr}")
    d = runs[True]["densify"]
    print(f"[packed trainer] {PACKED_ITERS} iterations of the [trainer] "
          f"dataset, {pk.capacity} slots, packed against tree: equal alive "
          f"masks ({pk.num_alive()}); densify at {d['iteration']} cloned "
          f"{d['n_cloned']}, split {d['n_split']} (thresholds {thresholds}); "
          f"per parameter (share beyond 2e-4 x max, max diff in lr): "
          + ", ".join(f"{k} {v[0]:.3%} {v[1]:.3f}" for k, v in worst.items())
          + f"; test PSNR {runs[True]['psnr']:.4f} vs "
          f"{runs[False]['psnr']:.4f} dB; ms per iteration over "
          f"{PACKED_STEADY[0] + 1}..{PACKED_STEADY[1]} (host clock, "
          f"synchronised at both ends): packed {runs[True]['ms']:.3f}, tree "
          f"{runs[False]['ms']:.3f}; launches per iteration "
          f"{runs[True]['per_it']}", flush=True)
    for packed in (True, False):
        tr = runs[packed]["tr"]
        busy, n_launch, rows = profiled_steps(torch, tr.step)
        it_ms = runs[packed]["ms"]
        print(f"[packed trainer] {'packed' if packed else 'tree'}: one "
              f"iteration's device busy {busy:.4f} ms (median of "
              f"{PROFILED_STEPS} profiled one by one) in {n_launch} kernel "
              f"launches, idle {1 - busy / it_ms:.1%} of the {it_ms:.3f} ms "
              f"iteration; " + ", ".join(f"{k} {v[0]:.4f} ms ({v[1]} calls)"
                                         for k, v in rows.items()),
              flush=True)
    del runs, pk, tree, tr, scene


# ------------------------------------------------------- the block dispatch

GRAPH_ITERS = 200              # [graph trainer]: densifies at 100 and 150
GRAPH_CAPACITY = 524_288       # 95 % of it alive: the densify at 100 grows it
GRAPH_STEADY = (150, 199)      # no capture, densify, sync or eval in 151..199
GRAPH_BUCKET = 50              # --densification_interval: the chain's bucket
OPTION_ITERS = 30              # [graph options]: evaluations at 10 and 30


def state_equal(torch, a, b) -> bool:
    from gs_tpu_torch.train.graph import state_leaves
    return all(x.dtype == y.dtype and torch.equal(x, y)
               for x, y in zip(state_leaves(a), state_leaves(b)))


def state_spread(torch, a, b) -> list:
    """Per state tensor, the largest |a - b| (0 for equal integer tensors,
    inf for unequal ones)."""
    from gs_tpu_torch.train.graph import state_leaves
    out = []
    for x, y in zip(state_leaves(a), state_leaves(b)):
        if x.is_floating_point():
            out.append(float((x - y).abs().max()) if x.numel() else 0.0)
        else:
            out.append(0.0 if torch.equal(x, y) else math.inf)
    return out


def graph_step_phase(torch, dev, p0, alive0, bench_camera, counters):
    """[graph step]: the packed bench step ([packed step]'s configuration)
    from one state for TRAIN_STEPS steps, eager twice and through the chain
    graph (``train/graph.py::make_train_step_chain``: one capture, one
    replay a step). The two eager runs first, against each other; the graph
    run bitwise the first eager run (states and metrics), or, if the eager
    step is not bitwise against itself, within its own run-to-run spread.
    Reports host ms per step (median), device busy (median of
    PROFILED_STEPS profiled one by one), kernel launches per step, the
    capture's ms and its graph pool's peak. Returns the wrappers' launches
    over the replays."""
    from gs_tpu_torch.config import (ModelConfig, OptimizationConfig,
                                     PipelineConfig, RasterConfig)
    from gs_tpu_torch.core.camera import stack_cameras
    from gs_tpu_torch.models.gaussian_model import init_state
    from gs_tpu_torch.models.packed_state import pack_state
    from gs_tpu_torch.train.graph import TrainingData, make_train_step_chain
    from gs_tpu_torch.train.step import make_train_step

    opt = OptimizationConfig(iterations=30_000)
    raster = RasterConfig(backend="auto", dup_capacity=DUP_CAPACITY,
                          max_per_tile=MAX_PER_TILE, chunk=64, exact_cull=True)
    step = make_train_step(opt, ModelConfig(), PipelineConfig(), raster,
                           stack_cameras([bench_camera(0)]), 1.0, 3,
                           packed=True)
    s0 = pack_state(init_state(p0, alive0, num_images=1))
    gt = torch.zeros((3, H, W), device=dev)
    fields = ("loss", "l1", "ssim", "num_duplicates", "max_tile_len",
              "overflow", "n_visible")

    def eager_run():
        st, ms, times = s0, [], []
        for it in range(1, TRAIN_STEPS + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st, m = step(st, 0, gt, iteration=it)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
            ms.append([getattr(m, f).clone() for f in fields])
        return st, ms, times

    e1, e2 = eager_run(), eager_run()
    eager_bitwise = state_equal(torch, e1[0], e2[0]) and all(
        torch.equal(a, b) for x, y in zip(e1[1], e2[1]) for a, b in zip(x, y))
    spread = state_spread(torch, e1[0], e2[0])
    print(f"[graph step] the eager bench step against itself, "
          f"{TRAIN_STEPS} steps from one state twice: "
          + ("bitwise equal" if eager_bitwise else
             f"not bitwise; largest |run 1 - run 2| per state tensor "
             f"{spread}"), flush=True)

    chain = make_train_step_chain(step, use_alpha=False, use_depth=False,
                                  bucket=TRAIN_STEPS)
    its = np.arange(1, TRAIN_STEPS + 1)
    ints = torch.from_numpy(np.stack([np.zeros_like(its), its], 1))
    floats = torch.zeros((TRAIN_STEPS, 6))
    floats[:, :3] = torch.from_numpy(step.schedule(its))
    chain.load(ints, floats, its)
    data = TrainingData(gt[None])
    before = {k: c.launches for k, c in counters.items()}
    chain.bind(s0, data)
    check(chain.graph is not None and len(chain.captures) == 1,
          "[graph step] no capture")
    cap = chain.captures[0]
    warm = {k: c.launches - before[k] for k, c in counters.items()}
    gs, gms, gtimes = chain.state, [], []
    before = {k: c.launches for k, c in counters.items()}
    for j in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gs, m = chain(gs, data, j)
        torch.cuda.synchronize()
        gtimes.append(1e3 * (time.perf_counter() - t0))
        gms.append([getattr(m, f).clone() for f in fields])
    launches = {k: c.launches - before[k] for k, c in counters.items()}
    check(all(launches[k] == TRAIN_STEPS for k in ("K1g", "K2", "K3", "K4")
              + PRE_IDS + ("ADAM",)) and launches["K1"] == 0,
          f"[graph step] launches {launches}")
    check(not any(bool(m[fields.index("overflow")]) for m in gms),
          "[graph step] overflow")
    graph_bitwise = state_equal(torch, gs, e1[0]) and all(
        torch.equal(a, b) for x, y in zip(gms, e1[1]) for a, b in zip(x, y))
    losses = [float(m[0]) for m in gms]
    if eager_bitwise:
        check(graph_bitwise, "[graph step] the graph step is not bitwise "
              "the eager step, which is bitwise against itself: "
              f"{state_spread(torch, gs, e1[0])}")
        how = "bitwise the eager run (states and every metric)"
    else:
        got = state_spread(torch, gs, e1[0])
        check(all(g <= s for g, s in zip(got, spread)),
              f"[graph step] beyond the eager run-to-run spread: {got} "
              f"against {spread}")
        how = (f"within the eager run-to-run spread (largest |graph - "
               f"eager| per tensor {got}, spread {spread})")
    check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
          f"[graph step] losses {losses}")
    eager_busy, eager_n, _ = profiled_steps(torch, lambda: step(
        e1[0], 0, gt, iteration=TRAIN_STEPS + 1))
    graph_busy, graph_n, _ = profiled_steps(torch, lambda: chain(
        gs, data, TRAIN_STEPS - 1))
    e_ms, g_ms = float(np.median(e1[2])), float(np.median(gtimes))
    print(f"[graph step] {TRAIN_STEPS} bench steps through the chain graph "
          f"from the same state: {how}; losses "
          + ", ".join(f"{x:.7f}" for x in losses)
          + f"; launches over the replays {launches} (the warm-up's "
          f"{warm}); capture {cap['ms']:.1f} ms, graph pool peak "
          f"{cap['pool_peak_bytes']} bytes", flush=True)
    busy_note = ("" if graph_busy > 0 else
                 " (the profiler saw no kernel of the replay: graph busy "
                 "not measured)")
    print(f"[graph step] ms per step (host clock, synchronised, median of "
          f"{TRAIN_STEPS}): eager {e_ms:.3f} (second run "
          f"{float(np.median(e2[2])):.3f}), graph {g_ms:.3f}; device busy "
          f"(median of {PROFILED_STEPS} profiled one by one): eager "
          f"{eager_busy:.4f} ms in {eager_n} kernel launches, graph "
          f"{graph_busy:.4f} ms in {graph_n}{busy_note}; idle eager "
          f"{1 - eager_busy / e_ms:.1%}, graph {1 - graph_busy / g_ms:.1%}",
          flush=True)
    del e1, e2, chain, gs
    return launches


def run_train_cli(torch, args, counters, steady=None, eager=False):
    """The training CLI on ``args``: with ``eager`` the Trainer's private
    ``_eager_dispatch`` (step mode's eager step and view, the reference of
    the graphs; the CLI has a flag for neither, as the JAX CLI has none).
    Records the syncs and replays (probe_trainer), the host
    ms of the block that starts at ``steady[0]`` (block mode) or of the
    iterations steady[0]+1..steady[1] (step mode), and the launch counts.
    Returns the Trainer, the record, that window's ms per iteration, the
    launches and the CLI's output."""
    from gs_tpu_torch.apps import train as train_app
    from gs_tpu_torch.train import loop
    T = loop.Trainer
    init, run_block = T.__init__, T.run_block
    window = {}

    def set_dispatch(self, *a, **kw):
        init(self, *a, **kw)
        self._eager_dispatch = eager

    def timed_block(self, k):
        if steady is None or self.iteration != steady[0] or self._replaying:
            return run_block(self, k)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run_block(self, k)
        torch.cuda.synchronize()
        window["ms"] = 1e3 * (time.perf_counter() - t0) / k
        return out

    T.__init__, T.run_block = set_dispatch, timed_block
    for c in counters.values():
        c.launches = 0
    log = io.StringIO()
    try:
        with probe_trainer(torch, counters, steady=steady or STEADY) as rec, \
                contextlib.redirect_stdout(log):
            tr = train_app.main(args)
        torch.cuda.synchronize()
    finally:
        T.__init__, T.run_block = init, run_block
    launches = {k: c.launches for k, c in counters.items()}
    if "ms" not in window and rec["steady"].get("t1") is not None:
        window["ms"] = steady_window(rec, counters, steady)[0]
    return tr, rec, window.get("ms"), launches, log.getvalue()


def graph_trainer_phase(torch, dev, root, counters):
    """[graph trainer]: the [trainer] dataset through the training CLI in
    its default block mode on CUDA (the chain) against --no_block_scan
    (step mode): GRAPH_ITERS iterations from
    GRAPH_CAPACITY slots, the first sync's overflow replay (TRAINER_DUP),
    a densify and opacity reset at 100 whose growth to 4x the capacity
    captures again, a densify at 150; the step-mode run is the eager one
    (``_eager_dispatch``), the reference. The losses at every sync and the
    final states of the two runs: bitwise, or, if not, within a second
    step-mode run's spread. The chain run's last evaluation renders its
    test view through the view graph at 2,097,152 slots: its capture's ms
    and pool peak beside the chain's. ms per iteration over GRAPH_STEADY (the block
    151..200 in block mode), device busy per iteration over one more
    bucket at the same capacity, idle share, every capture's ms and pool
    peak, and each run's
    launches (a chain run launches what the step-mode run does plus one
    warm-up step per capture). Returns the chain run's launches."""
    from gs_tpu_torch.train.graph import state_leaves
    model = os.path.join(os.path.dirname(root), "graph_model")
    args = ["-s", root, "-m", model, "-r", "1", "--eval",
            "--iterations", str(GRAPH_ITERS),
            "--densify_from_iter", "50",
            "--densification_interval", str(GRAPH_BUCKET),
            "--densify_until_iter", "160", "--opacity_reset_interval", "100",
            "--test_iterations", str(GRAPH_ITERS),
            "--save_iterations", str(GRAPH_ITERS),
            "--initial_capacity", str(GRAPH_CAPACITY),
            "--dup_capacity", str(TRAINER_DUP), "--disable_viewer",
            "--data_device", dev.type]
    runs = {}
    for name, extra in (("step", ["--no_block_scan"]), ("chain", [])):
        t0 = time.perf_counter()
        tr, rec, ms, launches, out = run_train_cli(
            torch, args + extra, counters,
            steady=(GRAPH_STEADY if name == "step"
                    else (GRAPH_STEADY[0], GRAPH_STEADY[1] + 1)),
            eager=name == "step")
        wall = time.perf_counter() - t0
        check(tr.iteration == GRAPH_ITERS, f"[graph trainer] {name}: "
              f"stopped at {tr.iteration}")
        check(rec["replay"] and tr.overflow_exhausted == 0,
              f"[graph trainer] {name}: no overflow replay")
        check(tr.state.capacity == 4 * GRAPH_CAPACITY,
              f"[graph trainer] {name}: no growth ({tr.state.capacity})")
        check(all(math.isfinite(x) for _, x, _ in rec["syncs"]),
              f"[graph trainer] {name}: non-finite loss")
        if name == "step":
            check(not tr.captures, "[graph trainer] the eager step mode "
                  "captured")
        else:
            check(len(tr.captures) >= 2 and "captured the" in out,
                  f"[graph trainer] {name}: captures {tr.captures}")
        check(all(v > 0 for v in launches.values()),
              f"[graph trainer] {name}: launches {launches}")
        if name == "step":
            # one preprocess forward and backward, one Adam and one SSIM
            # pair a training step (the eager views render the tree layout)
            check(launches["PRE"] == launches["K1g"]
                  and launches["PRE_bwd"] == launches["K3"]
                  == launches["ADAM"] == launches["SSIM"]
                  == launches["SSIM_bwd"],
                  f"[graph trainer] step: launches {launches}")
        # one bucket more of the trained state, profiled, no schedule and no
        # sync in it: the device's busy time per iteration
        def bucket():
            if name == "step":
                for _ in range(GRAPH_BUCKET):
                    tr._dispatch_step()
            else:
                tr.run_block(GRAPH_BUCKET)

        busy, n_k = (x / GRAPH_BUCKET for x in busy_per_call(torch, bucket))
        runs[name] = dict(rec=rec, ms=ms, launches=launches,
                          wall=wall, busy=busy, kernels=n_k,
                          state=[t.clone() for t in state_leaves(tr.state)],
                          captures=list(tr.captures),
                          views=list(tr.views.captures))
        first, last = GRAPH_STEADY[0] + 1, GRAPH_STEADY[1]
        print(f"[graph trainer] {name}: {GRAPH_ITERS} iterations through "
              f"gs_tpu_torch.apps.train.main in {wall:.2f} s; ms per "
              f"iteration {ms:.3f} (host clock, synchronised, over "
              + (f"{first}..{last}" if name == "step"
                 else f"the block {first}..{last + 1}")
              + f"); device busy {busy:.4f} ms per iteration over one "
              f"profiled bucket of {GRAPH_BUCKET} ({n_k:.1f} kernels each)"
              + ", " + idle_text(busy, ms)
              + f"; launches {launches}; replays "
              + ", ".join(f"{r['window']} {r['ms']:.1f} ms"
                          for r in rec["replay"])
              + f"; captures " + ", ".join(
                  f"capacity {c['capacity']} {c['ms']:.1f} ms pool peak "
                  f"{c['pool_peak_bytes']}" for c in tr.captures)
              + "; view captures " + (", ".join(
                  f"{c['width']}x{c['height']} at capacity {c['capacity']} "
                  f"{c['ms']:.1f} ms pool peak {c['pool_peak_bytes']}"
                  for c in tr.views.captures) or "none (eager views)"),
              flush=True)
        del tr
    step, r = runs["step"], runs["chain"]
    syncs = [x for _, x, _ in r["rec"]["syncs"]]
    ref = [x for _, x, _ in step["rec"]["syncs"]]
    bitwise = syncs == ref and all(
        torch.equal(a, b) for a, b in zip(r["state"], step["state"]))
    if not bitwise:
        # the eager run's own spread decides
        tr2, rec2, _, _, _ = run_train_cli(torch, args + [
            "--no_block_scan"], counters, eager=True)
        spread = [float((a - b).abs().max()) if a.is_floating_point()
                  else (0.0 if torch.equal(a, b) else math.inf)
                  for a, b in zip(state_leaves(tr2.state), step["state"])]
        got = [float((a - b).abs().max()) if a.is_floating_point()
               else (0.0 if torch.equal(a, b) else math.inf)
               for a, b in zip(r["state"], step["state"])]
        check(all(g <= s for g, s in zip(got, spread)),
              f"[graph trainer] chain against step mode {got}, beyond "
              f"the step mode's run-to-run spread {spread}")
        del tr2
    print(f"[graph trainer] chain against step mode: losses at the "
          f"syncs " + ", ".join(f"{i}: {x:.7f}"
                                 for i, x, _ in r["rec"]["syncs"])
          + (" and the final state bitwise equal" if bitwise else
             " within the step mode's run-to-run spread"), flush=True)
    # a chain run launches the eager step-mode run's kernels plus one
    # warm-up step per capture, and K2 once more per capture of the view
    # graph (its evaluation's view); K1 only in the evaluations, and the
    # preprocess forward with each K1 of the graphed views
    n_cap = len(runs["chain"]["captures"])
    n_views = len(runs["chain"]["views"])
    chain_k1 = runs["chain"]["launches"]["K1"]
    for k in ("K2", "K1g", "K3", "K4") + PRE_IDS + ("ADAM",) + SSIM_IDS:
        want = (step["launches"][k] + n_cap + (n_views if k == "K2" else 0)
                + (chain_k1 if k == "PRE" else 0))
        check(runs["chain"]["launches"][k] == want,
              f"[graph trainer] chain {k} launches "
              f"{runs['chain']['launches'][k]} != {want}")
    launches = runs["chain"]["launches"]
    del runs, step
    return launches


def option_datasets(torch, dev, root, p0, alive0):
    """Two variants of the [trainer] dataset for [graph options]: ``depths``
    beside its images (each view's inverse depth from a K1 render, as a
    16-bit PNG, and depth_params.json with its scale), and a copy whose
    last view is W - 16 pixels wide (its own PINHOLE camera), so the
    Trainer gets views of unequal size."""
    from PIL import Image
    from gs_tpu_torch.core.camera import focal2fov, make_camera
    from gs_tpu_torch.data import colmap
    from gs_tpu_torch.render import render
    sparse = os.path.join(root, "sparse", "0")
    extr = colmap.read_extrinsics_binary(os.path.join(sparse, "images.bin"))
    intr = colmap.read_intrinsics_binary(os.path.join(sparse, "cameras.bin"))
    fx = intr[1].params[0]
    fovx = 2 * math.atan(W / (2 * fx))
    os.makedirs(os.path.join(root, "depths"), exist_ok=True)
    params, narrow = {}, W - 16
    uneven = os.path.join(os.path.dirname(root), "uneven")
    os.makedirs(os.path.join(uneven, "sparse", "0"))
    os.makedirs(os.path.join(uneven, "images"))
    last = max(extr)
    with torch.no_grad():
        for k, e in sorted(extr.items()):
            cam = make_camera(np.eye(3), e.tvec, fovx, focal2fov(fx, H), W, H,
                              device=dev)
            out = render(cam, p0, torch.zeros(3, device=dev),
                         active_sh_degree=3, alive=alive0,
                         dup_capacity=1 << 23, max_per_tile=4096,
                         exact_cull=True)
            inv = out.invdepth[0].cpu().numpy()
            scale = float(inv.max())
            base = os.path.splitext(e.name)[0]
            Image.fromarray(np.round(inv / scale * 65535).astype(np.uint16)
                            ).save(os.path.join(root, "depths", base + ".png"))
            params[base] = {"scale": scale, "offset": 0.0}
            src = os.path.join(root, "images", e.name)
            dst = os.path.join(uneven, "images", e.name)
            if k == last:
                cam = make_camera(np.eye(3), e.tvec,
                                  focal2fov(fx, narrow), focal2fov(fx, H),
                                  narrow, H, device=dev)
                img = render(cam, p0, torch.zeros(3, device=dev),
                             active_sh_degree=3, alive=alive0,
                             dup_capacity=1 << 23, max_per_tile=4096,
                             exact_cull=True).image
                arr = (np.clip(img.cpu().numpy(), 0, 1) * 255 + 0.5)
                Image.fromarray(arr.astype(np.uint8).transpose(1, 2, 0)
                                ).save(dst)
            else:
                os.symlink(src, dst)
            del out
    with open(os.path.join(sparse, "depth_params.json"), "w") as f:
        json.dump(params, f)
    intr2 = dict(intr)
    intr2[2] = colmap.Intrinsics(2, "PINHOLE", narrow, H, np.array(
        [fx, fx, narrow / 2, H / 2]))
    extr2 = {k: (e._replace(camera_id=2) if k == last else e)
             for k, e in extr.items()}
    colmap.write_intrinsics_binary(intr2, os.path.join(uneven, "sparse", "0",
                                                       "cameras.bin"))
    colmap.write_extrinsics_binary(extr2, os.path.join(uneven, "sparse", "0",
                                                       "images.bin"))
    os.symlink(os.path.join(sparse, "points3D.bin"),
               os.path.join(uneven, "sparse", "0", "points3D.bin"))
    return uneven


def graph_options_phase(torch, dev, root, p0, alive0, counters):
    """[graph options] (the reference's optional training paths): the
    [trainer] dataset through the training CLI's default block mode for
    OPTION_ITERS iterations (1,048,576 slots, evaluations at 10 and 30)
    with each of -d depths, --train_test_exp, --antialiasing,
    --optimizer_type sparse_adam and --random_background, and on a copy
    whose views are of unequal size. For each: every sync's loss finite,
    the training views' L1 lower at 30 than at 10, and one more step of the
    trained state through the captured graph bitwise the same step run
    eagerly (functional, on a copy) with the same inputs."""
    from gs_tpu_torch.train.graph import clone_state
    uneven = option_datasets(torch, dev, root, p0, alive0)
    base = ["-r", "1", "--eval", "--iterations", str(OPTION_ITERS),
            "--test_iterations", "10", str(OPTION_ITERS),
            "--save_iterations", str(OPTION_ITERS),
            "--dup_capacity", str(TRAINER_DUP), "--disable_viewer",
            "--quiet", "--data_device", dev.type]
    cases = (("depth", root, ["-d", "depths"]),
             ("train_test_exp", root, ["--train_test_exp"]),
             ("antialiasing", root, ["--antialiasing"]),
             ("sparse_adam", root, ["--optimizer_type", "sparse_adam"]),
             ("random_background", root, ["--random_background"]),
             ("unequal views", uneven, []))
    results = {}
    for name, src, extra in cases:
        model = os.path.join(os.path.dirname(root), "opt_" + name[:5])
        evals = []
        from gs_tpu_torch.train import loop
        evaluate = loop.Trainer.evaluate

        def record(self, cams, max_views=None):
            out = evaluate(self, cams, max_views)
            if cams is not self.test_cams:
                evals.append((self.iteration, out["l1"]))
            return out

        loop.Trainer.evaluate = record
        t0 = time.perf_counter()
        try:
            tr, rec, _, launches, out = run_train_cli(
                torch, ["-s", src, "-m", model] + base + extra, counters)
        finally:
            loop.Trainer.evaluate = evaluate
        wall = time.perf_counter() - t0
        losses = [x for _, x, _ in rec["syncs"]]
        check(tr.iteration == OPTION_ITERS and losses
              and all(math.isfinite(x) for x in losses),
              f"[graph options] {name}: losses {losses}")
        check(len(evals) == 2 and evals[1][1] < evals[0][1],
              f"[graph options] {name}: the training views' L1 did not "
              f"fall: {evals}")
        check(tr._runner is not None and tr._runner.graph is not None,
              f"[graph options] {name}: no graph")
        if name == "depth":
            check(tr.use_depth and bool((tr.depth_oks > 0).any()),
                  "[graph options] depth: no depth prior loaded")
        if name == "unequal views":
            check("non-uniform camera resolutions" in out,
                  "[graph options] unequal views were not resized")
        # one more step: the replay against the eager step on a copy
        runner = tr._runner
        cams = [tr._next_camera()]
        runner.load(*tr._bucket_inputs(cams, runner.bucket))
        ref_state, ref = runner.step_body(clone_state(tr.state),
                                          runner.ints[0], runner.floats[0],
                                          inplace=False)
        ref = [x.clone() for x in ref if isinstance(x, torch.Tensor)]
        st, m = runner(tr.state, tr._data, 0)
        got = [x for x in m if isinstance(x, torch.Tensor)]
        same = state_equal(torch, st, ref_state) and all(
            torch.equal(a, b) for a, b in zip(got, ref))
        check(same, f"[graph options] {name}: the graph step is not the "
              f"eager step: {state_spread(torch, st, ref_state)}")
        results[name] = (losses, evals, wall, launches)
        print(f"[graph options] {name}: {OPTION_ITERS} iterations in "
              f"{wall:.2f} s; losses at the syncs "
              + ", ".join(f"{x:.6f}" for x in losses)
              + f"; training views' L1 " + ", ".join(
                  f"{i}: {x:.5f}" for i, x in evals)
              + f"; one more step through the graph bitwise the eager step "
              f"(camera {cams[0]}); launches {launches}", flush=True)
        del tr, runner, ref_state, st
    return results


STEP_GRAPH_ITERS = 60          # [step graph]: reset 30, densify 40, sync 50
STEP_GRAPH_EXTRA = 20          # the timed steps after each run
STEP_GRAPH_RANDOM_ITERS = 30   # its --random_background pair: sync at 30


def step_graph_phase(torch, dev, root, counters):
    """[step graph]: step mode through its CUDA graph
    (``train/graph.py::ChainStep.step``) against the eager step
    mode (the Trainer's private ``_eager_dispatch``), on the [trainer]
    dataset at 1,048,576 slots through the training CLI with
    --no_block_scan: STEP_GRAPH_ITERS iterations with an opacity reset at
    30, a densify at 40 and the first sync's (at 50) --dup_capacity
    overflow, whose window replays at grown buffers (the graph captured
    again); then a pair with --random_background (STEP_GRAPH_RANDOM_ITERS
    iterations, a reset at 15, a densify at 20, the overflow at the sync at
    30). Each pair: the losses at every sync and the final state bitwise.
    After each run, STEP_GRAPH_EXTRA more steps timed by host clock
    (synchronised at both ends, the launch counters read around them) and
    10 more profiled with device records only: ms, busy, idle and kernels
    per iteration, graphed against eager; each capture's ms and pool peak;
    the metrics one step returns keep their values after the next step.
    Returns the graphed runs' launches (the counts set to 0 just before
    each and read just after)."""
    from gs_tpu_torch.train.graph import state_leaves

    def args_for(name, iters, reset, densify, extra):
        model = os.path.join(os.path.dirname(root), "step_graph_" + name)
        return ["-s", root, "-m", model, "-r", "1", "--eval",
                "--iterations", str(iters), "--densify_from_iter",
                str(densify // 2), "--densification_interval", str(densify),
                "--densify_until_iter", str(densify + 5),
                "--opacity_reset_interval", str(reset),
                "--test_iterations", str(iters), "--save_iterations",
                str(iters), "--dup_capacity", str(TRAINER_DUP),
                "--disable_viewer", "--quiet", "--data_device", dev.type,
                "--no_block_scan"] + extra

    pairs = (("static", args_for("static", STEP_GRAPH_ITERS, 30, 40, [])),
             ("random", args_for("random", STEP_GRAPH_RANDOM_ITERS, 15, 20,
                                 ["--random_background"])))
    graph_launches = {k: 0 for k in counters}
    for pair, args in pairs:
        runs = {}
        for how in ("graph", "eager"):
            t0 = time.perf_counter()
            tr, rec, _, launches, out = run_train_cli(
                torch, args, counters, eager=how == "eager")
            wall = time.perf_counter() - t0
            iters = tr.iteration
            check(rec["replay"] and tr.overflow_exhausted == 0,
                  f"[step graph] {pair} {how}: no overflow replay")
            check(any(d["iteration"] > 0 for d in rec["densify"]),
                  f"[step graph] {pair} {how}: no densify")
            check(all(math.isfinite(x) for _, x, _ in rec["syncs"]),
                  f"[step graph] {pair} {how}: non-finite loss")
            if how == "graph":
                check(tr._runner is not None and len(tr.captures) >= 2
                      and "captured the chain step" in out,
                      f"[step graph] {pair}: captures {tr.captures}")
                check(all(launches[k] > iters for k in ("K2", "K1g", "K3",
                                                         "K4") + PRE_IDS
                          + ("ADAM",) + SSIM_IDS),
                      f"[step graph] {pair}: launches {launches}")
                for k, v in launches.items():
                    graph_launches[k] += v
            else:
                check(not tr.captures, f"[step graph] {pair}: the eager "
                      f"step mode captured")
            state = [t.clone() for t in state_leaves(tr.state)]
            # the metrics of a step keep their values after the next one
            first = tr.step()
            kept = [x.clone() for x in first if x is not None]
            tr.step()
            torch.cuda.synchronize()
            survive = all(torch.equal(x, y) for x, y in zip(
                [x for x in first if x is not None], kept))
            check(survive, f"[step graph] {pair} {how}: a step's metrics "
                  f"changed at the next step")
            c0 = {k: c.launches for k, c in counters.items()}
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            for _ in range(STEP_GRAPH_EXTRA):
                tr._dispatch_step()
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t1) / STEP_GRAPH_EXTRA
            per_it = {k: (c.launches - c0[k]) / STEP_GRAPH_EXTRA
                      for k, c in counters.items()}
            check(all(per_it[k] == 1 for k in ("K2", "K1g", "K3", "K4")
                      + PRE_IDS + ("ADAM",) + SSIM_IDS) and per_it["K1"] == 0,
                  f"[step graph] {pair} {how}: launches per iteration "
                  f"{per_it}")
            busy, n_k = busy_per_call(torch, tr._dispatch_step, 10)
            runs[how] = dict(syncs=[x for _, x, _ in rec["syncs"]],
                             state=state, ms=ms, busy=busy)
            print(f"[step graph] {pair} {how}: {iters} iterations through "
                  f"gs_tpu_torch.apps.train.main --no_block_scan in "
                  f"{wall:.2f} s; syncs " + ", ".join(
                      f"{i}: {x:.7f}" for i, x, _ in rec["syncs"])
                  + f"; replays " + ", ".join(
                      f"{r['window']} {r['ms']:.1f} ms" for r in rec["replay"])
                  + f"; launches {launches}; {STEP_GRAPH_EXTRA} more steps "
                  f"{ms:.3f} ms per iteration (host clock, synchronised), "
                  f"launches per iteration {per_it}; device busy "
                  f"{busy:.4f} ms per iteration over 10 more profiled "
                  f"({n_k:.1f} kernels each)"
                  + ", " + idle_text(busy, ms)
                  + f"; a step's metrics kept after the next; captures "
                  + (", ".join(f"capacity {c['capacity']} {c['ms']:.1f} ms "
                               f"pool peak {c['pool_peak_bytes']}"
                               for c in tr.captures) or "none"), flush=True)
            del tr
            torch.cuda.empty_cache()
        g, e = runs["graph"], runs["eager"]
        bitwise = [torch.equal(a, b) for a, b in zip(g["state"], e["state"])]
        check(g["syncs"] == e["syncs"] and all(bitwise),
              f"[step graph] {pair}: graphed against eager: losses "
              f"{g['syncs']} vs {e['syncs']}, state leaves equal {bitwise}")
        print(f"[step graph] {pair}: the graphed step mode bitwise the eager "
              f"one (the losses at every sync and the final state); ms per "
              f"iteration graph {g['ms']:.3f}, eager {e['ms']:.3f}; busy "
              f"{g['busy']:.4f} against {e['busy']:.4f} ms", flush=True)
        del runs
    return graph_launches


VIEW_FRAMES = 8                # [view graph]: bench frames timed each way
FLAT_SIZES = 6                 # [view graph]: resolutions, > MAX_VIEWS


def view_graph_phase(torch, dev, p0, alive0, bench_camera, counters):
    """[view graph]: the no-grad view as a CUDA graph
    (``render.py::ViewGraph``) against the eager ``render()``: the bench
    frame through the graph, bitwise every output of the eager render;
    VIEW_FRAMES frames each way in turns (host ms, synchronised), one
    profiled each way (busy, idle share, kernels), the launch counts
    around the graphed frames, the capture's ms and pool peak. Then, on the bench scene with seeded SH coefficients of degrees
    1-3 (so that the SH degree shows) and seeded opacities in [0.02, 0.2]
    (so that a densify's prune shows), at 2^23 entries (its first
    capture), each bitwise the eager view and each changing the image: a
    change of pose, of scaling_modifier and of SH degree (no capture), of
    resolution (a capture), a state replaced by a densify (a capture), and
    a view that overflows its buffers (render_grown: a capture at its
    buffers, then one at the grown ones). Last, FLAT_SIZES resolutions
    twice round through a ViewGraph of MAX_VIEWS views (each key captured
    again in the second round, its view bitwise the eager one): the memory
    the card reserves after the second round is within one capture's peak
    allocation of the first's (the graphs share a pool, and a released
    graph's memory serves the next capture); each capture's ms, peak
    allocation and growth of the reserved memory. Returns the launches of
    the graphed frames."""
    from gs_tpu_torch.config import RasterConfig
    from gs_tpu_torch.core.camera import make_camera
    from gs_tpu_torch.models.gaussian_model import (densify_and_prune,
                                                    init_state)
    from gs_tpu_torch.render import MAX_VIEWS, ViewGraph, render, render_grown
    from gs_tpu_torch.train.step import mask_sh_rest
    import dataclasses
    from gs_tpu_torch.core.gaussians import inverse_sigmoid

    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    # the changes' scene: SH coefficients above degree 0 and opacities in
    # [0.02, 0.2] (the bench scene's are 0.1), at ample buffers
    varied = p0._replace(
        sh_rest=0.1 * torch.randn(p0.sh_rest.shape, generator=gen,
                                  device=dev),
        logit_opacity=inverse_sigmoid(0.02 + 0.18 * torch.rand(
            p0.logit_opacity.shape, generator=gen, device=dev)))
    bg = torch.zeros(3, device=dev)
    raster = RasterConfig(dup_capacity=1 << 23, max_per_tile=MAX_PER_TILE,
                          exact_cull=True)
    kw = dict(active_sh_degree=3, dup_capacity=DUP_CAPACITY,
              max_per_tile=MAX_PER_TILE, exact_cull=True)
    params = p0
    graph = ViewGraph()
    fields = ("image", "invdepth", "final_T", "radii", "visibility",
              "num_duplicates", "max_tile_len", "overflow", "num_valid")

    def same(a, b):
        return all(torch.equal(getattr(a, f), getattr(b, f)) for f in fields)

    with torch.no_grad(), contextlib.redirect_stdout(io.StringIO()) as log:
        # the bench frame, graphed and eager
        launches = {k: 0 for k in counters}

        def graphed(cam):
            c0 = {k: c.launches for k, c in counters.items()}
            out = graph(cam, params, bg, alive=alive0, **kw)
            for k, c in counters.items():
                launches[k] += c.launches - c0[k]
            return out

        def eager(cam):
            return render(cam, params, bg, alive=alive0, **kw)

        check(same(graphed(bench_camera(0)), eager(bench_camera(0))),
              "[view graph] the bench frame != the eager render()")

        def frame(fn):
            def call(i):
                check(not bool(fn(bench_camera(i)).overflow),
                      f"[view graph] frame {i} overflowed")
            return call

        # VIEW_FRAMES a way, each its own pose
        times = host_ms_in_turns(torch, {"eager": frame(eager),
                                         "graph": frame(graphed)},
                                 VIEW_FRAMES // 2)
        busy = {k: busy_per_call(torch, lambda fn=fn: fn(bench_camera(0)))
                for k, fn in (("graph", graphed), ("eager", eager))}
    check(len(graph.captures) == 1, f"[view graph] captures "
          f"{graph.captures}")
    # the capture's warm-up, then 2 + VIEW_FRAMES replays (the profiled
    # one among them)
    want = 3 + VIEW_FRAMES
    # the tree layout: its preprocess is the twin
    check(launches["K2"] == launches["K1"] == want and launches["K1g"]
          == launches["K3"] == launches["K4"] == launches["PRE"]
          == launches["PRE_bwd"] == launches["ADAM"] == launches["SSIM"]
          == launches["SSIM_bwd"] == 0,
          f"[view graph] launches {launches}, want K2 = K1 = {want}")
    host = {k: float(np.median(v)) for k, v in times.items()}
    cap = graph.captures[0]
    print(f"[view graph] the bench frame {W}x{H} through the view graph: "
          f"every output bitwise the eager render(); ms per frame (host "
          f"clock, synchronised, median of {VIEW_FRAMES}, in turns): graph "
          f"{host['graph']:.3f} (" + ", ".join(
              f"{x:.2f}" for x in times["graph"]) + f"), eager "
          f"{host['eager']:.3f} (" + ", ".join(
              f"{x:.2f}" for x in times["eager"]) + f"); device busy per "
          f"frame (one profiled): graph {busy['graph'][0]:.4f} ms in "
          f"{busy['graph'][1]:.0f} kernels, eager {busy['eager'][0]:.4f} ms "
          f"in {busy['eager'][1]:.0f}; graph "
          f"{idle_text(busy['graph'][0], host['graph'])}, eager "
          f"{idle_text(busy['eager'][0], host['eager'])}; the graph's launches "
          f"{launches} (its capture's warm-up and {want - 1} replays); "
          f"capture {cap['ms']:.1f} ms, "
          f"graph pool peak {cap['pool_peak_bytes']} bytes", flush=True)

    # each input changed: bitwise the eager view, and not the base image
    def view(cam, sm=1.0, deg=3, p=varied, alive=alive0, r=raster):
        got, _ = render_grown(cam, p, bg, r, graph=graph, sh_degree=deg,
                              scaling_modifier=sm, alive=alive,
                              active_sh_degree=3)
        ref, _ = render_grown(cam, mask_sh_rest(p, deg), bg, r,
                              scaling_modifier=sm, alive=alive,
                              active_sh_degree=3)
        return got, ref

    base_cam = bench_camera(0)
    small = make_camera(np.eye(3), np.zeros(3), math.radians(70.0),
                        2 * math.atan(math.tan(math.radians(35.0)) * 720
                                      / 1280), 1280, 720, device=dev)
    st = init_state(p0, alive0, num_images=1)
    st = st._replace(params=varied,
                     grad_accum=torch.ones_like(st.grad_accum),
                     denom=torch.ones_like(st.denom))
    dense, info = densify_and_prune(
        st, torch.zeros((st.capacity, 3), device=dev), grad_threshold=2.0,
        min_opacity=0.05, extent=1.0, percent_dense=0.01,
        use_size_threshold=False)
    tight = dataclasses.replace(raster, dup_capacity=1 << 20)
    with torch.no_grad(), contextlib.redirect_stdout(io.StringIO()):
        base, ref = view(base_cam)
        check(same(base, ref) and not bool(base.overflow),
              "[view graph] the base view != eager, or it overflowed")
        changes = (("pose", dict(cam=bench_camera(40)), 0),
                   ("scaling_modifier", dict(sm=0.8), 0),
                   ("SH degree", dict(deg=1), 0),
                   ("resolution 1280x720", dict(cam=small), 1),
                   ("a densify's state", dict(p=dense.params,
                                              alive=dense.alive), 1),
                   ("an overflowing view", dict(r=tight), 2))
        seen = []
        for name, change, new in changes:
            before = len(graph.captures)
            got, ref = view(**dict(dict(cam=base_cam), **change))
            captured = len(graph.captures) - before
            moved = (got.image.shape != base.image.shape
                     or not torch.equal(got.image, base.image))
            check(same(got, ref), f"[view graph] {name}: the graphed view "
                  f"!= the eager view")
            # the overflowing view, rendered again at grown buffers, is the
            # base view itself; every other change changes the image
            check(moved != ("overflowing" in name),
                  f"[view graph] {name}: the image "
                  + ("differs from the base view's" if moved
                     else "did not change"))
            check(captured == new, f"[view graph] {name}: {captured} "
                  f"captures, want {new}")
            check(not bool(got.overflow), f"[view graph] {name}: overflow")
            seen.append(f"{name} ({captured} capture"
                        f"{'' if captured == 1 else 's'})")
    check(info.n_pruned > 0, f"[view graph] the densify pruned nothing "
          f"({info})")
    print(f"[view graph] bitwise the eager view, each but the last changing "
          f"the image (the last is the base view again): " + ", ".join(seen) + f"; the densify pruned {int(info.n_pruned)}; "
          f"the overflowing view (dup_capacity {tight.dup_capacity}) "
          f"captured at its buffers and again at grown ones; captures "
          + ", ".join(
              f"{c['width']}x{c['height']} at {c['capacity']} slots, "
              f"dup_capacity {c['dup_capacity']}: {c['ms']:.1f} ms, pool "
              f"peak {c['pool_peak_bytes']}, reserved growth "
              f"{c['pool_growth_bytes']}" for c in graph.captures),
          flush=True)
    graph.release()
    del graph, dense, st
    torch.cuda.empty_cache()

    # more resolutions than a ViewGraph keeps, twice round
    flat = ViewGraph()
    sizes = [(W * k // 6, H * k // 6) for k in range(6, 6 - FLAT_SIZES, -1)]
    cams = [make_camera(np.eye(3), np.zeros(3), math.radians(70.0),
                        2 * math.atan(math.tan(math.radians(35.0)) * h / w),
                        w, h, device=dev) for w, h in sizes]
    reserved = []
    with torch.no_grad(), contextlib.redirect_stdout(io.StringIO()):
        for _ in range(2):
            for cam in cams:
                check(same(flat(cam, varied, bg, alive=alive0, **kw),
                           render(cam, varied, bg, alive=alive0, **kw)),
                      f"[view graph] {cam.width}x{cam.height}: the graphed "
                      f"view != the eager render()")
            torch.cuda.synchronize()
            reserved.append(torch.cuda.memory_reserved(dev))
    peak = max(c["pool_peak_bytes"] for c in flat.captures)
    check(len(flat.captures) == 2 * FLAT_SIZES
          and len(flat.views) == MAX_VIEWS
          and reserved[1] - reserved[0] < peak,
          f"[view graph] {FLAT_SIZES} resolutions twice: captures "
          f"{len(flat.captures)}, views kept {len(flat.views)}, reserved "
          f"bytes after each round {reserved} (a capture's peak allocation "
          f"at most {peak})")
    print(f"[view graph] {FLAT_SIZES} resolutions ("
          + ", ".join(f"{w}x{h}" for w, h in sizes) + f") twice round "
          f"through a ViewGraph of {MAX_VIEWS} views: {len(flat.captures)} "
          f"captures, each view bitwise the eager render(); memory reserved "
          f"on the card after each round {reserved[0]}, {reserved[1]} bytes "
          f"(the largest peak allocation of one capture {peak}); captures "
          "(ms, peak allocation, reserved growth) " + ", ".join(
              f"{c['width']}x{c['height']} {c['ms']:.1f}, "
              f"{c['pool_peak_bytes']}, {c['pool_growth_bytes']}"
              for c in flat.captures),
          flush=True)
    flat.release()
    del flat, params, varied
    torch.cuda.empty_cache()
    return launches


DENSITY_ROUNDS = 2             # [density graph]: eager/graph turns each way
DENSITY_ITERS = 60             # its trainer pair: densifies at 25 and 50


def density_graph_phase(torch, dev, root, model, dup, counters):
    """[density graph]: density control as CUDA graphs
    (``train/graph.py::DensityGraph``) against the eager functions, on
    [trainer]'s checkpoint at iteration 300 (1,048,576 slots, its
    densification statistics as trained), packed and tree, on one device
    and in a ``LocalGroup(4)``: the graphed densify bitwise
    ``densify_and_prune(_packed)`` (the state and ``DensifyInfo``) for both
    ``use_size_threshold`` values, and the graphed reset bitwise
    ``reset_opacity(_packed)``; each way timed in turns by host clock
    (synchronised at both ends, the state restored between calls, outside
    the clock), one call each profiled (busy, kernels), each capture's ms,
    peak allocation and growth of the reserved memory. Then the trainer
    pair: the CLI in its block mode on the [trainer] dataset for
    DENSITY_ITERS iterations (densifies at 25 and 50, an opacity reset at
    50), with a view of a test camera asked for right after each densify
    and again after the next block (as a viewer's frames can fall), once
    with density control eager (the parent's: new tensors each time) and
    once graphed: the losses at every sync and the final states bitwise
    equal, and the view captures per densify of each."""
    from gs_tpu_torch.models import gaussian_model as gm
    from gs_tpu_torch.models import packed_state as ps_mod
    from gs_tpu_torch.parallel.mesh import LocalGroup
    from gs_tpu_torch.train import loop
    from gs_tpu_torch.train.checkpoint import load_checkpoint
    from gs_tpu_torch.train.graph import (DensityGraph, clone_state,
                                          state_leaves)

    base, _, extent = load_checkpoint(
        os.path.join(model, f"chkpnt{TRAINER_ITERS}.pth"), device=dev)
    # the threshold at the trained gradients' 90th percentile, so that a
    # tenth of the alive Gaussians clone or split
    grads = torch.nan_to_num(base.grad_accum / base.denom)[base.alive]
    kw = dict(grad_threshold=float(torch.quantile(grads, 0.9)),
              min_opacity=0.005, extent=extent, percent_dense=0.01)
    del grads
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    noise = torch.randn((base.capacity, 3), generator=gen, device=dev)
    results = []
    for layout in ("packed", "tree"):
        state0 = ps_mod.pack_state(base) if layout == "packed" else base
        dens = (ps_mod.densify_and_prune_packed if layout == "packed"
                else gm.densify_and_prune)
        reset = (ps_mod.reset_opacity_packed if layout == "packed"
                 else gm.reset_opacity)
        for where, mesh in (("one device", None),
                            (f"LocalGroup({MESH_K})", LocalGroup(MESH_K, dev))):
            work = clone_state(state0)
            graph = DensityGraph(work, mesh)
            infos = []
            with contextlib.redirect_stdout(io.StringIO()):
                for gate in (False, True):
                    for a, b in zip(state_leaves(work), state_leaves(state0)):
                        a.copy_(b)
                    ref, rinfo = dens(state0, noise, use_size_threshold=gate,
                                      **kw)
                    info = graph.densify(noise, gate, **kw)
                    torch.cuda.synchronize()
                    check(state_equal(torch, work, ref) and all(
                        torch.equal(x, y) for x, y in zip(info, rinfo)),
                        f"[density graph] {layout}, {where}, "
                        f"use_size_threshold {gate}: the graphed densify != "
                        f"the eager one")
                    infos.append({k: int(v) for k, v in
                                  rinfo._asdict().items()})
                    ref = reset(work)
                    graph.reset_opacity()
                    check(state_equal(torch, work, ref),
                          f"[density graph] {layout}, {where}: the graphed "
                          f"reset != the eager one")
                    del ref
            check(infos[0]["n_cloned"] + infos[0]["n_split"] > 0,
                  f"[density graph] {layout}: nothing cloned or split: "
                  f"{infos}")

            def restore():
                for a, b in zip(state_leaves(work), state_leaves(state0)):
                    a.copy_(b)
                torch.cuda.synchronize()

            ways = {"eager densify": lambda: dens(
                        state0, noise, use_size_threshold=True, **kw),
                    "graph densify": lambda: graph.densify(
                        noise, True, **kw),
                    "eager reset": lambda: reset(state0),
                    "graph reset": graph.reset_opacity}
            times = {k: [] for k in ways}
            order = list(ways) + list(ways)[::-1]
            for _ in range(DENSITY_ROUNDS):
                for k in order:
                    restore()
                    t = time.perf_counter()
                    ways[k]()
                    torch.cuda.synchronize()
                    times[k].append(1e3 * (time.perf_counter() - t))
            busy = {}
            for k, fn in ways.items():
                restore()
                # the resets over 3 calls (a reset of a reset is the same
                # work): the profiler saw no kernel of one eager reset
                busy[k] = busy_per_call(torch, fn, 3 if "reset" in k else 1)
            host = {k: float(np.median(v)) for k, v in times.items()}
            results.append((layout, where, host, busy, graph.captures))
            print(f"[density graph] {layout}, {where}, {base.capacity} "
                  f"slots: the graphed densify and reset bitwise the eager "
                  f"functions (state and DensifyInfo) for "
                  f"use_size_threshold False and True ({infos}); ms (host "
                  f"clock, synchronised, median of {2 * DENSITY_ROUNDS}, in "
                  f"turns): " + ", ".join(
                      f"{k} {host[k]:.3f} (busy {busy[k][0]:.4f} in "
                      f"{busy[k][1]:.0f} kernels, "
                      f"{idle_text(busy[k][0], host[k])})" for k in ways)
                  + "; captures " + ", ".join(
                      f"{c['what']} {c['ms']:.1f} ms, pool peak "
                      f"{c['pool_peak_bytes']}, reserved growth "
                      f"{c['pool_growth_bytes']}" for c in graph.captures),
                  flush=True)
            check(len(graph.captures) == 2, f"[density graph] {layout}, "
                  f"{where}: captures {graph.captures}")
            graph.release()
            del graph, work
            torch.cuda.empty_cache()
        del state0
    del base, noise
    torch.cuda.empty_cache()

    # the trainer pair: a view right after each densify and after the next
    # block, density control eager (the parent's) and graphed
    T = loop.Trainer
    apply_schedule, densify = T._apply_schedule, T._densify
    runs = {}
    for how in ("eager density", "graphed density"):
        seen = dict(densifies=0, pending=False, captures=[])

        def schedule(self, i, _how=how, _seen=seen):
            cam = self.test_cams[0].camera
            if self._replaying:
                return apply_schedule(self, i)
            if _seen["pending"]:           # the block after a densify
                self.render_view(cam)
                _seen["pending"] = False
            n = _seen["densifies"]
            if _how == "eager density":
                eager, self._eager_dispatch = self._eager_dispatch, True
                try:
                    apply_schedule(self, i)
                finally:
                    self._eager_dispatch = eager
            else:
                apply_schedule(self, i)
            if _seen["densifies"] > n:     # right after the densify
                before = len(self.views.captures)
                self.render_view(cam)
                _seen["captures"].append(len(self.views.captures) - before)
                _seen["pending"] = True

        def count_densify(self, state, use_size_threshold, _seen=seen):
            _seen["densifies"] += not self._replaying
            return densify(self, state, use_size_threshold)

        model_dir = os.path.join(os.path.dirname(root), "density_" +
                                 how.split()[0])
        args = ["-s", root, "-m", model_dir, "-r", "1", "--eval",
                "--iterations", str(DENSITY_ITERS), "--densify_from_iter",
                "5", "--densification_interval", "25",
                "--densify_until_iter", "55", "--opacity_reset_interval",
                "50", "--test_iterations", "1", "--save_iterations",
                str(DENSITY_ITERS), "--dup_capacity", str(dup),
                "--disable_viewer", "--quiet", "--data_device", dev.type]
        T._apply_schedule, T._densify = schedule, count_densify
        try:
            tr, rec, _, launches, out = run_train_cli(torch, args, counters)
        finally:
            T._apply_schedule, T._densify = apply_schedule, densify
        check(seen["densifies"] == 2 and len(seen["captures"]) == 2,
              f"[density graph] {how}: densifies {seen}")
        check(tr._runner is not None,
              f"[density graph] {how}: no graphed step ran")
        view_caps = len(tr.views.captures)
        # the view right after the densify, then the one after the next
        # block: the captures since the first view, per densify
        per_densify = (view_caps - 1) / seen["densifies"]
        runs[how] = dict(
            syncs=[x for _, x, _ in rec["syncs"]],
            state=[t.clone() for t in state_leaves(tr.state)],
            per_densify=per_densify, densify=rec["densify"],
            density_captures=list(tr.density_captures))
        print(f"[density graph] trainer, {how}: {tr.iteration} iterations "
              f"through gs_tpu_torch.apps.train.main (block mode) with a "
              f"{tr.test_cams[0].camera.width}x"
              f"{tr.test_cams[0].camera.height} view after each densify and "
              f"after the next block; densifies " + ", ".join(
                  f"{d['iteration']}: {d['ms']:.1f} ms (cloned {d['n_cloned']},"
                  f" split {d['n_split']}, pruned {d['n_pruned']})"
                  for d in rec["densify"])
              + f"; view captures {view_caps} in all, "
              f"{per_densify:.1f} per densify (right after each densify: "
              f"{seen['captures']}); density captures " + (", ".join(
                  f"{c['what']} {c['ms']:.1f} ms pool peak "
                  f"{c['pool_peak_bytes']}" for c in tr.density_captures)
                  or "none (eager)"), flush=True)
        del tr
        torch.cuda.empty_cache()
    e, g = runs["eager density"], runs["graphed density"]
    bitwise = [torch.equal(a, b) for a, b in zip(e["state"], g["state"])]
    check(e["syncs"] == g["syncs"] and all(bitwise),
          f"[density graph] trainer: graphed against eager density control: "
          f"losses {g['syncs']} vs {e['syncs']}, state leaves equal "
          f"{bitwise}")
    check(g["per_densify"] == 0 and len(g["density_captures"]) >= 2,
          f"[density graph] trainer: {g['per_densify']} view captures per "
          f"graphed densify, density captures {g['density_captures']}")
    print(f"[density graph] trainer: graphed density control bitwise the "
          f"eager one (the losses at every sync and the final state); view "
          f"captures per densify {e['per_densify']:.1f} eager (the parent's "
          f"new tensors) against {g['per_densify']:.1f} graphed (written "
          f"into the step graph's state)", flush=True)
    return results


MESH_VIEW_FRAMES = 8           # [mesh view graph]: bench frames each way


def mesh_view_graph_phase(torch, dev, p0, alive0, bench_camera, counters):
    """[mesh view graph]: the bench frame (500,000 Gaussians, 1920x1080)
    through ``Trainer.render_view`` under ``LocalGroup(MESH_K)``, whose
    view replays ``render.py::ViewGraph(mesh=...)``'s graph of the banded
    render and its collectives, against the Trainer's eager view (its
    private ``_eager_dispatch``): bitwise every output for the base view, a
    change of pose, of SH degree, a densify's state (the first, written into
    the step graph's static state, which replaces the start state; a second
    in place), a ``visible_capacity`` overflow and a ``dup_capacity``
    overflow, each with the captures it should cause; MESH_VIEW_FRAMES
    frames each way in turns (host ms), one profiled each way (busy, idle,
    kernels), K2 and K1 per view (one per band), each capture's ms, peak
    allocation and growth of the reserved memory. Returns the launches of
    the MESH_VIEW_FRAMES timed graphed views (the counts set to 0
    just before them, read just after)."""
    from gs_tpu_torch.config import (ModelConfig, OptimizationConfig,
                                     PipelineConfig, RasterConfig)
    from gs_tpu_torch.data.camera_utils import LoadedCamera
    from gs_tpu_torch.data.dataset_readers import CameraInfo
    from gs_tpu_torch.models.gaussian_model import init_state
    from gs_tpu_torch.parallel.mesh import LocalGroup
    from gs_tpu_torch.train.loop import Trainer
    import dataclasses

    cam0 = bench_camera(0)
    view = LoadedCamera(
        camera=cam0, info=CameraInfo(
            uid=0, R=np.eye(3), T=np.zeros(3), fovx=1.0, fovy=1.0,
            image_path="", image_name="bench", width=W, height=H),
        image=np.zeros((3, H, W), np.float32),
        alpha_mask=np.ones((1, H, W), np.float32), invdepth=None,
        depth_mask=None, depth_reliable=False)
    raster = RasterConfig(dup_capacity=DUP_CAPACITY, max_per_tile=MAX_PER_TILE,
                          exact_cull=True, visible_capacity=-1)
    # SH coefficients above degree 0 (the bench scene's are 0), so that the
    # SH degree shows, as [view graph]'s
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    varied = p0._replace(sh_rest=0.1 * torch.randn(
        p0.sh_rest.shape, generator=gen, device=dev))
    with contextlib.redirect_stdout(io.StringIO()):
        tr = Trainer([view], None, 1.0,
                     ModelConfig(sh_degree=3, data_device=str(dev)),
                     OptimizationConfig(), PipelineConfig(), raster,
                     start_state=init_state(varied, alive0, num_images=1),
                     mesh=LocalGroup(MESH_K, dev))
    del varied
    tr.iteration = 3000                  # the full SH degree
    fields = ("image", "invdepth", "final_T", "radii", "visibility",
              "num_duplicates", "max_tile_len", "overflow", "num_valid",
              "band_duplicates", "band_visible", "band_work")

    def same(a, b):
        return all(torch.equal(getattr(a, f), getattr(b, f)) for f in fields)

    launches = {k: 0 for k in counters}

    def graphed(cam):
        c0 = {k: c.launches for k, c in counters.items()}
        tr._eager_dispatch = False
        out = tr.render_view(cam)
        for k, c in counters.items():
            launches[k] += c.launches - c0[k]
        return out

    def eager(cam):
        tr._eager_dispatch = True
        try:
            return tr.render_view(cam)
        finally:
            tr._eager_dispatch = False

    seen = []

    def both(name, cam, want):
        before = len(tr.views.captures)
        ref = eager(cam)
        got = graphed(cam)
        captured = len(tr.views.captures) - before
        check(same(got, ref), f"[mesh view graph] {name}: the graphed view "
              f"!= the eager view")
        check(captured == want, f"[mesh view graph] {name}: {captured} "
              f"captures, want {want}")
        check(not bool(got.overflow), f"[mesh view graph] {name}: overflow")
        seen.append(f"{name} ({captured} capture"
                    f"{'' if captured == 1 else 's'})")
        return got

    with contextlib.redirect_stdout(io.StringIO()):
        base = both("base", cam0, 1)

        def frame(fn):
            def call(i):
                check(not bool(fn(bench_camera(i)).overflow),
                      f"[mesh view graph] frame {i} overflowed")
            return call

        for k in launches:
            launches[k] = 0
        times = host_ms_in_turns(torch, {"eager": frame(eager),
                                         "graph": frame(graphed)},
                                 MESH_VIEW_FRAMES // 2)
        window = dict(launches)        # the timed graphed views' alone
        n_graphed = sum(window.values())
        per_view = {k: v / MESH_VIEW_FRAMES for k, v in window.items()}
        busy = {k: busy_per_call(torch, lambda fn=fn: fn(cam0))
                for k, fn in (("graph", graphed), ("eager", eager))}
        check(per_view["K2"] == per_view["K1"] == per_view["PRE"] == MESH_K
              and per_view["K1g"] == per_view["K3"] == per_view["K4"]
              == per_view["PRE_bwd"] == per_view["ADAM"] == per_view["SSIM"]
              == per_view["SSIM_bwd"] == 0,
              f"[mesh view graph] launches per graphed view {per_view} "
              f"({n_graphed} in all), want K2 = K1 = PRE = {MESH_K}")
        moved = both("pose", bench_camera(40), 0)
        check(not torch.equal(moved.image, base.image),
              "[mesh view graph] the pose change left the image")
        tr.iteration = 1000
        low = both("SH degree 1", cam0, 0)
        check(not torch.equal(low.image, base.image),
              "[mesh view graph] the SH degree left the image")
        tr.iteration = 3000
        gen.manual_seed(5)
        for name, want in (("a densify's state", 1),
                           ("a second densify", 0)):
            st = tr.state
            st.grad_accum.copy_(4e-4 * torch.rand(
                st.grad_accum.shape, generator=gen, device=dev))
            st.denom.fill_(1.0)
            tr.state, info = tr._densify(st, False)
            check(int(info.n_cloned) + int(info.n_split) > 0,
                  f"[mesh view graph] {name}: {info}")
            dense = both(name, cam0, want)
            check(not torch.equal(dense.image, base.image),
                  f"[mesh view graph] {name} left the image")
        shard_visible = int(dense.band_visible.max())
        tr.raster = dataclasses.replace(raster,
                                        visible_capacity=shard_visible // 2)
        both(f"visible_capacity {shard_visible // 2}", cam0, 2)
        band_dup = int(dense.band_duplicates.max())
        tr.raster = dataclasses.replace(raster, dup_capacity=band_dup // 2)
        both(f"dup_capacity {band_dup // 2}", cam0, 2)
    host = {k: float(np.median(v)) for k, v in times.items()}
    print(f"[mesh view graph] the bench frame {W}x{H} through "
          f"Trainer.render_view under LocalGroup({MESH_K}): every output "
          f"bitwise the eager view; ms per frame (host clock, synchronised, "
          f"median of {MESH_VIEW_FRAMES}, in turns): graph "
          f"{host['graph']:.3f} (" + ", ".join(
              f"{x:.2f}" for x in times["graph"]) + f"), eager "
          f"{host['eager']:.3f} (" + ", ".join(
              f"{x:.2f}" for x in times["eager"]) + f"); device busy per "
          f"frame (one profiled): graph {busy['graph'][0]:.4f} ms in "
          f"{busy['graph'][1]:.0f} kernels, eager {busy['eager'][0]:.4f} ms "
          f"in {busy['eager'][1]:.0f}; graph "
          f"{idle_text(busy['graph'][0], host['graph'])}, eager "
          f"{idle_text(busy['eager'][0], host['eager'])}; launches per "
          f"graphed view {per_view}", flush=True)
    print(f"[mesh view graph] bitwise the eager view: " + ", ".join(seen)
          + "; captures " + ", ".join(
              f"{c['width']}x{c['height']} at {c['capacity']} local slots, "
              f"dup_capacity {c['dup_capacity']}: {c['ms']:.1f} ms, pool "
              f"peak {c['pool_peak_bytes']}, reserved growth "
              f"{c['pool_growth_bytes']}" for c in tr.views.captures)
          + "; the densifies' captures " + ", ".join(
              f"{c['what']} {c['ms']:.1f} ms" for c in tr.density_captures),
          flush=True)
    tr.views.release()
    tr._runner.release()
    del tr
    torch.cuda.empty_cache()
    return window


METRICS_VIEWS = 8              # [metrics graph]: 1080p views scored


def metrics_graph_phase(torch, dev, tmpdir, model):
    """[metrics graph]: the metrics CLI's SSIM and LPIPS as CUDA graphs
    (``utils/cuda_graphs.py::GraphedFunction``) against the eager
    functions, on METRICS_VIEWS 1080p views of the [trainer] model (the
    render CLI's train and test views, each with its ground truth), with
    [lpips]'s seeded random weights: ``results.json`` and ``per_view.json``
    of the graphed CLI byte for byte the eager CLI's; per view, SSIM +
    PSNR + LPIPS timed each way in turns by host clock (synchronised), one
    view each way profiled (busy, kernels), each capture's ms, peak
    allocation and growth of the reserved memory."""
    from gs_tpu_torch.apps import metrics as metrics_app
    from gs_tpu_torch.apps import render as render_app
    from gs_tpu_torch.ops.losses import psnr
    from gs_tpu_torch.ops.lpips import lpips_vgg
    from gs_tpu_torch.ops.ssim import ssim as ssim_fn
    from gs_tpu_torch.render import MAX_DUP_CAPACITY

    # the test view as [render CLI default] rendered it, at these buffers
    with contextlib.redirect_stdout(io.StringIO()):
        render_app.main(["-m", model, "--skip_test", "--dup_capacity",
                         str(MAX_DUP_CAPACITY)])
    pairs = []
    for split in ("train", "test"):
        d = os.path.join(model, split, f"ours_{TRAINER_ITERS}")
        pairs += [(os.path.join(d, "renders", f), os.path.join(d, "gt", f))
                  for f in sorted(os.listdir(os.path.join(d, "renders")))]
    check(len(pairs) == METRICS_VIEWS, f"[metrics graph] {len(pairs)} views")
    dirs = {}
    for how in ("graphed", "eager"):
        top = os.path.join(tmpdir, "metrics_" + how)
        out = os.path.join(top, "test", f"ours_{TRAINER_ITERS}")
        for sub in ("renders", "gt"):
            os.makedirs(os.path.join(out, sub))
        for i, (r, g) in enumerate(pairs):
            os.symlink(r, os.path.join(out, "renders", f"{i:05d}.png"))
            os.symlink(g, os.path.join(out, "gt", f"{i:05d}.png"))
        dirs[how] = top
    graphed = metrics_app.metric_functions(dev)
    eager = (ssim_fn, lpips_vgg(device=dev))
    check(graphed[1] is not None, "[metrics graph] no LPIPS weights")
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        metrics_app.evaluate([dirs["graphed"]], device=dev, functions=graphed)
    t_graphed = time.perf_counter() - t0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        metrics_app.evaluate([dirs["eager"]], device=dev, functions=eager)
    t_eager = time.perf_counter() - t0
    for name in ("results.json", "per_view.json"):
        with open(os.path.join(dirs["graphed"], name), "rb") as f, \
                open(os.path.join(dirs["eager"], name), "rb") as g:
            check(f.read() == g.read(), f"[metrics graph] {name}: the "
                  f"graphed CLI's != the eager CLI's")
    with open(os.path.join(dirs["graphed"], "results.json")) as f:
        results = json.load(f)[f"ours_{TRAINER_ITERS}"]
    out = os.path.join(dirs["graphed"], "test", f"ours_{TRAINER_ITERS}")
    renders, gts, _ = metrics_app.read_images(os.path.join(out, "renders"),
                                              os.path.join(out, "gt"))
    images = [tuple(torch.from_numpy(a.transpose(2, 0, 1).copy()).to(dev)
                    for a in (x, y)) for x, y in zip(renders, gts)]
    check(len(images) == METRICS_VIEWS, "[metrics graph] images")

    def per_view(fns):
        s_f, l_f = fns

        def call(i):
            a, b = images[i % len(images)]
            return (float(s_f(a, b)), float(psnr(a[None], b[None])[0, 0]),
                    float(l_f(a, b)))
        return call

    with torch.no_grad():
        times = host_ms_in_turns(torch, {"eager": per_view(eager),
                                         "graph": per_view(graphed)},
                                 METRICS_VIEWS // 2)
        busy = {k: busy_per_call(torch, lambda f=fns: per_view(f)(0))
                for k, fns in (("graph", graphed), ("eager", eager))}
        # each function alone: device ms by CUDA events (3 calls) and its
        # kernels (one profiled call)
        parts = {}
        a, b = images[0]
        for k, fns in (("graph", graphed), ("eager", eager)):
            parts[k] = [(time_ms(torch, lambda f=f: f(a, b), 3, 1),
                         busy_per_call(torch, lambda f=f: f(a, b))[1])
                        for f in fns]
    host = {k: float(np.median(v)) for k, v in times.items()}
    caps = [(name, c) for name, f in (("SSIM", graphed[0]),
                                      ("LPIPS", graphed[1]))
            for c in f.captures]
    print(f"[metrics graph] the metrics CLI on {METRICS_VIEWS} {W}x{H} views "
          f"of the [trainer] model (seeded random LPIPS weights): "
          f"results.json and per_view.json of the graphed CLI byte for byte "
          f"the eager CLI's ({results}); the CLI {t_graphed:.2f} s graphed, "
          f"{t_eager:.2f} s eager (the first with its captures); ms per "
          f"view, SSIM + PSNR + LPIPS (host clock, synchronised, median of "
          f"{METRICS_VIEWS}, in turns): graph {host['graph']:.3f} ("
          + ", ".join(f"{x:.2f}" for x in times["graph"]) + f"), eager "
          f"{host['eager']:.3f} (" + ", ".join(
              f"{x:.2f}" for x in times["eager"]) + f"); device busy per "
          f"view: graph {busy['graph'][0]:.4f} ms in {busy['graph'][1]:.0f} "
          f"kernels, eager {busy['eager'][0]:.4f} ms in "
          f"{busy['eager'][1]:.0f}; graph "
          f"{idle_text(busy['graph'][0], host['graph'])}, eager "
          f"{idle_text(busy['eager'][0], host['eager'])}; SSIM ms by CUDA "
          f"events (kernels) graph {parts['graph'][0][0]:.4f} "
          f"({parts['graph'][0][1]:.0f}), eager {parts['eager'][0][0]:.4f} "
          f"({parts['eager'][0][1]:.0f}); LPIPS graph "
          f"{parts['graph'][1][0]:.4f} ({parts['graph'][1][1]:.0f}), eager "
          f"{parts['eager'][1][0]:.4f} ({parts['eager'][1][1]:.0f}); "
          f"captures " + ", ".join(
              f"{name} {c['shapes'][0]} {c['ms']:.1f} ms, pool peak "
              f"{c['pool_peak_bytes']}, reserved growth "
              f"{c['pool_growth_bytes']}" for name, c in caps), flush=True)
    for f in graphed:
        f.release()
    del images, graphed, eager
    torch.cuda.empty_cache()


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    if not os.path.isfile(os.path.join(ROOT, "gs_tpu_torch", "render.py")):
        print("chip_smoke: run from a checkout of the repository "
              "(gs_tpu_torch/ not found beside this script)", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from gs_tpu_torch import native
    from gs_tpu_torch.apps import view_orbit
    from gs_tpu_torch.apps.render import params_from_ply
    from gs_tpu_torch.config import (ModelConfig, OptimizationConfig,
                                     PipelineConfig, save_config)
    from gs_tpu_torch.core.camera import focal2fov, make_camera
    from gs_tpu_torch.core.gaussians import GaussianParams, inverse_sigmoid
    from gs_tpu_torch.core.project import preprocess
    from gs_tpu_torch.core.sh import rgb2sh
    from gs_tpu_torch.data.ply import load_gaussian_ply, save_gaussian_ply
    from gs_tpu_torch.ops import _cuda
    from gs_tpu_torch.ops.binning import (bin_gaussians_payload,
                                          expansion_table, tile_grid)
    from gs_tpu_torch.ops.expand import expand_rows, expand_rows_plain
    from gs_tpu_torch.ops.rasterize import (K1_OPS, block_skip_counts,
                                            kernel_attributes, max_chunks_for,
                                            raster_tiles_fwd,
                                            raster_tiles_fwd_plain,
                                            raster_tiles_fwd_work)
    from gs_tpu_torch.ops.rasterize_plain import pack_projected
    from gs_tpu_torch.render import render

    from gs_tpu_torch.core.project import preprocess_bwd, preprocess_fwd
    from gs_tpu_torch.ops.adam import adam_packed
    from gs_tpu_torch.ops.fold import fold_rows
    from gs_tpu_torch.ops.rasterize import (raster_tiles_bwd,
                                            raster_tiles_fwd_save)
    from gs_tpu_torch.ops.ssim import ssim_bwd, ssim_fwd
    counters = {"K2": expand_rows, "K1": raster_tiles_fwd,
                "K1g": raster_tiles_fwd_save, "K3": raster_tiles_bwd,
                "K4": fold_rows, "PRE": preprocess_fwd,
                "PRE_bwd": preprocess_bwd, "ADAM": adam_packed,
                "SSIM": ssim_fwd, "SSIM_bwd": ssim_bwd}

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    # ---------------------------------------------------------------- 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    t0 = time.perf_counter()
    logs = _cuda.build()
    print(f"[build] {len(logs)} kernel libraries in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    t0 = time.perf_counter()
    native_lib = native.build()
    print(f"[build] the native COLMAP parser ({os.path.basename(native_lib)}) "
          f"in {time.perf_counter() - t0:.2f} s", flush=True)
    for src, log in logs.items():
        for line in log.splitlines():
            if any(w in line for w in ("registers", "spill", "error", "warning")):
                print(f"[build] {src}: {line.strip()}")
    for src in ("rasterize_fwd.cu", "rasterize_bwd.cu", "fold.cu"):
        for name, c in sass_counts(str(_cuda.library_path(src))).items():
            print(f"[sass] {name} ({src}), static counts: " + ", ".join(
                f"{k} {v}" for k, v in c.items()), flush=True)

    # the bench scene, rebuilt with the port, written and loaded back
    t0 = time.perf_counter()
    pts, cols, p0, alive0 = bench_scene(torch, dev)
    torch.cuda.synchronize()
    print(f"[scene] create_from_pcd of {N_GAUSS} points: "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    tmp = tempfile.TemporaryDirectory(dir=ROOT, prefix=".chip_smoke_")
    model_dir = tmp.name
    host = {k: getattr(p0, k)[:N_GAUSS].cpu().numpy() for k in p0._fields}
    ply = os.path.join(model_dir, "point_cloud", "iteration_30000",
                       "point_cloud.ply")
    save_gaussian_ply(ply, host["xyz"], host["sh_dc"], host["sh_rest"],
                      host["logit_opacity"], host["log_scale"], host["quat"])
    save_config(model_dir, ModelConfig(model_path=model_dir),
                PipelineConfig(), OptimizationConfig())
    d = load_gaussian_ply(ply)
    params, alive = params_from_ply(d, device=dev)
    check(all(np.array_equal(d[k], host[k]) for k in host), "PLY round trip")
    fovx = math.radians(70.0)
    fovy = focal2fov(W / (2 * math.tan(fovx / 2)), H)
    bg = torch.zeros(3, device=dev)

    def bench_camera(i):
        return make_camera(np.eye(3), np.array([2e-3 * i, 0.0, 0.0]), fovx,
                           fovy, W, H, device=dev)

    with torch.no_grad():
        cam0 = bench_camera(0)
        proj = preprocess(params, cam0, active_sh_degree=3, alive=alive)
        packets = pack_projected(proj)

        # ------------------------------------------------------------ 2
        k2_err = 0.0
        for name, comb, offsets, capacity in expand_cases():
            c, o = torch.from_numpy(comb).to(dev), torch.from_numpy(offsets).to(dev)
            got = expand_rows(c, o, capacity)
            torch.cuda.synchronize()
            ref = expand_rows_plain(c, o, capacity)
            check(torch.equal(got, ref), f"K2 != plain on case {name}")
            print(f"[K2] case {name}: bitwise equal", flush=True)
        comb, offsets, _, total = expansion_table(proj, packets, W, H, 16, 16)
        total = int(total)
        got = expand_rows(comb, offsets, DUP_CAPACITY)
        torch.cuda.synchronize()
        ref = expand_rows_plain(comb, offsets, DUP_CAPACITY)
        check(torch.equal(got, ref), "K2 != plain on the bench table")
        k2_err = float((got - ref).abs().max())
        del got, ref
        counts = comb[1].to(torch.int64)
        k2_ms = time_ms(torch, lambda: expand_rows(comb, offsets, DUP_CAPACITY), 20)
        k2_plain_ms = time_ms(torch, lambda: expand_rows_plain(
            comb, offsets, DUP_CAPACITY), 5)
        k2_lib_ms = time_ms(torch, lambda: torch.repeat_interleave(
            comb, counts, dim=1, output_size=total), 20)
        n_tab = comb.shape[1]
        k2_bytes = 16 * n_tab * 4 + n_tab * 4 + 16 * DUP_CAPACITY * 4
        k2_ops = DUP_CAPACITY * math.ceil(math.log2(n_tab + 1))
        k2_bound = max(k2_bytes / HBM_BYTES_PER_S, k2_ops / FP32_OPS_PER_S) * 1e3
        print(f"[K2] bench table [16, {n_tab}] -> {DUP_CAPACITY} entries "
              f"({total} owned): bitwise equal; kernel {k2_ms:.4f} ms, plain "
              f"{k2_plain_ms:.4f} ms, repeat_interleave {k2_lib_ms:.4f} ms, "
              f"bound {k2_bound:.4f} ms ({k2_bytes} bytes)", flush=True)
        del comb

        # ------------------------------------------------------------ 3
        srng = np.random.default_rng(5)
        n = 300
        small = GaussianParams(
            xyz=torch.tensor(np.concatenate([
                srng.uniform(-1, 1, (n, 2)), srng.uniform(3, 5, (n, 1))], 1),
                dtype=torch.float32, device=dev),
            sh_dc=rgb2sh(torch.tensor(srng.uniform(0, 1, (n, 1, 3)),
                                      dtype=torch.float32, device=dev)),
            sh_rest=torch.tensor(srng.normal(0, 0.02, (n, 15, 3)),
                                 dtype=torch.float32, device=dev),
            log_scale=torch.tensor(srng.uniform(-3.5, -1.5, (n, 3)),
                                   dtype=torch.float32, device=dev),
            quat=torch.tensor(srng.normal(0, 1, (n, 4)) + [2, 0, 0, 0],
                              dtype=torch.float32, device=dev),
            logit_opacity=inverse_sigmoid(torch.tensor(
                srng.uniform(0.2, 0.95, (n, 1)), dtype=torch.float32,
                device=dev)))
        sfovy = focal2fov(128 / (2 * math.tan(math.radians(30))), 96)
        scam = make_camera(np.eye(3), np.zeros(3), math.radians(60), sfovy,
                           128, 96, device=dev)
        k1_err = 0.0
        for label, pr, cam, capacity, mpt in (
                ("300 gaussians 128x96",
                 preprocess(small, scam, active_sh_degree=3), scam, 1 << 14, 512),
                (f"bench frame {W}x{H}", proj, cam0, DUP_CAPACITY, MAX_PER_TILE)):
            bins, feats = bin_gaussians_payload(
                pr, pack_projected(pr), cam.width, cam.height, 16, 16,
                capacity, exact_cull=True)
            check(not bool(bins.overflow), f"K1 {label}: binning overflow")
            gx, _ = tile_grid(cam.width, cam.height, 16, 16)
            args = (feats, bins.tile_start, bins.tile_end, gx, max_chunks_for(mpt))
            got = raster_tiles_fwd(*args)
            torch.cuda.synchronize()
            ref = raster_tiles_fwd_plain(*args)
            ok, mx, frac = images_match(got, ref)
            print(f"[K1] {label}: max |kernel - plain| {mx:.3e}, "
                  f"{frac:.4%} of values beyond 1e-5", flush=True)
            check(ok, f"K1 != plain on {label} (max {mx}, frac {frac})")
            k1_err = max(k1_err, mx)
        del got, ref
        k1_ms = time_ms(torch, lambda: raster_tiles_fwd(*args), 20)
        k1_plain_ms = time_ms(torch, lambda: raster_tiles_fwd_plain(*args), 3, 1)

        # work the frame's data needs: each pixel's pairs up to the one that
        # stops it, by where the kernel body drops them; each entry some
        # pixel reaches, read once
        work = raster_tiles_fwd_work(*args)
        k1_bound_b = work["bytes"] / HBM_BYTES_PER_S * 1e3
        k1_bound_o = work["ops"] / FP32_OPS_PER_S * 1e3
        k1_bound = max(k1_bound_b, k1_bound_o)
        pairs = ", ".join(f"{work[k]} {k} (x{K1_OPS[k]})" for k in K1_OPS)
        print(f"[K1] bench frame: {bins.tile_start.shape[0]} tiles, "
              f"{int(bins.num_valid)} entries in range, {work['entries']} "
              f"read, (entry, pixel) pairs reached: {pairs} = {work['ops']} "
              f"FP32 operations; kernel {k1_ms:.4f} ms, plain "
              f"{k1_plain_ms:.4f} ms, bound {k1_bound:.4f} ms (bytes "
              f"{k1_bound_b:.4f}, operations {k1_bound_o:.4f})", flush=True)
        skip = block_skip_counts(*args)
        print(f"[K1] bench frame: the block skip removes "
              f"{skip['skipped']} of the {skip['pairs']} (8x4 block, entry) "
              f"pairs of the windows ({skip['skipped'] / max(skip['pairs'], 1):.2%}"
              f"; ops/rasterize.py::block_skip_counts on the card); "
              + attributes_line(kernel_attributes(dev), ["K1", "K1g"]),
              flush=True)
        del feats, bins, args, proj, packets

        # ------------------------------------------------------------ 4
        kw = dict(active_sh_degree=d["sh_degree"], alive=alive,
                  dup_capacity=DUP_CAPACITY, max_per_tile=MAX_PER_TILE,
                  exact_cull=True)
        render(bench_camera(0), params, bg, **kw)          # warm the caches
        torch.cuda.synchronize()
        expand_rows.launches = raster_tiles_fwd.launches = 0
        outs, frame_s = [], []
        for i in range(FRAMES):
            cam = bench_camera(i)
            t0 = time.perf_counter()
            out = render(cam, params, bg, **kw)
            torch.cuda.synchronize()
            frame_s.append(time.perf_counter() - t0)
            outs.append(out)
        launches = {"K2": expand_rows.launches, "K1": raster_tiles_fwd.launches}
        for i, out in enumerate(outs):
            check(not bool(out.overflow), f"frame {i}: overflow")
            check(out.image.shape == (3, H, W), f"frame {i}: image shape")
            check(bool(torch.isfinite(out.image).all()), f"frame {i}: non-finite")
            check(0.0 <= float(out.image.min()) and float(out.image.max()) < 1.5,
                  f"frame {i}: image out of range")
        o = outs[0]
        covered = float((o.final_T < 0.5).float().mean())
        print(f"[serve] {FRAMES} frames {W}x{H}: num_duplicates "
              f"{int(o.num_duplicates)} (the JAX package on TPU: "
              f"{TPU_NUM_DUPLICATES}), num_valid {int(o.num_valid)}, "
              f"max_tile_len {int(o.max_tile_len)}, overflow False, "
              f"{covered:.1%} of pixels below T 0.5", flush=True)
        print(f"[serve] ms per frame (host clock, synchronised): "
              + ", ".join(f"{1e3 * s:.2f}" for s in frame_s)
              + f"; mean {1e3 * sum(frame_s) / FRAMES:.3f}", flush=True)
        print(f"[serve] launches over the {FRAMES} frames: {launches}", flush=True)
        check(int(o.num_duplicates) > 0 and int(o.num_valid) > 0, "empty frame")
        check(covered > 0.5, "the bench frame should be mostly covered")
        check(all(v > 0 for v in launches.values()), f"launches {launches}")
        del outs, o

        # where a frame's time goes: each stage timed alone by CUDA events
        cam = bench_camera(0)
        pr = preprocess(params, cam, active_sh_degree=3, alive=alive)
        pk = pack_projected(pr)
        stage_ms = {
            "preprocess": time_ms(torch, lambda: preprocess(
                params, cam, active_sh_degree=3, alive=alive), 10),
            "pack": time_ms(torch, lambda: pack_projected(pr), 10),
            "binning incl. K2": time_ms(torch, lambda: bin_gaussians_payload(
                pr, pk, W, H, 16, 16, DUP_CAPACITY, exact_cull=True), 10),
            "K2": k2_ms, "K1": k1_ms,
            "render()": time_ms(torch, lambda: render(cam, params, bg, **kw), 10),
        }
        print("[stages] ms by CUDA events: " + ", ".join(
            f"{k} {v:.4f}" for k, v in stage_ms.items()), flush=True)
        del pr, pk

        # the whole slice on the card against its plain versions on the CPU
        for backend_dev in (dev, torch.device("cpu")):
            sp = GaussianParams(*[t.to(backend_dev) for t in small])
            sc = make_camera(np.eye(3), np.zeros(3), math.radians(60), sfovy,
                             128, 96, device=backend_dev)
            so = render(sc, sp, torch.full((3,), 0.3, device=backend_dev),
                        active_sh_degree=3, dup_capacity=1 << 14,
                        max_per_tile=512, exact_cull=True)
            if backend_dev == dev:
                card_out = so
        for k in ("image", "invdepth", "final_T"):
            ok, mx, frac = images_match(getattr(card_out, k).cpu(), getattr(so, k))
            check(ok, f"small-scene render {k}: card vs CPU max {mx} frac {frac}")
        print(f"[slice] 300-gaussian 128x96 render(): card matches the CPU "
              f"plain path (image, invdepth, final_T)", flush=True)

        # orbit CLI: caps from a generous render of its own two cameras
        center, radius = view_orbit.orbit_geometry(d["xyz"], 1.0)
        nd_max, ml_max = 0, 0
        for i in range(2):
            cam = view_orbit.orbit_camera(center, radius, 0.3, math.pi * i, W,
                                          H, math.radians(70.0), device=dev)
            out = render(cam, params, bg, active_sh_degree=3, alive=alive,
                         dup_capacity=(1 << 24) - 1, max_per_tile=1 << 20,
                         exact_cull=True)
            check(not bool(out.overflow), "orbit pre-check overflow")
            nd_max = max(nd_max, int(out.num_duplicates))
            ml_max = max(ml_max, int(out.max_tile_len))
        orbit_cap = -(-int(nd_max * 1.05) // 1024) * 1024
        orbit_mpt = -(-int(ml_max * 1.1) // 128) * 128
        print(f"[orbit] caps: --dup_capacity {orbit_cap} --max_per_tile "
              f"{orbit_mpt} (num_duplicates {nd_max}, max_tile_len {ml_max})",
              flush=True)
        del out
    expand_rows.launches = raster_tiles_fwd.launches = 0
    log = io.StringIO()
    t0 = time.perf_counter()
    orbit_args = ["-m", model_dir, "--data_device", "cuda", "--frames", "2",
                  "--width", str(W), "--height", str(H), "--dup_capacity",
                  str(orbit_cap), "--max_per_tile", str(orbit_mpt)]
    with contextlib.redirect_stdout(log):
        view_orbit.main(orbit_args)
    orbit_s = time.perf_counter() - t0
    orbit_launches = {"K2": expand_rows.launches, "K1": raster_tiles_fwd.launches}
    print(log.getvalue().strip().splitlines()[-1])
    pngs = sorted(os.listdir(os.path.join(model_dir, "orbit_30000")))
    print(f"[orbit] 2 frames in {orbit_s:.2f} s, {pngs}, launches "
          f"{orbit_launches}", flush=True)
    check("overflow" not in log.getvalue(), "orbit CLI reported overflow")
    check(pngs == ["00000.png", "00001.png"], "orbit PNGs")
    check(all(v == 2 for v in orbit_launches.values()),
          f"orbit launches {orbit_launches}")

    # one profiled frame: device time by kernel, and the device's busy share
    # of the unprofiled frame time measured above
    with torch.no_grad():
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            render(bench_camera(0), params, bg, **kw)
            torch.cuda.synchronize()
    events = prof.key_averages()
    kernels_run = [e for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels_run) / 1e3
    frame_ms = 1e3 * sum(frame_s) / FRAMES
    print(f"[profile] one bench frame: device busy {busy_ms:.4f} ms in "
          f"{sum(e.count for e in kernels_run)} kernel launches; against the "
          f"{frame_ms:.3f} ms frame the device is idle "
          f"{1 - busy_ms / frame_ms:.1%}", flush=True)
    print(events.table(sort_by="cuda_time_total", row_limit=12,
                       max_name_column_width=60), flush=True)
    t_bf16 = time.perf_counter()
    bf16_launches, bf16_errs = bf16_serve_phase(
        torch, dev, params, alive, bg, bench_camera, kw, model_dir,
        orbit_args, counters)
    print(f"[bf16 serve] in {time.perf_counter() - t_bf16:.1f} s", flush=True)
    tmp.cleanup()
    del params, alive

    bare_step_ms, mid, kernels_train = train_phases(
        torch, dev, small, scam, p0, alive0, bench_camera)
    t_long = time.perf_counter()
    long_err, long_k4 = k4_long_phase(torch, dev)
    print(f"[K4 long] in {time.perf_counter() - t_long:.1f} s", flush=True)
    t_pre = time.perf_counter()
    pre = preprocess_phase(torch, dev)
    print(f"[preprocess] in {time.perf_counter() - t_pre:.1f} s", flush=True)
    t_adam = time.perf_counter()
    adam = adam_phase(torch, dev)
    print(f"[adam] in {time.perf_counter() - t_adam:.1f} s", flush=True)
    t_ssim = time.perf_counter()
    ssim = ssim_phase(torch, dev)
    print(f"[ssim] in {time.perf_counter() - t_ssim:.1f} s", flush=True)
    t_packed = time.perf_counter()
    packed_launches, packed_errs = packed_step_phase(
        torch, dev, p0, alive0, bench_camera, counters)
    bf16_step_phase(torch, dev, p0, alive0, bench_camera)
    t_graph = time.perf_counter()
    graph_step_launches = graph_step_phase(torch, dev, p0, alive0,
                                           bench_camera, counters)
    print(f"[graph step] in {time.perf_counter() - t_graph:.1f} s",
          flush=True)
    t_graph = time.perf_counter()
    view_graph_launches = view_graph_phase(torch, dev, p0, alive0,
                                           bench_camera, counters)
    print(f"[view graph] in {time.perf_counter() - t_graph:.1f} s",
          flush=True)
    for k, v in packed_mesh_phase(torch, dev, p0, alive0,
                                  bench_camera).items():
        packed_errs[k] = max(packed_errs[k], v)
    print(f"[packed] the packed step phases in "
          f"{time.perf_counter() - t_packed:.1f} s", flush=True)
    trainer_launches, trainer_tmp, root, model, dup, steady_ms = \
        trainer_phase(torch, dev, pts, cols, p0, alive0, bare_step_ms, mid)
    t_packed = time.perf_counter()
    packed_trainer_phase(torch, dev, root, counters)
    print(f"[packed trainer] in {time.perf_counter() - t_packed:.1f} s",
          flush=True)
    t_graph = time.perf_counter()
    graph_trainer_launches = graph_trainer_phase(torch, dev, root, counters)
    print(f"[graph trainer] in {time.perf_counter() - t_graph:.1f} s",
          flush=True)
    t_graph = time.perf_counter()
    graph_options_phase(torch, dev, root, p0, alive0, counters)
    print(f"[graph options] in {time.perf_counter() - t_graph:.1f} s",
          flush=True)
    t_graph = time.perf_counter()
    step_graph_launches = step_graph_phase(torch, dev, root, counters)
    print(f"[step graph] in {time.perf_counter() - t_graph:.1f} s",
          flush=True)
    t_graph = time.perf_counter()
    density_graph_phase(torch, dev, root, model, dup, counters)
    print(f"[density graph] in {time.perf_counter() - t_graph:.1f} s",
          flush=True)
    t_mesh = time.perf_counter()
    mesh_errs, _ = mesh_kernels_phase(torch, dev, p0, alive0, bench_camera,
                                      counters)
    mesh_step_phase(torch, dev, p0, alive0, bench_camera, counters)
    mesh_launches, trainer_errs = mesh_trainer_phase(torch, dev, root, dup,
                                                     counters)
    for k, v in trainer_errs.items():
        mesh_errs[k] = max(mesh_errs.get(k, 0.0), v)
    print(f"[mesh] the mesh phases in {time.perf_counter() - t_mesh:.1f} s",
          flush=True)
    t_mesh = time.perf_counter()
    mesh_graph_launches = mesh_graph_trainer_phase(torch, dev, root, dup,
                                                   counters)
    print(f"[mesh graph trainer] in {time.perf_counter() - t_mesh:.1f} s",
          flush=True)
    t_mesh = time.perf_counter()
    mesh_view_graph_launches = mesh_view_graph_phase(
        torch, dev, p0, alive0, bench_camera, counters)
    print(f"[mesh view graph] in {time.perf_counter() - t_mesh:.1f} s",
          flush=True)
    frames, live_cams = live_frames(torch, dev, p0, alive0, pts)
    del p0, alive0, mid
    viewer_launches, viewer_errs = viewer_phase(torch, dev, root, dup,
                                                steady_ms, counters)
    lpips_phase(torch, dev, trainer_tmp.name, model)
    t_graph = time.perf_counter()
    metrics_graph_phase(torch, dev, trainer_tmp.name, model)
    print(f"[metrics graph] in {time.perf_counter() - t_graph:.1f} s",
          flush=True)
    full_eval_phase(torch, dev, trainer_tmp.name, root, dup, counters)
    t_new = time.perf_counter()
    native_phase(root)
    live_launches, live_errs = live_phase(
        torch, dev, trainer_tmp.name, frames, live_cams, dup, steady_ms,
        counters)
    bench = {"K2": k2_ms, "K4": kernels_train[2]["ms"]}
    rain_errs, rain_k4 = live_rain_phase(torch, dev, trainer_tmp.name, frames,
                                         dup, bench, counters)
    convert_stream_phase(torch, dev, trainer_tmp.name, frames, dup)
    print(f"[live] the new phases in {time.perf_counter() - t_new:.1f} s",
          flush=True)
    trainer_tmp.cleanup()

    # --------------------------------------------------------------- 10
    kernels = [
        {"name": "expand_rows", "id": "K2", "route": "cuda",
         "source": "gs_tpu_torch/csrc/expand.cu",
         "replaces": "gs_tpu/ops/expand_pallas.py:61",
         "launches": launches["K2"], "max_abs_err": k2_err,
         "ms": k2_ms, "kernel_ms": k2_ms, "plain_ms": k2_plain_ms,
         "bound_ms": k2_bound, "bound_by": "bytes" if k2_bytes /
         HBM_BYTES_PER_S >= k2_ops / FP32_OPS_PER_S else "operations",
         "library_ms": k2_lib_ms},
        {"name": "raster_tiles_fwd", "id": "K1", "route": "cuda",
         "source": "gs_tpu_torch/csrc/rasterize_fwd.cu",
         "replaces": "gs_tpu/ops/rasterize_pallas.py:125",
         "launches": launches["K1"], "max_abs_err": k1_err,
         "ms": k1_ms, "kernel_ms": k1_ms, "plain_ms": k1_plain_ms,
         "bound_ms": k1_bound,
         "bound_by": "bytes" if k1_bound_b >= k1_bound_o else "operations",
         "library_ms": None},
    ] + kernels_train + [
        # port-only: gs_tpu's preprocess is jnp, no pallas_call; its errors
        # are relative to each field's or row group's largest
        {"name": f"preprocess_{way}", "id": i, "route": "cuda",
         "source": "gs_tpu_torch/csrc/preprocess.cu", "replaces": None,
         "launches": pre[f"{way}_launches"], "max_abs_err": None,
         "max_rel_err": pre["max_rel_err"], "ms": pre[f"{way}_ms"],
         "kernel_ms": pre[f"{way}_ms"], "plain_ms": pre[f"twin_{way}_ms"],
         "bound_ms": pre[f"{way}_bound_ms"], "bound_by": "bytes",
         "library_ms": None}
        for way, i in zip(("fwd", "bwd"), PRE_IDS)] + [
        # port-only as well (gs_tpu's Adam is jnp); bitwise its twin, in
        # place at ADAM_SLOTS slots, dense (and column-masked beside)
        {"name": "adam_packed", "id": "ADAM", "route": "cuda",
         "source": "gs_tpu_torch/csrc/adam.cu", "replaces": None,
         "launches": adam["launches"], "max_abs_err": 0.0,
         "ms": adam["dense_ms"], "kernel_ms": adam["dense_ms"],
         "masked_ms": adam["masked_ms"], "plain_ms": adam["twin_ms"],
         "plain_masked_ms": adam["twin_masked_ms"],
         "bound_ms": adam["bound_ms"], "bound_by": "bytes",
         "library_ms": None}] + [
        # port-only too (gs_tpu's SSIM is jnp); the value's error absolute,
        # the gradient's relative to its largest, at the SSIM_FRAMES
        {"name": f"ssim_{way}", "id": i, "route": "cuda",
         "source": "gs_tpu_torch/csrc/ssim.cu", "replaces": None,
         "launches": ssim[f"{way}_launches"],
         "max_abs_err": ssim["max_value_err"],
         "max_rel_err": ssim["max_rel_err"], "ms": ssim[f"{way}_ms"],
         "kernel_ms": ssim[f"{way}_ms"], "plain_ms": ssim[f"twin_{way}_ms"],
         "bound_ms": ssim[f"{way}_bound_ms"],
         "bound_by": ssim[f"{way}_bound_by"], "library_ms": None}
        for way, i in zip(("fwd", "bwd"), SSIM_IDS)]
    k4 = kernels_train[2]
    k4.update(long_k4)
    k4.update(rain_k4)
    k4["max_abs_err"] = max(k4["max_abs_err"], long_err)
    for k in kernels:
        # None: a phase with counters of its own, without the preprocess's
        k["trainer_launches"] = trainer_launches.get(k["id"])
        k["viewer_launches"] = viewer_launches[k["id"]]
        k["live_launches"] = live_launches[k["id"]]
        k["mesh_launches"] = mesh_launches[k["id"]]
        k["packed_launches"] = packed_launches[k["id"]]
        k["bf16_launches"] = bf16_launches[k["id"]]
        k["graph_step_launches"] = graph_step_launches[k["id"]]
        k["graph_trainer_launches"] = graph_trainer_launches[k["id"]]
        k["mesh_graph_launches"] = mesh_graph_launches[k["id"]]
        k["step_graph_launches"] = step_graph_launches[k["id"]]
        k["view_graph_launches"] = view_graph_launches[k["id"]]
        k["mesh_view_graph_launches"] = mesh_view_graph_launches[k["id"]]
        if k["id"] in PRE_IDS + ("ADAM",) + SSIM_IDS:
            continue
        k["max_abs_err"] = max(k["max_abs_err"], viewer_errs[k["id"]],
                               live_errs[k["id"]], rain_errs[k["id"]],
                               mesh_errs.get(k["id"], 0.0),
                               packed_errs[k["id"]],
                               bf16_errs.get(k["id"], 0.0))
    print(f"[done] {time.perf_counter() - t_start:.1f} s in all", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
