"""The training driver — port of ``gs_tpu/train/loop.py``: schedule,
densification, eval, overflow replay, on one device or with the Gaussians
sharded over a group (``mesh``), on the packed [R, C] state layout (the
default, as in the JAX package) or the tree layout.

Orchestrates the train step like the reference loop (ref: train.py:43-183):
epoch-less random camera picks without replacement, densify/prune every
``densification_interval`` iterations inside [densify_from_iter,
densify_until_iter), opacity reset every ``opacity_reset_interval`` (plus
once at densify_from_iter on a white background), the SH-degree ramp and
periodic test-set PSNR reports. Padded-capacity growth (at 85 % alive, by 4,
capped below 2^24: ``next_capacity``) and duplicate-buffer overflow
recovery have no reference counterpart: an overflow is seen only at a sync,
so the state at each sync is kept and the window since is replayed with
grown buffers, with the same camera picks and random draws, so no update is
kept from a truncated render.

The training images (and alpha masks, depth maps, depth masks and depth
weights) move to ``model_cfg.data_device`` once, in the constructor.
Nothing reads the device back between syncs (every ``sync_every``
iterations in step mode, after every block in block mode, at test
iterations, and after every densify, whose growth check reads the alive
count, as the JAX trainer's ``_maybe_grow`` does).

Step mode runs one iteration at a time, as the JAX trainer dispatches
its jitted step once per iteration (``gs_tpu/train/loop.py:261-280``): on
CUDA each iteration replays one captured CUDA graph of the step
(``train/graph.py::ChainStep.step``), its camera, iteration,
schedule row and background loaded into the graph's inputs; on the CPU the
same body runs eagerly. Block mode (``train(block_scan=True)``,
``run_block``) runs schedule-aligned blocks with the JAX trainer's block
dispatch (``train/graph.py``): ``block_dispatch`` "chain" (the default,
``gs_tpu/train/loop.py:158-164``) replays a CUDA graph of one step per
iteration, "scan" one of a bucket of ``densification_interval`` steps per
bucket; on the CPU the same bodies run eagerly. The graph updates its
static state in place, so the snapshot at a sync is a copy of it, and the
metrics the trainer keeps are copies of the graph's; whatever replaces
the state between steps or blocks (densify, opacity reset, an overflow
replay's snapshot, a resumed checkpoint) is copied into the static
tensors at the next one. A growth of the capacity, or of the binning
buffers (which rebuilds the step), captures again; ``captures`` records
each capture's capacity, time and graph-pool peak. Under a ``mesh`` the block goes through the same
chain or scan, whose graph then holds the banded step and its
collectives, as the JAX trainer dispatches its block under a mesh
(``gs_tpu/train/loop.py:327-375``); on gloo the bodies run eagerly.

Under a ``mesh`` (a group of ``parallel/mesh.py``) the state is this
process's shards of a capacity padded to a multiple of the group's size
(``gs_tpu/train/loop.py:138-146``), and every step renders through
``render_multichip``. ``visible_capacity`` 0 is sized from the per-shard
alive counts at the start and grown on overflow like the binning buffers
(``:567-614``); -1 gathers whole shards. A densify gathers the state, runs
the one-device ``densify_and_prune`` with the same noise on every process
and shards the result again: the JAX package's sharded densify equals the
one-device one (``tests/test_sharding.py``), and so does this. Growth
likewise gathers, grows and re-shards. Test views render banded too.

``packed`` (None means packed, ``gs_tpu/train/loop.py:96``) keeps the
state as a ``models/packed_state.py::PackedState``, packed after the mesh
shard; densify, opacity reset and growth go through the packed functions,
which unpack, run the tree layout's and pack again. The snapshot, the
checkpoints (``train/checkpoint.py`` unpacks) and every render of a view
read ``PackedState.params``/``.alive``.

The views of ``render_view`` and ``evaluate`` (and so the viewer's
frames) replay a captured CUDA graph of the view
(``render.py::ViewGraph``), as the JAX trainer jits ``_eval_render``
(``gs_tpu/train/loop.py:661-701``); a new state, resolution or buffer size
captures again. Under a mesh the graph holds the banded view and its
collectives. Density control replays one captured graph per densify and
one per opacity reset (``train/graph.py::DensityGraph``), as the JAX
trainer jits ``densify_and_prune`` and ``reset_opacity``
(``gs_tpu/train/loop.py:225-231``): the graph writes its result into the
step graph's static state, so the next step and the views keep their
captures. ``_eager_dispatch`` runs step mode's step, the view and density
control eagerly: the reference the card's checks hold the graphs to.

Host spans (``utils/spans.py``) time what the host does around the
replays: ``train`` (a ``train`` call), ``train.block``, ``train.load`` (a
bucket's inputs), ``train.step`` (one replay, in ``train/graph.py``),
``train.sync``, ``train.snapshot`` and ``train.schedule``, each with the
iteration it belongs to, and ``view`` around ``render_view``.

Not ported, being XLA machinery of the JAX trainer: the background thread
of the next capacity tier's compile (a capture takes about one step, so
the next tier is captured when it is needed; ``train/graph.py`` says
more).
"""
from __future__ import annotations

import copy
import dataclasses
import math
import os
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..config import (ModelConfig, OptimizationConfig, PipelineConfig,
                      RasterConfig)
from ..core.camera import stack_cameras
from ..data.camera_utils import LoadedCamera
from ..models.gaussian_model import (MAX_CAPACITY, TrainState,
                                     create_from_pcd, densify_and_prune,
                                     grow_capacity, init_state, reset_opacity)
from ..models.packed_state import (PackedState, densify_and_prune_packed,
                                   grow_capacity_packed, pack_state,
                                   reset_opacity_packed, unpack_state)
from ..ops.losses import psnr
from ..parallel.mesh import gather_state, pad_state, shard_state
from ..render import (MAX_DUP_CAPACITY, RenderOutput, ViewGraph,
                      overflow_changes, render_grown)
from ..utils import spans
from .graph import (DensityGraph, TrainingData, make_train_step_chain,
                    make_train_steps_scan)
from .step import StepMetrics, make_train_step, mask_sh_rest


def next_capacity(capacity: int, factor: int = 4) -> int:
    """The capacity a grow moves to: ``factor`` times, capped at
    ``MAX_CAPACITY`` (the binning addresses fewer than 2^24 Gaussians)."""
    return min(capacity * factor, MAX_CAPACITY)


def _normalize_resolutions(cams: list) -> list:
    """Training batches require one (W, H); real COLMAP scenes occasionally
    differ by a pixel after undistortion — resize those to the modal
    resolution (sub-pixel warp, FoV kept) instead of crashing."""
    from collections import Counter
    sizes = Counter((c.camera.width, c.camera.height) for c in cams)
    if len(sizes) == 1:
        return cams
    (w, h), _ = sizes.most_common(1)[0]
    print(f"[gs_tpu_torch] non-uniform camera resolutions {dict(sizes)}; "
          f"resizing all to {w}x{h}")
    out = []
    for c in cams:
        if (c.camera.width, c.camera.height) == (w, h):
            out.append(c)
            continue
        import cv2
        img = cv2.resize(c.image.transpose(1, 2, 0), (w, h)).transpose(2, 0, 1)
        alpha = cv2.resize(c.alpha_mask[0], (w, h))[None]
        invd = (cv2.resize(c.invdepth, (w, h))
                if c.invdepth is not None else None)
        dmask = (cv2.resize(c.depth_mask, (w, h))
                 if c.depth_mask is not None else None)
        cam = dataclasses.replace(c.camera, width=w, height=h)
        out.append(c._replace(camera=cam, image=np.ascontiguousarray(img),
                              alpha_mask=np.ascontiguousarray(alpha),
                              invdepth=invd, depth_mask=dmask))
    return out


def _fold_window(last: StepMetrics, acc: Optional[StepMetrics]) -> StepMetrics:
    """The last step's metrics with the window's overflow flag and the
    largest num_duplicates and max_tile_len (and, under a mesh, the largest
    band's counts) since the last sync, on the device: an overflow anywhere
    in the window must be seen at the sync."""
    if acc is None:
        return last
    banded = {k: torch.maximum(getattr(last, k), getattr(acc, k))
              for k in ("max_band_visible", "max_band_duplicates")
              if getattr(last, k) is not None}
    return last._replace(
        overflow=last.overflow | acc.overflow,
        num_duplicates=torch.maximum(last.num_duplicates, acc.num_duplicates),
        max_tile_len=torch.maximum(last.max_tile_len, acc.max_tile_len),
        **banded)


class Trainer:
    def __init__(self, train_cams: Sequence[LoadedCamera],
                 point_cloud, spatial_lr_scale: float,
                 model_cfg: ModelConfig, opt: OptimizationConfig,
                 pipe: PipelineConfig, raster: RasterConfig,
                 test_cams: Sequence[LoadedCamera] = (),
                 start_state: Optional[TrainState] = None,
                 start_iteration: int = 0, seed: int = 0,
                 initial_capacity: Optional[int] = None, mesh=None,
                 packed: Optional[bool] = None):
        """Trains on ``model_cfg.data_device``; the cameras must be there.
        ``mesh``: a group of ``parallel/mesh.py`` to shard the Gaussians
        over; ``start_state`` (a TrainState or a PackedState) is then the
        whole state, as on one device. ``packed``: train on the [R, C]
        layout (None: yes, as the JAX trainer does)."""
        if not train_cams:
            raise ValueError("the Trainer needs at least one training camera")
        self.mesh = mesh
        self.packed = True if packed is None else bool(packed)
        self.device = torch.device(model_cfg.data_device)
        self.train_cams = _normalize_resolutions(list(train_cams))
        self.test_cams = list(test_cams)
        self.model_cfg = model_cfg
        self.opt = opt
        self.pipe = pipe
        self.raster = raster
        # spatial_lr_scale IS the scene extent: the reference assigns
        # cameras_extent to both (scene/__init__.py passes it as
        # spatial_lr_scale; train.py:161 uses it as the densify extent)
        self.spatial_lr_scale = float(spatial_lr_scale)
        self.iteration = start_iteration
        self.rng = np.random.default_rng(seed)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)

        def upload(arrays):
            return torch.from_numpy(np.stack(arrays)).to(self.device)

        self.cam_batch = stack_cameras([c.camera for c in self.train_cams])
        self.images = upload([c.image for c in self.train_cams])
        has_alpha = any(c.alpha_mask.min() < 1.0 for c in self.train_cams)
        self.alphas = (upload([c.alpha_mask for c in self.train_cams])
                       if has_alpha else None)
        # depth priors may cover only part of the cameras (the reference
        # simply skips the depth term for views without a map); missing views
        # get zero maps + depth_ok=0
        self.use_depth = any(c.invdepth is not None for c in self.train_cams)
        if self.use_depth:
            h, w = self.train_cams[0].image.shape[1:]
            zero = np.zeros((h, w), np.float32)
            self.invdepths = upload(
                [c.invdepth if c.invdepth is not None else zero
                 for c in self.train_cams])
            self.depth_masks = upload(
                [c.depth_mask if c.depth_mask is not None else zero
                 for c in self.train_cams])
            self.depth_oks = upload(
                [1.0 if (c.invdepth is not None and c.depth_reliable) else 0.0
                 for c in self.train_cams]).to(torch.float32)
        self._data = TrainingData(
            self.images, self.alphas,
            *((self.invdepths, self.depth_masks, self.depth_oks)
              if self.use_depth else ()))

        if start_state is None:
            pts, cols, _ = point_cloud
            params, alive = create_from_pcd(pts, cols, model_cfg.sh_degree,
                                            capacity=initial_capacity,
                                            device=self.device)
            self.state = init_state(params, alive,
                                    num_images=len(self.train_cams))
        elif isinstance(start_state, PackedState):
            self.state = unpack_state(start_state)
        else:
            self.state = start_state
        if mesh is not None:
            self.state = shard_state(pad_state(self.state, mesh.size), mesh)
            self._auto_visible_capacity()
        if self.packed:
            self.state = pack_state(self.state)

        # block dispatch: "chain" replays one captured step per iteration,
        # "scan" one captured bucket of densification_interval steps
        self.block_dispatch = "chain"
        self._runner = None
        self.captures: list = []      # every capture: capacity, ms, pool peak
        # the view's graphs (render_view, evaluate, the viewer), banded
        # under a mesh
        self.views = ViewGraph(mesh=mesh)
        # every capture of density control's graphs (densify, opacity
        # reset), which the step runner holds on its static state
        self.density_captures: list = []
        # True: step mode's step, the view and density control run
        # eagerly, not as graph replays (the reference the card's checks
        # hold them to; as the JAX CLI has no switch for its jit, no flag
        # sets it)
        self._eager_dispatch = False
        self._build_step()
        self._camera_stack: list[int] = []
        self.ema_loss = 0.0
        self.sync_every = 50          # device->host metric fetch cadence
        self._last_metrics = None
        self._window_metrics = None
        self._last_cam = -1
        # windows where replay gave up and truncated updates were kept: a
        # correctness cliff that must be loud
        self.overflow_exhausted = 0
        # densifies that found the alive count past 85 % of MAX_CAPACITY
        self.capacity_exhausted = 0
        # overflow replay: keep the state at the last sync point plus a log
        # of everything dispatched since, so a binning overflow (observable
        # only at syncs) re-runs the damaged window with grown buffers
        # instead of keeping truncated-gradient updates. Holding references
        # is the snapshot, but for the step graph's static tensors, which
        # the graphs (step and density control) write in place: the
        # snapshot holds copies of those (``_take_snapshot``).
        self._replaying = False
        self._replay_log: list = []
        self._synced = None
        self._take_snapshot()

    # ------------------------------------------------------------- plumbing

    def _build_step(self):
        self._runner = None           # captured from the old step
        self.train_step = make_train_step(
            self.opt, self.model_cfg, self.pipe, self.raster, self.cam_batch,
            self.spatial_lr_scale, self.model_cfg.sh_degree, mesh=self.mesh,
            packed=self.packed)

    # ------------------------------------------------------------- the mesh

    @property
    def capacity(self) -> int:
        """The whole state's capacity (under a mesh, over all shards)."""
        if self.mesh is None:
            return self.state.capacity
        return self.state.capacity // len(self.mesh.local) * self.mesh.size

    def _local_shards(self, x: torch.Tensor):
        return x.chunk(len(self.mesh.local))

    def num_alive(self) -> int:
        """The alive count of the whole state (a collective under a mesh:
        every process calls it)."""
        if self.mesh is None:
            return int(self.state.num_alive)
        return int(self.mesh.sum([a.sum() for a in
                                  self._local_shards(self.state.alive)]))

    def full_state(self):
        """The whole state, a TrainState or a PackedState (gathered under
        a mesh: every process calls it), for checkpoints, PLY snapshots and
        density control."""
        if self.mesh is None:
            return self.state
        return gather_state(self.state, self.mesh)

    def _auto_visible_capacity(self):
        """``visible_capacity`` 0 (auto): the largest per-shard alive count
        (visible <= alive) with 20 % headroom, 64-aligned; off when that is
        no smaller than a shard. -1: off (``gs_tpu/train/loop.py:567-593``)."""
        vcap = self.raster.visible_capacity
        if vcap < 0:
            self.raster = dataclasses.replace(self.raster, visible_capacity=0)
            return
        if vcap:
            return
        per_shard = self.mesh.gather_values(
            [a.sum() for a in self._local_shards(self.state.alive)])
        mx = int(per_shard.max())
        auto = max(64, -(-int(mx * 1.2 + 63) // 64) * 64)
        if auto < self.capacity // self.mesh.size:
            self.raster = dataclasses.replace(self.raster,
                                              visible_capacity=auto)

    def _next_camera(self) -> int:
        # random pop without replacement (ref: train.py:96-98)
        if not self._camera_stack:
            self._camera_stack = list(
                self.rng.permutation(len(self.train_cams)))
        return int(self._camera_stack.pop())

    def _densify_noise(self, capacity: int) -> torch.Tensor:
        """The split children's standard-normal offsets, [capacity, 3],
        drawn into density control's static input (a new tensor under
        ``_eager_dispatch``)."""
        out = (None if self._eager_dispatch
               else self._runner.density_control().noise)
        return torch.randn((capacity, 3), generator=self.generator,
                           device=self.device, out=out)

    def _density_control(self, state) -> DensityGraph:
        """Density control on the step graph's static state, with
        ``state`` bound into it first: the current runner's (else one for
        ``block_dispatch``), which the next step replays, so the view
        graphs, which read the same tensors, keep their captures."""
        runner = self._graph_runner(self._runner.mode if self._runner
                                    else self.block_dispatch)
        runner.bind(state, self._data)
        return runner.density_control()

    def _densify(self, state, use_size_threshold: bool):
        """One densify/prune: one replay of density control's graph on the
        step graph's static state (on the CPU its body), as the JAX trainer
        dispatches its jitted densify once. Under a mesh: gather, the
        one-device pass with the same noise on every process (the same
        generator state), and shard again, in the graph too. Under
        ``_eager_dispatch``, eagerly on new tensors."""
        kw = dict(grad_threshold=self.opt.densify_grad_threshold,
                  min_opacity=0.005, extent=self.spatial_lr_scale,
                  percent_dense=self.opt.percent_dense)
        capacity = state.capacity
        if self.mesh is not None:
            capacity = capacity // len(self.mesh.local) * self.mesh.size
        if not self._eager_dispatch:
            density = self._density_control(state)
            info = density.densify(self._densify_noise(capacity),
                                   use_size_threshold, **kw)
            return density.state, info
        if self.mesh is not None:
            state = gather_state(state, self.mesh)
        densify = densify_and_prune_packed if self.packed else \
            densify_and_prune
        state, info = densify(state, self._densify_noise(capacity),
                              use_size_threshold=use_size_threshold, **kw)
        if self.mesh is not None:
            state = shard_state(state, self.mesh)
        return state, info

    # ----------------------------------------------------------------- step

    def step(self, sync: bool = False) -> StepMetrics:
        """Run one training iteration (self.iteration advances to i+1).

        The device is read back (loss, overflow) only every ``sync_every``
        iterations or when ``sync`` is set; the returned metrics are 0-d
        device tensors, copies that later steps leave as they are.
        """
        self._dispatch_step()
        i = self.iteration
        self._apply_schedule(i)
        if sync or i % self.sync_every == 0:
            self.sync_metrics()
        return self._last_metrics

    def _dispatch_step(self):
        """One train step (no schedule, no sync) — the replayable unit: a
        replay of step mode's graph (on the CPU its body), or the eager
        step under ``_eager_dispatch``."""
        self._log(("step",))
        self.iteration += 1
        i = self.iteration
        idx = self._next_camera()
        alpha = self.alphas[idx] if self.alphas is not None else None
        if self.use_depth:
            invd, dmask = self.invdepths[idx], self.depth_masks[idx]
            dok = self.depth_oks[idx]
        else:
            invd, dmask, dok = None, None, 0.0
        if self._eager_dispatch:
            self.state, metrics = self.train_step(
                self.state, idx, self.images[idx], alpha, invd, dmask, dok,
                i, generator=self.generator)
        else:
            # the eager step's own draw, in its order (train/step.py)
            bg = (torch.rand(3, generator=self.generator, device=self.device)
                  if self.opt.random_background else None)
            sched = torch.from_numpy(self.train_step.schedule(i)[0])
            self.state, metrics = self._graph_runner("chain").step(
                self.state, self._data, idx, i, sched, bg)
        self._window_metrics = _fold_window(metrics, self._window_metrics)
        self._last_metrics = self._window_metrics
        self._last_cam = idx

    def _apply_schedule(self, i: int):
        """Densify/opacity-reset at iteration i (ref: train.py:157-167)."""
        with spans.span("train.schedule", unit=i):
            self._log(("schedule", i))
            opt = self.opt
            if i < opt.densify_until_iter:
                if (i > opt.densify_from_iter
                        and i % opt.densification_interval == 0):
                    self.state, _ = self._densify(
                        self.state, i > opt.opacity_reset_interval)
                    self._maybe_grow()
                if i % opt.opacity_reset_interval == 0 or (
                        self.model_cfg.white_background and
                        i == opt.densify_from_iter):
                    if self._eager_dispatch:
                        self.state = (reset_opacity_packed if self.packed
                                      else reset_opacity)(self.state)
                    else:
                        density = self._density_control(self.state)
                        density.reset_opacity()
                        self.state = density.state

    def run_block(self, k: int) -> StepMetrics:
        """Run ``k`` iterations with no schedule and no sync. The caller
        keeps densify/reset boundaries out of the block (``train`` aligns
        blocks to the schedule).

        The block goes through ``block_dispatch``, on one device or under a
        ``mesh``: buckets of at most ``densification_interval`` steps, each
        bucket's camera picks, iterations, schedule rows and backgrounds
        uploaded once; "chain" replays the captured step once per
        iteration, "scan" the captured bucket once (its tail steps
        masked)."""
        self._log(("block", k))
        if self.block_dispatch not in ("chain", "scan"):
            raise ValueError(f"block_dispatch {self.block_dispatch!r}: "
                             f"'chain' or 'scan'")
        with spans.span("train.block", unit=self.iteration + 1):
            runner = self._graph_runner(self.block_dispatch)
            done = 0
            while done < k:
                b = min(runner.bucket, k - done)
                with spans.span("train.load", unit=self.iteration + 1):
                    cams = [self._next_camera() for _ in range(b)]
                    runner.load(*self._bucket_inputs(cams, runner.bucket))
                self.state, metrics = runner.run(self.state, self._data, b)
                self.iteration += b
                done += b
                self._last_cam = cams[-1]
                self._window_metrics = _fold_window(metrics,
                                                    self._window_metrics)
            self._last_metrics = self._window_metrics
            return self._last_metrics

    def _graph_runner(self, mode: str):
        """Block mode's chain or scan of the current step, built when first
        needed (and again after ``_build_step`` or a change of mode); step
        mode replays the chain's graph through its ``step`` entry."""
        if self._runner is None or self._runner.mode != mode:
            maker = (make_train_step_chain if mode == "chain"
                     else make_train_steps_scan)
            self._runner = maker(
                self.train_step, use_alpha=self.alphas is not None,
                use_depth=self.use_depth,
                bucket=max(int(self.opt.densification_interval), 1))
            self._runner.captures = self.captures
            self._runner.density_captures = self.density_captures
        return self._runner

    def _bucket_inputs(self, cams: list, bucket: int):
        """One bucket's inputs: [B, 2] camera indices and iterations, [B, 6]
        schedule rows and backgrounds, [B] valid (the first len(cams)). The
        tail repeats the last camera, as the JAX trainer's does; all B
        backgrounds are drawn, in one call, whatever the mode."""
        b = len(cams)
        its = self.iteration + 1 + np.arange(bucket)
        idxs = np.array(cams + cams[-1:] * (bucket - b), np.int64)
        ints = torch.from_numpy(np.stack([idxs, its], 1))
        floats = torch.zeros((bucket, 6))
        floats[:, :3] = torch.from_numpy(self.train_step.schedule(its))
        floats = floats.to(self.device, non_blocking=True)
        if self.opt.random_background:
            floats[:, 3:] = torch.rand((bucket, 3), generator=self.generator,
                                       device=self.device)
        return ints, floats, torch.from_numpy(np.arange(bucket) < b)

    def _next_boundary(self, i: int, end: int, extra=()) -> int:
        """Next schedule event strictly after iteration i."""
        opt = self.opt
        cands = [end]
        for interval, limit in ((opt.densification_interval,
                                 opt.densify_until_iter),
                                (opt.opacity_reset_interval, end)):
            if i < limit:
                cands.append(min((i // interval + 1) * interval, end))
        if i < opt.densify_from_iter:
            cands.append(opt.densify_from_iter)
        cands.extend(e for e in extra if e > i)
        return max(min(cands), i + 1)

    # ------------------------------------------------- sync + overflow replay

    def _log(self, entry):
        if not self._replaying:
            self._replay_log.append(entry)

    def _take_snapshot(self):
        """Mark the current state verified-clean; replay restores to here."""
        with spans.span("train.snapshot", unit=self.iteration):
            self._last_sync_iter = self.iteration
            self._replay_log = []
            self._window_metrics = None
            state = self.state
            if self._runner is not None:
                # the next block writes into the graph's static tensors
                state = self._runner.unshared(state)
            self._snapshot = dict(
                state=state, iteration=self.iteration,
                generator=self.generator.get_state(),
                camera_stack=list(self._camera_stack),
                rng_state=copy.deepcopy(self.rng.bit_generator.state))

    def _restore_snapshot(self):
        s = self._snapshot
        self.state = s["state"]
        self.iteration = s["iteration"]
        self.generator.set_state(s["generator"])
        self._camera_stack = list(s["camera_stack"])
        self.rng.bit_generator.state = copy.deepcopy(s["rng_state"])
        self._window_metrics = None

    def _replay_window(self) -> StepMetrics:
        """Re-run everything dispatched since the last sync (same cameras,
        same random draws) on the snapshot state with the rebuilt step."""
        log = self._replay_log
        self._replaying = True
        try:
            self._restore_snapshot()
            for entry in log:
                if entry[0] == "step":
                    self._dispatch_step()
                elif entry[0] == "block":
                    self.run_block(entry[1])
                else:  # ("schedule", i)
                    self._apply_schedule(entry[1])
        finally:
            self._replaying = False
            self._replay_log = log   # a second overflow replays again
        return self._last_metrics

    def sync_metrics(self):
        """Read the window's metrics back; handle overflow / NaN.

        On binning overflow the whole window since the previous sync is
        replayed with grown buffers (the reference never trains on a
        truncated render — its CUDA buffers are exact per frame)."""
        metrics = self._last_metrics
        if metrics is None or metrics is self._synced:
            return
        with spans.span("train.sync", unit=self.iteration):
            attempts = 0
            while bool(metrics.overflow):
                banded = metrics.max_band_duplicates is not None
                changes = overflow_changes(
                    self.raster.dup_capacity, self.raster.max_per_tile,
                    int(metrics.max_band_duplicates if banded
                        else metrics.num_duplicates),
                    int(metrics.max_tile_len),
                    self.raster.visible_capacity if banded else 0,
                    int(metrics.max_band_visible) if banded else 0)
                replay = bool(changes) and attempts < 4
                if changes:
                    self._grow_raster(changes, will_replay=replay)
                if not replay:
                    # replay budget exhausted, or the buffer is at its limit:
                    # this window trained on truncated renders. Record it
                    # loudly.
                    why = (f"after {attempts} attempts" if changes else
                           f"at the dup_capacity limit {MAX_DUP_CAPACITY}")
                    self.overflow_exhausted += 1
                    print(f"[gs_tpu_torch] WARNING: overflow replay exhausted "
                          f"{why} at iteration {self.iteration} "
                          f"({int(metrics.num_duplicates)} entries); "
                          f"truncated updates kept "
                          f"(overflow_exhausted={self.overflow_exhausted})",
                          flush=True)
                    break
                attempts += 1
                metrics = self._replay_window()
            loss = float(metrics.loss)
            if not math.isfinite(loss):
                self._dump_debug(self._last_cam)
                raise FloatingPointError(
                    f"non-finite loss at iteration {self.iteration} (camera "
                    f"{self._last_cam}); state snapshot written next to the "
                    f"model")
            # ref: train.py:142-148
            self.ema_loss = 0.4 * loss + 0.6 * self.ema_loss
            self._synced = self._last_metrics
            self._take_snapshot()

    def _dump_debug(self, cam_idx: int):
        """Crash snapshot of the rasterizer inputs — the counterpart of the
        reference's --debug dump-on-kernel-failure (ref: README.md:168-171,
        train.py:101-102)."""
        path = os.path.join(self.model_cfg.model_path or ".", "dump.npz")
        state = self.full_state()
        if self.mesh is not None and not self.mesh.is_main:
            return
        p = {k: t.detach().cpu().numpy()
             for k, t in state.params._asdict().items()}
        np.savez(path, **p, alive=state.alive.cpu().numpy(),
                 cam_idx=cam_idx, iteration=self.iteration)
        print(f"[gs_tpu_torch] wrote debug dump to {path}")

    def _grow_raster(self, changes: dict, will_replay: bool):
        """Grow the overflowed buffer(s) and rebuild the step."""
        ran = self.iteration - self._last_sync_iter
        msg = (f"replaying the {ran}-iteration window" if will_replay
               else f"up to {ran} iterations ran truncated")
        print(f"[gs_tpu_torch] binning overflow; {msg}; growing {changes}",
              flush=True)
        self.raster = dataclasses.replace(self.raster, **changes)
        self._build_step()

    def _maybe_grow(self, headroom: float = 0.85, factor: int = 4):
        n_alive = self.num_alive()
        cap = self.capacity
        if n_alive <= headroom * cap:
            return
        new_cap = next_capacity(cap, factor)
        if self.mesh is not None:
            # a multiple of the shards, within MAX_CAPACITY
            k = self.mesh.size
            new_cap = min(-(-new_cap // k) * k, MAX_CAPACITY // k * k)
        if new_cap > cap:
            print(f"[gs_tpu_torch] capacity {n_alive}/{cap} alive; "
                  f"growing to {new_cap}", flush=True)
            grow = (grow_capacity_packed
                    if isinstance(self.state, PackedState) else grow_capacity)
            if self.mesh is None:
                self.state = grow(self.state, new_cap)
            else:
                self.state = shard_state(grow(
                    gather_state(self.state, self.mesh), new_cap), self.mesh)
        if n_alive > headroom * MAX_CAPACITY:
            # densify drops the rows that find no free slot from here on
            self.capacity_exhausted += 1
            print(f"[gs_tpu_torch] WARNING: {n_alive} Gaussians alive at "
                  f"iteration {self.iteration}, past {headroom:.0%} of the "
                  f"largest capacity {MAX_CAPACITY}; densification will "
                  f"drop new Gaussians "
                  f"(capacity_exhausted={self.capacity_exhausted})",
                  flush=True)

    # ----------------------------------------------------------------- eval

    @torch.no_grad()
    def render_view(self, cam, scaling_modifier: float = 1.0) -> RenderOutput:
        """A no-grad render of the current state from ``cam`` (K2 + K1), as
        the test views and the viewer see it (ref: the JAX trainer's
        ``_eval_render``): the SH ramp as the train step applies it
        (coefficients above the active degree masked to zero, the full
        basis evaluated), the trainer's pipeline and raster settings, and a
        second render at grown buffers if the view overflows them
        (``render_grown``; the trainer's own ``raster`` stays as it is).
        The view replays a captured graph (``views``, a
        ``render.py::ViewGraph``; on the CPU its body runs eagerly) and the
        output is a copy, as the JAX trainer jits ``_eval_render``. Under a
        mesh every process renders the same view, banded (K2 and K1 per
        band), and the graph holds the bands' collectives."""
        with spans.span("view", frame=True):
            bg = torch.full((3,),
                            1.0 if self.model_cfg.white_background else 0.0,
                            device=self.device)
            sh_deg = min(self.iteration // 1000, self.model_cfg.sh_degree)
            kw = dict(active_sh_degree=self.model_cfg.sh_degree,
                      antialiasing=self.pipe.antialiasing,
                      alive=self.state.alive)
            if self.mesh is not None:
                if scaling_modifier != 1.0:
                    # every process renders the same view, banded; the
                    # reference's debug switches change no value and are not
                    # applied
                    raise ValueError("scaling_modifier is not supported under "
                                     "a mesh")
            else:
                kw.update(scaling_modifier=scaling_modifier,
                          convert_SHs_python=self.pipe.convert_SHs_python,
                          compute_cov3D_python=self.pipe.compute_cov3D_python)
            if self._eager_dispatch:
                out, _ = render_grown(
                    cam, mask_sh_rest(self.state.params, sh_deg), bg,
                    self.raster, mesh=self.mesh, **kw)
                return out
            # the packed block itself (its ``params`` unpack anew at each
            # access): the view's preprocess reads it and applies the ramp
            src = (self.state.packed if isinstance(self.state, PackedState)
                   else self.state.params)
            out, _ = render_grown(cam, src, bg, self.raster, mesh=self.mesh,
                                  graph=self.views, sh_degree=sh_deg, **kw)
            return out

    @torch.no_grad()
    def evaluate(self, cams: Sequence[LoadedCamera],
                 max_views: Optional[int] = None) -> dict:
        """L1 + PSNR over a camera list (ref: train.py:207-242
        training_report), each view through ``render_view``."""
        if max_views:
            cams = cams[:max_views]
        if not cams:
            return {}
        l1s, psnrs = [], []
        for c in cams:
            img = torch.clamp(self.render_view(c.camera).image, 0.0, 1.0)
            gt = torch.from_numpy(c.image).to(self.device)
            if self.model_cfg.train_test_exp:
                # score the right half only (ref: train.py:216-219 intent,
                # render.py:41-43)
                half = img.shape[-1] // 2
                img = img[..., half:]
                gt = gt[..., half:]
            l1s.append(float(torch.mean(torch.abs(img - gt))))
            psnrs.append(float(psnr(img[None], gt[None])[0, 0]))
        return {"l1": float(np.mean(l1s)), "psnr": float(np.mean(psnrs)),
                "n_views": len(cams)}

    # ------------------------------------------------------------------ run

    def train(self, iterations: Optional[int] = None,
              test_iterations: Sequence[int] = (),
              on_step: Optional[Callable] = None,
              on_test: Optional[Callable] = None,
              log_every: int = 10, block_scan: bool = False,
              boundary_iterations: Sequence[int] = (),
              block_cap: Optional[Callable] = None):
        """Run until ``iterations`` (defaults to opt.iterations).

        ``block_scan`` runs schedule-aligned blocks of steps (no schedule
        event and no ``boundary_iterations`` inside one) with one sync
        after each; step mode keeps the reference's loop shape and syncs
        every ``sync_every`` iterations.

        ``block_cap()``, called before each block, may return an int that
        caps the block's length: an attached viewer client then gets frames
        between blocks (the reference drains its socket every iteration,
        ref: train.py:72-86).
        """
        t0 = time.perf_counter()
        with spans.span("train", unit=self.iteration + 1):
            end = iterations if iterations is not None else self.opt.iterations
            events = sorted(set(test_iterations) | set(boundary_iterations))
            while self.iteration < end:
                if block_scan:
                    nb = self._next_boundary(self.iteration, end, extra=events)
                    if block_cap is not None:
                        cap = block_cap()
                        if cap:
                            nb = min(nb, self.iteration + max(int(cap), 1))
                    self.run_block(nb - self.iteration)
                    i = self.iteration
                    self._apply_schedule(i)
                    self.sync_metrics()
                    if on_step is not None:
                        on_step(i, self._last_metrics, self)
                else:
                    metrics = self.step()
                    i = self.iteration
                    if on_step is not None and i % log_every == 0:
                        on_step(i, metrics, self)
                if i in test_iterations:
                    self.sync_metrics()   # replay any overflow before scoring
                    report = {
                        "test": self.evaluate(self.test_cams),
                        "train_sample": self.evaluate(self.train_cams[:5]),
                    }
                    if on_test is not None:
                        on_test(i, report, self)
                    else:
                        print(f"[ITER {i}] " + " ".join(
                            f"{k}: psnr={v.get('psnr', float('nan')):.2f} "
                            f"l1={v.get('l1', float('nan')):.4f}"
                            for k, v in report.items() if v))
        return time.perf_counter() - t0
