"""Graphed dispatch of the training step — port of
``gs_tpu/train/step.py::make_train_step_chain`` and of the jitted step
itself (``make_train_step``'s ``jax.jit``).

The JAX package trains a block of steps on its accelerator with the
training data on the device and the camera picked by a traced index, one
compiled executable dispatched per step (its default block dispatch, the
"chain"); in step mode it dispatches its jitted step once per iteration.
PyTorch's counterpart of a compiled executable replayed per call is a CUDA
graph: on a CUDA device, :func:`make_train_step_chain` captures one step
and replays it once per step of a block, and in step mode once per call
with that call's inputs (:meth:`ChainStep.step`). On the CPU the same body
runs eagerly, in the same order on the same buffers: that is the path the
CPU tests hold against the JAX package, as the kernels' plain versions
are. The JAX package's other block dispatch, a ``lax.scan`` over a bucket
of steps, is not ported: a graph replay costs a few microseconds of a step
of many milliseconds, so one replay a bucket has nothing to save.

The graph reads and writes static tensors. A bucket's inputs (camera
indices, iterations, schedule rows and backgrounds) are uploaded into
static buffers once per bucket; the chain copies its row of them into its
step inputs on the device before each replay. The state is updated in
place: the step's last operation writes each new value into the state's
own tensor (``inplace`` in ``models/gaussian_model.py``), so no step
copies the state (a packed state of 1,048,576 slots holds ~0.8 GB of
parameters and moments). Alternating between two captures would need a
second state and buys nothing here. Density control writes its result
into the static tensors too (:class:`DensityGraph`, which the chain
holds). A state handed in from outside (the trainer's snapshot for an
overflow replay, a checkpoint, an eager densify's result) is copied into
the static tensors; one of another shape (a capacity growth) makes new
static tensors and a new capture. A caller that keeps a state past the
next replay (the trainer's snapshot) keeps a copy of every static tensor
in it (``unshared``): those change at every replay.

A capture first runs one step on a copy of the state on a side stream
(``utils/cuda_graphs.py``). Its time and the private pool's peak are
printed and kept in ``captures``. The JAX trainer compiles the next
capacity tier ahead of time in a thread (``_spawn_aot``), because an XLA
compile takes minutes; a capture takes about one eager step plus the
graph's instantiation, so the next tier is captured when it is needed and
nothing runs in the background. A failed capture or replay raises:
nothing retries through the eager loop.

Under a mesh (``train_step.mesh``, a group of ``parallel/mesh.py``) the
step is the banded multi-GPU step, and the graph holds its collectives
too: a ``LocalGroup``'s concatenations and sums, a ``ProcessGroup``'s NCCL
all-gathers, reduce-scatters and all-reduces (on gloo, CPU tensors, the
body runs eagerly). Every rank of a ``ProcessGroup`` captures at the same
points, because what decides a capture is what all ranks share: the
shapes, and the gathered overflow statistics behind a growth. Each rank's
warm-up runs the step's collectives before the capture, so NCCL's
communicator exists; after the capture the ranks agree, eagerly, on
whether every capture succeeded, and a capture that failed on any rank
raises on every rank (a rank that went on alone would hang in its next
collective). NCCL destroys a communicator only after every graph that
captured its collectives is gone, so ``ProcessGroup.close`` releases the
graphs of its group before it destroys the group. The bucket's metrics
then also carry the largest shard's visible count and the largest band's
duplicates over the bucket's steps, from which the trainer grows
``visible_capacity`` and the per-band ``dup_capacity``; ``captures``
records the whole state's capacity.

The random backgrounds of a bucket are drawn before it, all B draws at
once, as the JAX trainer splits one key into B per bucket: no generator
runs inside a graph. Step mode draws its background before each call, the
eager step's own ``torch.rand(3)`` in the eager order (the densify's noise
comes from the same generator). The graph adds the launches its capture
made to the kernel wrappers' counters at every replay.

Density control, the port of the JAX trainer's jitted ``densify_and_prune``
and ``reset_opacity``, is :class:`DensityGraph`: one captured graph per
densify and one per opacity reset, which write into the step graph's
static state; the chain holds it (:meth:`ChainStep.density_control`) and
releases it with its own graph.
"""
from __future__ import annotations

import time
from typing import NamedTuple, Optional, Sequence

import torch

from ..core.gaussians import GaussianParams
from ..models.gaussian_model import (DensifyInfo, densify_and_prune,
                                     reset_opacity)
from ..models.packed_state import (PackedState, densify_and_prune_packed,
                                   reset_opacity_packed)
from ..parallel.mesh import gather_state, shard_state
from ..utils import spans
from ..utils.cuda_graphs import capture, launch_counters, replay  # noqa: F401
from .step import StepMetrics


class TrainingData(NamedTuple):
    """The training views on the device, stacked by camera index."""
    images: torch.Tensor                     # [V, 3, H, W]
    alphas: Optional[torch.Tensor] = None    # [V, 1, H, W]
    invdepths: Optional[torch.Tensor] = None  # [V, H, W]
    depth_masks: Optional[torch.Tensor] = None
    depth_oks: Optional[torch.Tensor] = None  # [V] float32


# the bucket's metrics folded over its steps: the worst overflow and
# the largest counts (the last two under a mesh only), as
# ``gs_tpu/train/step.py:291-299`` and ``train/loop.py::_fold_window``
FOLDED = ("overflow", "num_duplicates", "max_tile_len", "max_band_visible",
          "max_band_duplicates")


def state_leaves(state) -> list:
    """Every tensor of a TrainState or PackedState, in order."""
    out = []
    for x in state:
        out.extend(x if isinstance(x, GaussianParams) else (x,))
    return out


def state_from_leaves(like, leaves):
    """A state of ``like``'s type from :func:`state_leaves`' order."""
    it = iter(leaves)
    return type(like)(*[GaussianParams(*[next(it) for _ in x])
                        if isinstance(x, GaussianParams) else next(it)
                        for x in like])


def clone_state(state):
    return state_from_leaves(state, [t.clone() for t in state_leaves(state)])


class ChainStep:
    """One step per call over the device-resident data (see
    :func:`make_train_step_chain`): the static state, the bucket's input
    buffers, the capture, the replay and density control."""

    label = "chain step"      # what the capture's messages call it

    def __init__(self, train_step, *, use_alpha: bool, use_depth: bool,
                 bucket: int):
        self.core = train_step.core
        self.mesh = train_step.mesh
        self.device = torch.device(train_step.device)
        self.random_background = train_step.random_background
        self.use_alpha, self.use_depth = use_alpha, use_depth
        self.bucket = max(int(bucket), 1)
        self.graphed = self.device.type == "cuda"
        self.state = None            # the static state the graph updates
        self.data: Optional[TrainingData] = None
        self.graph = None
        self.counts: dict = {}       # kernel wrapper -> launches per replay
        self.captures: list = []     # {capacity, ms, pool_peak_bytes}
        # density control on the static state, made when first asked for
        self.density: Optional[DensityGraph] = None
        self.density_captures: list = []
        dev, b = self.device, self.bucket
        # per step: camera index and iteration; schedule row and background
        self.ints = torch.zeros((b, 2), dtype=torch.int64, device=dev)
        self.floats = torch.zeros((b, 6), dtype=torch.float32, device=dev)
        # the loaded bucket's iterations, on the host: its spans' units
        self.iterations: list = [0] * b
        # the replayed step's inputs, a row of the bucket's
        self.row_ints = torch.zeros((2,), dtype=torch.int64, device=dev)
        self.row_floats = torch.zeros((6,), dtype=torch.float32, device=dev)
        self.out: Optional[StepMetrics] = None
        # the bucket's FOLDED metrics, by name
        self.fold: Optional[dict] = None

    # ------------------------------------------------------------ the state

    def owns(self, state) -> bool:
        """Whether ``state``'s tensors are this graph's static ones."""
        return self.state is not None and all(
            a is b for a, b in zip(state_leaves(state),
                                   state_leaves(self.state)))

    def unshared(self, state):
        """``state`` with each of this graph's static tensors in it
        replaced by a copy: what a caller keeps past the next replay (a
        densify's result keeps the step counters and exposures it was
        given)."""
        if self.state is None:
            return state
        mine = {id(t) for t in state_leaves(self.state)}
        return state_from_leaves(state, [
            t.clone() if id(t) in mine else t for t in state_leaves(state)])

    def bind(self, state, data: TrainingData):
        """Make the static state hold ``state``: a copy into the static
        tensors where the shapes agree, else new static tensors (and a new
        capture on CUDA)."""
        if self.owns(state) and data is self.data:
            return
        mine = None if self.state is None else state_leaves(self.state)
        theirs = state_leaves(state)
        if (data is self.data and mine is not None
                and type(state) is type(self.state)
                and [(t.shape, t.dtype) for t in mine]
                == [(t.shape, t.dtype) for t in theirs]):
            with torch.no_grad():
                for a, b in zip(mine, theirs):
                    if a is not b:
                        a.copy_(b)
            return
        self.release()
        self.state = clone_state(state)
        self.data = data
        if self.graphed:
            self._capture()

    def density_control(self) -> "DensityGraph":
        """Density control on the static state (a :class:`DensityGraph`),
        made when first asked for and again for new static tensors."""
        if self.density is None:
            self.density = DensityGraph(self.state, self.mesh,
                                        self.density_captures)
        return self.density

    def load(self, ints: torch.Tensor, floats: torch.Tensor,
             iterations: Sequence[int]):
        """A bucket's inputs into the static buffers, one row a step (at
        most ``bucket``): ``ints`` [b, 2] int64 (camera index, iteration),
        ``floats`` [b, 6] float32 (the schedule row, the background), and
        the rows' iterations on the host."""
        b = ints.shape[0]
        self.ints[:b].copy_(ints, non_blocking=True)
        self.floats[:b].copy_(floats, non_blocking=True)
        self.iterations = [int(i) for i in iterations]

    # ------------------------------------------------------------- the step

    def step_body(self, state, ints: torch.Tensor, floats: torch.Tensor,
                  inplace: bool = True):
        """One step on ``state`` (in place unless ``inplace`` is False), its
        camera and iteration from ``ints`` [2], its schedule row and
        background from ``floats`` [6], its views gathered from the data by
        the device index. Its ``step`` stamp opens the step's stages
        (``utils/spans.py``); the graph body closes them with ``end``."""
        spans.stage("step", self.device)
        d = self.data
        index = ints[0].reshape(1)

        def pick(x):
            return x.index_select(0, index)[0]

        gt = pick(d.images)
        alpha = pick(d.alphas) if self.use_alpha else None
        if self.use_depth:
            invd, dmask, dok = (pick(d.invdepths), pick(d.depth_masks),
                                pick(d.depth_oks))
        else:
            invd = dmask = dok = None
        bg = floats[3:] if self.random_background else None
        return self.core(state, ints[0], ints[1], floats[:3], gt, alpha,
                         invd, dmask, dok, bg, inplace=inplace)

    def _warm_up(self, state):
        _, m = self.step_body(state, self.row_ints, self.row_floats)
        self._make_fold(m)
        spans.stage("end", self.device)

    def _body(self):
        """What the graph holds: one step of the static state from the row
        inputs, folded into the bucket's metrics."""
        self.state, self.out = self.step_body(self.state, self.row_ints,
                                              self.row_floats)
        self._make_fold(self.out)
        self._fold_in(self.out)
        spans.stage("end", self.device)

    def _make_fold(self, m: StepMetrics):
        # outside any capture: a zero fill made inside one would replay
        if self.fold is None:
            self.fold = {k: torch.zeros_like(getattr(m, k)) for k in FOLDED
                         if getattr(m, k) is not None}

    def _fold_in(self, m: StepMetrics):
        """The bucket's worst overflow and largest counts, in place."""
        for k, acc in self.fold.items():
            op = torch.logical_or if k == "overflow" else torch.maximum
            op(acc, getattr(m, k), out=acc)

    # -------------------------------------------------- capture and replay

    def capacity(self) -> int:
        """The whole state's capacity (under a mesh, over every shard)."""
        n = self.state.alive.shape[0]
        if self.mesh is None:
            return n
        return n // len(self.mesh.local) * self.mesh.size

    def _capture(self):
        mesh = self.mesh
        warm = [clone_state(self.state)]
        cap = capture(self.device, lambda: self._warm_up(warm.pop()),
                      self._body, self.label, mesh=mesh, owner=self)
        self.counts = cap.counts
        self.graph = cap.graph
        ms = 1e3 * (time.perf_counter() - cap.start)
        capacity = self.capacity()
        self.captures.append(dict(capacity=capacity, ms=ms,
                                  pool_peak_bytes=cap.pool_peak_bytes))
        shards = "" if mesh is None else f" in {mesh.size} shards"
        print(f"[gs_tpu_torch] captured the {self.label} at capacity "
              f"{capacity}{shards} in {ms:.1f} ms (graph pool peak "
              f"{cap.pool_peak_bytes} bytes)", flush=True)

    def release(self):
        """Destroy the captured graphs, the step's and density control's; a
        later step raises (``dispatch``)."""
        if self.graph is not None:
            self.graph.reset()
            self.graph = None
        if self.density is not None:
            self.density.release()
            self.density = None

    def dispatch(self):
        """The graph's replay on CUDA, the body itself on the CPU; on CUDA
        without a graph (its capture raised) it raises again."""
        if self.graph is not None:
            replay(self.graph, self.counts)
        elif self.graphed:
            raise RuntimeError(f"the {self.label} was not captured")
        else:
            self._body()

    # ------------------------------------------------------------ the calls

    def __call__(self, state, data: TrainingData, j: int):
        """Step ``j`` of the loaded bucket on ``state`` (copied into the
        static state unless it is that already). Returns the static state
        and the step's metrics, which the next call overwrites."""
        self.bind(state, data)
        with spans.span("train.step", unit=self.iterations[j]):
            self.row_ints.copy_(self.ints[j])
            self.row_floats.copy_(self.floats[j])
            self.dispatch()
        return self.state, self.out

    def step(self, state, data: TrainingData, cam: int, iteration: int,
             sched: torch.Tensor, bg: Optional[torch.Tensor] = None):
        """Step mode's entry, the port of the JAX trainer's jitted
        ``train_step`` (``gs_tpu/train/step.py:247``, dispatched once per
        iteration by ``gs_tpu/train/loop.py:261-280``): one step on
        ``state`` with its inputs given, not taken from a loaded bucket:
        camera ``cam`` at ``iteration``, ``sched`` its [3] row of the
        schedule table (on the host), ``bg`` the background (random
        backgrounds only; the caller draws it). They go into the row
        buffers a bucket's row is copied into, and the same graph replays.
        Returns the static state and a copy of the step's metrics; the
        bucket's fold, which the graph also updates, is not read (``run``
        zeroes it before a bucket)."""
        self.bind(state, data)
        with spans.span("train.step", unit=iteration):
            self.row_ints.copy_(torch.tensor([cam, iteration]),
                                non_blocking=True)
            self.row_floats[:3].copy_(sched, non_blocking=True)
            if bg is not None:
                self.row_floats[3:].copy_(bg)
            self.dispatch()
        return self.state, StepMetrics(*[
            x.clone() if isinstance(x, torch.Tensor) else x
            for x in self.out])

    def run(self, state, data: TrainingData, b: int):
        """The first ``b`` steps of the loaded bucket, one replay each.
        Returns the static state and the last step's metrics with the
        bucket's worst overflow and largest counts (copies)."""
        self.bind(state, data)
        if self.fold is not None:
            for x in self.fold.values():
                x.zero_()
        for j in range(b):
            self(self.state, data, j)
        m = StepMetrics(*[x.clone() if isinstance(x, torch.Tensor) else x
                          for x in self.out])
        return self.state, m._replace(**{k: x.clone()
                                         for k, x in self.fold.items()})


def make_train_step_chain(train_step, *, use_alpha: bool, use_depth: bool,
                          bucket: int = 1) -> ChainStep:
    """Single-step dispatch with the device-resident training data: the
    step gathers its image (and alpha mask, depth map, depth mask and
    depth weight) by the camera's device index, so consecutive calls move
    no frame. On CUDA the step is captured once as a CUDA graph over the
    static state and the step inputs, and each call copies its row of the
    loaded bucket into those inputs and replays. ``bucket``: the rows
    :meth:`ChainStep.load` takes. ``train_step``: a
    ``train/step.py::make_train_step`` result, on one device or under a
    mesh (its collectives captured with the step; see the module's
    docstring). :meth:`ChainStep.run` folds the bucket's metrics over its
    steps as the JAX trainer's chain does (``gs_tpu/train/loop.py:
    194-202``); :meth:`ChainStep.step` is step mode's entry to the same
    graph."""
    return ChainStep(train_step, use_alpha=use_alpha, use_depth=use_depth,
                     bucket=bucket)


class DensityGraph:
    """Density control as CUDA graphs: the port of the JAX trainer's jitted
    ``densify_and_prune`` and ``reset_opacity`` (``gs_tpu/train/loop.py:
    225-231``, packed or tree, ``use_size_threshold`` a traced
    ``jnp.bool_``), one replay per densify and one per opacity reset.

    A DensityGraph works on the one ``state`` it is made with (a
    TrainState or PackedState; under ``mesh`` its local shards): each graph
    reads it and writes its result into its own tensors, in place
    (``copy_`` after every read). The chain holds one on its static state
    (:meth:`ChainStep.density_control`), so the next step's replay takes
    the result as its own, with no copy, and the view graphs, which hold
    the same tensors, keep their captures; a chain with new static tensors
    makes a new one. The densify's static inputs are the
    split noise ``noise`` [C, 3] (C the whole capacity; the caller draws it
    there, or hands in a tensor that is copied there) and
    ``use_size_threshold`` as a 0-d bool tensor; its :class:`DensifyInfo`
    is copied out after the replay. Both graphs allocate from one pool.

    Under a mesh the densify graph holds ``gather_state``, the one-device
    pass and ``shard_state``, with their collectives; the opacity reset
    runs on the local shards, as on one device. The captures agree across
    the ranks and register with the group (``utils/cuda_graphs.py::
    capture``). On the CPU the same bodies run eagerly, in place.
    ``captures`` (a list the caller may share) records each capture's
    kind, capacity, ms, peak allocation and what it added to the memory
    the card reserves."""

    def __init__(self, state, mesh=None, captures: Optional[list] = None):
        self.state = state
        self.mesh = mesh
        self.device = state.alive.device
        self.graphed = self.device.type == "cuda"
        self.capacity = state.alive.shape[0]
        if mesh is not None:
            self.capacity = self.capacity // len(mesh.local) * mesh.size
        self.noise = torch.empty((self.capacity, 3), device=self.device)
        self.use_size_threshold = torch.zeros((), dtype=torch.bool,
                                              device=self.device)
        self.graphs: dict = {}       # "densify" / "reset" -> Capture
        self.kw: dict = {}           # the densify graph's thresholds
        self.info: Optional[DensifyInfo] = None
        self.pool = None
        self.captures = [] if captures is None else captures

    def release(self):
        """Destroy the captured graphs (and so free their pool)."""
        for cap in self.graphs.values():
            cap.graph.reset()
        self.graphs = {}
        self.pool = None

    @staticmethod
    def _write(state, new):
        """``new``'s tensors into ``state``'s own, where they differ."""
        with torch.no_grad():
            for a, b in zip(state_leaves(state), state_leaves(new)):
                if a is not b:
                    a.copy_(b)

    def _densify_body(self, state):
        spans.stage("densify", self.device)
        mesh = self.mesh
        full = state if mesh is None else gather_state(state, mesh)
        fn = (densify_and_prune_packed if isinstance(state, PackedState)
              else densify_and_prune)
        new, self.info = fn(full, self.noise,
                            use_size_threshold=self.use_size_threshold,
                            **self.kw)
        if mesh is not None:
            new = shard_state(new, mesh)
        self._write(state, new)
        spans.stage("end", self.device)

    def _reset_body(self, state):
        spans.stage("reset_opacity", self.device)
        fn = (reset_opacity_packed if isinstance(state, PackedState)
              else reset_opacity)
        self._write(state, fn(state))
        spans.stage("end", self.device)

    def _run(self, what: str):
        body = self._densify_body if what == "densify" else self._reset_body
        cap = self.graphs.get(what)
        if cap is None and self.graphed:
            cap = self._capture(what, body)
        if cap is not None:
            replay(cap.graph, cap.counts)
        else:
            body(self.state)

    def _capture(self, what: str, body):
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        warm = [clone_state(self.state)]
        cap = capture(self.device, lambda: body(warm.pop()),
                      lambda: body(self.state), f"{what} graph",
                      mesh=self.mesh, owner=self, pool=self.pool)
        self.graphs[what] = cap
        ms = 1e3 * (time.perf_counter() - cap.start)
        self.captures.append(dict(
            what=what, capacity=self.capacity, ms=ms,
            pool_peak_bytes=cap.pool_peak_bytes,
            pool_growth_bytes=cap.reserved_growth_bytes))
        shards = "" if self.mesh is None else f" in {self.mesh.size} shards"
        print(f"[gs_tpu_torch] captured the {what} graph at capacity "
              f"{self.capacity}{shards} in {ms:.1f} ms (graph pool peak "
              f"{cap.pool_peak_bytes} bytes)", flush=True)
        return cap

    def densify(self, noise: torch.Tensor, use_size_threshold, *,
                grad_threshold: float, min_opacity: float, extent: float,
                percent_dense: float) -> DensifyInfo:
        """``densify_and_prune(_packed)`` of the state with ``noise`` and
        ``use_size_threshold`` (a bool or a 0-d bool tensor), written into
        the state's tensors. Returns a copy of the :class:`DensifyInfo`.
        Other thresholds than the graph's capture it again."""
        kw = dict(grad_threshold=grad_threshold, min_opacity=min_opacity,
                  extent=extent, percent_dense=percent_dense)
        if kw != self.kw:
            if "densify" in self.graphs:
                self.graphs.pop("densify").graph.reset()
            self.kw = kw
        if noise is not self.noise:
            self.noise.copy_(noise)
        if isinstance(use_size_threshold, torch.Tensor):
            self.use_size_threshold.copy_(use_size_threshold)
        else:
            self.use_size_threshold.fill_(bool(use_size_threshold))
        self._run("densify")
        return DensifyInfo(*[x.clone() for x in self.info])

    def reset_opacity(self):
        """``reset_opacity(_packed)`` of the state, written into its
        tensors."""
        self._run("reset")
