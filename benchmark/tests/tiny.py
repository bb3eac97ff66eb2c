"""Tiny cells for the CPU tests: the benchmark's own configurations and
traffic mixes cut to a few thousand Gaussians and 64x48 photos, so that a
whole run (set-up, window, checks) takes seconds on the CPU."""
from __future__ import annotations

import json
from pathlib import Path

from benchmark.harness import scene
from benchmark.harness.common import BENCH, Cell, load_benchmark

# limits for the tiny cells, from their readings on the CPU (a sound run
# reads a loss gap of ~1e-5, a gradient gap of ~7e-6, a change gap of
# ~5e-7 and ~0.2 % of bytes off), with room above
TRAIN_LIMITS = {"loss1_gap": 1e-4, "grad_gap": 1e-4, "change_gap": 1e-3}
VIEW_LIMITS = {"bytes_off": 0.01}
SEED = 123456789012


def config(name: str = "m360-garden") -> dict:
    c = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    c.update(gaussians=3000, capacity=4096, width=64, height=48, focal=50.0,
             images=9, train_views=7)
    c["scene"] = dict(c["scene"], blobs=10)
    return c


def _per_layer(cell: str) -> list:
    return [m for m in load_benchmark()["per_layer"]
            if cell in m.get("workloads", [cell])]


def train_cell(traffic: str = "train_late") -> Cell:
    t = json.loads((BENCH / "traffic" / f"{traffic}.json").read_text())
    t.update(chunk=5, warm_iterations=2, trace_iterations=5,
             roofline_samples=2)
    t.pop("adam_v_rms", None)
    return Cell.of("train.m360-garden", config(), t, dict(TRAIN_LIMITS),
                   per_layer=_per_layer("train.m360-garden"),
                   chips=int(t["ranks"]))


def view_cell() -> Cell:
    t = json.loads((BENCH / "traffic" / "view_orbit.json").read_text())
    t.update(width=96, height=64, focal=80.0, trace_frames=4, check_frames=3,
             sample_from=3,
             roofline_samples=2, buffer_poses=4, warm_frames=2)
    return Cell.of("view.m360-garden", config(), t, dict(VIEW_LIMITS),
                   per_layer=_per_layer("view.m360-garden"))


def use_cache(path: Path):
    """Keep the tiny scenes' photos out of the checkout's cache."""
    scene.CACHE = Path(path)


def run_train(seconds: float = 0.5, group=None, cell: Cell = None):
    from benchmark.harness import train
    return train.run(cell or train_cell(), SEED, seconds, False, "cpu",
                     group=group)


def run_view(seconds: float = 0.5):
    from benchmark.harness import view
    return view.run(view_cell(), SEED, seconds, False, "cpu")


def mesh_rank(rank: int, world: int, port: int, fault: str, result: str):
    """One rank of a tiny sharded training run over gloo (CPU), with the
    ``fault`` of test_bench_faults planted ("" for none); rank 0 writes
    its checks to ``result``."""
    import sys
    import torch.distributed as dist
    sys.path.insert(0, str(BENCH.parent))
    from gs_tpu_torch.parallel import mesh
    use_cache(Path(result).parent / "cache")
    if fault == "exchange":
        import torch

        def local_only(self, xs):
            (x,) = xs
            parts = [x if r == self.rank else torch.zeros_like(x)
                     for r in range(self.size)]
            return torch.cat(parts)

        mesh.ProcessGroup.gather = local_only
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    group = mesh.ProcessGroup("cpu")
    cell = train_cell("train_late.mesh4")
    cell.chips = world
    out = run_train(group=group, cell=cell)
    if rank == 0:
        Path(result).write_text(json.dumps(
            {"correct": out["checks"].correct,
             "checks": out["checks"].as_dict()}))


def launched_rank(rank: int, world: int, port: int, plant_on: int,
                  result: str):
    """One rank of a tiny sharded training run through ``run.py``'s rank
    body over gloo (CPU), with a module named ``jax`` planted in rank
    ``plant_on``'s process (-1: in none); rank 0 writes its line to
    ``result``. Exits with the rank body's code."""
    import sys
    import types
    import torch.distributed as dist
    sys.path.insert(0, str(BENCH.parent))
    from benchmark import run
    from benchmark.harness import common
    from gs_tpu_torch.parallel import mesh
    use_cache(Path(result).parent.parent / "cache")
    # the line's device on the CPU: no card to name
    common.device_info = lambda torch, chips: {
        "platform": "cpu", "kind": "cpu", "count": chips}
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    group = mesh.ProcessGroup("cpu")
    cell = train_cell("train_late.mesh4")
    cell.chips = world
    if rank == plant_on:
        sys.modules["jax"] = types.ModuleType("jax")
    args = run._args(["--workload", cell.name, "--seed", str(SEED),
                      "--seconds", "0.5", "--rank", str(rank)]
                     + (["--result-file", result] if rank == 0 else []))
    raise SystemExit(run.run_rank(args, cell, "cpu", group))
