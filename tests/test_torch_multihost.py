"""Two OS processes over torch.distributed (gloo, on the CPU): the
ProcessGroup's collectives and their backward, and the train CLI under
``--multihost``, as tests/test_multihost.py holds the JAX package's.

``test_gathers_across_two_processes``: each process runs ``_worker``, which
checks on its own rank that the packet gather's backward sums every rank's
gradient into the owner's rows and the band gather's backward hands a rank
its own band's slice (not a sum over ranks, which would be 2x too large);
that a state sharded and gathered comes back bitwise; and that
``render_multichip`` over the two processes gives the frame and the
gradients of ``LocalGroup(2)`` in one process (the same phases, summed in
another order: 1e-6 of the largest value).

``test_two_process_cli_matches_local_group``: two processes train a tiny
COLMAP scene through ``python -m gs_tpu_torch.apps.train --multihost``
(GS_TPU_COORD/GS_TPU_NPROCS/GS_TPU_PROCID, two densifies), rank 0 alone
writing the model dir; the saved point cloud equals that of the same CLI
run in this process with ``group=LocalGroup(2)``, within
tests/test_multihost.py's 5e-5 x max.

Each subprocess has its own time limit, well inside the suite's.
"""
import os
import socket
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.join(REPO, "tests")
LIMIT_S = 240


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_two(cmd_of_rank, env_extra, tmp_path, name):
    port = _free_port()
    procs, logs = [], []
    for rank in range(2):
        log = tmp_path / f"{name}{rank}.log"
        logs.append(log)
        env = dict(os.environ, GS_TPU_COORD=f"127.0.0.1:{port}",
                   GS_TPU_NPROCS="2", GS_TPU_PROCID=str(rank),
                   OMP_NUM_THREADS="1", PYTHONPATH=REPO + os.pathsep + TESTS,
                   **env_extra)
        with open(log, "w") as f:
            procs.append(subprocess.Popen(cmd_of_rank(rank), cwd=REPO, env=env,
                                          stdout=f, stderr=subprocess.STDOUT))
    try:
        rcs = [p.wait(timeout=LIMIT_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    outs = [log.read_text() for log in logs]
    for rank, rc in enumerate(rcs):
        assert rc == 0, f"rank {rank} failed:\n{outs[rank][-4000:]}"
    return outs


# ------------------------------------------------------------ collectives

def _worker():
    """One rank of test_gathers_across_two_processes (run as a script)."""
    import math
    torch.set_num_threads(1)
    from gs_tpu_torch.core.camera import focal2fov, make_camera
    from gs_tpu_torch.core.gaussians import GaussianParams
    from gs_tpu_torch.models.gaussian_model import create_from_pcd, init_state
    from gs_tpu_torch.parallel.mesh import (LocalGroup, gather_state,
                                            init_from_env, shard_state)
    from gs_tpu_torch.parallel.render_mc import render_multichip

    group = init_from_env("cpu")
    r, k = group.rank, group.size
    assert k == 2 and group.local == [r]

    # packet gather: forward concatenates, backward sums over ranks
    x = torch.full((3, 2), float(r + 1), requires_grad=True)
    y = group.gather([x])
    assert torch.equal(y, torch.cat([torch.full((3, 2), 1.0),
                                     torch.full((3, 2), 2.0)]))
    w = torch.arange(12.0).reshape(6, 2) * (r + 1)
    (gx,) = torch.autograd.grad((y * w).sum(), [x])
    full = torch.arange(12.0).reshape(6, 2) * 3       # ranks 1 and 2 summed
    assert torch.equal(gx, full[3 * r:3 * r + 3]), gx

    # band gather: backward is this rank's slice, not a sum
    b = torch.full((2, 2), float(r), requires_grad=True)
    stacked = group.gather_bands([b])
    assert stacked.shape == (2, 2, 2)
    (gb,) = torch.autograd.grad((stacked * torch.arange(2.0)[:, None, None]
                                 ).sum(), [b])
    assert torch.equal(gb, torch.full((2, 2), float(r)))

    # the state, sharded and gathered back, bitwise
    rng = np.random.default_rng(2)
    pts = np.concatenate([rng.uniform(-1, 1, (100, 2)),
                          rng.uniform(3, 5, (100, 1))], axis=1)
    params, alive = create_from_pcd(pts, rng.uniform(0, 1, (100, 3)), 2,
                                    capacity=256, device="cpu")
    state = init_state(params, alive, num_images=2)
    mine = shard_state(state, group)
    assert mine.capacity == 128
    assert torch.equal(mine.params.xyz, state.params.xyz[128 * r:128 * (r + 1)])
    back = gather_state(mine, group)
    for a, c in zip(torch.utils._pytree.tree_leaves(back),
                    torch.utils._pytree.tree_leaves(state)):
        assert a.dtype == c.dtype and torch.equal(a, c)

    # render_multichip over the processes = LocalGroup(2) in one process
    fovx = math.radians(60.0)
    cam = make_camera(np.eye(3), np.zeros(3), fovx,
                      focal2fov(64 / (2 * math.tan(fovx / 2)), 48), 64, 48,
                      device="cpu")
    gt = torch.tensor(np.random.default_rng(1).uniform(0, 1, (3, 48, 64)),
                      dtype=torch.float32)
    kw = dict(active_sh_degree=2, dup_capacity=1 << 13, max_per_tile=256,
              chunk=64, band_assign="cost", visible_capacity=112)

    def run(g, p, a):
        leaves = [t.detach().clone().requires_grad_(True) for t in p]
        tap = torch.zeros((p.capacity, 2), requires_grad=True)
        out = render_multichip(GaussianParams(*leaves), cam,
                               torch.tensor([0.1, 0.2, 0.3]), g, alive=a,
                               mean2d_tap=tap, **kw)
        loss = abs(out.image - gt).mean() + 0.1 * out.invdepth.mean()
        return out, torch.autograd.grad(loss, leaves + [tap])

    out2, g2 = run(group, mine.params, mine.alive)
    out1, g1 = run(LocalGroup(2, "cpu"), state.params, state.alive)
    assert not bool(out2.overflow)
    for name in ("image", "invdepth", "final_T"):
        assert torch.equal(getattr(out2, name), getattr(out1, name)), name
    assert torch.equal(out2.band_work, out1.band_work)
    for a, c in zip(g2, g1):
        c = c[128 * r:128 * (r + 1)]
        assert float((a - c).abs().max()) <= 1e-6 * float(c.abs().max()), (
            float((a - c).abs().max()), float(c.abs().max()))
    import torch.distributed as dist
    dist.destroy_process_group()
    print(f"rank {r} ok")


def test_gathers_across_two_processes(tmp_path):
    outs = _run_two(lambda rank: [sys.executable, "-c",
                                  "import test_torch_multihost as t; "
                                  "t._worker()"],
                    {}, tmp_path, "worker")
    assert [o.strip().splitlines()[-1] for o in outs] == ["rank 0 ok",
                                                          "rank 1 ok"]


# -------------------------------------------------------------- the CLI

def _train_args(root, model):
    return ["-s", root, "-m", model, "--iterations", "12",
            "--test_iterations", "12", "--save_iterations", "12",
            "--densify_from_iter", "4", "--densification_interval", "5",
            "--opacity_reset_interval", "1000", "--initial_capacity", "256",
            "--dup_capacity", "4096", "--max_per_tile", "64", "--chunk", "32",
            "--disable_viewer", "--quiet", "--seed", "7", "--eval",
            "--data_device", "cpu"]


def test_two_process_cli_matches_local_group(tmp_path):
    from test_data import make_colmap_dataset
    from gs_tpu_torch.apps import train as train_app
    from gs_tpu_torch.data.ply import load_gaussian_ply
    from gs_tpu_torch.parallel.mesh import LocalGroup

    root = str(tmp_path / "dataset")
    make_colmap_dataset(root, np.random.default_rng(11), n_images=4,
                        width=64, height=48)
    model_mh = str(tmp_path / "model_mh")
    outs = _run_two(lambda rank: [sys.executable, "-m",
                                  "gs_tpu_torch.apps.train",
                                  *_train_args(root, model_mh),
                                  "--multihost"],
                    {}, tmp_path, "train")
    assert "Sharding gaussians over 2 devices (2 process(es))" in outs[0]
    assert "Sharding gaussians" not in outs[1]
    assert "Evaluating test" in outs[0]
    assert "Saving Gaussians" not in outs[1]

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        model_lg = str(tmp_path / "model_lg")
        trainer = train_app.main(_train_args(root, model_lg),
                                 group=LocalGroup(2, "cpu"))
    finally:
        torch.set_num_threads(n)
    assert trainer.num_alive() > 50, "no densify"

    rel = os.path.join("point_cloud", "iteration_12", "point_cloud.ply")
    a = load_gaussian_ply(os.path.join(model_mh, rel))
    b = load_gaussian_ply(os.path.join(model_lg, rel))
    assert sorted(a) == sorted(b)
    for key in a:
        va, vb = np.asarray(a[key]), np.asarray(b[key])
        assert va.shape == vb.shape, key
        if va.dtype.kind == "f":
            scale = max(1.0, float(np.max(np.abs(vb))))
            assert np.max(np.abs(va - vb)) <= 5e-5 * scale, key
        else:
            assert np.array_equal(va, vb), key


# ------------------------------------------------------- --mesh N's ranks

_WAITS_FOR_RANK_1 = """
import os, torch.distributed as dist
dist.init_process_group(
    "gloo", world_size=int(os.environ["WORLD_SIZE"]),
    rank=int(os.environ["RANK"]),
    init_method=f"tcp://{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}")
if int(os.environ["RANK"]) == 1:
    os._exit(3)
dist.barrier()
"""


def test_spawn_ranks_stops_the_others_when_one_fails():
    """``--mesh N``'s launcher: rank 1 exits with 3 after the gloo
    rendezvous while rank 0 waits for it in a barrier. The launcher raises
    within seconds, naming rank 1, and stops rank 0; a run whose ranks all
    succeed returns."""
    import time
    from gs_tpu_torch.apps.train import spawn_ranks
    t0 = time.perf_counter()
    try:
        spawn_ranks(2, [sys.executable, "-c", _WAITS_FOR_RANK_1])
    except RuntimeError as e:
        assert "rank 1 exited with 3" in str(e), e
    else:
        raise AssertionError("spawn_ranks did not raise")
    assert time.perf_counter() - t0 < 60
    spawn_ranks(2, [sys.executable, "-c", "import os; assert os.environ["
                    "'WORLD_SIZE'] == '2'"])
