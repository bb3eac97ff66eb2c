"""A run with its timed path broken underneath must come out as not
correct: the training step that returns its state unchanged, the step
that takes its loss over half of its batch (half of the image's rows),
the block that trains every step on its first row's camera,
the sharded step that leaves out the exchange between ranks, and the view
whose answer is altered where it is produced (a frame of the previous
pose). Each drives a whole tiny run on the CPU, the look for a chip
skipped; the sound run beside each passes.
"""
from __future__ import annotations

import json
import multiprocessing as mp
import socket

import pytest

from benchmark.tests import tiny


def test_sound_training_run_is_correct():
    assert tiny.run_train()["checks"].correct


def test_step_that_returns_its_state_unchanged(monkeypatch):
    import gs_tpu_torch.train.step as step
    monkeypatch.setattr(step, "adam_update_packed",
                        lambda ps, grad, lr, visible=None, valid=None,
                        inplace=False: ps)
    checks = tiny.run_train()["checks"]
    assert not checks.correct
    assert checks.values["change_gap"] > 0.99


def test_loss_over_half_the_batch(monkeypatch):
    import gs_tpu_torch.train.step as step
    l1, ssim = step.l1_loss, step.ssim

    def half(f):
        return lambda a, b: f(a[:, :a.shape[1] // 2], b[:, :b.shape[1] // 2])

    monkeypatch.setattr(step, "l1_loss", half(l1))
    monkeypatch.setattr(step, "ssim", half(ssim))
    checks = tiny.run_train()["checks"]
    assert not checks.correct


def test_camera_of_the_bucket_s_first_row_for_every_step(monkeypatch):
    """A block that trains every step of a bucket on its first row's
    camera: the followed steps after the first run as one block, so the
    third trains on the second's camera and the change comes out apart."""
    from gs_tpu_torch.train.loop import Trainer
    real = Trainer._bucket_inputs

    def first_row(self, cams, bucket):
        ints, floats, valid = real(self, cams, bucket)
        ints[:, 0] = ints[0, 0]
        return ints, floats, valid

    monkeypatch.setattr(Trainer, "_bucket_inputs", first_row)
    checks = tiny.run_train()["checks"]
    assert not checks.correct, checks.as_dict()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _mesh(fault: str, tmp_path) -> dict:
    ctx = mp.get_context("spawn")
    port, result = _free_port(), tmp_path / "rank0.json"
    procs = [ctx.Process(target=tiny.mesh_rank,
                         args=(r, 2, port, fault, str(result)))
             for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=300)
        assert not p.is_alive() and p.exitcode == 0
    return json.loads(result.read_text())


@pytest.mark.parametrize("fault", ["", "exchange"])
def test_sharded_step_without_its_exchange(fault, tmp_path):
    out = _mesh(fault, tmp_path)
    assert out["correct"] is (fault == ""), out["checks"]


@pytest.mark.parametrize("plant_on", [-1, 1])
def test_jax_on_a_rank_but_0_leaves_no_line(plant_on, tmp_path, capsys):
    """Every rank looks for JAX's modules once its run is done: a module
    planted in rank 1 alone makes that rank exit with 4, and the
    launcher then prints no line; with none planted it prints rank 0's."""
    from benchmark import run
    ctx = mp.get_context("spawn")
    port = _free_port()
    result = tmp_path / "result" / "rank0.json"
    result.parent.mkdir()
    procs = [ctx.Process(target=tiny.launched_rank,
                         args=(r, 2, port, plant_on, str(result)))
             for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=300)
        assert not p.is_alive()
    rcs = [p.exitcode for p in procs]
    capsys.readouterr()
    if plant_on < 0:
        assert rcs == [0, 0]
        run.print_line(rcs, result)
        line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert line["correct"] is True and list(line)[-1] == "checks"
    else:
        assert rcs == [0, 4]
        with pytest.raises(SystemExit) as e:
            run.print_line(rcs, result)
        assert e.value.code != 0
        assert capsys.readouterr().out == ""


def test_view_whose_frame_is_altered(monkeypatch):
    from gs_tpu_torch.viewer import server
    real = server.frame_bytes
    previous = []

    def stale(image):
        b = real(image)
        previous.append(b)
        return previous[-2] if len(previous) > 1 else b

    assert tiny.run_view()["checks"].correct
    monkeypatch.setattr(server, "frame_bytes", stale)
    assert not tiny.run_view()["checks"].correct


@pytest.mark.parametrize("kind", ["train", "view"])
def test_control_is_not_correct(kind):
    """The control, the program's own bfloat16 path, fails the limits
    that the sound runs pass (the card's readings at the cells' sizes:
    PERF.md)."""
    from benchmark.harness import train, view
    cell = tiny.train_cell() if kind == "train" else tiny.view_cell()
    driver = train if kind == "train" else view
    out = driver.run(cell, tiny.SEED, 0.5, False, "cpu",
                     raster_kw={"bf16_features": True})
    assert not out["checks"].correct, out["checks"].as_dict()


@pytest.mark.parametrize("mode", ["reference-bf16", "exchange"])
def test_reference_side_control_and_fault(mode):
    """The sharded cell's control (the reference in bfloat16) and its
    exchange fault, planted in the reference put in the program's place,
    read far past the limits."""
    from benchmark import control
    cell = tiny.train_cell("train_late.mesh4")
    row = control.reference_pair(cell, tiny.SEED, "cpu", mode)
    assert any(row[k] > v for k, v in tiny.TRAIN_LIMITS.items()), row
