"""CPU tests of the 2024 recipe's cell (``harness/train_full.py``,
``reference/full.py``, ``control_full.py``) on a tiny scene: the
``db-playroom`` configuration and the ``train_late.full`` mix cut to a few
thousand Gaussians and 64x48 photos, held to the cell's own limits
(``benchmark/limits/train.db-playroom.json``).

* The plain reference of the four switches against the program's CPU path
  with all four on: correct, over seven groups.
* Each switch left out of the program in turn, the depth term's gradient
  alone dropped, the loss over half the batch, and the reference in
  bfloat16 in the program's place (the control): not correct.
* The exposed photos, depth priors and exposures that
  ``harness/train_full.py`` makes are the same in two processes for one
  configuration seed.
"""
from __future__ import annotations

import hashlib
import json
import multiprocessing as mp
from pathlib import Path

import numpy as np
import pytest

from benchmark import control_full
from benchmark.harness.common import BENCH, Cell
from benchmark.tests import tiny

CELL = "train.db-playroom"


@pytest.fixture(autouse=True)
def one_torch_thread():
    """At these shapes torch's thread pool gives nothing, and beside other
    test processes its threads oversubscribe the cores."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def full_cell() -> Cell:
    t = json.loads((BENCH / "traffic" / "train_late.full.json").read_text())
    t.update(chunk=5, warm_iterations=2, trace_iterations=5,
             roofline_samples=2)
    # Adam's second moments as a fresh run has them: the late phase's
    # are the full-size scene's gradients
    t.pop("adam_v_rms")
    limits = json.loads((BENCH / "limits" / f"{CELL}.json").read_text())
    return Cell.of(CELL, tiny.config("db-playroom"), t, limits)


def test_config_sizes():
    c = json.loads((BENCH / "configs" / "db-playroom.json").read_text())
    assert c["reduced"] == [] and c["sh_degree"] == 3
    assert c["gaussians"] == int(676e6 / 248)
    assert c["gaussians"] / 0.85 <= c["capacity"] < 4 * c["gaussians"] / 0.85
    assert (c["width"], c["height"], c["images"]) == (1264, 832, 225)
    held = len(range(0, c["images"], c["holdout_every"]))
    assert c["images"] - held == c["train_views"] == 196
    assert c["pipeline"] == {"antialiasing": True}
    assert c["model"]["train_test_exp"] is True
    from benchmark.harness import scene
    views = scene.train_views(c)
    # every camera inside the walls and outside the furniture
    s = c["scene"]
    for v in views:
        r = float(np.hypot(*v.center[:2]))
        assert s["blob_region"] + s["blob_radius"][1] < r
        assert r < s["shell_radius"][0]


def test_full_run_matches_the_reference_on_the_cpu():
    out = _run()
    checks = out["checks"]
    assert checks.correct, checks.as_dict()
    r = out["readings"]
    assert set(r["ref_grad_norm"]) == set(r["grad_norm"]) == {
        "xyz", "sh_dc", "sh_rest", "log_scale", "quat", "logit", "exposure"}
    assert r["ref_change_norm"]["exposure"] > 0
    assert len(set(r["cameras"])) == len(r["cameras"]) == 3
    # the depth term's gradient is read at the first reliable prior, here
    # the second view's
    assert r["depth_ok"] == [False, True, True] and r["depth_step"] == 1
    assert "depth_grad_gap" in checks.values
    assert out["attempted"] > 0 and out["failed"] == 0


def _run(fault: str = ""):
    undo = control_full.plant(fault) if fault else None
    try:
        from benchmark.harness import train_full
        return train_full.run(full_cell(), tiny.SEED, 0.5, False, "cpu")
    finally:
        if undo is not None:
            undo()


@pytest.mark.parametrize("fault", sorted(control_full.FAULTS))
def test_each_fault_is_not_correct(fault):
    checks = _run(fault)["checks"]
    assert not checks.correct, (fault, checks.as_dict())
    if fault in ("depth", "depth-grad"):
        # the whole of the depth term's gradient missing
        assert abs(checks.values["depth_grad_gap"] - 1) < 0.01, \
            checks.as_dict()


def test_reference_in_bfloat16_is_not_correct():
    cell = full_cell()
    row = control_full.reference_bf16(cell, tiny.SEED, "cpu")
    assert any(row[k] > v for k, v in cell.limits.items()), row


def _data_digest(cache: str, result: str):
    """In a process of its own: the exposed photos, the priors and the
    exposures of the tiny configuration made into ``cache``, hashed."""
    import torch
    from benchmark.harness import scene as S
    from benchmark.harness import train_full as TF
    torch.set_num_threads(1)
    tiny.use_cache(Path(cache))
    cfg = tiny.config("db-playroom")
    gt = S.ground_truth(cfg, "cpu")
    shots = TF.exposed_photos(cfg, S.photos(cfg, gt, "cpu"), "cpu")
    priors, ok = TF.depth_priors(cfg, gt, S.train_views(cfg), "cpu")
    h = hashlib.sha256()
    for a in (shots, priors, ok, TF.exposures(cfg),
              TF.start_exposures(cfg, tiny.SEED, 0.01)):
        h.update(np.ascontiguousarray(a).tobytes())
    Path(result).write_text(h.hexdigest())


def test_photos_priors_and_exposures_are_the_same_in_two_processes(tmp_path):
    ctx = mp.get_context("spawn")
    digests = []
    for k in range(2):
        res = tmp_path / f"digest{k}"
        p = ctx.Process(target=_data_digest,
                        args=(str(tmp_path / f"cache{k}"), str(res)))
        p.start()
        p.join(timeout=300)
        assert p.exitcode == 0
        digests.append(res.read_text())
    assert digests[0] == digests[1]
    # another run seed moves the exposures' start, not the data
    from benchmark.harness import train_full as TF
    cfg = tiny.config("db-playroom")
    a = TF.start_exposures(cfg, 1, 0.01)
    b = TF.start_exposures(cfg, 2, 0.01)
    assert not np.array_equal(a, b)
    assert np.abs(a - TF.exposures(cfg)).max() < 0.1
