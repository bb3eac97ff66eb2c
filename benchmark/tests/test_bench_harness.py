"""CPU tests of the benchmark (``benchmark/``): what it imports, its files
against the benchmark's contract, the result's last line, and the plain
reference against the program's CPU path on a tiny scene.

    python -m pytest benchmark/tests -q
"""
from __future__ import annotations

import ast
import io
import json
import re
import sys
from contextlib import redirect_stdout
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.harness import common  # noqa: E402
from benchmark.tests import tiny  # noqa: E402

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "gs_tpu"}


def _imports(path: Path):
    """(level, module) of every import statement in a source file."""
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield 0, a.name
        elif isinstance(node, ast.ImportFrom):
            yield node.level, node.module or ""


def _bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_nothing_imports_jax_or_the_jax_package():
    sources = list(BENCH.rglob("*.py"))
    assert len(sources) > 10
    for path in sources:
        for level, mod in _imports(path):
            if level == 0:
                # whole top-level names: gs_tpu_torch is not gs_tpu
                assert mod.split(".")[0] not in FORBIDDEN, (path, mod)


def test_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").rglob("*.py"):
        for level, mod in _imports(path):
            top = mod.split(".")[0]
            assert level == 1 or top in ("torch", "numpy", "math",
                                         "typing", "__future__"), (path, mod)


def test_forbidden_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "gs_tpu_torch_fake", object())
    assert "gs_tpu_torch_fake" not in common.forbidden_modules()
    monkeypatch.setitem(sys.modules, "gs_tpu.fake", object())
    assert common.forbidden_modules() == ["gs_tpu"]


def test_benchmark_json_names_units_and_files():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["benchmark"]
    assert 1 <= b["run_seconds"] <= 51
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    names += [w["name"] for w in b["workloads"]]
    names += [c["name"] for c in b["configs"]]
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in b["workloads"]]:
        assert NAME.match(n), n
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).is_file()
        assert c["file"].startswith("benchmark/")
        for text in (c["source"], c["why"]):
            assert 1 <= len(text) <= 200 and "\n" not in text
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    cells = {w["name"]: w for w in b["workloads"]}
    for w in cells.values():
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        assert (BENCH / "traffic" / f"{w['traffic']}.json").is_file()
        assert (BENCH / "limits" / f"{w['name']}.json").is_file()
        reported = [m for m in b["end_to_end"] if common.applies(m, w["name"])]
        assert "setup_s" in [m["name"] for m in reported]
        assert len(reported) >= 2
        assert any(common.applies(m, w["name"]) for m in b["per_layer"])
    assert sum(w["chips"] == 4 for w in cells.values()) <= max(
        1, len(cells) // 4)
    for m in b["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
        assert m["moves"] in e2e
        assert "\n" not in m["layer"] and len(m["layer"]) <= 200
        # every cell it names reports the end-to-end metric it moves
        for c in m["workloads"]:
            assert common.applies(e2e[m["moves"]], c), (m["name"], c)
    assert len(json.dumps(b)) < 64 * 1024


@pytest.mark.parametrize("name", ["m360-garden", "tandt-truck"])
def test_config_sizes(name):
    c = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    assert c["name"] == name and c["reduced"] == []
    assert c["sh_degree"] == 3
    # the capacity is the 4x tier above the count / 0.85
    assert c["gaussians"] / 0.85 <= c["capacity"] < 4 * c["gaussians"] / 0.85
    assert c["capacity"] & (c["capacity"] - 1) == 0
    held = len(range(0, c["images"], c["holdout_every"]))
    assert c["images"] - held == c["train_views"]
    from benchmark.harness import scene
    assert len(scene.train_views(c)) == c["train_views"]


@pytest.mark.parametrize("metric", sorted(
    p.stem for p in (BENCH / "metrics").glob("*.py")))
def test_reader_finds_nothing_in_an_empty_trace(metric):
    read = common.reader(metric)
    for kind in ("train", "view"):
        t = {"kind": kind, "units": 10, "chips": 1, "busy_s": [0.0],
             "window_s": [1.0], "nccl_s": [0.0]}
        assert read(t) is None


def test_driver_is_found_by_its_kind():
    from benchmark import run
    cell = tiny.train_cell()
    cell.traffic = dict(cell.traffic, kind="live")
    with pytest.raises(ValueError, match=r"\['train', 'view'\]"):
        run.drive(cell, tiny.SEED, 0.1, False, "cpu")


def test_last_line_schema(monkeypatch):
    from benchmark import run
    monkeypatch.setattr(common, "device_info", lambda torch, chips: {
        "platform": "gpu", "kind": "test", "count": chips})
    cell = tiny.train_cell()
    checks = common.Checks({"loss_gap": 1e-3})
    checks.add("loss_gap", 1e-4)
    out = {"metrics": {"train_it_s": {"value": 12.5, "unit": "it/s"}},
           "attempted": 300, "failed": 0, "memory_peak_bytes": 123,
           "window_start": 110.0, "checks": checks}
    buf = io.StringIO()
    with redirect_stdout(buf):
        run.finish(cell, out, False, 100.0, 1)
    line = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True
    assert line["metrics"]["setup_s"] == {"value": 10.0, "unit": "s"}
    assert line["device"]["memory_peak_bytes"] == 123
    assert line["checks"]["loss_gap"] == {"value": 1e-4, "limit": 1e-3}


def test_percentile_is_over_all_values():
    assert common.percentile(list(range(101)), 95) == 95
    assert common.percentile([3.0], 95) == 3.0


def test_training_run_matches_the_reference_on_the_cpu():
    out = tiny.run_train()
    checks = out["checks"]
    assert checks.correct, checks.as_dict()
    r = out["readings"]
    assert len(set(r["cameras"])) == len(r["cameras"]) == 3
    assert out["attempted"] > 0 and out["failed"] == 0


def test_view_run_matches_the_reference_on_the_cpu():
    out = tiny.run_view()
    assert out["checks"].correct, out["checks"].as_dict()
    assert out["attempted"] > 0 and out["failed"] == 0


def test_reference_render_of_an_empty_view_is_the_background():
    import torch
    from benchmark.reference import render as R
    n = 5
    params = {"xyz": torch.full((n, 3), -50.0), "sh": torch.zeros(n, 16, 3),
              "log_scale": torch.full((n, 3), -3.0),
              "quat": torch.tensor([[1.0, 0, 0, 0]] * n),
              "logit": torch.zeros(n)}
    cam = R.make_camera([0, 0, 0], [[1, 0, 0], [0, 1, 0], [0, 0, 1]],
                        1.0, 0.8, 32, 24, "cpu")
    img = R.render(params, cam, torch.tensor([0.2, 0.4, 0.6]))
    assert torch.allclose(img, torch.tensor([0.2, 0.4, 0.6])[:, None, None]
                          .expand(3, 24, 32))


def test_failed_rank_is_relayed_last_with_its_own_exit_code(tmp_path,
                                                            capsys):
    """A rank that fails: every rank's standard error on the launcher's,
    the failed rank's last, and an exit code apart from the chip runner's
    2 and 3, with no line."""
    from benchmark import run
    logs = []
    for r, text in enumerate(["rank zero's line\n", "a traceback\nBoom\n",
                              "ended\n"]):
        logs.append(tmp_path / f"rank{r}.err")
        logs[-1].write_text(text)
    rcs = [-15, 1, -15]
    run.relay(logs, rcs, first=1)
    with pytest.raises(SystemExit) as e:
        run.print_line(rcs, tmp_path / "rank0.json")
    assert e.value.code == run.RANK_FAILED not in (0, 2, 3)
    out, err = capsys.readouterr()
    assert out == ""
    lines = err.splitlines()
    assert lines[0] == "rank zero's line" and lines[1] == "[rank 2] ended"
    assert lines[-3:] == ["[rank 1] a traceback", "[rank 1] Boom",
                          "benchmark: ranks exited with [-15, 1, -15]"]
