#!/usr/bin/env python3
"""Run one cell of the benchmark once.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. ``--trace 0`` measures the cell's end-to-end
metrics over a window of ``--seconds``; ``--trace 1`` profiles the cell and
reports its per-layer metrics. Either way the run then checks what the
timed path produced against the plain reference (``benchmark/reference``)
and prints one JSON object as the last line of standard output:
``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
``--trace 1`` ``breakdown``, and last ``checks``, each number compared
beside its limit (also the last lines of standard error).

A cell whose traffic asks for several ranks starts them itself, one
process per card over NCCL, relays each rank's standard error (a failed
rank's last) and prints rank 0's result. Exits non-zero, with no result:
4 when JAX or the JAX package was loaded in any of its processes, 5
without enough CUDA cards, 6 when a rank failed (its code and its last
lines of standard error on ours), 1 on an error of this process.
"""
from __future__ import annotations

import argparse
import importlib
import json
import os
import shutil
import socket
import subprocess
import sys
import time
from pathlib import Path

T_START = time.time()
BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# every build and kernel cache inside the checkout, at a fixed path
os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                      str(ROOT / ".bench_cache" / "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR",
                      str(ROOT / ".bench_cache" / "triton"))
os.environ.setdefault("USE_FLAX", "0")
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def _args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # a rank of a cell that runs several: set by this script for its ranks
    ap.add_argument("--rank", type=int, default=-1, help=argparse.SUPPRESS)
    ap.add_argument("--result-file", default="", help=argparse.SUPPRESS)
    ap.add_argument("--t-start", type=float, default=0.0,
                    help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# exit codes, apart from 2 and 3, which chip runners use for their own faults
JAX_LOADED, NO_CARDS, RANK_FAILED = 4, 5, 6


def _fail(msg: str, code: int):
    print(f"benchmark: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(code)


def drive(cell, seed, seconds, traced, device, group=None):
    """The cell's driver: ``run`` of ``benchmark/harness/<kind>.py``, by
    its traffic's ``kind``."""
    kind = cell.traffic["kind"]
    name = f"benchmark.harness.{kind}"
    driver = None
    if kind.isidentifier():
        try:
            driver = importlib.import_module(name)
        except ModuleNotFoundError as e:
            if e.name != name:
                raise
    if not hasattr(driver, "run"):
        kinds = sorted(p.stem for p in (BENCH / "harness").glob("*.py")
                       if "\ndef run(" in p.read_text())
        raise ValueError(f"traffic kind {kind!r}: no run() in "
                         f"benchmark/harness/{kind}.py; one of {kinds}")
    return driver.run(cell, seed, seconds, traced, device, group=group)


def check_modules():
    """Exit with 4, and no result, where JAX or the JAX package was
    loaded in this process."""
    from benchmark.harness.common import forbidden_modules
    bad = forbidden_modules()
    if bad:
        _fail(f"modules of JAX or the JAX package were loaded: {bad}",
              JAX_LOADED)


def finish(cell, out: dict, traced: bool, t_start: float, chips: int):
    """The result's line from a driver's output."""
    import torch
    from benchmark.harness.common import device_info, emit
    checks = out.pop("checks")
    metrics = dict(out["metrics"])
    if not traced:
        metrics["setup_s"] = {"value": out["window_start"] - t_start,
                              "unit": "s"}
    device = device_info(torch, chips)
    device["memory_peak_bytes"] = int(out["memory_peak_bytes"])
    if traced:
        device["busy_s"] = out["busy_s"]
        device["window_s"] = out["traced_window_s"]
    result = {"correct": checks.correct, "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics, "device": device}
    if traced and out.get("breakdown"):
        result["breakdown"] = out["breakdown"]
    info = {k: out[k] for k in ("captures", "readings", "window_s",
                                "chunk_s", "latency_ms_median") if k in out}
    print(f"benchmark: {cell.name} {json.dumps(info)}", file=sys.stderr)
    emit(result, checks.as_dict())


def _launch(args, cell):
    """Start the cell's ranks (rank r on card r), wait for every one, relay
    their standard error and print rank 0's result."""
    import signal
    import tempfile
    # ended from outside (a time limit): end the ranks too, in ``finally``
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(143))
    port = _free_port()
    tmp = Path(tempfile.mkdtemp())
    res = tmp / "rank0.json"
    procs, logs = [], []
    try:
        for r in range(cell.chips):
            env = dict(os.environ, GS_TPU_COORD=f"127.0.0.1:{port}",
                       GS_TPU_NPROCS=str(cell.chips), GS_TPU_PROCID=str(r),
                       LOCAL_RANK=str(r), OMP_NUM_THREADS="4")
            cmd = [sys.executable, str(Path(__file__).resolve()),
                   "--workload", args.workload, "--seed", str(args.seed),
                   "--seconds", str(args.seconds), "--trace",
                   str(args.trace), "--rank", str(r), "--t-start",
                   repr(T_START)]
            if r == 0:
                cmd += ["--result-file", str(res)]
            logs.append(tmp / f"rank{r}.err")
            with open(logs[-1], "w") as err:
                procs.append(subprocess.Popen(cmd, cwd=str(ROOT), env=env,
                                              stderr=err))
        first = _wait(procs)
        rcs = [p.returncode for p in procs]
        relay(logs, rcs, first)
        print_line(rcs, res)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(tmp, ignore_errors=True)


def _wait(procs) -> int:
    """Wait for every rank. A rank that fails leaves the others waiting in a
    collective: end them. Returns the rank that failed first, or -1."""
    while any(p.poll() is None for p in procs):
        failed = [r for r, p in enumerate(procs) if p.poll()]
        if failed:
            for p in procs:
                if p.poll() is None:
                    p.terminate()
            for p in procs:
                try:
                    p.wait(timeout=30)
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait()
            return failed[0]
        time.sleep(0.5)
    failed = [r for r, p in enumerate(procs) if p.returncode]
    return failed[0] if failed else -1


def relay(logs, rcs, first: int, tail: int = 40):
    """Each rank's standard error on ours, the others' lines marked with
    their rank; where a rank failed, the one that failed first comes last,
    its last ``tail`` lines again after its exit code."""
    order = [r for r in range(len(logs)) if r != first]
    order += [first] if first >= 0 else []
    for r in order:
        text = Path(logs[r]).read_text(errors="replace")
        mark = "" if r == 0 else f"[rank {r}] "
        for line in text.splitlines():
            print(mark + line, file=sys.stderr)
        if r == first:
            print(f"benchmark: rank {r} exited with {rcs[r]} first; its "
                  "last lines:", file=sys.stderr)
            for line in text.splitlines()[-tail:]:
                print(f"[rank {r}] {line}", file=sys.stderr)
    sys.stderr.flush()


def print_line(rcs, res: Path):
    """Rank 0's line, printed where every rank exited with 0 (each checks
    its own modules) and this process loaded none of JAX either."""
    if any(rcs):
        _fail(f"ranks exited with {rcs}", RANK_FAILED)
    line = json.loads(res.read_text())
    from benchmark.harness.common import emit
    check_modules()
    # the checks again, after whatever the ranks printed last
    checks = line.pop("checks")
    emit(line, checks)


def run_rank(args, cell, device, group=None) -> int:
    """One process's run: the driver, then, on every rank, the look for
    JAX's modules; rank 0 prints the line, or writes it to
    ``--result-file`` for the launcher."""
    out = drive(cell, args.seed, args.seconds, bool(args.trace), device,
                group)
    check_modules()
    if args.rank > 0:
        return 0
    t_start = args.t_start or T_START
    if args.result_file:
        import io
        buf = io.StringIO()
        stdout, sys.stdout = sys.stdout, buf
        try:
            finish(cell, out, bool(args.trace), t_start, cell.chips)
        finally:
            sys.stdout = stdout
        Path(args.result_file).write_text(buf.getvalue().strip()
                                          .splitlines()[-1])
        return 0
    finish(cell, out, bool(args.trace), t_start, cell.chips)
    return 0


def main(argv=None) -> int:
    args = _args(argv)
    from benchmark.harness.common import Cell
    cell = Cell(args.workload)
    import torch
    if not torch.cuda.is_available():
        _fail("no CUDA device", NO_CARDS)
    if torch.cuda.device_count() < cell.chips:
        _fail(f"{cell.name} needs {cell.chips} cards; "
              f"{torch.cuda.device_count()} are visible", NO_CARDS)
    ranks = int(cell.traffic.get("ranks", 1))
    if ranks != cell.chips:
        _fail(f"{cell.name}: its traffic runs {ranks} ranks on "
              f"{cell.chips} chips", 1)
    if ranks > 1 and args.rank < 0:
        _launch(args, cell)
        return 0
    group = None
    if ranks > 1:
        from gs_tpu_torch.parallel.mesh import init_from_env
        group = init_from_env("cuda")
    device = torch.device("cuda", torch.cuda.current_device())
    from benchmark.harness.common import power_limit
    if args.rank <= 0:
        print(f"benchmark: {power_limit()}", file=sys.stderr, flush=True)
    return run_rank(args, cell, device, group)


if __name__ == "__main__":
    sys.exit(main())
