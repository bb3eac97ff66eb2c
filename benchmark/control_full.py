#!/usr/bin/env python3
"""Readings of a ``train_full`` cell's checks for its limits, on the card:
the program as it runs, the reference in bfloat16, each of the recipe's
four switches left out of the program in turn, the depth term's gradient
alone left out, and the loss over half the batch (``control.py`` drives
the ``train`` and ``view`` kinds).

    python3 benchmark/control_full.py --workload <name> --seeds <n> [<n> ...]
        --mode <mode> [--seconds 2]

Modes:

- ``sound``: the program as it runs (the lower readings);
- ``reference-bf16``: the reference computed in bfloat16 in the
  program's place, against the reference in float32 (the control: the
  nearest precision below the configuration's float32);
- ``antialiasing``, ``depth``, ``exposure``, ``sparse_adam``: the switch
  left out of the program's step (``gs_tpu_torch/train/step.py``);
- ``depth-grad``: the depth term in the loss, its gradient dropped (the
  rendered inverse depth detached: no cotangent reaches the rasterizer's
  backward through it);
- ``half-batch``: the loss over the top half of the image's rows.

The faults are planted by :data:`FAULTS`; each must come out as not
correct.

Each seed prints one JSON line with the numbers compared. The
benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def _no_antialiasing(step):
    real = step.preprocess_packed
    return {"preprocess_packed": lambda *a, **k: real(
        *a, **dict(k, antialiasing=False))}


def _no_depth(step):
    """The depth term weighted 0 in every schedule row."""
    real = step.schedule_table

    def table(*a, **k):
        rows = real(*a, **k)
        rows[:, 2] = 0.0
        return rows
    return {"schedule_table": table}


def _detached_depth(step):
    """The depth term's value kept, its gradient dropped."""
    real = step.render_projected

    def render(*a, **k):
        out = real(*a, **k)
        return out._replace(invdepth=out.invdepth.detach())
    return {"render_projected": render}


def _no_exposure(step):
    return {"apply_exposure": lambda image, exposure: image}


def _dense_adam(step):
    real = step.adam_update_packed
    return {"adam_update_packed": lambda ps, grad, lr, visible=None, **k:
            real(ps, grad, lr, None, **k)}


def _half_batch(step):
    """L1 and SSIM over the top half of the image's rows only."""
    return {name: lambda a, b, f=getattr(step, name): f(
        a[:, :a.shape[1] // 2], b[:, :b.shape[1] // 2])
        for name in ("l1_loss", "ssim")}


# each fault: name -> (step module -> {attribute: replacement})
FAULTS = {"antialiasing": _no_antialiasing, "depth": _no_depth,
          "depth-grad": _detached_depth, "exposure": _no_exposure,
          "sparse_adam": _dense_adam, "half-batch": _half_batch}


def plant(fault: str):
    """Plant ``fault`` in ``gs_tpu_torch.train.step``; returns the undo."""
    import gs_tpu_torch.train.step as step
    new = FAULTS[fault](step)
    real = {name: getattr(step, name) for name in new}
    for name, fn in new.items():
        setattr(step, name, fn)
    return lambda: [setattr(step, name, fn) for name, fn in real.items()]


def reference_bf16(cell, seed: int, device) -> dict:
    """The followed steps by the reference in bfloat16 against the
    reference in float32, from the run's start state, exposures, cameras,
    photos and priors."""
    import torch
    from benchmark.harness import scene as S
    from benchmark.harness import train_full as TF
    from benchmark.harness.train import camera_order, spatial_extent
    from benchmark.reference import full as F
    from benchmark.reference import train as RT
    cfg, tf = cell.config, cell.traffic
    gt = S.ground_truth(cfg, device)
    views = S.train_views(cfg)
    shots = TF.exposed_photos(cfg, S.photos(cfg, gt, device), device)
    priors, ok = TF.depth_priors(cfg, gt, views, device)
    start = S.perturbed(gt, seed, tf["perturb"])
    del gt
    params = {k: v for k, v in start.items() if k != "alive_idx"}
    e0 = torch.from_numpy(TF.start_exposures(
        cfg, seed, tf["perturb"]["exposure"])).to(device)
    picks = camera_order(seed, len(views), int(tf["follow_steps"]))
    common = (
        picks, [S.ref_camera(views[c], device) for c in picks],
        [torch.from_numpy(shots[c]).to(device).permute(2, 0, 1).float()
         / 255.0 for c in picks],
        [(torch.from_numpy(priors[c]).to(device),
          torch.ones(priors.shape[1:], device=device), bool(ok[c]))
         for c in picks],
        torch.zeros(3, device=device), tf["optimization"],
        int(tf["start_iteration"]) + 1, spatial_extent(views))
    kw = dict(v_rms=tf.get("adam_v_rms"),
              antialiasing=bool(cfg["pipeline"]["antialiasing"]))
    ref = F.train_steps(params, e0, *common, **kw)
    low = F.train_steps(params, e0, *common, dtype=torch.bfloat16, **kw)
    return {
        "loss1_gap": abs(low["losses"][0] - ref["losses"][0])
        / abs(ref["losses"][0]),
        "loss_last_gap": abs(low["losses"][-1] - ref["losses"][-1])
        / abs(ref["losses"][-1]),
        "grad_gap": RT.worst_gap(low["grad_norm"], ref["grad_norm"])[0],
        "change_gap": RT.worst_gap(low["change_norm"],
                                   ref["change_norm"])[0],
        "depth_grad_gap": TF.depth_grad_gap(
            TF.split_rows(low["depth_m"]), ref)
        if ref["depth_step"] is not None else 0.0,
        "readings": {"losses": low["losses"], "ref_losses": ref["losses"],
                     "depth_step": ref["depth_step"]}}


def program(cell, seed: int, device, mode: str, seconds: float) -> dict:
    """The cell's run with ``mode`` planted in the program."""
    from benchmark.harness import train_full
    undo = plant(mode) if mode in FAULTS else None
    try:
        out = train_full.run(cell, seed, seconds, False, device)
    finally:
        if undo is not None:
            undo()
    row = dict(out["checks"].values)
    row["readings"] = out.get("readings")
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--mode", required=True,
                    choices=("sound", "reference-bf16") + tuple(FAULTS))
    args = ap.parse_args(argv)
    import torch
    from benchmark.harness.common import Cell
    cell = Cell(args.workload)
    if cell.traffic["kind"] != "train_full":
        raise SystemExit(f"{cell.name} is not a train_full cell: "
                         f"benchmark/control.py reads it")
    if not torch.cuda.is_available():
        raise SystemExit("control readings need a CUDA device")
    device = torch.device("cuda", 0)
    for seed in args.seeds:
        row = (reference_bf16(cell, seed, device)
               if args.mode == "reference-bf16"
               else program(cell, seed, device, args.mode, args.seconds))
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "mode": args.mode, **row}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
