#!/usr/bin/env python3
"""Readings of a cell's checks for its limits, on the card: the program
as it runs, the control, which has to come out as not correct, and the
faults a cell can have.

    python3 benchmark/control.py --workload <name> --seeds <n> [<n> ...]
        --mode <mode> [--seconds 2]

Modes:

- ``sound``: the program as it runs (the lower readings);
- ``control``: the program's own bfloat16 path (``RasterConfig(
  bf16_features=True)``: colours and inverse depth streamed as bfloat16
  pairs through the tile sort), driven through the cell's run;
- ``reference-bf16``: the reference computed in bfloat16 in the program's
  place, against the reference in float32 (training cells; the control of
  a path with no bfloat16 option, such as the banded multi-GPU step; the
  reference runs whole on one card);
- ``half-batch``: the training step's loss over half of its batch (the
  top half of the image's rows), planted in the program (one-card cells)
  or, with ``--in-reference``, in the reference put in its place;
- ``exchange``: the sharded step without its exchange between ranks,
  planted in the reference put in the program's place: each rank's
  Gaussians alone render and train (training cells of several ranks);
- ``altered``: each frame the bytes of the previous pose (view cells).

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


def _half(loss):
    """A loss over the top half of the image's rows only."""
    def make(gt, lam):
        f = loss(gt[:, :gt.shape[1] // 2], lam)
        return lambda image: f(image[:, :image.shape[1] // 2])
    return make


def reference_pair(cell, seed: int, device, mode: str) -> dict:
    """The three followed steps of a training cell by the reference with
    ``mode`` planted, against the reference as it is, from the run's
    start state and cameras."""
    import torch
    from benchmark.harness import scene as S
    from benchmark.harness.train import camera_order, spatial_extent
    from benchmark.reference import train as RT
    cfg, tf = cell.config, cell.traffic
    gt = S.ground_truth(cfg, device)
    photos = S.photos(cfg, gt, device)
    views = S.train_views(cfg)
    start = S.perturbed(gt, seed, tf["perturb"])
    del gt
    params = {k: v for k, v in start.items() if k != "alive_idx"}
    picks = camera_order(seed, len(views), int(tf["follow_steps"]))
    cams = [S.ref_camera(views[c], device) for c in picks]
    shots = [torch.from_numpy(photos[c]).to(device).permute(2, 0, 1).float()
             / 255.0 for c in picks]
    bg = torch.zeros(3, device=device)
    common = (cams, shots, bg, tf["optimization"],
              int(tf["start_iteration"]) + 1, spatial_extent(views))
    v_rms = tf.get("adam_v_rms")
    ref = RT.train_steps(params, *common, v_rms=v_rms)
    planted = dict(params=params, v_rms=v_rms)
    if mode == "reference-bf16":
        planted["dtype"] = torch.bfloat16
    elif mode == "half-batch":
        planted["loss"] = _half(RT.loss_fn)
    elif mode == "exchange":
        # rank 0's shard alone: the slots [0, capacity / ranks)
        own = start["alive_idx"] < cfg["capacity"] // int(tf["ranks"])
        planted["params"] = {k: v[own] for k, v in params.items()}
    else:
        raise ValueError(mode)
    low = RT.train_steps(planted.pop("params"), *common, **planted)
    return {
        "loss1_gap": abs(low["losses"][0] - ref["losses"][0])
        / abs(ref["losses"][0]),
        "grad_gap": RT.worst_gap(low["grad_norm"], ref["grad_norm"])[0],
        "change_gap": RT.worst_gap(low["change_norm"],
                                   ref["change_norm"])[0],
        "readings": {"losses": low["losses"], "ref_losses": ref["losses"]}}


def program(cell, seed: int, device, mode: str, seconds: float) -> dict:
    """The cell's run with ``mode`` planted in the program."""
    from benchmark.harness import train, view
    driver = train if cell.traffic["kind"] == "train" else view
    kw = {"bf16_features": True} if mode == "control" else None
    undo = []
    if mode == "half-batch":
        import gs_tpu_torch.train.step as step
        for name in ("l1_loss", "ssim"):
            f = getattr(step, name)
            undo.append((step, name, f))
            setattr(step, name, lambda a, b, f=f: f(
                a[:, :a.shape[1] // 2], b[:, :b.shape[1] // 2]))
    elif mode == "altered":
        from gs_tpu_torch.viewer import server
        real, previous = server.frame_bytes, []
        undo.append((server, "frame_bytes", real))

        def stale(image):
            previous.append(real(image))
            return previous[-2] if len(previous) > 1 else previous[-1]
        server.frame_bytes = stale
    try:
        out = driver.run(cell, seed, seconds, False, device, raster_kw=kw)
    finally:
        for mod, name, f in undo:
            setattr(mod, name, f)
    row = dict(out["checks"].values)
    row["readings"] = out.get("readings")
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--mode", required=True, choices=(
        "sound", "control", "reference-bf16", "half-batch", "exchange",
        "altered"))
    ap.add_argument("--in-reference", action="store_true")
    args = ap.parse_args(argv)
    import torch
    from benchmark.harness.common import Cell
    cell = Cell(args.workload)
    if not torch.cuda.is_available():
        raise SystemExit("control readings need a CUDA device")
    device = torch.device("cuda", 0)
    for seed in args.seeds:
        in_ref = args.mode in ("reference-bf16", "exchange") or (
            args.mode == "half-batch" and args.in_reference)
        if cell.chips > 1 and not in_ref:
            raise SystemExit(f"{cell.name} runs on {cell.chips} ranks: "
                             f"read it through benchmark/run.py, or plant "
                             f"the mode in the reference")
        row = (reference_pair(cell, seed, device, args.mode) if in_ref
               else program(cell, seed, device, args.mode, args.seconds))
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "mode": args.mode, "in_reference": in_ref, **row}),
              flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
