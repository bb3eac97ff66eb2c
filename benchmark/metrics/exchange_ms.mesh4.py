"""exchange_ms.mesh4 (ms): the collectives of a sharded training iteration
on rank 0's stream, waits for the other ranks included (``exchange``: the
packet gather, the cost all-reduce, the band gather and the statistics
gather; ``exchange_bwd``: the reduce-scatter), by the program's stage
stamps inside the graph replays (``gs_tpu_torch/utils/spans.py``), the
mean over the traced iterations."""

STAGES = ("exchange", "exchange_bwd")


def read(t):
    if (t.get("kind") != "train" or t["chips"] < 2 or not sum(t["busy_s"])
            or not t["units"]):
        return None
    try:
        from gs_tpu_torch.utils import spans
    except ImportError:     # a program without stage stamps
        return None
    m = spans.stage_means(last=t["units"], unit="step")
    return sum(m.get(s, 0.0) for s in STAGES) if m else None
