"""update_ms.train (ms): the densification statistics, Adam and the
exposure update a training iteration (``update``), by the program's stage
stamps inside the graph replays (``gs_tpu_torch/utils/spans.py``), the
mean over the traced iterations on rank 0."""

STAGES = ("update",)


def read(t):
    if t.get("kind") != "train" or not sum(t["busy_s"]) or not t["units"]:
        return None
    try:
        from gs_tpu_torch.utils import spans
    except ImportError:     # a program without stage stamps
        return None
    m = spans.stage_means(last=t["units"], unit="step")
    return sum(m.get(s, 0.0) for s in STAGES) if m else None
