"""exposure_depth_ms.full (ms): the depth-L1 term (``depth``, from its
stamp to the backward's) and the exposures' Adam (``exposure``) a training
iteration, by the program's stage stamps inside the graph replays
(``gs_tpu_torch/utils/spans.py``), the mean over the traced iterations.
None on a program that stamps neither."""

STAGES = ("depth", "exposure")


def read(t):
    if t.get("kind") != "train" or not sum(t["busy_s"]) or not t["units"]:
        return None
    try:
        from gs_tpu_torch.utils import spans
    except ImportError:     # a program without stage stamps
        return None
    m = spans.stage_means(last=t["units"], unit="step")
    if not any(s in m for s in STAGES):
        return None
    return sum(m.get(s, 0.0) for s in STAGES)
