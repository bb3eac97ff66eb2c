"""raster_ms.view (ms): the binning (depth sort, K2, tile sort) and K1 a
frame (``binning`` + ``raster``), by the program's stage stamps inside
the view's graph replay (``gs_tpu_torch/utils/spans.py``), the mean over
the traced frames."""

STAGES = ("binning", "raster")


def read(t):
    if t.get("kind") != "view" or not t["busy_s"][0] or not t["units"]:
        return None
    try:
        from gs_tpu_torch.utils import spans
    except ImportError:     # a program without stage stamps
        return None
    m = spans.stage_means(last=t["units"], unit="frame")
    return sum(m.get(s, 0.0) for s in STAGES) if m else None
