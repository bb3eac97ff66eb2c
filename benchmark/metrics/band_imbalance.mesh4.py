"""band_imbalance.mesh4 (x): the largest band's composited entries over the
mean band's, by the program's ``band_work`` counter (every band's entries,
written once a step inside the graph replays; ``gs_tpu_torch/utils/
spans.py``), the mean over the traced iterations on rank 0. 1 is even."""


def read(t):
    if (t.get("kind") != "train" or t["chips"] < 2 or not sum(t["busy_s"])
            or not t["units"]):
        return None
    try:
        from gs_tpu_torch.utils import spans
    except ImportError:     # a program without the counter
        return None
    ratios = [max(w) * len(w) / sum(w)
              for w in spans.counter("band_work", last=t["units"],
                                     unit="step") if sum(w)]
    return sum(ratios) / len(ratios) if ratios else None
