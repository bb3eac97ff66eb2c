"""adam_column_share.full (%): the columns the sparse Adam writes a
training iteration over the state's capacity, by the program's
``adam_columns`` counter (the visibility that drives Adam's mask, written
once a step inside the graph replays; ``gs_tpu_torch/utils/spans.py``),
the mean over the traced iterations: the share of Adam's pass over the
packed block that a truly sparse Adam would keep."""


def read(t):
    if (t.get("kind") != "train" or not sum(t["busy_s"]) or not t["units"]
            or not t.get("capacity")):
        return None
    try:
        from gs_tpu_torch.utils import spans
    except ImportError:     # a program without the counter
        return None
    cols = [c[0] for c in spans.counter("adam_columns", last=t["units"],
                                        unit="step") if c]
    if not cols:
        return None
    return 100.0 * sum(cols) / len(cols) / t["capacity"]
