"""train_mfu (%): the FP32 operations the traced iterations need
(``harness/work.py::iteration_ops``: the alive Gaussians' preprocess and
Adam, L1 and SSIM, the rasterizers' counted pairs and the fold) over the
traced chunk's time, as a share of the chips' FP32 peak."""


def read(t):
    if t.get("kind") != "train" or "needed_ops" not in t:
        return None
    window = sum(t["window_s"]) / len(t["window_s"])
    if not window:
        return None
    return 100.0 * t["needed_ops"] * t["units"] / (
        window * t["peak"] * t["chips"])
