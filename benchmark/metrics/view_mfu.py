"""view_mfu (%): the FP32 operations the traced frames need
(``harness/work.py::view_ops``: the alive Gaussians' preprocess and the
forward rasterizer's counted pairs) over the traced frames' time, as a
share of the chip's FP32 peak."""


def read(t):
    if t.get("kind") != "view" or "needed_ops" not in t:
        return None
    if not t["window_s"][0]:
        return None
    return 100.0 * t["needed_ops"] * t["units"] / (t["window_s"][0]
                                                  * t["peak"])
