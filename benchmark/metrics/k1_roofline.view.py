"""k1_roofline.view (%): the forward rasterizer (K1,
``raster_fwd_kernel<false>``) over the first sampled traced frames: the
least time its counted work needs (``harness/work.py``) over the time its
launches took."""


def read(t):
    if t.get("kind") != "view" or not t.get("k1_s"):
        return None
    return 100.0 * t["k1_bound_s"] / t["k1_s"]
