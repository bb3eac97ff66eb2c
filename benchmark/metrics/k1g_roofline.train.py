"""k1g_roofline.train (%): the forward rasterizer's grad variant (K1g,
``raster_fwd_kernel<true>``) over the first sampled iterations of the
traced chunk: the least time its counted work needs on the chips
(``harness/work.py``; K1's work and the per-pixel residual it writes) over
the time its launches took, summed over the ranks' bands."""


def read(t):
    if t.get("kind") != "train" or not t.get("k1g_s"):
        return None
    return 100.0 * t["k1g_bound_s"] / t["k1g_s"]
