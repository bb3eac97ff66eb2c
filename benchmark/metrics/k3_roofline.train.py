"""k3_roofline.train (%): the raster backward (K3, ``raster_bwd_kernel``)
over the first sampled iterations of the traced chunk: the least time its
counted work needs (``harness/work.py``) over the time its launches took,
summed over the ranks' bands."""


def read(t):
    if t.get("kind") != "train" or not t.get("k3_s"):
        return None
    return 100.0 * t["k3_bound_s"] / t["k3_s"]
