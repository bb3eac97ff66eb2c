"""device_idle.train (%): the share of the traced training chunk in which
no operation ran on the device, by the profiler, the mean over the ranks."""


def read(t):
    if t.get("kind") != "train" or not sum(t["busy_s"]) or not all(t["window_s"]):
        return None
    shares = [1 - b / w for b, w in zip(t["busy_s"], t["window_s"])]
    return 100.0 * sum(shares) / len(shares)
