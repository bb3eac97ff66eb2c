"""step_device_ms.train (ms): device-busy time per training iteration in
the traced chunk (the union of the profiler's device operations), the
mean over the ranks."""


def read(t):
    if t.get("kind") != "train" or not sum(t["busy_s"]) or not t["units"]:
        return None
    return 1e3 * sum(t["busy_s"]) / len(t["busy_s"]) / t["units"]
