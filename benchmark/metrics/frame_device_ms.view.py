"""frame_device_ms.view (ms): device-busy time per frame in the traced
frames (the union of the profiler's device operations)."""


def read(t):
    if t.get("kind") != "view" or not t["busy_s"][0] or not t["units"]:
        return None
    return 1e3 * t["busy_s"][0] / t["units"]
