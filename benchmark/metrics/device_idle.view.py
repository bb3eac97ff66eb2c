"""device_idle.view (%): the share of the traced frames in which no
operation ran on the device, by the profiler."""


def read(t):
    if t.get("kind") != "view" or not t["busy_s"][0] or not t["window_s"][0]:
        return None
    return 100.0 * (1 - t["busy_s"][0] / t["window_s"][0])
