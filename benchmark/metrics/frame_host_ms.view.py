"""frame_host_ms.view (ms): the host's time a frame inside the program's
calls, less their waits for the device: the host spans
``gs_tpu_torch.view`` (``Trainer.render_view``) and
``gs_tpu_torch.frame_bytes`` less their ``view.overflow_check`` and
``frame_bytes.readback`` (``gs_tpu_torch/utils/spans.py``), the mean over
the traced frames."""

CALLS = ("gs_tpu_torch.view", "gs_tpu_torch.frame_bytes")
WAITS = ("gs_tpu_torch.view.overflow_check",
         "gs_tpu_torch.frame_bytes.readback")


def read(t):
    if t.get("kind") != "view" or not t["busy_s"][0] or not t["units"]:
        return None
    try:
        from gs_tpu_torch.utils import spans
    except ImportError:     # a program without stage stamps
        return None
    record = spans.host_spans()
    calls = {s.id: s for s in record if s.name in CALLS}
    ns: dict = {}
    for s in calls.values():
        ns[s.unit] = ns.get(s.unit, 0) + s.end_ns - s.start_ns
    for s in record:
        if s.name in WAITS and s.parent in calls:
            ns[s.unit] -= s.end_ns - s.start_ns
    frames = [ns[u] for u in sorted(ns)[-t["units"]:]]
    return 1e-6 * sum(frames) / len(frames) if frames else None
