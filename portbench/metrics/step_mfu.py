"""``step_mfu``: the operations the calls need (``work/<kind>.py``) over the
wall time of the stretch without the profiler, against the one peak."""

from portbench.work import PEAK_FLOPS


def read(rec):
    if not rec.call_s or rec.window_s <= 0 or rec.trace is None or not rec.trace.has_device:
        return None
    return 100.0 * rec.work[0] * len(rec.call_s) / rec.window_s / PEAK_FLOPS
