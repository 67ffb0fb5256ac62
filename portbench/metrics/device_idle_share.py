"""``device_idle_share``: the traced window less the union of device
operations, over the window, in percent."""


def read(rec):
    tv = rec.trace
    if tv is None or tv.window is None or not tv.has_device:
        return None
    lo, hi = tv.window
    return 100.0 * (1.0 - tv.busy_s(lo, hi) / (hi - lo))
