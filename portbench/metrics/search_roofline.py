"""``search_roofline``: the least time the chip needs for the traced calls'
work (``work/<kind>.py``, one peak) over the device-busy time inside them."""


def read(rec):
    tv = rec.trace
    if tv is None or not tv.calls:
        return None
    busy = sum(tv.busy_s(s, e) for s, e in tv.calls)
    if busy <= 0:
        return None
    return 100.0 * rec.call_bound_s * len(tv.calls) / busy
