"""``index_host_ms``: the mean over the traced calls of each call's span less
the device-busy time inside it: the time the index layer keeps the device
waiting on the host (query preparation, copies, syncs, the hit lists)."""


def read(rec):
    tv = rec.trace
    if tv is None or not tv.calls or not tv.has_device:
        return None
    host = [(e - s) - tv.busy_s(s, e) for s, e in tv.calls]
    return 1e3 * sum(host) / len(host)
