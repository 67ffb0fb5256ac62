"""``launches_per_call``: CUDA kernels that started inside the traced calls,
over the number of calls."""


def read(rec):
    tv = rec.trace
    if tv is None or not tv.calls or not tv.has_device:
        return None
    return sum(tv.kernels_in(s, e) for s, e in tv.calls) / len(tv.calls)
