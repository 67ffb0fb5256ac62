"""``call_p95_ms``: the 95th percentile of every call of the window, each
timed on the host from submit until its hits are on the host."""

import numpy as np


def read(rec):
    return float(np.percentile(rec.call_s, 95)) * 1e3 if rec.call_s else None
