"""Length-bucket planning for ragged layouts (host side).

The port's copy of ``autorag_research_tpu/index/sparse.py::_plan_buckets``,
shared by the bucketed multi-vector layout and, with the BM25 slice, the
slot-padded sparse layout.
"""

from __future__ import annotations

import numpy as np


def _plan_buckets(counts: np.ndarray, n_buckets: int) -> list[int]:
    """Bucket max-count boundaries (ascending, the last covers the largest
    count) minimizing the total padded area ``sum(bucket_size *
    bucket_width)``, by a DP over the distinct counts. Skewed corpora (most
    rows short, a few long) waste most of a single ``[N, L_max]`` layout;
    2-3 buckets recover it."""
    counts = np.maximum(np.asarray(counts, dtype=np.int64), 1)
    distinct = np.unique(counts)
    if len(distinct) <= 1 or n_buckets <= 1:
        return [int(distinct[-1])] if len(distinct) else [1]
    n_buckets = min(n_buckets, len(distinct))
    sorted_counts = np.sort(counts)
    num_le = np.searchsorted(sorted_counts, distinct, side="right")  # rows per prefix
    m = len(distinct)
    dp = num_le.astype(np.float64) * distinct  # one bucket covering [0..j]
    choice = np.full((n_buckets, m), -1, dtype=np.int64)
    for b in range(1, n_buckets):
        new_dp = np.empty(m)
        for j in range(m):
            # split after distinct[i] (i < j): earlier buckets cover [0..i]
            cand = dp[:j] + (num_le[j] - num_le[:j]) * float(distinct[j])
            if len(cand) == 0 or dp[j] <= cand.min():
                new_dp[j] = dp[j]
                choice[b, j] = -1
            else:
                i = int(np.argmin(cand))
                new_dp[j] = cand[i]
                choice[b, j] = i
        dp = new_dp
    bounds = []
    j = m - 1
    for b in range(n_buckets - 1, 0, -1):
        bounds.append(int(distinct[j]))
        i = choice[b, j]
        if i < 0:
            break
        j = i
    else:
        bounds.append(int(distinct[j]))
    return sorted(set(bounds))
