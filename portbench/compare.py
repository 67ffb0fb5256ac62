"""The comparison that decides ``correct``: answers against the reference.

An answer is one query's list of k hits (ids and scores). Three numbers,
each the worst over the checked queries:

- ``malformed``: answers that are not k distinct row ids with finite scores;
- ``rank_gap``: the widest gap by which the reference's score of the i-th hit
  lies below the reference's i-th best score. An exact top-k gives 0, or the
  rounding of a near-tie that the two sides order differently;
- ``score_gap``: the widest gap between a hit's reported score and the
  reference's score of the same id.

The limits sit in each configuration's file under ``"check"``.
"""

from __future__ import annotations

import numpy as np

NUMBERS = ("malformed", "rank_gap", "score_gap")


def hits_arrays(answers: list, k: int) -> tuple[np.ndarray, np.ndarray]:
    """SearchHit lists -> (ids [M, k] int64, -1 where missing; scores [M, k]
    float64, nan where missing)."""
    ids = np.full((len(answers), k), -1, dtype=np.int64)
    scores = np.full((len(answers), k), np.nan)
    for r, hits in enumerate(answers):
        for c, hit in enumerate(hits[:k]):
            ids[r, c] = int(hit.doc_id)
            scores[r, c] = float(hit.score)
    return ids, scores


def judge(ids: np.ndarray, scores: np.ndarray, counts: np.ndarray, top_s: np.ndarray,
          at: np.ndarray, n: int, k_eff: int) -> dict:
    """The three numbers for answers ``ids`` / ``scores`` [M, k]; ``counts``
    [M] is how many hits each answer held, ``top_s`` the reference's best
    scores and ``at`` its scores of ``ids``."""
    ids, scores, at, top_s = ids[:, :k_eff], scores[:, :k_eff], at[:, :k_eff], top_s[:, :k_eff]
    bad = (counts != k_eff) | (ids < 0).any(axis=1) | (ids >= n).any(axis=1)
    bad |= ~np.isfinite(scores).all(axis=1) | ~np.isfinite(at).all(axis=1)
    srt = np.sort(ids, axis=1)
    bad |= (srt[:, 1:] == srt[:, :-1]).any(axis=1)
    ok = ~bad
    rank_gap = float(np.max(top_s[ok] - at[ok], initial=0.0))
    score_gap = float(np.max(np.abs(scores[ok] - at[ok]), initial=0.0))
    return {"malformed": int(bad.sum()), "rank_gap": rank_gap, "score_gap": score_gap}


def within(readings: dict, limits: dict) -> bool:
    return all(readings[name] <= limits[name] for name in NUMBERS)
