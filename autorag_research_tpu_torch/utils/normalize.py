"""Score normalization for hybrid convex-combination fusion.

Behavioral parity with the reference ``util.py:371-533``:

- ``None`` entries (documents missing from a pipeline's result list) are
  preserved in place and excluded from the statistics.
- All-equal valid scores normalize to 0.5 (mm/tmm/dbsf) or 0.0 (z).
- ``z``/``dbsf`` use the *population* standard deviation.
- ``dbsf`` clips to [0, 1] against mean ± 3σ bounds.

Vectorized with numpy; a PyTorch device variant lives in ``ops/fusion.py``
for fusing whole batches on the device. A copy of the JAX package's
``utils/normalize.py``.
"""

from __future__ import annotations

import numpy as np

MISSING_SCORE_FLOORS: dict[str, float] = {
    "mm": 0.0,
    "tmm": 0.0,
    "z": -3.0,
    "dbsf": 0.0,
}
"""Post-normalization floor substituted for documents a pipeline did not return
(reference ``pipelines/retrieval/hybrid.py:33-44``)."""


def _split(scores: list[float | None]) -> tuple[np.ndarray, np.ndarray]:
    """Return (values ndarray with NaN for None, mask of valid entries)."""
    arr = np.array([np.nan if s is None else float(s) for s in scores], dtype=np.float64)
    return arr, ~np.isnan(arr)


def _emit(arr: np.ndarray, mask: np.ndarray) -> list[float | None]:
    return [float(v) if m else None for v, m in zip(arr, mask)]


def normalize_minmax(scores: list[float | None]) -> list[float | None]:
    """Min-max to [0, 1]; all-equal -> 0.5 (reference ``util.py:371-405``)."""
    if not scores:
        return []
    arr, mask = _split(scores)
    if not mask.any():
        return list(scores)
    lo, hi = arr[mask].min(), arr[mask].max()
    rng = hi - lo
    if rng == 0:
        return _emit(np.full_like(arr, 0.5), mask)
    return _emit((arr - lo) / rng, mask)


def normalize_tmm(scores: list[float | None], theoretical_min: float) -> list[float | None]:
    """Theoretical-min / actual-max scaling (reference ``util.py:408-445``)."""
    if not scores:
        return []
    arr, mask = _split(scores)
    if not mask.any():
        return list(scores)
    rng = arr[mask].max() - theoretical_min
    if rng == 0:
        return _emit(np.full_like(arr, 0.5), mask)
    return _emit((arr - theoretical_min) / rng, mask)


def _py_mean_std(valid: np.ndarray) -> tuple[float, float]:
    """Sequential-sum mean/population-std, bit-matching the reference's plain
    Python ``sum()`` (``util.py:471-474``). Numpy's pairwise summation rounds
    differently, which flips the sign of near-zero stds on all-equal inputs —
    and then ±1.0 z-scores diverge. Found by the oracle fuzz tests."""
    vals = [float(v) for v in valid]
    n = len(vals)
    mean = sum(vals) / n
    var = sum((v - mean) ** 2 for v in vals) / n
    return mean, var**0.5


def normalize_zscore(scores: list[float | None]) -> list[float | None]:
    """Population z-score; zero-std -> all zeros (reference ``util.py:448-486``)."""
    if not scores:
        return []
    arr, mask = _split(scores)
    if not mask.any():
        return list(scores)
    mean, std = _py_mean_std(arr[mask])
    if std == 0:
        return _emit(np.zeros_like(arr), mask)
    return _emit((arr - mean) / std, mask)


def normalize_dbsf(scores: list[float | None]) -> list[float | None]:
    """3-sigma distribution-based fusion normalization (reference ``util.py:489-533``)."""
    if not scores:
        return []
    arr, mask = _split(scores)
    if not mask.any():
        return list(scores)
    mean, std = _py_mean_std(arr[mask])
    if std == 0:
        return _emit(np.full_like(arr, 0.5), mask)
    # range computed as hi - lo (not 6*std): differs by an ulp, and the
    # reference (util.py:525-527) uses hi - lo
    lo, hi = mean - 3 * std, mean + 3 * std
    out = np.clip((arr - lo) / (hi - lo), 0.0, 1.0)
    return _emit(out, mask)
