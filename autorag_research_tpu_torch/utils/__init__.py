from autorag_research_tpu_torch.utils.normalize import (
    MISSING_SCORE_FLOORS,
    normalize_dbsf,
    normalize_minmax,
    normalize_tmm,
    normalize_zscore,
)
from autorag_research_tpu_torch.utils.concurrency import run_with_concurrency_limit

__all__ = [
    "MISSING_SCORE_FLOORS",
    "normalize_dbsf",
    "normalize_minmax",
    "normalize_tmm",
    "normalize_zscore",
    "run_with_concurrency_limit",
]
