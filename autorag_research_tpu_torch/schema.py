"""Universal metric I/O record and the generation-evidence metadata contract.

Mirrors the behavioral contract of the reference ``autorag_research/schema.py:8-120``:
``MetricInput`` is the single record type passed to every metric function, and
generation pipelines must record their final evidence chunk ids under
``context_chunk_ids`` (with the same ordered legacy fallbacks) so that
generation-time faithfulness metrics can resolve retrieved contents.
"""

from __future__ import annotations

from dataclasses import dataclass, field, fields
from typing import Any

import numpy as np

GENERATION_CONTEXT_CHUNK_ID_KEY = "context_chunk_ids"
"""Canonical result-metadata key naming the chunks fed to the final generator."""

GENERATION_CONTEXT_CHUNK_ID_KEYS = (
    GENERATION_CONTEXT_CHUNK_ID_KEY,
    "source_chunk_ids",
    "selected_subset_chunk_ids",
    "selected_chunk_ids",
    "chunk_ids",
)
"""Ordered metadata keys accepted as final generation evidence (canonical first)."""

GENERATION_LEGACY_RETRIEVED_CHUNK_ID_KEYS = ("retrieved_chunk_ids", "retrieval_chunk_ids")
"""Older metadata keys holding the broader retrieved candidate set (fallback only)."""


def _valid_str(x: str) -> bool:
    return len(x.strip()) > 0


def _valid_list(x: Any) -> bool:
    if isinstance(x, np.ndarray):
        x = x.flatten().tolist()
    if len(x) == 0:
        return False
    for item in x:
        if item is None:
            return False
        checker = _TYPE_CHECKS.get(type(item))
        if checker is None or not checker(item):
            return False
    return True


_TYPE_CHECKS: dict[type, Any] = {
    str: _valid_str,
    list: _valid_list,
    np.ndarray: _valid_list,
    int: lambda _: True,
    float: lambda _: True,
    bool: lambda _: True,
    dict: lambda _: True,
}


@dataclass
class MetricInput:
    """One query's worth of data for a metric function.

    Field set and validation semantics match the reference ``MetricInput``
    (``schema.py:30-120``): a field is *valid* when it is non-None, non-empty
    (strings stripped, lists non-empty with all elements valid).
    """

    query: str | None = None
    queries: list[str] | None = None
    retrieval_gt_contents: list[list[str]] | None = None
    retrieved_contents: list[str] | None = None
    retrieval_gt: list[list[str]] | None = None
    retrieved_ids: list[str] | None = None
    relevance_scores: dict[str, int] | None = None  # prefixed_id -> graded relevance
    prompt: str | None = None
    generated_texts: str | None = None
    generation_gt: list[str] | None = None
    generated_log_probs: list[float] | None = None

    def is_fields_notnone(self, fields_to_check: list[str]) -> bool:
        for name in fields_to_check:
            value = getattr(self, name)
            if value is None:
                return False
            try:
                checker = _TYPE_CHECKS.get(type(value))
                if checker is None or not checker(value):
                    return False
            except Exception:
                return False
        return True

    @classmethod
    def field_names(cls) -> list[str]:
        return [f.name for f in fields(cls)]


@dataclass
class RetrievedItem:
    """One retrieval hit: a document id with its relevance score.

    ``doc_id`` carries the namespace-free id; ``prefixed_id`` (``chunk_{id}`` or
    ``image_chunk_{id}``) is the form used in metric inputs, matching the
    reference's prefixing at ``orm/service/retrieval_evaluation.py:197-205``.
    """

    doc_id: Any
    score: float
    chunk_type: str = "chunk"  # "chunk" | "image_chunk"
    content: str | None = None
    metadata: dict = field(default_factory=dict)

    @property
    def prefixed_id(self) -> str:
        return f"{self.chunk_type}_{self.doc_id}"
