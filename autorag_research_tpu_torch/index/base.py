"""Index layer shared contracts.

Every index (dense / multi-vector / sparse) exposes:
- ``build(...)`` from arrays or a catalog;
- ``search(queries, k) -> list[list[SearchHit]]`` with scores in the
  reference's similarity conventions (higher = better);
- ``save(dir)`` / ``load(dir)`` artifact serialization (the device analogue of
  the reference's pg_dump/HF-dump distribution of precomputed embeddings,
  ``data/hf_storage.py``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any


@dataclass
class SearchHit:
    doc_id: Any
    score: float

    def as_dict(self) -> dict:
        return {"doc_id": self.doc_id, "score": self.score}
