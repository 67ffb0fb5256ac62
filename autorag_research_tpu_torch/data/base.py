"""Dataset ingestor bases.

Role parity with the reference ``data/base.py:23-126``: an ingestor binds to
an ingestion service, loads a benchmark dataset, writes queries/chunks/GT into
the catalog, and drives embedding (single-vector ``embed_all`` or
late-interaction ``embed_all_late_interaction``).

The port's copy of the JAX package's ``data/base.py``, for the offline text
ingestors (``local``, ``synthetic``); the network-bound ones, the
multimodal base and the download cache arrive with ROADMAP.md queue 1,
item 7.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Literal

from autorag_research_tpu_torch.store.ingestion import IngestionService


class DataIngestor(ABC):
    """Loads one benchmark dataset into a catalog."""

    service: IngestionService | None = None

    def set_service(self, service: IngestionService) -> None:
        self.service = service

    @abstractmethod
    def ingest(
        self,
        subset: str = "test",
        query_limit: int | None = None,
        min_corpus_cnt: int | None = None,
    ) -> None:
        ...

    def detect_primary_key_type(self) -> Literal["bigint", "string"]:
        return "string"

    def _require_service(self) -> IngestionService:
        if self.service is None:
            raise RuntimeError(f"{type(self).__name__}: call set_service() before ingest()")
        return self.service


class TextDataIngestor(DataIngestor):
    """Text corpus + text queries; single- or multi-vector embedding."""

    def __init__(self, embedding_model=None):
        self.embedding_model = embedding_model

    def embed_all(self, batch_size: int = 256):
        return self._require_service().embed_all(self.embedding_model, batch_size)

    def embed_all_late_interaction(self, batch_size: int = 64):
        return self._require_service().embed_all_late_interaction(
            self.embedding_model, batch_size
        )
