"""Dataset ingestor bases.

Role parity with the reference ``data/base.py:23-126``: an ingestor binds to
an ingestion service, loads a benchmark dataset, writes queries/chunks/GT into
the catalog, and drives embedding (single-vector ``embed_all`` or
late-interaction ``embed_all_late_interaction``).

The port's copy of the JAX package's ``data/base.py``: the text base, the
multimodal base (page images as ``image_chunk`` rows) and ``DATA_DIR``, the
download cache of the BEIR ingestor.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from pathlib import Path
from typing import Literal

from autorag_research_tpu_torch.store.ingestion import IngestionService

RANDOM_SEED = 42  # gold-preserving subsampling seed, as in the reference

DATA_DIR = Path.home() / ".cache" / "autorag_research_tpu" / "datasets"


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


class MultiModalDataIngestor(DataIngestor):
    """Page images -> image chunks; image embedding (single or multi-vector)."""

    def __init__(self, embedding_model=None):
        self.embedding_model = embedding_model

    def embed_all(self, batch_size: int = 64):
        service = self._require_service()
        out = {
            "image_chunk": service.embed_table(
                self.embedding_model, "image_chunk", batch_size, image=True
            ),
            "query": service.embed_table(self.embedding_model, "query", batch_size),
        }
        return out

    def embed_all_late_interaction(self, batch_size: int = 16):
        return self._require_service().embed_all_late_interaction(
            self.embedding_model, batch_size, image=True
        )
