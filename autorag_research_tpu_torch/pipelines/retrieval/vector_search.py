"""Dense vector search pipeline (single-vector cosine).

Counterpart of ``autorag_research_tpu/pipelines/retrieval/vector_search.py``
in ``search_mode="single"`` over the exact :class:`DenseIndex` (modes
``"exact"`` and ``"verified"`` through ``index_options={"mode": ...}``);
score = cosine similarity (the reference's ``1 - distance``). The batch path
scores every pending query of a page in one search. Multi-vector search and
the IVF indexes arrive with later slices of the port.
"""

from __future__ import annotations

from typing import Any, Literal

import numpy as np
import torch

from autorag_research_tpu_torch.exceptions import EmbeddingMissingError
from autorag_research_tpu_torch.index import registry
from autorag_research_tpu_torch.index.dense import DenseIndex
from autorag_research_tpu_torch.pipelines.retrieval.base import BaseRetrievalPipeline


class VectorSearchPipeline(BaseRetrievalPipeline):
    retrieval_unit = "chunk"

    def __init__(
        self,
        catalog,
        name: str = "vector_search",
        search_mode: Literal["single"] = "single",
        embedding_model=None,
        table: str = "chunk",
        index_type: Literal["exact"] = "exact",
        index_options: dict | None = None,
        device: str | torch.device = "cuda",
    ):
        if search_mode != "single":
            raise NotImplementedError(
                "search_mode='multi' (MaxSim) is ported with the MaxSim slice"
            )
        if index_type != "exact":
            raise NotImplementedError(f"index_type={index_type!r} is ported with the IVF slice")
        self.search_mode = search_mode
        self.embedding_model = embedding_model
        self.table = table
        self.index_type = index_type
        self.index_options = index_options or {}
        self.device = torch.device(device)
        # result persistence routes by the searched table
        self.retrieval_unit = "image_chunk" if table == "image_chunk" else "chunk"
        super().__init__(catalog, name)

    def _get_pipeline_config(self) -> dict[str, Any]:
        # the JAX package's config keys, so both packages see one pipeline
        return {
            "type": "vector_search",
            "search_mode": self.search_mode,
            "retrieval_unit": self.retrieval_unit,
            "table": self.table,
            "index_type": self.index_type,
            "index_options": self.index_options,
            "maxsim_prefilter": None,
        }

    # ------------------------------------------------------------------ index
    def _index(self) -> DenseIndex:
        return registry.get_or_build(
            self.catalog,
            "dense",
            self.table,
            builder=lambda: DenseIndex.from_catalog(
                self.catalog, self.table, device=self.device, **self.index_options
            ),
            device=self.device,
            **{str(k): str(v) for k, v in sorted(self.index_options.items())},
        )

    # ----------------------------------------------------------------- search
    def search_by_embedding(self, embedding, top_k: int) -> list[dict[str, Any]]:
        """Direct dense search from a raw embedding."""
        hits = self._index().search(np.atleast_2d(embedding), top_k)[0]
        return [h.as_dict() for h in hits]

    def _retrieve_batch_by_ids(
        self, query_ids, top_k, max_concurrency=16, max_retries=3, retry_delay=1.0
    ):
        idx = self._index()
        out: dict[Any, Any] = {}
        valid_ids, embs = [], []
        for qid in query_ids:
            e = self.catalog.get_embedding("query", qid)
            if e is None:
                out[qid] = EmbeddingMissingError(f"query {qid} has no embedding")
                continue
            valid_ids.append(qid)
            embs.append(e)
        if valid_ids:
            for qid, hits in zip(valid_ids, idx.search(np.stack(embs), top_k)):
                out[qid] = [h.as_dict() for h in hits]
        return out

    def _retrieve_batch_by_texts(self, texts, top_k):
        """Serving hot path: one batched embed + one search for the whole
        micro-batch; an on-device embedder chains into the search with no
        device -> host copy in between."""
        if self.embedding_model is None:
            raise EmbeddingMissingError("no embedding model configured for text retrieval")
        idx = self._index()
        if hasattr(self.embedding_model, "embed_texts_device"):
            embs = self.embedding_model.embed_texts_device(list(texts))
        else:
            embs = np.asarray(self.embedding_model.embed_texts(list(texts)))
        return [[h.as_dict() for h in hits] for hits in idx.search(embs, top_k)]

    async def _retrieve_by_id(self, query_id, top_k):
        res = self._retrieve_batch_by_ids([query_id], top_k)[query_id]
        if isinstance(res, BaseException):
            raise res
        return res

    async def _retrieve_by_text(self, query_text, top_k):
        if self.embedding_model is None:
            raise EmbeddingMissingError("no embedding model configured for text retrieval")
        vec = await self.embedding_model.aembed_query(query_text)
        return self.search_by_embedding(vec, top_k)
