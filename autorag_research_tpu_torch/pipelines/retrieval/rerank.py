"""Rerank wrapper: fetch a larger pool from the inner pipeline, rerank texts.

Capability parity with the reference ``pipelines/retrieval/rerank.py:86``.

The port's copy of the JAX package's ``pipelines/retrieval/rerank.py``,
with its top-up for candidates whose contents are missing.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

from autorag_research_tpu_torch.config import BasePipelineConfig
from autorag_research_tpu_torch.pipelines.retrieval.base import BaseRetrievalPipeline


class RerankPipeline(BaseRetrievalPipeline):

    def __init__(
        self,
        catalog,
        name: str = "rerank",
        inner_retrieval_pipeline=None,
        reranker=None,
        fetch_k_multiplier: int = 3,
    ):
        self.inner = inner_retrieval_pipeline
        self.reranker = reranker
        self.fetch_k_multiplier = fetch_k_multiplier
        self.retrieval_unit = getattr(
            inner_retrieval_pipeline, "retrieval_unit", "chunk"
        )
        super().__init__(catalog, name)

    def _get_pipeline_config(self) -> dict[str, Any]:
        return {
            "type": "rerank",
            "fetch_k_multiplier": self.fetch_k_multiplier,
            "reranker": getattr(self.reranker, "model_name", None),
            "retrieval_unit": self.retrieval_unit,
        }

    async def _rerank_hits(self, query_text: str, hits: list[dict], top_k: int):
        if not hits:
            return []
        ids = [h["doc_id"] for h in hits]
        lookup = self.catalog.get_chunk_contents(ids)
        pool = [(h, lookup.get(h["doc_id"])) for h in hits]
        pool = [(h, text) for h, text in pool if text]
        if not pool:
            return hits[:top_k]
        ranked = await self.reranker.arerank(
            query_text, [text for _, text in pool], top_k=top_k
        )
        out = [
            {"doc_id": pool[r.index][0]["doc_id"], "score": r.score} for r in ranked
        ]
        if len(out) < top_k:
            # top up with candidates whose contents were missing (partial
            # ingest) in their original retrieval order — dropping them could
            # silently return fewer than top_k results
            ranked_ids = {h["doc_id"] for h in out}
            floor = min((h["score"] for h in out), default=0.0)
            for i, h in enumerate(hits):
                if len(out) >= top_k:
                    break
                if h["doc_id"] not in ranked_ids and not lookup.get(h["doc_id"]):
                    out.append({"doc_id": h["doc_id"], "score": floor - 1.0 - i})
        return out

    async def _retrieve_by_id(self, query_id, top_k):
        text = self.catalog.get_query_text(query_id)
        hits = await self.inner._retrieve_by_id(query_id, top_k * self.fetch_k_multiplier)
        return await self._rerank_hits(text, hits, top_k)

    async def _retrieve_by_text(self, query_text, top_k):
        hits = await self.inner._retrieve_by_text(query_text, top_k * self.fetch_k_multiplier)
        return await self._rerank_hits(query_text, hits, top_k)


@dataclass(kw_only=True)
class RerankConfig(BasePipelineConfig):
    config_type = "rerank"
    kind = "retrieval"

    inner_retrieval_pipeline_name: str
    reranker: Any = None
    fetch_k_multiplier: int = 3

    def build(self, catalog, context):
        return RerankPipeline(
            catalog,
            name=self.name,
            inner_retrieval_pipeline=context.load_pipeline(self.inner_retrieval_pipeline_name),
            reranker=context.load_reranker(self.reranker),
            fetch_k_multiplier=self.fetch_k_multiplier,
        )
