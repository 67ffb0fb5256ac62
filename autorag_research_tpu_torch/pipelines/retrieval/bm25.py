"""BM25 sparse retrieval pipeline.

Counterpart of ``autorag_research_tpu/pipelines/retrieval/bm25.py``: batched
scoring of every pending query of a page through one ``SparseIndex.search``
on ``device``. Tokenizer names as the JAX package accepts them (``simple`` /
``wiki_tocken``, ``english``, the local HuggingFace presets). The registry
key and the pipeline config are the JAX package's, so both packages share
one pipeline and one index artifact. ``BM25Config`` builds it on the build
context's device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from autorag_research_tpu_torch.config import BasePipelineConfig
from autorag_research_tpu_torch.index import registry
from autorag_research_tpu_torch.index.sparse import SparseIndex
from autorag_research_tpu_torch.pipelines.retrieval.base import BaseRetrievalPipeline


class BM25Pipeline(BaseRetrievalPipeline):
    retrieval_unit = "chunk"

    def __init__(
        self,
        catalog,
        name: str = "bm25",
        tokenizer: str = "simple",
        k1: float = 1.2,
        b: float = 0.75,
        table: str = "chunk",
        bucketize: int = 1,
        device: str | torch.device = "cuda",
    ):
        self.tokenizer = tokenizer
        self.k1 = k1
        self.b = b
        self.table = table
        self.bucketize = bucketize
        self.device = torch.device(device)
        super().__init__(catalog, name)

    def _get_pipeline_config(self) -> dict[str, Any]:
        return {
            "type": "bm25",
            "tokenizer": self.tokenizer,
            "k1": self.k1,
            "b": self.b,
            "bucketize": self.bucketize,
            "retrieval_unit": self.retrieval_unit,
        }

    def _index(self) -> SparseIndex:
        return registry.get_or_build(
            self.catalog,
            "sparse",
            self.table,
            builder=lambda: SparseIndex.from_catalog(
                self.catalog, self.table, tokenizer=self.tokenizer, k1=self.k1,
                b=self.b, bucketize=self.bucketize, device=self.device,
            ),
            device=self.device,
            tokenizer=self.tokenizer,
            k1=self.k1,
            b=self.b,
            bucketize=self.bucketize,
        )

    def _retrieve_batch_by_ids(
        self, query_ids, top_k, max_concurrency=16, max_retries=3, retry_delay=1.0
    ):
        idx = self._index()
        texts = []
        valid = []
        out: dict[Any, Any] = {}
        for qid in query_ids:
            text = self.catalog.get_query(qid)
            if text is None or not text["contents"]:
                out[qid] = ValueError(f"query {qid} missing contents")
                continue
            valid.append(qid)
            texts.append(text["contents"])
        if valid:
            for qid, hits in zip(valid, idx.search(texts, top_k)):
                out[qid] = [h.as_dict() for h in hits]
        return out

    async def _retrieve_by_id(self, query_id, top_k):
        res = self._retrieve_batch_by_ids([query_id], top_k)[query_id]
        if isinstance(res, BaseException):
            raise res
        return res

    async def _retrieve_by_text(self, query_text, top_k):
        return [h.as_dict() for h in self._index().search([query_text], top_k)[0]]

    def _retrieve_batch_by_texts(self, texts, top_k):
        """Serving hot path: the whole micro-batch in one search."""
        return [[h.as_dict() for h in hits] for hits in self._index().search(list(texts), top_k)]


@dataclass(kw_only=True)
class BM25Config(BasePipelineConfig):
    config_type = "bm25"
    kind = "retrieval"

    tokenizer: str = "simple"
    k1: float = 1.2
    b: float = 0.75
    table: str = "chunk"
    bucketize: int = 1

    def build(self, catalog, context):
        return BM25Pipeline(
            catalog,
            name=self.name,
            tokenizer=self.tokenizer,
            k1=self.k1,
            b=self.b,
            table=self.table,
            bucketize=self.bucketize,
            device=context.device,
        )
