"""Hybrid retrieval pipelines: RRF and Convex Combination fusion.

Capability parity with the reference ``pipelines/retrieval/hybrid.py``
(classes at ``:440`` RRF and ``:537`` CC): two named sub-pipelines are
resolved through the loader, each is asked for ``top_k * fetch_k_multiplier``
candidates, and the lists are fused (math in ``ops/fusion.py`` with exact
reference semantics). The batch path drives both sub-pipelines' *batched*
retrieval so dense/BM25 legs each run one batched search per page. The
port's copy of the JAX package's ``pipelines/retrieval/hybrid.py``; the legs
run on their own devices.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

from autorag_research_tpu_torch.config import BasePipelineConfig
from autorag_research_tpu_torch.ops.fusion import cc_fuse, rrf_fuse
from autorag_research_tpu_torch.pipelines.retrieval.base import BaseRetrievalPipeline


class _HybridBase(BaseRetrievalPipeline):
    def __init__(self, catalog, name, pipeline_1, pipeline_2, fetch_k_multiplier=2):
        self.pipeline_1 = pipeline_1
        self.pipeline_2 = pipeline_2
        self.fetch_k_multiplier = fetch_k_multiplier
        # propagate the legs' unit so image-pipeline fusion persists into the
        # image result table (hardcoding "chunk" wrote image ids into the
        # chunk table); mixed legs are invalid — ids would collide
        u1 = getattr(pipeline_1, "retrieval_unit", "chunk")
        u2 = getattr(pipeline_2, "retrieval_unit", "chunk")
        if u1 != u2:
            raise ValueError(
                f"hybrid legs retrieve different units ({u1} vs {u2}); "
                "fuse pipelines of one unit"
            )
        self.retrieval_unit = u1
        super().__init__(catalog, name)

    def _fuse(self, res1, res2, top_k: int, fetch_k: int) -> list[dict[str, Any]]:
        raise NotImplementedError

    def _retrieve_batch_by_ids(
        self, query_ids, top_k, max_concurrency=16, max_retries=3, retry_delay=1.0
    ):
        fetch_k = top_k * self.fetch_k_multiplier
        batch_1 = self.pipeline_1._retrieve_batch_by_ids(
            query_ids, fetch_k, max_concurrency, max_retries, retry_delay
        )
        batch_2 = self.pipeline_2._retrieve_batch_by_ids(
            query_ids, fetch_k, max_concurrency, max_retries, retry_delay
        )
        out: dict[Any, Any] = {}
        for qid in query_ids:
            r1, r2 = batch_1.get(qid), batch_2.get(qid)
            if isinstance(r1, BaseException):
                out[qid] = r1
            elif isinstance(r2, BaseException):
                out[qid] = r2
            else:
                out[qid] = self._fuse(r1 or [], r2 or [], top_k, fetch_k)
        return out

    async def _retrieve_by_id(self, query_id, top_k):
        res = self._retrieve_batch_by_ids([query_id], top_k)[query_id]
        if isinstance(res, BaseException):
            raise res
        return res

    async def _retrieve_by_text(self, query_text, top_k):
        fetch_k = top_k * self.fetch_k_multiplier
        r1 = await self.pipeline_1._retrieve_by_text(query_text, fetch_k)
        r2 = await self.pipeline_2._retrieve_by_text(query_text, fetch_k)
        return self._fuse(r1, r2, top_k, fetch_k)

    def _retrieve_batch_by_texts(self, texts, top_k):
        """Serving hot path: both legs run their batched searches once."""
        fetch_k = top_k * self.fetch_k_multiplier
        b1 = self.pipeline_1._retrieve_batch_by_texts(texts, fetch_k)
        b2 = self.pipeline_2._retrieve_batch_by_texts(texts, fetch_k)
        return [self._fuse(r1, r2, top_k, fetch_k) for r1, r2 in zip(b1, b2)]


class HybridRRFPipeline(_HybridBase):
    def __init__(self, catalog, name, pipeline_1, pipeline_2, rrf_k=60, fetch_k_multiplier=2):
        self.rrf_k = rrf_k
        super().__init__(catalog, name, pipeline_1, pipeline_2, fetch_k_multiplier)

    def _get_pipeline_config(self):
        return {
            "type": "hybrid_rrf",
            "rrf_k": self.rrf_k,
            "fetch_k_multiplier": self.fetch_k_multiplier,
            "retrieval_unit": self.retrieval_unit,
        }

    def _fuse(self, res1, res2, top_k, fetch_k):
        return rrf_fuse(res1, res2, k=self.rrf_k, top_k=top_k, fetch_k=fetch_k)


class HybridCCPipeline(_HybridBase):
    def __init__(
        self,
        catalog,
        name,
        pipeline_1,
        pipeline_2,
        weight: float = 0.5,
        normalize_method: str = "mm",
        pipeline_1_min: float | None = None,
        pipeline_2_min: float | None = None,
        fetch_k_multiplier: int = 2,
    ):
        self.weight = weight
        self.normalize_method = normalize_method
        self.pipeline_1_min = pipeline_1_min
        self.pipeline_2_min = pipeline_2_min
        super().__init__(catalog, name, pipeline_1, pipeline_2, fetch_k_multiplier)

    def _get_pipeline_config(self):
        return {
            "type": "hybrid_cc",
            "weight": self.weight,
            "normalize_method": self.normalize_method,
            "fetch_k_multiplier": self.fetch_k_multiplier,
            "retrieval_unit": self.retrieval_unit,
        }

    def _fuse(self, res1, res2, top_k, fetch_k):
        return cc_fuse(
            res1,
            res2,
            weight=self.weight,
            top_k=top_k,
            normalize_method=self.normalize_method,
            pipeline_1_min=self.pipeline_1_min,
            pipeline_2_min=self.pipeline_2_min,
        )


def _theoretical_min(pipeline) -> float:
    """Default tmm theoretical minimum by sub-pipeline score convention:
    cosine similarity -> -1, BM25 -> 0 (reference passes these via config)."""
    config = pipeline._get_pipeline_config() if hasattr(pipeline, "_get_pipeline_config") else {}
    # every cosine-scored leg: dense/MaxSim text search, image search, and
    # HyDE (dense under the hood) — a 0.0 floor would rank a retrieved
    # negative-cosine doc BELOW a doc the leg never returned
    if config.get("type") in ("vector_search", "image_vector_search", "hyde"):
        return -1.0
    return 0.0


@dataclass(kw_only=True)
class HybridRRFConfig(BasePipelineConfig):
    config_type = "hybrid_rrf"
    kind = "retrieval"

    retrieval_pipeline_1_name: str
    retrieval_pipeline_2_name: str
    rrf_k: int = 60
    fetch_k_multiplier: int = 2

    def build(self, catalog, context):
        return HybridRRFPipeline(
            catalog,
            name=self.name,
            pipeline_1=context.load_pipeline(self.retrieval_pipeline_1_name),
            pipeline_2=context.load_pipeline(self.retrieval_pipeline_2_name),
            rrf_k=self.rrf_k,
            fetch_k_multiplier=self.fetch_k_multiplier,
        )


@dataclass(kw_only=True)
class HybridCCConfig(BasePipelineConfig):
    config_type = "hybrid_cc"
    kind = "retrieval"

    retrieval_pipeline_1_name: str
    retrieval_pipeline_2_name: str
    weight: float = 0.5
    normalize_method: str = "mm"
    pipeline_1_min: float | None = None
    pipeline_2_min: float | None = None
    fetch_k_multiplier: int = 2

    def build(self, catalog, context):
        p1 = context.load_pipeline(self.retrieval_pipeline_1_name)
        p2 = context.load_pipeline(self.retrieval_pipeline_2_name)
        p1_min = self.pipeline_1_min
        p2_min = self.pipeline_2_min
        if self.normalize_method == "tmm":
            p1_min = p1_min if p1_min is not None else _theoretical_min(p1)
            p2_min = p2_min if p2_min is not None else _theoretical_min(p2)
        return HybridCCPipeline(
            catalog,
            name=self.name,
            pipeline_1=p1,
            pipeline_2=p2,
            weight=self.weight,
            normalize_method=self.normalize_method,
            pipeline_1_min=p1_min,
            pipeline_2_min=p2_min,
            fetch_k_multiplier=self.fetch_k_multiplier,
        )
