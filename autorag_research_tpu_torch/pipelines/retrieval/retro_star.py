"""RETRO*: rubric-guided LLM scoring reranks a wrapped pipeline's candidates.

Capability parity with the reference ``pipelines/retrieval/retro_star.py:178``:
fetch ``candidate_top_k`` candidates from the wrapped (text chunk) pipeline,
score each (query, doc) pair with an LLM against a relevance rubric (optionally
averaging ``num_samples`` weighted samples), bounded LLM concurrency, then
rank by the rubric score.

The port's copy of the JAX package's ``pipelines/retrieval/retro_star.py``.
"""

from __future__ import annotations

import asyncio
import re
from dataclasses import dataclass
from typing import Any

from autorag_research_tpu_torch.config import BasePipelineConfig
from autorag_research_tpu_torch.pipelines.retrieval.base import BaseRetrievalPipeline

DEFAULT_RELEVANCE_DEFINITION = (
    "A document is relevant when it contains information that directly helps "
    "answer the query."
)

DEFAULT_PROMPT = (
    "{relevance_definition}\n\n"
    "Rate how relevant the {document_type} is to the {query_type}. Assign one "
    "integer relevance score from 0 to 100 and end your response with the "
    "final score inside <score> tags, for example <score>87</score>.\n\n"
    "{query_type}: {query}\n\n{document_type}: {doc}\n\nScore:"
)

_SCORE_TAG_RE = re.compile(r"<score>\s*(-?\d{1,3})\s*</score>", re.IGNORECASE | re.DOTALL)


def _parse_score(text: str) -> float:
    """Reference scoring contract (retro_star.py:55,67-82): the LAST
    <score>N</score> tag, clamped to [0, 100]; a bare trailing number is
    accepted as a fallback for untrained raters."""
    matches = list(_SCORE_TAG_RE.finditer(text))
    if matches:
        return max(0.0, min(100.0, float(matches[-1].group(1))))
    m = re.search(r"(\d+(?:\.\d+)?)\s*$", text.strip())
    if m is None:
        m = re.search(r"\d+(?:\.\d+)?", text)
    if m is None:
        return 0.0
    return max(0.0, min(100.0, float(m.group(0))))


class RetroStarPipeline(BaseRetrievalPipeline):

    def __init__(
        self,
        catalog,
        name: str = "retro_star",
        llm=None,
        retrieval_pipeline=None,
        candidate_top_k: int = 100,
        prompt_template: str = DEFAULT_PROMPT,
        relevance_definition: str = DEFAULT_RELEVANCE_DEFINITION,
        query_type: str = "query",
        document_type: str = "document",
        num_samples: int = 1,
        sample_weights: list[float] | None = None,
        max_document_chars: int = 3000,
        max_rerank_concurrency: int = 4,
    ):
        if "{query}" not in prompt_template or "{doc}" not in prompt_template:
            raise ValueError("prompt_template must contain '{query}' and '{doc}'")
        if sample_weights is not None and len(sample_weights) != num_samples:
            raise ValueError("sample_weights must match num_samples")
        self.llm = llm
        self.inner = retrieval_pipeline
        self.candidate_top_k = candidate_top_k
        self.prompt_template = prompt_template
        self.relevance_definition = relevance_definition
        self.query_type = query_type
        self.document_type = document_type
        self.num_samples = num_samples
        self.sample_weights = sample_weights or [1.0] * num_samples
        self.max_document_chars = max_document_chars
        self.max_rerank_concurrency = max_rerank_concurrency
        self.retrieval_unit = getattr(retrieval_pipeline, "retrieval_unit", "chunk")
        super().__init__(catalog, name)

    def _get_pipeline_config(self) -> dict[str, Any]:
        return {
            "type": "retro_star",
            "candidate_top_k": self.candidate_top_k,
            "num_samples": self.num_samples,
            "retrieval_unit": self.retrieval_unit,
        }

    async def _score_doc(self, query: str, doc: str, semaphore) -> float:
        prompt = self.prompt_template.format(
            relevance_definition=self.relevance_definition,
            query_type=self.query_type,
            document_type=self.document_type,
            query=query,
            doc=doc[: self.max_document_chars],
        )
        async with semaphore:
            samples = []
            for _ in range(self.num_samples):
                response = await self.llm.agenerate(prompt)
                samples.append(_parse_score(response.text))
        total_w = sum(self.sample_weights)
        return sum(s * w for s, w in zip(samples, self.sample_weights)) / (total_w or 1.0)

    async def _search(self, query_text: str, hits: list[dict], top_k: int):
        if not hits:
            return []
        ids = [h["doc_id"] for h in hits]
        lookup = self.catalog.get_chunk_contents(ids)
        semaphore = asyncio.Semaphore(self.max_rerank_concurrency)
        scores = await asyncio.gather(
            *[
                self._score_doc(query_text, lookup.get(h["doc_id"], ""), semaphore)
                for h in hits
            ]
        )
        try:
            ranked = sorted(
                zip(hits, scores),
                key=lambda t: (-t[1], -t[0]["score"], t[0]["doc_id"]),
            )
        except TypeError:  # mixed id types (pathological)
            ranked = sorted(
                zip(hits, scores),
                key=lambda t: (-t[1], -t[0]["score"], str(t[0]["doc_id"])),
            )
        return [{"doc_id": h["doc_id"], "score": s} for (h, s) in ranked[:top_k]]

    async def _retrieve_by_id(self, query_id, top_k):
        text = self.catalog.get_query_text(query_id)
        hits = await self.inner._retrieve_by_id(query_id, self.candidate_top_k)
        return await self._search(text, hits, top_k)

    async def _retrieve_by_text(self, query_text, top_k):
        hits = await self.inner._retrieve_by_text(query_text, self.candidate_top_k)
        return await self._search(query_text, hits, top_k)


@dataclass(kw_only=True)
class RetroStarConfig(BasePipelineConfig):
    config_type = "retro_star"
    kind = "retrieval"

    retrieval_pipeline_name: str
    llm: Any = None
    candidate_top_k: int = 100
    num_samples: int = 1
    sample_weights: list[float] | None = None
    max_rerank_concurrency: int = 4

    def build(self, catalog, context):
        return RetroStarPipeline(
            catalog,
            name=self.name,
            llm=context.load_llm(self.llm),
            retrieval_pipeline=context.load_pipeline(self.retrieval_pipeline_name),
            candidate_top_k=self.candidate_top_k,
            num_samples=self.num_samples,
            sample_weights=self.sample_weights,
            max_rerank_concurrency=self.max_rerank_concurrency,
        )
