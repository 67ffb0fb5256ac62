"""Question decomposition retrieval: decompose -> retrieve per sub-question ->
merge by max score -> optional rerank.

Capability parity with the reference
``pipelines/retrieval/question_decomposition.py:100`` (same sub-question
parsing behaviors: numbered/bulleted lines, inline numbering, '?'-separated
run-ons; dedup against the original query; cap at max_subquestions).

The port's copy of the JAX package's
``pipelines/retrieval/question_decomposition.py``.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Any

from autorag_research_tpu_torch.config import BasePipelineConfig
from autorag_research_tpu_torch.ops.fusion import id_tiebreak_sort
from autorag_research_tpu_torch.pipelines.retrieval.base import BaseRetrievalPipeline

DEFAULT_DECOMPOSITION_PROMPT = (
    "Decompose the following question into at most {max_subquestions} simpler "
    "sub-questions that together answer it. Output one sub-question per line "
    "with no numbering.\n\nQuestion: {query}\n\nSub-questions:"
)

_PREFIX_RE = re.compile(r"^(?:\d+[.)]\s*|[-*•]\s*)")


def parse_subquestions(text: str) -> list[str]:
    lines = [ln.strip() for ln in text.strip().splitlines() if ln.strip()]
    if len(lines) == 1:
        inline = re.split(r"\s+(?=(?:\d+[.)]|[-*•])\s*)", lines[0])
        if len(inline) > 1:
            lines = [x.strip() for x in inline if x.strip()]
        elif lines[0].count("?") > 1:
            lines = [x.strip() for x in re.split(r"(?<=\?)\s+", lines[0]) if x.strip()]
    out = []
    for line in lines:
        cleaned = _PREFIX_RE.sub("", line).strip().rstrip(" ;")
        if cleaned:
            out.append(cleaned)
    return out


class QuestionDecompositionPipeline(BaseRetrievalPipeline):
    def __init__(
        self,
        catalog,
        name: str = "question_decomposition",
        llm=None,
        inner_retrieval_pipeline=None,
        reranker=None,
        decomposition_prompt_template: str = DEFAULT_DECOMPOSITION_PROMPT,
        max_subquestions: int = 3,
        fetch_k_multiplier: int = 2,
    ):
        self.llm = llm
        self.inner = inner_retrieval_pipeline
        self.reranker = reranker
        self.prompt_template = decomposition_prompt_template
        self.max_subquestions = max_subquestions
        self.fetch_k_multiplier = fetch_k_multiplier
        self.retrieval_unit = getattr(inner_retrieval_pipeline, "retrieval_unit", "chunk")
        super().__init__(catalog, name)

    def _get_pipeline_config(self) -> dict[str, Any]:
        return {
            "type": "question_decomposition",
            "max_subquestions": self.max_subquestions,
            "fetch_k_multiplier": self.fetch_k_multiplier,
            "retrieval_unit": self.retrieval_unit,
        }

    async def _decompose(self, query: str) -> list[str]:
        response = await self.llm.agenerate(
            self.prompt_template.format(query=query, max_subquestions=self.max_subquestions)
        )
        subs = parse_subquestions(response.text)
        seen = {" ".join(query.lower().split())}
        unique = []
        for s in subs:
            norm = " ".join(s.lower().split())
            if norm and norm not in seen:
                seen.add(norm)
                unique.append(s)
            if len(unique) >= self.max_subquestions:
                break
        return unique

    async def _search(self, query_text: str, top_k: int):
        fetch_k = top_k * self.fetch_k_multiplier
        questions = [query_text, *await self._decompose(query_text)]
        merged: dict[Any, float] = {}
        for q in questions:
            for hit in await self.inner._retrieve_by_text(q, fetch_k):
                did = hit["doc_id"]
                score = float(hit["score"])
                if did not in merged or score > merged[did]:
                    merged[did] = score
        hits = [
            {"doc_id": d, "score": s}
            for d, s in id_tiebreak_sort(merged.items(), lambda kv: kv[1], lambda kv: kv[0])
        ]
        if self.reranker is not None:
            ids = [h["doc_id"] for h in hits]
            lookup = self.catalog.get_chunk_contents(ids)
            pool = [(h, lookup.get(h["doc_id"])) for h in hits if lookup.get(h["doc_id"])]
            if pool:
                ranked = await self.reranker.arerank(
                    query_text, [t for _, t in pool], top_k=top_k
                )
                return [
                    {"doc_id": pool[r.index][0]["doc_id"], "score": r.score}
                    for r in ranked
                ]
        return hits[:top_k]

    async def _retrieve_by_id(self, query_id, top_k):
        text = self.catalog.get_query_text(query_id)
        if text is None:
            raise ValueError(f"query {query_id} not found")
        return await self._search(text, top_k)

    async def _retrieve_by_text(self, query_text, top_k):
        return await self._search(query_text, top_k)


@dataclass(kw_only=True)
class QuestionDecompositionConfig(BasePipelineConfig):
    config_type = "question_decomposition"
    kind = "retrieval"

    inner_retrieval_pipeline_name: str
    llm: Any = None
    reranker: Any = None
    decomposition_prompt_template: str = DEFAULT_DECOMPOSITION_PROMPT
    max_subquestions: int = 3
    fetch_k_multiplier: int = 2

    def build(self, catalog, context):
        return QuestionDecompositionPipeline(
            catalog,
            name=self.name,
            llm=context.load_llm(self.llm),
            inner_retrieval_pipeline=context.load_pipeline(self.inner_retrieval_pipeline_name),
            reranker=context.load_reranker(self.reranker),
            decomposition_prompt_template=self.decomposition_prompt_template,
            max_subquestions=self.max_subquestions,
            fetch_k_multiplier=self.fetch_k_multiplier,
        )
