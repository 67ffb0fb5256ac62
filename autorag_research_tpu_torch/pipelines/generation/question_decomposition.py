"""Question-decomposition generation: decompose -> retrieve per sub-question ->
merged context -> single answer.

Capability parity with the reference
``pipelines/generation/question_decomposition.py:54``.

The port's copy of the JAX package's ``pipelines/generation/question_decomposition.py``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

from autorag_research_tpu_torch.config import BasePipelineConfig
from autorag_research_tpu_torch.pipelines.generation.base import BaseGenerationPipeline, GenerationResult, select_top_evidence
from autorag_research_tpu_torch.pipelines.retrieval.question_decomposition import (
    DEFAULT_DECOMPOSITION_PROMPT,
    parse_subquestions,
)
from autorag_research_tpu_torch.schema import GENERATION_CONTEXT_CHUNK_ID_KEY
from autorag_research_tpu_torch.utils.tokens import TokenUsageTracker

ANSWER_PROMPT = (
    "Answer the main question using the evidence gathered for its "
    "sub-questions.\n\nEvidence:\n{context}\n\nMain question: {query}\nAnswer:"
)


class QuestionDecompositionGenerationPipeline(BaseGenerationPipeline):
    def __init__(
        self,
        catalog,
        name: str = "question_decomposition_gen",
        retrieval_pipeline=None,
        llm=None,
        max_subquestions: int = 3,
        per_subquestion_k: int | None = None,
    ):
        self.max_subquestions = max_subquestions
        self.per_subquestion_k = per_subquestion_k
        super().__init__(catalog, name, retrieval_pipeline, llm)

    def _get_pipeline_config(self) -> dict[str, Any]:
        return {
            "type": "question_decomposition",
            "max_subquestions": self.max_subquestions,
        }

    async def _generate(self, query_id, top_k) -> GenerationResult:
        query = self.get_query_text(query_id)
        tracker = TokenUsageTracker()
        response = await self.llm.agenerate(
            DEFAULT_DECOMPOSITION_PROMPT.format(
                query=query, max_subquestions=self.max_subquestions
            )
        )
        tracker.record(response)
        subs = parse_subquestions(response.text)[: self.max_subquestions]
        # reference semantics (question_decomposition.py:223-230): each
        # question retrieves the FULL top_k and the merged pool dedups by max
        # score — the old floor division (top_k // (n+1)) made the pool
        # mathematically unable to reach top_k unique docs
        per_k = self.per_subquestion_k or top_k

        evidence: dict[Any, float] = {}
        for question in [query, *subs]:
            for hit in await self.retrieval_pipeline._retrieve_by_text(question, per_k):
                evidence[hit["doc_id"]] = max(
                    evidence.get(hit["doc_id"], -1e30), float(hit["score"])
                )
        final_ids = select_top_evidence(evidence, top_k)
        context = "\n".join(self.get_chunk_contents(final_ids))
        response = await self.llm.agenerate(ANSWER_PROMPT.format(context=context, query=query))
        tracker.record(response)
        return GenerationResult(
            text=response.text.strip(),
            token_usage=tracker.total,
            metadata={
                GENERATION_CONTEXT_CHUNK_ID_KEY: final_ids,
                "subquestions": subs,
            },
            retrieved=[{"doc_id": d, "score": evidence[d]} for d in final_ids],
        )


@dataclass(kw_only=True)
class QuestionDecompositionGenConfig(BasePipelineConfig):
    config_type = "question_decomposition_gen"
    kind = "generation"

    retrieval_pipeline_name: str
    llm: Any = None
    max_subquestions: int = 3
    per_subquestion_k: int | None = None

    def build(self, catalog, context):
        return QuestionDecompositionGenerationPipeline(
            catalog,
            name=self.name,
            retrieval_pipeline=context.load_pipeline(self.retrieval_pipeline_name),
            llm=context.load_llm(self.llm),
            max_subquestions=self.max_subquestions,
            per_subquestion_k=self.per_subquestion_k,
        )
