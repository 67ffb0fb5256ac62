"""Self-RAG: prompt-based reflect / retrieve / revise loop.

Capability parity with the reference ``pipelines/generation/self_rag.py:73``
(prompt-only adaptation — no fine-tuned reflection-token model): draft an
answer without evidence, then loop — a reflection prompt returns JSON deciding
``should_retrieve``/``is_supported``; retrieve when requested and revise the
answer grounded in the context; stop when supported or the step budget ends.

The port's copy of the JAX package's ``pipelines/generation/self_rag.py``.
"""

from __future__ import annotations

import json
import re
from dataclasses import dataclass
from typing import Any

from autorag_research_tpu_torch.config import BasePipelineConfig
from autorag_research_tpu_torch.pipelines.generation.base import BaseGenerationPipeline, GenerationResult, select_top_evidence
from autorag_research_tpu_torch.schema import GENERATION_CONTEXT_CHUNK_ID_KEY
from autorag_research_tpu_torch.utils.tokens import TokenUsageTracker

INITIAL_PROMPT = (
    "You are answering a question without external evidence.\n"
    "Question: {query}\nAnswer:"
)

REFLECTION_PROMPT = (
    "You are a Self-RAG controller deciding whether an answer needs retrieval "
    "or revision.\n\nQuestion: {query}\nCurrent answer: {answer}\n"
    "Context so far:\n{context}\n\n"
    "Return JSON only: {{\"should_retrieve\": true/false, "
    "\"is_supported\": true/false, \"retrieval_query\": \"...\", \"critique\": \"...\"}}"
)

REVISION_PROMPT = (
    "Revise the answer so it is grounded in the retrieved context.\n\n"
    "Question: {query}\nCurrent answer: {answer}\nContext:\n{context}\n\n"
    "Return only the revised answer."
)


def _parse_reflection(text: str) -> dict:
    m = re.search(r"\{.*\}", text, re.DOTALL)
    if m:
        try:
            return json.loads(m.group(0))
        except json.JSONDecodeError:
            pass
    lowered = text.lower()
    return {
        "should_retrieve": "true" in lowered and "should_retrieve" in lowered,
        "is_supported": "supported" in lowered,
        "retrieval_query": "",
        "critique": text.strip()[:200],
    }


class SelfRAGPipeline(BaseGenerationPipeline):
    def __init__(
        self,
        catalog,
        name: str = "self_rag",
        retrieval_pipeline=None,
        llm=None,
        max_reflection_steps: int = 3,
    ):
        self.max_reflection_steps = max_reflection_steps
        super().__init__(catalog, name, retrieval_pipeline, llm)

    def _get_pipeline_config(self) -> dict[str, Any]:
        return {"type": "self_rag", "max_reflection_steps": self.max_reflection_steps}

    async def _generate(self, query_id, top_k) -> GenerationResult:
        query = self.get_query_text(query_id)
        tracker = TokenUsageTracker()
        response = await self.llm.agenerate(INITIAL_PROMPT.format(query=query))
        tracker.record(response)
        answer = response.text.strip()
        evidence: dict[Any, float] = {}
        critiques: list[str] = []

        for _ in range(self.max_reflection_steps):
            context = "\n".join(
                self.get_chunk_contents(list(evidence))
            ) or "(No retrieved context yet)"
            response = await self.llm.agenerate(
                REFLECTION_PROMPT.format(query=query, answer=answer, context=context)
            )
            tracker.record(response)
            reflection = _parse_reflection(response.text)
            critiques.append(str(reflection.get("critique", "")))
            if reflection.get("is_supported") and not reflection.get("should_retrieve"):
                break
            if reflection.get("should_retrieve", True):
                rq = str(reflection.get("retrieval_query") or query)
                for hit in await self.retrieval_pipeline._retrieve_by_text(rq, top_k):
                    evidence[hit["doc_id"]] = max(
                        evidence.get(hit["doc_id"], -1e30), float(hit["score"])
                    )
                context = "\n".join(self.get_chunk_contents(list(evidence)))
                response = await self.llm.agenerate(
                    REVISION_PROMPT.format(query=query, answer=answer, context=context)
                )
                tracker.record(response)
                answer = response.text.strip()

        final_ids = select_top_evidence(evidence, top_k)
        return GenerationResult(
            text=answer,
            token_usage=tracker.total,
            metadata={
                GENERATION_CONTEXT_CHUNK_ID_KEY: final_ids,
                "critiques": critiques,
            },
            retrieved=[{"doc_id": d, "score": evidence[d]} for d in final_ids],
        )


@dataclass(kw_only=True)
class SelfRAGConfig(BasePipelineConfig):
    config_type = "self_rag"
    kind = "generation"

    retrieval_pipeline_name: str
    llm: Any = None
    max_reflection_steps: int = 3

    def build(self, catalog, context):
        return SelfRAGPipeline(
            catalog,
            name=self.name,
            retrieval_pipeline=context.load_pipeline(self.retrieval_pipeline_name),
            llm=context.load_llm(self.llm),
            max_reflection_steps=self.max_reflection_steps,
        )
