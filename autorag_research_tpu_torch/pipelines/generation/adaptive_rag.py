"""AdaptiveRAG: complexity router -> zero / single / multi(IRCoT) strategy.

Capability parity with the reference ``pipelines/generation/adaptive_rag.py:125``:
an LLM classifies the query as simple/moderate/complex; each class maps to a
configurable route — zero (no retrieval), single (one retrieval pass), or
multi (IRCoT-style interleaved loop bounded by ``max_multi_steps``).

The port's copy of the JAX package's ``pipelines/generation/adaptive_rag.py``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

from autorag_research_tpu_torch.config import BasePipelineConfig
from autorag_research_tpu_torch.pipelines.generation.base import BaseGenerationPipeline, GenerationResult, select_top_evidence
from autorag_research_tpu_torch.schema import GENERATION_CONTEXT_CHUNK_ID_KEY
from autorag_research_tpu_torch.utils.tokens import TokenUsageTracker

COMPLEXITY_PROMPT = (
    "Classify the following question complexity as exactly one of: simple, "
    "moderate, complex.\n- simple: answerable from general knowledge\n"
    "- moderate: needs one retrieval pass\n"
    "- complex: needs iterative multi-step retrieval\n\n"
    "Question: {query}\nClass:"
)
ZERO_PROMPT = "Answer the question directly.\n\nQuestion: {query}\nAnswer:"
SINGLE_PROMPT = (
    "Answer the question with the provided context.\n\nContext:\n{context}\n\n"
    "Question: {query}\nAnswer:"
)
MULTI_REASONING_PROMPT = (
    "You are answering a multi-step question using chain-of-thought reasoning.\n"
    "Write the next reasoning step or a final sentence starting with "
    '"answer is:".\n\nEvidence:\n{context}\n\nQuestion: {query}\n'
    "Reasoning so far: {cot}\nNext:"
)
MULTI_ANSWER_PROMPT = (
    "Answer the question using the collected evidence.\n\nEvidence:\n{context}\n\n"
    "Question: {query}\nAnswer:"
)


class AdaptiveRAGPipeline(BaseGenerationPipeline):
    def __init__(
        self,
        catalog,
        name: str = "adaptive_rag",
        retrieval_pipeline=None,
        llm=None,
        route_for_simple: str = "zero",
        route_for_moderate: str = "single",
        route_for_complex: str = "multi",
        max_multi_steps: int = 2,
    ):
        self.routes = {
            "simple": route_for_simple,
            "moderate": route_for_moderate,
            "complex": route_for_complex,
        }
        self.max_multi_steps = max_multi_steps
        super().__init__(catalog, name, retrieval_pipeline, llm)

    def _get_pipeline_config(self) -> dict[str, Any]:
        return {
            "type": "adaptive_rag",
            "routes": self.routes,
            "max_multi_steps": self.max_multi_steps,
        }

    async def _classify(self, query: str, tracker) -> str:
        response = await self.llm.agenerate(COMPLEXITY_PROMPT.format(query=query))
        tracker.record(response)
        text = response.text.lower()
        for label in ("complex", "moderate", "simple"):
            if label in text:
                return label
        return "moderate"

    async def _generate(self, query_id, top_k) -> GenerationResult:
        query = self.get_query_text(query_id)
        tracker = TokenUsageTracker()
        label = await self._classify(query, tracker)
        route = self.routes.get(label, "single")
        evidence: dict[Any, float] = {}

        async def expand(q):
            for hit in await self.retrieval_pipeline._retrieve_by_text(q, top_k):
                evidence[hit["doc_id"]] = max(
                    evidence.get(hit["doc_id"], -1e30), float(hit["score"])
                )

        if route == "zero":
            response = await self.llm.agenerate(ZERO_PROMPT.format(query=query))
            tracker.record(response)
            answer = response.text.strip()
        elif route == "single":
            await expand(query)
            context = "\n".join(self.get_chunk_contents(list(evidence)))
            response = await self.llm.agenerate(
                SINGLE_PROMPT.format(context=context, query=query)
            )
            tracker.record(response)
            answer = response.text.strip()
        else:  # multi
            await expand(query)
            cot: list[str] = []
            answer = None
            for _ in range(self.max_multi_steps):
                context = "\n".join(self.get_chunk_contents(list(evidence)))
                response = await self.llm.agenerate(
                    MULTI_REASONING_PROMPT.format(context=context, query=query, cot=" ".join(cot))
                )
                tracker.record(response)
                step = response.text.strip()
                cot.append(step)
                import re as _re

                m = _re.search(r"answer is:\s*(.*)", step, _re.IGNORECASE | _re.DOTALL)
                if m:
                    answer = m.group(1).strip()  # case preserved
                    break
                await expand(step)
            if answer is None:
                context = "\n".join(self.get_chunk_contents(list(evidence)))
                response = await self.llm.agenerate(
                    MULTI_ANSWER_PROMPT.format(context=context, query=query)
                )
                tracker.record(response)
                answer = response.text.strip()

        final_ids = select_top_evidence(evidence, top_k)
        return GenerationResult(
            text=answer,
            token_usage=tracker.total,
            metadata={
                GENERATION_CONTEXT_CHUNK_ID_KEY: final_ids,
                "complexity": label,
                "route": route,
            },
            retrieved=[{"doc_id": d, "score": evidence[d]} for d in final_ids],
        )


@dataclass(kw_only=True)
class AdaptiveRAGConfig(BasePipelineConfig):
    config_type = "adaptive_rag"
    kind = "generation"

    retrieval_pipeline_name: str
    llm: Any = None
    route_for_simple: str = "zero"
    route_for_moderate: str = "single"
    route_for_complex: str = "multi"
    max_multi_steps: int = 2

    def build(self, catalog, context):
        return AdaptiveRAGPipeline(
            catalog,
            name=self.name,
            retrieval_pipeline=context.load_pipeline(self.retrieval_pipeline_name),
            llm=context.load_llm(self.llm),
            route_for_simple=self.route_for_simple,
            route_for_moderate=self.route_for_moderate,
            route_for_complex=self.route_for_complex,
            max_multi_steps=self.max_multi_steps,
        )
