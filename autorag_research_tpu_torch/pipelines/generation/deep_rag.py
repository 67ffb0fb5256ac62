"""DeepRAG: subquery-level decisions — terminate, or (subquery, retrieve vs
parametric).

Capability parity with the reference ``pipelines/generation/deep_rag.py:142``:
at each step the LLM either terminates with a final answer or emits the next
subquery plus a choice of answering it from retrieval or from parametric
knowledge; the (subquery, evidence/answer) trace accumulates until
termination or the step budget.

The port's copy of the JAX package's ``pipelines/generation/deep_rag.py``.
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

DECISION_PROMPT = (
    "You are a DeepRAG controller. Given the trace so far, return exactly one "
    "action:\n"
    "- <retrieve>standalone subquery</retrieve> when external evidence is needed\n"
    "- <parametric>standalone subquery</parametric> when model knowledge suffices\n"
    "- <answer>final answer</answer> when the trace is sufficient\n\n"
    "Question: {query}\n\nTrace:\n{trace}\n\nNext action:"
)

SUBANSWER_PROMPT = (
    "Answer the sub-question{context_clause}.\n{context}\n"
    "Sub-question: {subquery}\nShort answer:"
)

FINAL_PROMPT = (
    "Answer the main question from the completed trace.\n\nQuestion: {query}\n\n"
    "Trace:\n{trace}\n\nAnswer:"
)


_TAG_RE = re.compile(
    r"<(retrieve|parametric|answer)>\s*(.*?)\s*</\1>", re.IGNORECASE | re.DOTALL
)


def _parse_decision(text: str) -> dict:
    """Accepts the trained-controller tag protocol (reference
    ``parse_deeprag_action`` deep_rag.py:88 — ``<retrieve>``/``<parametric>``/
    ``<answer>``) or this framework's JSON form; unparseable -> terminate."""
    m = _TAG_RE.search(text)
    if m:
        kind, payload = m.group(1).lower(), m.group(2).strip()
        if kind == "answer":
            return {"action": "terminate", "final_answer": payload}
        return {
            "action": "subquery",
            "subquery": payload,
            "use_retrieval": kind == "retrieve",
        }
    m = re.search(r"\{.*\}", text, re.DOTALL)
    if m:
        try:
            return json.loads(m.group(0))
        except json.JSONDecodeError:
            pass
    return {"action": "terminate", "final_answer": text.strip()}


class DeepRAGPipeline(BaseGenerationPipeline):
    def __init__(
        self,
        catalog,
        name: str = "deep_rag",
        retrieval_pipeline=None,
        llm=None,
        max_steps: int = 5,
        per_subquery_k: int = 3,
    ):
        self.max_steps = max_steps
        self.per_subquery_k = per_subquery_k
        super().__init__(catalog, name, retrieval_pipeline, llm)

    def _get_pipeline_config(self) -> dict[str, Any]:
        return {"type": "deep_rag", "max_steps": self.max_steps}

    async def _generate(self, query_id, top_k) -> GenerationResult:
        query = self.get_query_text(query_id)
        tracker = TokenUsageTracker()
        trace: list[str] = []
        evidence: dict[Any, float] = {}
        answer = None

        for _ in range(self.max_steps):
            response = await self.llm.agenerate(
                DECISION_PROMPT.format(query=query, trace="\n".join(trace) or "(empty)")
            )
            tracker.record(response)
            decision = _parse_decision(response.text)
            if decision.get("action") == "terminate":
                answer = str(decision.get("final_answer") or "").strip()
                break
            subquery = str(decision.get("subquery") or query)
            use_retrieval = bool(decision.get("use_retrieval", True))
            if use_retrieval:
                hits = await self.retrieval_pipeline._retrieve_by_text(
                    subquery, self.per_subquery_k
                )
                for h in hits:
                    evidence[h["doc_id"]] = max(
                        evidence.get(h["doc_id"], -1e30), float(h["score"])
                    )
                context = "\n".join(
                    self.get_chunk_contents([h["doc_id"] for h in hits])
                )
                sub_response = await self.llm.agenerate(
                    SUBANSWER_PROMPT.format(
                        context_clause=" using the context",
                        context=f"Context:\n{context}\n",
                        subquery=subquery,
                    )
                )
            else:
                sub_response = await self.llm.agenerate(
                    SUBANSWER_PROMPT.format(
                        context_clause=" from your own knowledge",
                        context="",
                        subquery=subquery,
                    )
                )
            tracker.record(sub_response)
            source = "retrieval" if use_retrieval else "parametric"
            trace.append(f"Q: {subquery} [{source}] A: {sub_response.text.strip()}")

        if answer is None or not answer:
            response = await self.llm.agenerate(
                FINAL_PROMPT.format(query=query, trace="\n".join(trace) or "(empty)")
            )
            tracker.record(response)
            answer = response.text.strip()

        final_ids = select_top_evidence(evidence, top_k)
        return GenerationResult(
            text=answer,
            token_usage=tracker.total,
            metadata={
                GENERATION_CONTEXT_CHUNK_ID_KEY: final_ids,
                "trace": trace,
            },
            retrieved=[{"doc_id": d, "score": evidence[d]} for d in final_ids],
        )


@dataclass(kw_only=True)
class DeepRAGConfig(BasePipelineConfig):
    config_type = "deep_rag"
    kind = "generation"

    retrieval_pipeline_name: str
    llm: Any = None
    max_steps: int = 5
    per_subquery_k: int = 3

    def build(self, catalog, context):
        return DeepRAGPipeline(
            catalog,
            name=self.name,
            retrieval_pipeline=context.load_pipeline(self.retrieval_pipeline_name),
            llm=context.load_llm(self.llm),
            max_steps=self.max_steps,
            per_subquery_k=self.per_subquery_k,
        )
