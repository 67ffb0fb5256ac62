"""MAIN-RAG: multi-agent document filtering with an adaptive score threshold.

Capability parity with the reference ``pipelines/generation/main_rag.py:186``
(3 agents + logprob scoring): Agent-1 (predictor) judges each candidate
document yes/no for usefulness — scored by the yes-token log-probability when
the LLM reports logprobs, else by parsing the verdict; the adaptive threshold
is ``mean(scores) - tau * std(scores)``; Agent-2 answers over the surviving
ordered documents; Agent-3 (judge) optionally revises the answer.

The port's copy of the JAX package's ``pipelines/generation/main_rag.py``.
"""

from __future__ import annotations

import asyncio
import math
from dataclasses import dataclass
from typing import Any

from autorag_research_tpu_torch.config import BasePipelineConfig
from autorag_research_tpu_torch.pipelines.generation.base import BaseGenerationPipeline, GenerationResult
from autorag_research_tpu_torch.schema import GENERATION_CONTEXT_CHUNK_ID_KEY
from autorag_research_tpu_torch.utils.tokens import TokenUsageTracker

PREDICT_PROMPT = (
    "Does the document help answer the question? Reply Yes or No.\n\n"
    "Question: {query}\n\nDocument:\n{doc}\n\nReply:"
)
ANSWER_PROMPT = (
    "Answer the question using the filtered documents.\n\nDocuments:\n{context}\n\n"
    "Question: {query}\nAnswer:"
)
JUDGE_PROMPT = (
    "Check the answer against the documents and fix unsupported claims. "
    "Return the final answer only.\n\nDocuments:\n{context}\n\n"
    "Question: {query}\nDraft answer: {answer}\nFinal answer:"
)


def _yes_score(response) -> float:
    """Yes-probability from logprobs when available, else parsed verdict."""
    if response.logprobs:
        for entry in response.logprobs:
            token = str(entry.get("token", "")).strip().lower()
            if token in ("yes", "no"):
                prob = math.exp(float(entry.get("logprob", -10.0)))
                return prob if token == "yes" else 1.0 - prob
    return 1.0 if response.text.strip().lower().startswith("yes") else 0.0


class MainRAGPipeline(BaseGenerationPipeline):
    def __init__(
        self,
        catalog,
        name: str = "main_rag",
        retrieval_pipeline=None,
        llm=None,
        candidate_pool: int | None = None,
        tau: float = 0.5,
        use_judge: bool = True,
    ):
        self.candidate_pool = candidate_pool
        self.tau = tau
        self.use_judge = use_judge
        super().__init__(catalog, name, retrieval_pipeline, llm)

    def _get_pipeline_config(self) -> dict[str, Any]:
        return {"type": "main_rag", "tau": self.tau, "use_judge": self.use_judge}

    async def _generate(self, query_id, top_k) -> GenerationResult:
        query = self.get_query_text(query_id)
        tracker = TokenUsageTracker()
        pool_k = self.candidate_pool or top_k * 2
        hits = await self.retrieve_for(query_id, pool_k)
        ids = [h["doc_id"] for h in hits]
        lookup = self.catalog.get_chunk_contents(ids)
        docs = [(h, lookup[h["doc_id"]]) for h in hits if h["doc_id"] in lookup]

        # per-doc judgments are independent: fan out under a semaphore like
        # spd_rag/autothinkrag (sequential awaits cost pool_k LLM round-trips
        # of pure latency per query)
        semaphore = asyncio.Semaphore(8)

        async def judge(text):
            async with semaphore:
                response = await self.llm.agenerate(
                    PREDICT_PROMPT.format(query=query, doc=text)
                )
            tracker.record(response)
            return _yes_score(response)

        scores = list(await asyncio.gather(*[judge(text) for _, text in docs]))

        if scores:
            mean = sum(scores) / len(scores)
            var = sum((s - mean) ** 2 for s in scores) / len(scores)
            threshold = mean - self.tau * math.sqrt(var)
            kept = [
                (h, text, s)
                for (h, text), s in zip(docs, scores)
                if s >= threshold
            ]
            kept.sort(key=lambda t: -t[2])
            kept = kept[:top_k]
        else:
            kept = []

        kept_ids = [h["doc_id"] for h, _, _ in kept]
        context = "\n".join(text for _, text, _ in kept) or "(no documents passed filtering)"
        response = await self.llm.agenerate(ANSWER_PROMPT.format(context=context, query=query))
        tracker.record(response)
        answer = response.text.strip()
        if self.use_judge and kept:
            response = await self.llm.agenerate(
                JUDGE_PROMPT.format(context=context, query=query, answer=answer)
            )
            tracker.record(response)
            answer = response.text.strip()

        return GenerationResult(
            text=answer,
            token_usage=tracker.total,
            metadata={
                GENERATION_CONTEXT_CHUNK_ID_KEY: kept_ids,
                "retrieved_chunk_ids": ids,
                "filter_scores": {str(h["doc_id"]): s for (h, _), s in zip(docs, scores)},
            },
            retrieved=[{"doc_id": h["doc_id"], "score": s} for h, _, s in kept],
        )


@dataclass(kw_only=True)
class MainRAGConfig(BasePipelineConfig):
    config_type = "main_rag"
    kind = "generation"

    retrieval_pipeline_name: str
    llm: Any = None
    candidate_pool: int | None = None
    tau: float = 0.5
    use_judge: bool = True

    def build(self, catalog, context):
        return MainRAGPipeline(
            catalog,
            name=self.name,
            retrieval_pipeline=context.load_pipeline(self.retrieval_pipeline_name),
            llm=context.load_llm(self.llm),
            candidate_pool=self.candidate_pool,
            tau=self.tau,
            use_judge=self.use_judge,
        )
