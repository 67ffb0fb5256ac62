"""SPD-RAG: one sub-agent per document -> coordinator -> synthesis.

Behavioral parity with the reference ``pipelines/generation/spd_rag.py:90``
three-role protocol: a SUB-AGENT answers the question from each document in
isolation; a COORDINATOR judges each partial answer Yes/No for usefulness
(reference DEFAULT_COORDINATOR_* prompts); a SYNTHESIS agent merges the
useful partials into one coherent answer (not a concatenation). Sub-agents
may also self-filter with 'No relevant information'.

The port's copy of the JAX package's ``pipelines/generation/spd_rag.py``.
"""

from __future__ import annotations

import asyncio
from dataclasses import dataclass
from typing import Any

from autorag_research_tpu_torch.config import BasePipelineConfig
from autorag_research_tpu_torch.pipelines.generation.base import BaseGenerationPipeline, GenerationResult
from autorag_research_tpu_torch.schema import GENERATION_CONTEXT_CHUNK_ID_KEY
from autorag_research_tpu_torch.utils.tokens import TokenUsageTracker

PER_DOC_PROMPT = (
    "You are a focused document analyst: answer the question using ONLY this "
    "document. If it holds no relevant information, reply 'IRRELEVANT'.\n\n"
    "Question: {query}\n\nDocument:\n{doc}\n\nFinding:"
)

COORDINATOR_PROMPT = (
    "Does this partial answer provide useful information for the question? "
    "Reply Yes or No.\n\nQuestion: {query}\nPartial answer: {partial}\nReply:"
)

AGGREGATE_PROMPT = (
    "Synthesize the useful partial answers into ONE coherent answer — resolve "
    "conflicts by preferring the more specific, better-supported information; "
    "do not just concatenate.\n\n"
    "Question: {query}\n\nPartial answers:\n{findings}\n\nAnswer:"
)


class SPDRAGPipeline(BaseGenerationPipeline):
    def __init__(
        self,
        catalog,
        name: str = "spd_rag",
        retrieval_pipeline=None,
        llm=None,
        max_doc_concurrency: int = 8,
    ):
        self.max_doc_concurrency = max_doc_concurrency
        super().__init__(catalog, name, retrieval_pipeline, llm)

    def _get_pipeline_config(self) -> dict[str, Any]:
        return {"type": "spd_rag", "max_doc_concurrency": self.max_doc_concurrency}

    async def _generate(self, query_id, top_k) -> GenerationResult:
        query = self.get_query_text(query_id)
        tracker = TokenUsageTracker()
        hits = await self.retrieve_for(query_id, top_k)
        ids = [h["doc_id"] for h in hits]
        lookup = self.catalog.get_chunk_contents(ids)
        semaphore = asyncio.Semaphore(self.max_doc_concurrency)

        async def analyze(doc_id, text):
            async with semaphore:
                response = await self.llm.agenerate(
                    PER_DOC_PROMPT.format(query=query, doc=text)
                )
            tracker.record(response)
            return doc_id, response.text.strip()

        findings = await asyncio.gather(
            *[analyze(did, lookup[did]) for did in ids if did in lookup]
        )
        # drop only findings that ARE the IRRELEVANT sentinel (reference
        # semantics: the coordinator judges everything else — a finding that
        # merely mentions the word, e.g. "not irrelevant: ...", must survive)
        candidates = [
            (d, f)
            for d, f in findings
            if not f.lower().lstrip("'\"` ").startswith("irrelevant")
        ]

        async def coordinate(doc_id, partial):
            async with semaphore:
                response = await self.llm.agenerate(
                    COORDINATOR_PROMPT.format(query=query, partial=partial)
                )
            tracker.record(response)
            return doc_id, partial, response.text.strip().lower().startswith("yes")

        judged = await asyncio.gather(*[coordinate(d, f) for d, f in candidates])
        useful = [(d, f) for d, f, ok in judged if ok]
        findings_block = "\n".join(f"- {f}" for _, f in useful) or "(no useful documents)"
        response = await self.llm.agenerate(
            AGGREGATE_PROMPT.format(query=query, findings=findings_block)
        )
        tracker.record(response)
        useful_ids = [d for d, _ in useful]
        return GenerationResult(
            text=response.text.strip(),
            token_usage=tracker.total,
            metadata={
                GENERATION_CONTEXT_CHUNK_ID_KEY: useful_ids,
                "retrieved_chunk_ids": ids,
                "findings": {str(d): f for d, f in findings},
            },
            retrieved=[h for h in hits if h["doc_id"] in set(useful_ids)],
        )


@dataclass(kw_only=True)
class SPDRAGConfig(BasePipelineConfig):
    config_type = "spd_rag"
    kind = "generation"

    retrieval_pipeline_name: str
    llm: Any = None
    max_doc_concurrency: int = 8

    def build(self, catalog, context):
        return SPDRAGPipeline(
            catalog,
            name=self.name,
            retrieval_pipeline=context.load_pipeline(self.retrieval_pipeline_name),
            llm=context.load_llm(self.llm),
            max_doc_concurrency=self.max_doc_concurrency,
        )
