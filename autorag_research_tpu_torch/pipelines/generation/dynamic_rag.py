"""DynamicRAG: an LLM reranker selects an ordered (possibly empty) doc subset.

Capability parity with the reference ``pipelines/generation/dynamic_rag.py:70``:
the selector LLM sees the candidate pool and outputs the ordered subset worth
keeping (possibly none), then the answer is generated from exactly that
subset; the selection is recorded under ``selected_chunk_ids``.

The port's copy of the JAX package's ``pipelines/generation/dynamic_rag.py``.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Any

from autorag_research_tpu_torch.config import BasePipelineConfig
from autorag_research_tpu_torch.pipelines.generation.base import BaseGenerationPipeline, GenerationResult
from autorag_research_tpu_torch.schema import GENERATION_CONTEXT_CHUNK_ID_KEY
from autorag_research_tpu_torch.utils.tokens import TokenUsageTracker

SELECT_PROMPT = (
    "You are selecting documents to answer a question. Review the numbered "
    "documents and output the numbers of the useful ones in the best reading "
    "order, separated by commas (output 'none' if no document helps).\n\n"
    "Question: {query}\n\n{docs}\n\nSelection:"
)

ANSWER_PROMPT = (
    "Answer the question using the documents (or general knowledge when no "
    "documents are given).\n\nDocuments:\n{context}\n\nQuestion: {query}\nAnswer:"
)


class DynamicRAGPipeline(BaseGenerationPipeline):
    def __init__(
        self,
        catalog,
        name: str = "dynamic_rag",
        retrieval_pipeline=None,
        llm=None,
        candidate_pool: int | None = None,
    ):
        self.candidate_pool = candidate_pool
        super().__init__(catalog, name, retrieval_pipeline, llm)

    def _get_pipeline_config(self) -> dict[str, Any]:
        return {"type": "dynamic_rag", "candidate_pool": self.candidate_pool}

    async def _generate(self, query_id, top_k) -> GenerationResult:
        query = self.get_query_text(query_id)
        tracker = TokenUsageTracker()
        pool_k = self.candidate_pool or top_k * 2
        hits = await self.retrieve_for(query_id, pool_k)
        ids = [h["doc_id"] for h in hits]
        lookup = self.catalog.get_chunk_contents(ids)
        pool = [(h, lookup.get(h["doc_id"])) for h in hits if lookup.get(h["doc_id"])]

        docs_block = "\n".join(f"[{i + 1}] {text}" for i, (_, text) in enumerate(pool))
        response = await self.llm.agenerate(SELECT_PROMPT.format(query=query, docs=docs_block))
        tracker.record(response)
        selected: list[int] = []
        # reference semantics (rerankers/dynamic_rag.py:74-91): only a
        # LEADING "None" is a zero-document decision; "1, 3 help; none of
        # the others" still selects 1 and 3
        none_prefixed = re.match(
            r"^[\s\[\(\"'`*-]*none\b", response.text, flags=re.IGNORECASE
        )
        if not none_prefixed:
            for tok in re.findall(r"\d+", response.text):
                idx = int(tok) - 1
                if 0 <= idx < len(pool) and idx not in selected:
                    selected.append(idx)
        selected = selected[:top_k]
        selected_ids = [pool[i][0]["doc_id"] for i in selected]
        context = "\n".join(pool[i][1] for i in selected) or "(no documents selected)"
        response = await self.llm.agenerate(ANSWER_PROMPT.format(context=context, query=query))
        tracker.record(response)
        return GenerationResult(
            text=response.text.strip(),
            token_usage=tracker.total,
            metadata={
                GENERATION_CONTEXT_CHUNK_ID_KEY: selected_ids,
                "selected_chunk_ids": selected_ids,
                "retrieved_chunk_ids": ids,
            },
            retrieved=[pool[i][0] for i in selected],
        )


@dataclass(kw_only=True)
class DynamicRAGConfig(BasePipelineConfig):
    config_type = "dynamic_rag"
    kind = "generation"

    retrieval_pipeline_name: str
    llm: Any = None
    candidate_pool: int | None = None

    def build(self, catalog, context):
        return DynamicRAGPipeline(
            catalog,
            name=self.name,
            retrieval_pipeline=context.load_pipeline(self.retrieval_pipeline_name),
            llm=context.load_llm(self.llm),
            candidate_pool=self.candidate_pool,
        )
