"""HybridDeepSearcher: parallel <search> blocks with a rolling log + budgets.

Capability parity with the reference
``pipelines/generation/hybrid_deep_searcher.py:163``: each turn the LLM may
emit SEVERAL ``<search>...</search>`` blocks — all execute in parallel — or a
final ``<answer>...</answer>``; a rolling interaction log feeds the next turn;
both a turn budget and a total-search budget apply.

The port's copy of the JAX package's ``pipelines/generation/hybrid_deep_searcher.py``.
"""

from __future__ import annotations

import asyncio
import re
from dataclasses import dataclass
from typing import Any

from autorag_research_tpu_torch.config import BasePipelineConfig
from autorag_research_tpu_torch.pipelines.generation.base import BaseGenerationPipeline, GenerationResult, select_top_evidence
from autorag_research_tpu_torch.schema import GENERATION_CONTEXT_CHUNK_ID_KEY
from autorag_research_tpu_torch.utils.tokens import TokenUsageTracker

TURN_PROMPT = (
    "You are a deep research agent. Think, then either issue one or more "
    "parallel searches as <search>query</search> blocks, or finish with "
    "<answer>final answer</answer>.\nSearches used: {used}/{budget}.\n\n"
    "Question: {query}\n\nInteraction log:\n{log}\n\nNext:"
)

FINAL_PROMPT = (
    "Answer the question from the gathered evidence.\n\nLog:\n{log}\n\n"
    "Question: {query}\nAnswer:"
)

_SEARCH_RE = re.compile(r"<search>\s*(.*?)\s*</search>", re.IGNORECASE | re.DOTALL)
_ANSWER_RE = re.compile(r"<answer>\s*(.*?)\s*</answer>", re.IGNORECASE | re.DOTALL)
# the paper/trained-model protocol (reference DEFAULT_HDS_PLAN_PROMPT,
# hybrid_deep_searcher.py:28-41): parallel queries between
# <|begin search queries|> ... <|end search queries|> separated by semicolons
# or newlines, final answer in \boxed{...}
_HDS_BLOCK_RE = re.compile(
    r"<\|begin search queries\|>\s*(.*?)\s*<\|end search queries\|>",
    re.IGNORECASE | re.DOTALL,
)
_BOXED_RE = re.compile(r"\\boxed\{(.*?)\}", re.DOTALL)


def parse_hds_action(text: str, max_queries: int) -> tuple[str | None, list[str]]:
    """-> (final_answer | None, [search queries]); accepts both the paper's
    token protocol and this framework's <search>/<answer> tags."""
    m = _BOXED_RE.search(text) or _ANSWER_RE.search(text)
    if m:
        return m.group(1).strip(), []
    queries: list[str] = []
    block = _HDS_BLOCK_RE.search(text)
    if block:
        queries = [
            q.strip()
            for part in block.group(1).splitlines()
            for q in part.split(";")
            if q.strip()
        ]
    else:
        queries = [q.strip() for q in _SEARCH_RE.findall(text) if q.strip()]
    # dedup preserving order, capped
    seen: list[str] = []
    for q in queries:
        if q not in seen:
            seen.append(q)
    return None, seen[:max_queries]


class HybridDeepSearcherPipeline(BaseGenerationPipeline):
    def __init__(
        self,
        catalog,
        name: str = "hybrid_deep_searcher",
        retrieval_pipeline=None,
        llm=None,
        max_turns: int = 4,
        search_budget: int = 8,
        per_search_k: int = 3,
    ):
        self.max_turns = max_turns
        self.search_budget = search_budget
        self.per_search_k = per_search_k
        super().__init__(catalog, name, retrieval_pipeline, llm)

    def _get_pipeline_config(self) -> dict[str, Any]:
        return {
            "type": "hybrid_deep_searcher",
            "max_turns": self.max_turns,
            "search_budget": self.search_budget,
        }

    async def _generate(self, query_id, top_k) -> GenerationResult:
        query = self.get_query_text(query_id)
        tracker = TokenUsageTracker()
        log: list[str] = []
        evidence: dict[Any, float] = {}
        used = 0
        answer = None

        for _ in range(self.max_turns):
            response = await self.llm.agenerate(
                TURN_PROMPT.format(
                    used=used, budget=self.search_budget, query=query,
                    log="\n".join(log) or "(empty)",
                )
            )
            tracker.record(response)
            final, searches = parse_hds_action(
                response.text, max(0, self.search_budget - used)
            )
            if final is not None:
                answer = final
                break
            if not searches:
                log.append(f"(no action) {response.text.strip()[:100]}")
                continue
            used += len(searches)

            async def run_search(q):
                hits = await self.retrieval_pipeline._retrieve_by_text(q, self.per_search_k)
                contents = self.get_chunk_contents([h["doc_id"] for h in hits])
                return q, hits, contents

            results = await asyncio.gather(*[run_search(q) for q in searches])
            for q, hits, contents in results:
                for h in hits:
                    evidence[h["doc_id"]] = max(
                        evidence.get(h["doc_id"], -1e30), float(h["score"])
                    )
                snippet = " | ".join(c[:120] for c in contents)
                log.append(f"search: {q}\nresults: {snippet}")
            if used >= self.search_budget:
                break

        if answer is None:
            response = await self.llm.agenerate(
                FINAL_PROMPT.format(log="\n".join(log) or "(empty)", query=query)
            )
            tracker.record(response)
            answer = response.text.strip()

        final_ids = select_top_evidence(evidence, top_k)
        return GenerationResult(
            text=answer,
            token_usage=tracker.total,
            metadata={
                GENERATION_CONTEXT_CHUNK_ID_KEY: final_ids,
                "interaction_log": log,
                "searches_used": used,
            },
            retrieved=[{"doc_id": d, "score": evidence[d]} for d in final_ids],
        )


@dataclass(kw_only=True)
class HybridDeepSearcherConfig(BasePipelineConfig):
    config_type = "hybrid_deep_searcher"
    kind = "generation"

    retrieval_pipeline_name: str
    llm: Any = None
    max_turns: int = 4
    search_budget: int = 8
    per_search_k: int = 3

    def build(self, catalog, context):
        return HybridDeepSearcherPipeline(
            catalog,
            name=self.name,
            retrieval_pipeline=context.load_pipeline(self.retrieval_pipeline_name),
            llm=context.load_llm(self.llm),
            max_turns=self.max_turns,
            search_budget=self.search_budget,
            per_search_k=self.per_search_k,
        )
