"""Search-R1 rollout protocol: <think>/<search>/<information>/<answer>.

Capability parity with the reference ``pipelines/generation/search_r1.py:107``:
the LLM reasons in ``<think>`` blocks and either issues ``<search>query</search>``
(results injected back between ``<information>`` tags) or terminates with
``<answer>...</answer>``; an action budget bounds the rollout, with a fallback
final-answer prompt when the budget is exhausted.

The port's copy of the JAX package's ``pipelines/generation/search_r1.py``.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Any

from autorag_research_tpu_torch.config import BasePipelineConfig
from autorag_research_tpu_torch.pipelines.generation.base import BaseGenerationPipeline, GenerationResult
from autorag_research_tpu_torch.schema import GENERATION_CONTEXT_CHUNK_ID_KEY
from autorag_research_tpu_torch.utils.tokens import TokenUsageTracker

STEP_PROMPT = (
    "Answer the given question. You must conduct reasoning inside <think> and "
    "</think> first every time you get new information. After reasoning, if you "
    "find you lack some knowledge, you can call a search engine by "
    "<search> query </search> and it will return the top searched results "
    "between <information> and </information>. You can search as many times as "
    "you want. If you find no further external knowledge needed, you can "
    "directly provide the answer inside <answer> and </answer>, without "
    "detailed illustrations. Question: {query}\n{rollout}"
)

FINAL_PROMPT = (
    "Answer the question from the Search-R1 rollout.\n\nRollout:\n{rollout}\n\n"
    "Question: {query}\nAnswer:"
)

_SEARCH_RE = re.compile(r"<search>\s*(.*?)\s*</search>", re.IGNORECASE | re.DOTALL)
_ANSWER_RE = re.compile(r"<answer>\s*(.*?)\s*</answer>", re.IGNORECASE | re.DOTALL)


class SearchR1Pipeline(BaseGenerationPipeline):
    def __init__(
        self,
        catalog,
        name: str = "search_r1",
        retrieval_pipeline=None,
        llm=None,
        step_prompt_template: str = STEP_PROMPT,
        final_prompt_template: str = FINAL_PROMPT,
        max_actions: int = 4,
    ):
        self.step_prompt_template = step_prompt_template
        self.final_prompt_template = final_prompt_template
        self.max_actions = max_actions
        super().__init__(catalog, name, retrieval_pipeline, llm)

    def _get_pipeline_config(self) -> dict[str, Any]:
        return {"type": "search_r1", "max_actions": self.max_actions}

    @staticmethod
    def _truncate_to_first_action(segment: str) -> str:
        """Keep the LLM segment only through its earliest completed action."""
        ends = []
        for pattern in (_SEARCH_RE, _ANSWER_RE):
            m = pattern.search(segment)
            if m:
                ends.append(m.end())
        return segment[: min(ends)] if ends else segment

    async def _generate(self, query_id, top_k) -> GenerationResult:
        query = self.get_query_text(query_id)
        tracker = TokenUsageTracker()
        rollout = ""
        evidence_ids: list[Any] = []
        evidence_scores: dict[Any, float] = {}
        answer = None
        terminated_by = "budget_exhausted"

        for _ in range(self.max_actions):
            response = await self.llm.agenerate(
                self.step_prompt_template.format(query=query, rollout=rollout)
            )
            tracker.record(response)
            segment = self._truncate_to_first_action(response.text)
            rollout += segment
            m = _ANSWER_RE.search(segment)
            if m:
                answer = m.group(1).strip()
                terminated_by = "answer"
                break
            m = _SEARCH_RE.search(segment)
            if m:
                search_query = m.group(1).strip()
                hits = await self.retrieval_pipeline._retrieve_by_text(search_query, top_k)
                contents = self.get_chunk_contents([h["doc_id"] for h in hits])
                for h in hits:
                    if h["doc_id"] not in evidence_scores:
                        evidence_ids.append(h["doc_id"])
                    evidence_scores[h["doc_id"]] = max(
                        evidence_scores.get(h["doc_id"], -1e30), float(h["score"])
                    )
                info = "\n".join(contents)
                rollout += f"\n<information>\n{info}\n</information>\n"
            else:
                # no action emitted: nudge the model by closing the rollout
                rollout += "\n"

        if answer is None:
            response = await self.llm.agenerate(
                self.final_prompt_template.format(rollout=rollout, query=query)
            )
            tracker.record(response)
            answer = response.text.strip()
            terminated_by = "budget_exhausted_fallback"

        return GenerationResult(
            text=answer,
            token_usage=tracker.total,
            metadata={
                GENERATION_CONTEXT_CHUNK_ID_KEY: evidence_ids,
                "rollout": rollout,
                "terminated_by": terminated_by,
            },
            retrieved=[
                {"doc_id": d, "score": evidence_scores[d]} for d in evidence_ids
            ],
        )


@dataclass(kw_only=True)
class SearchR1Config(BasePipelineConfig):
    config_type = "search_r1"
    kind = "generation"

    retrieval_pipeline_name: str
    llm: Any = None
    max_actions: int = 4

    def build(self, catalog, context):
        return SearchR1Pipeline(
            catalog,
            name=self.name,
            retrieval_pipeline=context.load_pipeline(self.retrieval_pipeline_name),
            llm=context.load_llm(self.llm),
            max_actions=self.max_actions,
        )
