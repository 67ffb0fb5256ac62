"""AutoThinkRAG: complexity router + perception/reasoning decomposition.

Behavioral parity with the reference ``pipelines/generation/autothinkrag.py:147``
(QCR + DPR, multimodal-capable) with its three differentiated paths
(reference ``:24-62``, tiers ``:98``, ``max_reasoning_steps`` ``:99``):

- **simple** — factual lookup: answer directly from retrieved context;
- **moderate** — synthesis: answer while showing the reasoning process;
- **complex** — decomposed perception (extract query-relevant facts per
  retrieved item, image chunks via a vision-capable LLM) followed by an
  ITERATIVE reasoning chain of up to ``max_reasoning_steps`` steps
  (``THOUGHT:`` continues the chain, ``ANSWER:`` terminates).

The port's copy of the JAX package's ``pipelines/generation/autothinkrag.py``.
"""

from __future__ import annotations

import asyncio
from dataclasses import dataclass
from typing import Any

from autorag_research_tpu_torch.config import BasePipelineConfig
from autorag_research_tpu_torch.pipelines.generation.base import BaseGenerationPipeline, GenerationResult
from autorag_research_tpu_torch.schema import GENERATION_CONTEXT_CHUNK_ID_KEY
from autorag_research_tpu_torch.utils.tokens import TokenUsageTracker

import re

_ANSWER_RE = re.compile(r"ANSWER:\s*(.*)", re.IGNORECASE | re.DOTALL)

ROUTE_PROMPT = (
    "Classify the query's complexity as exactly one of: simple, moderate, "
    "complex.\n"
    "- simple: factual lookup, single-hop, direct answer from context\n"
    "- moderate: synthesis across multiple pieces of information\n"
    "- complex: multi-hop reasoning or combining visual and textual "
    "evidence step by step\n\n"
    "Query: {query}\nClassification (one word):"
)
DIRECT_PROMPT = (
    "Answer using the context.\n\nContext:\n{context}\n\nQuestion: {query}\nAnswer:"
)
PERCEIVE_PROMPT = (
    "Extract the facts from this item that are relevant to the question. "
    "Reply 'NONE' if nothing is relevant.\n\nQuestion: {query}\n\nItem:\n{item}\n\nFacts:"
)
VISUAL_PROMPT = (
    "Describe the visual content relevant to answering this question.\n\n"
    "Question: {query}\n\nDescription:"
)
MODERATE_PROMPT = (
    "Answer the question by synthesizing information from the context. Show "
    "your reasoning process.\n\nContext:\n{context}\n\nQuestion: {query}\n"
    "Answer (explain your reasoning):"
)
REASON_STEP_PROMPT = (
    "You are solving a complex question with multi-step reasoning over "
    "perceived facts.\nEither continue the chain with 'THOUGHT: <next "
    "deduction>' or finish with 'ANSWER: <final answer>'.\n\n"
    "Facts:\n{facts}\n\nReasoning chain so far:\n{chain}\n\n"
    "Question: {query}\nNext step:"
)


class AutoThinkRAGPipeline(BaseGenerationPipeline):
    def __init__(
        self,
        catalog,
        name: str = "autothinkrag",
        retrieval_pipeline=None,
        llm=None,
        max_perception_concurrency: int = 8,
        max_reasoning_steps: int = 3,
    ):
        self.max_perception_concurrency = max_perception_concurrency
        self.max_reasoning_steps = max_reasoning_steps
        super().__init__(catalog, name, retrieval_pipeline, llm)

    def _get_pipeline_config(self) -> dict[str, Any]:
        return {
            "type": "autothinkrag",
            "max_reasoning_steps": self.max_reasoning_steps,
        }

    def _resolve_items(self, hits) -> list[tuple[Any, str, bytes | None]]:
        """(doc_id, text, image_bytes) per hit — image chunks resolve to their
        bytes for vision-capable LLMs."""
        unit = getattr(self.retrieval_pipeline, "retrieval_unit", "chunk")
        ids = [h["doc_id"] for h in hits]
        if unit == "image_chunk":
            rows = self.catalog.get_image_chunks(ids)
            return [
                (did, f"(image chunk {did})", rows[did]["image"] if did in rows else None)
                for did in ids
            ]
        lookup = self.catalog.get_chunk_contents(ids)
        return [(did, lookup.get(did, ""), None) for did in ids]

    async def _generate(self, query_id, top_k) -> GenerationResult:
        query = self.get_query_text(query_id)
        tracker = TokenUsageTracker()
        response = await self.llm.agenerate(ROUTE_PROMPT.format(query=query))
        tracker.record(response)
        lowered = response.text.lower()
        if "complex" in lowered:
            complexity = "complex"
        elif "moderate" in lowered:
            complexity = "moderate"
        else:
            complexity = "simple"

        hits = await self.retrieve_for(query_id, top_k)
        items = self._resolve_items(hits)
        final_ids = [d for d, _, _ in items]
        chain: list[str] = []

        if complexity in ("simple", "moderate"):
            context = "\n".join(text for _, text, _ in items)
            # visual interpretation runs for EVERY tier (reference
            # autothinkrag.py:484-517 injects visual_context into the simple
            # and moderate prompts too) — image evidence must reach the LLM,
            # not '(image chunk N)' placeholders
            images = [img for _, _, img in items if img is not None]
            if images:
                response = await self.llm.agenerate(
                    VISUAL_PROMPT.format(query=query), images=images
                )
                tracker.record(response)
                interp = response.text.strip()
                if interp:
                    context = (
                        f"{context}\n\nVisual Interpretation:\n{interp}"
                        if context else f"Visual Interpretation:\n{interp}"
                    )
            template = DIRECT_PROMPT if complexity == "simple" else MODERATE_PROMPT
            response = await self.llm.agenerate(
                template.format(context=context, query=query)
            )
            tracker.record(response)
            answer = response.text.strip()
            facts: list[str] = []
        else:
            semaphore = asyncio.Semaphore(self.max_perception_concurrency)

            async def perceive(did, text, image):
                kwargs = {"images": [image]} if image is not None else {}
                async with semaphore:
                    response = await self.llm.agenerate(
                        PERCEIVE_PROMPT.format(query=query, item=text), **kwargs
                    )
                tracker.record(response)
                return response.text.strip()

            perceived = await asyncio.gather(*[perceive(*item) for item in items])
            facts = [f for f in perceived if f and "none" != f.lower().strip()]
            facts_text = "\n".join(f"- {f}" for f in facts) or "(none)"
            answer = None
            for _ in range(self.max_reasoning_steps):
                response = await self.llm.agenerate(
                    REASON_STEP_PROMPT.format(
                        facts=facts_text,
                        chain="\n".join(chain) or "(start)",
                        query=query,
                    )
                )
                tracker.record(response)
                step = response.text.strip()
                m = _ANSWER_RE.search(step)
                if m:
                    answer = m.group(1).strip()
                    break
                chain.append(step if step.upper().startswith("THOUGHT") else f"THOUGHT: {step}")
            if answer is None:  # budget exhausted: answer from the chain
                response = await self.llm.agenerate(
                    DIRECT_PROMPT.format(
                        context=facts_text + "\n" + "\n".join(chain), query=query
                    )
                )
                tracker.record(response)
                answer = response.text.strip()

        return GenerationResult(
            text=answer,
            token_usage=tracker.total,
            metadata={
                GENERATION_CONTEXT_CHUNK_ID_KEY: final_ids,
                "complexity": complexity,
                "perceived_facts": facts,
                "reasoning_chain": chain,
            },
            retrieved=hits,
        )


@dataclass(kw_only=True)
class AutoThinkRAGConfig(BasePipelineConfig):
    config_type = "autothinkrag"
    kind = "generation"

    retrieval_pipeline_name: str
    llm: Any = None
    max_perception_concurrency: int = 8
    max_reasoning_steps: int = 3

    def build(self, catalog, context):
        return AutoThinkRAGPipeline(
            catalog,
            name=self.name,
            retrieval_pipeline=context.load_pipeline(self.retrieval_pipeline_name),
            llm=context.load_llm(self.llm),
            max_perception_concurrency=self.max_perception_concurrency,
            max_reasoning_steps=self.max_reasoning_steps,
        )
