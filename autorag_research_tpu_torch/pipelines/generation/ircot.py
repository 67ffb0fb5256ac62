"""IRCoT: interleaved chain-of-thought reasoning and retrieval.

Capability parity with the reference ``pipelines/generation/ircot.py:54``
("Interleaving Retrieval with Chain-of-Thought Reasoning", ACL 2023):
retrieve for the question, then loop — generate one CoT sentence, retrieve
with it, accumulate evidence — until "answer is:" appears or ``max_steps``;
finish with a QA prompt over all collected paragraphs.

The port's copy of the JAX package's ``pipelines/generation/ircot.py``.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Any

from autorag_research_tpu_torch.config import BasePipelineConfig
from autorag_research_tpu_torch.pipelines.generation.base import BaseGenerationPipeline, GenerationResult, select_top_evidence
from autorag_research_tpu_torch.schema import GENERATION_CONTEXT_CHUNK_ID_KEY
from autorag_research_tpu_torch.utils.tokens import TokenUsageTracker

REASONING_PROMPT = (
    "You are answering a multi-step question using chain-of-thought reasoning.\n"
    "Write the NEXT single reasoning sentence. When you can answer, write a "
    'sentence starting with "answer is:".\n\n'
    "Paragraphs:\n{paragraphs}\n\nQuestion: {query}\nReasoning so far: {cot}\nNext sentence:"
)

QA_PROMPT = (
    "Answer the following question using the provided paragraphs.\n\n"
    "Paragraphs:\n{paragraphs}\n\nQuestion: {query}\nAnswer:"
)

_ANSWER_RE = re.compile(r"answer is:\s*(.*)", re.IGNORECASE | re.DOTALL)


class IRCoTPipeline(BaseGenerationPipeline):
    def __init__(
        self,
        catalog,
        name: str = "ircot",
        retrieval_pipeline=None,
        llm=None,
        reasoning_prompt_template: str = REASONING_PROMPT,
        qa_prompt_template: str = QA_PROMPT,
        max_steps: int = 8,
        paragraphs_per_step: int | None = None,
    ):
        self.reasoning_prompt_template = reasoning_prompt_template
        self.qa_prompt_template = qa_prompt_template
        self.max_steps = max_steps
        self.paragraphs_per_step = paragraphs_per_step
        super().__init__(catalog, name, retrieval_pipeline, llm)

    def _get_pipeline_config(self) -> dict[str, Any]:
        return {"type": "ircot", "max_steps": self.max_steps}

    async def _generate(self, query_id, top_k) -> GenerationResult:
        query = self.get_query_text(query_id)
        tracker = TokenUsageTracker()
        per_step = self.paragraphs_per_step or top_k
        evidence: dict[Any, float] = {}

        async def expand(question: str):
            for hit in await self.retrieval_pipeline._retrieve_by_text(question, per_step):
                did, score = hit["doc_id"], float(hit["score"])
                if did not in evidence or score > evidence[did]:
                    evidence[did] = score

        await expand(query)
        cot_sentences: list[str] = []
        steps = 0
        answer = None
        for _ in range(self.max_steps):
            steps += 1
            ordered = [(d, evidence[d]) for d in select_top_evidence(evidence, len(evidence))]
            paragraphs = "\n".join(
                f"- {p}" for p in self.get_chunk_contents([d for d, _ in ordered[: top_k * 2]])
            )
            response = await self.llm.agenerate(
                self.reasoning_prompt_template.format(
                    paragraphs=paragraphs, query=query, cot=" ".join(cot_sentences)
                )
            )
            tracker.record(response)
            sentence = response.text.strip().split("\n")[0]
            cot_sentences.append(sentence)
            m = _ANSWER_RE.search(sentence)
            if m:
                answer = m.group(1).strip()
                break
            await expand(sentence)

        final_ids = select_top_evidence(evidence, top_k)
        if answer is None:
            paragraphs = "\n".join(f"- {p}" for p in self.get_chunk_contents(final_ids))
            response = await self.llm.agenerate(
                self.qa_prompt_template.format(paragraphs=paragraphs, query=query)
            )
            tracker.record(response)
            answer = response.text.strip()

        return GenerationResult(
            text=answer,
            token_usage=tracker.total,
            metadata={
                GENERATION_CONTEXT_CHUNK_ID_KEY: final_ids,
                "cot": cot_sentences,
                "steps": steps,
            },
            retrieved=[{"doc_id": d, "score": evidence[d]} for d in final_ids],
        )


@dataclass(kw_only=True)
class IRCoTConfig(BasePipelineConfig):
    config_type = "ircot"
    kind = "generation"

    retrieval_pipeline_name: str
    llm: Any = None
    max_steps: int = 8
    paragraphs_per_step: int | None = None

    def build(self, catalog, context):
        return IRCoTPipeline(
            catalog,
            name=self.name,
            retrieval_pipeline=context.load_pipeline(self.retrieval_pipeline_name),
            llm=context.load_llm(self.llm),
            max_steps=self.max_steps,
            paragraphs_per_step=self.paragraphs_per_step,
        )
