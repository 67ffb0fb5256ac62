"""RAG-Critic: critic-guided corrective loop with the full error taxonomy.

Behavioral parity with the reference ``pipelines/generation/rag_critic.py:376``:

- the critic returns a verdict + recommended fix actions chosen from the
  reference's supported set ``{retrieval, rewrite_query, decompose_query,
  refine_documents, generate_answer}`` (``:271-277``), either as direct JSON
  (``critic_output_format="json_actions"``) or as the trained RAG-Critic-3B
  tag taxonomy (``critic_output_format="rag_critic_tags"``) whose tag2 values
  map to actions (``RAG_CRITIC_3B_TAG2_ACTIONS`` ``:281-303``);
- the loop executes the deduplicated actions in order — re-retrieve, rewrite
  the query then retrieve, decompose into sub-questions and retrieve each,
  LLM-refine the document set, regenerate the answer — until the critic
  approves or ``max_rounds`` is exhausted (``:1002+`` action handlers).

The port's copy of the JAX package's ``pipelines/generation/rag_critic.py``.
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

SUPPORTED_ACTIONS = (
    "retrieval",
    "rewrite_query",
    "decompose_query",
    "refine_documents",
    "generate_answer",
)

# Trained-critic error taxonomy -> fix actions (reference ``:281-303``; the
# tag2 strings are the published RAG-Critic-3B label set).
TAG2_ACTIONS: dict[str, tuple[str, ...]] = {
    "insufficient or incomplete information retrieval": ("retrieval",),
    "data insufficiency in retrieval": ("retrieval",),
    "relevance gaps in retrieval": ("retrieval",),
    "irrelevant information retrieval": ("retrieval", "refine_documents"),
    "erroneous information retrieval": ("retrieval", "refine_documents"),
    "omission of key information": ("generate_answer",),
    "lack of specificity": ("generate_answer",),
    "specificity and precision errors": ("generate_answer",),
    "partial coverage and temporal issues": ("retrieval", "generate_answer"),
    "lack of practicality": ("generate_answer",),
    "contextual understanding errors": ("rewrite_query", "generate_answer"),
    "factual inaccuracies": ("generate_answer",),
    "incorrect and incomplete answers": ("generate_answer",),
    "golden answer misalignment": ("generate_answer",),
    "misinterpretation of queries and information": ("rewrite_query", "decompose_query"),
    "entity and concept confusion": ("rewrite_query", "decompose_query"),
    "irrelevant content and topic drift": ("refine_documents", "generate_answer"),
    "off-topic and redundant responses": ("refine_documents", "generate_answer"),
    "content and context misalignment": ("refine_documents", "generate_answer"),
    "overly complex and redundant response": ("refine_documents", "generate_answer"),
}

DRAFT_PROMPT = (
    "Answer the question using the context.\n\nContext:\n{context}\n\n"
    "Question: {query}\nAnswer:"
)

CRITIC_JSON_PROMPT = (
    "You are a RAG critic. Review the answer against the question and the "
    "retrieved context.\nReturn JSON only:\n"
    '{{"verdict": "approved" or "revise", "feedback": "...", '
    '"recommended_actions": [list from {actions}]}}\n\n'
    "Question: {query}\nContext:\n{context}\nAnswer: {answer}\nCritique:"
)

CRITIC_TAGS_PROMPT = (
    "You are the RAG-Critic error-analysis model. Judge the prediction.\n"
    'If correct, output exactly: {{"Judgement": "Correct"}}\n'
    "If incorrect, output JSON "
    '{{"Judgement": "Error", "Error_analysis": "...", "tag2": ["..."]}}\n'
    "with tag2 values from this taxonomy: {tags}\n\n"
    "Question: {query}\nRetrieved Passages:\n{context}\n"
    "Model's Prediction: {answer}\nAnalysis:"
)

REWRITE_PROMPT = (
    "Rewrite this search query so it better retrieves evidence for the "
    "question. Problem noted: {feedback}\nQuestion: {query}\nRewritten query:"
)

DECOMPOSE_PROMPT = (
    "Decompose the question into 2-3 simpler sub-questions, one per line.\n"
    "Question: {query}\nSub-questions:"
)

REFINE_PROMPT = (
    "From the numbered documents, list the numbers of those actually useful "
    "for answering (comma-separated). Problem noted: {feedback}\n\n"
    "Question: {query}\nDocuments:\n{documents}\nUseful document numbers:"
)

REGENERATE_PROMPT = (
    "The previous answer had this problem: {feedback}\nWrite an improved "
    "answer using the context.\n\nContext:\n{context}\n\nQuestion: {query}\n"
    "Previous answer: {answer}\nImproved answer:"
)


def _json_payload(text: str) -> dict:
    m = re.search(r"\{.*\}", text, re.DOTALL)
    if m:
        try:
            data = json.loads(m.group(0))
            if isinstance(data, dict):
                return data
        except json.JSONDecodeError:
            pass
    return {}


def parse_critique(text: str, output_format: str) -> dict:
    """-> {"approved": bool, "feedback": str, "actions": [supported...]}."""
    data = _json_payload(text)
    if output_format == "rag_critic_tags":
        judgement = str(data.get("Judgement", "")).strip().lower()
        if judgement == "correct":
            return {"approved": True, "feedback": "", "actions": []}
        tags = data.get("tag2") or []
        if isinstance(tags, str):
            tags = [tags]
        actions: list[str] = []
        for tag in tags:
            for a in TAG2_ACTIONS.get(str(tag).strip().lower(), ()):
                if a not in actions:
                    actions.append(a)
        # reference semantics (rag_critic.py:682-704): ONLY an explicit
        # 'Correct' judgement approves; anything else — 'Error', 'Incorrect',
        # empty, unparseable prose — is a revise verdict (falling back to
        # regeneration when no tag maps to a fix action)
        return {
            "approved": False,
            "feedback": str(data.get("Error_analysis", "")) or text.strip()[:500],
            "actions": actions or ["generate_answer"],
        }
    verdict = str(data.get("verdict", "")).strip().lower()
    raw = data.get("recommended_actions") or []
    if isinstance(raw, str):
        raw = [raw]
    actions = []
    for a in raw:
        a = str(a).strip().lower()
        if a in SUPPORTED_ACTIONS and a not in actions:
            actions.append(a)
    approved = verdict == "approved" or (not data and "approved" in text.lower())
    if verdict == "revise" and not actions:
        actions = ["generate_answer"]
    return {
        "approved": approved and not actions,
        "feedback": str(data.get("feedback", ""))[:500],
        "actions": actions,
    }


class RAGCriticPipeline(BaseGenerationPipeline):
    def __init__(
        self,
        catalog,
        name: str = "rag_critic",
        retrieval_pipeline=None,
        llm=None,
        critic_llm=None,
        critic_output_format: str = "json_actions",
        max_rounds: int = 3,
    ):
        if critic_output_format not in ("json_actions", "rag_critic_tags"):
            raise ValueError(
                f"unknown critic_output_format '{critic_output_format}'"
            )
        self.critic_llm = critic_llm
        self.critic_output_format = critic_output_format
        self.max_rounds = max_rounds
        super().__init__(catalog, name, retrieval_pipeline, llm)

    def _get_pipeline_config(self) -> dict[str, Any]:
        return {
            "type": "rag_critic",
            "critic_output_format": self.critic_output_format,
            "max_rounds": self.max_rounds,
        }

    async def _generate(self, query_id, top_k) -> GenerationResult:
        query = self.get_query_text(query_id)
        search_query = query
        critic = self.critic_llm or self.llm
        tracker = TokenUsageTracker()
        evidence: dict[Any, float] = {}

        async def call(llm, prompt):
            response = await llm.agenerate(prompt)
            tracker.record(response)
            return response.text.strip()

        async def expand(q):
            for h in await self.retrieval_pipeline._retrieve_by_text(q, top_k):
                evidence[h["doc_id"]] = max(
                    evidence.get(h["doc_id"], -1e30), float(h["score"])
                )

        await expand(search_query)

        def active_ids():
            return select_top_evidence(evidence, top_k * 2)

        def context():
            return "\n".join(self.get_chunk_contents(active_ids()))

        answer = await call(self.llm, DRAFT_PROMPT.format(context=context(), query=query))
        history = []

        for _ in range(self.max_rounds):
            if self.critic_output_format == "rag_critic_tags":
                prompt = CRITIC_TAGS_PROMPT.format(
                    tags=", ".join(sorted(TAG2_ACTIONS)),
                    query=query, context=context(), answer=answer,
                )
            else:
                prompt = CRITIC_JSON_PROMPT.format(
                    actions=", ".join(SUPPORTED_ACTIONS),
                    query=query, context=context(), answer=answer,
                )
            critique = parse_critique(await call(critic, prompt), self.critic_output_format)
            history.append(critique)
            if critique["approved"] or not critique["actions"]:
                break
            feedback = critique["feedback"] or "answer needs revision"
            regenerate = False
            for action in critique["actions"]:
                if action == "retrieval":
                    await expand(search_query)
                    regenerate = True
                elif action == "rewrite_query":
                    search_query = await call(
                        self.llm, REWRITE_PROMPT.format(feedback=feedback, query=query)
                    ) or query
                    await expand(search_query)
                    regenerate = True
                elif action == "decompose_query":
                    subs = [
                        line.strip(" -1234567890.").strip()
                        for line in (
                            await call(self.llm, DECOMPOSE_PROMPT.format(query=query))
                        ).splitlines()
                        if line.strip()
                    ]
                    for sub in subs[:3]:
                        await expand(sub)
                    regenerate = True
                elif action == "refine_documents":
                    ids = active_ids()
                    # align ids with the texts actually SHOWN to the LLM:
                    # get_chunk_contents silently skips ids without contents,
                    # and numbering `ids` while showing `texts` would map the
                    # LLM's kept numbers onto the wrong documents
                    lookup = self.catalog.get_chunk_contents(ids)
                    shown = [(d, lookup[d]) for d in ids if d in lookup]
                    numbered = "\n".join(
                        f"{i + 1}. {t}" for i, (_, t) in enumerate(shown)
                    )
                    reply = await call(
                        self.llm,
                        REFINE_PROMPT.format(feedback=feedback, query=query, documents=numbered),
                    )
                    keep = {int(n) - 1 for n in re.findall(r"\d+", reply)}
                    kept = [d for i, (d, _) in enumerate(shown) if i in keep]
                    if kept:  # never refine down to nothing
                        dropped = set(ids) - set(kept)
                        for d in dropped:
                            evidence.pop(d, None)
                    regenerate = True
                elif action == "generate_answer":
                    regenerate = True
            if regenerate:
                answer = await call(
                    self.llm,
                    REGENERATE_PROMPT.format(
                        feedback=feedback, context=context(), query=query, answer=answer
                    ),
                )

        final_ids = select_top_evidence(evidence, top_k)
        return GenerationResult(
            text=answer,
            token_usage=tracker.total,
            metadata={
                GENERATION_CONTEXT_CHUNK_ID_KEY: final_ids,
                "critiques": history,
                "final_search_query": search_query,
            },
            retrieved=[{"doc_id": d, "score": evidence[d]} for d in final_ids],
        )


@dataclass(kw_only=True)
class RAGCriticConfig(BasePipelineConfig):
    config_type = "rag_critic"
    kind = "generation"

    retrieval_pipeline_name: str
    llm: Any = None
    critic_llm: Any = None
    critic_output_format: str = "json_actions"
    max_rounds: int = 3

    def build(self, catalog, context):
        return RAGCriticPipeline(
            catalog,
            name=self.name,
            retrieval_pipeline=context.load_pipeline(self.retrieval_pipeline_name),
            llm=context.load_llm(self.llm),
            critic_llm=context.load_llm(self.critic_llm),
            critic_output_format=self.critic_output_format,
            max_rounds=self.max_rounds,
        )
