"""RAS (Retrieval-And-Structuring): plan -> retrieve -> triple graph -> answer.

Behavioral parity with the reference ``pipelines/generation/ras.py:202``
paper-protocol loop: the planner is consulted BEFORE every retrieval and
returns one action token — ``[NO_RETRIEVAL]`` (answer from parametric
knowledge; only honored before any evidence exists), ``[SUBQ] <subquery>``
(retrieve for the standalone subquery), or ``[SUFFICIENT]`` (the graph can
answer). Each retrieval's passages are structured into question-relevant
triples (``<triple>s | p | o</triple>`` per the reference
``DEFAULT_RAS_TRIPLE_PROMPT``; ``(s; p; o)`` lines also accepted) appended to
the evolving graph G_Q with per-subquery history; the final answer is
generated from the serialized graph plus that history. Trained GraphLLM/GNN
components are out of scope here as in the reference.

The port's copy of the JAX package's ``pipelines/generation/ras.py``.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Any

from autorag_research_tpu_torch.config import BasePipelineConfig
from autorag_research_tpu_torch.pipelines.generation.base import BaseGenerationPipeline, GenerationResult, select_top_evidence
from autorag_research_tpu_torch.schema import GENERATION_CONTEXT_CHUNK_ID_KEY
from autorag_research_tpu_torch.utils.tokens import TokenUsageTracker

PLAN_PROMPT = (
    "You are a Retrieval-And-Structuring (RAS) planner. Decide the next "
    "action for answering the question from an evolving graph. Return exactly "
    "one action token:\n"
    "- [NO_RETRIEVAL] to answer directly from parametric knowledge\n"
    "- [SUBQ] standalone retrieval subquery, when more evidence is needed\n"
    "- [SUFFICIENT] when the graph and history are sufficient\n\n"
    "Question: {query}\n\nCurrent graph G_Q:\n{graph}\n\n"
    "Subquery history:\n{history}\n\nNext action:"
)
TRIPLE_PROMPT = (
    "Extract question-relevant factual triples from the passages.\n"
    "Return each triple as <triple>subject | predicate | object</triple>.\n"
    "If no useful triple exists, return <none/>.\n\n"
    "Question: {query}\nSubquery: {need}\n\nPassages:\n{passages}\n\nTriples:"
)
ANSWER_PROMPT = (
    "Answer the question using only the structured graph and subquery "
    "history.\n\nStructured graph G_Q:\n{graph}\n\n"
    "Subquery-to-triples history:\n{history}\n\nQuestion: {query}\nAnswer:"
)
DIRECT_PROMPT = "Answer the question from your own knowledge.\nQuestion: {query}\nAnswer:"

_TRIPLE_TAG_RE = re.compile(r"<triple>\s*(.*?)\s*</triple>", re.IGNORECASE | re.DOTALL)
_TRIPLE_PAREN_RE = re.compile(r"\(([^;()]+);([^;()]+);([^;()]+)\)")
_SUBQ_RE = re.compile(r"\[SUBQ\]\s*(.*)", re.IGNORECASE)


def parse_plan_action(text: str) -> tuple[str, str]:
    """-> (kind in {no_retrieval, subquery, sufficient, invalid}, subquery)."""
    stripped = text.strip()
    if re.search(r"\[NO_RETRIEVAL\]", stripped, re.IGNORECASE):
        return "no_retrieval", ""
    if re.search(r"\[SUFFICIENT\]", stripped, re.IGNORECASE):
        return "sufficient", ""
    m = _SUBQ_RE.search(stripped)
    if m and m.group(1).strip():
        return "subquery", m.group(1).strip().splitlines()[0].strip()
    return "invalid", ""


def parse_triples(text: str) -> list[tuple[str, str, str]]:
    out: list[tuple[str, str, str]] = []
    for m in _TRIPLE_TAG_RE.finditer(text):
        parts = [p.strip() for p in m.group(1).split("|")]
        if len(parts) == 3 and all(parts):
            out.append((parts[0], parts[1], parts[2]))
    for m in _TRIPLE_PAREN_RE.finditer(text):
        triple = tuple(p.strip() for p in m.groups())
        if all(triple):
            out.append(triple)  # type: ignore[arg-type]
    return out


class RASPipeline(BaseGenerationPipeline):
    def __init__(
        self,
        catalog,
        name: str = "ras",
        retrieval_pipeline=None,
        llm=None,
        max_iterations: int = 3,
        per_need_k: int = 3,
    ):
        self.max_iterations = max_iterations
        self.per_need_k = per_need_k
        super().__init__(catalog, name, retrieval_pipeline, llm)

    def _get_pipeline_config(self) -> dict[str, Any]:
        return {"type": "ras", "max_iterations": self.max_iterations}

    async def _generate(self, query_id, top_k) -> GenerationResult:
        query = self.get_query_text(query_id)
        tracker = TokenUsageTracker()
        triples: list[tuple[str, str, str]] = []
        history: list[str] = []
        evidence: dict[Any, float] = {}

        async def call(prompt):
            response = await self.llm.agenerate(prompt)
            tracker.record(response)
            return response.text

        def graph_text():
            return "\n".join(f"({s} | {p} | {o})" for s, p, o in triples) or "(empty)"

        def history_text():
            return "\n".join(history) or "(none)"

        answer = None
        for it in range(self.max_iterations):
            kind, subq = parse_plan_action(
                await call(
                    PLAN_PROMPT.format(
                        query=query, graph=graph_text(), history=history_text()
                    )
                )
            )
            if kind == "no_retrieval" and it == 0 and not triples:
                # paper: direct parametric answer is only a FIRST action
                answer = (await call(DIRECT_PROMPT.format(query=query))).strip()
                break
            if kind == "sufficient":
                break
            if kind != "subquery":
                subq = query  # invalid action degrades to the main question
            hits = await self.retrieval_pipeline._retrieve_by_text(subq, self.per_need_k)
            for h in hits:
                evidence[h["doc_id"]] = max(
                    evidence.get(h["doc_id"], -1e30), float(h["score"])
                )
            passages = "\n".join(self.get_chunk_contents([h["doc_id"] for h in hits]))
            new = [
                t for t in parse_triples(
                    await call(TRIPLE_PROMPT.format(query=query, need=subq, passages=passages))
                )
                if t not in triples
            ]
            triples.extend(new)
            history.append(
                f"{subq} -> " + ("; ".join(f"({s} | {p} | {o})" for s, p, o in new) or "(no triples)")
            )

        if answer is None:
            answer = (
                await call(
                    ANSWER_PROMPT.format(
                        graph=graph_text(), history=history_text(), query=query
                    )
                )
            ).strip()

        final_ids = select_top_evidence(evidence, top_k)
        return GenerationResult(
            text=answer,
            token_usage=tracker.total,
            metadata={
                GENERATION_CONTEXT_CHUNK_ID_KEY: final_ids,
                "subquery_history": history,
                "triples": [list(t) for t in triples],
            },
            retrieved=[{"doc_id": d, "score": evidence[d]} for d in final_ids],
        )


@dataclass(kw_only=True)
class RASConfig(BasePipelineConfig):
    config_type = "ras"
    kind = "generation"

    retrieval_pipeline_name: str
    llm: Any = None
    max_iterations: int = 3
    per_need_k: int = 3

    def build(self, catalog, context):
        return RASPipeline(
            catalog,
            name=self.name,
            retrieval_pipeline=context.load_pipeline(self.retrieval_pipeline_name),
            llm=context.load_llm(self.llm),
            max_iterations=self.max_iterations,
            per_need_k=self.per_need_k,
        )
