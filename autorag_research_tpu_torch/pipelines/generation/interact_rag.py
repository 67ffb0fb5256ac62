"""InteractRAG: LLM drives corpus-interaction primitives.

Behavioral parity with the reference ``pipelines/generation/interact_rag.py:276``
(paper primitives, reference ``:36-40`` and prompt ``:78-84``): the agent
loops over structured commands against the corpus —

- ``dense(query)`` / ``sparse(query)``: semantic vs exact search;
- ``fusion(query)`` or ``fusion(query, semantic=0.6, exact=0.4)``:
  score-normalized weighted sum over the top-20 of each engine (paper
  Appendix C.2; reference ``:136``);
- ``entity(term)``: exact entity lookup returning the three snippets most
  related to the original question (reference ``:81``);
- ``include(id_or_term)`` / ``exclude(id_or_term)``: pin or drop evidence by
  chunk id (reference semantics, ``:82-83``) — a non-id argument filters by
  substring as a convenience extension;
- ``scale(n)``: adjust retrieval scale, capped at ``max_scale``
  (reference ``:246``);
- ``answer(final)``: terminate.

The port's copy of the JAX package's ``pipelines/generation/interact_rag.py``.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Any

from autorag_research_tpu_torch.config import BasePipelineConfig
from autorag_research_tpu_torch.ops.fusion import cc_fuse
from autorag_research_tpu_torch.pipelines.generation.base import BaseGenerationPipeline, GenerationResult, select_top_evidence
from autorag_research_tpu_torch.schema import GENERATION_CONTEXT_CHUNK_ID_KEY
from autorag_research_tpu_torch.utils.tokens import TokenUsageTracker

COMMAND_PROMPT = (
    "You explore a corpus with commands to gather evidence for the question.\n"
    "Commands: dense(text) | sparse(text) | "
    "fusion(text[, semantic=0.6, exact=0.4]) | entity(term) | "
    "include(chunk_id) | exclude(chunk_id) | scale(n) | answer(final answer)\n"
    "Current working set ({n_docs} docs):\n{working_set}\n\n"
    "Question: {query}\nInteraction log:\n{log}\n\nNext command:"
)

_CMD_RE = re.compile(r"(dense|sparse|fusion|entity|include|exclude|scale|answer)\s*\(\s*(.*?)\s*\)\s*$", re.DOTALL | re.IGNORECASE)
_FUSION_W_RE = re.compile(r"semantic\s*=\s*([0-9.]+)\s*,?\s*exact\s*=\s*([0-9.]+)", re.IGNORECASE)


def _parse_fusion_arg(arg: str) -> tuple[str, float, float]:
    """'query, semantic=0.6, exact=0.4' -> ('query', 0.6, 0.4); default 0.5/0.5."""
    m = _FUSION_W_RE.search(arg)
    if m:
        text = arg[: m.start()].rstrip(" ,")
        return text, float(m.group(1)), float(m.group(2))
    return arg, 0.5, 0.5


def _coerce_id(arg: str, working: dict, catalog):
    """Interpret the argument as a chunk id when possible (reference
    include/exclude operate on displayed-evidence IDs)."""
    arg = arg.strip()
    for candidate in (arg, int(arg) if arg.lstrip("-").isdigit() else None):
        if candidate is None:
            continue
        if candidate in working:
            return candidate
        if catalog.get_chunk_contents([candidate]).get(candidate) is not None:
            return candidate
    return None


class InteractRAGPipeline(BaseGenerationPipeline):
    def __init__(
        self,
        catalog,
        name: str = "interact_rag",
        retrieval_pipeline=None,  # dense leg
        sparse_retrieval_pipeline=None,
        llm=None,
        max_turns: int = 6,
        max_scale: int = 20,
    ):
        self.sparse_pipeline = sparse_retrieval_pipeline
        self.max_turns = max_turns
        self.max_scale = max_scale
        super().__init__(catalog, name, retrieval_pipeline, llm)

    def _get_pipeline_config(self) -> dict[str, Any]:
        return {
            "type": "interact_rag",
            "max_turns": self.max_turns,
            "max_scale": self.max_scale,
        }

    async def _generate(self, query_id, top_k) -> GenerationResult:
        query = self.get_query_text(query_id)
        tracker = TokenUsageTracker()
        k = top_k
        working: dict[Any, float] = {}
        log: list[str] = []
        answer = None

        def lookup(ids):
            return self.catalog.get_chunk_contents(list(ids))

        async def dense(q):
            return await self.retrieval_pipeline._retrieve_by_text(q, k)

        async def sparse(q):
            pipe = self.sparse_pipeline or self.retrieval_pipeline
            return await pipe._retrieve_by_text(q, k)

        for _ in range(self.max_turns):
            contents = lookup(working)
            ws = "\n".join(
                f"- {contents[d][:150]}" for d in list(working)[:10] if d in contents
            ) or "(empty)"
            response = await self.llm.agenerate(
                COMMAND_PROMPT.format(
                    n_docs=len(working), working_set=ws, query=query, log="\n".join(log) or "(none)"
                )
            )
            tracker.record(response)
            m = _CMD_RE.search(response.text.strip())
            if m is None:
                log.append(f"unparsed: {response.text.strip()[:80]}")
                continue
            cmd, arg = m.group(1).lower(), m.group(2)
            log.append(f"{cmd}({arg[:60]})")
            if cmd == "answer":
                answer = arg.strip()
                break
            if cmd == "scale":
                try:
                    k = max(1, min(self.max_scale, int(re.sub(r"\D", "", arg) or k)))
                except ValueError:
                    pass
                continue
            if cmd in ("dense", "sparse", "fusion"):
                if cmd == "fusion":
                    text_arg, sem_w, ex_w = _parse_fusion_arg(arg)
                    # paper Appendix C.2: normalize each engine's top-20 then
                    # weighted-sum (cc with mm normalization)
                    d_hits = await self.retrieval_pipeline._retrieve_by_text(text_arg, 20)
                    s_pipe = self.sparse_pipeline or self.retrieval_pipeline
                    s_hits = await s_pipe._retrieve_by_text(text_arg, 20)
                    weight = sem_w / max(sem_w + ex_w, 1e-9)
                    hits = cc_fuse(
                        d_hits, s_hits, weight=weight, top_k=k, normalize_method="mm"
                    )
                else:
                    hits = await (dense(arg) if cmd == "dense" else sparse(arg))
                for h in hits:
                    working[h["doc_id"]] = max(
                        working.get(h["doc_id"], -1e30), float(h["score"])
                    )
            elif cmd == "entity":
                # catalog helper escapes LIKE wildcards (the entity term is
                # LLM-controlled — 'entity(%)' must not match every chunk)
                match_ids = self.catalog.find_chunks_by_contents(arg, limit=20)
                # the three snippets most related to the QUESTION (not the
                # entity term) — rank matches by the exact engine's scores
                if len(match_ids) > 3:
                    s_pipe = self.sparse_pipeline or self.retrieval_pipeline
                    q_hits = await s_pipe._retrieve_by_text(query, 100)
                    rank = {h["doc_id"]: i for i, h in enumerate(q_hits)}
                    match_ids.sort(key=lambda d: rank.get(d, len(rank)))
                for did in match_ids[:3]:
                    working.setdefault(did, 0.0)
            elif cmd in ("include", "exclude"):
                target_id = _coerce_id(arg, working, self.catalog)
                if target_id is not None:
                    if cmd == "include":
                        row = self.catalog.get_chunk_contents([target_id])
                        if row:
                            working[target_id] = max(working.get(target_id, 0.0), 0.0)
                    else:
                        working.pop(target_id, None)
                else:  # substring-filter convenience extension
                    contents = lookup(working)
                    term = arg.lower()
                    working = {
                        d: s
                        for d, s in working.items()
                        if d in contents
                        and ((term in contents[d].lower()) == (cmd == "include"))
                    }

        final_ids = select_top_evidence(working, top_k)
        if answer is None:
            context = "\n".join(lookup(final_ids).values())
            response = await self.llm.agenerate(
                f"Answer the question using the evidence.\n\nEvidence:\n{context}\n\n"
                f"Question: {query}\nAnswer:"
            )
            tracker.record(response)
            answer = response.text.strip()

        return GenerationResult(
            text=answer,
            token_usage=tracker.total,
            metadata={
                GENERATION_CONTEXT_CHUNK_ID_KEY: final_ids,
                "interaction_log": log,
            },
            retrieved=[{"doc_id": d, "score": working[d]} for d in final_ids],
        )


@dataclass(kw_only=True)
class InteractRAGConfig(BasePipelineConfig):
    config_type = "interact_rag"
    kind = "generation"

    retrieval_pipeline_name: str
    sparse_retrieval_pipeline_name: str | None = None
    llm: Any = None
    max_turns: int = 6
    max_scale: int = 20

    def build(self, catalog, context):
        sparse = (
            context.load_pipeline(self.sparse_retrieval_pipeline_name)
            if self.sparse_retrieval_pipeline_name
            else None
        )
        return InteractRAGPipeline(
            catalog,
            name=self.name,
            retrieval_pipeline=context.load_pipeline(self.retrieval_pipeline_name),
            sparse_retrieval_pipeline=sparse,
            llm=context.load_llm(self.llm),
            max_turns=self.max_turns,
            max_scale=self.max_scale,
        )
