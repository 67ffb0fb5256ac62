"""ET2RAG: test-time majority voting over context subsets.

Behavioral parity with the reference ``pipelines/generation/et2rag.py:111``:

1. organize retrieved docs into subsets by strategy —
   ``qa`` (top1 alone, then top1 + one other: factoid QA keeps the best hit),
   ``recipe`` (one self-contained doc per subset),
   ``image`` (consecutive pairs over the top-20, subsets = combinations of two
   pairs — the paper's Table-2 schedule), or ``random`` (seeded sampling, this
   framework's original variant);
2. generate a PARTIAL answer per subset concurrently (reference ``:279+``);
3. vote: with an embedding model, pick the subset whose partial answer has the
   highest mean cosine similarity to the others (semantic consistency voting,
   reference's embedding-similarity selection); otherwise fall back to a
   normalized-string majority vote;
4. generate the FULL answer from the winning subset (reference step 7).

The port's copy of the JAX package's ``pipelines/generation/et2rag.py``.
"""

from __future__ import annotations

import asyncio
import random
from collections import Counter
from dataclasses import dataclass
from itertools import combinations
from typing import Any

import numpy as np

from autorag_research_tpu_torch.config import BasePipelineConfig
from autorag_research_tpu_torch.evaluation.metrics.generation import normalize_string
from autorag_research_tpu_torch.pipelines.generation.base import BaseGenerationPipeline, GenerationResult
from autorag_research_tpu_torch.schema import GENERATION_CONTEXT_CHUNK_ID_KEY
from autorag_research_tpu_torch.utils.tokens import TokenUsageTracker

ORGANIZATION_STRATEGIES = ("qa", "recipe", "image", "random")

PARTIAL_PROMPT = (
    "Answer the question using only this context.\n\nContext:\n{context}\n\n"
    "Question: {query}\nGive a short, direct answer.\nAnswer:"
)

FULL_PROMPT = (
    "Answer the question using the context. Be complete and accurate.\n\n"
    "Context:\n{context}\n\nQuestion: {query}\nAnswer:"
)


def make_subsets(
    docs: list[tuple[Any, str]],
    strategy: str,
    num_subsets: int | None,
    subset_size: int | None,
    rng: random.Random,
) -> list[list[tuple[Any, str]]]:
    """Reference subset schedules (``_create_qa/recipe/image_subsets``)."""
    if not docs:
        return []
    if strategy == "qa":
        n = num_subsets or min(len(docs), 5)
        subsets = [[docs[0]]]
        for i in range(1, min(n, len(docs))):
            subsets.append([docs[0], docs[i]])
        return subsets
    if strategy == "recipe":
        n = num_subsets or min(len(docs), 5)
        return [[d] for d in docs[:n]]
    if strategy == "image":
        top = docs[:20]
        n = num_subsets or 5
        pairs = [[top[i], top[i + 1]] for i in range(0, len(top) - 1, 2)]
        if not pairs:
            return [top[:1]]
        subsets = []
        for i, j in combinations(range(len(pairs)), 2):
            subsets.append(pairs[i] + pairs[j])
            if len(subsets) >= n:
                break
        return subsets or [pairs[0]]
    # "random": top-ranked subset always included, the rest seeded samples
    n = num_subsets or 5
    size = subset_size or max(1, len(docs) // 2)
    subsets = [docs[:size]]
    for _ in range(n - 1):
        subsets.append(rng.sample(docs, min(size, len(docs))))
    return subsets


def similarity_vote(answers: list[str], embedding_model) -> int:
    """Semantic-consistency vote: index of the answer with the highest mean
    cosine similarity to the other answers (the reference's embedding vote)."""
    vecs = np.asarray(embedding_model.embed_texts(answers), np.float32)
    norms = np.linalg.norm(vecs, axis=1, keepdims=True)
    vecs = vecs / np.where(norms == 0, 1.0, norms)
    sims = vecs @ vecs.T
    np.fill_diagonal(sims, 0.0)
    mean_sim = sims.sum(axis=1) / max(len(answers) - 1, 1)
    return int(np.argmax(mean_sim))  # ties -> lower index = higher-ranked subset


class ET2RAGPipeline(BaseGenerationPipeline):
    def __init__(
        self,
        catalog,
        name: str = "et2rag",
        retrieval_pipeline=None,
        llm=None,
        embedding_model=None,
        organization_strategy: str = "qa",
        num_subsets: int | None = 5,
        subset_size: int | None = None,
        seed: int = 42,
    ):
        if organization_strategy not in ORGANIZATION_STRATEGIES:
            raise ValueError(
                f"unknown organization_strategy '{organization_strategy}' "
                f"(one of {ORGANIZATION_STRATEGIES})"
            )
        self.embedding_model = embedding_model
        self.organization_strategy = organization_strategy
        self.num_subsets = num_subsets
        self.subset_size = subset_size
        self.seed = seed
        super().__init__(catalog, name, retrieval_pipeline, llm)

    def _get_pipeline_config(self) -> dict[str, Any]:
        return {
            "type": "et2rag",
            "organization_strategy": self.organization_strategy,
            "num_subsets": self.num_subsets,
            "subset_size": self.subset_size,
        }

    async def _generate(self, query_id, top_k) -> GenerationResult:
        query = self.get_query_text(query_id)
        tracker = TokenUsageTracker()
        hits = await self.retrieve_for(query_id, top_k)
        ids = [h["doc_id"] for h in hits]
        lookup = self.catalog.get_chunk_contents(ids)
        docs = [(h["doc_id"], lookup[h["doc_id"]]) for h in hits if h["doc_id"] in lookup]
        if not docs:
            response = await self.llm.agenerate(
                FULL_PROMPT.format(context="(none)", query=query)
            )
            tracker.record(response)
            return GenerationResult(
                response.text.strip(),
                tracker.total,
                {GENERATION_CONTEXT_CHUNK_ID_KEY: [], "num_subsets": 0,
                 "selected_subset_index": -1},
            )

        rng = random.Random(f"{self.seed}:{query_id}")
        subsets = make_subsets(
            docs, self.organization_strategy, self.num_subsets, self.subset_size, rng
        )

        semaphore = asyncio.Semaphore(8)

        async def partial(subset):
            context = "\n".join(text for _, text in subset)
            async with semaphore:
                response = await self.llm.agenerate(
                    PARTIAL_PROMPT.format(context=context, query=query)
                )
            tracker.record(response)
            return response.text.strip()

        answers = await asyncio.gather(*[partial(s) for s in subsets])
        if self.embedding_model is not None and len(answers) > 1:
            # the embedding model is synchronous (device round-trip):
            # off-thread it so concurrently running queries' LLM I/O on this
            # event loop is not frozen for the duration
            winner = await asyncio.to_thread(
                similarity_vote, answers, self.embedding_model
            )
            votes: dict[str, int] = {}
        else:
            counts = Counter(normalize_string(a) for a in answers)
            top_norm, _ = max(counts.items(), key=lambda kv: kv[1])
            winner = next(
                i for i, a in enumerate(answers) if normalize_string(a) == top_norm
            )
            votes = dict(counts)

        chosen = subsets[winner]
        response = await self.llm.agenerate(
            FULL_PROMPT.format(
                context="\n".join(text for _, text in chosen), query=query
            )
        )
        tracker.record(response)
        return GenerationResult(
            text=response.text.strip(),
            token_usage=tracker.total,
            metadata={
                GENERATION_CONTEXT_CHUNK_ID_KEY: [d for d, _ in chosen],
                "num_subsets": len(subsets),
                "selected_subset_index": winner,
                "votes": votes,
                "candidate_answers": list(answers),
            },
            retrieved=hits,
        )


@dataclass(kw_only=True)
class ET2RAGConfig(BasePipelineConfig):
    config_type = "et2rag"
    kind = "generation"

    retrieval_pipeline_name: str
    llm: Any = None
    embedding_model: Any = None
    organization_strategy: str = "qa"
    num_subsets: int | None = 5
    subset_size: int | None = None

    def build(self, catalog, context):
        return ET2RAGPipeline(
            catalog,
            name=self.name,
            retrieval_pipeline=context.load_pipeline(self.retrieval_pipeline_name),
            llm=context.load_llm(self.llm),
            embedding_model=context.load_embedding(self.embedding_model),
            organization_strategy=self.organization_strategy,
            num_subsets=self.num_subsets,
            subset_size=self.subset_size,
        )
