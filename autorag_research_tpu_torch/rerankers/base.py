"""Reranker protocol.

Role parity with the reference ``rerankers/base.py:12-153``:
``rerank(query, texts, top_k) -> list[RerankResult(index, text, score)]``
sorted by score desc, with async + batched wrappers. Concrete rerankers live
in ``local.py`` (offline-capable), ``llm.py`` (listwise LLM / RankGPT-style),
``hf.py`` (local HF checkpoints: cross-encoder, MonoT5, UPR), and ``api.py``
(Cohere/Jina/Voyage/Mixedbread HTTP, egress-gated).

The port's copy of the JAX package's ``rerankers/base.py``: the same
``_finalize`` order, ``(-score, index)``.
"""

from __future__ import annotations

import asyncio
from abc import ABC, abstractmethod
from dataclasses import dataclass
from typing import Sequence


@dataclass
class RerankResult:
    index: int  # position in the input texts list
    text: str
    score: float


class BaseReranker(ABC):
    model_name: str = "base"

    @abstractmethod
    def rerank(
        self, query: str, texts: Sequence[str], top_k: int | None = None
    ) -> list[RerankResult]:
        """Score texts against the query; return sorted desc, truncated to top_k."""

    async def arerank(
        self, query: str, texts: Sequence[str], top_k: int | None = None
    ) -> list[RerankResult]:
        return await asyncio.to_thread(self.rerank, query, list(texts), top_k)

    async def arerank_batch(
        self,
        queries: Sequence[str],
        texts_per_query: Sequence[Sequence[str]],
        top_k: int | None = None,
        max_concurrency: int = 8,
    ) -> list[list[RerankResult]]:
        semaphore = asyncio.Semaphore(max_concurrency)

        async def one(q, texts):
            async with semaphore:
                return await self.arerank(q, texts, top_k)

        return await asyncio.gather(
            *[one(q, t) for q, t in zip(queries, texts_per_query)]
        )

    @staticmethod
    def _finalize(
        scored: list[tuple[int, str, float]], top_k: int | None
    ) -> list[RerankResult]:
        scored.sort(key=lambda t: (-t[2], t[0]))
        if top_k is not None:
            scored = scored[:top_k]
        return [RerankResult(i, t, s) for i, t, s in scored]
