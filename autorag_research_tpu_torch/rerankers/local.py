"""Offline-capable rerankers.

The port's copy of the JAX package's ``rerankers/local.py``: host numpy over
any embedding adapter.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from autorag_research_tpu_torch.rerankers.base import BaseReranker, RerankResult


class EmbeddingSimilarityReranker(BaseReranker):
    """Cosine-similarity rerank with any embedding adapter — the offline
    bi-encoder analogue of the reference's sentence_transformer reranker
    (``rerankers/sentence_transformer.py``)."""

    def __init__(self, embedding_model):
        self.embedding_model = embedding_model
        self.model_name = f"embedding_similarity({type(embedding_model).__name__})"

    def rerank(self, query: str, texts: Sequence[str], top_k: int | None = None):
        if not texts:
            return []
        q = np.asarray(self.embedding_model.embed_query(query), np.float64)
        t = np.asarray(self.embedding_model.embed_texts(list(texts)), np.float64)
        qn = q / (np.linalg.norm(q) or 1.0)
        tn = t / np.maximum(np.linalg.norm(t, axis=1, keepdims=True), 1e-12)
        scores = tn @ qn
        return self._finalize(
            [(i, text, float(s)) for i, (text, s) in enumerate(zip(texts, scores))],
            top_k,
        )


class MockReranker(BaseReranker):
    """Deterministic test reranker: score = token overlap with the query."""

    model_name = "mock"

    def rerank(self, query: str, texts: Sequence[str], top_k: int | None = None):
        q_tokens = set(query.lower().split())
        scored = []
        for i, text in enumerate(texts):
            overlap = len(q_tokens & set(text.lower().split()))
            scored.append((i, text, float(overlap)))
        return self._finalize(scored, top_k)
