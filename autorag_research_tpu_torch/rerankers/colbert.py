"""ColBERT late-interaction reranker.

Capability parity with the reference ``rerankers/colbert.py``: token-level
query/passage embeddings scored with MaxSim. Any ``MultiVectorEmbedding``
adapter works — the native encoder gives a fully offline on-device path, and
ColPali/Infinity adapters plug in for trained checkpoints.

The port's copy of the JAX package's ``rerankers/colbert.py``: host numpy
MaxSim over a ``MultiVectorEmbedding`` (``torch_encoder`` with
``multi_vector: true`` in the port). It reaches no MaxSim kernel, as the JAX
reranker reaches none.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from autorag_research_tpu_torch.rerankers.base import BaseReranker


class ColBERTReranker(BaseReranker):
    def __init__(self, embedding_model):
        """embedding_model: a MultiVectorEmbedding (token-level) adapter."""
        self.embedding_model = embedding_model
        self.model_name = f"colbert({type(embedding_model).__name__})"

    def rerank(self, query: str, texts: Sequence[str], top_k: int | None = None):
        if not texts:
            return []
        q = np.asarray(self.embedding_model.embed_query_multi(query), np.float32)
        qn = q / np.maximum(np.linalg.norm(q, axis=-1, keepdims=True), 1e-12)
        doc_mats = self.embedding_model.embed_texts_multi(list(texts))
        scored = []
        for i, (text, mat) in enumerate(zip(texts, doc_mats)):
            mat = np.asarray(mat, np.float32)
            if mat.size == 0:
                scored.append((i, text, 0.0))
                continue
            mn = mat / np.maximum(np.linalg.norm(mat, axis=-1, keepdims=True), 1e-12)
            sims = qn @ mn.T  # [Tq, Td]
            scored.append((i, text, float(sims.max(axis=1).mean())))
        return self._finalize(scored, top_k)
