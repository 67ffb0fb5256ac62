"""Embedding model adapters.

Role parity with the reference's LangChain-based embedding bases
(``embeddings/base.py:12-137``): a single-vector interface (text + optional
image) and a multi-vector (late interaction / ColBERT-ColPali style)
interface. This framework's adapters return numpy arrays directly — the index
builder consumes ``[N, d]`` float32 — and the batched encoder in ``models/``
implements the same interface for on-device inference.

``MockEmbedding`` replaces the reference's random-vector test fake
(``tests/mock.py:5-19``) but is *deterministic per text* (hash-seeded) so
retrieval results are reproducible across processes.
"""

from __future__ import annotations

import asyncio
import hashlib
from abc import ABC, abstractmethod
from typing import Sequence

import numpy as np


class BaseEmbedding(ABC):
    """Single-vector embedding model."""

    dim: int

    @abstractmethod
    def embed_texts(self, texts: Sequence[str]) -> np.ndarray:
        """Batch-embed texts -> [N, dim] float32."""

    def embed_query(self, text: str) -> np.ndarray:
        return self.embed_texts([text])[0]

    def embed_images(self, images: Sequence[bytes]) -> np.ndarray:
        raise NotImplementedError(f"{type(self).__name__} does not embed images")

    async def aembed_texts(self, texts: Sequence[str]) -> np.ndarray:
        return await asyncio.to_thread(self.embed_texts, list(texts))

    async def aembed_query(self, text: str) -> np.ndarray:
        return (await self.aembed_texts([text]))[0]

    def health_check(self) -> int:
        """Probe the model; returns the embedding dim (reference
        ``injection.py:24-83`` health-check pattern)."""
        vec = self.embed_query("health check")
        return int(np.asarray(vec).shape[-1])


class MultiVectorEmbedding(ABC):
    """Multi-vector (late interaction) embedding model: one [T, dim] matrix
    per input, T varies per input."""

    dim: int

    @abstractmethod
    def embed_texts_multi(self, texts: Sequence[str]) -> list[np.ndarray]:
        """Batch-embed texts -> list of [T_i, dim] float32 matrices."""

    def embed_query_multi(self, text: str) -> np.ndarray:
        return self.embed_texts_multi([text])[0]

    def embed_images_multi(self, images: Sequence[bytes]) -> list[np.ndarray]:
        raise NotImplementedError(f"{type(self).__name__} does not embed images")

    async def aembed_texts_multi(self, texts: Sequence[str]) -> list[np.ndarray]:
        return await asyncio.to_thread(self.embed_texts_multi, list(texts))

    def health_check(self) -> int:
        mat = self.embed_query_multi("health check")
        return int(np.asarray(mat).shape[-1])


def _hash_vec(text: str, dim: int, salt: str = "") -> np.ndarray:
    seed = int.from_bytes(
        hashlib.sha256((salt + text).encode("utf-8")).digest()[:8], "little"
    )
    rng = np.random.default_rng(seed)
    v = rng.normal(size=dim).astype(np.float32)
    return v / np.linalg.norm(v)


class MockEmbedding(BaseEmbedding):
    """Deterministic hash-seeded embedding for tests and dry runs."""

    def __init__(self, dim: int = 64):
        self.dim = dim

    def embed_texts(self, texts: Sequence[str]) -> np.ndarray:
        return np.stack([_hash_vec(t, self.dim) for t in texts])

    def embed_images(self, images: Sequence[bytes]) -> np.ndarray:
        return np.stack(
            [_hash_vec(hashlib.sha256(b).hexdigest(), self.dim, "img:") for b in images]
        )


class MockMultiVectorEmbedding(MultiVectorEmbedding):
    """Deterministic multi-vector mock: one vector per whitespace token
    (capped), mimicking token-level late-interaction embeddings."""

    def __init__(self, dim: int = 64, max_tokens: int = 16):
        self.dim = dim
        self.max_tokens = max_tokens

    def embed_texts_multi(self, texts: Sequence[str]) -> list[np.ndarray]:
        out = []
        for t in texts:
            tokens = t.split()[: self.max_tokens] or [t]
            out.append(np.stack([_hash_vec(tok, self.dim, f"tok{i}:") for i, tok in enumerate(tokens)]))
        return out

    def embed_images_multi(self, images: Sequence[bytes]) -> list[np.ndarray]:
        out = []
        for b in images:
            h = hashlib.sha256(b).hexdigest()
            out.append(np.stack([_hash_vec(h, self.dim, f"patch{i}:") for i in range(self.max_tokens)]))
        return out
