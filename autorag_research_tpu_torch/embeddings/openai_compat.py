"""OpenAI-compatible embeddings API adapter (openai / together / ollama /
vllm / jina / any ``/embeddings`` endpoint).

Capability parity with the reference's remote embedding presets
(``configs/embedding/openai-{small,large}.yaml``, ``openai-like.yaml``,
``together.yaml``, ``ollama.yaml``, ``vllm.yaml``, ``jina.yaml`` — all
LangChain ``OpenAIEmbeddings``-shaped clients, injected via reference
``injection.py:86-225``). Implemented over the REST ``POST /embeddings``
API with stdlib urllib; a ``transport`` callable ``(url, body, headers,
timeout) -> dict`` is injectable so tests (and proxies / recorded fixtures)
replace the HTTP layer — the environment is egress-blocked, so live calls
are exercised only through mock transports.

The port's copy of the JAX package's ``embeddings/openai_compat.py``.
"""

from __future__ import annotations

import json
import os
import urllib.request
from typing import Callable, Sequence

import numpy as np

from autorag_research_tpu_torch.embeddings.base import BaseEmbedding
from autorag_research_tpu_torch.exceptions import LLMError

Transport = Callable[[str, dict, dict, float], dict]


def _urllib_transport(url: str, body: dict, headers: dict, timeout: float = 120.0) -> dict:
    req = urllib.request.Request(url, data=json.dumps(body).encode(), headers=headers)
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read())


class OpenAICompatEmbedding(BaseEmbedding):
    """Single-vector embeddings over an OpenAI-compatible REST endpoint."""

    def __init__(
        self,
        model: str = "text-embedding-3-small",
        base_url: str = "https://api.openai.com/v1",
        api_key: str | None = None,
        api_key_env: str = "OPENAI_API_KEY",
        dimensions: int | None = None,
        batch_size: int = 256,
        timeout: float = 120.0,
        transport: Transport | None = None,
    ):
        self.model_name = model
        self.base_url = base_url.rstrip("/")
        self.api_key = api_key or os.environ.get(api_key_env, "")
        self.dimensions = dimensions
        self.batch_size = batch_size
        self.timeout = timeout
        self.transport = transport or _urllib_transport
        self.dim = dimensions or 0  # discovered on first call when not pinned

    def _post_batch(self, texts: list[str]) -> list[np.ndarray]:
        body: dict = {"model": self.model_name, "input": texts}
        if self.dimensions:
            body["dimensions"] = self.dimensions
        headers = {"Content-Type": "application/json"}
        if self.api_key:
            headers["Authorization"] = f"Bearer {self.api_key}"
        try:
            data = self.transport(
                f"{self.base_url}/embeddings", body, headers, self.timeout
            )
        except Exception as exc:  # noqa: BLE001
            raise LLMError(f"{self.model_name} embeddings call failed: {exc}") from exc
        rows = data.get("data")
        if not rows:
            err = data.get("error") or data
            raise LLMError(f"{self.model_name}: no embeddings in response: {err}")
        # the API may return rows out of order; 'index' is authoritative
        out: list[np.ndarray | None] = [None] * len(texts)
        for i, row in enumerate(rows):
            vec = np.asarray(row["embedding"], dtype=np.float32)
            out[int(row.get("index", i))] = vec
        missing = [i for i, v in enumerate(out) if v is None]
        if missing:
            raise LLMError(f"{self.model_name}: response missing rows {missing[:5]}")
        return out  # type: ignore[return-value]

    def embed_texts(self, texts: Sequence[str]) -> np.ndarray:
        vecs: list[np.ndarray] = []
        texts = list(texts)
        for lo in range(0, len(texts), self.batch_size):
            vecs.extend(self._post_batch(texts[lo : lo + self.batch_size]))
        if vecs:
            self.dim = int(vecs[0].shape[-1])
        return np.stack(vecs) if vecs else np.zeros((0, self.dim), np.float32)
