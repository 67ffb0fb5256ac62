"""HTTP API rerankers (Cohere / Jina / Voyage / Mixedbread).

Capability parity with the reference's API rerankers (``rerankers/cohere.py``,
``jina.py``, ``voyageai.py``, ``mixedbreadai.py``), implemented over the
providers' public REST rerank endpoints with stdlib urllib (no SDKs in this
image). Requires network egress + an API key; errors surface as LLMError.

The port's copy of the JAX package's ``rerankers/api.py``: the same request
bodies and endpoints.
"""

from __future__ import annotations

import json
import os
import urllib.request
from typing import Sequence

from autorag_research_tpu_torch.exceptions import LLMError
from autorag_research_tpu_torch.rerankers.base import BaseReranker


class _RestReranker(BaseReranker):
    endpoint: str
    key_env: str
    provider: str
    # provider API dialect: Cohere/Jina take "documents"/"top_n", Voyage
    # takes "documents"/"top_k", Mixedbread takes "input"/"top_k"
    docs_param: str = "documents"
    top_k_param: str = "top_n"

    def __init__(self, model: str, api_key: str | None = None, timeout: float = 60.0):
        self.model = model
        self.api_key = api_key or os.environ.get(self.key_env)
        self.timeout = timeout
        self.model_name = f"{self.provider}({model})"

    def _post(self, payload: dict) -> dict:
        if not self.api_key:
            raise LLMError(f"{self.provider}: no API key (set {self.key_env})")
        req = urllib.request.Request(
            self.endpoint,
            data=json.dumps(payload).encode(),
            headers={
                "Content-Type": "application/json",
                "Authorization": f"Bearer {self.api_key}",
            },
        )
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                return json.loads(resp.read())
        except Exception as exc:  # noqa: BLE001
            raise LLMError(f"{self.provider} rerank call failed: {exc}") from exc

    def rerank(self, query: str, texts: Sequence[str], top_k: int | None = None):
        data = self._post(
            {
                "model": self.model,
                "query": query,
                self.docs_param: list(texts),
                self.top_k_param: top_k or len(texts),
            }
        )
        results = data.get("results", data.get("data", []))
        scored = [
            (int(r["index"]), texts[int(r["index"])], float(r.get("relevance_score", r.get("score", 0.0))))
            for r in results
        ]
        return self._finalize(scored, top_k)


class CohereReranker(_RestReranker):
    endpoint = "https://api.cohere.com/v2/rerank"
    key_env = "COHERE_API_KEY"
    provider = "cohere"

    def __init__(self, model: str = "rerank-v3.5", **kw):
        super().__init__(model, **kw)


class JinaReranker(_RestReranker):
    endpoint = "https://api.jina.ai/v1/rerank"
    key_env = "JINA_API_KEY"
    provider = "jina"

    def __init__(self, model: str = "jina-reranker-v2-base-multilingual", **kw):
        super().__init__(model, **kw)


class VoyageReranker(_RestReranker):
    endpoint = "https://api.voyageai.com/v1/rerank"
    key_env = "VOYAGE_API_KEY"
    provider = "voyageai"
    top_k_param = "top_k"

    def __init__(self, model: str = "rerank-2", **kw):
        super().__init__(model, **kw)


class MixedbreadReranker(_RestReranker):
    endpoint = "https://api.mixedbread.com/v1/reranking"
    key_env = "MXBAI_API_KEY"
    provider = "mixedbreadai"
    docs_param = "input"
    top_k_param = "top_k"

    def __init__(self, model: str = "mixedbread-ai/mxbai-rerank-large-v1", **kw):
        super().__init__(model, **kw)
