"""Infinity embedding-server client (text + image, single- and multi-vector).

Capability parity with the reference ``embeddings/infinity.py:21-171``: a
remote Infinity server exposes an OpenAI-style ``/embeddings`` endpoint that
can return token-level (ColBERT-style) matrices; this client speaks that
protocol with stdlib urllib. Requires network reachability to the server.

The port's copy of the JAX package's ``embeddings/infinity.py``.
"""

from __future__ import annotations

import base64
import json
import urllib.request
from typing import Sequence

import numpy as np

from autorag_research_tpu_torch.embeddings.base import BaseEmbedding, MultiVectorEmbedding
from autorag_research_tpu_torch.exceptions import ModelLoadError


class _InfinityClient:
    def __init__(self, base_url: str = "http://localhost:7997", model: str = "", timeout: float = 60.0):
        self.base_url = base_url.rstrip("/")
        self.model = model
        self.timeout = timeout

    def _post(self, inputs, modality: str = "text"):
        body = {"model": self.model, "input": list(inputs)}
        if modality != "text":
            body["modality"] = modality
        req = urllib.request.Request(
            f"{self.base_url}/embeddings",
            data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"},
        )
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                data = json.loads(resp.read())
        except Exception as exc:  # noqa: BLE001
            raise ModelLoadError(f"infinity server call failed ({self.base_url}): {exc}") from exc
        return [np.asarray(d["embedding"], dtype=np.float32) for d in data["data"]]

    @staticmethod
    def _image_payload(images: Sequence[bytes]) -> list[str]:
        return [
            "data:image/png;base64," + base64.b64encode(b).decode() for b in images
        ]


class InfinityEmbedding(_InfinityClient, BaseEmbedding):
    def __init__(self, base_url: str = "http://localhost:7997", model: str = "", **kw):
        super().__init__(base_url, model, **kw)
        self.dim = 0  # discovered on first call

    def embed_texts(self, texts: Sequence[str]) -> np.ndarray:
        vecs = self._post(texts)
        self.dim = vecs[0].shape[-1] if vecs else self.dim
        return np.stack(vecs)

    def embed_images(self, images: Sequence[bytes]) -> np.ndarray:
        vecs = self._post(self._image_payload(images), modality="image")
        # image-only pipelines discover the dim here (embed_texts may never run)
        self.dim = vecs[0].shape[-1] if vecs else self.dim
        return np.stack(vecs)


class InfinityMultiVectorEmbedding(_InfinityClient, MultiVectorEmbedding):
    """Token-level (late interaction) mode: the server returns [T, d] lists."""

    def __init__(self, base_url: str = "http://localhost:7997", model: str = "", **kw):
        super().__init__(base_url, model, **kw)
        self.dim = 0

    def _to_matrices(self, vecs) -> list[np.ndarray]:
        mats = [np.atleast_2d(v) for v in vecs]
        self.dim = mats[0].shape[-1] if mats else self.dim
        return mats

    def embed_texts_multi(self, texts: Sequence[str]) -> list[np.ndarray]:
        return self._to_matrices(self._post(texts))

    def embed_images_multi(self, images: Sequence[bytes]) -> list[np.ndarray]:
        return self._to_matrices(self._post(self._image_payload(images), modality="image"))
