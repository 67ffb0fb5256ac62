"""ColPali / ColQwen late-interaction VLM embedding adapters (torch).

Capability parity with the reference ``embeddings/colpali.py:56-245`` (multi-
vector) and ``embeddings/bipali.py:53-255`` (single-vector pooled variant):
local inference of ColPali-family checkpoints through the ``colpali_engine``
or plain ``transformers`` stack, producing token/patch-level embedding
matrices for the MaxSim index.

Zero-egress image: requires a *local* checkpoint directory; absent models
raise ``ModelLoadError`` with guidance. (``colpali_engine`` is not baked into
this image — the transformers path is tried as fallback.)

The port's copy of the JAX package's ``embeddings/colpali.py`` (already
torch there). The model runs on ``device``, ``"cuda"`` unless the caller
asks for another; the model registry builds it on its own device.
"""

from __future__ import annotations

import functools
import io
from typing import Sequence

import numpy as np

from autorag_research_tpu_torch.embeddings.base import BaseEmbedding, MultiVectorEmbedding
from autorag_research_tpu_torch.exceptions import ModelLoadError


@functools.lru_cache(maxsize=2)
def _load_colpali(checkpoint: str, device: str):
    try:
        from colpali_engine.models import ColPali, ColPaliProcessor  # type: ignore

        model = ColPali.from_pretrained(checkpoint, local_files_only=True).to(device).eval()
        processor = ColPaliProcessor.from_pretrained(checkpoint, local_files_only=True)
        return model, processor
    except Exception as primary:  # noqa: BLE001
        try:
            import torch  # noqa: F401
            from transformers import AutoModel, AutoProcessor

            model = AutoModel.from_pretrained(
                checkpoint, local_files_only=True, trust_remote_code=True
            ).to(device).eval()
            processor = AutoProcessor.from_pretrained(
                checkpoint, local_files_only=True, trust_remote_code=True
            )
            return model, processor
        except Exception as exc:  # noqa: BLE001
            raise ModelLoadError(
                f"cannot load ColPali checkpoint '{checkpoint}' "
                f"(colpali_engine: {primary}; transformers: {exc}); "
                "pass a local checkpoint directory"
            ) from exc


class ColPaliEmbedding(MultiVectorEmbedding):
    """Multi-vector (late interaction) ColPali adapter."""

    def __init__(
        self,
        checkpoint: str = "vidore/colpali-v1.3",
        device: str = "cuda",
        batch_size: int = 4,
    ):
        self.checkpoint = checkpoint
        self.device = str(device)
        self.batch_size = batch_size
        self.dim = 128  # ColPali projection dim

    def _forward(self, batch) -> list[np.ndarray]:
        import torch

        model, _ = _load_colpali(self.checkpoint, self.device)
        device_batch = {k: v.to(self.device) for k, v in batch.items()}
        with torch.no_grad():
            out = model(**device_batch)
        emb = out if isinstance(out, torch.Tensor) else out.last_hidden_state
        # the mask must live on the SAME device as emb (indexing a CUDA
        # tensor with a CPU mask raises); use the moved copy
        mask = device_batch.get("attention_mask")
        results = []
        for i in range(emb.shape[0]):
            row = emb[i]
            if mask is not None:
                row = row[mask[i].bool()]
            results.append(row.float().cpu().numpy())
        # the colpali_engine projection is 128-d; the AutoModel FALLBACK
        # emits backbone-width hidden states — track the real width so
        # index sizing never disagrees with the matrices
        if results and results[0].shape[-1] != self.dim:
            self.dim = int(results[0].shape[-1])
        return results

    def embed_texts_multi(self, texts: Sequence[str]) -> list[np.ndarray]:
        _, processor = _load_colpali(self.checkpoint, self.device)
        out: list[np.ndarray] = []
        for start in range(0, len(texts), self.batch_size):
            batch = processor.process_queries(list(texts[start : start + self.batch_size]))
            out.extend(self._forward(batch))
        return out

    def embed_images_multi(self, images: Sequence[bytes]) -> list[np.ndarray]:
        from PIL import Image

        _, processor = _load_colpali(self.checkpoint, self.device)
        out: list[np.ndarray] = []
        for start in range(0, len(images), self.batch_size):
            pil = [
                Image.open(io.BytesIO(b)).convert("RGB")
                for b in images[start : start + self.batch_size]
            ]
            batch = processor.process_images(pil)
            out.extend(self._forward(batch))
        return out


class BiPaliEmbedding(BaseEmbedding, ColPaliEmbedding):
    """Single-vector pooled variant (BiPali): mean over token vectors."""

    def __init__(self, checkpoint: str = "vidore/bipali", device: str = "cuda", batch_size: int = 4):
        ColPaliEmbedding.__init__(self, checkpoint, device, batch_size)

    def embed_texts(self, texts: Sequence[str]) -> np.ndarray:
        mats = self.embed_texts_multi(texts)
        return np.stack([m.mean(axis=0) for m in mats])

    def embed_images(self, images: Sequence[bytes]) -> np.ndarray:
        mats = self.embed_images_multi(images)
        return np.stack([m.mean(axis=0) for m in mats])
