"""On-GPU embedding adapter backed by the native PyTorch encoder.

Counterpart of ``autorag_research_tpu/embeddings/jax_encoder.py``: bridges
``models/encoder.py`` into the embedding protocol so index builds and query
batches run batched inference on the device. Works offline with hash-bucket
tokenization and seeded random init; ``params_path`` loads an ``.npz`` of
flattened parameters as the JAX package's ``save_params`` writes it, giving
identical weights.
"""

from __future__ import annotations

from pathlib import Path
from typing import Sequence

import numpy as np
import torch

from autorag_research_tpu_torch.embeddings.base import BaseEmbedding, MultiVectorEmbedding
from autorag_research_tpu_torch.models.encoder import (
    EncoderConfig,
    RetrievalEncoder,
    from_jax_params,
    hash_tokenize,
)


def load_params(path: str | Path) -> dict[str, torch.Tensor]:
    """State dict from a flattened-parameter ``.npz``."""
    with np.load(path) as data:
        return from_jax_params({name: data[name] for name in data.files})


class _EncoderBase:
    def __init__(
        self,
        config: EncoderConfig | None = None,
        params_path: str | Path | None = None,
        seed: int = 0,
        batch_size: int = 256,
        device: str | torch.device = "cuda",
    ):
        self.config = config or EncoderConfig()
        self.device = torch.device(device)
        self.encoder = RetrievalEncoder(self.config, device=self.device, seed=seed).eval()
        if params_path is not None:
            self.encoder.load_state_dict(load_params(params_path))
        self.batch_size = batch_size
        self.dim = self.config.out_dim

    @torch.inference_mode()
    def _forward_batches(self, texts: Sequence[str]) -> list[tuple[torch.Tensor, np.ndarray]]:
        outs = []
        for start in range(0, len(texts), self.batch_size):
            chunk = list(texts[start : start + self.batch_size])
            ids, mask = hash_tokenize(chunk, self.config.vocab_size, self.config.max_len)
            emb = self.encoder(
                torch.from_numpy(ids).to(self.device, torch.int64),
                torch.from_numpy(mask).to(self.device),
            )
            outs.append((emb, mask))
        return outs

    def _encode(self, texts: Sequence[str]) -> np.ndarray | list[np.ndarray]:
        outs = [(e.float().cpu().numpy(), m) for e, m in self._forward_batches(texts)]
        if self.config.multi_vector:
            return [row[row_mask] for emb, mask in outs for row, row_mask in zip(emb, mask)]
        return np.concatenate([e for e, _ in outs])


class TorchEncoderEmbedding(_EncoderBase, BaseEmbedding):
    """Single-vector on-device embedder."""

    def __init__(self, config: EncoderConfig | None = None, **kw):
        config = config or EncoderConfig(multi_vector=False)
        if config.multi_vector:
            raise ValueError("TorchEncoderEmbedding needs a single-vector config")
        super().__init__(config, **kw)

    def embed_texts(self, texts: Sequence[str]) -> np.ndarray:
        return self._encode(texts)  # type: ignore[return-value]

    def embed_texts_device(self, texts: Sequence[str]) -> torch.Tensor:
        """Serving hot path: embeddings stay on the device, so the caller
        chains the retrieval kernels without a device -> host copy."""
        embs = [e for e, _ in self._forward_batches(texts)]
        return embs[0] if len(embs) == 1 else torch.cat(embs)


class TorchEncoderMultiVectorEmbedding(_EncoderBase, MultiVectorEmbedding):
    """Token-level (late interaction) on-device embedder."""

    def __init__(self, config: EncoderConfig | None = None, **kw):
        config = config or EncoderConfig(multi_vector=True)
        if not config.multi_vector:
            raise ValueError("TorchEncoderMultiVectorEmbedding needs a multi-vector config")
        super().__init__(config, **kw)

    def embed_texts_multi(self, texts: Sequence[str]) -> list[np.ndarray]:
        return self._encode(texts)  # type: ignore[return-value]
