"""On-device cross-encoder reranker over the native PyTorch cross-encoder.

Counterpart of ``autorag_research_tpu/rerankers/jax_cross.py`` (model name
``torch_cross_encoder``): scores every (query, text) pair in batched
forwards of ``models/cross_encoder.py`` on the device. Works offline with
hash-bucket tokenization and seeded random init; ``params_path`` loads the
``.npz`` of flattened parameters that the JAX ``CrossEncoderTrainer.save``
writes, giving identical weights.

Runs on ``device`` (``"cuda"`` unless the caller asks for another); asked
for ``cuda`` on a machine without one, construction raises. The JAX reranker
pads every chunk to ``batch_size`` to keep one compiled shape; the rows are
independent, so the port scores each chunk as it is (a row's score does not
depend on the rows beside it up to f32 reduction order).
"""

from __future__ import annotations

from pathlib import Path
from typing import Sequence

import numpy as np
import torch

from autorag_research_tpu_torch.models.cross_encoder import (
    CrossEncoder,
    cross_params_from_jax,
    pair_tokenize,
)
from autorag_research_tpu_torch.models.encoder import EncoderConfig
from autorag_research_tpu_torch.rerankers.base import BaseReranker


class TorchCrossEncoderReranker(BaseReranker):
    model_name = "torch_cross_encoder"

    def __init__(
        self,
        config: EncoderConfig | None = None,
        params_path: str | Path | None = None,
        batch_size: int = 64,
        seed: int = 0,
        device: str | torch.device = "cuda",
    ):
        self.config = config or EncoderConfig()
        self.batch_size = batch_size
        self.model = CrossEncoder(self.config, device=device, seed=seed).eval()
        if params_path is not None:
            with np.load(params_path) as data:
                flat = {name: data[name] for name in data.files}
            self.model.load_state_dict(cross_params_from_jax(flat))

    @property
    def device(self) -> torch.device:
        return self.model.device

    @torch.inference_mode()
    def score_pairs(self, query: str, texts: Sequence[str]) -> torch.Tensor:
        """f32 scores [len(texts)] on the device, in ``batch_size`` chunks."""
        cfg, dev = self.config, self.device
        out = []
        for lo in range(0, len(texts), self.batch_size):
            chunk = list(texts[lo : lo + self.batch_size])
            ids, mask = pair_tokenize([query] * len(chunk), chunk, cfg.vocab_size, cfg.max_len)
            out.append(self.model(torch.from_numpy(ids).to(dev, torch.int64),
                                  torch.from_numpy(mask).to(dev)))
        return out[0] if len(out) == 1 else torch.cat(out)

    def rerank(self, query: str, texts: Sequence[str], top_k: int | None = None):
        if not texts:
            return []
        scores = self.score_pairs(query, texts).double().cpu().numpy().tolist()  # one readback
        return self._finalize(
            [(i, t, float(s)) for i, (t, s) in enumerate(zip(texts, scores))], top_k
        )
