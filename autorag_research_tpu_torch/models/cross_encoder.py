"""PyTorch cross-encoder: joint (query, doc) relevance scoring.

Counterpart of the serving half of ``autorag_research_tpu/models/cross_encoder.py``:
the encoder's transformer body (``models/encoder.py``) over the concatenated
``query [SEP] doc`` token sequence, a masked mean pool and a scalar score
head. There is no output projection and no L2 normalisation: the score is
``pooled @ score.w + score.b[0]``.

The numerics follow the JAX model: layer norm with eps 1e-6 over the biased
variance, a -1e30 attention mask under a plain softmax, tanh-approximated
GELU, true f32 products (TF32 stays off), and ``max(mask.sum, 1)`` as the
pool's divisor. The parameters keep the JAX layout and their ``state_dict``
keys are the flattened names that the JAX ``save_params`` writes (``embed``,
``pos``, ``blocks.<i>.*``, ``final_ln.*``, ``score.w`` [h, 1], ``score.b``
[1]), so :func:`cross_params_from_jax` and :func:`cross_params_to_jax` carry
weights between the packages. Pairwise training (``pairwise_train_step``,
``CrossEncoderTrainer``) is not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from autorag_research_tpu_torch.models.encoder import (
    EncoderConfig,
    _attention,
    _Block,
    _LayerNorm,
    from_jax_params,
    hash_tokenize,
)
from autorag_research_tpu_torch.ops.dense import _require_exact_f32

SEP_TOKEN = 1  # reserved by hash_tokenize (ids start at 1; collisions harmless)


class _ScoreHead(nn.Module):
    def __init__(self, hidden: int):
        super().__init__()
        self.w = nn.Parameter(torch.empty(hidden, 1))
        self.b = nn.Parameter(torch.zeros(1))


class CrossEncoder(nn.Module):
    """``forward(token_ids, mask)`` with [B, T] inputs returns [B] relevance
    scores. Random init draws N(0, 0.02) from a ``torch.Generator`` seeded
    with ``seed`` for every matrix (JAX's ``PRNGKey`` stream differs, so
    parity goes through :func:`cross_params_from_jax`); layer norms start at
    (1, 0) and the score bias at 0, as in the JAX ``init_cross_params``."""

    def __init__(self, config: EncoderConfig, device: str | torch.device = "cuda", seed: int = 0):
        super().__init__()
        self.config = config
        h, m = config.hidden, config.hidden * config.mlp_ratio
        self.embed = nn.Parameter(torch.empty(config.vocab_size, h))
        self.pos = nn.Parameter(torch.empty(config.max_len, h))
        self.final_ln = _LayerNorm(h)
        self.blocks = nn.ModuleList(_Block(h, m) for _ in range(config.layers))
        self.score = _ScoreHead(h)
        gen = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            for name, p in self.named_parameters():
                if not name.endswith(("scale", "bias", "score.b")):
                    p.copy_(torch.randn(p.shape, generator=gen) * 0.02)
        self.requires_grad_(False)
        self.to(torch.device(device))

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def forward(self, token_ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        _require_exact_f32()
        cfg = self.config
        mask = mask.to(torch.bool)
        x = self.embed[token_ids] + self.pos[: token_ids.shape[1]][None]
        x = x.to(cfg.dtype)
        for blk in self.blocks:
            y = blk.ln1(x)
            x = x + _attention(y, blk.qkv, blk.attn_out, mask, cfg)
            y = blk.ln2(x)
            y = nn.functional.gelu(y @ blk.mlp_in + blk.mlp_bias, approximate="tanh")
            x = x + y @ blk.mlp_out
        x = self.final_ln(x)
        maskf = mask.to(x.dtype)[..., None]
        pooled = (x * maskf).sum(1) / torch.clamp(maskf.sum(1), min=1.0)
        return (pooled @ self.score.w).squeeze(-1) + self.score.b[0]


# A ``CrossEncoder`` state dict from the JAX package's flattened parameters
# (the keys of the ``.npz`` that ``CrossEncoderTrainer.save`` writes): the
# layouts and names agree, so the encoder's mapping serves.
cross_params_from_jax = from_jax_params


def cross_params_to_jax(model: CrossEncoder) -> dict[str, np.ndarray]:
    """The inverse of :func:`cross_params_from_jax`: the flat numpy dict that
    the JAX ``load_params`` reads."""
    return {name: t.detach().cpu().numpy() for name, t in model.state_dict().items()}


def pair_tokenize(
    queries: list[str], docs: list[str], vocab_size: int, max_len: int
) -> tuple[np.ndarray, np.ndarray]:
    """``query [SEP] doc`` token sequences, each leg budgeted half the window."""
    half = max(1, (max_len - 1) // 2)
    q_ids, q_mask = hash_tokenize(list(queries), vocab_size, half)
    d_ids, d_mask = hash_tokenize(list(docs), vocab_size, max_len - half - 1)
    n = len(queries)
    ids = np.zeros((n, max_len), dtype=np.int32)
    mask = np.zeros((n, max_len), dtype=np.bool_)
    for i in range(n):
        ql = int(q_mask[i].sum())
        dl = int(d_mask[i].sum())
        ids[i, :ql] = q_ids[i, :ql]
        ids[i, ql] = SEP_TOKEN
        ids[i, ql + 1 : ql + 1 + dl] = d_ids[i, :dl]
        mask[i, : ql + 1 + dl] = True
    return ids, mask
