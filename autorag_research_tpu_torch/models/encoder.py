"""PyTorch retrieval encoder: the framework's native embedding model family.

Counterpart of ``autorag_research_tpu/models/encoder.py``: a BERT-style
transformer bi-encoder.

- single-vector mode: masked mean pool -> projection -> L2 norm (dense index);
- multi-vector mode: per-token projection -> L2 norm (late interaction).

Weights keep the JAX package's layout, ``[in, out]`` used as ``x @ W``, and
the module's ``state_dict`` keys are the JAX package's flattened parameter
names (``embed``, ``blocks.0.qkv``, ``final_ln.scale``, ...), so
:func:`from_jax_params` maps a saved JAX parameter file one to one. The
numerics follow the JAX model: layer norm with eps 1e-6 over the biased
variance, a -1e30 attention mask and tanh-approximated GELU.
"""

from __future__ import annotations

import hashlib
import math
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn


@dataclass(frozen=True)
class EncoderConfig:
    vocab_size: int = 32768
    hidden: int = 256
    layers: int = 4
    heads: int = 4
    mlp_ratio: int = 4
    max_len: int = 128
    out_dim: int = 128
    multi_vector: bool = False
    dtype: torch.dtype = torch.float32

    @property
    def head_dim(self) -> int:
        return self.hidden // self.heads


class _LayerNorm(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _layer_norm(x, self.scale, self.bias)


def _layer_norm(x, scale, bias, eps=1e-6):
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * scale + bias


def _attention(x, qkv_w, out_w, mask, config: EncoderConfig):
    b, t, h = x.shape
    q, k, v = torch.split(x @ qkv_w, h, dim=-1)

    def heads(a):
        return a.reshape(b, t, config.heads, config.head_dim).transpose(1, 2)

    q, k, v = heads(q), heads(k), heads(v)
    scores = (q @ k.transpose(-1, -2)) / math.sqrt(config.head_dim)
    scores = scores.masked_fill(~mask[:, None, None, :], -1e30)
    probs = torch.softmax(scores, dim=-1)
    ctx = (probs @ v).transpose(1, 2).reshape(b, t, h)
    return ctx @ out_w


class _Block(nn.Module):
    def __init__(self, h: int, m: int):
        super().__init__()
        self.ln1 = _LayerNorm(h)
        self.qkv = nn.Parameter(torch.empty(h, 3 * h))
        self.attn_out = nn.Parameter(torch.empty(h, h))
        self.ln2 = _LayerNorm(h)
        self.mlp_in = nn.Parameter(torch.empty(h, m))
        self.mlp_bias = nn.Parameter(torch.zeros(m))
        self.mlp_out = nn.Parameter(torch.empty(m, h))


class RetrievalEncoder(nn.Module):
    """Transformer encoder; ``forward(token_ids, mask)`` with [B, T] inputs
    returns [B, out_dim] (single-vector) or [B, T, out_dim] (multi-vector),
    L2-normalized. Random init draws N(0, 0.02) from a ``torch.Generator``
    seeded with ``seed`` (JAX's ``PRNGKey`` stream differs, so parity goes
    through :func:`from_jax_params`)."""

    def __init__(self, config: EncoderConfig, device: str | torch.device = "cuda", seed: int = 0):
        super().__init__()
        self.config = config
        h, m = config.hidden, config.hidden * config.mlp_ratio
        self.embed = nn.Parameter(torch.empty(config.vocab_size, h))
        self.pos = nn.Parameter(torch.empty(config.max_len, h))
        self.out_proj = nn.Parameter(torch.empty(h, config.out_dim))
        self.final_ln = _LayerNorm(h)
        self.blocks = nn.ModuleList(_Block(h, m) for _ in range(config.layers))
        gen = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            for name, p in self.named_parameters():
                if not name.endswith(("scale", "bias")):
                    p.copy_(torch.randn(p.shape, generator=gen) * 0.02)
        self.to(torch.device(device))

    def forward(self, token_ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        x = self.embed[token_ids] + self.pos[: token_ids.shape[1]][None]
        x = x.to(cfg.dtype)
        for blk in self.blocks:
            y = blk.ln1(x)
            x = x + _attention(y, blk.qkv, blk.attn_out, mask, cfg)
            y = blk.ln2(x)
            y = nn.functional.gelu(y @ blk.mlp_in + blk.mlp_bias, approximate="tanh")
            x = x + y @ blk.mlp_out
        x = self.final_ln(x)
        tokens = x @ self.out_proj
        if cfg.multi_vector:
            tokens = tokens * mask[..., None]
            norms = torch.linalg.vector_norm(tokens, dim=-1, keepdim=True)
            return tokens / torch.where(norms == 0, 1.0, norms)
        maskf = mask.to(tokens.dtype)[..., None]
        pooled = (tokens * maskf).sum(1) / torch.clamp(maskf.sum(1), min=1.0)
        norms = torch.linalg.vector_norm(pooled, dim=-1, keepdim=True)
        return pooled / torch.where(norms == 0, 1.0, norms)


def from_jax_params(flat: dict[str, np.ndarray]) -> dict[str, torch.Tensor]:
    """A ``RetrievalEncoder`` state dict from the JAX package's flattened
    parameters (the keys ``embeddings/jax_encoder.save_params`` writes). The
    layouts agree, so every array maps to the same-named tensor untouched."""
    return {name: torch.from_numpy(np.array(arr, dtype=np.float32)) for name, arr in flat.items()}


# ----------------------------------------------------------- tokenization
def hash_tokenize(
    texts: list[str], vocab_size: int, max_len: int
) -> tuple[np.ndarray, np.ndarray]:
    """Deterministic hash-bucket tokenizer (feature hashing) so the encoder
    runs fully offline; swap in an HF tokenizer for trained checkpoints."""
    ids = np.zeros((len(texts), max_len), dtype=np.int32)
    mask = np.zeros((len(texts), max_len), dtype=np.bool_)
    for i, text in enumerate(texts):
        toks = text.lower().split()[:max_len]
        for j, t in enumerate(toks):
            digest = hashlib.md5(t.encode()).digest()
            ids[i, j] = 1 + int.from_bytes(digest[:4], "little") % (vocab_size - 1)
            mask[i, j] = True
        if not toks:
            mask[i, 0] = True
    return ids, mask
