"""PyTorch retrieval encoder: the framework's native embedding model family.

Counterpart of ``autorag_research_tpu/models/encoder.py``: a BERT-style
transformer bi-encoder.

- single-vector mode: masked mean pool -> projection -> L2 norm (dense index);
- multi-vector mode: per-token projection -> L2 norm (late interaction);
- ``contrastive_train_step``: InfoNCE with in-batch negatives (MaxSim as the
  similarity in multi-vector mode), one plain SGD step ``p - lr * g`` over
  every parameter, by autograd (the JAX step is ``jax.value_and_grad`` over
  plain XLA: no Pallas kernel has a backward).

``param_specs`` is the JAX spec tree (a spec a tuple of mesh axis names or
None); ``shard_params`` / ``gather_params`` place the weights on a ``(dp, tp)``
mesh and back (``parallel/train.py``).

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


def param_specs(config: EncoderConfig) -> dict:
    """Spec tree: hidden-dim tensor parallelism over axis 'tp' (the JAX
    ``param_specs``, each ``PartitionSpec`` as a tuple)."""
    block = {
        "ln1": {"scale": (None,), "bias": (None,)},
        "qkv": (None, "tp"),
        "attn_out": ("tp", None),
        "ln2": {"scale": (None,), "bias": (None,)},
        "mlp_in": (None, "tp"),
        "mlp_bias": ("tp",),
        "mlp_out": ("tp", None),
    }
    return {
        "embed": (None, "tp"),
        "pos": (None, "tp"),
        "out_proj": (None, None),
        "final_ln": {"scale": (None,), "bias": (None,)},
        "blocks": [block for _ in range(config.layers)],
    }


def shard_params(params, config: EncoderConfig, mesh):
    """``params`` (a ``RetrievalEncoder`` or its flat state dict) placed on a
    ``(dp, tp)`` mesh by :func:`param_specs` (``parallel/train.py``)."""
    from autorag_research_tpu_torch.parallel.train import shard_tree

    return shard_tree(params, param_specs(config), mesh, config)


def gather_params(sharded) -> dict[str, torch.Tensor]:
    """The flat CPU state dict of a sharded tree: what ``from_jax_params``
    gives, and, as numpy, what ``encoder_params_to_jax`` gives."""
    from autorag_research_tpu_torch.parallel.train import gather_tree

    return gather_tree(sharded)


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

    ctx = masked_attention(heads(q), heads(k), heads(v), mask[:, None, None, :])
    return ctx.transpose(1, 2).reshape(b, t, h) @ out_w


def masked_attention(q, k, v, keep):
    """Softmax attention of [B, H, Tq, D] queries over [B, H, Tk, D] keys,
    ``keep`` broadcastable to [B, H, Tq, Tk]: masked scores are -1e30 under a
    plain softmax, as in the JAX models (the encoder and the decoder)."""
    scores = (q @ k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    scores = scores.masked_fill(~keep, -1e30)
    return torch.softmax(scores, dim=-1) @ v


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
        return pool_tokens(x @ self.out_proj, mask, cfg.multi_vector)


def pool_tokens(tokens: torch.Tensor, mask: torch.Tensor, multi_vector: bool) -> torch.Tensor:
    """The encoder's head over projected [B, T, out_dim] tokens: masked and
    L2-normalized per token (multi-vector), else masked mean pool then L2
    norm."""
    if multi_vector:
        tokens = tokens * mask[..., None]
        norms = torch.linalg.vector_norm(tokens, dim=-1, keepdim=True)
        return tokens / torch.where(norms == 0, 1.0, norms)
    maskf = mask.to(tokens.dtype)[..., None]
    pooled = (tokens * maskf).sum(1) / torch.clamp(maskf.sum(1), min=1.0)
    norms = torch.linalg.vector_norm(pooled, dim=-1, keepdim=True)
    return pooled / torch.where(norms == 0, 1.0, norms)


def info_nce_loss(q_emb: torch.Tensor, d_emb: torch.Tensor, temperature: float = 0.05):
    """In-batch-negative contrastive loss; positives on the diagonal."""
    logits = q_emb @ d_emb.T / temperature
    return -torch.log_softmax(logits, dim=-1).diagonal().mean()


def maxsim_info_nce_loss(q, d, q_mask, d_mask, temperature: float = 0.05):
    """InfoNCE over MaxSim scores of [B, Tq, D] queries against [B, Td, D]
    documents. Document pads take a -1e9 bias (a pad is a zero vector, so an
    unbiased max would floor every token's score at 0 and erase the gradient
    of anti-correlated negatives), query pads are masked out of the sum, and
    the sum is divided by the query's length, as in the JAX step."""
    sim = torch.einsum("qtd,nsd->qnts", q, d)
    d_bias = torch.where(d_mask[None, :, None, :] > 0, 0.0, -1e9)
    per_tok = (sim + d_bias).amax(-1) * q_mask[:, None, :]  # [Q, N, Tq]
    scores = per_tok.sum(-1) / torch.clamp(q_mask.sum(-1)[:, None], min=1)
    return -torch.log_softmax(scores / temperature, dim=-1).diagonal().mean()


def contrastive_loss(encoder: "RetrievalEncoder", batch: dict, temperature: float = 0.05):
    """The bi-encoder's training loss on one batch of ``q_ids`` / ``q_mask``
    / ``d_ids`` / ``d_mask`` [B, T] tensors on the module's device."""
    q = encoder(batch["q_ids"], batch["q_mask"])
    d = encoder(batch["d_ids"], batch["d_mask"])
    if encoder.config.multi_vector:
        return maxsim_info_nce_loss(q, d, batch["q_mask"], batch["d_mask"], temperature)
    return info_nce_loss(q, d, temperature)


def sgd_step(module: nn.Module, loss_fn, lr: float) -> torch.Tensor:
    """``loss_fn()`` and its gradient over every parameter of ``module``,
    then ``p - lr * g`` in place; returns the detached loss (no host sync).
    Gradients are on only inside the call, so a serving module stays as it
    was built. TF32 stays off: the parity with the JAX step and the CPU is
    held in true f32."""
    from autorag_research_tpu_torch.ops.dense import _require_exact_f32

    _require_exact_f32()
    params = list(module.parameters())
    flags = [p.requires_grad for p in params]
    try:
        with torch.enable_grad():
            for p in params:
                p.requires_grad_(True)
            loss = loss_fn()
            grads = torch.autograd.grad(loss, params)
    finally:
        for p, flag in zip(params, flags):
            p.requires_grad_(flag)
    with torch.no_grad():
        for p, g in zip(params, grads):
            p.sub_(lr * g)
    return loss.detach()


def contrastive_train_step(
    encoder: "RetrievalEncoder", batch: dict, lr: float = 1e-3, temperature: float = 0.05
) -> torch.Tensor:
    """One SGD step of bi-encoder training on ``encoder``'s parameters, in
    place. batch: q_ids / q_mask / d_ids / d_mask [B, T] on the module's
    device. Returns the loss (a 0-d tensor on the device). The JAX step
    returns ``(new_params, loss)``; here the module holds the parameters."""
    return sgd_step(encoder, lambda: contrastive_loss(encoder, batch, temperature), lr)


def encoder_params_to_jax(model: nn.Module) -> dict[str, np.ndarray]:
    """The inverse of :func:`from_jax_params`: the flat numpy dict that the
    JAX ``embeddings/jax_encoder.load_params`` reads."""
    return {name: t.detach().cpu().numpy() for name, t in model.state_dict().items()}


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
