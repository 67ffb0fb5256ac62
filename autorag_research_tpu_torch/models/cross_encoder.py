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
weights between the packages.

Training: ``pairwise_train_step`` is the pairwise logistic loss
``mean(softplus(score_neg - score_pos))`` with one plain SGD step by autograd
(the JAX step is ``jax.value_and_grad`` over plain XLA), and
``CrossEncoderTrainer`` pairs each (query, gold chunk) of a catalog with a
seeded in-corpus negative, drawing from numpy's generator in the JAX
trainer's order, so both packages train on the same batches.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch
from torch import nn

from autorag_research_tpu_torch.models.encoder import (
    EncoderConfig,
    _attention,
    _Block,
    _LayerNorm,
    encoder_params_to_jax,
    from_jax_params,
    hash_tokenize,
    sgd_step,
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
# (the keys of the ``.npz`` that ``CrossEncoderTrainer.save`` writes), and
# back: the layouts and names agree, so the encoder's mappings serve.
cross_params_from_jax = from_jax_params
cross_params_to_jax = encoder_params_to_jax


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


def pairwise_loss(model: CrossEncoder, batch: dict) -> torch.Tensor:
    """``mean(softplus(neg - pos))`` of one batch of pos_ids / pos_mask /
    neg_ids / neg_mask [B, T] tensors on the module's device."""
    pos = model(batch["pos_ids"], batch["pos_mask"])
    neg = model(batch["neg_ids"], batch["neg_mask"])
    return nn.functional.softplus(neg - pos).mean()


def pairwise_train_step(model: CrossEncoder, batch: dict, lr: float = 1e-3) -> torch.Tensor:
    """One SGD step of the pairwise logistic loss on ``model``'s parameters,
    in place; returns the loss (a 0-d tensor on the device). The JAX step
    returns ``(new_params, loss)``; here the module holds the parameters."""
    return sgd_step(model, lambda: pairwise_loss(model, batch), lr)


@dataclass
class CrossTrainReport:
    steps: int = 0
    losses: list[float] = field(default_factory=list)
    seconds: float = 0.0

    @property
    def final_loss(self) -> float | None:
        return self.losses[-1] if self.losses else None


class CrossEncoderTrainer:
    """Pairwise training on catalog GT: (query, gold chunk) positives with
    seeded random in-corpus negatives. The module trains on ``device``
    (``"cuda"`` unless the caller asks for another); ``model`` holds the
    weights (``cross_params_from_jax`` loads another package's)."""

    def __init__(
        self,
        config: EncoderConfig | None = None,
        lr: float = 1e-3,
        batch_size: int = 16,
        seed: int = 0,
        negative_strategy: str = "random",
        device: str | torch.device = "cuda",
    ):
        if negative_strategy not in ("random", "cycle"):
            raise ValueError("negative_strategy must be 'random' or 'cycle'")
        self.config = config or EncoderConfig()
        self.model = CrossEncoder(self.config, device=device, seed=seed)
        self.lr = lr
        self.batch_size = batch_size
        self.seed = seed
        self.negative_strategy = negative_strategy

    def _tensors(self, ids: np.ndarray, mask: np.ndarray):
        dev = self.model.device
        return torch.from_numpy(ids).to(dev, torch.int64), torch.from_numpy(mask).to(dev)

    def train(self, catalog, epochs: int = 1, max_steps: int | None = None) -> CrossTrainReport:
        from autorag_research_tpu_torch.models.trainer import build_pairs

        pairs = build_pairs(catalog)  # (query text, gold chunk text)
        if len(pairs) < 2:
            raise ValueError("need at least 2 (query, gold chunk) pairs to train")
        all_docs = [d for _, d in pairs]
        rng = np.random.default_rng(self.seed)
        report = CrossTrainReport()
        start = time.perf_counter()
        bsz = min(self.batch_size, len(pairs))
        cfg = self.config
        for _ in range(epochs):
            order = rng.permutation(len(pairs))
            for lo in range(0, len(pairs) - bsz + 1, bsz):
                chosen = [pairs[i] for i in order[lo : lo + bsz]]
                queries = [q for q, _ in chosen]
                pos_docs = [d for _, d in chosen]
                # negative: a different doc from the corpus pool. "cycle"
                # pairs each positive with a FIXED offset negative — a
                # stationary signal that converges much faster on tiny
                # corpora than per-step random draws.
                neg_docs = []
                for j, (_, pos) in enumerate(chosen):
                    if self.negative_strategy == "cycle":
                        cand = all_docs[(order[lo + j] + 1) % len(all_docs)]
                        if cand == pos and len(all_docs) > 1:
                            cand = all_docs[(order[lo + j] + 2) % len(all_docs)]
                    else:
                        while True:
                            cand = all_docs[rng.integers(len(all_docs))]
                            if cand != pos or len(set(all_docs)) == 1:
                                break
                    neg_docs.append(cand)
                pos_ids, pos_mask = self._tensors(
                    *pair_tokenize(queries, pos_docs, cfg.vocab_size, cfg.max_len))
                neg_ids, neg_mask = self._tensors(
                    *pair_tokenize(queries, neg_docs, cfg.vocab_size, cfg.max_len))
                batch = {"pos_ids": pos_ids, "pos_mask": pos_mask,
                         "neg_ids": neg_ids, "neg_mask": neg_mask}
                loss = pairwise_train_step(self.model, batch, lr=self.lr)
                report.losses.append(float(loss))
                report.steps += 1
                if max_steps is not None and report.steps >= max_steps:
                    break
            if max_steps is not None and report.steps >= max_steps:
                break
        report.seconds = time.perf_counter() - start
        return report

    def save(self, path: str | Path) -> None:
        """The flat ``.npz`` that the JAX ``CrossEncoderTrainer.save`` writes
        (uncompressed; ``np.load`` reads both forms)."""
        np.savez(path, **cross_params_to_jax(self.model))

    def as_reranker(self, batch_size: int = 64):
        """Wrap the trained weights as a ``TorchCrossEncoderReranker`` on the
        trainer's device (a copy: further training does not move it)."""
        from autorag_research_tpu_torch.rerankers.torch_cross import TorchCrossEncoderReranker

        r = TorchCrossEncoderReranker(self.config, batch_size=batch_size, seed=self.seed,
                                      device=self.model.device)
        r.model.load_state_dict(self.model.state_dict())
        return r
