"""Bi-encoder training on catalog ground truth.

Counterpart of ``autorag_research_tpu/models/trainer.py``. The trainer:

1. builds contrastive pairs from the catalog's retrieval relations (each
   query paired with one gold chunk; in-batch negatives);
2. runs ``contrastive_train_step`` (plain SGD) or the same loss under
   ``torch.optim.AdamW`` (b1 0.9, b2 0.999, eps 1e-8, decay on the old
   parameter: the update ``optax.adamw`` computes) on one device;
3. checkpoints under ``directory/step_<N>`` and resumes from the latest;
4. saves the trained weights as the flat ``.npz`` that
   ``TorchEncoderEmbedding(params_path=...)`` (and the JAX package's
   ``JaxEncoderEmbedding``) serves and indexes with.

A checkpoint is a directory of two files: ``params.npz``, the flat parameter
names of ``save_params``, and ``state.pt``, ``torch.save`` of the step and
the optimizer's state dict (``None`` under SGD). A restore gives back both
bitwise. The JAX trainer writes orbax checkpoints instead; the two formats
do not read each other.

Training over a ``(dp, tp)`` mesh is not ported: ``mesh=`` raises (ROADMAP.md
queue 1, item 6b, the training half of item 6). The data order is the JAX trainer's (numpy ``default_rng((seed,
start_step))``), so both packages see the same batches.
"""

from __future__ import annotations

import logging
import os
import shutil
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from autorag_research_tpu_torch.models.encoder import (
    EncoderConfig,
    RetrievalEncoder,
    contrastive_loss,
    contrastive_train_step,
    encoder_params_to_jax,
    hash_tokenize,
)

logger = logging.getLogger("AutoRAG-Research-TPU")

@dataclass
class TrainReport:
    steps: int = 0
    losses: list[float] = field(default_factory=list)
    seconds: float = 0.0

    @property
    def final_loss(self) -> float | None:
        return self.losses[-1] if self.losses else None


def build_pairs(catalog) -> list[tuple[str, str]]:
    """(query text, gold chunk text) pairs from the catalog's GT relations —
    one pair per (query, gold chunk)."""
    pairs: list[tuple[str, str]] = []
    for qid in catalog.get_all_query_ids():
        qtext = catalog.get_query_text(qid)
        if not qtext:
            continue
        gold_ids = [
            r["chunk_id"]
            for r in catalog.get_relations_by_query(qid)
            if r["chunk_id"] is not None
        ]
        contents = catalog.get_chunk_contents(gold_ids)
        for cid in gold_ids:
            if cid in contents:
                pairs.append((qtext, contents[cid]))
    return pairs


class BiEncoderTrainer:
    """``encoder`` (a ``RetrievalEncoder`` on ``device``, ``"cuda"`` unless
    the caller asks for another) holds the weights, with gradients on: the
    trainer owns it. ``from_jax_params`` loads another package's weights
    into it."""

    def __init__(
        self,
        config: EncoderConfig | None = None,
        lr: float = 1e-3,
        temperature: float = 0.05,
        batch_size: int = 32,
        mesh=None,
        seed: int = 0,
        optimizer: str = "sgd",
        weight_decay: float = 0.01,
        device: str | torch.device = "cuda",
    ):
        if mesh is not None:
            raise NotImplementedError(
                "bi-encoder training over a (dp, tp) mesh is not in the port yet "
                "(ROADMAP.md queue 1, item 6b)"
            )
        if optimizer not in ("sgd", "adamw"):
            raise ValueError(f"unknown optimizer '{optimizer}' (sgd | adamw)")
        self.config = config or EncoderConfig()
        self.encoder = RetrievalEncoder(self.config, device=device, seed=seed).requires_grad_(True)
        self.device = self.encoder.embed.device
        self.lr = lr
        self.temperature = temperature
        self.batch_size = batch_size
        self.seed = seed
        self.optimizer = optimizer
        self.weight_decay = weight_decay
        self._opt = (
            torch.optim.AdamW(self.encoder.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8,
                              weight_decay=weight_decay)
            if optimizer == "adamw" else None
        )

    def _make_batch(self, pairs: list[tuple[str, str]]) -> dict[str, torch.Tensor]:
        queries, docs = zip(*pairs)
        cfg = self.config
        q_ids, q_mask = hash_tokenize(list(queries), cfg.vocab_size, cfg.max_len)
        d_ids, d_mask = hash_tokenize(list(docs), cfg.vocab_size, cfg.max_len)
        dev = self.device
        return {
            "q_ids": torch.from_numpy(q_ids).to(dev, torch.int64),
            "q_mask": torch.from_numpy(q_mask).to(dev),
            "d_ids": torch.from_numpy(d_ids).to(dev, torch.int64),
            "d_mask": torch.from_numpy(d_mask).to(dev),
        }

    def step(self, batch: dict[str, torch.Tensor]) -> torch.Tensor:
        """One optimizer step on ``batch``; the loss stays on the device."""
        if self._opt is None:
            return contrastive_train_step(self.encoder, batch, lr=self.lr,
                                          temperature=self.temperature)
        from autorag_research_tpu_torch.ops.dense import _require_exact_f32

        _require_exact_f32()
        self._opt.zero_grad(set_to_none=True)
        loss = contrastive_loss(self.encoder, batch, self.temperature)
        loss.backward()
        self._opt.step()
        return loss.detach()

    # ------------------------------------------------------------ checkpoints
    def save_checkpoint(self, directory: str | Path, step: int) -> Path:
        """Parameters and optimizer state under ``directory/step_<N>``,
        written beside it first and renamed into place, so a checkpoint that
        exists is whole."""
        path = Path(directory).resolve() / f"step_{step}"
        tmp = path.with_name(f".{path.name}.{os.getpid()}.tmp")
        shutil.rmtree(tmp, ignore_errors=True)
        tmp.mkdir(parents=True)
        np.savez(tmp / "params.npz", **encoder_params_to_jax(self.encoder))
        torch.save({"step": int(step),
                    "optimizer": None if self._opt is None else self._opt.state_dict()},
                   tmp / "state.pt")
        shutil.rmtree(path, ignore_errors=True)
        tmp.rename(path)
        return path

    @staticmethod
    def latest_checkpoint(directory: str | Path) -> Path | None:
        directory = Path(directory)
        if not directory.is_dir():
            return None
        steps = []
        for p in directory.iterdir():
            if p.is_dir() and p.name.startswith("step_"):
                try:
                    steps.append((int(p.name[5:]), p))
                except ValueError:
                    continue
        return max(steps)[1] if steps else None

    def restore_checkpoint(self, directory: str | Path) -> int:
        """Restore the parameters and optimizer state of the latest
        ``step_<N>`` checkpoint. Returns the restored step (0 if no
        checkpoint exists)."""
        from autorag_research_tpu_torch.embeddings.torch_encoder import load_params

        path = self.latest_checkpoint(directory)
        if path is None:
            return 0
        self.encoder.load_state_dict(load_params(path / "params.npz"))
        state = torch.load(path / "state.pt", map_location=self.device, weights_only=True)
        if self._opt is not None:
            if state["optimizer"] is None:
                raise ValueError(f"{path} holds no optimizer state (written under sgd)")
            self._opt.load_state_dict(state["optimizer"])
        return int(state["step"])

    # ------------------------------------------------------------------ train
    def train(
        self,
        catalog,
        epochs: int = 1,
        max_steps: int | None = None,
        checkpoint_dir: str | Path | None = None,
        checkpoint_every: int = 50,
    ) -> TrainReport:
        """Train; with ``checkpoint_dir`` set, auto-resumes from the latest
        checkpoint there and saves every ``checkpoint_every`` steps plus at
        the end. ``max_steps`` counts TOTAL steps including restored ones.
        Each step's loss is read back as it runs, as the JAX trainer reads
        it."""
        pairs = build_pairs(catalog)
        if len(pairs) < 2:
            raise ValueError("need at least 2 (query, gold chunk) pairs to train")
        start_step = 0
        if checkpoint_dir is not None:
            start_step = self.restore_checkpoint(checkpoint_dir)
        # fold the resume step into the data-order seed so a resumed run does
        # not replay the exact permutations already consumed
        rng = np.random.default_rng((self.seed, start_step))
        report = TrainReport()
        start = time.perf_counter()
        bsz = min(self.batch_size, len(pairs))
        global_step = start_step
        done = max_steps is not None and global_step >= max_steps
        for _ in range(epochs):
            if done:
                break
            order = rng.permutation(len(pairs))
            for lo in range(0, len(pairs) - bsz + 1, bsz):
                batch = self._make_batch([pairs[i] for i in order[lo : lo + bsz]])
                report.losses.append(float(self.step(batch)))
                report.steps += 1
                global_step += 1
                if checkpoint_dir is not None and global_step % checkpoint_every == 0:
                    self.save_checkpoint(checkpoint_dir, global_step)
                if max_steps is not None and global_step >= max_steps:
                    done = True
                    break
        if checkpoint_dir is not None and report.steps:
            self.save_checkpoint(checkpoint_dir, global_step)
        report.seconds = time.perf_counter() - start
        logger.info(
            "trained %d steps in %.1fs (loss %.4f -> %.4f)",
            report.steps, report.seconds,
            report.losses[0] if report.losses else float("nan"),
            report.final_loss or float("nan"),
        )
        return report

    def save(self, path: str | Path) -> None:
        from autorag_research_tpu_torch.embeddings.torch_encoder import save_params

        save_params(self.encoder, path)

    def as_embedding(self, batch_size: int = 256):
        """Wrap the trained weights as an embedding adapter for indexing, on
        the trainer's device (a copy: further training does not move it)."""
        from autorag_research_tpu_torch.embeddings.torch_encoder import (
            TorchEncoderEmbedding,
            TorchEncoderMultiVectorEmbedding,
        )

        cls = TorchEncoderMultiVectorEmbedding if self.config.multi_vector else TorchEncoderEmbedding
        emb = cls(self.config, batch_size=batch_size, seed=self.seed, device=self.device)
        emb.encoder.load_state_dict(self.encoder.state_dict())
        return emb
