"""On-device LM SFT: teach ``TorchLM`` a workspace's QA behavior.

Counterpart of ``autorag_research_tpu/models/lm_trainer.py``: ingest -> build
retrieval GT -> TRAIN the causal decoder on (context, question, answer)
sequences -> serve and evaluate generation pipelines against it, with no
egress.

- examples are byte-tokenized to ONE [B, T] shape, right-padded, with a
  per-position loss mask selecting only answer(+EOS) targets (SFT masking);
- AdamW (``torch.optim.AdamW``: b1 0.9, b2 0.999, eps 1e-8, decay on the old
  parameter, the update ``optax.adamw`` computes) over every parameter of
  the tied-weight decoder that the serving path uses;
- the schedule is the JAX trainer's: a shuffled epoch order whose ragged
  tail is filled by resampling, ``max_steps`` truncating it, and fixed-length
  chunks whose tail is padded by resampling rows. The JAX trainer scans a
  chunk in one jit; here a chunk's steps run back to back with their losses
  kept on the device and read back once a chunk, so the host never waits
  inside a chunk. The chunks fix which batches run, so ``report.steps``
  counts the padded schedule, as in the JAX package;
- the checkpoint is the flat ``.npz`` of ``JaxLM.save`` / ``TorchLM.load``,
  so a trained file drops into the ``torch_lm`` (or ``jax_lm``) preset's
  ``checkpoint:`` knob.
"""

from __future__ import annotations

import json
import time
from typing import Any, Sequence

import numpy as np
import torch

from autorag_research_tpu_torch.models.decoder import (
    BOS_ID,
    EOS_ID,
    PAD_ID,
    _BYTE_OFFSET,
    CausalDecoder,
    DecoderConfig,
    decoder_params_from_jax,
    decoder_params_to_jax,
    next_token_nll,
)
from autorag_research_tpu_torch.models.trainer import TrainReport

DEFAULT_LM_PROMPT = (
    "Answer the question using only the provided context.\n\n"
    "Context:\n{context}\n\nQuestion: {query}\n\nAnswer:"
)


def build_lm_examples(
    catalog,
    prompt_template: str = DEFAULT_LM_PROMPT,
    max_context_chunks: int = 3,
) -> list[tuple[str, str]]:
    """(prompt, answer) pairs from a workspace: gold-context prompts in the
    exact format ``basic_rag`` emits at eval time, answers from each query's
    ``generation_gt``. Queries without generation GT are skipped."""
    examples: list[tuple[str, str]] = []
    for qid in catalog.get_all_query_ids():
        row = catalog.get_query(qid)
        if row is None or not row["contents"]:
            continue
        raw_gt = row["generation_gt"]
        if not raw_gt:
            continue
        try:
            gts = json.loads(raw_gt)
        except (json.JSONDecodeError, TypeError):
            gts = [raw_gt]
        if not isinstance(gts, list):
            gts = [gts]
        gold_ids = [
            r["chunk_id"]
            for r in catalog.get_relations_by_query(qid)
            if r["chunk_id"] is not None
        ][:max_context_chunks]
        contents = catalog.get_chunk_contents(gold_ids)
        context = "\n\n".join(contents[c] for c in gold_ids if c in contents)
        prompt = prompt_template.format(
            context=context or "(no context retrieved)", query=row["contents"]
        )
        for gt in gts:
            if gt:
                examples.append((prompt, str(gt)))
    return examples


def encode_sft(
    examples: Sequence[tuple[str, str]], seq_len: int
) -> dict[str, np.ndarray]:
    """Right-padded [N, seq_len] ids/mask plus an SFT loss mask.

    Sequence = BOS + prompt bytes + answer bytes + EOS. ``loss_mask[p]`` marks
    positions whose NEXT token is an answer byte or the EOS — prompt tokens
    provide context but contribute no loss. Prompts longer than the budget
    are head-truncated (keep the question tail, like ``byte_tokenize``).
    """
    n = len(examples)
    ids = np.full((n, seq_len), PAD_ID, dtype=np.int32)
    mask = np.zeros((n, seq_len), dtype=np.bool_)
    loss_mask = np.zeros((n, seq_len), dtype=np.bool_)
    for i, (prompt, answer) in enumerate(examples):
        p_ids = [BOS_ID] + [b + _BYTE_OFFSET for b in prompt.encode("utf-8")]
        a_ids = [b + _BYTE_OFFSET for b in answer.encode("utf-8")] + [EOS_ID]
        budget = seq_len - len(a_ids)
        if budget < 1:  # answer alone overflows: keep its head, 1 ctx token
            p_ids = p_ids[:1]
            a_ids = a_ids[: seq_len - 1]
        elif len(p_ids) > budget:
            p_ids = [BOS_ID] + p_ids[len(p_ids) - budget + 1 :]
        row = p_ids + a_ids
        ids[i, : len(row)] = row
        mask[i, : len(row)] = True
        # answer starts at len(p_ids); position p predicts token p+1
        start = len(p_ids)
        loss_mask[i, max(0, start - 1) : len(row) - 1] = True
    return {"ids": ids, "mask": mask, "loss_mask": loss_mask}


def _sft_loss(decoder: CausalDecoder, batch: dict) -> torch.Tensor:
    """Next-token loss over the answer (+EOS) targets of one batch of ids /
    mask / loss_mask [B, T] tensors on the module's device."""
    mask = batch["mask"].to(torch.bool)
    return next_token_nll(decoder(batch["ids"], mask), batch["ids"],
                          batch["loss_mask"].to(torch.bool) & mask)


class LMTrainer:
    """AdamW SFT over the causal decoder on ``device`` (``"cuda"`` unless
    the caller asks for another). ``params``: the flat numpy dict of the JAX
    package's parameter names to start from (what ``decoder_params_to_jax``
    gives), else the seeded init."""

    def __init__(
        self,
        config: DecoderConfig | None = None,
        lr: float = 3e-3,
        batch_size: int = 16,
        seq_len: int = 256,
        weight_decay: float = 0.01,
        seed: int = 0,
        params: dict[str, np.ndarray] | None = None,
        device: str | torch.device = "cuda",
    ):
        self.config = config or DecoderConfig()
        if seq_len > self.config.max_len:
            raise ValueError(
                f"seq_len {seq_len} exceeds decoder max_len {self.config.max_len}"
            )
        self.decoder = CausalDecoder(self.config, device=device, seed=seed)
        if params is not None:
            self.decoder.load_state_dict(decoder_params_from_jax(params))
        self.decoder.requires_grad_(True)  # built for serving with gradients off
        self.batch_size = batch_size
        self.seq_len = seq_len
        self.seed = seed
        self._opt = torch.optim.AdamW(self.decoder.parameters(), lr=lr, betas=(0.9, 0.999),
                                      eps=1e-8, weight_decay=weight_decay)

    def step(self, batch: dict[str, torch.Tensor]) -> torch.Tensor:
        """One AdamW step on ``batch``; the loss stays on the device."""
        self._opt.zero_grad(set_to_none=True)
        loss = _sft_loss(self.decoder, batch)
        loss.backward()
        self._opt.step()
        return loss.detach()

    # ------------------------------------------------------------------ data
    def _epoch_order(self, n: int, rng: np.random.Generator) -> np.ndarray:
        """One epoch's [steps, B] shuffled row indices; the ragged tail batch
        is filled by re-sampling (memorization-scale corpora are tiny — no
        example may silently vanish from an epoch)."""
        order = rng.permutation(n)
        pad = (-n) % self.batch_size
        if pad:
            order = np.concatenate([order, rng.choice(n, size=pad)])
        return order.reshape(-1, self.batch_size)

    def schedule(self, n: int, epochs: int, max_steps: int | None = None) -> tuple[np.ndarray, int]:
        """The [steps, B] row indices the JAX trainer runs over ``n``
        examples, chunk padding included, and the chunk length."""
        rng = np.random.default_rng(self.seed)
        order = np.concatenate([self._epoch_order(n, rng) for _ in range(epochs)], axis=0)
        if max_steps is not None:
            order = order[:max_steps]
        # fixed-length chunks (the JAX trainer's scans; it bounds the stacked
        # upload too); the tail chunk is padded by resampling rows — extra
        # memorization steps, never dropped examples
        bytes_per_step = self.batch_size * self.seq_len * 6  # int32 + 2 bool
        chunk_steps = max(1, min(128, order.shape[0], (256 << 20) // bytes_per_step))
        total = order.shape[0]
        pad = (-total) % chunk_steps
        if pad:
            order = np.concatenate([order, order[rng.choice(total, size=pad)]])
        return order, chunk_steps

    # ----------------------------------------------------------------- train
    def train(
        self,
        source: Any,
        epochs: int = 10,
        max_steps: int | None = None,
        prompt_template: str = DEFAULT_LM_PROMPT,
        log_every: int = 0,
    ) -> TrainReport:
        """``source`` is a Catalog (examples built from its GT) or a list of
        (prompt, answer) pairs."""
        examples = (
            source
            if isinstance(source, list)
            else build_lm_examples(source, prompt_template)
        )
        if not examples:
            raise ValueError(
                "no LM training examples: queries need generation_gt "
                "(and ideally retrieval GT for context)"
            )
        data = encode_sft(examples, self.seq_len)
        order, chunk_steps = self.schedule(data["ids"].shape[0], epochs, max_steps)
        report = TrainReport()
        t0 = time.time()
        dev = self.decoder.device
        for start in range(0, order.shape[0], chunk_steps):
            idx = order[start : start + chunk_steps]
            # one upload a chunk; the losses are read back once a chunk
            chunk = {k: torch.from_numpy(v[idx]).to(dev) for k, v in data.items()}
            chunk["ids"] = chunk["ids"].long()
            losses = torch.stack([self.step({k: v[s] for k, v in chunk.items()})
                                  for s in range(idx.shape[0])])
            report.losses.extend(float(x) for x in losses.cpu().numpy())
        report.steps = order.shape[0]
        report.seconds = time.time() - t0
        if log_every:
            steps_per_epoch = max(1, order.shape[0] // max(1, epochs))
            arr = np.asarray(report.losses)
            for e in range(0, arr.size, steps_per_epoch * log_every):
                chunk_losses = arr[e : e + steps_per_epoch]
                print(f"step {e}: loss {chunk_losses.mean():.4f}")
        return report

    # ------------------------------------------------------------ checkpoint
    def save(self, path: str) -> None:
        np.savez(path, **decoder_params_to_jax(self.decoder))

    def to_llm(self, **kwargs) -> Any:
        """Wrap the trained weights in a serving ``TorchLM`` on the trainer's
        device (a copy: further training does not move it)."""
        from autorag_research_tpu_torch.llm.torch_lm import TorchLM

        kwargs.setdefault("device", self.decoder.device)
        llm = TorchLM(config=self.config, seed=self.seed, **kwargs)
        llm.decoder.load_state_dict(self.decoder.state_dict())
        return llm
