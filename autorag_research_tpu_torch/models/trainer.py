"""Bi-encoder training on catalog ground truth.

Counterpart of ``autorag_research_tpu/models/trainer.py``. The trainer:

1. builds contrastive pairs from the catalog's retrieval relations (each
   query paired with one gold chunk; in-batch negatives);
2. runs ``contrastive_train_step`` (plain SGD) or the same loss under
   ``torch.optim.AdamW`` (b1 0.9, b2 0.999, eps 1e-8, decay on the old
   parameter: the update ``optax.adamw`` computes) on one device, or, given
   a ``(dp, tp)`` mesh (``parallel/mesh.py::train_mesh``), the same step over
   the mesh (``parallel/train.py``): the weights and the AdamW state sharded
   by ``param_specs``, the batch rows over ``dp``, the batch size aligned
   down to a multiple of ``dp`` as in the JAX trainer;
3. checkpoints under ``directory/step_<N>`` and resumes from the latest;
4. saves the trained weights as the flat ``.npz`` that
   ``TorchEncoderEmbedding(params_path=...)`` (and the JAX package's
   ``JaxEncoderEmbedding``) serves and indexes with.

A checkpoint is a directory of two files: ``params.npz``, the flat parameter
names of ``save_params``, and ``state.pt``, ``torch.save`` of the step and
the optimizer's state dict (``None`` under SGD). A restore gives back both
bitwise. Under a mesh both are gathered into the unsharded form first (the
AdamW state keyed by the unsharded parameter order), so a checkpoint resumes
with or without a mesh, of any shape; in several processes rank 0 writes it.
The JAX trainer writes orbax checkpoints instead; the two formats do not
read each other.

The data order is the JAX trainer's (numpy ``default_rng((seed,
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
    gather_params,
    hash_tokenize,
    shard_params,
)
from autorag_research_tpu_torch.parallel.mesh import process_rank
from autorag_research_tpu_torch.parallel.train import (
    adamw,
    gather_tree,
    place,
    sharded_contrastive_train_step,
    tp_slice,
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
    trainer owns it. With ``mesh`` (a ``(dp, tp)`` ``DeviceMesh``) the
    weights live in ``sharded`` instead (``encoder`` is None) and ``device``
    is the first device of this process's first dp row. :meth:`load_params`
    loads a flat state dict (``from_jax_params`` of another package's
    weights) either way."""

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
        if optimizer not in ("sgd", "adamw"):
            raise ValueError(f"unknown optimizer '{optimizer}' (sgd | adamw)")
        self.config = config or EncoderConfig()
        self.mesh = mesh
        self.sharded = None
        if mesh is None:
            self.encoder = RetrievalEncoder(self.config, device=device, seed=seed).requires_grad_(True)
            self.device = self.encoder.embed.device
        else:
            # the seeded init is drawn on the CPU on every device, so the
            # sharded weights are the unsharded trainer's
            self.encoder = None
            init = RetrievalEncoder(self.config, device="cpu", seed=seed)
            self.sharded = shard_params(init, self.config, mesh)
            self.device = mesh.grid[self.sharded.rows[0]][0]
            # the unsharded optimizer's parameter order, which keys a
            # checkpoint's AdamW state
            self._param_names = [name for name, _ in init.named_parameters()]
        self.lr = lr
        self.temperature = temperature
        self.batch_size = batch_size
        self.seed = seed
        self.optimizer = optimizer
        self.weight_decay = weight_decay
        self._opt = self._make_optimizer() if optimizer == "adamw" else None

    def _make_optimizer(self) -> torch.optim.AdamW:
        if self.sharded is not None:
            return adamw(self.sharded, self.lr, self.weight_decay)
        return torch.optim.AdamW(self.encoder.parameters(), lr=self.lr, betas=(0.9, 0.999),
                                 eps=1e-8, weight_decay=self.weight_decay)

    def state_dict(self) -> dict[str, torch.Tensor]:
        """The weights as one flat state dict (gathered under a mesh)."""
        if self.sharded is not None:
            return gather_params(self.sharded)
        return self.encoder.state_dict()

    def load_params(self, flat: dict) -> None:
        """Load a flat state dict (tensors or arrays) into the weights;
        under a mesh it is sharded anew and the optimizer starts over."""
        if self.sharded is None:
            self.encoder.load_state_dict({k: v if isinstance(v, torch.Tensor) else torch.as_tensor(v)
                                          for k, v in flat.items()})
            return
        self.sharded = shard_params(flat, self.config, self.mesh)
        if self._opt is not None:
            self._opt = self._make_optimizer()

    def _make_batch(self, pairs: list[tuple[str, str]]) -> dict[str, torch.Tensor]:
        queries, docs = zip(*pairs)
        cfg = self.config
        q_ids, q_mask = hash_tokenize(list(queries), cfg.vocab_size, cfg.max_len)
        d_ids, d_mask = hash_tokenize(list(docs), cfg.vocab_size, cfg.max_len)
        # under a mesh the batch stays on the host: the step sends each dp
        # row's block to its tp group
        dev = self.device if self.sharded is None else torch.device("cpu")
        return {
            "q_ids": torch.from_numpy(q_ids).to(dev, torch.int64),
            "q_mask": torch.from_numpy(q_mask).to(dev),
            "d_ids": torch.from_numpy(d_ids).to(dev, torch.int64),
            "d_mask": torch.from_numpy(d_mask).to(dev),
        }

    def step(self, batch: dict[str, torch.Tensor]) -> torch.Tensor:
        """One optimizer step on ``batch``; the loss stays on the device."""
        if self.sharded is not None:
            return sharded_contrastive_train_step(self.sharded, batch, lr=self.lr,
                                                  temperature=self.temperature,
                                                  optimizer=self._opt)
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
        params = {k: v.detach().cpu().numpy() for k, v in self.state_dict().items()}
        opt_state = self._optimizer_state()
        if process_rank() != 0:
            return path
        tmp = path.with_name(f".{path.name}.{os.getpid()}.tmp")
        shutil.rmtree(tmp, ignore_errors=True)
        tmp.mkdir(parents=True)
        np.savez(tmp / "params.npz", **params)
        torch.save({"step": int(step), "optimizer": opt_state}, tmp / "state.pt")
        shutil.rmtree(path, ignore_errors=True)
        tmp.rename(path)
        return path

    def _optimizer_state(self) -> dict | None:
        """The optimizer's state dict in the unsharded form: under a mesh
        each state tensor is gathered like its parameter and keyed by the
        unsharded module's parameter order."""
        if self._opt is None or self.sharded is None:
            return None if self._opt is None else self._opt.state_dict()
        sp, opt = self.sharded, self._opt
        group = {k: v for k, v in opt.state_dict()["param_groups"][0].items() if k != "params"}
        names = self._param_names
        state = {}
        first = sp.shards[sp.rows[0]][0]
        if opt.state.get(first[names[0]]):
            for key in ("exp_avg", "exp_avg_sq"):
                full = gather_tree(sp, pick=lambda t, key=key: opt.state[t][key])
                for idx, name in enumerate(names):
                    state.setdefault(idx, {"step": opt.state[first[name]]["step"].clone()})
                    state[idx][key] = full[name]
        return {"state": state, "param_groups": [{**group, "params": list(range(len(names)))}]}

    def _load_optimizer_state(self, saved: dict) -> None:
        if self.sharded is None:
            self._opt.load_state_dict(saved)
            return
        sp, opt = self.sharded, self._opt
        names = self._param_names
        for i, j, name, t in sp.entries():
            entry = saved["state"].get(names.index(name))
            if entry is None:
                continue
            spec = sp.specs[name]
            opt.state[t] = {
                "step": entry["step"].clone(),
                **{key: place(tp_slice(entry[key], spec, j, sp.tp, name), t.device)
                   for key in ("exp_avg", "exp_avg_sq")},
            }

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
        self.load_params(load_params(path / "params.npz"))
        state = torch.load(path / "state.pt", map_location=self.device, weights_only=True)
        if self._opt is not None:
            if state["optimizer"] is None:
                raise ValueError(f"{path} holds no optimizer state (written under sgd)")
            self._load_optimizer_state(state["optimizer"])
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
        if self.mesh is not None:
            dp = self.mesh.shape.get("dp", 1)
            if len(pairs) < dp:
                raise ValueError(
                    f"need at least dp={dp} training pairs for this mesh, have {len(pairs)}"
                )
            bsz = max(dp, bsz - bsz % dp)
            # bsz started <= len(pairs) and dp <= len(pairs) is enforced
            # above, so the dp alignment keeps bsz <= len(pairs)
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
        """The flat ``.npz`` of ``save_params`` (gathered under a mesh; in
        several processes rank 0 writes it)."""
        if process_rank() == 0:
            np.savez(path, **{k: v.detach().cpu().numpy() for k, v in self.state_dict().items()})

    def as_embedding(self, batch_size: int = 256):
        """Wrap the trained weights as an embedding adapter for indexing, on
        the trainer's device (a copy: further training does not move it)."""
        from autorag_research_tpu_torch.embeddings.torch_encoder import (
            TorchEncoderEmbedding,
            TorchEncoderMultiVectorEmbedding,
        )

        cls = TorchEncoderMultiVectorEmbedding if self.config.multi_vector else TorchEncoderEmbedding
        emb = cls(self.config, batch_size=batch_size, seed=self.seed, device=self.device)
        emb.encoder.load_state_dict(self.state_dict())
        return emb
