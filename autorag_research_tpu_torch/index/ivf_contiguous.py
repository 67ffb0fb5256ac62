"""Cluster-contiguous IVF on one GPU: k-means cells packed as row blocks.

Counterpart of ``autorag_research_tpu/index/ivf_contiguous.py``:

- the rows of each k-means cell are copied, cell by cell, into fixed-size
  blocks ``[n_blocks, block_rows, d]`` (a cell owns ceil(size / block_rows)
  blocks; a tail block is zero-padded, its pad ids ``n``);
- each block carries a search key, the normalized mean of its rows, so that
  probing ranks blocks directly;
- search scores every key, takes each query's top ``nprobe_blocks`` blocks
  (``jax.lax.top_k``'s order: ``ops/topk.py::topk_ordered``), gathers them
  whole and ranks their rows exactly by ``(-score, id)``, the gathers of as
  many queries at a time as fit ``index/ivf.py::GATHER_BUDGET_BYTES``.

The k-means is ``index/ivf.py::train_centroids`` (the JAX package's sample
and initial rows, deterministic per-cell sums); a row's cell is the first
maximum of its similarities (``torch.argmax``, as ``jnp.argmax``); the
packing is the JAX package's host loop.

``placement``: ``"device"`` (the default) keeps the blocks on ``device``;
``"host"`` keeps them in host memory (pinned when ``device`` is a GPU) with
only the keys on ``device``, and a search copies the union of its batch's
probed blocks in one transfer. The JAX package names the mode ``device``:
its ``"tpu"`` is ``placement="device"`` and its ``"host"`` is
``placement="host"`` (:func:`placement_of`), as the pipeline reads a JAX
config's ``device`` option and ``load`` an artifact's. Artifacts
(``ivf_cc.npz`` + ``meta.json``) have the JAX package's names, keys and
``device`` values; the port stores the arrays uncompressed.
"""

from __future__ import annotations

import json
import threading
import time
from pathlib import Path
from typing import Any, Sequence

import numpy as np
import torch

from autorag_research_tpu_torch.exceptions import EmbeddingMissingError, IndexNotBuiltError
from autorag_research_tpu_torch.index.base import SearchHit
from autorag_research_tpu_torch.index.dense import l2_normalize
from autorag_research_tpu_torch.index.ivf import (
    GATHER_BUDGET_BYTES,
    _sync,
    hits_of,
    queries_on,
    train_centroids,
)
from autorag_research_tpu_torch.ops.topk import INT_MAX, NEG_INF, sort_topk, topk_ordered

# the JAX package's placement modes (its ``device`` argument) -> placement
JAX_PLACEMENTS = {"tpu": "device", "host": "host"}
ASSIGN_CHUNK_ROWS = 262144


def placement_of(mode: str) -> str:
    """The port's placement of a JAX ``device`` mode, or of its own value."""
    if mode in JAX_PLACEMENTS:
        return JAX_PLACEMENTS[mode]
    if mode in ("device", "host"):
        return mode
    raise ValueError(f"unknown placement: {mode!r} (device, host; or the JAX modes tpu, host)")


def _probe_blocks(queries: torch.Tensor, block_keys: torch.Tensor, p: int) -> torch.Tensor:
    """[Q, p] int32: each query's top ``p`` blocks by key similarity."""
    return topk_ordered(queries @ block_keys.T, p)[1]


def _score_blocks(queries, block_data, block_ids, top_blocks, k: int, n_real: int):
    """(scores, rows) [Q, k] over the rows of each query's blocks
    ``top_blocks`` [Q, p] of ``block_data`` [B, S, d] / ``block_ids`` [B, S]
    (JAX ``_score_blocks``); pad rows are masked to ``(NEG_INF, INT_MAX)``."""
    p = top_blocks.shape[1]
    _, s_rows, d = block_data.shape
    step = max(1, GATHER_BUDGET_BYTES // (p * s_rows * d * block_data.element_size()))
    out_s, out_i = [], []
    for lo in range(0, queries.shape[0], step):
        blks = top_blocks[lo : lo + step].long()
        data = block_data[blks].flatten(1, 2)  # [c, p * S, d]
        ids = block_ids[blks].flatten(1)
        scores = torch.bmm(data, queries[lo : lo + step, :, None])[..., 0]
        valid = ids < n_real
        s, i = sort_topk(torch.where(valid, scores, NEG_INF), torch.where(valid, ids, INT_MAX), k)
        out_s.append(s)
        out_i.append(i)
    return torch.cat(out_s), torch.cat(out_i)


class IVFContiguousIndex:
    """Block-contiguous IVF ANN over L2-normalized embeddings.

    ``n_cells`` defaults to ``max(8, 2 sqrt(n))`` (at most n) and
    ``nprobe_blocks`` to a 32nd of the blocks. ``build_seconds`` splits the
    build: normalize, upload, k-means (sampling included), assignment (with
    its read-back) and packing."""

    def __init__(
        self,
        ids: Sequence[Any],
        embeddings: np.ndarray,
        n_cells: int | None = None,
        block_rows: int = 256,
        nprobe_blocks: int | None = None,
        kmeans_iterations: int = 8,
        seed: int = 0,
        device: str | torch.device = "cuda",
        placement: str = "device",
    ):
        t0 = time.perf_counter()
        self.placement = placement_of(placement)
        self.device = torch.device(device)
        self.ids = list(ids)
        n = len(self.ids)
        mat = l2_normalize(np.asarray(embeddings, np.float32))
        self._n = n
        self.block_rows = block_rows
        self.n_cells = min(n_cells or max(8, int(np.sqrt(max(n, 1)) * 2)), max(n, 1))
        self._device: tuple | None = None
        self._lazy = threading.Lock()  # a first search from several threads uploads once
        self.build_seconds = {"normalize": time.perf_counter() - t0}
        self._build(mat, seed, kmeans_iterations)
        self.nprobe_blocks = nprobe_blocks or max(1, self.n_blocks // 32)

    # ------------------------------------------------------------------ build
    def _build(self, mat: np.ndarray, seed: int, iterations: int) -> None:
        secs = self.build_seconds
        n, d = mat.shape
        t0 = time.perf_counter()
        rng = np.random.default_rng(seed)
        data = torch.from_numpy(mat).to(self.device)
        _sync(self.device)
        secs["upload"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        centroids = train_centroids(data, self.n_cells, iterations, rng)
        self.centroids = centroids.cpu().numpy()
        secs["kmeans"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        assign = torch.cat([
            torch.argmax(data[lo : lo + ASSIGN_CHUNK_ROWS] @ centroids.T, dim=1)
            for lo in range(0, n, ASSIGN_CHUNK_ROWS)
        ]).to(torch.int32).cpu().numpy()
        del data
        secs["assign"] = time.perf_counter() - t0

        # rows copied cell by cell into fixed-size blocks
        t0 = time.perf_counter()
        s = self.block_rows
        order = np.argsort(assign, kind="stable")
        _, counts = np.unique(assign, return_counts=True)
        self.n_blocks = int((-(-counts // s)).sum())
        blocks = np.zeros((self.n_blocks, s, d), dtype=np.float32)
        row_ids = np.full((self.n_blocks, s), n, dtype=np.int32)  # pad -> n
        keys = np.zeros((self.n_blocks, d), dtype=np.float32)
        b = pos = 0
        for count in counts:
            rows = order[pos : pos + count]
            pos += count
            for lo in range(0, count, s):
                part = rows[lo : lo + s]
                blocks[b, : len(part)] = mat[part]
                row_ids[b, : len(part)] = part
                keys[b] = l2_normalize(mat[part].mean(axis=0, keepdims=True))[0]
                b += 1
        self._blocks = blocks
        self._row_ids = row_ids
        self._keys = keys
        secs["pack"] = time.perf_counter() - t0

    def to_device(self) -> "IVFContiguousIndex":
        """Keys on the device; the blocks there too (``placement="device"``)
        or in host memory, pinned for a GPU (``"host"``)."""
        keys = torch.from_numpy(self._keys).to(self.device)
        if self.placement == "host":
            blocks = torch.from_numpy(self._blocks)
            self._device = (keys, blocks.pin_memory() if self.device.type == "cuda" else blocks, None)
        else:
            self._device = (
                keys,
                torch.from_numpy(self._blocks).to(self.device),
                torch.from_numpy(self._row_ids).to(self.device),
            )
        return self

    def device_bytes(self) -> int:
        """Bytes of the index's tensors on its device (the keys alone when the
        blocks stay on the host)."""
        if self._device is None:
            return 0
        on = self._device if self.placement == "device" else self._device[:1]
        return sum(t.numel() * t.element_size() for t in on)

    # ----------------------------------------------------------------- search
    def topk_rows(self, query_embeddings, k: int, nprobe_blocks: int | None = None):
        """Batch search -> host (scores, rows) [Q, min(k, n)]; a row of
        ``n`` or more is no hit."""
        if self._n == 0:
            raise IndexNotBuiltError("index has no documents")
        with self._lazy:
            if self._device is None:
                self.to_device()
        keys, blocks, row_ids = self._device  # type: ignore[misc]
        q = queries_on(query_embeddings, self.device)
        top_blocks = _probe_blocks(q, keys, min(nprobe_blocks or self.nprobe_blocks, self.n_blocks))
        k_eff = min(k, self._n)
        if self.placement == "host":
            scores, rows = self._search_host(q, blocks, top_blocks, k_eff)
        else:
            scores, rows = _score_blocks(q, blocks, row_ids, top_blocks, k_eff, self._n)
        return scores.cpu().numpy(), rows.cpu().numpy()

    def search(
        self, query_embeddings, k: int, nprobe_blocks: int | None = None
    ) -> list[list[SearchHit]]:
        return hits_of(self.ids, *self.topk_rows(query_embeddings, k, nprobe_blocks), self._n)

    def _search_host(self, q: torch.Tensor, blocks: torch.Tensor, top_blocks: torch.Tensor, k: int):
        """The batch's union of probed blocks, gathered on the host (into
        pinned memory for a GPU) and copied to the device in one transfer,
        then scored as the device placement scores its own blocks."""
        uniq, inverse = np.unique(top_blocks.cpu().numpy(), return_inverse=True)
        inverse = inverse.reshape(top_blocks.shape)
        sel = torch.from_numpy(uniq)
        payload = torch.empty((len(uniq), *blocks.shape[1:]), dtype=blocks.dtype,
                              pin_memory=blocks.is_pinned())
        torch.index_select(blocks, 0, sel, out=payload)
        return _score_blocks(
            q, payload.to(self.device, non_blocking=True),
            torch.from_numpy(self._row_ids[uniq]).to(self.device),
            torch.from_numpy(inverse).to(self.device), k, self._n,
        )

    # ------------------------------------------------------------ persistence
    def save(self, path: str | Path) -> None:
        path = Path(path)
        path.mkdir(parents=True, exist_ok=True)
        np.savez(
            path / "ivf_cc.npz",
            blocks=self._blocks,
            row_ids=self._row_ids,
            keys=self._keys,
            centroids=self.centroids,
        )
        meta = {
            "kind": "ivf_contiguous",
            "n_cells": self.n_cells,
            "block_rows": self.block_rows,
            "nprobe_blocks": self.nprobe_blocks,
            "device": "host" if self.placement == "host" else "tpu",
            "ids": self.ids,
        }
        (path / "meta.json").write_text(json.dumps(meta, default=str))

    @classmethod
    def load(cls, path: str | Path, device: str | torch.device = "cuda") -> "IVFContiguousIndex":
        """An index from the files either package's ``save`` writes (the
        saved ``device`` mode is its placement); tensors go to ``device`` on
        first use."""
        path = Path(path)
        meta = json.loads((path / "meta.json").read_text())
        arrays = np.load(path / "ivf_cc.npz")
        idx = cls.__new__(cls)
        idx.ids = meta["ids"]
        idx.device = torch.device(device)
        idx.placement = placement_of(meta.get("device", "tpu"))
        idx.n_cells = meta["n_cells"]
        idx.block_rows = meta["block_rows"]
        idx.nprobe_blocks = meta["nprobe_blocks"]
        idx._blocks = arrays["blocks"]
        idx._row_ids = arrays["row_ids"]
        idx._keys = arrays["keys"]
        idx.centroids = arrays["centroids"]
        idx.n_blocks = idx._blocks.shape[0]
        idx._n = len(idx.ids)
        idx._device = None
        idx._lazy = threading.Lock()
        idx.build_seconds = {}
        return idx

    @classmethod
    def from_catalog(cls, catalog, table: str = "chunk", **kwargs) -> "IVFContiguousIndex":
        ids, mat = catalog.get_embeddings_matrix(table)
        if not ids:
            raise EmbeddingMissingError(f"no embeddings in table '{table}'")
        return cls(ids, mat, **kwargs)
