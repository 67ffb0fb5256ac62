"""IVF approximate dense index on one GPU: k-means cells + cell-probed search.

Counterpart of ``autorag_research_tpu/index/ivf.py``, the framework's
counterpart of the reference's default ANN index (VectorChord ``vchordrq``):

- **build**: spherical k-means on the device over a capped sample of the
  L2-normalized corpus (assignment is one [n, C] product an iteration, the
  centroid update a per-cell sum), then every document's top-8 cells by
  similarity, and on the host the JAX package's capacity-constrained packing
  into a ``[C, cell_pad]`` member table (round r places each unplaced
  document into its r-th cell while capacity lasts, best similarity first;
  leftovers go to the emptiest cells; nothing is dropped);
- **search**: queries score every centroid, probe the top ``nprobe`` cells,
  gather those cells' members' vectors and rank them exactly by
  ``(-score, id)``.

The sample and the initial centroids come from the same
``np.random.default_rng(seed)`` calls as the JAX package's, so both start
from the same rows. Products are true f32 (no TF32). The per-cell sum is a
one-hot product in chunks, not an atomic scatter, so two builds with one
seed on one machine give bitwise-equal centroids, members and cells. Ties
select as ``jax.lax.top_k`` / ``jnp.argmax`` do: the lower index first
(``ops/topk.py::topk_ordered``, ``torch.argmax``). The search gathers the
candidates of as many queries at a time as fit :data:`GATHER_BUDGET_BYTES`
(one query's alone may exceed it), never a whole batch's.

The corpus stays on ``device`` (the card by default) from the build on.
Artifacts (``ivf.npz`` + ``meta.json``) have the JAX package's names and keys,
so either package loads what the other saved; the port stores the arrays
uncompressed. A mesh raises ``NotImplementedError``.
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
from autorag_research_tpu_torch.index.dense import _l2_normalize_device, l2_normalize
from autorag_research_tpu_torch.ops.topk import INT_MAX, NEG_INF, sort_topk, topk_ordered

# bytes of gathered candidate vectors a search step may hold
GATHER_BUDGET_BYTES = 1 << 30
# bytes of the one-hot matrix of a k-means update step, and rows of the
# [rows, C] similarity matrix of an assignment step
ONE_HOT_BUDGET_BYTES = 1 << 28
ASSIGN_CHUNK_ROWS = 131072


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _cell_sums(data: torch.Tensor, assign: torch.Tensor, n_cells: int) -> torch.Tensor:
    """[C, d] per-cell sums of ``data`` rows (JAX ``segment_sum``) as one-hot
    products over row chunks: deterministic, where an atomic scatter's f32
    sums change from run to run."""
    cells = torch.arange(n_cells, device=data.device)[:, None]
    step = max(1, ONE_HOT_BUDGET_BYTES // (4 * n_cells))
    sums = data.new_zeros((n_cells, data.shape[1]))
    for lo in range(0, data.shape[0], step):
        one_hot = (assign[None, lo : lo + step] == cells).to(data.dtype)
        sums += one_hot @ data[lo : lo + step]
    return sums


def _kmeans(data: torch.Tensor, init_idx: torch.Tensor, n_cells: int, iterations: int) -> torch.Tensor:
    """Spherical k-means (JAX ``_kmeans``): assignment by the largest
    similarity (first maximum), centroids the normalized mean of their rows;
    an empty cell keeps its centroid."""
    centroids = data[init_idx]
    for _ in range(iterations):
        assign = torch.argmax(data @ centroids.T, dim=1)
        sums = _cell_sums(data, assign, n_cells)
        counts = torch.bincount(assign, minlength=n_cells).to(data.dtype)[:, None]
        new = torch.where(counts > 0, sums / torch.clamp(counts, min=1.0), centroids)
        norms = torch.linalg.vector_norm(new, dim=1, keepdim=True)
        centroids = torch.where(norms > 0, new / torch.where(norms == 0, 1.0, norms), new)
    return centroids


def train_centroids(data: torch.Tensor, n_cells: int, iterations: int, rng) -> torch.Tensor:
    """Sampled k-means shared by :class:`IVFIndex` and ``IVFContiguousIndex``
    (JAX ``train_centroids``): the sample, sorted, and the initial rows are
    drawn by the JAX package's ``rng`` calls; ``data`` stays on its device."""
    n = data.shape[0]
    sample_cap = max(n_cells * 64, 50_000)
    if n > sample_cap:
        sample = np.sort(rng.choice(n, size=sample_cap, replace=False))
        train = data[torch.from_numpy(sample).to(data.device)]
    else:
        train = data
    n_train = train.shape[0]
    init_idx = rng.choice(n_train, size=n_cells, replace=n_train < n_cells)
    return _kmeans(train, torch.from_numpy(np.asarray(init_idx)).to(data.device), n_cells, iterations)


def _assign_prefs(data: torch.Tensor, centroids: torch.Tensor, n_prefs: int):
    """Top-``n_prefs`` cells a row (cells int32, similarities f32), over row
    chunks: only a [chunk, C] similarity matrix exists at a time."""
    cells, sims = [], []
    for lo in range(0, data.shape[0], ASSIGN_CHUNK_ROWS):
        s, c = topk_ordered(data[lo : lo + ASSIGN_CHUNK_ROWS] @ centroids.T, n_prefs)
        cells.append(c)
        sims.append(s)
    return torch.cat(cells), torch.cat(sims)


def _ivf_search(queries, corpus, centroids, members, k: int, nprobe: int):
    """(scores, rows) [Q, k] by ``(-score, row)`` over the members of each
    query's top ``nprobe`` cells (JAX ``_ivf_search``); ``corpus`` ends with
    a zero row that member pads point at, masked to ``(NEG_INF, INT_MAX)``."""
    n_real, d = corpus.shape[0] - 1, corpus.shape[1]
    _, top_cells = topk_ordered(queries @ centroids.T, nprobe)
    per_query = nprobe * members.shape[1] * d * corpus.element_size()
    step = max(1, GATHER_BUDGET_BYTES // per_query)
    out_s, out_i = [], []
    for lo in range(0, queries.shape[0], step):
        idx = members[top_cells[lo : lo + step].long()].flatten(1)  # [c, nprobe * cell_pad]
        scores = torch.bmm(corpus[idx.long()], queries[lo : lo + step, :, None])[..., 0]
        valid = idx < n_real
        s, i = sort_topk(torch.where(valid, scores, NEG_INF), torch.where(valid, idx, INT_MAX), k)
        out_s.append(s)
        out_i.append(i)
    return torch.cat(out_s), torch.cat(out_i)


def queries_on(query_embeddings, device: torch.device) -> torch.Tensor:
    """L2-normalized [Q, d] f32 queries on ``device``: numpy on the host (as
    the JAX package does), a tensor on ``device``."""
    if isinstance(query_embeddings, torch.Tensor):
        q = query_embeddings.to(device, torch.float32)
        return _l2_normalize_device(q[None, :] if q.ndim == 1 else q).contiguous()
    q = l2_normalize(np.atleast_2d(np.asarray(query_embeddings, np.float32)))
    return torch.from_numpy(q).to(device)


def hits_of(ids: list, scores: np.ndarray, rows: np.ndarray, n: int) -> list[list[SearchHit]]:
    return [
        [SearchHit(ids[int(r)], float(s)) for s, r in zip(qs, qr) if r < n and s > -1e37]
        for qs, qr in zip(scores, rows)
    ]


class IVFIndex:
    """Cell-probed ANN over L2-normalized embeddings on one device.

    ``n_cells`` defaults to ``max(8, 2 sqrt(n))`` (at most n), ``nprobe`` to a
    tenth of the cells, ``cell_pad`` to ``pad_factor`` x the mean cell size,
    floored so that the table holds every document. ``build_seconds`` splits
    the build: normalize, upload, k-means (sampling included), assignment
    (with its read-back) and packing."""

    def __init__(
        self,
        ids: Sequence[Any],
        embeddings: np.ndarray,
        n_cells: int | None = None,
        nprobe: int | None = None,
        pad_factor: float = 2.0,
        kmeans_iterations: int = 8,
        seed: int = 0,
        device: str | torch.device = "cuda",
    ):
        t0 = time.perf_counter()
        self.ids = list(ids)
        n = len(self.ids)
        self.device = torch.device(device)
        mat = l2_normalize(np.asarray(embeddings, np.float32))
        self.n_cells = n_cells or max(8, int(np.sqrt(max(n, 1)) * 2))
        self.n_cells = min(self.n_cells, max(n, 1))
        self.nprobe = nprobe or max(1, self.n_cells // 10)
        self.pad_factor = pad_factor
        self.kmeans_iterations = kmeans_iterations
        self.cell_pad = max(
            8,
            int(np.ceil(n / self.n_cells)),
            int(np.ceil(n / self.n_cells * pad_factor)),
        )
        self._n = n
        self._host = mat
        self._device: tuple[torch.Tensor, torch.Tensor, torch.Tensor] | None = None
        self._lazy = threading.Lock()  # a first search from several threads uploads once
        self.build_seconds = {"normalize": time.perf_counter() - t0}
        self._build(seed, kmeans_iterations)

    # ------------------------------------------------------------------ build
    def _upload_corpus(self) -> torch.Tensor:
        """[n + 1, d] f32 on the device: the corpus, then the zero row that
        member pads point at."""
        corpus = torch.zeros((self._n + 1, self._host.shape[1]), dtype=torch.float32, device=self.device)
        corpus[: self._n].copy_(torch.from_numpy(self._host))
        return corpus

    def _build(self, seed: int, iterations: int) -> None:
        secs = self.build_seconds
        t0 = time.perf_counter()
        rng = np.random.default_rng(seed)
        corpus = self._upload_corpus()
        data = corpus[: self._n]
        _sync(self.device)
        secs["upload"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        centroids = train_centroids(data, self.n_cells, iterations, rng)
        self.centroids = centroids.cpu().numpy()
        secs["kmeans"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        pref_cells, pref_sims = _assign_prefs(data, centroids, min(8, self.n_cells))
        pref_cells = pref_cells.cpu().numpy()  # [n, P] a document's cells by preference
        pref_sims = pref_sims.cpu().numpy()
        secs["assign"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        counts = np.zeros(self.n_cells, dtype=np.int64)
        members = np.full((self.n_cells, self.cell_pad), self._n, dtype=np.int32)
        remaining = np.arange(self._n)
        for r in range(pref_cells.shape[1]):
            if len(remaining) == 0:
                break
            cells_r = pref_cells[remaining, r]
            order = np.argsort(-pref_sims[remaining, r])
            unplaced = []
            for pos in order:
                doc = remaining[pos]
                cell = cells_r[pos]
                if counts[cell] < self.cell_pad:
                    members[cell, counts[cell]] = doc
                    counts[cell] += 1
                else:
                    unplaced.append(doc)
            remaining = np.asarray(unplaced, dtype=np.int64)
        for doc in remaining:  # leftovers -> the emptiest cells
            cell = int(np.argmin(counts))
            members[cell, counts[cell]] = doc
            counts[cell] += 1
        self.members = members
        self.cell_counts = counts
        secs["pack"] = time.perf_counter() - t0
        self._device = (corpus, centroids, torch.from_numpy(members).to(self.device))

    def to_device(self, mesh=None) -> "IVFIndex":
        if mesh is not None:
            raise NotImplementedError("a mesh-sharded IVFIndex is ported with the multi-GPU slice")
        with self._lazy:
            if self._device is None:
                self._device = (
                    self._upload_corpus(),
                    torch.from_numpy(np.asarray(self.centroids, np.float32)).to(self.device),
                    torch.from_numpy(np.asarray(self.members, np.int32)).to(self.device),
                )
        return self

    def device_bytes(self) -> int:
        """Bytes of the index's tensors on its device."""
        return sum(t.numel() * t.element_size() for t in self._device or ())

    # ----------------------------------------------------------------- search
    def topk_rows(self, query_embeddings, k: int, nprobe: int | None = None):
        """Batch search -> host (scores, rows) [Q, min(k, n)]; a row of
        ``n`` or more is no hit."""
        if self._n == 0:
            raise IndexNotBuiltError("index has no documents")
        corpus, centroids, members = self.to_device()._device  # type: ignore[misc]
        scores, rows = _ivf_search(
            queries_on(query_embeddings, self.device), corpus, centroids, members,
            min(k, self._n), min(nprobe or self.nprobe, self.n_cells),
        )
        return scores.cpu().numpy(), rows.cpu().numpy()

    def search(self, query_embeddings, k: int, nprobe: int | None = None) -> list[list[SearchHit]]:
        return hits_of(self.ids, *self.topk_rows(query_embeddings, k, nprobe), self._n)

    # ------------------------------------------------------------ persistence
    def save(self, path: str | Path) -> None:
        path = Path(path)
        path.mkdir(parents=True, exist_ok=True)
        np.savez(
            path / "ivf.npz",
            embeddings=self._host,
            centroids=self.centroids,
            members=self.members,
            cell_counts=self.cell_counts,
        )
        meta = {
            "kind": "ivf",
            "n_cells": self.n_cells,
            "nprobe": self.nprobe,
            "cell_pad": self.cell_pad,
            "pad_factor": self.pad_factor,
            "kmeans_iterations": self.kmeans_iterations,
            "ids": self.ids,
        }
        (path / "meta.json").write_text(json.dumps(meta, default=str))

    @classmethod
    def load(cls, path: str | Path, device: str | torch.device = "cuda") -> "IVFIndex":
        """An index from the files either package's ``save`` writes; its
        tensors go to ``device`` on first use."""
        path = Path(path)
        meta = json.loads((path / "meta.json").read_text())
        arrays = np.load(path / "ivf.npz")
        idx = cls.__new__(cls)
        idx.ids = meta["ids"]
        idx.device = torch.device(device)
        idx.n_cells = meta["n_cells"]
        idx.nprobe = meta["nprobe"]
        idx.cell_pad = meta["cell_pad"]
        idx.pad_factor = float(meta.get("pad_factor", 2.0))
        idx.kmeans_iterations = int(meta.get("kmeans_iterations", 8))
        idx._host = arrays["embeddings"]
        idx.centroids = arrays["centroids"]
        idx.members = arrays["members"]
        idx.cell_counts = arrays["cell_counts"]
        idx._n = len(idx.ids)
        idx._device = None
        idx._lazy = threading.Lock()
        idx.build_seconds = {}
        return idx

    @classmethod
    def from_catalog(cls, catalog, table: str = "chunk", **kwargs) -> "IVFIndex":
        ids, mat = catalog.get_embeddings_matrix(table)
        if not ids:
            raise EmbeddingMissingError(f"no embeddings in table '{table}'")
        return cls(ids, mat, **kwargs)
