"""Dense single-vector index: corpus embeddings resident in GPU memory.

Counterpart of ``autorag_research_tpu/index/dense.py`` on one device.
Vectors are L2-normalized at build and query time, so the kernels' raw dot
product is the cosine similarity (the reference's ``1 - cosine_distance``);
with ``metric="ip"`` the raw inner product is returned instead. Artifacts
(``embeddings.npy`` + ``meta.json``) have the JAX package's format, so either
package loads what the other saved. On the card the corpus is stored with d
zero-padded to a multiple of 8, the kernels' unit, and queries are padded to
its width; zero lanes leave every score unchanged. The int8 corpus also
gets zero rows up to a multiple of 16, which its search masks.
"""

from __future__ import annotations

import json
import threading
from pathlib import Path
from typing import Any, Sequence

import numpy as np
import torch

from autorag_research_tpu_torch.exceptions import EmbeddingMissingError, IndexNotBuiltError
from autorag_research_tpu_torch.index.base import SearchHit
from autorag_research_tpu_torch.ops.dense import (
    build_verified_sidecar,
    dense_topk,
    dense_topk_int8,
    dense_topk_verified,
    device_width,
    int8_rows,
    pad_width,
    quantize_int8,
)
from autorag_research_tpu_torch.utils.concurrency import map_row_chunks

# the verified sidecar pads its bf16 rows to this multiple
_SIDECAR_PAD_ROWS = 2048


def _device_memory_bytes(device: torch.device) -> int:
    """Device memory for capacity checks; a CPU device has no limit."""
    if device.type != "cuda":
        return 1 << 62
    _free, total = torch.cuda.mem_get_info(device)
    return int(total)


# rows of a matrix normalized at a time, chunks in threads: each row's
# arithmetic is its own, so the result is the whole matrix's bit for bit
_NORMALIZE_CHUNK_ROWS = 16384


def _l2_normalize_rows(x: np.ndarray) -> np.ndarray:
    norms = np.linalg.norm(x, axis=-1, keepdims=True)
    return np.where(norms > 0, x / np.where(norms == 0, 1.0, norms), 0.0)


def l2_normalize(x: np.ndarray) -> np.ndarray:
    """Row-normalize; zero rows stay zero (cosine undefined -> score 0)."""
    x = np.asarray(x, dtype=np.float32)
    if x.ndim != 2 or x.shape[0] <= _NORMALIZE_CHUNK_ROWS:
        return _l2_normalize_rows(x)
    out = np.empty_like(x)

    def part(rows: slice) -> None:
        out[rows] = _l2_normalize_rows(x[rows])

    map_row_chunks(part, x.shape[0], _NORMALIZE_CHUNK_ROWS)
    return out


def _l2_normalize_device(q: torch.Tensor) -> torch.Tensor:
    norms = torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    return torch.where(norms > 0, q / torch.where(norms == 0, 1.0, norms), 0.0)


class DenseIndex:
    """Dense top-k over an [N, d] corpus tensor on one device.

    Modes: ``"exact"`` (:func:`dense_topk`); ``"verified"``
    (:func:`dense_topk_verified`: a bf16 prescreen through the seg-stats
    kernel plus a bound-checked f32 rescore; results always equal
    ``"exact"``, tie order included); the serving modes ``"approx"``
    (:func:`dense_topk` ``method="approx"``: the JAX package's
    ``approx_max_k`` mode, whose selection the port makes exact, so its ids
    equal ``"exact"``'s up to the scores' rounding) and ``"int8"``
    (:func:`dense_topk_int8`: a per-row int8 corpus, 4x fewer device bytes,
    approximate: the JAX package documents 98% top-10 agreement with f32).
    """

    def __init__(
        self,
        ids: Sequence[Any],
        embeddings: np.ndarray,
        metric: str = "cosine",
        dtype: str = "float32",
        mode: str = "exact",
        device: str | torch.device = "cuda",
    ):
        if mode not in ("exact", "verified", "approx", "int8"):
            raise ValueError(f"unknown mode: {mode}")
        if len(ids) != embeddings.shape[0]:
            raise ValueError("ids/embeddings length mismatch")
        if metric not in ("cosine", "ip"):
            raise ValueError(f"unknown metric: {metric}")
        self.ids = list(ids)
        self.metric = metric
        self.dtype = dtype
        self.mode = mode
        self.device = torch.device(device)
        self._sidecar: dict | None = None
        self._device_scale: torch.Tensor | None = None
        # (n_fail, covered) of the last verified search: the proof's outcome
        self.last_stats: tuple[int, bool] | None = None
        mat = np.asarray(embeddings, dtype=np.float32)
        if metric == "cosine":
            mat = l2_normalize(mat)
        self._host = mat
        self._device: torch.Tensor | None = None
        self._n = mat.shape[0]
        # a first search from several threads uploads once
        self._lazy = threading.Lock()

    # ------------------------------------------------------------- lifecycle
    @classmethod
    def from_catalog(
        cls, catalog, table: str = "chunk", metric: str = "cosine",
        dtype: str = "float32", mode: str = "exact", device: str | torch.device = "cuda",
    ):
        ids, mat = catalog.get_embeddings_matrix(table)
        if not ids:
            raise EmbeddingMissingError(f"no embedded rows in table '{table}'")
        return cls(ids, mat, metric=metric, dtype=dtype, mode=mode, device=device)

    @property
    def n_docs(self) -> int:
        return self._n

    @property
    def dim(self) -> int:
        return self._host.shape[1]

    def verified_device_bytes(self) -> int:
        """Resident bytes the verified mode needs: the f32 corpus (rescore
        source) plus the padded bf16 prescreen sidecar, 6 bytes per
        (doc, dim)."""
        n, d = self._host.shape
        n_pad = -(-n // _SIDECAR_PAD_ROWS) * _SIDECAR_PAD_ROWS
        return n * d * 4 + n_pad * d * 2

    def device_bytes(self) -> int:
        """Bytes of the corpus tensors on the device: the corpus, the int8
        mode's per-row scales, the verified mode's bf16 sidecar."""
        tensors = [self._device, self._device_scale]
        if self._sidecar is not None:
            tensors.append(self._sidecar["corpus_lo"])
        return sum(t.numel() * t.element_size() for t in tensors if t is not None)

    def to_device(self) -> "DenseIndex":
        """Materialize the corpus (and the verified sidecar, or the int8
        scales) on the device."""
        if self.mode == "verified":
            need = self.verified_device_bytes()
            limit = _device_memory_bytes(self.device)
            if need > 0.85 * limit:
                raise IndexNotBuiltError(
                    f"verified mode needs ~{need / 2**30:.1f} GB (f32 corpus + "
                    f"bf16 sidecar) but the device has {limit / 2**30:.1f} GB. "
                    "Use mode='exact', or a corpus split over several devices."
                )
        width = device_width(self.dim, self.device)
        if self.mode == "int8":
            # quantize once on the host and ship int8: the f32 corpus never
            # occupies device memory. Zero rows up to int8_rows, scale 0,
            # which the search masks
            cq, cs = quantize_int8(self._host)
            pad = int8_rows(self._n, self.device) - self._n
            cq = torch.nn.functional.pad(pad_width(torch.from_numpy(cq), width), (0, 0, 0, pad))
            self._device = cq.to(self.device)
            self._device_scale = torch.nn.functional.pad(torch.from_numpy(cs), (0, pad)).to(self.device)
            return self
        dt = torch.bfloat16 if self.dtype == "bfloat16" else torch.float32
        self._device = pad_width(torch.from_numpy(self._host), width).to(self.device, dt)
        if self.mode == "verified":
            side = build_verified_sidecar(self._host, rep="bf16", pad_rows_to=_SIDECAR_PAD_ROWS)
            self._sidecar = {
                "corpus_lo": pad_width(side["corpus_lo"], width).to(self.device),
                "corpus_scale": None,
                "nd_max": side["nd_max"],
                "r_max": side["r_max"],
            }
        return self

    def _ensure_device(self) -> torch.Tensor:
        with self._lazy:
            if self._device is None:
                self.to_device()
            return self._device

    # ----------------------------------------------------------------- search
    def topk_rows(self, query_embeddings, k: int) -> tuple[np.ndarray, np.ndarray]:
        """Batch search -> (scores [Q, k], corpus row numbers [Q, k]).

        Accepts numpy or a ``torch.Tensor``: a tensor is normalized on the
        index's device and chained straight into the search with no host
        copy in between. A verified search leaves its proof's
        ``(n_fail, covered)`` in :attr:`last_stats`."""
        if self._n == 0:
            raise IndexNotBuiltError("index has no documents")
        corpus = self._ensure_device()
        if isinstance(query_embeddings, torch.Tensor):
            q = query_embeddings.to(self.device, torch.float32)
            if q.ndim == 1:
                q = q[None, :]
            if self.metric == "cosine":
                q = _l2_normalize_device(q)
        else:
            q = np.atleast_2d(np.asarray(query_embeddings, dtype=np.float32))
            if self.metric == "cosine":
                q = l2_normalize(q)
            q = torch.from_numpy(q).to(self.device)
        q = pad_width(q, corpus.shape[1])
        if self.mode == "int8":
            scores, rows = dense_topk_int8(
                q.float().contiguous(), corpus, self._device_scale, k, n_valid=self._n
            )
            return scores.cpu().numpy(), rows.cpu().numpy()
        q = q.to(corpus.dtype).contiguous()
        if self.mode == "verified":
            scores, rows, n_fail, covered = dense_topk_verified(
                q, corpus, self._sidecar, k, return_stats=True
            )
            self.last_stats = (n_fail, covered)
        else:
            method = "approx" if self.mode == "approx" else "auto"
            scores, rows = dense_topk(q, corpus, k, method=method)
        return scores.float().cpu().numpy(), rows.cpu().numpy()

    def search(self, query_embeddings, k: int) -> list[list[SearchHit]]:
        """Batch search returning doc ids + similarity scores (higher=better)."""
        k_eff = min(k, self._n)
        scores, rows = self.topk_rows(query_embeddings, k)
        return [
            [SearchHit(self.ids[r], float(s)) for s, r in zip(qs[:k_eff], qr[:k_eff])]
            for qs, qr in zip(scores, rows)
        ]

    # ------------------------------------------------------------ persistence
    def save(self, path: str | Path) -> None:
        path = Path(path)
        path.mkdir(parents=True, exist_ok=True)
        np.save(path / "embeddings.npy", self._host)
        meta = {
            "kind": "dense",
            "metric": self.metric,
            "dtype": self.dtype,
            "mode": self.mode,
            "n_docs": self._n,
            "dim": self.dim,
            "ids": self.ids,
        }
        (path / "meta.json").write_text(json.dumps(meta, default=str))

    @classmethod
    def load(cls, path: str | Path, device: str | torch.device = "cuda") -> "DenseIndex":
        path = Path(path)
        meta = json.loads((path / "meta.json").read_text())
        mat = np.load(path / "embeddings.npy")
        # the saved matrix is already normalized: bypass __init__'s pass
        idx = cls(meta["ids"], mat, metric="ip", dtype=meta.get("dtype", "float32"),
                  mode=meta.get("mode", "exact"), device=device)
        idx.metric = meta["metric"]
        return idx
