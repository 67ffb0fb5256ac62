"""Multi-vector (late interaction) index: ragged token embeddings on one GPU.

Counterpart of ``autorag_research_tpu/index/multi_vector.py``. Ragged
``[T_i, d]`` per-document matrices are padded to ``[N, Tmax, d]`` with a
token-count vector for masking. ``bucketize > 1`` partitions documents by
token count (``_plan_buckets``), pads each bucket only to its own maximum,
searches bucket by bucket and merges by global ``(-score, row)`` on the host,
so results equal the flat layout's exactly.

Modes: ``"exact"`` (:func:`maxsim_topk`: on the card the fused kernel for
k <= 16, the scores kernel beyond; ``search_method`` pins a kernel:
``"pallas"`` v1, ``"pallas_v2"``, ``"pallas_v3"``, or ``"xla"`` the scan),
``"verified"`` (:func:`maxsim_topk_verified`: bf16 prescreen through the
scores kernel, exact f32 rescore, results always equal ``"exact"``) and
``"int8"`` (:func:`maxsim_topk_int8`: per-token int8 tokens quantized on the
host, 1 byte per dim on the device plus a scale per token; approximate).
``search`` returns MaxSim / n_query_vectors (the reference's ``-distance /
n_query_vectors``). On the card the tokens are stored with d zero-padded to
a multiple of 8, the kernels' unit, and queries are padded to that width.
With a mesh (``to_device(mesh)``) the flat layout, never bucketed, is
row-sharded over the corpus axis (pad documents of length 0) and searched by
the engines of ``parallel/sharded.py`` in every mode; ``prefilter`` is then
ignored with a warning, as in the JAX package.
Artifacts (``mv.npz`` + ``meta.json``) have the JAX package's format, so
either package loads what the other saved.
"""

from __future__ import annotations

import json
import logging
import threading
from pathlib import Path
from typing import Any, Sequence

import numpy as np
import torch

from autorag_research_tpu_torch.exceptions import EmbeddingMissingError, IndexNotBuiltError
from autorag_research_tpu_torch.index.base import SearchHit
from autorag_research_tpu_torch.index.buckets import _plan_buckets
from autorag_research_tpu_torch.index.dense import l2_normalize
from autorag_research_tpu_torch.ops.dense import (
    INT_MAX,
    dense_topk,
    device_width,
    int8_rows,
    pad_width,
)
from autorag_research_tpu_torch.ops.maxsim import (
    build_maxsim_sidecar,
    maxsim_rerank,
    maxsim_topk,
    maxsim_topk_int8,
    maxsim_topk_verified,
    quantize_int8_tokens,
)
from autorag_research_tpu_torch.parallel.mesh import check_mesh
from autorag_research_tpu_torch.parallel.sharded import (
    ShardedRows,
    mesh_max,
    place_rows,
    sharded_maxsim_topk,
    sharded_maxsim_topk_int8,
    sharded_maxsim_topk_verified,
)

logger = logging.getLogger(__name__)


def pad_ragged(mats: Sequence[np.ndarray], max_tokens: int | None = None) -> tuple[np.ndarray, np.ndarray]:
    """list of [T_i, d] -> (padded [N, Tmax, d], lens [N])."""
    if not mats:
        return np.zeros((0, 1, 0), np.float32), np.zeros((0,), np.int32)
    tmax = max_tokens or max(m.shape[0] for m in mats)
    d = mats[0].shape[1]
    out = np.zeros((len(mats), tmax, d), dtype=np.float32)
    lens = np.zeros(len(mats), dtype=np.int32)
    for i, m in enumerate(mats):
        t = min(m.shape[0], tmax)
        out[i, :t] = m[:t]
        lens[i] = t
    return out, lens


def _mean_token_proxies(docs: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """Per-document single-vector proxy (normalized mean of the real token
    vectors): one definition for build and load, so the prefilter stage
    cannot diverge between fresh and restored indexes."""
    if len(docs):
        sums = docs.sum(axis=1)
        counts = np.maximum(lens[:, None], 1)
        return l2_normalize(sums / counts)
    return np.zeros((0, docs.shape[2]), np.float32)


class MultiVectorIndex:
    """Exact MaxSim top-k over padded token matrices on one device."""

    def __init__(
        self,
        ids: Sequence[Any],
        doc_matrices: Sequence[np.ndarray],
        normalize: bool = True,
        max_tokens: int | None = None,
        search_method: str = "auto",
        mode: str = "exact",
        bucketize: int = 1,
        device: str | torch.device = "cuda",
    ):
        if len(ids) != len(doc_matrices):
            raise ValueError("ids/doc_matrices length mismatch")
        if mode not in ("exact", "verified", "int8"):
            raise ValueError(f"unknown mode: {mode}")
        if bucketize < 1:
            raise ValueError("bucketize must be >= 1")
        self.ids = list(ids)
        self.normalize = normalize
        self.mode = mode
        # default route for search(): "auto" (ops/maxsim.maxsim_route);
        # "xla" pins the scan, "pallas" / "pallas_v2" / "pallas_v3" a kernel
        self.search_method = search_method
        self.bucketize = bucketize
        self.device = torch.device(device)
        mats = [
            l2_normalize(np.asarray(m, np.float32)) if normalize else np.asarray(m, np.float32)
            for m in doc_matrices
        ]
        self._docs, self._lens = pad_ragged(mats, max_tokens)
        self._n = len(self.ids)
        self._init_device_state()

    def _init_device_state(self) -> None:
        # the prefilter's single-vector proxies (derived state, rebuilt on load)
        self._proxies = _mean_token_proxies(self._docs, self._lens)
        self._device: tuple[torch.Tensor, torch.Tensor] | None = None
        self._scales_device: torch.Tensor | None = None
        self._sidecar: dict | None = None
        self._proxies_device: torch.Tensor | None = None
        self._device_buckets: list[dict] | None = None
        # the mesh the tokens are row-sharded over (ShardedRows in _device,
        # _scales_device and the sidecar's docs_lo), or None
        self._mesh = None
        # (n_fail, covered) of the last verified search: the proof's outcome
        self.last_stats: tuple[int, bool] | None = None
        # a first search from several threads uploads once
        self._lazy = threading.Lock()

    @classmethod
    def from_catalog(cls, catalog, table: str = "chunk", **kwargs) -> "MultiVectorIndex":
        ids, mats = catalog.get_embeddings_matrix(table, multi=True)
        if not ids:
            raise EmbeddingMissingError(f"no multi-vector rows in table '{table}'")
        return cls(ids, mats, **kwargs)

    @property
    def n_docs(self) -> int:
        return self._n

    @property
    def dim(self) -> int:
        return self._docs.shape[2]

    @property
    def max_doc_tokens(self) -> int:
        return self._docs.shape[1]

    def device_bytes(self) -> int:
        """Token-matrix bytes on the device under the current layout (the
        cost the bucketed layout exists to shrink), the bf16 sidecar and the
        int8 mode's per-token scales included."""
        tensors: list[torch.Tensor] = []
        if self._mesh is not None:
            arrays = [self._device[0], self._scales_device]
            if self._sidecar is not None:
                arrays.append(self._sidecar["docs_lo"])
            return sum(a.nbytes() for a in arrays if a is not None)
        if self._device_buckets is not None:
            for b in self._device_buckets:
                tensors += [b[key] for key in ("docs", "lo", "scales") if key in b]
        elif self._device is not None:
            tensors.append(self._device[0])
            if self._sidecar is not None:
                tensors.append(self._sidecar["docs_lo"])
            if self._scales_device is not None:
                tensors.append(self._scales_device)
        return sum(t.numel() * t.element_size() for t in tensors)

    def _upload_tokens(self, docs: np.ndarray) -> dict:
        """{"docs"} (f32, or int8 with {"scales"} in int8 mode) on the
        device, d zero-padded to a multiple of 8 on the card; int8 tokens
        also up to a multiple of 16 per document (``int8_rows``), so every
        tile of documents is a product :func:`int8_matmul` takes in place.
        The pad tokens lie past every length, masked as any pad token."""
        width = device_width(self.dim, self.device)
        if self.mode == "int8":
            # quantize on the host and ship int8: the f32 tokens never occupy
            # device memory
            docs_q, scales = quantize_int8_tokens(docs)
            pad = int8_rows(docs.shape[1], self.device) - docs.shape[1]
            docs_q = pad_width(torch.from_numpy(docs_q), width)
            return {
                "docs": torch.nn.functional.pad(docs_q, (0, 0, 0, pad)).to(self.device),
                "scales": torch.nn.functional.pad(torch.from_numpy(scales), (0, pad)).to(self.device),
            }
        return {"docs": pad_width(torch.from_numpy(docs), width).to(self.device)}

    def _build_device_buckets(self) -> list[dict]:
        """Partition rows by token count; each bucket keeps ascending global
        rows, so per-bucket ``(-score, local_row)`` order is global
        ``(-score, row)`` order and the merge reproduces the flat layout."""
        bounds = _plan_buckets(self._lens, self.bucketize)
        buckets: list[dict] = []
        lo_bound = 0
        for hi in bounds:
            rows = np.where((self._lens > lo_bound) & (self._lens <= hi))[0]
            lo_bound = hi
            if rows.size == 0:
                continue
            entry: dict = {
                "rows": rows.astype(np.int64),
                "lens": torch.from_numpy(self._lens[rows]).to(self.device),
                **self._upload_tokens(np.ascontiguousarray(self._docs[rows, :hi])),
            }
            if self.mode == "verified":
                side = build_maxsim_sidecar(entry["docs"], entry["lens"])
                entry["lo"] = side.pop("docs_lo")
                entry["sidecar"] = side
            buckets.append(entry)
        return buckets

    def to_device(self, mesh=None) -> "MultiVectorIndex":
        """Materialize the tokens (and the verified sidecar) on the device,
        or row-sharded over ``mesh``'s corpus axis."""
        if mesh is not None:
            return self._to_device_sharded(check_mesh(mesh))
        self._mesh = None
        if self.bucketize > 1 and self._n:
            self._device_buckets = self._build_device_buckets()
            self._device = None
            return self
        self._device_buckets = None
        up = self._upload_tokens(self._docs)
        lens = torch.from_numpy(self._lens).to(self.device)
        if self.mode == "verified" and self._n:
            self._sidecar = build_maxsim_sidecar(up["docs"], lens)
        self._device = (up["docs"], lens)
        self._scales_device = up.get("scales")
        return self

    def _to_device_sharded(self, mesh) -> "MultiVectorIndex":
        """The flat layout row-sharded over the corpus axis: each shard's
        tokens (int8 with their scales in int8 mode) and lengths on its
        device, d padded as on one device; verified mode builds each shard's
        bf16 sidecar on its device and keeps the whole corpus's bounds (the
        largest of the shards')."""
        self.device = mesh.merge_device()
        self._mesh = mesh
        self._device_buckets = None
        width = device_width(self.dim, self.device)
        lens = place_rows(self._lens, mesh)
        rows = lens.shard_rows
        scales = None
        if self.mode == "int8":
            docs_q, sc = quantize_int8_tokens(self._docs)
            pad = int8_rows(docs_q.shape[1], self.device) - docs_q.shape[1]
            docs_t = torch.nn.functional.pad(pad_width(torch.from_numpy(docs_q), width), (0, 0, 0, pad))
            docs = place_rows(docs_t, mesh, shard_rows=rows)
            scales = place_rows(torch.nn.functional.pad(torch.from_numpy(sc), (0, pad)), mesh,
                                shard_rows=rows)
        else:
            docs = place_rows(pad_width(torch.from_numpy(self._docs), width), mesh, shard_rows=rows)
        self._sidecar = None
        if self.mode == "verified" and self._n:
            sides = [None if t is None else build_maxsim_sidecar(t) for t in docs.shards]
            local = [side for side in sides if side is not None]
            self._sidecar = {
                "docs_lo": ShardedRows([None if side is None else side["docs_lo"] for side in sides],
                                       rows, docs.shape),
                "nd_max": mesh_max(max(side["nd_max"] for side in local), mesh),
                "r_max": mesh_max(max(side["r_max"] for side in local), mesh),
            }
        self._device = (docs, lens)
        self._scales_device = scales
        return self

    # ----------------------------------------------------------------- search
    def _queries(self, query_matrices) -> tuple[np.ndarray, np.ndarray]:
        mats = [
            l2_normalize(np.atleast_2d(np.asarray(m, np.float32)))
            if self.normalize
            else np.atleast_2d(np.asarray(m, np.float32))
            for m in query_matrices
        ]
        return pad_ragged(mats)

    def _search_bucketed(self, q, q_lens, k: int, method: str, kprime: int | None):
        """One search per token-count bucket; host merge by global
        ``(-score, row)``, identical to the flat layout."""
        nq = q.shape[0]
        all_scores, all_rows = [], []
        fails, covered = 0, True
        for bucket in self._device_buckets:  # type: ignore[union-attr]
            nb = int(bucket["rows"].size)
            kb = min(k, nb)
            if self.mode == "verified":
                s, r, n_fail, cov = maxsim_topk_verified(
                    q, q_lens, bucket["docs"], bucket["lens"],
                    {**bucket["sidecar"], "docs_lo": bucket["lo"]}, kb,
                    kprime=kprime if kprime is not None else 64, return_stats=True,
                )
                fails, covered = fails + n_fail, covered and cov
            elif self.mode == "int8":
                s, r = maxsim_topk_int8(
                    q, q_lens, bucket["docs"], bucket["scales"], bucket["lens"], kb
                )
            else:
                s, r = maxsim_topk(q, q_lens, bucket["docs"], bucket["lens"], kb, method=method)
            s = s.cpu().numpy()
            r = r.cpu().numpy()
            valid = (r >= 0) & (r < nb) & (s > -1e37)
            g = np.where(valid, bucket["rows"][np.where(valid, r, 0)], INT_MAX)
            all_scores.append(np.where(valid, s, -np.inf))
            all_rows.append(g)
        if self.mode == "verified":
            self.last_stats = (fails, covered)
        scores = np.concatenate(all_scores, axis=1)
        rows = np.concatenate(all_rows, axis=1)
        order = np.lexsort((rows, -scores), axis=1)[:, :k]
        b_idx = np.arange(nq)[:, None]
        return scores[b_idx, order], rows[b_idx, order]

    def topk_rows(
        self,
        query_matrices: Sequence[np.ndarray],
        k: int,
        method: str | None = None,
        prefilter: int | None = None,
        kprime: int | None = None,
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Batch search -> (raw MaxSim scores [Q, k], rows [Q, k], query
        token counts [Q]); see :meth:`search` for the options. A verified
        search leaves its proof's ``(n_fail, covered)`` in
        :attr:`last_stats`."""
        if self._n == 0:
            raise IndexNotBuiltError("index has no documents")
        if prefilter is not None and self.mode == "verified":
            raise ValueError(
                "prefilter is not supported with mode='verified': the "
                "PLAID-style prefilter is approximate and would void the "
                "mode's always-equal-exact contract; use mode='exact' with "
                "prefilter, or drop prefilter"
            )
        if prefilter is not None and self.mode == "int8":
            raise ValueError(
                "prefilter is not supported with mode='int8' "
                "(the exact-rerank stage needs the f32 token matrix)"
            )
        if prefilter is not None and self.bucketize > 1:
            raise ValueError(
                "prefilter is not supported with bucketize>1: the rerank "
                "stage gathers candidates from one flat device tensor, which "
                "the bucketed layout exists to avoid; use bucketize=1 with "
                "prefilter, or drop prefilter"
            )
        if method is None:
            method = self.search_method
        with self._lazy:
            if self._device is None and self._device_buckets is None:
                self.to_device()
            if prefilter is not None and self._mesh is None and self._proxies_device is None:
                self._proxies_device = torch.from_numpy(self._proxies).to(self.device)
        q_np, q_lens_np = self._queries(query_matrices)
        q = pad_width(torch.from_numpy(q_np), device_width(self.dim, self.device)).to(self.device)
        # lengths stay on the host: the kernels' launch plans read them there
        q_lens = torch.from_numpy(q_lens_np)
        if self._device_buckets is not None:
            scores, rows = self._search_bucketed(q, q_lens, k, method, kprime)
            return scores, rows, q_lens_np
        docs, lens = self._device  # type: ignore[misc]
        if self._mesh is not None:
            if prefilter is not None:
                logger.warning(
                    "prefilter=%s is ignored on a mesh-sharded MultiVectorIndex "
                    "(the exact full scan runs instead)", prefilter,
                )
            if self.mode == "verified":
                s, r, n_fail, covered = sharded_maxsim_topk_verified(
                    q, q_lens, docs, lens, self._sidecar["docs_lo"], self._sidecar["nd_max"],
                    self._sidecar["r_max"], k, self._n, self._mesh,
                    kprime=kprime if kprime is not None else 64, return_stats=True,
                )
                self.last_stats = (n_fail, covered)
            elif self.mode == "int8":
                s, r = sharded_maxsim_topk_int8(
                    q, q_lens, docs, self._scales_device, lens, k, self._n, self._mesh
                )
            else:
                s, r = sharded_maxsim_topk(q, q_lens, docs, lens, k, self._n, self._mesh, method=method)
        elif prefilter is not None:
            # stage 1: candidates from the mean-token proxies
            q_proxy = l2_normalize(q_np.sum(axis=1) / np.maximum(q_lens_np[:, None], 1))
            n_cand = min(self._n, max(k, k * prefilter))
            _, cand = dense_topk(
                torch.from_numpy(q_proxy).to(self.device), self._proxies_device, n_cand
            )
            # stage 2: exact MaxSim over the candidates only
            s, r = maxsim_rerank(q, q_lens, docs, lens, cand, k)
        elif self.mode == "verified":
            s, r, n_fail, covered = maxsim_topk_verified(
                q, q_lens, docs, lens, self._sidecar, k,
                kprime=kprime if kprime is not None else 64, return_stats=True,
            )
            self.last_stats = (n_fail, covered)
        elif self.mode == "int8":
            s, r = maxsim_topk_int8(q, q_lens, docs, self._scales_device, lens, k)
        else:
            s, r = maxsim_topk(q, q_lens, docs, lens, k, method=method)
        return s.cpu().numpy(), r.cpu().numpy(), q_lens_np

    def search(
        self,
        query_matrices: Sequence[np.ndarray],
        k: int,
        method: str | None = None,
        prefilter: int | None = None,
        kprime: int | None = None,
    ) -> list[list[SearchHit]]:
        """query_matrices: list of [Tq_i, d]. Scores = MaxSim / Tq_i.

        ``prefilter=M``: the two-stage PLAID-style search, a dense
        top-(k*M) pass over single-vector document proxies, then exact
        MaxSim over those candidates only (approximate; refused with
        mode='verified' and with bucketize>1). ``kprime`` (mode='verified'):
        the prescreen's candidate count, clamped to ``max(kprime, k)``,
        default 64. ``method`` overrides ``search_method``."""
        scores, rows, q_lens = self.topk_rows(query_matrices, k, method, prefilter, kprime)
        k_eff = min(k, self._n)
        out = []
        for qi, (qs, qr) in enumerate(zip(scores, rows)):
            nq = max(int(q_lens[qi]), 1)
            out.append(
                [
                    SearchHit(self.ids[int(r)], float(s) / nq)
                    # the score floor drops NEG_INF fillers (empty docs, pads)
                    for s, r in zip(qs[:k_eff], qr[:k_eff])
                    if r < self._n and s > -1e37
                ]
            )
        return out

    # ------------------------------------------------------------ persistence
    def save(self, path: str | Path) -> None:
        path = Path(path)
        path.mkdir(parents=True, exist_ok=True)
        # uncompressed, as the IVF artifacts: float tokens do not compress (a
        # page-scale corpus of 5 GB would take minutes through zlib), and
        # np.load reads either form, so both packages load what the other saved
        np.savez(path / "mv.npz", docs=self._docs, lens=self._lens)
        (path / "meta.json").write_text(
            json.dumps(
                {
                    "kind": "multi_vector",
                    "normalize": self.normalize,
                    "search_method": self.search_method,
                    "mode": self.mode,
                    "bucketize": self.bucketize,
                    "ids": self.ids,
                },
                default=str,
            )
        )

    @classmethod
    def load(cls, path: str | Path, device: str | torch.device = "cuda") -> "MultiVectorIndex":
        path = Path(path)
        meta = json.loads((path / "meta.json").read_text())
        mode = meta.get("mode", "exact")
        arrays = np.load(path / "mv.npz")
        idx = cls.__new__(cls)
        idx.ids = meta["ids"]
        idx.normalize = meta["normalize"]
        idx.search_method = meta.get("search_method", "auto")
        idx.mode = mode
        idx.bucketize = meta.get("bucketize", 1)
        idx.device = torch.device(device)
        idx._docs = arrays["docs"]
        idx._lens = arrays["lens"]
        idx._n = len(idx.ids)
        # the sidecar and the proxies are derived state, rebuilt here or on
        # the first to_device()
        idx._init_device_state()
        return idx
