"""BM25 sparse index: tokenization -> document statistics -> slot arrays on one GPU.

Counterpart of ``autorag_research_tpu/index/sparse.py``. The build tokenizes
in Python and fills the slot arrays with vectorized numpy: document
frequencies, lengths and per-(doc, term) BM25 weights
``tf (k1 + 1) / (tf + k1 (1 - b + b dl / avgdl))`` in float64, cast to f32,
bitwise equal to the JAX package's ``_build_python`` (vocabulary in first-seen
order, slots in first-occurrence order, the same ``max_slots`` truncation).
Query weights are Lucene's ``idf = ln(1 + (N - df + 0.5) / (df + 0.5))``
times the query term count. Scores are positive, higher is better; hits
with score <= 0 (no term overlap) are dropped.

Device layouts, as the JAX package chooses them:

- lane-packed (``ops/sparse.py::pack_slots``) when every document has at most
  64 unique terms, on the card, or off it up to 10,000 documents;
- bucketed (``bucketize > 1``): documents partitioned by unique-term count,
  each bucket packed when its width is at most 64, else flat, one launch per
  bucket and a host merge by ``(-score, global row)``;
- flat otherwise, slots padded to a multiple of 4.

``search`` routes through ``ops/sparse.py::bm25_route``. Flat layout on the
card with ``tile_skip`` (the default) and k <= 2,048: the JAX package's
pruned legs (``_search_pruned``), positive scores only: the probe kernel over
the exact candidate tiles of the host term -> tile lists when a batch is
selective (candidate tiles <= half the corpus's), else the two-pass tile-WAND
probe, which falls back to the Bloom tile-skip kernel when its bound prunes
too little; the v2 kernel otherwise. Packed layout (``_search_packed_auto``):
with ``tile_skip`` and k within a candidate tile the packed probe or tile-WAND
over the packed layout (falling back to the full packed kernel), else the
full packed kernel; the pins ``xla`` / ``pallas_v2`` / ``pallas`` run from a
flat upload made on first use. Bucketed layout: the packed kernel on each
packed bucket, the whole-corpus route of the method on each flat one. The
pruned pins fall back to ``auto`` on a packed or bucketed layout. All legs
are exact: the hits are the same. A
mesh raises ``NotImplementedError``. Artifacts (``sparse.npz`` +
``meta.json``) have the JAX package's format, so either package loads what
the other saved.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Sequence

import numpy as np
import torch

from autorag_research_tpu_torch.exceptions import IndexNotBuiltError
from autorag_research_tpu_torch.index.base import SearchHit
from autorag_research_tpu_torch.index.buckets import _plan_buckets
from autorag_research_tpu_torch.index.tokenize import get_tokenizer
from autorag_research_tpu_torch.ops.sparse import (
    BLOCK_Q,
    DOC_PAD,
    QUERY_PAD,
    SKIP_BLOCK_N,
    bm25_route,
    bm25_topk_packed,
    bm25_topk_probe,
    bm25_topk_probe_packed,
    bm25_topk_scan,
    bm25_topk_v1,
    bm25_topk_v2,
    bm25_topk_v2_skip,
    bm25_topk_wand,
    build_term_tile_lists,
    build_term_tile_maxw,
    build_tile_bitmaps,
    candidate_cap,
    cluster_doc_order,
    pack_slots,
    packed_block_rows,
    probe_candidates,
    pruned_leg,
)
from autorag_research_tpu_torch.ops.topk import INT_MAX, NEG_INF

# widest document (unique terms) of a packed layout: two or more per row
PACK_MAX_WIDTH = 64
# off the card the JAX package packs only corpora this small (its packed
# kernel runs interpreted there); the port makes the same layout choice, so
# that its CPU route is the JAX package's
PACK_OFF_CARD_MAX_DOCS = 10_000
# the whole-corpus routes over a flat layout
_FLAT_ROUTES = {"scan": bm25_topk_scan, "fused": bm25_topk_v2, "v1": bm25_topk_v1}


def _pad_slots(ids: np.ndarray, w: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Pad the slot axis with empty slots to a multiple of 4 (the kernel's
    16-byte loads; pads never match, scores unchanged)."""
    pad = (-ids.shape[1]) % 4
    if pad:
        ids = np.pad(ids, ((0, 0), (0, pad)), constant_values=DOC_PAD)
        w = np.pad(w, ((0, 0), (0, pad)))
    return ids, w


class SparseIndex:
    """Exact BM25 top-k over a slot-padded term-weight layout on one device.

    ``bucketize > 1`` opts into the bucketed device layout (one trimmed
    layout per bucket of unique-term counts, planned by
    ``index/buckets.py::_plan_buckets``): for corpora that are mostly short,
    or bound by device memory. The host slot arrays stay the build and save
    source of truth."""

    def __init__(
        self,
        ids: Sequence[Any],
        texts: Sequence[str] | None = None,
        tokenizer: str = "simple",
        k1: float = 1.2,
        b: float = 0.75,
        max_slots: int | None = None,
        bucketize: int = 1,
        tile_skip: bool = True,
        cluster_layout: bool = False,
        probe_block_n: int = 2048,
        device: str | torch.device = "cuda",
    ):
        self.ids = list(ids)
        self.tokenizer_name = tokenizer
        self.k1 = k1
        self.b = b
        self.max_slots = max_slots
        self.bucketize = bucketize
        # pruned search on the card: probe / tile-WAND / Bloom skip legs
        self.tile_skip = tile_skip
        # opt-in physical reorder by rarest term, so that tile_skip can prune
        # (ops/sparse.cluster_doc_order); equal-score ties at the k boundary
        # may resolve to other documents than in the id-ordered layout
        self.cluster_layout = cluster_layout
        # doc tile of the probe and WAND legs' term -> tile lists (a packed
        # layout's tile is this many documents in whole packed rows)
        self.probe_block_n = probe_block_n
        self.device = torch.device(device)
        self.vocab: dict[str, int] = {}
        self.doc_freq: np.ndarray | None = None
        self.doc_lengths: np.ndarray | None = None
        self.avgdl = 0.0
        self.n_docs = len(self.ids)
        self._slot_ids: np.ndarray | None = None  # [N, L] int32
        self._slot_weights: np.ndarray | None = None  # [N, L] float32
        self._reset_device()
        self._bitmaps: torch.Tensor | None = None
        self._term_tiles: dict[int, tuple[np.ndarray, np.ndarray]] = {}
        self._term_tiles_maxw: dict[int, tuple[np.ndarray, np.ndarray, np.ndarray]] = {}
        if texts is not None:
            self._build(texts)

    def _reset_device(self) -> None:
        # flat or packed (ids, weights), or None
        self._device: tuple[torch.Tensor, torch.Tensor] | None = None
        self._device_pack = 1  # documents per row of _device
        # flat upload behind the xla / pallas_v2 / pallas pins of a packed index
        self._device_flat: tuple[torch.Tensor, torch.Tensor] | None = None
        self._device_buckets: list[dict] | None = None

    # ----------------------------------------------------------------- build
    @classmethod
    def from_catalog(cls, catalog, table: str = "chunk", **kwargs) -> "SparseIndex":
        rows = catalog.connect().execute(
            f"SELECT id, contents FROM {table} WHERE contents IS NOT NULL ORDER BY id"
        ).fetchall()
        return cls([r["id"] for r in rows], [r["contents"] for r in rows], **kwargs)

    def _build(self, texts: Sequence[str]) -> None:
        """Tokenize in Python, then fill the slot arrays with numpy."""
        tok = get_tokenizer(self.tokenizer_name)
        n = len(texts)
        tokens: list[str] = []
        lens = []
        for text in texts:
            words = tok.tokenize(text or "")
            lens.append(len(words))
            tokens.extend(words)
        lengths = np.asarray(lens, dtype=np.int64)
        vocab = self.vocab
        for t in dict.fromkeys(tokens):  # first-seen order
            vocab.setdefault(t, len(vocab))
        n_vocab = max(len(vocab), 1)
        tids = np.fromiter(map(vocab.__getitem__, tokens), dtype=np.int64, count=len(tokens))
        del tokens
        # unique (doc, term) pairs with their counts, in (doc, first occurrence) order
        doc_of = np.repeat(np.arange(n, dtype=np.int64), lengths)
        keys, first, cnt = np.unique(doc_of * n_vocab + tids, return_index=True, return_counts=True)
        order = np.argsort(first, kind="stable")
        keys, cnt = keys[order], cnt[order]
        pair_doc = keys // n_vocab
        pair_tid = keys % n_vocab

        self.doc_freq = np.bincount(pair_tid, minlength=len(vocab)).astype(np.int64)
        self.doc_lengths = lengths
        self.avgdl = float(lengths.mean()) if n else 0.0

        # BM25 doc-side weights in float64, in _build_python's operation order
        k1, b = self.k1, self.b
        if self.avgdl:
            norm = k1 * (1 - b + b * (lengths / self.avgdl))
        else:
            norm = np.full(n, k1 * (1 - b + b * 0.0))
        w64 = (cnt * (k1 + 1)) / (cnt + norm[pair_doc])

        n_terms = np.bincount(pair_doc, minlength=n)
        slots = int(n_terms.max()) if n else 0
        if self.max_slots is not None and slots > self.max_slots:
            slots = self.max_slots
        slots = max(slots, 1)
        starts = np.cumsum(n_terms) - n_terms
        pos = np.arange(len(keys)) - starts[pair_doc]
        over = n_terms > slots
        if over.any():
            # overflow: keep each long doc's highest-weight terms (stable
            # by first occurrence), in that order
            key2 = np.where(over[pair_doc], -w64, 0.0)
            order = np.lexsort((pos, key2, pair_doc))
            pair_doc, pair_tid, w64 = pair_doc[order], pair_tid[order], w64[order]
        keep = pos < slots  # pos is the rank within the doc either way
        slot_ids = np.full((n, slots), DOC_PAD, dtype=np.int32)
        slot_w = np.zeros((n, slots), dtype=np.float32)
        slot_ids[pair_doc[keep], pos[keep]] = pair_tid[keep]
        slot_w[pair_doc[keep], pos[keep]] = w64[keep]
        self._slot_ids = slot_ids
        self._slot_weights = slot_w
        self._apply_cluster_layout()
        self._reset_device()
        self._bitmaps = None
        self._term_tiles = {}
        self._term_tiles_maxw = {}

    def _apply_cluster_layout(self) -> None:
        """Reorder documents by rarest term when ``cluster_layout`` is set."""
        if not (self.cluster_layout and len(self.ids)):
            return
        assert self._slot_ids is not None and self.doc_freq is not None
        order = cluster_doc_order(self._slot_ids, self.doc_freq)
        self._slot_ids = self._slot_ids[order]
        self._slot_weights = self._slot_weights[order]
        self.ids = [self.ids[i] for i in order]
        if self.doc_lengths is not None:
            self.doc_lengths = self.doc_lengths[order]

    # ---------------------------------------------------------------- queries
    def idf(self, term_id: int) -> float:
        assert self.doc_freq is not None
        df = float(self.doc_freq[term_id])
        return float(np.log(1.0 + (self.n_docs - df + 0.5) / (df + 0.5)))

    def encode_queries(
        self, queries: Sequence[str], max_terms: int | None = None
    ) -> tuple[np.ndarray, np.ndarray]:
        """Tokenize queries -> (term ids [B, T], idf*qtf weights [B, T]),
        padded with QUERY_PAD / 0. Unknown terms are dropped."""
        tok = get_tokenizer(self.tokenizer_name)
        per_query: list[list[tuple[int, float]]] = []
        for q in queries:
            tf: dict[int, int] = {}
            for t in tok.tokenize(q or ""):
                tid = self.vocab.get(t)
                if tid is not None:
                    tf[tid] = tf.get(tid, 0) + 1
            pairs = [(tid, cnt * self.idf(tid)) for tid, cnt in tf.items()]
            if max_terms is not None and len(pairs) > max_terms:
                pairs.sort(key=lambda x: -x[1])
                pairs = pairs[:max_terms]
            per_query.append(pairs)
        t_max = max((len(p) for p in per_query), default=0) or 1
        q_ids = np.full((len(queries), t_max), QUERY_PAD, dtype=np.int32)
        q_w = np.zeros((len(queries), t_max), dtype=np.float32)
        for i, pairs in enumerate(per_query):
            for j, (tid, w) in enumerate(pairs):
                q_ids[i, j] = tid
                q_w[i, j] = w
        return q_ids, q_w

    # ----------------------------------------------------------------- search
    def _upload(self, ids: np.ndarray, w: np.ndarray) -> tuple[torch.Tensor, torch.Tensor]:
        return (torch.from_numpy(np.ascontiguousarray(ids)).to(self.device),
                torch.from_numpy(np.ascontiguousarray(w)).to(self.device))

    def to_device(self, mesh=None) -> "SparseIndex":
        """Upload the slot arrays in the layout the JAX package's
        ``to_device`` chooses: bucketed with ``bucketize > 1``, else packed
        when every document has at most ``PACK_MAX_WIDTH`` unique terms (on
        the card, or off it up to ``PACK_OFF_CARD_MAX_DOCS`` documents), else
        flat."""
        if mesh is not None:
            raise NotImplementedError("a mesh-sharded SparseIndex is ported with the multi-GPU slice")
        if self._slot_ids is None:
            raise IndexNotBuiltError("sparse index not built")
        self._reset_device()
        if self.bucketize > 1:
            self._device_buckets = self._build_device_buckets()
            return self
        ids, w = self._slot_ids, self._slot_weights
        width = ids.shape[1]
        if (width <= PACK_MAX_WIDTH and self.n_docs
                and (self.device.type == "cuda" or self.n_docs <= PACK_OFF_CARD_MAX_DOCS)):
            pids, pw, self._device_pack = pack_slots(ids, w, width)  # width <= 64: pack >= 2
            self._device = self._upload(pids, pw)
            return self
        self._device = self._upload(*_pad_slots(ids, w))
        return self

    def _build_device_buckets(self) -> list[dict]:
        """Partition rows by unique-term count (JAX ``_build_device_buckets``);
        each bucket keeps ascending global row order, so that its kernel's
        tie order maps to the global ``(-score, row)`` order. A bucket of
        width at most ``PACK_MAX_WIDTH`` is packed."""
        assert self._slot_ids is not None and self._slot_weights is not None
        counts = (self._slot_ids != DOC_PAD).sum(axis=1)
        buckets = []
        assigned = np.zeros(self.n_docs, dtype=bool)
        for bound in _plan_buckets(counts, self.bucketize):
            rows = np.nonzero((counts <= bound) & ~assigned)[0]
            if rows.size == 0:
                continue
            assigned[rows] = True
            width = max(int(counts[rows].max()), 1)
            if width <= PACK_MAX_WIDTH:
                ids, w, pack = pack_slots(self._slot_ids[rows], self._slot_weights[rows], width)
            else:
                ids, w = _pad_slots(self._slot_ids[rows, :width], self._slot_weights[rows, :width])
                pack = 1
            buckets.append({"rows": rows, "pack": pack, "arrays": self._upload(ids, w)})
        return buckets

    def _flat_device(self) -> tuple[torch.Tensor, torch.Tensor]:
        """The flat device arrays: the flat upload itself, or else (a packed
        index) a flat upload of the same slot arrays, made on first use and
        kept."""
        if self._device is not None and self._device_pack == 1:
            return self._device
        if self._device_flat is None:
            self._device_flat = self._upload(*_pad_slots(self._slot_ids, self._slot_weights))
        return self._device_flat

    def _layout(self) -> str:
        """The device layout searched: bucketed, packed or flat."""
        if self._device_buckets is not None:
            return "bucketed"
        return "packed" if self._device_pack > 1 else "flat"

    def device_bytes(self) -> int:
        """Slot-array bytes on the device under the current layout (packed or
        bucketed layouts as such; a pin's flat upload is not counted, as in
        the JAX package)."""
        if self._device_buckets is not None:
            arrays = [t for bucket in self._device_buckets for t in bucket["arrays"]]
        else:
            arrays = list(self._device or ())
        return sum(t.numel() * t.element_size() for t in arrays)

    def _ensure_bitmaps(self) -> torch.Tensor:
        """Tile term-presence bitmaps for the skip kernel, built once per
        layout at its ``SKIP_BLOCK_N``."""
        if self._bitmaps is None:
            assert self._slot_ids is not None
            self._bitmaps = torch.from_numpy(build_tile_bitmaps(self._slot_ids, SKIP_BLOCK_N)).to(self.device)
        return self._bitmaps

    def _ensure_term_tiles(self, block_n: int) -> tuple[np.ndarray, np.ndarray]:
        """Host CSR term -> tile lists, built once per (layout, tile size)."""
        if block_n not in self._term_tiles:
            assert self._slot_ids is not None
            self._term_tiles[block_n] = build_term_tile_lists(self._slot_ids, block_n)
        return self._term_tiles[block_n]

    def _ensure_term_tiles_maxw(self, block_n: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Host CSR term -> (tile, max weight) for the WAND bound, built once
        per (layout, tile size)."""
        if block_n not in self._term_tiles_maxw:
            assert self._slot_ids is not None
            self._term_tiles_maxw[block_n] = build_term_tile_maxw(
                self._slot_ids, self._slot_weights, block_n
            )
        return self._term_tiles_maxw[block_n]

    def _queries_on_device(self, q_ids: np.ndarray, q_w: np.ndarray):
        return torch.from_numpy(q_ids).to(self.device), torch.from_numpy(q_w).to(self.device)

    def _search_pruned(self, q_ids: np.ndarray, q_w: np.ndarray, doc_ids, doc_w, k: int, method: str):
        """The pruned legs over the flat layout (JAX ``_search_pruned``), all
        ``positive_only``: the probe kernel over the exact candidate tiles of
        the host term -> tile lists when the batch is selective (candidate
        tiles <= half the corpus's); else the two-pass tile-WAND probe,
        falling back to the Bloom tile-skip kernel when its bound prunes too
        little. ``pallas_probe`` and ``pallas_wand`` pin their leg,
        ``pallas_v2_skip`` the skip kernel, as does a k beyond
        ``probe_block_n``."""
        qi, qw = self._queries_on_device(q_ids, q_w)
        pbn = self.probe_block_n
        if min(k, self.n_docs) <= pbn and method in ("auto", "pallas_probe", "pallas_wand"):
            p_tiles = max(1, -(-self.n_docs // pbn))
            indptr, tiles = self._ensure_term_tiles(pbn)
            cand, count, maxc = probe_candidates(q_ids, indptr, tiles, bq=BLOCK_Q, cap=p_tiles)
            if pruned_leg(method, maxc, p_tiles) == "probe":
                cand = np.ascontiguousarray(cand[:, : candidate_cap(maxc, p_tiles)])
                return bm25_topk_probe(
                    qi, qw, doc_ids, doc_w, torch.from_numpy(cand).to(self.device),
                    torch.from_numpy(count).to(self.device), k, block_n=pbn,
                )
            return bm25_topk_wand(
                q_ids, q_w, doc_ids, doc_w, self._ensure_term_tiles_maxw(pbn), k, block_n=pbn,
                fallback=lambda: bm25_topk_v2_skip(
                    qi, qw, doc_ids, doc_w, self._ensure_bitmaps(), min(k, self.n_docs),
                    positive_only=True,
                ),
            )
        return bm25_topk_v2_skip(qi, qw, doc_ids, doc_w, self._ensure_bitmaps(), k, positive_only=True)

    def _search_packed_pruned(self, q_ids: np.ndarray, q_w: np.ndarray, k: int):
        """The pruned legs over the packed layout (JAX ``_search_packed_auto``
        on the TPU): a candidate tile is ``packed_block_rows`` packed rows,
        so the host term -> tile lists are built at that many times ``pack``
        documents; the packed probe for a selective batch, else tile-WAND
        over the packed layout, whose fallback is the full packed kernel."""
        pack = self._device_pack
        packed_ids, packed_w = self._device  # type: ignore[misc]
        bn_rows = packed_block_rows(self.probe_block_n, pack)
        docs_per_tile = bn_rows * pack
        p_tiles = max(1, -(-self.n_docs // docs_per_tile))
        indptr, tiles = self._ensure_term_tiles(docs_per_tile)
        cand, count, maxc = probe_candidates(q_ids, indptr, tiles, bq=BLOCK_Q, cap=p_tiles)
        if pruned_leg("auto", maxc, p_tiles) == "probe":
            qi, qw = self._queries_on_device(q_ids, q_w)
            cand = np.ascontiguousarray(cand[:, : candidate_cap(maxc, p_tiles)])
            return bm25_topk_probe_packed(
                qi, qw, packed_ids, packed_w, self.n_docs, pack,
                torch.from_numpy(cand).to(self.device), torch.from_numpy(count).to(self.device),
                k, block_n=bn_rows,
            )
        return bm25_topk_wand(
            q_ids, q_w, None, None, self._ensure_term_tiles_maxw(docs_per_tile), k, block_n=bn_rows,
            packed=(packed_ids, packed_w, self.n_docs, pack),
        )

    def _search_bucketed(self, q_ids: np.ndarray, q_w: np.ndarray, k: int, flat_route: str):
        """One launch per bucket (the packed kernel for a packed bucket, else
        the whole-corpus ``flat_route`` of :func:`bm25_route`), then a host
        merge by ``(-score, global row)`` (JAX ``_search_bucketed``). Returns
        host (scores, rows) [Q, <= k], no-hit entries ``(NEG_INF, INT_MAX)``."""
        qi, qw = self._queries_on_device(q_ids, q_w)
        nq = q_ids.shape[0]
        all_s = [np.empty((nq, 0), np.float32)]
        all_r = [np.empty((nq, 0), np.int64)]
        for bucket in self._device_buckets:  # type: ignore[union-attr]
            nb = int(bucket["rows"].size)
            ids, w = bucket["arrays"]
            if bucket["pack"] > 1:
                s, r = bm25_topk_packed(qi, qw, ids, w, nb, min(k, nb), bucket["pack"])
            else:
                s, r = _FLAT_ROUTES[flat_route](qi, qw, ids, w, min(k, nb))
            s, r = s.cpu().numpy(), r.cpu().numpy()
            valid = r != INT_MAX
            all_r.append(np.where(valid, bucket["rows"][np.where(valid, r, 0)], INT_MAX))
            all_s.append(np.where(valid, s, np.float32(NEG_INF)))
        scores = np.concatenate(all_s, axis=1)
        rows = np.concatenate(all_r, axis=1)
        order = np.lexsort((rows, -scores), axis=1)[:, :k]
        b_idx = np.arange(nq)[:, None]
        return scores[b_idx, order], rows[b_idx, order]

    def topk_rows(self, queries: Sequence[str], k: int, method: str = "auto") -> tuple[np.ndarray, np.ndarray]:
        """Batch search -> (scores [Q, k'], rows [Q, k']) on the host, in
        ``(-score, row)`` order (k' = k, or at most k on a bucketed index);
        entries with score <= 0 are no hits."""
        if self._slot_ids is None:
            raise IndexNotBuiltError("sparse index not built")
        if self._device is None and self._device_buckets is None:
            self.to_device()
        q_ids, q_w = self.encode_queries(queries)
        route = bm25_route(method, self.n_docs, k, self.device.type, self.tile_skip, self._layout(),
                           self._device_pack, self.probe_block_n)
        if route.startswith("bucketed_"):
            return self._search_bucketed(q_ids, q_w, k, route.removeprefix("bucketed_"))
        if route == "pruned":
            scores, rows = self._search_pruned(q_ids, q_w, *self._device, k, method)  # type: ignore[misc]
        elif route == "pruned_packed":
            scores, rows = self._search_packed_pruned(q_ids, q_w, k)
        elif route == "packed":
            scores, rows = bm25_topk_packed(*self._queries_on_device(q_ids, q_w), *self._device,
                                            self.n_docs, k, self._device_pack)
        else:
            scores, rows = _FLAT_ROUTES[route](*self._queries_on_device(q_ids, q_w),
                                               *self._flat_device(), k)
        return scores.cpu().numpy(), rows.cpu().numpy()

    def search(self, queries: Sequence[str], k: int, method: str = "auto") -> list[list[SearchHit]]:
        scores, rows = self.topk_rows(queries, k, method)
        k_eff = min(k, self.n_docs)
        out = []
        for qs, qr in zip(scores, rows):
            hits = []
            for s, r in zip(qs[:k_eff], qr[:k_eff]):
                if not (s > 0.0):  # no term overlap, or no hit at all
                    break
                hits.append(SearchHit(self.ids[int(r)], float(s)))
            out.append(hits)
        return out

    def score_host(self, queries: Sequence[str]) -> np.ndarray:
        """Host scipy CSR oracle: the full [B, N] f32 BM25 score matrix."""
        from scipy.sparse import csr_matrix

        assert self._slot_ids is not None
        n_terms = max(len(self.vocab), 1)
        rows, cols = np.nonzero(self._slot_ids >= 0)
        mat = csr_matrix(
            (self._slot_weights[rows, cols], (rows, self._slot_ids[rows, cols])),
            shape=(self.n_docs, n_terms),
        )
        q_ids, q_w = self.encode_queries(queries)
        qb, qt = np.nonzero(q_ids >= 0)
        qmat = np.zeros((n_terms, len(queries)), dtype=np.float32)
        qmat[q_ids[qb, qt], qb] = q_w[qb, qt]
        return np.ascontiguousarray((mat @ qmat).T.astype(np.float32))

    # ------------------------------------------------------------ persistence
    def save(self, path: str | Path) -> None:
        path = Path(path)
        path.mkdir(parents=True, exist_ok=True)
        np.savez_compressed(
            path / "sparse.npz",
            slot_ids=self._slot_ids,
            slot_weights=self._slot_weights,
            doc_freq=self.doc_freq,
            doc_lengths=self.doc_lengths,
        )
        meta = {
            "kind": "sparse",
            "tokenizer": self.tokenizer_name,
            "k1": self.k1,
            "b": self.b,
            "bucketize": self.bucketize,
            "tile_skip": self.tile_skip,
            "cluster_layout": self.cluster_layout,
            "probe_block_n": self.probe_block_n,
            "avgdl": self.avgdl,
            "n_docs": self.n_docs,
            "ids": self.ids,
            "vocab": self.vocab,
        }
        (path / "meta.json").write_text(json.dumps(meta, default=str))

    @classmethod
    def load(cls, path: str | Path, device: str | torch.device = "cuda") -> "SparseIndex":
        path = Path(path)
        meta = json.loads((path / "meta.json").read_text())
        arrays = np.load(path / "sparse.npz")
        idx = cls(
            meta["ids"], texts=None, tokenizer=meta["tokenizer"],
            k1=meta["k1"], b=meta["b"], bucketize=meta.get("bucketize", 1),
            tile_skip=meta.get("tile_skip", True),
            # a cluster-ordered layout is already in the saved slot arrays;
            # the flag only records provenance (no re-sort on load)
            cluster_layout=meta.get("cluster_layout", False),
            probe_block_n=int(meta.get("probe_block_n", 2048)),
            device=device,
        )
        idx.vocab = meta["vocab"]
        idx.avgdl = meta["avgdl"]
        idx.doc_freq = arrays["doc_freq"]
        idx.doc_lengths = arrays["doc_lengths"]
        idx._slot_ids = arrays["slot_ids"]
        idx._slot_weights = arrays["slot_weights"]
        return idx
