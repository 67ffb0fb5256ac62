"""BM25 sparse scoring on an NVIDIA GPU: the slot-padded layout, flat or lane-packed.

Counterpart of ``autorag_research_tpu/ops/sparse.py``. Each document's unique
terms occupy ``L`` slots of two ``[N, L]`` arrays, term ids (``DOC_PAD`` = -1
where empty) and precomputed BM25 term weights (0 where empty); a query is
``T`` (term id, idf * qtf) pairs, padded with ``QUERY_PAD`` = -2 and weight 0,
so pads never match each other. The lane-packed layout (:func:`pack_slots`)
puts ``P = 128 // width`` short documents in each 128-word row.

One scoring order everywhere, ``_slot_match_scores`` of the JAX package: for
each query term t in increasing order, ``p_t = w[n, l*] * qw[b, t]``
(rounded), then ``score = score + p_t`` (rounded), where ``l*`` is the doc
slot holding the term (the sum over every slot, which is that one weight on
index-built arrays). The scan, the plain versions and the kernels compute
exactly this, in either layout, so the CPU and the card rank alike bit for
bit.

- :func:`bm25_topk_scan` (JAX ``bm25_topk_xla``): document tiles with a
  running ``(-score, row)`` merge; zero-score documents are candidates.
- :func:`bm25_topk_v2` (JAX ``bm25_topk_pallas_v2``): the fused kernel of
  ``csrc/bm25_v2.cu`` for any k; :func:`bm25_topk_v1` (JAX
  ``bm25_topk_pallas``, the ``pallas`` pin): the same kernel under its own
  name and launch count. Both run the scoring body of ``csrc/bm25_hash.cuh``
  (a per-document term hash in shared memory, many queries per staged
  document tile) on the tile plan of :func:`bm25_hash_plan`.
- :func:`bm25_topk_v2_skip` (JAX ``bm25_topk_pallas_v2_skip``): the hash
  body skipping, per 8-query group, the doc tiles that the 4-probe Bloom
  predicate clears (:func:`tile_group_masks`); ``positive_only`` masks
  scores <= 0 and pads under-full rows with ``(0.0, INT_MAX)``.
- :func:`bm25_topk_probe` (JAX ``bm25_topk_pallas_probe``): the hash body's
  skip walk in ``positive_only`` mode over explicit candidate doc tiles per
  8-query tile, from the exact host term -> tile lists
  (:func:`build_term_tile_lists`, :func:`probe_candidates`) or the two-pass
  tile-WAND bound (:func:`bm25_topk_wand`), folded into the walk's group
  masks on the device (:func:`probe_group_masks`).
- :func:`bm25_topk_packed` (JAX ``bm25_topk_pallas_packed``) and
  :func:`bm25_topk_probe_packed` (JAX ``bm25_topk_pallas_probe_packed``):
  the whole walk and the probe over the packed layout, on the same body.
- :func:`bm25_route` / :func:`pruned_leg` / :func:`bm25_topk`: the dispatch.

CPU tensors take each kernel's plain version; CUDA tensors launch the kernel
or raise.
"""

from __future__ import annotations

import ctypes
import math
from typing import Callable, NamedTuple

import numpy as np
import torch

from autorag_research_tpu_torch.ops import cuda_build
from autorag_research_tpu_torch.ops.dense import _round_up
from autorag_research_tpu_torch.ops.topk import (
    INT_MAX,
    NEG_INF,
    merge_topk,
    pad_to_k,
    sort_topk,
    topk_ordered,
)

DOC_PAD = -1
QUERY_PAD = -2

# Kernel launches per wrapper: each wrapper adds one where it launches its
# kernel and nowhere else.
LAUNCHES = {
    "bm25_topk_v2": 0,
    "bm25_topk_v2_skip": 0,
    "bm25_topk_probe": 0,
    "bm25_topk_packed": 0,
    "bm25_topk_probe_packed": 0,
    "bm25_topk_v1": 0,
}
# Calls of the plain versions and the scan, whatever the device: a run on the
# card shows with these that its tensors never took a plain route.
PLAIN_CALLS = {
    "bm25_topk_scan": 0,
    "bm25_topk_v2_plain": 0,
    "bm25_topk_v2_skip_plain": 0,
    "bm25_topk_probe_plain": 0,
    "bm25_topk_packed_plain": 0,
    "bm25_topk_probe_packed_plain": 0,
    "bm25_topk_v1_plain": 0,
}

# [B, tile_n, L] f32 match weights of one scan step
SCAN_TILE_BUDGET = 512 << 20
# query terms the kernel stages in shared memory
KERNEL_T_MAX = 2048
# the Bloom bitmaps', the skip kernel's and the probe's doc tile
SKIP_BLOCK_N = 2048
# largest k the pruned routes serve (the JAX package's pruned_ok gate)
PRUNED_K_MAX = 2048
# queries per row of the probes' candidate lists and of the tile predicate
BLOCK_Q = 8
# words in a row of the lane-packed layout
PACKED_LANES = 128
# the hash body's tile plan (csrc/bm25_hash.cuh): the largest query tile,
# by default and at most (a tile's 8-query groups fill a 32-bit skip mask)
HASH_QB = 128
HASH_QB_MAX = 256
# a document's table: the next power of two >= HASH_TABLE_FACTOR L entries
# (a miss then rarely finds its first bucket full), but no more than
# HASH_TABLE_CAP entries where 2 L would do, and never fewer than 2 L
HASH_TABLE_FACTOR = 8
HASH_TABLE_CAP = 4096
# a block's and an SM's shared memory on sm_90 (the SM keeps 1 KiB per
# resident block), and the most of a block's the lists may take
SMEM_BLOCK_MAX = 232448
SMEM_SM = 233472
SMEM_BLOCK_RESERVED = 1024
HASH_LIST_SMEM_MAX = 64 << 10
# lists longer than HASH_K_DIRECT merge their candidates HASH_CAP at a time
# (bm25_hash.cuh's K_DIRECT and CAP: its launcher refuses a plan whose shared
# memory differs from its own count)
HASH_K_DIRECT = 64
HASH_CAP = 32
# resident blocks an SM's registers hold (the kernel's __launch_bounds__(256, 2))
HASH_BLOCKS_PER_SM_MAX = 2
# the hash body's walks (bm25_hash.cuh's Walk): whole parts, or the skip
# walk in positive_only or v2 mode
_WALK_FULL, _WALK_SKIP_POS, _WALK_SKIP_V2 = 0, 1, 2
# the pins that name a pruned leg of a flat single-device index
PRUNED_PINS = ("pallas_v2_skip", "pallas_probe", "pallas_wand")


def reset_launch_counts() -> None:
    for counts in (LAUNCHES, PLAIN_CALLS):
        for name in counts:
            counts[name] = 0


# ------------------------------------------------------------- plain paths
def _slot_match_scores(q_ids, q_w, tid, tw) -> torch.Tensor:
    """[B, n] f32 scores of a document tile, term by term in increasing t:
    the match weight of term t (summed over slots), times its query weight,
    added to the running score. Separate ops, so no FMA contraction."""
    scores = torch.zeros((q_ids.shape[0], tid.shape[0]), dtype=torch.float32, device=tid.device)
    for t in range(q_ids.shape[1]):
        match = tid[None, :, :] == q_ids[:, t, None, None]
        c = torch.where(match, tw[None], 0.0).sum(dim=2)
        scores = scores + c * q_w[:, t, None]
    return scores


def _scan_tile_n(b: int, slots: int, n: int) -> int:
    tile = max(32, (SCAN_TILE_BUDGET // max(b * slots * 4, 1)) // 32 * 32)
    return min(tile, _round_up(max(n, 1), 32))


def _prepare(q_ids, q_w, doc_ids, doc_w):
    dev = doc_ids.device
    return (
        torch.as_tensor(q_ids).to(dev, torch.int32),
        torch.as_tensor(q_w).to(dev, torch.float32),
        doc_ids.to(torch.int32),
        doc_w.to(torch.float32),
    )


def _positive_filler(scores, ids):
    """Entries masked by ``positive_only`` (score <= 0) become the kernel's
    ``(0.0, INT_MAX)`` filler."""
    empty = ~(scores > 0.0)
    return scores.masked_fill(empty, 0.0), ids.masked_fill(empty, INT_MAX)


def _scan(q_ids, q_w, doc_ids, doc_w, k: int, tile_n: int | None, positive_only: bool = False,
          allowed: torch.Tensor | None = None, allowed_block: int = SKIP_BLOCK_N):
    """The tiled scan behind every plain version. ``allowed`` [B, n_tiles]
    bool keeps, per query, only the documents of its doc tiles of
    ``allowed_block`` rows (the probe's candidate tiles)."""
    q_ids, q_w, doc_ids, doc_w = _prepare(q_ids, q_w, doc_ids, doc_w)
    b = q_ids.shape[0]
    n, slots = doc_ids.shape
    k_eff = min(k, n)
    dev = doc_ids.device
    scores = torch.full((b, k_eff), NEG_INF, dtype=torch.float32, device=dev)
    ids = torch.full((b, k_eff), INT_MAX, dtype=torch.int32, device=dev)
    if n == 0 or b == 0:
        return pad_to_k(scores, ids, k, k_eff)
    tile_n = min(tile_n or _scan_tile_n(b, slots, n), _round_up(n, 32))
    for base in range(0, n, tile_n):
        tile_s = _slot_match_scores(q_ids, q_w, doc_ids[base : base + tile_n], doc_w[base : base + tile_n])
        if positive_only:
            tile_s = torch.where(tile_s > 0.0, tile_s, NEG_INF)
        if allowed is not None:
            cols = torch.arange(base, base + tile_s.shape[1], device=dev) // allowed_block
            tile_s = torch.where(allowed[:, cols], tile_s, NEG_INF)
        top_s, top_i = topk_ordered(tile_s, min(k_eff, tile_s.shape[1]))
        scores, ids = sort_topk(
            torch.cat([scores, top_s], dim=1), torch.cat([ids, top_i + base], dim=1), k_eff
        )
    if positive_only:
        scores, ids = _positive_filler(scores, ids)
    return pad_to_k(scores, ids, k, k_eff)


def bm25_topk_scan(
    q_ids: torch.Tensor,
    q_weights: torch.Tensor,
    doc_ids: torch.Tensor,
    doc_weights: torch.Tensor,
    k: int,
    tile_n: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact BM25 top-k as a loop over document tiles of ``tile_n`` rows (JAX
    ``bm25_topk_xla``), each step's [B, tile_n, L] match weights within
    ``SCAN_TILE_BUDGET`` by default. Zero-score documents are candidates.
    Returns (scores f32 [B, k], rows int32 [B, k]) in ``(-score, row)``
    order, padded past the corpus with ``(NEG_INF, INT_MAX)``."""
    PLAIN_CALLS["bm25_topk_scan"] += 1
    return _scan(q_ids, q_weights, doc_ids, doc_weights, k, tile_n)


def bm25_topk_v2_plain(q_ids, q_weights, doc_ids, doc_weights, k: int):
    """Plain PyTorch version of :func:`bm25_topk_v2`: the same top-k, zero
    scores included, by a tiled scan."""
    PLAIN_CALLS["bm25_topk_v2_plain"] += 1
    return _scan(q_ids, q_weights, doc_ids, doc_weights, k, None)


def _check_bitmaps(bitmaps, n: int, block_n: int) -> None:
    """The bitmaps must tile the corpus at the kernel's block_n: a re-tiled
    corpus would let tile t's filter clear another tile's terms."""
    n_tiles = -(-n // block_n)
    if bitmaps.ndim != 2 or bitmaps.shape[0] != n_tiles:
        raise ValueError(
            f"bitmaps built for {bitmaps.shape[0]} tiles, the corpus has {n_tiles} tiles of "
            f"block_n={block_n}; rebuild the bitmaps at this block_n"
        )


def bm25_topk_v2_skip_plain(
    q_ids, q_weights, doc_ids, doc_weights, bitmaps, k: int,
    block_n: int = SKIP_BLOCK_N, positive_only: bool = False,
):
    """Plain PyTorch version of :func:`bm25_topk_v2_skip`. The predicate has
    no false negatives, so the function is the scan's: with
    ``positive_only=False`` the v2 top-k; with ``positive_only=True`` only
    scores > 0, under-full rows padded with ``(0.0, INT_MAX)``. The bitmaps
    are checked against ``block_n`` as the kernel checks them."""
    _check_bitmaps(bitmaps, doc_ids.shape[0], block_n)
    PLAIN_CALLS["bm25_topk_v2_skip_plain"] += 1
    return _scan(q_ids, q_weights, doc_ids, doc_weights, k, None, positive_only)


def _check_candidates(cand, count, b: int) -> None:
    q_tiles = -(-b // BLOCK_Q)
    if cand.ndim != 2 or cand.shape[0] != q_tiles or count.shape != (cand.shape[0],):
        raise ValueError(
            f"cand {tuple(cand.shape)} / count {tuple(count.shape)} must hold one row per "
            f"query tile of {BLOCK_Q}: {q_tiles} rows for {b} queries"
        )


def _candidate_mask(cand, count, b: int, n_tiles: int) -> torch.Tensor:
    """[B, n_tiles] bool: the live, in-range candidate tiles of each
    query's tile."""
    q_tiles, cap = cand.shape
    live = torch.arange(cap, device=cand.device)[None, :] < count.to(cand.device)[:, None]
    live &= (cand >= 0) & (cand < n_tiles)
    tile_ok = torch.zeros((q_tiles, n_tiles), dtype=torch.bool, device=cand.device)
    rows = torch.arange(q_tiles, device=cand.device)[:, None].expand(q_tiles, cap)
    tile_ok[rows[live], cand[live].long()] = True
    return tile_ok[torch.arange(b, device=cand.device) // BLOCK_Q]


def bm25_topk_probe_plain(
    q_ids, q_weights, doc_ids, doc_weights, cand, count, k: int, block_n: int = SKIP_BLOCK_N,
):
    """Plain PyTorch version of :func:`bm25_topk_probe`: the positive hits
    of each query among the documents of its query tile's candidate tiles
    (``cand[g, :count[g]]``, tiles of ``block_n`` rows), in ``(-score, row)``
    order, under-full rows padded with ``(0.0, INT_MAX)``."""
    b = q_ids.shape[0]
    _check_candidates(cand, count, b)
    PLAIN_CALLS["bm25_topk_probe_plain"] += 1
    dev = doc_ids.device
    n_tiles = -(-doc_ids.shape[0] // block_n)
    allowed = _candidate_mask(
        torch.as_tensor(cand).to(dev, torch.int64), torch.as_tensor(count).to(dev, torch.int64),
        b, n_tiles,
    )
    return _scan(q_ids, q_weights, doc_ids, doc_weights, k, None, True, allowed, block_n)


def bm25_topk_v1_plain(q_ids, q_weights, doc_ids, doc_weights, k: int):
    """Plain PyTorch version of :func:`bm25_topk_v1`: v2's function, so the
    same tiled scan."""
    PLAIN_CALLS["bm25_topk_v1_plain"] += 1
    return _scan(q_ids, q_weights, doc_ids, doc_weights, k, None)


# ------------------------------------------------------ lane-packed layout
def pack_slots(
    doc_ids: np.ndarray, doc_weights: np.ndarray, width: int
) -> tuple[np.ndarray, np.ndarray, int]:
    """Pack P = 128 // width docs per 128-word row (doc d -> row d // P,
    lane group d % P, stride 128 // P). Returns (packed_ids [ceil(N/P), 128],
    packed_weights, P); the lanes past P * stride, and the groups past the
    last document, are ``DOC_PAD`` / 0. ``P == 1`` returns the arrays as
    they are. Raises ``ValueError`` when a live slot lies beyond ``width``.
    The JAX ``pack_slots``, bit for bit."""
    p = max(1, PACKED_LANES // width)
    if p == 1:
        return doc_ids, doc_weights, 1
    if doc_ids.shape[1] > width and (doc_ids[:, width:] != DOC_PAD).any():
        raise ValueError(
            f"pack_slots(width={width}): some docs have live terms beyond "
            f"slot {width}; pack only corpora whose docs fit the width"
        )
    # the stride, not the raw width, is what the kernels derive from P
    # (width 24 -> P 5 -> stride 25)
    stride = PACKED_LANES // p
    n = doc_ids.shape[0]
    rows = -(-n // p)
    ids = np.full((rows * p, stride), DOC_PAD, doc_ids.dtype)
    w = np.zeros((rows * p, stride), doc_weights.dtype)
    ids[:n, :width] = doc_ids[:, :width]
    w[:n, :width] = doc_weights[:, :width]
    out_ids = np.full((rows, PACKED_LANES), DOC_PAD, doc_ids.dtype)
    out_w = np.zeros((rows, PACKED_LANES), doc_weights.dtype)
    out_ids[:, : p * stride] = ids.reshape(rows, p * stride)
    out_w[:, : p * stride] = w.reshape(rows, p * stride)
    return out_ids, out_w, p


def _check_packed(packed_ids, packed_w, n_docs: int, pack: int) -> None:
    if not 2 <= pack <= PACKED_LANES:
        raise ValueError(f"pack must be in [2, {PACKED_LANES}], got {pack}")
    for x, name in ((packed_ids, "packed_ids"), (packed_w, "packed_weights")):
        if x.ndim != 2 or x.shape[1] != PACKED_LANES or x.shape[0] * pack < n_docs:
            raise ValueError(
                f"{name} {tuple(x.shape)} must be [R, {PACKED_LANES}] with R * pack >= "
                f"n_docs = {n_docs} (pack_slots's layout)"
            )


def _unpack(packed_ids, packed_w, n_docs: int, pack: int):
    """The packed layout's documents as flat [n_docs, 128 // pack] slot
    arrays (the dead tail lanes dropped)."""
    stride = PACKED_LANES // pack
    rows = packed_ids.shape[0]
    return tuple(
        x[:, : pack * stride].reshape(rows * pack, stride)[:n_docs] for x in (packed_ids, packed_w)
    )


def bm25_topk_packed_plain(q_ids, q_weights, packed_ids, packed_weights, n_docs: int, k: int,
                           pack: int):
    """Plain PyTorch version of :func:`bm25_topk_packed`: the scan over the
    unpacked documents, bitwise :func:`bm25_topk_v2_plain` on the flat
    arrays (pad slots add zeros)."""
    _check_packed(packed_ids, packed_weights, n_docs, pack)
    PLAIN_CALLS["bm25_topk_packed_plain"] += 1
    doc_ids, doc_w = _unpack(packed_ids, packed_weights, n_docs, pack)
    return _scan(q_ids, q_weights, doc_ids, doc_w, k, None)


def _check_probe_k(k_eff: int, block_n: int) -> None:
    if k_eff > block_n:
        # the JAX kernel extracts k per lane group from block_n packed rows
        raise ValueError(
            f"k={k_eff} needs block_n >= {k_eff} packed rows; rebuild the "
            "term->tile lists at a larger block or use a full-scan method"
        )


def bm25_topk_probe_packed_plain(q_ids, q_weights, packed_ids, packed_weights, n_docs: int,
                                 pack: int, cand, count, k: int, block_n: int = 1024):
    """Plain PyTorch version of :func:`bm25_topk_probe_packed`: the probe's
    positive hits over the unpacked documents, a candidate tile being
    ``block_n`` packed rows (``block_n * pack`` documents)."""
    _check_packed(packed_ids, packed_weights, n_docs, pack)
    _check_probe_k(min(k, n_docs), block_n)
    b = q_ids.shape[0]
    _check_candidates(cand, count, b)
    PLAIN_CALLS["bm25_topk_probe_packed_plain"] += 1
    dev = packed_ids.device
    tile = block_n * pack
    allowed = _candidate_mask(
        torch.as_tensor(cand).to(dev, torch.int64), torch.as_tensor(count).to(dev, torch.int64),
        b, -(-n_docs // tile),
    )
    doc_ids, doc_w = _unpack(packed_ids, packed_weights, n_docs, pack)
    return _scan(q_ids, q_weights, doc_ids, doc_w, k, None, True, allowed, tile)


# ------------------------------------------------------------ Bloom filters
# Knuth-style odd multipliers of the 4 Bloom probes (the JAX package's).
_BLOOM_MULTS = (0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D, 0x27D4EB2F)


def _bloom_positions(terms: np.ndarray, space: int) -> list[np.ndarray]:
    t = terms.astype(np.uint64)
    return [((t * np.uint64(m)) % np.uint64(space)).astype(np.int64) for m in _BLOOM_MULTS]


def bitmap_words_for(doc_ids: np.ndarray, block_n: int) -> int:
    """Words per tile filter: about 16 bits per distinct term (4 probes ->
    ~20% fill, ~0.2% per-term false positives), distinct terms per tile
    estimated as the max over up to 8 evenly spaced tiles, rounded up to a
    power of two (at least 64 words)."""
    n = doc_ids.shape[0]
    if n == 0:
        return 64
    n_tiles = -(-n // block_n)
    distinct = 1
    for t in np.unique(np.linspace(0, n_tiles - 1, num=min(8, n_tiles), dtype=int)):
        tile = doc_ids[t * block_n : (t + 1) * block_n]
        distinct = max(distinct, len(np.unique(tile[tile >= 0])) or 1)
    return max(64, int(2 ** np.ceil(np.log2(distinct * 16 / 32))))


def build_tile_bitmaps(doc_ids: np.ndarray, block_n: int, n_words: int | None = None) -> np.ndarray:
    """Per-doc-tile 4-probe Bloom term filters, [n_tiles, n_words] int32:
    tile t covers doc rows [t*block_n, (t+1)*block_n), and a term is possibly
    present iff all 4 probe bits are set. False positives only cost a missed
    skip. The numpy path of the JAX ``build_tile_bitmaps``, bit for bit."""
    n = doc_ids.shape[0]
    n_tiles = -(-n // block_n)
    if n_words is None:
        n_words = bitmap_words_for(doc_ids, block_n)
    space = 32 * n_words
    if space & (space - 1):
        raise ValueError(
            f"n_words must make 32*n_words a power of two (got {n_words}): the "
            "query-side probe reduces modulo 2^32 first, which agrees with these "
            "bitmap residues only when the space divides 2^32"
        )
    rows, cols = np.nonzero(doc_ids >= 0)
    keys = np.unique((rows // block_n).astype(np.int64) * (2**32) + doc_ids[rows, cols])
    tile_of = (keys >> 32).astype(np.int64)
    term_of = (keys & 0xFFFFFFFF).astype(np.int64)
    total_bits = n_tiles * space
    if total_bits <= (1 << 31):
        # one byte per bit, then packbits
        bits = np.zeros(total_bits, np.uint8)
        for pos in _bloom_positions(term_of, space):
            bits[tile_of * space + pos] = 1
        flat = np.packbits(bits, bitorder="little").view(np.int32)
    else:
        flat = np.zeros(n_tiles * n_words, dtype=np.int32)
        coords = np.unique(
            np.concatenate([tile_of * space + pos for pos in _bloom_positions(term_of, space)])
        )
        np.bitwise_or.at(flat, coords // 32, (np.int64(1) << (coords % 32)).astype(np.int32))
    return flat.reshape(n_tiles, n_words)


def cluster_doc_order(doc_ids: np.ndarray, doc_freq: np.ndarray) -> np.ndarray:
    """Permutation grouping documents by their rarest term (lowest df), so
    that selective terms co-locate in few tiles and the tile predicate can
    prune. Ties at the k boundary may then resolve to other (equally scored)
    documents than in the unclustered layout."""
    n, _ = doc_ids.shape
    safe = np.where(doc_ids >= 0, doc_ids, 0)
    dfs = np.where(doc_ids >= 0, doc_freq[safe], np.iinfo(np.int64).max)
    rarest_slot = np.argmin(dfs, axis=1)
    rarest_term = doc_ids[np.arange(n), rarest_slot]
    return np.argsort(rarest_term, kind="stable")


def _query_tile_hits(q_ids, bitmaps: torch.Tensor) -> torch.Tensor:
    """[n_tiles, B] bool on the bitmaps' device: True iff some live term of
    query b is possibly present in doc tile j (all 4 Bloom probe bits set),
    the 4 probes gathered at once. The probe ``(q * mult) mod 2^32 mod
    space`` runs in int64 (torch has no general uint32 arithmetic)."""
    n_tiles, n_words = bitmaps.shape
    space = 32 * n_words
    if space & (space - 1):
        raise ValueError(f"32 * {n_words} words is not a power of two")
    q = torch.as_tensor(q_ids).to(bitmaps.device, torch.int64)
    live = q >= 0
    # the multipliers as Python scalars: a tensor of them would be a
    # blocking host-to-device copy on every call
    pos = torch.where(live, torch.stack([(q * m) & 0xFFFFFFFF for m in _BLOOM_MULTS]) % space, 0)
    words = bitmaps[:, pos // 32]  # [n_tiles, 4, B, T]
    probe = ((words >> (pos % 32).to(words.dtype)) & 1) != 0
    return (probe.all(dim=1) & live).any(dim=2)


def tile_match(q_ids: torch.Tensor, bitmaps: torch.Tensor, bq: int = BLOCK_Q) -> torch.Tensor:
    """(query tile x doc tile) Bloom term-presence predicate, bool
    [ceil(B/bq), n_tiles], on the bitmaps' device (JAX ``_tile_match``): True
    iff some query term of the tile of ``bq`` queries is possibly present in
    the doc tile. The last query tile's pad rows replicate rows 0.. as the
    JAX wrapper's do, so the matrix is the JAX package's bit for bit."""
    hits = _query_tile_hits(q_ids, bitmaps)
    n_tiles, b = hits.shape
    q_tiles = -(-b // bq)
    row_src = torch.arange(q_tiles * bq, device=hits.device) % max(b, 1)
    return hits[:, row_src].reshape(n_tiles, q_tiles, bq).any(dim=2).T


def _check_group_tile(qb: int) -> None:
    if qb % BLOCK_Q or not BLOCK_Q <= qb <= HASH_QB_MAX:
        raise ValueError(f"qb={qb} must be a multiple of {BLOCK_Q} in [{BLOCK_Q}, {HASH_QB_MAX}]")


def _pack_group_bits(groups: torch.Tensor) -> torch.Tensor:
    """[q_tiles, qb / 8, n_tiles] bool -> int32 [q_tiles, n_tiles] masks, bit g
    from group g (bit 31 the sign bit)."""
    bits = torch.arange(groups.shape[1], device=groups.device)[None, :, None]
    masks = (groups.to(torch.int64) << bits).sum(dim=1)
    return torch.where(masks >= 2**31, masks - 2**32, masks).to(torch.int32).contiguous()


def tile_group_masks(q_ids: torch.Tensor, bitmaps: torch.Tensor, qb: int) -> torch.Tensor:
    """The skip walk's predicate, int32 [ceil(B/qb), n_tiles] on the bitmaps'
    device: bit g of entry (i, j) is set iff some query of the 8-query group
    g of query tile i (queries ``i qb + 8 g`` to ``+ 7`` that are < B) may
    hold a term of doc tile j. Group g is row ``i qb / 8 + g`` of
    :func:`tile_match`'s matrix (the JAX kernel's own 8-query rows), except
    that queries past B set no bit, where ``tile_match`` ORs rows of other
    tiles into its last row. ``qb`` is a multiple of 8 up to
    ``HASH_QB_MAX`` (32 groups, bit 31 the sign bit)."""
    _check_group_tile(qb)
    hits = _query_tile_hits(q_ids, bitmaps)
    n_tiles, b = hits.shape
    q_tiles = -(-b // qb)
    hits = torch.cat([hits, hits.new_zeros((n_tiles, q_tiles * qb - b))], dim=1)
    groups = hits.reshape(n_tiles, q_tiles, qb // BLOCK_Q, BLOCK_Q).any(dim=3)
    return _pack_group_bits(groups.permute(1, 2, 0))


def probe_group_masks(cand: torch.Tensor, count: torch.Tensor, b: int, qb: int,
                      n_tiles: int) -> torch.Tensor:
    """The probes' skip masks from their candidate lists, int32 [ceil(B/qb),
    n_tiles] on ``cand``'s device: bit g of entry (i, j) is set iff tile j is
    a live, in-range entry of row ``i qb / 8 + g`` of ``cand`` [ceil(B/8),
    cap] (the rows of :func:`_candidate_mask`): an entry before ``count``
    (so a count past ``cap`` counts ``cap``), with ``0 <= tile < n_tiles``;
    a repeated entry sets its bit once, in any order; rows past ceil(B/8)
    set none. ``qb`` and the bit layout as in :func:`tile_group_masks`.
    Tensor ops on the device only: no host sync."""
    _check_group_tile(qb)
    dev = cand.device
    cand = cand.to(torch.int64)
    rows, cap = cand.shape
    q_tiles = -(-b // qb)
    live = (cand >= 0) & (cand < n_tiles)
    live &= torch.arange(cap, device=dev) < count.to(dev)[:, None]
    if rows > -(-b // BLOCK_Q):
        live[-(-b // BLOCK_Q):] = False
    # one flag per (8-query group, tile) and one dump slot for dead entries:
    # an index put, so repeats set a flag once and nothing is read back
    size = q_tiles * (qb // BLOCK_Q) * n_tiles
    flags = torch.zeros(size + 1, dtype=torch.bool, device=dev)
    row_start = torch.arange(0, rows * n_tiles, n_tiles, device=dev)[:, None]
    flags[torch.where(live, cand + row_start, size)] = True
    return _pack_group_bits(flags[:size].view(q_tiles, qb // BLOCK_Q, n_tiles))


# ------------------------------------------------- host term -> tile lists
def _csr_by_term(terms: np.ndarray) -> np.ndarray:
    vocab = int(terms[-1]) + 1 if len(terms) else 1
    return np.cumsum(np.bincount(terms + 1, minlength=vocab + 1)).astype(np.int64)


def build_term_tile_lists(doc_ids: np.ndarray, block_n: int) -> tuple[np.ndarray, np.ndarray]:
    """Exact host inverted index at tile granularity: CSR (indptr, tiles)
    mapping term id -> sorted unique doc tiles holding it, the probe's
    candidate source. The numpy path of the JAX ``build_term_tile_lists``,
    bit for bit."""
    n = doc_ids.shape[0]
    n_tiles = max(1, -(-n // block_n))
    rows, cols = np.nonzero(doc_ids >= 0)
    keys = np.unique(doc_ids[rows, cols].astype(np.int64) * n_tiles + (rows // block_n))
    terms = keys // n_tiles
    return _csr_by_term(terms), (keys % n_tiles).astype(np.int32)


def build_term_tile_maxw(
    doc_ids: np.ndarray, doc_weights: np.ndarray, block_n: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Exact host (term -> tile -> max BM25 weight) CSR, the WAND bound's
    source: the keys of :func:`build_term_tile_lists` with ``maxw[i]``, the
    largest per-document total weight of ``terms[i]`` in tile ``tiles[i]``,
    inflated by ``1 + 1e-6`` so that the f32 bound stays above the kernel's
    own f32 sum. Bitwise equal to the JAX ``build_term_tile_maxw``; the
    sums and maxima run through ``bincount`` and a sort instead of
    ``np.add.at`` / ``np.maximum.at`` (the same values, in seconds at
    500,000 documents)."""
    n = doc_ids.shape[0]
    n_tiles = max(1, -(-n // block_n))
    rows, cols = np.nonzero(doc_ids >= 0)
    terms_all = doc_ids[rows, cols].astype(np.int64)
    w_all = np.asarray(doc_weights, np.float64)[rows, cols]
    # per-(term, doc) slot-weight totals, summed in slot order ...
    keys_td, inv_td = np.unique(terms_all * n + rows, return_inverse=True)
    sums = np.bincount(inv_td.ravel(), weights=w_all, minlength=len(keys_td))
    terms_u = keys_td // n
    tiles_u = (keys_td % n) // block_n
    # ... then the per-(term, tile) maximum over documents
    keys, inv = np.unique(terms_u * n_tiles + tiles_u, return_inverse=True)
    inv = inv.ravel()
    order = np.lexsort((sums, inv))
    last = np.ones(len(order), bool)
    last[:-1] = inv[order][1:] != inv[order][:-1]
    maxw64 = np.zeros(len(keys), np.float64)
    maxw64[inv[order][last]] = np.maximum(sums[order][last], 0.0)
    maxw = (maxw64 * (1.0 + 1e-6)).astype(np.float32)
    terms = keys // n_tiles
    return _csr_by_term(terms), (keys % n_tiles).astype(np.int32), maxw


def probe_candidates(
    q_ids: np.ndarray, indptr: np.ndarray, tiles: np.ndarray, bq: int, cap: int
) -> tuple[np.ndarray, np.ndarray, int]:
    """Union the term -> tile lists of each query tile of ``bq`` queries:
    (cand [q_tiles, cap] int32 in increasing order, count [q_tiles],
    max_count). A union beyond ``cap`` is truncated, so the caller checks
    ``max_count`` (JAX ``probe_candidates``)."""
    bsz = q_ids.shape[0]
    q_tiles = -(-bsz // bq)
    vocab = len(indptr) - 1
    cand = np.zeros((q_tiles, cap), np.int32)
    count = np.zeros(q_tiles, np.int32)
    max_count = 0
    for i in range(q_tiles):
        terms = q_ids[i * bq : min((i + 1) * bq, bsz)].ravel()
        terms = terms[(terms >= 0) & (terms < vocab)]
        chunks = [tiles[indptr[t] : indptr[t + 1]] for t in terms]
        union = np.unique(np.concatenate(chunks)) if chunks else np.empty(0, np.int32)
        max_count = max(max_count, len(union))
        union = union[:cap]
        cand[i, : len(union)] = union
        count[i] = len(union)
    return cand, count, max_count


def wand_upper_bounds(
    q_ids: np.ndarray,
    q_weights: np.ndarray,
    indptr: np.ndarray,
    tiles: np.ndarray,
    maxw: np.ndarray,
    n_tiles: int,
) -> tuple[np.ndarray, np.ndarray]:
    """Per-query per-tile WAND bounds on the host (JAX ``wand_upper_bounds``
    with ``return_single_best``): ub [B, n_tiles] >= every score in the
    tile (0 where no query term is), and sb, the best single-term
    contribution ``max_t qw_t * maxw(t, tile)``, a lower bound on the best
    score the tile attains. One vectorized step per term position t over
    the whole batch, in the JAX loop's f32 order (a query's term lists hold
    each tile once, so no (query, tile) pair repeats within a step): bitwise
    the JAX result."""
    bsz, n_terms = q_ids.shape
    vocab = len(indptr) - 1
    ub = np.zeros((bsz, n_tiles), np.float32)
    sb = np.zeros((bsz, n_tiles), np.float32)
    for t in range(n_terms):
        tid = q_ids[:, t].astype(np.int64)
        w = q_weights[:, t].astype(np.float32)
        live = np.flatnonzero((tid >= 0) & (tid < vocab) & (w > 0.0))
        lo = indptr[tid[live]]
        lens = indptr[tid[live] + 1] - lo
        rows = np.repeat(live, lens)
        entries = np.repeat(lo - np.cumsum(lens) + lens, lens) + np.arange(int(lens.sum()))
        vals = w[rows] * maxw[entries]
        cols = tiles[entries]
        ub[rows, cols] += vals
        sb[rows, cols] = np.maximum(sb[rows, cols], vals)
    return ub, sb


# ----------------------------------------------------------------- kernels
def _check_kernel_operands(q_ids, q_w, doc_ids, doc_w) -> None:
    for x, name, dtype in (
        (q_ids, "q_ids", torch.int32), (q_w, "q_weights", torch.float32),
        (doc_ids, "doc_ids", torch.int32), (doc_w, "doc_weights", torch.float32),
    ):
        if not x.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor")
        if x.dtype != dtype or x.ndim != 2 or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 2-D {dtype} tensor")
        if x.device != doc_ids.device:
            raise ValueError("the operands must share a device")
    if q_ids.shape != q_w.shape or doc_ids.shape != doc_w.shape:
        raise ValueError("ids and weights must share a shape")
    if q_ids.shape[1] > KERNEL_T_MAX:
        raise ValueError(f"the BM25 kernel stages at most {KERNEL_T_MAX} terms per query")


def _kernel_queries(q_ids, q_w, dev):
    return (torch.as_tensor(q_ids).to(dev, torch.int32).contiguous(),
            torch.as_tensor(q_w).to(dev, torch.float32).contiguous())


class HashPlan(NamedTuple):
    """The tile plan of one ``csrc/bm25_hash.cuh`` launch."""

    qb: int  # queries of a block's query tile
    docs: int  # documents of a staged tile (D, a power of two <= 32)
    table: int  # entries of a document's term table (a power of two >= 2 L, >= 8)
    list_smem: bool  # the k-best lists in shared memory (else in the output)
    staged: bool  # slots staged and tables in shared memory (else D = 1, global scratch)
    smem: int  # dynamic shared memory bytes of a block
    q_tiles: int
    part: int  # documents of a part, a multiple of docs
    parts: int
    blocks_per_sm: int  # resident blocks an SM holds by the plan's count (sets parts)


def _r16(x: int) -> int:
    return -(-x // 16) * 16


def _pow2_at_least(x: int) -> int:
    return 1 << max(0, x - 1).bit_length()


def _stage_words(docs: int, slots: int, pack: int) -> int:
    """Words of one staged tile of ``docs`` documents (``bm25_hash.cuh``'s
    ``stage_words``): ``docs`` rows of ``slots`` slots, or in the packed
    layout (``pack > 1``) the whole 128-word rows they lie in. A tile starts
    at a multiple of ``docs``, so it meets at most ``(pack - gcd(docs, pack)
    + docs - 1) // pack + 1`` rows."""
    if pack == 1:
        return docs * slots
    return ((pack - math.gcd(docs, pack) + docs - 1) // pack + 1) * PACKED_LANES


def _hash_smem(docs: int, table: int, slots: int, t: int, qb: int, k: int, list_smem: bool,
               staged: bool, pack: int = 1) -> int:
    """Dynamic shared memory of a block: ``bm25_hash.cuh``'s ``Layout``, each
    region rounded to 16 bytes (the tables' (key, weight) pairs, two staged
    tiles of ids and weights, 32 documents' repeat marks and, packed, their
    staged offsets, the query tile's compacted (term, first bucket) pairs
    and weights in rows of T rounded up to 4, its term counts, the lists
    when they sit there, and past ``HASH_K_DIRECT`` each query's buffer of
    ``HASH_CAP`` candidates)."""
    dh = docs * table if staged else 0
    dl = _stage_words(docs, slots, pack) if staged else 0
    lk = qb * k if list_smem else 0
    lb = qb if k > HASH_K_DIRECT else 0
    tp = _round_up(t, 4)
    return (_r16(dh * 8) + 4 * _r16(dl * 4) + _r16(32 * 4) + (_r16(32 * 4) if pack > 1 else 0)
            + _r16(qb * tp * 8) + _r16(qb * tp * 4) + _r16(qb * 4) + 2 * _r16(lk * 4)
            + 2 * _r16(lb * HASH_CAP * 4) + _r16(lb * 4))


def _hash_fit(qb: int, table: int, slots: int, t: int, k: int, max_docs: int, pack: int):
    """(docs, list_smem, smem) of the first staged layout that fits a query
    tile of ``qb``: lists in shared memory first (when within
    ``HASH_LIST_SMEM_MAX``), two blocks an SM before one, the most documents
    up to ``max_docs`` first; None when not even one document fits a block."""
    two = SMEM_SM // 2 - SMEM_BLOCK_RESERVED
    for list_smem in (True, False) if qb * k * 8 <= HASH_LIST_SMEM_MAX else (False,):
        for budget in (two, SMEM_BLOCK_MAX):
            for docs in (32, 16, 8, 4, 2, 1):
                if docs > max_docs:
                    continue
                smem = _hash_smem(docs, table, slots, t, qb, k, list_smem, True, pack)
                if smem <= budget:
                    return docs, list_smem, smem
    return None


def bm25_hash_plan(b: int, t: int, n: int, slots: int, k: int, sms: int,
                   qb_max: int = HASH_QB, block_n: int | None = None, pack: int = 1) -> HashPlan:
    """Tile plan of the hash body for B queries of T terms over N documents
    of L slots, lists of k (pure: the CPU tests check its invariants). The
    table has the next power of two >= ``HASH_TABLE_FACTOR`` L entries, cut
    to ``HASH_TABLE_CAP`` but never below 2 L (and at least 8). The query
    tile is the largest multiple of 8 up to ``qb_max`` (a multiple of 8 up
    to ``HASH_QB_MAX``; ``chip_smoke.py`` times other values than
    ``HASH_QB``), halved while :func:`_hash_fit` finds no staged layout for
    it; a row too wide even for a tile of 8 takes D = 1, 8 queries, lists in
    the output and the table in global scratch. Parts split the corpus so
    that the grid fills the SMs in one wave, no more (one block an SM with
    global scratch, so the scratch stays within ``sms * table`` entries).

    The skip walk (``block_n``, its skip tile): D divides ``block_n``, so a
    staged tile lies in one skip tile (a part may start inside one: parts of
    whole skip tiles would give the slowest block up to a skip tile more
    work). The packed layout (``pack > 1``, ``slots = 128 // pack``):
    a staged tile holds the whole 128-word rows its documents lie in."""
    table = max(8, _pow2_at_least(2 * slots),
                min(_pow2_at_least(HASH_TABLE_FACTOR * slots), HASH_TABLE_CAP))
    max_docs = min(32, block_n & -block_n) if block_n else 32
    qb = min(_round_up(max(b, 1), 8), qb_max)
    fit = _hash_fit(qb, table, slots, t, k, max_docs, pack)
    while fit is None and qb > 8:
        qb = max(8, qb // 2 // 8 * 8)
        fit = _hash_fit(qb, table, slots, t, k, max_docs, pack)
    staged = fit is not None
    if not staged and pack > 1:
        raise ValueError(f"no staged plan for the packed layout (pack {pack}, T = {t}, k = {k})")
    docs, list_smem, smem = fit if staged else (1, False, _hash_smem(1, table, slots, t, 8, k, False,
                                                                     False))
    qb = qb if staged else 8
    per_sm = max(1, min(HASH_BLOCKS_PER_SM_MAX, SMEM_SM // (smem + SMEM_BLOCK_RESERVED)))
    q_tiles = -(-b // qb)
    target = per_sm * sms if staged else sms
    parts = max(1, min(-(-n // docs), target // q_tiles))  # one wave
    part = _round_up(-(-n // parts), docs)
    return HashPlan(qb, docs, table, list_smem, staged, smem, q_tiles, part, -(-n // part), per_sm)


def bm25_tile_plan(b: int, t: int, n: int, slots: int, k: int, sms: int, qb_max: int = HASH_QB,
                   block_n: int | None = None, pack: int = 1) -> HashPlan:
    """The plan a hash-body launch takes (pure): :func:`bm25_hash_plan`'s,
    but a query tile past ``HASH_QB`` only where it stages as many documents
    a tile (D) as the ``HASH_QB`` plan, else that plan. A wider tile halves
    the table builds, once per (query tile, document), which pays where they
    are most of the walk, as for the probes' few live terms; past the lists'
    shared-memory room it halves D too, and then costs more than it saves
    (``chip_smoke.py``'s query-tile sweeps of the probe on an H100 SXM: QB
    256 28% faster at k = 10, 41% slower at k = 1,000 with D 2 for 4)."""
    plan = bm25_hash_plan(b, t, n, slots, k, sms, qb_max, block_n, pack)
    if qb_max <= HASH_QB:
        return plan
    base = bm25_hash_plan(b, t, n, slots, k, sms, HASH_QB, block_n, pack)
    return plan if plan.docs >= base.docs else base


def _hash_topk(name: str, q_ids, q_w, doc_ids, doc_w, k: int, qb_max: int = HASH_QB, *,
               group_masks: Callable[[int], torch.Tensor] | None = None, block_n: int | None = None,
               positive_only: bool = True, n_docs: int | None = None, pack: int = 1,
               stats: torch.Tensor | None = None):
    """Top-k of CUDA tensors through ``csrc/bm25_hash.cuh``'s body, launched
    by ``csrc/bm25_v2.cu``'s ``<name>_launch`` on :func:`bm25_tile_plan`'s
    plan (query tiles up to ``qb_max``) and counted under ``LAUNCHES[name]``;
    per-part lists merged.
    ``group_masks`` takes the skip walk over skip tiles of ``block_n``
    documents: called with the plan's query tile ``qb``, it returns the
    walk's int32 [ceil(B/qb), ceil(N/block_n)] masks (the caller's
    predicate: :func:`tile_group_masks` or :func:`probe_group_masks`);
    ``positive_only`` picks the walk's mode. ``pack > 1``:
    ``doc_ids`` / ``doc_w`` are :func:`pack_slots`'s rows holding ``n_docs``
    documents (a power-of-two pack is read as the flat [R pack, 128 / pack]
    array it is). ``stats``: a CUDA int64 [2] that the skip walk adds its
    counts to: the (query, document) pairs that probed nothing, and the
    (query tile, document) pairs never staged."""
    dev = doc_ids.device
    b = q_ids.shape[0]
    n = doc_ids.shape[0] if n_docs is None else n_docs
    k_eff = min(k, n)
    if k_eff == 0 or b == 0:
        return _empty_topk(b, k, dev)
    q_ids, q_w = _kernel_queries(q_ids, q_w, dev)
    _check_kernel_operands(q_ids, q_w, doc_ids, doc_w)
    b, t = q_ids.shape
    slots = doc_ids.shape[1]
    if pack > 1:
        slots = PACKED_LANES // pack
        if pack & (pack - 1) == 0:  # the packed rows are the flat array
            doc_ids, doc_w = (x.view(-1, slots)[:n] for x in (doc_ids, doc_w))
            pack = 1
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = bm25_tile_plan(b, t, n, slots, k_eff, sms, qb_max, block_n, pack)
    masks = None
    walk = _WALK_FULL
    if group_masks is not None:
        masks = group_masks(plan.qb)
        if masks.shape != (plan.q_tiles, -(-n // block_n)) or masks.dtype != torch.int32 \
                or masks.device != dev:
            raise ValueError(f"group masks {tuple(masks.shape)} {masks.dtype} on {masks.device}: "
                             f"the skip walk takes int32 [{plan.q_tiles}, {-(-n // block_n)}] on {dev}")
        masks = masks.contiguous()
        walk = _WALK_SKIP_POS if positive_only else _WALK_SKIP_V2
    out_s = torch.empty((b, plan.parts, k_eff), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, plan.parts, k_eff), dtype=torch.int32, device=dev)
    g_tab = None
    if not plan.staged:  # (key, weight) pairs, one table per block
        g_tab = torch.empty(2 * plan.q_tiles * plan.parts * plan.table, dtype=torch.int32, device=dev)
    # 16-byte copies: tiles of a multiple of 4 words (whole packed rows, or D
    # rows of L slots) on aligned arrays
    vec = ((pack > 1 or plan.docs * slots % 4 == 0) and doc_ids.data_ptr() % 16 == 0
           and doc_w.data_ptr() % 16 == 0)
    fn = getattr(cuda_build.load("bm25_v2"), f"{name}_launch")
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 19 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rc = fn(
        q_ids.data_ptr(), q_w.data_ptr(), doc_ids.data_ptr(), doc_w.data_ptr(),
        masks.data_ptr() if masks is not None else None, out_s.data_ptr(), out_i.data_ptr(),
        g_tab.data_ptr() if g_tab is not None else None,
        stats.data_ptr() if stats is not None else None,
        b, t, n, slots, k_eff, plan.part, plan.parts, plan.q_tiles, plan.qb, plan.docs,
        plan.table, int(plan.list_smem), int(plan.staged), int(vec), plan.smem, walk,
        block_n or 0, masks.shape[1] if masks is not None else 0, pack,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    cuda_build.check_launch(rc, name)
    LAUNCHES[name] += 1
    scores, ids = merge_topk(out_s, out_i, k_eff)
    return pad_to_k(scores, ids, k, k_eff)


def _empty_topk(b: int, k: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    empty = torch.empty((b, 0), dtype=torch.float32, device=device)
    return pad_to_k(empty, empty.to(torch.int32), k, 0)


def bm25_topk_v2(
    q_ids: torch.Tensor,
    q_weights: torch.Tensor,
    doc_ids: torch.Tensor,
    doc_weights: torch.Tensor,
    k: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused BM25 top-k (JAX ``bm25_topk_pallas_v2``), any k. CUDA tensors
    launch ``csrc/bm25_v2.cu``'s whole-corpus walk (the hash body of
    ``csrc/bm25_hash.cuh``); CPU tensors take :func:`bm25_topk_v2_plain`.
    Returns (scores [B, k], rows [B, k]) in ``(-score, row)`` order;
    zero-score documents fill rows with fewer positive hits, in row order."""
    if not doc_ids.is_cuda:
        return bm25_topk_v2_plain(q_ids, q_weights, doc_ids, doc_weights, k)
    return _hash_topk("bm25_topk_v2", q_ids, q_weights, doc_ids, doc_weights, k)


def bm25_topk_v2_skip(
    q_ids: torch.Tensor,
    q_weights: torch.Tensor,
    doc_ids: torch.Tensor,
    doc_weights: torch.Tensor,
    bitmaps: torch.Tensor,
    k: int,
    block_n: int = SKIP_BLOCK_N,
    positive_only: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`bm25_topk_v2` with term-driven tile skipping (JAX
    ``bm25_topk_pallas_v2_skip``). ``bitmaps`` [n_tiles, W] int32 must be
    built at the same ``block_n`` (else ``ValueError``; the corpus is never
    re-tiled). CUDA tensors launch the hash body of ``csrc/bm25_hash.cuh``
    (``csrc/bm25_v2.cu``'s skip walk): a query whose 8-query group's
    predicate (:func:`tile_group_masks`) is False on a doc tile probes
    nothing there, and a doc tile that no group of a query tile needs is
    neither read nor scored; with ``positive_only=False`` the latter only
    once every list of the query tile holds a k-th score > 0, so results
    equal v2's bitwise. With ``positive_only=True`` only scores > 0 are
    kept, rows with fewer hits padded with ``(0.0, INT_MAX)``. CPU tensors
    take :func:`bm25_topk_v2_skip_plain`."""
    if not doc_ids.is_cuda:
        return bm25_topk_v2_skip_plain(
            q_ids, q_weights, doc_ids, doc_weights, bitmaps, k, block_n, positive_only
        )
    _check_bitmaps(bitmaps, doc_ids.shape[0], block_n)
    bitmaps = bitmaps.to(doc_ids.device)
    return _hash_topk("bm25_topk_v2_skip", q_ids, q_weights, doc_ids, doc_weights, k,
                      group_masks=lambda qb: tile_group_masks(q_ids, bitmaps, qb), block_n=block_n,
                      positive_only=positive_only)


def bm25_topk_probe(
    q_ids: torch.Tensor,
    q_weights: torch.Tensor,
    doc_ids: torch.Tensor,
    doc_weights: torch.Tensor,
    cand: torch.Tensor,
    count: torch.Tensor,
    k: int,
    block_n: int = SKIP_BLOCK_N,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Probe-mode BM25 top-k over explicit candidate doc tiles (JAX
    ``bm25_topk_pallas_probe``): ``cand`` [ceil(B/8), cap] int32 lists the
    tiles of ``block_n`` rows that each query tile of 8 queries scores,
    ``count`` [ceil(B/8)] how many entries are live (entries past ``cap``,
    outside the corpus's tiles or repeated change nothing; any order).
    Exact only if every tile holding a positive score is listed.
    ``positive_only``: hits in ``(-score, row)`` order, rows padded with
    ``(0.0, INT_MAX)``. CUDA tensors launch ``csrc/bm25_v2.cu``'s
    ``bm25_topk_probe_launch``: the hash body's skip walk in
    ``positive_only`` mode over the lists' :func:`probe_group_masks`; CPU
    tensors take :func:`bm25_topk_probe_plain`."""
    if not doc_ids.is_cuda:
        return bm25_topk_probe_plain(q_ids, q_weights, doc_ids, doc_weights, cand, count, k, block_n)
    return _probe_topk("bm25_topk_probe", q_ids, q_weights, doc_ids, doc_weights, cand, count, k,
                       block_n)


def _probe_topk(name: str, q_ids, q_w, doc_ids, doc_w, cand, count, k: int, block_n: int,
                n_docs: int | None = None, pack: int = 1):
    """A probe on CUDA tensors: :func:`_hash_topk`'s skip walk in
    ``positive_only`` mode over skip tiles of ``block_n`` documents, its
    masks built on the device from (``cand``, ``count``) at the plan's
    query tile (:func:`probe_group_masks`), that tile up to
    ``HASH_QB_MAX`` (:func:`bm25_tile_plan`); the empty cases answer
    ``(0.0, INT_MAX)`` without a launch."""
    dev = doc_ids.device
    b = q_ids.shape[0]
    _check_candidates(cand, count, b)
    n = doc_ids.shape[0] if n_docs is None else n_docs
    k_eff = min(k, n)
    if k_eff == 0 or b == 0 or cand.shape[1] == 0:
        s, i = _empty_topk(b, k_eff, dev)
        return pad_to_k(*_positive_filler(s, i), k, k_eff)
    cand, count = torch.as_tensor(cand).to(dev), torch.as_tensor(count).to(dev)
    n_tiles = -(-n // block_n)
    return _hash_topk(name, q_ids, q_w, doc_ids, doc_w, k, HASH_QB_MAX,
                      group_masks=lambda qb: probe_group_masks(cand, count, b, qb, n_tiles),
                      block_n=block_n, positive_only=True, n_docs=n_docs, pack=pack)


def bm25_topk_packed(
    q_ids: torch.Tensor,
    q_weights: torch.Tensor,
    packed_ids: torch.Tensor,
    packed_weights: torch.Tensor,
    n_docs: int,
    k: int,
    pack: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """BM25 top-k over the lane-packed layout (JAX ``bm25_topk_pallas_packed``):
    ``packed_ids`` / ``packed_weights`` [R, 128] from :func:`pack_slots`
    hold ``n_docs`` documents, ``pack`` a row. Returns (scores [B, k], doc
    rows [B, k]) in ``(-score, row)`` order, zero-score documents included,
    as :func:`bm25_topk_v2` returns them on the flat layout: on the card
    bitwise the same. CUDA tensors launch the hash body of
    ``csrc/bm25_hash.cuh`` over the packed rows (``csrc/bm25_v2.cu``'s
    ``bm25_topk_packed_launch``; a power-of-two pack's rows are read as the
    flat array they are); CPU tensors take :func:`bm25_topk_packed_plain`."""
    if not packed_ids.is_cuda:
        return bm25_topk_packed_plain(q_ids, q_weights, packed_ids, packed_weights, n_docs, k, pack)
    _check_packed(packed_ids, packed_weights, n_docs, pack)
    return _hash_topk("bm25_topk_packed", q_ids, q_weights, packed_ids, packed_weights, k,
                      n_docs=n_docs, pack=pack)


def bm25_topk_probe_packed(
    q_ids: torch.Tensor,
    q_weights: torch.Tensor,
    packed_ids: torch.Tensor,
    packed_weights: torch.Tensor,
    n_docs: int,
    pack: int,
    cand: torch.Tensor,
    count: torch.Tensor,
    k: int,
    block_n: int = 1024,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Probe-mode BM25 over the lane-packed layout (JAX
    ``bm25_topk_pallas_probe_packed``): a candidate tile is ``block_n``
    packed rows, so ``block_n * pack`` documents, and the exact candidate
    source is ``build_term_tile_lists(doc_ids, block_n * pack)``. The
    contract of :func:`bm25_topk_probe`: positive hits in ``(-score, row)``
    order, rows padded with ``(0.0, INT_MAX)``. ``ValueError`` when
    ``min(k, n_docs) > block_n``, as in the JAX package. CUDA tensors launch
    ``csrc/bm25_v2.cu``'s ``bm25_topk_probe_packed_launch``, the probe's
    skip walk over the packed rows (a power-of-two pack's rows read as the
    flat array they are); CPU tensors take
    :func:`bm25_topk_probe_packed_plain`."""
    if not packed_ids.is_cuda:
        return bm25_topk_probe_packed_plain(q_ids, q_weights, packed_ids, packed_weights, n_docs,
                                            pack, cand, count, k, block_n)
    _check_packed(packed_ids, packed_weights, n_docs, pack)
    _check_probe_k(min(k, n_docs), block_n)
    return _probe_topk("bm25_topk_probe_packed", q_ids, q_weights, packed_ids, packed_weights, cand,
                       count, k, block_n * pack, n_docs, pack)


def bm25_topk_v1(
    q_ids: torch.Tensor,
    q_weights: torch.Tensor,
    doc_ids: torch.Tensor,
    doc_weights: torch.Tensor,
    k: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """BM25 top-k through the v1 kernel (JAX ``bm25_topk_pallas``, the
    ``pallas`` pin): the TPU kernel's function, not its blocks, so the
    kernel of :func:`bm25_topk_v2` (``csrc/bm25_hash.cuh``) under
    ``bm25_topk_v1_launch`` and its own launch count, the same results.
    CPU tensors take :func:`bm25_topk_v1_plain`."""
    if not doc_ids.is_cuda:
        return bm25_topk_v1_plain(q_ids, q_weights, doc_ids, doc_weights, k)
    return _hash_topk("bm25_topk_v1", q_ids, q_weights, doc_ids, doc_weights, k)


# ------------------------------------------------------------- tile WAND
def _merge_topk_host(s1, i1, s2, i2, k):
    """Exact ``(-score, id)`` merge of two disjoint per-query top-k lists."""
    scores = np.concatenate([np.asarray(s1), np.asarray(s2)], axis=1)
    ids = np.concatenate([np.asarray(i1), np.asarray(i2)], axis=1)
    order = np.lexsort((ids, -scores), axis=1)[:, :k]
    b_idx = np.arange(scores.shape[0])[:, None]
    return scores[b_idx, order], ids[b_idx, order]


def candidate_cap(m: int, n_tiles: int) -> int:
    return min(n_tiles, max(16, 1 << max(0, m - 1).bit_length()))


def _group_any(mask: np.ndarray, bq: int) -> np.ndarray:
    """[B, n] -> [ceil(B/bq), n]: any over each query tile's rows."""
    q_tiles = -(-mask.shape[0] // bq)
    return np.stack([mask[g * bq : (g + 1) * bq].any(axis=0) for g in range(q_tiles)])


def bm25_topk_wand(
    q_ids: torch.Tensor,
    q_weights: torch.Tensor,
    doc_ids: torch.Tensor,
    doc_weights: torch.Tensor,
    term_tiles_maxw: tuple[np.ndarray, np.ndarray, np.ndarray],
    k: int,
    block_n: int = SKIP_BLOCK_N,
    pass1_tiles: int | None = None,
    scan_fraction: float = 0.75,
    return_stats: bool = False,
    fallback: Callable[[], tuple[torch.Tensor, torch.Tensor]] | None = None,
    packed: tuple[torch.Tensor, torch.Tensor, int, int] | None = None,
):
    """Exact tile-WAND BM25 top-k (JAX ``bm25_topk_wand``): a two-pass
    upper-bound-pruned probe. ``term_tiles_maxw`` is
    :func:`build_term_tile_maxw` at ``block_n`` documents, or at ``block_n *
    pack`` with ``packed=(packed_ids, packed_weights, n_docs, pack)``: then
    ``doc_ids`` / ``doc_weights`` are unused, both passes run
    :func:`bm25_topk_probe_packed` over tiles of ``block_n`` packed rows and
    the default fallback is :func:`bm25_topk_packed`. Exits, cheapest first:

    1. ``fallback_early``: a provable lower bound on each query's k-th score
       (the k-th largest per-tile best single-term score) already leaves
       more than ``scan_fraction`` of the tiles to scan: ``fallback`` (default
       :func:`bm25_topk` ``auto``), no probe launched.
    2. ``single_pass``: the tiles whose bound reaches that lower bound are
       barely more than pass 1 would take: one probe over them.
    3. two passes: each query's own top tiles by bound, then the remaining
       tiles whose bound reaches the k-th pass-1 score; merged on the host.
       ``fallback_full`` instead when both would touch more than
       ``scan_fraction`` of the tiles.

    Positive hits in ``(-score, row)`` order, as the full scan's; filler
    has score <= 0. With ``return_stats`` also the exit and tile counts."""
    q_np = q_ids.cpu().numpy() if torch.is_tensor(q_ids) else np.asarray(q_ids)
    w_np = q_weights.cpu().numpy() if torch.is_tensor(q_weights) else np.asarray(q_weights)
    if packed is not None:
        packed_ids, packed_w, n_docs, pack = packed
        dev = packed_ids.device
    else:
        dev, n_docs, pack = doc_ids.device, doc_ids.shape[0], 1
    bsz = q_np.shape[0]
    indptr, tiles, maxw = term_tiles_maxw
    n_tiles = max(1, -(-n_docs // (block_n * pack)))
    k_eff = min(k, n_docs)
    bq = BLOCK_Q
    q_tiles = -(-bsz // bq)
    q_dev = torch.as_tensor(q_np).to(dev, torch.int32)
    w_dev = torch.as_tensor(w_np).to(dev, torch.float32)
    ub, sb = wand_upper_bounds(q_np, w_np, indptr, tiles, maxw, n_tiles)

    def done(s, i, stats):
        s, i = pad_to_k(s, i, k, k_eff)
        return (s, i, stats) if return_stats else (s, i)

    def fallback_out(stats):
        stats["fallback_full"] = True
        if fallback is not None:
            s, i = fallback()
        elif packed is not None:
            s, i = bm25_topk_packed(q_dev, w_dev, packed_ids, packed_w, n_docs, k_eff, pack)
        else:
            s, i = bm25_topk(q_dev, w_dev, doc_ids, doc_weights, k_eff)
        return done(s[:, :k_eff], i[:, :k_eff], stats)

    def probe(cand, count, cap):
        cand = torch.from_numpy(np.ascontiguousarray(cand[:, :cap])).to(dev)
        count = torch.from_numpy(count).to(dev)
        if packed is not None:
            return bm25_topk_probe_packed(q_dev, w_dev, packed_ids, packed_w, n_docs, pack,
                                          cand, count, k_eff, block_n)
        return bm25_topk_probe(q_dev, w_dev, doc_ids, doc_weights, cand, count, k_eff, block_n)

    stats = {"n_tiles": n_tiles, "pass1_tiles": 0, "pass2_tiles_max": 0, "fallback_full": False,
             "fallback_early": False, "single_pass": False}
    # a provable lower bound on each query's final k-th score; the (1 - 1e-5)
    # deflation covers the builder's bound inflation and f32 rounding
    if n_tiles > k_eff:
        theta_lb = -np.partition(-sb, k_eff - 1, axis=1)[:, k_eff - 1]
        theta_lb = np.maximum(theta_lb * (1.0 - 1e-5), 0.0).astype(np.float32)
    else:
        theta_lb = np.zeros(bsz, np.float32)
    est = _group_any((ub > 0.0) & (ub >= theta_lb[:, None]), bq)
    est_max = int(est.sum(axis=1).max()) if len(est) else 0
    if est_max > scan_fraction * n_tiles:
        stats.update(pass2_tiles_max=est_max, fallback_early=True)
        return fallback_out(stats)

    # pass 1: each query's own top tiles by bound, unioned per query tile
    b1 = max(1, min(max(8, k_eff) if pass1_tiles is None else pass1_tiles, n_tiles))
    sel = []
    for q in range(bsz):
        order = np.argsort(-ub[q], kind="stable")[:b1]
        sel.append(order[ub[q][order] > 0.0])
    groups = [
        np.unique(np.concatenate(sel[g * bq : (g + 1) * bq] or [np.empty(0, np.int64)]))
        for g in range(q_tiles)
    ]
    max1 = max((len(u) for u in groups), default=0)

    # one pass: the lower-bound set barely exceeds pass 1's union
    if pass1_tiles is None and est_max <= 2 * max1 + 64:
        cap_e = candidate_cap(est_max, n_tiles)
        cand_e = np.zeros((q_tiles, cap_e), np.int32)
        count_e = np.zeros(q_tiles, np.int32)
        for g in range(q_tiles):
            live = np.flatnonzero(est[g])[:cap_e]
            cand_e[g, : len(live)] = live
            count_e[g] = len(live)
        s1, i1 = probe(cand_e, count_e, cap_e)
        stats.update(pass1_tiles=est_max, single_pass=True)
        return done(s1, i1, stats)

    cap1 = candidate_cap(max1, n_tiles)
    cand1 = np.zeros((q_tiles, cap1), np.int32)
    count1 = np.zeros(q_tiles, np.int32)
    for g, u in enumerate(groups):
        cand1[g, : len(u)] = u
        count1[g] = len(u)
    s1, i1 = probe(cand1, count1, cap1)
    # per-query threshold: the k-th positive pass-1 score, raised by the
    # lower bound (both are lower bounds on the true k-th score)
    theta = s1[:, k_eff - 1].cpu().numpy().copy()
    theta[~(theta > 0.0)] = 0.0
    theta = np.maximum(theta, theta_lb)
    in_pass1 = np.zeros((q_tiles, n_tiles), bool)
    for g in range(q_tiles):
        in_pass1[g, cand1[g, : count1[g]]] = True
    need = _group_any((ub > 0.0) & (ub >= theta[:, None]), bq) & ~in_pass1
    count2 = need.sum(axis=1).astype(np.int32)
    max2 = int(count2.max()) if len(count2) else 0
    p1_max = int(count1.max()) if len(count1) else 0
    stats.update(pass1_tiles=p1_max, pass2_tiles_max=max2)
    if max2 + p1_max > scan_fraction * n_tiles:
        return fallback_out(stats)
    if max2 == 0:
        return done(s1, i1, stats)
    cap2 = candidate_cap(max2, n_tiles)
    cand2 = np.zeros((q_tiles, cap2), np.int32)
    for g in range(q_tiles):
        live = np.flatnonzero(need[g])[:cap2]
        cand2[g, : len(live)] = live
    s2, i2 = probe(cand2, count2, cap2)
    sm, im = _merge_topk_host(s1.cpu().numpy(), i1.cpu().numpy(), s2.cpu().numpy(),
                              i2.cpu().numpy(), k_eff)
    return done(torch.from_numpy(sm).to(dev), torch.from_numpy(im).to(dev), stats)


# -------------------------------------------------------------- dispatch
def packed_block_rows(probe_block_n: int, pack: int) -> int:
    """Packed rows per candidate tile of a packed index's pruned legs (JAX
    ``_search_packed_auto``'s ``bn_rows``): ``probe_block_n`` documents in
    whole packed rows, rounded down to a multiple of 8 rows, at least 8."""
    return max(8, (probe_block_n // pack) // 8 * 8)


def bm25_route(method: str, n: int, k: int, device_type: str, tile_skip: bool, layout: str = "flat",
               pack: int = 1, probe_block_n: int = SKIP_BLOCK_N) -> str:
    """The route of a ``SparseIndex`` search as a pure function of its
    device layout (``"flat"``, ``"packed"`` or ``"bucketed"``): ``"scan"``,
    ``"fused"`` (the v2 kernel), ``"v1"`` (the v1 kernel), ``"pruned"`` (the
    probe / WAND / Bloom-skip legs of ``SparseIndex._search_pruned``),
    ``"packed"`` (the packed kernel over the whole corpus),
    ``"pruned_packed"`` (``_search_packed_auto``'s probe / WAND legs over
    the packed layout) or ``"bucketed_<leg>"`` (the packed kernel on each
    packed bucket, ``<leg>`` - scan, fused or v1 - on each flat one).

    The pruned legs exist on a flat layout only: elsewhere the pruned pins
    ``pallas_v2_skip``, ``pallas_probe`` and ``pallas_wand`` fall back to
    ``auto``, as in the JAX package's ``search``.

    Flat layout, ``auto``: on the card the pruned legs with ``tile_skip``
    while ``min(k, n) <= PRUNED_K_MAX`` (the JAX package's ``pruned_ok``),
    else the v2 kernel; off the card the scan (what the JAX package does off
    the TPU). ``xla`` pins the scan, ``pallas_v2`` the v2 kernel, ``pallas``
    the v1 kernel; the pruned pins take their leg on any device (plain
    versions on the CPU) while k allows, else fall back as ``auto`` without
    ``tile_skip``.

    Packed layout (``pack`` documents a row, JAX ``_search_packed_auto``):
    ``auto`` takes the pruned packed legs on the card with ``tile_skip``
    while ``min(k, n)`` fits a candidate tile of :func:`packed_block_rows`
    rows, else the packed kernel (its plain version off the card); ``xla``,
    ``pallas_v2`` and ``pallas`` take their flat route on a flat upload of
    the same slot arrays.

    Bucketed layout (JAX ``_search_bucketed``): a flat bucket takes the
    whole-corpus route of ``method`` (``auto``: the v2 kernel on the card,
    the scan off it)."""
    if layout not in ("flat", "packed", "bucketed"):
        raise ValueError(f"unknown SparseIndex layout: {layout}")
    if method in PRUNED_PINS and layout != "flat":
        method = "auto"
    if layout == "bucketed":
        return "bucketed_" + bm25_route(method, n, k, device_type, False)
    if layout == "packed" and method == "auto":
        fits = min(k, n) <= packed_block_rows(probe_block_n, pack)
        return "pruned_packed" if (tile_skip and fits and device_type == "cuda") else "packed"
    pruned_ok = min(k, n) <= PRUNED_K_MAX
    plain = "fused" if device_type == "cuda" else "scan"
    if method == "auto":
        return "pruned" if (tile_skip and pruned_ok and device_type == "cuda") else plain
    if method == "xla":
        return "scan"
    if method == "pallas_v2":
        return "fused"
    if method == "pallas":
        return "v1"
    if method in PRUNED_PINS:
        return "pruned" if pruned_ok else plain
    raise ValueError(f"unknown bm25_topk method: {method}")


def pruned_leg(method: str, maxc: int, p_tiles: int) -> str:
    """``"probe"`` or ``"wand"``: the leg a pruned search takes once the
    batch's candidate-tile unions are known (``maxc`` the largest of the
    query tiles', ``p_tiles`` the corpus's tiles). ``auto`` probes a
    selective batch (``maxc <= p_tiles // 2``), ``pallas_probe`` always,
    ``pallas_wand`` never (JAX ``_search_pruned`` and ``_search_packed_auto``)."""
    if method == "pallas_probe" or (method == "auto" and maxc <= p_tiles // 2):
        return "probe"
    return "wand"


def bm25_topk(
    q_ids: torch.Tensor,
    q_weights: torch.Tensor,
    doc_ids: torch.Tensor,
    doc_weights: torch.Tensor,
    k: int,
    method: str = "auto",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact BM25 top-k over the whole flat corpus (JAX ``bm25_topk``):
    ``auto`` takes the v2 kernel on the card and the scan off it;
    ``pallas_v2``, ``pallas`` (v1) and ``xla`` pin the v2 kernel, the v1
    kernel and the scan (plain versions on CPU tensors). Zero scores are
    candidates; the search layer drops them."""
    route = bm25_route(method, doc_ids.shape[0], k, doc_ids.device.type, False)
    if route == "scan":
        return bm25_topk_scan(q_ids, q_weights, doc_ids, doc_weights, k)
    if route == "fused":
        return bm25_topk_v2(q_ids, q_weights, doc_ids, doc_weights, k)
    if route == "v1":
        return bm25_topk_v1(q_ids, q_weights, doc_ids, doc_weights, k)
    raise ValueError(f"bm25_topk has no pruned route; method {method!r} is a SparseIndex pin")
