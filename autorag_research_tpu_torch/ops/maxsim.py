"""Multi-vector MaxSim (late interaction) scoring on an NVIDIA GPU.

Counterpart of ``autorag_research_tpu/ops/maxsim.py``: ColBERT/ColPali-style
``score(q, D) = sum_t max_s q_t . d_s`` over documents padded to
``[N, Td, d]`` with token counts ``[N]`` and queries padded to ``[B, Tq, d]``
with counts ``[B]``. Scores are raw MaxSim sums; callers divide by the
query's token count.

- :func:`maxsim_topk_scan` (JAX ``maxsim_topk_xla``): a loop over document
  tiles with a running ``(-score, row)`` merge, bounded memory.
- :func:`maxsim_topk_v2` (JAX ``maxsim_topk_pallas_v2``): the fused kernel
  ``csrc/maxsim_v2.cu`` on the tile body ``csrc/maxsim_tile.cuh``, streaming
  top-k, launched by the pure plan :func:`maxsim_plan`; CPU tensors take
  :func:`maxsim_topk_v2_plain`.
- :func:`maxsim_topk_v1` (JAX ``maxsim_topk_pallas``, the ``pallas`` pin):
  ``csrc/maxsim_v1.cu``, the same tile body under its ``bias`` policy (an
  additive [N, Td] document-token bias in place of lengths); CPU tensors
  take :func:`maxsim_topk_v1_plain`.
- :func:`maxsim_topk_v3` (JAX ``maxsim_topk_pallas_v3``, the ``pallas_v3``
  pin): ``csrc/maxsim_v3.cu``, the tile body under its ``lane`` policy (the
  mask folded into the product through a bias lane); CPU tensors take
  :func:`maxsim_topk_v3_plain`.
- :func:`maxsim_scores_v2` (JAX ``maxsim_scores_pallas_v2``): the same
  kernel's raw-scores epilogue, ``[B, N]``; CPU tensors take
  :func:`maxsim_scores_v2_plain`. :func:`maxsim_topk_via_scores` selects
  from it with ``sort_topk``.
- :func:`maxsim_rerank`: exact MaxSim over per-query candidate rows (a
  gather plus a batched product, outside any kernel in both packages).
- :func:`maxsim_topk_verified`: bf16 prescreen, exact f32 rescore of the
  candidates and a per-query proof that they hold the true top-k.
- :func:`maxsim_topk_int8` (the int8 serving mode): per-token int8 documents,
  s8 x s8 -> s32 products from ``torch._int_mm`` (JAX: ``dot_general`` with
  ``preferred_element_type=int32``, outside any Pallas kernel).

The kernels take any k (lists beyond shared memory live in the output) and
any d (zero-padded to a multiple of 8, which leaves every product exact).

Empty documents (length 0) score ``NEG_INF`` and keep their row, on every
route: the convention of ``maxsim_topk_xla``. (The JAX v1 and v2 Pallas
kernels let an empty document's sum overflow to ``-inf``; their top-k then
never lists it. The JAX v3 kernel scores it Tq_pad x -1e30, above the search
layer's floor, so its pin lists it as a hit where the port's does not.)
Rows past the corpus never surface; k beyond the corpus pads with
``(NEG_INF, INT_MAX)``.

Exact paths are true f32 (TF32 off, checked); bf16 operands are upcast to
f32 in the plain versions, so their products are exact and summed in f32,
as ``preferred_element_type=f32`` gives.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass, field

import numpy as np
import torch

from autorag_research_tpu_torch.ops import cuda_build
from autorag_research_tpu_torch.utils.concurrency import count_call
from autorag_research_tpu_torch.ops.dense import (
    SMEM_BLOCK_MAX,
    _require_exact_f32,
    _round_up,
    int8_matmul,
    pad_width,
    quantize_int8,
)
from autorag_research_tpu_torch.ops.topk import (
    INT_MAX,
    NEG_INF,
    merge_topk,
    pad_to_k,
    sort_topk,
    topk_ordered,
)

# Kernel launches per wrapper: each wrapper adds one where it launches its
# kernel and nowhere else.
LAUNCHES = {"maxsim_topk_v2": 0, "maxsim_scores_v2": 0, "maxsim_topk_v1": 0, "maxsim_topk_v3": 0}
# Calls of the plain versions and the scan, whatever the device: a run on the
# card shows with these that its tensors never took a plain route.
PLAIN_CALLS = {
    "maxsim_topk_scan": 0,
    "maxsim_topk_v2_plain": 0,
    "maxsim_scores_v2_plain": 0,
    "maxsim_topk_v1_plain": 0,
    "maxsim_topk_v3_plain": 0,
}

# [B, Tq, tile_n, Td] f32 product budget of one scan step (JAX: the same)
MAXSIM_TILE_BUDGET = 512 << 20
# [Bc, N] f32 score block of one scores-kernel call: queries run in chunks
# that fit it
SCORES_BUDGET = 256 << 20
# the fused kernel serves round_up(min(k, n), 8) <= FUSED_K_MAX on "auto"
FUSED_K_MAX = 16
# v3's bias-lane value for pad document tokens (JAX ``_MASK_BIAS``): finite
# in bf16, and Tq_pad times it stays finite in f32
MASK_BIAS = -1.0e30
# gathered [Bc, C, Td, d] f32 candidate tokens of one rerank chunk
_RERANK_BUDGET = 1 << 30


def reset_launch_counts() -> None:
    for counts in (LAUNCHES, PLAIN_CALLS):
        for name in counts:
            counts[name] = 0


def _auto_tile_n(b: int, tq: int, td: int, n: int) -> int:
    per_doc = b * tq * td * 4
    tile = max(8, (MAXSIM_TILE_BUDGET // max(per_doc, 1)) // 8 * 8)
    return min(tile, 4096, _round_up(n, 8))


# ------------------------------------------------------------- plain paths
def _tile_scores(qf, q_mask, tile, tile_lens):
    """Raw MaxSim of f32 queries [B, Tq, d] against a document tile
    [n, Td, d] -> [B, n] f32; empty documents NEG_INF."""
    b, tq, d = qf.shape
    n, td, _ = tile.shape
    s = torch.matmul(qf.reshape(b * tq, d), tile.float().reshape(n * td, d).T)
    s = s.view(b, tq, n, td)
    tok = torch.arange(td, device=qf.device)
    s = s.masked_fill(~(tok[None, :] < tile_lens[:, None])[None, None], NEG_INF)
    per_token = torch.amax(s, dim=3).masked_fill(~q_mask[:, :, None], 0.0)
    scores = per_token.sum(dim=1)
    return scores.masked_fill(~(tile_lens > 0)[None, :], NEG_INF)


def _query_mask(query_lens, b: int, tq: int, device) -> torch.Tensor:
    lens = torch.as_tensor(query_lens, device=device).reshape(b)
    return torch.arange(tq, device=device)[None, :] < lens[:, None]


def _select_tiles(b: int, n: int, k: int, tile_n: int, device, tile_scores):
    """``(-score, row)`` top-k over document tiles of ``tile_n`` rows with a
    running merge; ``tile_scores(lo, hi)`` gives the [B, hi - lo] scores of
    rows [lo, hi). Returns (scores f32 [B, k], rows int32 [B, k])."""
    k_eff = min(k, n)
    scores = torch.full((b, k_eff), NEG_INF, dtype=torch.float32, device=device)
    ids = torch.full((b, k_eff), INT_MAX, dtype=torch.int32, device=device)
    if n == 0 or b == 0:
        return pad_to_k(scores, ids, k, k_eff)
    for base in range(0, n, tile_n):
        tile_s = tile_scores(base, min(n, base + tile_n))
        top_s, top_i = topk_ordered(tile_s, min(k_eff, tile_s.shape[1]))
        scores, ids = sort_topk(
            torch.cat([scores, top_s], dim=1), torch.cat([ids, top_i + base], dim=1), k_eff
        )
    return pad_to_k(scores, ids, k, k_eff)


def _tile_rows(b: int, tq: int, td: int, n: int, tile_n: int | None) -> int:
    return min(tile_n or _auto_tile_n(b, tq, td, n), _round_up(max(n, 1), 8))


def _scan(queries, query_lens, docs, doc_lens, k: int, tile_n: int | None):
    b, tq, _ = queries.shape
    n, td, _ = docs.shape
    dev = queries.device
    qf = queries.float()
    q_mask = _query_mask(query_lens, b, tq, dev)
    lens = torch.as_tensor(doc_lens, device=dev).reshape(n)
    return _select_tiles(
        b, n, k, _tile_rows(b, tq, td, n, tile_n), dev,
        lambda lo, hi: _tile_scores(qf, q_mask, docs[lo:hi], lens[lo:hi]),
    )


def maxsim_topk_scan(
    queries: torch.Tensor,
    query_lens: torch.Tensor,
    docs: torch.Tensor,
    doc_lens: torch.Tensor,
    k: int,
    tile_n: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact MaxSim top-k as a loop over document tiles of ``tile_n`` rows
    (JAX ``maxsim_topk_xla``): each step materializes one [B, Tq, tile_n,
    Td] f32 product (``MAXSIM_TILE_BUDGET`` by default). Returns (scores f32
    [B, k], rows int32 [B, k]) in ``(-score, row)`` order."""
    _require_exact_f32()
    count_call(PLAIN_CALLS, "maxsim_topk_scan")
    return _scan(queries, query_lens, docs, doc_lens, k, tile_n)


def maxsim_topk_v2_plain(queries, query_lens, docs, doc_lens, k: int):
    """Plain PyTorch version of :func:`maxsim_topk_v2`: the same
    ``(-score, row)`` top-k by a tiled scan with bounded product tiles."""
    _require_exact_f32()
    count_call(PLAIN_CALLS, "maxsim_topk_v2_plain")
    return _scan(queries, query_lens, docs, doc_lens, k, None)


def maxsim_scores_v2_plain(queries, query_lens, docs, doc_lens) -> torch.Tensor:
    """Plain PyTorch version of :func:`maxsim_scores_v2`: raw [B, N] f32
    MaxSim scores, document tile by document tile."""
    _require_exact_f32()
    count_call(PLAIN_CALLS, "maxsim_scores_v2_plain")
    b, tq, _ = queries.shape
    n, td, _ = docs.shape
    dev = queries.device
    if n == 0 or b == 0:
        return torch.empty((b, n), dtype=torch.float32, device=dev)
    tile_n = _auto_tile_n(b, tq, td, n)
    qf = queries.float()
    q_mask = _query_mask(query_lens, b, tq, dev)
    lens = torch.as_tensor(doc_lens, device=dev).reshape(n)
    return torch.cat(
        [
            _tile_scores(qf, q_mask, docs[base : base + tile_n], lens[base : base + tile_n])
            for base in range(0, n, tile_n)
        ],
        dim=1,
    )


def _masked_queries(queries, query_lens):
    """Queries with every token row past its query's length zeroed."""
    b, tq, _ = queries.shape
    mask = _query_mask(query_lens, b, tq, queries.device)
    return queries * mask[:, :, None].to(queries.dtype)


def v1_bias(doc_lens, n: int, td: int, device) -> torch.Tensor:
    """The v1 kernel's additive document-token bias [N, Td] f32: 0 for real
    tokens, NEG_INF for pads (JAX ``maxsim_topk_pallas``'s ``dbias``)."""
    lens = torch.as_tensor(doc_lens, device=device).reshape(n)
    tok = torch.arange(td, device=device)
    return torch.where(tok[None, :] < lens[:, None], 0.0, NEG_INF).to(torch.float32)


def maxsim_topk_v1_plain(queries, query_lens, docs, doc_lens, k: int):
    """Plain PyTorch version of :func:`maxsim_topk_v1`, the same function:
    zero pad query rows, the bias added to every product before the max over
    all Td tokens, the rows summed; a sum that overflows to -inf (an empty
    document) becomes NEG_INF. Returns (scores [B, k], rows [B, k]) in
    ``(-score, row)`` order."""
    _require_exact_f32()
    count_call(PLAIN_CALLS, "maxsim_topk_v1_plain")
    b, tq, d = queries.shape
    n, td, _ = docs.shape
    dev = queries.device
    qf = _masked_queries(queries, query_lens).float().reshape(b * tq, d)
    bias = v1_bias(doc_lens, n, td, dev)

    def tile_scores(lo, hi):
        tile = docs[lo:hi].float().reshape((hi - lo) * td, d)
        s = torch.matmul(qf, tile.T).view(b, tq, hi - lo, td) + bias[lo:hi][None, None]
        return torch.clamp(torch.amax(s, dim=3).sum(dim=1), min=NEG_INF)

    return _select_tiles(b, n, k, _tile_rows(b, tq, td, n, None), dev, tile_scores)


def maxsim_v3_operands(queries, query_lens, docs, doc_lens):
    """The v3 kernel's augmented operands (JAX ``maxsim_topk_pallas_v3``'s
    bias lane): d grows to ``dp = round_up(d + 1, 8)`` and lane d holds 1 on
    every query row, pad rows and rows up to ``tq_pad = round_up(Tq, 8)``
    included, and 0 (real token) or ``MASK_BIAS`` (pad) on document tokens.
    Returns (queries [B, tq_pad, dp], docs [N, Td, dp]) in the inputs'
    dtype, query rows past their lengths zero elsewhere."""
    b, tq, d = queries.shape
    n, td, _ = docs.shape
    dp = _round_up(d + 1, 8)
    tq_pad = _round_up(max(tq, 1), 8)
    q = torch.nn.functional.pad(_masked_queries(queries, query_lens), (0, dp - d, 0, tq_pad - tq))
    q[:, :, d] = 1
    lens = torch.as_tensor(doc_lens, device=docs.device).reshape(n)
    valid = torch.arange(td, device=docs.device)[None, :] < lens[:, None]
    dd = torch.nn.functional.pad(docs, (0, dp - d))
    dd[:, :, d] = torch.where(valid, 0.0, MASK_BIAS).to(docs.dtype)
    return q.contiguous(), dd.contiguous()


def _reset_empty(scores, ids, doc_lens, n: int):
    """v3 scores an empty document Tq_pad x MASK_BIAS, below every real score
    and above the pads: set it to NEG_INF with its row, the other routes'
    convention, which keeps the order."""
    lens = torch.as_tensor(doc_lens, device=ids.device).reshape(n)
    real = ids < n
    empty = real & (lens[torch.where(real, ids, 0).long()] == 0)
    return scores.masked_fill(empty, NEG_INF), ids


def maxsim_topk_v3_plain(queries, query_lens, docs, doc_lens, k: int):
    """Plain PyTorch version of :func:`maxsim_topk_v3`, the same function:
    the augmented operands of :func:`maxsim_v3_operands` multiplied, the max
    over all Td tokens and the sum over the tq_pad rows taken with no other
    mask, empty documents at NEG_INF with their row.
    The kernel scores every empty document of a query alike (rows x -1e30,
    below every real score) and resets it after selection, so its empty
    documents follow the real ones in row order; here they are set to
    NEG_INF before selection, which gives that order too (a CPU sum of
    tq_pad equal values may round differently from column to column)."""
    _require_exact_f32()
    count_call(PLAIN_CALLS, "maxsim_topk_v3_plain")
    b = queries.shape[0]
    n, td, _ = docs.shape
    qa, da = maxsim_v3_operands(queries, query_lens, docs, doc_lens)
    tq_pad, dp = qa.shape[1], qa.shape[2]
    qf = qa.float().reshape(b * tq_pad, dp)
    lens = torch.as_tensor(doc_lens, device=queries.device).reshape(n)

    def tile_scores(lo, hi):
        tile = da[lo:hi].float().reshape((hi - lo) * td, dp)
        s = torch.matmul(qf, tile.T).view(b, tq_pad, hi - lo, td)
        scores = torch.amax(s, dim=3).sum(dim=1)
        return scores.masked_fill(~(lens[lo:hi] > 0)[None, :], NEG_INF)

    return _select_tiles(b, n, k, _tile_rows(b, tq_pad, td, n, None), queries.device, tile_scores)


# ----------------------------------------------------------------- kernels
def _kernel_operands(queries, docs):
    """Check the kernels' operands and zero-pad d to a multiple of 8 (a copy
    only when d % 8 != 0; ``MultiVectorIndex`` pads once at upload)."""
    for x, name in ((queries, "queries"), (docs, "docs")):
        if not x.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor")
        if x.dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"{name} dtype {x.dtype} not in (float32, bfloat16)")
        if x.ndim != 3 or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 3-D tensor")
        if x.data_ptr() % 16:
            raise ValueError(f"{name}: the kernel needs 16-byte alignment")
    if queries.dtype != docs.dtype:
        raise ValueError("queries and docs must share a dtype")
    if queries.device != docs.device or queries.shape[2] != docs.shape[2]:
        raise ValueError("queries and docs must share a device and a width")
    d8 = _round_up(max(queries.shape[2], 1), 8)
    return pad_width(queries, d8), pad_width(docs, d8)


# --------------------------------------------- the tile body and its plan
# csrc/maxsim_tile.cuh: row tiles of 128 query-token rows in f32 and 256 in
# bf16 (a staged token then meets 256 rows, so staging no longer bounds the
# tensor cores), document chunks of 16 tokens, 128-token product tiles,
# groups of 32 documents, at most 32 queries a row tile, staged token k-boxes
# of 128 tokens x 128 bytes
MAXSIM_ROWS = {torch.float32: 128, torch.bfloat16: 256}
MAXSIM_CHUNK, MAXSIM_TILE_TOK = 16, 128
MAXSIM_GROUP, MAXSIM_QMAX = 32, 32
MAXSIM_BOX = 128 * 128
MAXSIM_STAGES = (3, 6)  # the fewest and the most ring slots
# a fused part holds at least MAXSIM_PART_K * k documents, so parts never
# grow with k; a row block takes at most MAXSIM_WAVE_PARTS times its share
# of one wave's slots
MAXSIM_PART_K, MAXSIM_WAVE_PARTS = 4, 4
# the tile body's mask policies (its Mask) and the source whose launchers
# instantiate each: "lens" reads document lengths (#9, #10), "bias" adds an
# [N, Td] bias before the max (#11), "lane" finds the mask in lane d of its
# operands (#12); "bias" and "lane" walk all Td tokens of every document
MAXSIM_MASKS = {"lens": "maxsim_v2", "bias": "maxsim_v1", "lane": "maxsim_v3"}
# each launching wrapper's policy
_WRAPPER_MASK = {
    "maxsim_topk_v2": "lens", "maxsim_scores_v2": "lens",
    "maxsim_topk_v1": "bias", "maxsim_topk_v3": "lane",
}


def maxsim_layout_bytes(rows: int, k_boxes: int, stages: int, resident: bool, smem_lists: bool,
                        k: int) -> int:
    """Shared-memory bytes of ``csrc/maxsim_tile.cuh``'s layout (its
    ``layout_bytes``) for row tiles of ``rows``: 1,024 bytes of alignment
    slack, the resident query k-boxes (``rows`` x 128 bytes each), the ring
    (a token k-box a slot, and a query k-box beside it when the queries are
    streamed), the [32, rows + 1] f32 row-maxima table, the ring's and the
    query tile's barriers, and [32, k] lists when they live in shared
    memory."""
    qbox = rows * 128
    q = k_boxes * qbox if resident else 0
    slot = MAXSIM_BOX if resident else MAXSIM_BOX + qbox
    lists = MAXSIM_QMAX * k * 8 if smem_lists else 0
    return 1024 + q + stages * slot + MAXSIM_GROUP * (rows + 1) * 4 + 16 * (stages + 1) + lists


def maxsim_layout(d: int, k: int, dtype: torch.dtype) -> tuple[int, int, bool, str | None, int]:
    """(k_boxes, stages, resident, lists, smem_bytes) for width ``d`` and
    lists of ``k`` (0: the scores epilogue, no lists): the query rows stay
    resident while they fit beside the shortest ring, else each slot
    streams them; the lists live in shared memory while they fit too, else
    in the output; then the ring takes as many slots as fit, up to 6."""
    rows = MAXSIM_ROWS[dtype]
    k_boxes = -(-d * (2 if dtype == torch.bfloat16 else 4) // 128)
    lo, hi = MAXSIM_STAGES
    resident = maxsim_layout_bytes(rows, k_boxes, lo, True, False, 0) <= SMEM_BLOCK_MAX
    lists = None
    if k > 0:
        fits = maxsim_layout_bytes(rows, k_boxes, lo, resident, True, k) <= SMEM_BLOCK_MAX
        lists = "shared" if fits else "global"
    shared = lists == "shared"
    stages = max(s for s in range(lo, hi + 1)
                 if maxsim_layout_bytes(rows, k_boxes, s, resident, shared, k) <= SMEM_BLOCK_MAX)
    return k_boxes, stages, resident, lists, maxsim_layout_bytes(rows, k_boxes, stages, resident,
                                                                  shared, k)


@dataclass(frozen=True)
class MaxSimPlan:
    """The launch plan of one launch of the tile body ``csrc/maxsim_tile.cuh``."""

    rows: int  # query-token rows of a row tile
    k_boxes: int  # staged k-boxes of a row (128 bytes each)
    stages: int  # slots of the staging ring
    resident: bool  # query rows resident (else streamed beside each slot)
    lists: str | None  # "shared", "global" (the output) or None (scores)
    smem_bytes: int
    blocks: int  # row blocks: whole queries, in order
    q_rows: int  # packed query rows, ``rows`` a row tile: the rows the kernel computes
    parts: int
    part_docs: int  # documents of a part, a multiple of 32
    items: int  # (row block, part) pairs
    grid: int  # blocks launched, each walking items in a grid-stride loop
    slots: int  # resident block slots of the card
    waves: int
    rows_valid: int
    # tokens walked per row tile: with doc_lens ("lens"), always ("bias",
    # "lane": every document's Td tokens)
    tokens_walked: int | None = None
    tokens_valid: int | None = None  # with doc_lens
    mask: str = "lens"
    # int32 [blocks, 4] (first query, queries, row tiles, first packed row)
    # then [B, 2] (packed row, rows): the kernel's table
    table: np.ndarray = field(default=None, compare=False, repr=False)

    def note(self) -> str:
        """One line for logs: the plan and its work ratios."""
        walk = ""
        if self.tokens_walked is not None and self.tokens_valid is not None:
            walk = f", tokens walked / valid {self.tokens_walked / max(self.tokens_valid, 1):.4f}"
        elif self.tokens_walked is not None:
            walk = f", tokens walked {self.tokens_walked}"
        policy = "" if self.mask == "lens" else f"{self.mask} policy: "
        return (f"{policy}{self.blocks} row blocks ({self.q_rows} rows, tiles of {self.rows}) x "
                f"{self.parts} parts of "
                f"{self.part_docs} docs = {self.items} items on a grid of {self.grid} "
                f"({self.slots} slots, {self.waves} waves); ring {self.stages} x "
                f"{self.k_boxes} k-boxes, queries {'resident' if self.resident else 'streamed'}"
                f", lists {self.lists}, {self.smem_bytes} B shared; rows computed / valid "
                f"{self.q_rows / max(self.rows_valid, 1):.4f}{walk}")


def _row_blocks(q_lens: np.ndarray, tile: int) -> list[tuple[int, int, int]]:
    """Whole queries packed in order into row tiles of ``tile`` rows: (first
    query, queries, row tiles) per block. A tile closes when the next query
    would overflow it or it holds 32 queries; a longer query takes
    ceil(len / tile) tiles of a block of its own."""
    blocks = []
    first, count, rows = 0, 0, 0
    for b, length in enumerate(q_lens.tolist()):
        if length > tile:
            if count:
                blocks.append((first, count, 1))
            blocks.append((b, 1, -(-length // tile)))
            first, count, rows = b + 1, 0, 0
            continue
        if count and (rows + length > tile or count == MAXSIM_QMAX):
            blocks.append((first, count, 1))
            first, count, rows = b, 0, 0
        count += 1
        rows += length
    if count:
        blocks.append((first, count, 1))
    return blocks


def _parts(n: int, blocks: int, k: int, slots: int) -> tuple[int, int]:
    """(parts, part_docs): the split of the N documents whose items fill
    the card's waves best (ties to fewer parts), a part a multiple of 32
    documents, at most MAXSIM_WAVE_PARTS x one wave's share a row block and,
    with lists, at least MAXSIM_PART_K x k documents a part."""
    p_max = min(-(-n // MAXSIM_GROUP), MAXSIM_WAVE_PARTS * max(1, slots // blocks))
    if k > 0:
        p_max = min(p_max, n // (MAXSIM_PART_K * k))
    best = None
    for p in range(1, max(1, p_max) + 1):
        part_docs = _round_up(-(-n // p), MAXSIM_GROUP)
        parts = -(-n // part_docs)
        items = blocks * parts
        fill = items / (-(-items // slots) * slots)
        if best is None or fill > best[0]:
            best = (fill, parts, part_docs)
    return best[1], best[2]


def _tokens_walked(lens: np.ndarray) -> int:
    """Tokens the tile body walks over documents walked to ``lens`` [N]:
    chunks of 16, product tiles of 8 chunks per group of 32 documents."""
    chunks = np.bincount(np.arange(lens.size) // MAXSIM_GROUP, weights=-(-lens // MAXSIM_CHUNK))
    tiles = -(-chunks.astype(np.int64) // (MAXSIM_TILE_TOK // MAXSIM_CHUNK))
    return int(tiles.sum() * MAXSIM_TILE_TOK)


def maxsim_plan(q_lens, n: int, td: int, d: int, k: int, dtype: torch.dtype, sms: int,
                blocks_per_sm: int, doc_lens=None, mask: str = "lens") -> MaxSimPlan:
    """Pure launch plan of the MaxSim tile body for queries of lengths
    ``q_lens`` [B] (host integers, at most their padded length) against N =
    ``n`` documents of ``td`` padded tokens of width ``d`` (a multiple of
    8: the operand width the kernel sees, d' for "lane"), lists of ``k`` (0
    for the scores epilogue; clamped to n), on a card of ``sms`` SMs that
    holds ``blocks_per_sm`` of the policy's blocks each, under the mask
    policy ``mask`` (:data:`MAXSIM_MASKS`; "bias" and "lane" are fused only).

    Row blocks pack whole queries by their own lengths into row tiles of
    ``MAXSIM_ROWS[dtype]`` (:func:`_row_blocks`), so the kernel computes no
    pad row beyond each tile's tail; under "bias" and "lane" a query of
    length 0 keeps one row (its sums then tell an empty document from a full
    one, as the TPU kernels' pad rows do; every other pad row adds exactly 0
    there). Items (row block, part) fill whole waves of the card's resident
    slots (:func:`_parts`). The tokens the walk covers are reported for
    "bias" and "lane" (every document's Td tokens, N x round_up(Td, 16) up to
    the last group's tile) and, with ``doc_lens`` [N], for "lens"; with
    ``doc_lens`` the valid tokens too. The launch needs neither."""
    q_lens = np.asarray(q_lens, dtype=np.int64).reshape(-1)
    b = q_lens.size
    if (min(b, n, td, d, sms, blocks_per_sm) < 1 or d % 8 or k < 0 or (q_lens < 0).any()
            or n * td >= 2**31 or mask not in MAXSIM_MASKS or (mask != "lens" and k < 1)):
        raise ValueError(f"no maxsim plan for B={b} n={n} td={td} d={d} k={k} sms={sms} "
                         f"blocks_per_sm={blocks_per_sm} mask={mask!r}")
    k = min(k, n)
    rows = MAXSIM_ROWS[dtype]
    k_boxes, stages, resident, lists, smem = maxsim_layout(d, k, dtype)
    own_rows = q_lens if mask == "lens" else np.maximum(q_lens, 1)
    blocks = np.asarray(_row_blocks(own_rows, rows), dtype=np.int64).reshape(-1, 3)
    tiles = blocks[:, 2]
    row0 = np.concatenate([[0], np.cumsum(tiles)[:-1]]) * rows
    q_start = np.concatenate([[0], np.cumsum(own_rows)[:-1]])
    # a query's packed row: its block's first row plus the rows before it there
    of_block = np.repeat(np.arange(len(blocks)), blocks[:, 1])
    q_row = row0[of_block] + q_start - q_start[blocks[of_block, 0]]
    table = np.concatenate([
        np.stack([blocks[:, 0], blocks[:, 1], tiles, row0], axis=1).reshape(-1),
        np.stack([q_row, own_rows], axis=1).reshape(-1),
    ]).astype(np.int32)
    slots = sms * blocks_per_sm
    parts, part_docs = _parts(n, len(blocks), k, slots)
    items = len(blocks) * parts
    walked = None if mask == "lens" else _tokens_walked(np.full(n, td, dtype=np.int64))
    valid = None
    if doc_lens is not None:
        lens = np.clip(np.asarray(doc_lens, dtype=np.int64).reshape(n), 0, td)
        valid = int(lens.sum())
        if mask == "lens":
            walked = _tokens_walked(lens)
    return MaxSimPlan(
        rows=rows, k_boxes=k_boxes, stages=stages, resident=resident, lists=lists,
        smem_bytes=smem, blocks=len(blocks), q_rows=int(tiles.sum()) * rows, parts=parts,
        part_docs=part_docs, items=items, grid=min(items, slots), slots=slots,
        waves=-(-items // slots), rows_valid=int(q_lens.sum()), tokens_walked=walked,
        tokens_valid=valid, mask=mask, table=table,
    )


def _query_gather(plan: MaxSimPlan, b: int, tq: int) -> np.ndarray:
    """Source row of each packed query row in [B * Tq + 1] rows (the padded
    queries flattened, then one zero row for the tiles' empty rows): a
    query's row t comes from its row t (under "bias" and "lane" the one row
    of a query of length 0 is its row 0, which the wrappers' operands hold
    zero, bias lane aside)."""
    qrow = plan.table[4 * plan.blocks:].reshape(b, 2).astype(np.int64)
    lens = qrow[:, 1]
    src = np.full(plan.q_rows, b * tq, dtype=np.int64)
    owner = np.repeat(np.arange(b), lens)
    tok = np.arange(int(lens.sum())) - np.repeat(np.cumsum(lens) - lens, lens)
    src[qrow[owner, 0] + tok] = owner * tq + tok
    return src


def _host_lens(query_lens, b: int, tq: int) -> np.ndarray:
    """Query lengths on the host, clamped to [0, Tq]: a numpy array or CPU
    tensor costs nothing, a CUDA tensor one copy of 4 B bytes."""
    if isinstance(query_lens, torch.Tensor):
        query_lens = query_lens.detach().cpu().numpy()
    lens = np.asarray(query_lens).reshape(-1).astype(np.int64)
    if lens.shape != (b,):
        raise ValueError("query_lens must be [B]")
    return np.clip(lens, 0, tq)


_TILE_BLOCKS_PER_SM: dict = {}


def _tile_blocks_per_sm(device: torch.device, mask: str, bf16: bool, fused: bool,
                        smem: int) -> int:
    """Resident blocks of the tile body's ``mask`` instantiation an SM holds
    at ``smem`` bytes, from the CUDA occupancy calculator (its registers and
    shared memory)."""
    key = (device.index, mask, bf16, fused, smem)
    if key not in _TILE_BLOCKS_PER_SM:
        source = MAXSIM_MASKS[mask]
        fn = getattr(cuda_build.load(source), f"{source}_blocks_per_sm")
        fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
        blocks = ctypes.c_int(0)
        with torch.cuda.device(device):
            rc = fn(int(bf16), int(fused), smem, ctypes.byref(blocks))
        cuda_build.check_launch(rc, source)
        if blocks.value < 1:
            raise RuntimeError(f"{source}: no block fits an SM at {smem} bytes")
        _TILE_BLOCKS_PER_SM[key] = blocks.value
    return _TILE_BLOCKS_PER_SM[key]


def v2_plan_on_card(query_lens, n: int, td: int, d: int, k: int, dtype: torch.dtype,
                    device: torch.device, doc_lens=None, mask: str = "lens") -> MaxSimPlan:
    """The plan the tile body launches on ``device`` for host query lengths
    under ``mask``: :func:`maxsim_topk_v2` (k > 0) or :func:`maxsim_scores_v2`
    (k = 0) by default, :func:`maxsim_topk_v1` with "bias", #12 with "lane"
    (``d`` then the augmented width). Its SM count and the policy's resident
    blocks an SM at the plan's shared memory."""
    k = min(k, n)
    smem = maxsim_layout(d, k, dtype)[-1]
    bps = _tile_blocks_per_sm(device, mask, dtype == torch.bfloat16, k > 0, smem)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return maxsim_plan(query_lens, n, td, d, k, dtype, sms, bps, doc_lens=doc_lens, mask=mask)


def _device_lens(doc_lens, n: int, device) -> torch.Tensor:
    """Document lengths as the "lens" launch reads them: int32 [N] on the card."""
    dlens = torch.as_tensor(doc_lens).to(device, torch.int32).contiguous()
    if dlens.shape != (n,):
        raise ValueError("doc_lens must be [N]")
    return dlens


def _tile_launch(name: str, queries, query_lens, docs, aux, k_eff: int):
    """Launch ``name`` on the tile body: #9 (``maxsim_topk_v2``, k_eff > 0:
    lists [B, P, k_eff]) or #10 (``maxsim_scores_v2``, k_eff 0: scores
    [B, N]) of ``csrc/maxsim_v2.cu`` with ``aux`` the int32 lengths [N] on
    the card, #11 (``maxsim_topk_v1``) of ``csrc/maxsim_v1.cu`` with ``aux``
    the f32 bias [N, Td], or #12 (``maxsim_topk_v3``) of ``csrc/maxsim_v3.cu``
    on the augmented operands, ``aux`` None. The plan is made on the host
    from the query lengths; its table and the packed rows' sources cross in
    one pinned copy, and the packed query rows [q_rows, d] are gathered on
    the card."""
    _require_exact_f32()
    mask = _WRAPPER_MASK[name]
    dev = queries.device
    queries, docs = _kernel_operands(queries, docs)
    b, tq, d = queries.shape
    n, td, _ = docs.shape
    if mask == "bias" and (aux.shape != (n, td) or aux.dtype != torch.float32
                           or aux.device != dev or not aux.is_contiguous()):
        raise ValueError("the bias must be a contiguous f32 [N, Td] tensor on the card")
    plan = v2_plan_on_card(_host_lens(query_lens, b, tq), n, td, d, k_eff, queries.dtype, dev,
                           mask=mask)
    host = np.concatenate([plan.table, _query_gather(plan, b, tq)]).astype(np.int32)
    on_card = torch.from_numpy(host).pin_memory().to(dev, non_blocking=True)
    table = on_card[: plan.table.size]
    flat = torch.cat([queries.reshape(b * tq, d), queries.new_zeros((1, d))])
    qp = flat.index_select(0, on_card[plan.table.size:])
    if k_eff > 0:
        out_s = torch.empty((b, plan.parts, k_eff), dtype=torch.float32, device=dev)
        out_i = torch.empty((b, plan.parts, k_eff), dtype=torch.int32, device=dev)
    else:
        out_s = torch.empty((b, n), dtype=torch.float32, device=dev)
        out_i = None
    suffix = "f32" if queries.dtype == torch.float32 else "bf16"
    fn = getattr(cuda_build.load(MAXSIM_MASKS[mask]), f"{name}_{suffix}_launch")
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 14 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rc = fn(
        qp.data_ptr(), docs.data_ptr(), aux.data_ptr() if aux is not None else None,
        table.data_ptr(), out_s.data_ptr(),
        out_i.data_ptr() if out_i is not None else None,
        b, n, td, d, plan.q_rows, k_eff, plan.blocks, plan.parts, plan.part_docs, plan.grid,
        plan.stages, int(plan.resident), int(plan.lists == "shared"), plan.smem_bytes,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    cuda_build.check_launch(rc, name)
    count_call(LAUNCHES, name)
    return out_s, out_i


def _tile_topk(name: str, queries, query_lens, docs, aux, k: int):
    """One fused launch of ``name`` (:func:`_tile_launch`) merged to (scores
    [B, k], rows [B, k]), padded past N with ``(NEG_INF, INT_MAX)``."""
    b = queries.shape[0]
    k_eff = min(k, docs.shape[0])
    if k_eff == 0 or b == 0:
        empty = torch.empty((b, 0), device=queries.device)
        return pad_to_k(empty, empty.to(torch.int32), k, 0)
    out_s, out_i = _tile_launch(name, queries, query_lens, docs, aux, k_eff)
    scores, ids = merge_topk(out_s, out_i, k_eff)
    return pad_to_k(scores, ids, k, k_eff)


def maxsim_topk_v2(
    queries: torch.Tensor,
    query_lens,
    docs: torch.Tensor,
    doc_lens: torch.Tensor,
    k: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused MaxSim top-k (JAX ``maxsim_topk_pallas_v2``): queries and docs
    both f32 or both bf16, f32 sums, the [B, N] scores never materialized,
    any k and any d. CUDA tensors launch ``csrc/maxsim_v2.cu``; CPU tensors
    take :func:`maxsim_topk_v2_plain`. ``query_lens`` may stay on the host
    (a numpy array or CPU tensor) beside CUDA queries: the launch plan reads
    them there, and a CUDA tensor costs one copy of 4 B bytes. Returns
    (scores [B, k], rows [B, k]) in ``(-score, row)`` order, empty documents
    at NEG_INF with their row."""
    if queries.dtype != docs.dtype:
        raise ValueError("queries and docs must share a dtype")
    if not queries.is_cuda:
        return maxsim_topk_v2_plain(queries, query_lens, docs, doc_lens, k)
    dlens = _device_lens(doc_lens, docs.shape[0], queries.device)
    return _tile_topk("maxsim_topk_v2", queries, query_lens, docs, dlens, k)


def maxsim_topk_v1(
    queries: torch.Tensor,
    query_lens,
    docs: torch.Tensor,
    doc_lens: torch.Tensor,
    k: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused MaxSim top-k with an additive document-token bias (JAX
    ``maxsim_topk_pallas``, the ``pallas`` pin): the wrapper builds the
    [N, Td] f32 bias per call (:func:`v1_bias`) and the kernel
    ``csrc/maxsim_v1.cu`` (the tile body's "bias" policy) adds it before the
    per-token max, over all Td tokens. Any k, any d; f32 or bf16.
    ``query_lens`` may stay on the host, as :func:`maxsim_topk_v2` takes
    them. CPU tensors take :func:`maxsim_topk_v1_plain`. Returns (scores
    [B, k], rows [B, k]) in ``(-score, row)`` order, empty documents at
    NEG_INF with their row."""
    if queries.dtype != docs.dtype:
        raise ValueError("queries and docs must share a dtype")
    if not queries.is_cuda:
        return maxsim_topk_v1_plain(queries, query_lens, docs, doc_lens, k)
    bias = v1_bias(doc_lens, docs.shape[0], docs.shape[1], queries.device)
    return _tile_topk(
        "maxsim_topk_v1", _masked_queries(queries, query_lens), query_lens, docs, bias, k
    )


def maxsim_topk_v3(
    queries: torch.Tensor,
    query_lens,
    docs: torch.Tensor,
    doc_lens: torch.Tensor,
    k: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused MaxSim top-k with the mask folded into the product (JAX
    ``maxsim_topk_pallas_v3``, the ``pallas_v3`` pin): the wrapper builds the
    augmented operands per call (:func:`maxsim_v3_operands`), the kernel
    ``csrc/maxsim_v3.cu`` (the tile body's "lane" policy) reads no lengths,
    and empty documents are reset to NEG_INF with their row after selection
    (the JAX kernel leaves them at Tq_pad x -1e30). Any k, any d; f32 or
    bf16. ``query_lens`` may stay on the host, as :func:`maxsim_topk_v2`
    takes them. CPU tensors take :func:`maxsim_topk_v3_plain`. Returns
    (scores [B, k], rows [B, k]) in ``(-score, row)`` order."""
    if queries.dtype != docs.dtype:
        raise ValueError("queries and docs must share a dtype")
    if not queries.is_cuda:
        return maxsim_topk_v3_plain(queries, query_lens, docs, doc_lens, k)
    qa, da = maxsim_v3_operands(queries, query_lens, docs, doc_lens)
    return _v3_topk(qa, query_lens, da, doc_lens, k)


def _v3_topk(qa, query_lens, da, doc_lens, k: int):
    """#12's launch on the augmented operands of :func:`maxsim_v3_operands`,
    its empty documents reset after selection."""
    s, i = _tile_topk("maxsim_topk_v3", qa, query_lens, da, None, k)
    return _reset_empty(s, i, doc_lens, da.shape[0])


def maxsim_scores_v2(
    queries: torch.Tensor,
    query_lens,
    docs: torch.Tensor,
    doc_lens: torch.Tensor,
) -> torch.Tensor:
    """Raw [B, N] f32 MaxSim scores (JAX ``maxsim_scores_pallas_v2``, written
    [B, N] directly). CUDA tensors launch the scores epilogue of
    ``csrc/maxsim_v2.cu`` (``query_lens`` as :func:`maxsim_topk_v2` takes
    them); CPU tensors take :func:`maxsim_scores_v2_plain`. Empty documents
    score NEG_INF."""
    if not queries.is_cuda:
        return maxsim_scores_v2_plain(queries, query_lens, docs, doc_lens)
    if queries.shape[0] == 0 or docs.shape[0] == 0:
        return torch.empty(
            (queries.shape[0], docs.shape[0]), dtype=torch.float32, device=queries.device
        )
    dlens = _device_lens(doc_lens, docs.shape[0], queries.device)
    return _tile_launch("maxsim_scores_v2", queries, query_lens, docs, dlens, 0)[0]


def _scores_chunk(b: int, n: int) -> int:
    """Queries per scores-kernel call: a [Bc, N] f32 block of at most
    ``SCORES_BUDGET`` bytes."""
    return max(1, min(b, SCORES_BUDGET // (4 * max(n, 1))))


def maxsim_topk_via_scores(
    queries, query_lens, docs, doc_lens, k: int, chunk_b: int | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact ``(-score, row)`` top-k from the flat score matrix, any k (JAX
    ``maxsim_topk_via_scores``): query chunks of ``chunk_b`` rows (default:
    ``SCORES_BUDGET`` per [Bc, N] block) through :func:`maxsim_scores_v2`,
    each selected by ``sort_topk``."""
    b = queries.shape[0]
    n = docs.shape[0]
    chunk_b = chunk_b or _scores_chunk(b, n)
    # lengths stay where they are: each chunk's launch plan reads them on the
    # host, so lengths on the card cross once here, never per chunk
    lens = torch.as_tensor(query_lens).reshape(b)
    if lens.is_cuda and queries.is_cuda:
        lens = lens.cpu()
    out_s, out_i = [], []
    for lo in range(0, b, chunk_b):
        s = maxsim_scores_v2(queries[lo : lo + chunk_b], lens[lo : lo + chunk_b], docs, doc_lens)
        ids = torch.arange(n, dtype=torch.int32, device=s.device).expand_as(s)
        cs, ci = sort_topk(s, ids, k)
        out_s.append(cs)
        out_i.append(ci)
    if not out_s:
        return pad_to_k(
            torch.empty((0, 0), dtype=torch.float32, device=queries.device),
            torch.empty((0, 0), dtype=torch.int32, device=queries.device), k, 0,
        )
    return torch.cat(out_s), torch.cat(out_i)


# -------------------------------------------------------------- dispatch
def maxsim_route(method: str, b: int, n: int, k: int, device_type: str) -> tuple[str, int]:
    """The route of :func:`maxsim_topk` as a pure function: (``"scan"``,
    ``"fused"`` or ``"scores"``, queries per scores call).

    ``auto``: tensors off the card take the scan (what the JAX package does
    off the TPU); on the card the fused kernel while ``round_up(min(k, n),
    8) <= 16`` (JAX's rule without its VMEM conditions), else the scores
    kernel plus ``sort_topk`` in query chunks whose [Bc, N] f32 block fits
    ``SCORES_BUDGET``; never the scan. ``xla`` pins the scan, ``pallas_v2``
    the fused kernel (``"fused"``), ``pallas`` the v1 kernel (``"v1"``) and
    ``pallas_v3`` the v3 kernel (``"v3"``); off the card each pinned kernel's
    wrapper takes its plain version, as the JAX package runs a pinned Pallas
    kernel in interpret mode off the TPU."""
    chunk = _scores_chunk(b, n)
    if method == "auto":
        if device_type != "cuda":
            return "scan", chunk
        if _round_up(min(k, n), 8) <= FUSED_K_MAX:
            return "fused", chunk
        return "scores", chunk
    if method == "xla":
        return "scan", chunk
    if method == "pallas_v2":
        return "fused", chunk
    if method == "pallas":
        return "v1", chunk
    if method == "pallas_v3":
        return "v3", chunk
    raise ValueError(f"unknown maxsim method: {method}")


def maxsim_topk(
    queries: torch.Tensor,
    query_lens: torch.Tensor,
    docs: torch.Tensor,
    doc_lens: torch.Tensor,
    k: int,
    method: str = "auto",
    tile_n: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact MaxSim top-k through the route :func:`maxsim_route` picks.
    ``tile_n`` sizes the scan's document tiles only."""
    route, chunk = maxsim_route(method, queries.shape[0], docs.shape[0], k, queries.device.type)
    if route == "scan":
        return maxsim_topk_scan(queries, query_lens, docs, doc_lens, k, tile_n=tile_n)
    if route == "fused":
        return maxsim_topk_v2(queries, query_lens, docs, doc_lens, k)
    if route == "v1":
        return maxsim_topk_v1(queries, query_lens, docs, doc_lens, k)
    if route == "v3":
        return maxsim_topk_v3(queries, query_lens, docs, doc_lens, k)
    return maxsim_topk_via_scores(queries, query_lens, docs, doc_lens, k, chunk_b=chunk)


# ------------------------------------------------------------------ rerank
def maxsim_rerank(
    queries: torch.Tensor,
    query_lens: torch.Tensor,
    docs: torch.Tensor,
    doc_lens: torch.Tensor,
    cand: torch.Tensor,
    k: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact MaxSim over per-query candidate rows ``cand`` [B, C] (INT_MAX
    or any row >= N = pad), in f32 (TF32 off; bf16 operands upcast, so their
    products are exact). The gathered [Bc, C, Td, d] tokens run in query
    chunks of about 1 GiB. Returns (scores [B, k], rows [B, k]) in global
    ``(-score, row)`` order; empty or pad candidates score NEG_INF, pads with
    row INT_MAX."""
    _require_exact_f32()
    b, tq, d = queries.shape
    n, td, _ = docs.shape
    c = cand.shape[1]
    dev = queries.device
    cand = cand.to(dev)
    lens = torch.as_tensor(doc_lens, device=dev).reshape(n)
    q_mask = _query_mask(query_lens, b, tq, dev)
    safe = torch.where(cand < n, cand, 0).long()
    chunk = max(1, _RERANK_BUDGET // max(1, c * td * d * 4))
    tok = torch.arange(td, device=dev)
    parts = []
    for lo in range(0, b, chunk):
        rows = safe[lo : lo + chunk]
        bc = rows.shape[0]
        cand_docs = docs[rows].float().reshape(bc, c * td, d)
        cand_lens = lens[rows]
        sims = torch.bmm(queries[lo : lo + chunk].float(), cand_docs.transpose(1, 2))
        sims = sims.view(bc, tq, c, td)
        tok_ok = tok[None, None, :] < cand_lens[:, :, None]
        sims = sims.masked_fill(~tok_ok[:, None], NEG_INF)
        per_token = torch.amax(sims, dim=3).masked_fill(~q_mask[lo : lo + chunk, :, None], 0.0)
        # an empty candidate would sum Tq x NEG_INF into -inf; clamp per token
        # (empty candidates are set to NEG_INF below anyway)
        per_token = torch.clamp(per_token, min=-1e30)
        scores = per_token.sum(dim=1)
        parts.append(scores.masked_fill(~(cand_lens > 0), NEG_INF))
    scores = torch.cat(parts) if parts else torch.empty((0, c), device=dev)
    valid = cand < n
    scores = scores.masked_fill(~valid, NEG_INF)
    ids = torch.where(valid, cand.to(torch.int32), INT_MAX)
    k_eff = min(k, c)
    s, i = sort_topk(scores, ids, k_eff)
    return pad_to_k(s, i, k, k_eff)


# ------------------------------------------------------ verified-exact path
def build_maxsim_sidecar(docs, doc_lens=None) -> dict:
    """Prescreen sidecar for :func:`maxsim_topk_verified`, on the device of
    ``docs`` (a numpy array stays on the CPU).

    Returns ``{"docs_lo", "nd_max", "r_max"}``: the bf16 copy of the padded
    ``[N, Td, d]`` tokens; max ||d_j|| and max ||d_j - bf16(d_j)|| over every
    token vector (pad tokens are zeros, residual 0), computed in float64 in
    row chunks and rounded UP (slack factor, then the next f32) so they bound
    the device's f32 arithmetic. ``doc_lens`` is accepted for the JAX
    signature; pads need no mask."""
    if isinstance(docs, torch.Tensor):
        d32 = docs.float()
    else:
        d32 = torch.from_numpy(np.asarray(docs, dtype=np.float32))
    if d32.numel() == 0:
        raise ValueError("cannot build a maxsim sidecar for an empty corpus")
    docs_lo = d32.to(torch.bfloat16)
    r_max = 0.0
    nd_max = 0.0
    chunk = max(1, (1 << 28) // max(d32.shape[1] * d32.shape[2] * 8, 1))
    for lo in range(0, d32.shape[0], chunk):
        d64 = d32[lo : lo + chunk].double()
        resid = d64 - docs_lo[lo : lo + chunk].double()
        r_max = max(r_max, float(torch.sqrt((resid * resid).sum(dim=2)).max()))
        nd_max = max(nd_max, float(torch.sqrt((d64 * d64).sum(dim=2)).max()))

    def _up(x: float) -> float:
        x32 = np.float32(x * (1.0 + 1e-6))
        return float(np.nextafter(x32, np.float32(np.inf)))

    return {"docs_lo": docs_lo, "nd_max": _up(nd_max), "r_max": _up(r_max)}


def _maxsim_prescreen_eps(qf, q_hat, q_mask, nd_max, r_max):
    """Provable per-query MaxSim error bound on raw scores (JAX
    ``_maxsim_prescreen_eps``): per query token |q_t.d_s - q^_t.d^_s| <=
    ||q_t - q^_t|| nd_max + ||q^_t|| r_max (Cauchy-Schwarz); the max over s
    is 1-Lipschitz and MaxSim sums over the valid tokens. The 1.001 factor
    and the (d + Tq) 2^-23 term cover the f32 evaluation rounding, including
    the f32 accumulation of the bf16 prescreen and nothing coarser."""
    d = qf.shape[2]
    tq = qf.shape[1]
    nd = torch.as_tensor(nd_max, dtype=torch.float32, device=qf.device)
    rm = torch.as_tensor(r_max, dtype=torch.float32, device=qf.device)
    eq = qf - q_hat
    eqn = torch.sqrt(torch.sum(eq * eq, dim=2)).masked_fill(~q_mask, 0.0)
    qn = torch.sqrt(torch.sum(q_hat * q_hat, dim=2)).masked_fill(~q_mask, 0.0)
    s_eqn = torch.sum(eqn, dim=1)
    s_qn = torch.sum(qn, dim=1)
    return (s_eqn * nd + s_qn * rm) * 1.001 + ((d + tq) * 2.0**-23) * s_qn * (nd + rm) + 1e-30


def _maxsim_topk_verified(
    queries, query_lens, docs, doc_lens, docs_lo, nd_max, r_max,
    k: int, kprime: int, second_chance: int, tile_n: int | None = None,
):
    b, tq, _ = queries.shape
    n = docs.shape[0]
    k_eff = min(k, n)
    kp_eff = min(kprime, n)
    f_cap = min(second_chance, b)
    dev = queries.device
    qf = queries.float()
    # the kernels' launch plans read the lengths where the caller keeps them
    lens_in = torch.as_tensor(query_lens).reshape(b)
    query_lens = lens_in.to(dev)
    q_mask = _query_mask(query_lens, b, tq, dev)

    # ---- pass 1: bf16 prescreen of every document -> top-(k'+1) candidates;
    # on the card through the kernels (k'+1 > 16: the scores kernel)
    q_lo = qf.to(torch.bfloat16)
    q_hat = q_lo.float()
    eps = _maxsim_prescreen_eps(qf, q_hat, q_mask, nd_max, r_max)
    ps, pi = maxsim_topk(q_lo, lens_in, docs_lo, doc_lens, kp_eff + 1, tile_n=tile_n)
    # (k'+1)-th prescreen score: any non-candidate prescreens <= this
    boundary = ps[:, kp_eff]
    cand = pi[:, :kp_eff]

    # ---- pass 2: exact f32 rescore of the candidates only
    out_s, out_i = maxsim_rerank(qf, query_lens, docs, doc_lens, cand, k_eff)

    # ---- verification: a doc with true >= e_(k) prescreens >= theta = e_(k)
    # - eps; every non-candidate prescreens <= boundary, so boundary < theta
    # proves the true top-k, tie order included, lies in the rescored set
    theta = out_s[:, k_eff - 1] - eps
    ok_q = boundary < theta

    # ---- second chance: exact search for up to f_cap failed queries
    if f_cap > 0:
        ar = torch.arange(b, dtype=torch.int64, device=dev)
        prio = torch.where(ok_q, b + ar, ar)
        order = torch.argsort(prio, stable=True)[:f_cap]
        fs, fi = maxsim_topk(qf[order], query_lens[order], docs, doc_lens, k_eff, tile_n=tile_n)
        take = ~ok_q[order][:, None]
        out_s[order] = torch.where(take, fs, out_s[order])
        out_i[order] = torch.where(take, fi, out_i[order])

    # ---- batch fallback: more failures than the second chance covers. One
    # host sync per batch reads the count (the JAX package uses lax.cond).
    n_fail = int((~ok_q).sum())
    covered = n_fail <= f_cap
    if not covered:
        out_s, out_i = maxsim_topk(qf, lens_in, docs, doc_lens, k_eff, tile_n=tile_n)
    out_s, out_i = pad_to_k(out_s, out_i, k, k_eff)
    return out_s, out_i, n_fail, covered


def maxsim_topk_verified(
    queries: torch.Tensor,
    query_lens: torch.Tensor,
    docs: torch.Tensor,
    doc_lens: torch.Tensor,
    sidecar: dict,
    k: int,
    kprime: int = 64,
    second_chance: int = 0,
    tile_n: int | None = None,
    return_stats: bool = False,
):
    """GUARANTEED-EXACT MaxSim top-k at bf16-prescreen speed (JAX
    ``maxsim_topk_verified``).

    A bf16 prescreen of every document (``sidecar["docs_lo"]`` on the docs'
    device) keeps the top-``kprime`` candidates and the (k'+1)-th score as a
    boundary; only the candidates are rescored in exact f32
    (:func:`maxsim_rerank`). A per-query bound (:func:`_maxsim_prescreen_eps`)
    proves the true top-k lies among them, or the query re-runs exactly
    through :func:`maxsim_topk` ("auto": the kernels on the card):
    ``second_chance`` failed queries per batch, more than that the whole
    batch. Results equal exact mode, tie order included, up to the sub-ulp
    reduction-order caveat. ``kprime`` is clamped to ``max(kprime, k)``.
    Returns (scores [B, k], rows [B, k]); with ``return_stats=True`` also
    (n_fail, covered) as a Python int and bool."""
    _require_exact_f32()
    kprime = max(kprime, k)
    out_s, out_i, n_fail, covered = _maxsim_topk_verified(
        queries, query_lens, docs, doc_lens, sidecar["docs_lo"], sidecar["nd_max"],
        sidecar["r_max"], k, kprime, second_chance, tile_n,
    )
    if return_stats:
        return out_s, out_i, n_fail, covered
    return out_s, out_i


# ----------------------------------------------------------- int8 serving
def quantize_int8_tokens(docs):
    """Per-token-row symmetric int8 quantization of a padded [N, Td, d] token
    matrix: ``docs ~= q * scale[..., None]``. Returns (q int8 [N, Td, d],
    scale f32 [N, Td]); pad tokens are zero rows with scale 0. numpy in, numpy
    out (the index build path); a tensor stays on its device."""
    n, td, d = docs.shape
    q, scale = quantize_int8(docs.reshape(n * td, d))
    return q.reshape(n, td, d), scale.reshape(n, td)


def maxsim_topk_int8(
    queries: torch.Tensor,
    query_lens: torch.Tensor,
    docs_q: torch.Tensor,
    doc_scales: torch.Tensor,
    doc_lens: torch.Tensor,
    k: int,
    tile_n: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """MaxSim top-k over a per-token int8 corpus (JAX ``maxsim_topk_int8``).

    Queries quantize per token row on the device; each document-token scale
    multiplies the s32 products before the max over document tokens (scales
    vary per token, so they decide which token wins), and each query token's
    scale weights its maximum before the sum; pad query tokens add exactly 0.
    Document tiles of ``tile_n`` rows (``MAXSIM_TILE_BUDGET`` by default) go
    through one s8 product each, with a running ``(-score, row)`` merge.

    Contract: APPROXIMATE against f32 (quantization error), deterministic
    within the quantized scores. Empty documents score NEG_INF with their
    row. Returns (scores [B, k], rows [B, k])."""
    b, tq, d = queries.shape
    n, td, _ = docs_q.shape
    dev = queries.device
    q_q, q_scale = quantize_int8(queries.float().reshape(b * tq, d))
    q_mask = _query_mask(query_lens, b, tq, dev)
    # the query-token scale, zero on pad tokens, weights the per-token maxima
    q_weight = torch.where(q_mask, q_scale.reshape(b, tq), 0.0)
    lens = torch.as_tensor(doc_lens, device=dev).reshape(n)
    scales = torch.as_tensor(doc_scales, device=dev)
    tok = torch.arange(td, device=dev)

    def tile_scores(lo, hi):
        nt = hi - lo
        s = int8_matmul(q_q, docs_q[lo:hi].reshape(nt * td, d)).float().view(b, tq, nt, td)
        s = s * scales[lo:hi][None, None]  # per-doc-token dequant before the max
        s = s.masked_fill(~(tok[None, :] < lens[lo:hi, None])[None, None], NEG_INF)
        per_token = torch.amax(s, dim=3) * q_weight[:, :, None]
        # pad query tokens add exactly 0, also against an empty document
        per_token = torch.where(q_mask[:, :, None], per_token, 0.0)
        return per_token.sum(dim=1).masked_fill(~(lens[lo:hi] > 0)[None, :], NEG_INF)

    return _select_tiles(b, n, k, _tile_rows(b, tq, td, n, tile_n), dev, tile_scores)
