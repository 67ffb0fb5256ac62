"""Dense exact similarity scoring + top-k on an NVIDIA GPU (PyTorch + CUDA).

Counterpart of ``autorag_research_tpu/ops/dense.py``. The corpus lives in
device memory as an ``[N, d]`` tensor and a whole query batch is scored at
once. Method names map to the JAX package's as follows:

- ``full`` (``dense_topk_xla_full``): one ``torch.matmul`` plus
  :func:`topk_ordered` over the materialized [Q, N] scores.
- ``scan`` (``dense_topk_xla``): a loop over corpus tiles with a running
  ``(-score, id)`` merge, bounded memory.
- ``kernel`` (``dense_topk_pallas``): :func:`dense_topk_stream`, the
  hand-written CUDA kernel ``csrc/dense_topk_stream.cu`` that never
  materializes the scores; on CPU tensors its plain version
  :func:`dense_topk_plain`. Any k, any d.
- ``two_stage`` (``dense_topk_xla_two_stage``): per-segment then global
  selection over the materialized scores, exact.
- ``approx`` (``dense_topk_approx``): the scores plus an exact
  ``(-score, id)`` selection. ``lax.approx_max_k`` has no CUDA primitive and
  lowers to an exact top-k off the TPU, so the ids equal the exact ones.

The int8 serving mode (:func:`dense_topk_int8`) quantizes per row and takes
its s8 x s8 -> s32 products from ``torch._int_mm``; the JAX package computes
them with ``dot_general(preferred_element_type=int32)`` outside any Pallas
kernel.

The verified-exact path (:func:`dense_topk_verified`) runs its prescreen
through :func:`seg_stats_bf16`, the CUDA kernel ``csrc/seg_stats.cu``
(``_seg_stats_kernel`` in the JAX package), with :func:`_seg_stats_plain` as
its plain version.

Exact paths are true f32: the entry points switch TF32 off for matmuls and
check it (the counterpart of ``precision=HIGHEST``), since the verified
proof's error bound assumes an exact f32 rescore. Scores are raw dot
products: with L2-normalized inputs, cosine similarity.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from autorag_research_tpu_torch.ops import cuda_build
from autorag_research_tpu_torch.utils.concurrency import count_call, map_row_chunks
from autorag_research_tpu_torch.ops.topk import (  # noqa: F401 - re-exported
    INT_MAX,
    NEG_INF,
    merge_topk,
    pad_to_k,
    sort_topk,
    topk_ordered,
)

# Kernel launches per wrapper: each wrapper adds one where it launches its
# kernel and nowhere else, so a run can show which kernels it went through.
LAUNCHES = {"seg_stats_bf16": 0, "dense_topk_stream": 0}

# Score-matrix budget (bytes) for the ``full`` path; beyond it the scores are
# never materialized.
FULL_MATERIALIZE_BUDGET = 2 << 30

# Corpus rows per step of the int8 scan leg (JAX ``_dense_topk_int8_scan``)
INT8_TILE_N = 131072

# The streaming kernel's tile and shared-memory layout (csrc/dense_topk_stream.cu,
# whose launcher refuses a plan whose bytes differ from its own count): a
# 128 x 128 block tile; a ring of 3 staged slices of 32 k-columns from a
# 1,024-byte boundary (f32: TMA boxes of 128 rows of both operands; bf16:
# rows at a stride of 40) and its barriers; the per-row k-th entries,
# counters and buffers of 32 candidates; then the [128, k] lists when they fit.
STREAM_BQ = STREAM_BN = 128
STREAM_STAGES = 3
STREAM_CAP = 32
STREAM_BK = 32
STREAM_STAGE_BYTES = {
    torch.float32: 2 * STREAM_BQ * STREAM_BK * 4,
    torch.bfloat16: 2 * STREAM_BQ * (STREAM_BK + 8) * 2,
}
STREAM_RING_EXTRA = 1024 + 64  # alignment slack and the ring's barriers
STREAM_EPI_BYTES = 4 * STREAM_BQ * 4 + 2 * STREAM_BQ * STREAM_CAP * 4
# rows a part holds at least per list entry
STREAM_PART_K = 4
SMEM_BLOCK_MAX = 232448  # a block's shared memory on sm_90

# The seg-stats kernel's work items and shared-memory layout (csrc/seg_stats.cu,
# whose launcher refuses a plan whose bytes differ from its own count): items
# of 128 queries x 256 corpus rows (two segments of 128); a ring of 4 slices of
# 64 k-columns of both operands (TMA boxes of 128 bytes a row) from a 1,024-byte
# boundary; a full and an empty barrier per slot.
SEG_BQ, SEG_BN, SEG_BK, SEG_STAGES = 128, 256, 64, 4
SEG_SMEM_BYTES = 1024 + SEG_STAGES * (SEG_BQ + SEG_BN) * SEG_BK * 2 + 16 * SEG_STAGES


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _require_exact_f32() -> None:
    """Pin f32 matmuls to true f32 (no TF32) and check that it holds."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    if torch.backends.cuda.matmul.allow_tf32 or torch.get_float32_matmul_precision() != "highest":
        raise RuntimeError("exact dense paths need true f32 matmuls (TF32 is on)")


def _scores(queries: torch.Tensor, corpus: torch.Tensor) -> torch.Tensor:
    """f32 scores [Q, N]; bf16 inputs multiply exactly in f32 and sum in f32."""
    return torch.matmul(queries.float(), corpus.float().T)


def _masked_scores(qf, corpus, base: int, n_valid: int):
    scores = _scores(qf, corpus)
    col = base + torch.arange(scores.shape[1], device=scores.device)
    return scores.masked_fill(col[None, :] >= n_valid, NEG_INF)


def pad_width(x: torch.Tensor, width: int) -> torch.Tensor:
    """Zero-pad the last axis of ``x`` to ``width``. The kernels take d in
    multiples of 8; zero lanes add exact zeros to every product, so scores
    stay bitwise those of the unpadded operands."""
    if x.shape[-1] == width:
        return x
    if x.shape[-1] > width:
        raise ValueError(f"width {x.shape[-1]} exceeds {width}")
    return torch.nn.functional.pad(x, (0, width - x.shape[-1]))


def device_width(d: int, device: torch.device) -> int:
    """d as an index stores it on ``device``: rounded up to the kernels'
    multiple of 8 on the card (once, at upload), as it is elsewhere."""
    return _round_up(max(d, 1), 8) if device.type == "cuda" else d


def int8_rows(n: int, device: torch.device) -> int:
    """Rows an int8 operand is stored with on ``device``: a multiple of 16 on
    the card, the unit :func:`int8_matmul` would otherwise copy it to on
    every product; the pad rows are zero and the searches mask them."""
    return _round_up(n, 16) if device.type == "cuda" else n


def _check_cuda_operand(x: torch.Tensor, name: str, dtypes: tuple) -> None:
    if not x.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor")
    if x.dtype not in dtypes:
        raise ValueError(f"{name} dtype {x.dtype} not in {dtypes}")
    if x.ndim != 2 or not x.is_contiguous():
        raise ValueError(f"{name} must be a contiguous 2-D tensor")
    if x.data_ptr() % 16:
        raise ValueError(f"{name}: the kernel needs 16-byte alignment")


def _kernel_operands(a: torch.Tensor, b: torch.Tensor, names: tuple, dtypes: tuple):
    """Check two CUDA operands of one width and zero-pad it to a multiple of 8
    (a copy only when d % 8 != 0; the indexes pad once at upload)."""
    _check_cuda_operand(a, names[0], dtypes)
    _check_cuda_operand(b, names[1], dtypes)
    if a.device != b.device or a.shape[1] != b.shape[1]:
        raise ValueError(f"{names[0]} and {names[1]} must share a device and a width")
    d8 = _round_up(max(a.shape[1], 1), 8)
    return pad_width(a, d8), pad_width(b, d8)


# --------------------------------------------------------------- exact paths
def dense_topk_full(
    queries: torch.Tensor, corpus: torch.Tensor, k: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact dense top-k over the materialized [Q, N] scores (JAX
    ``dense_topk_xla_full``). Returns (scores f32 [Q, k], ids int32 [Q, k])
    in ``(-score, id)`` order."""
    _require_exact_f32()
    k_eff = min(k, corpus.shape[0])
    top_s, top_i = topk_ordered(_scores(queries, corpus), k_eff)
    return pad_to_k(top_s, top_i, k, k_eff)


def _scan_topk(queries, corpus, k_eff: int, tile_n: int, n_valid: int):
    """Top-k over corpus tiles of ``tile_n`` rows with a running
    ``(-score, id)`` merge; rows >= n_valid never surface."""
    q = queries.shape[0]
    scores = torch.full((q, k_eff), NEG_INF, dtype=torch.float32, device=queries.device)
    ids = torch.full((q, k_eff), INT_MAX, dtype=torch.int32, device=queries.device)
    for base in range(0, corpus.shape[0], tile_n):
        tile = _masked_scores(queries, corpus[base : base + tile_n], base, n_valid)
        tile_s, tile_local = topk_ordered(tile, min(k_eff, tile.shape[1]))
        scores, ids = sort_topk(
            torch.cat([scores, tile_s], dim=1),
            torch.cat([ids, tile_local + base], dim=1),
            k_eff,
        )
    return scores, ids


def dense_topk_scan(
    queries: torch.Tensor, corpus: torch.Tensor, k: int, tile_n: int = 131072
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact dense top-k as a loop over corpus tiles with a running
    ``(-score, id)`` merge (JAX ``dense_topk_xla``): bounded memory."""
    _require_exact_f32()
    n = corpus.shape[0]
    k_eff = min(k, n)
    scores, ids = _scan_topk(queries, corpus, k_eff, tile_n, n)
    return pad_to_k(scores, ids, k, k_eff)


class StreamPlan(NamedTuple):
    """The tile plan of one ``csrc/dense_topk_stream.cu`` launch."""

    bq: int  # queries of a block tile
    bn: int  # corpus rows of a block tile
    bk: int  # k-columns of a staged slice
    stages: int  # slots of the staging ring
    k_slices: int  # slices of one tile (d / bk, rounded up)
    q_tiles: int
    part_rows: int  # corpus rows of a part, a multiple of bn
    parts: int
    lists: str  # where the k-best lists live: "shared" or "global" (the output)
    smem_bytes: int  # dynamic shared memory of a block
    slots: int  # resident blocks of the card: SMs x blocks an SM
    waves: int  # ceil(q_tiles x parts / slots)


def dense_stream_layout(k: int, dtype: torch.dtype) -> tuple[str, int]:
    """(where the lists live, shared-memory bytes) of ``dense_topk_stream.cu``'s
    layout for lists of ``k``: the staging ring, the per-row k-th entries,
    counters and candidate buffers, and the [BQ, k] lists while all of it fits
    a block's 227 KB (else the lists live in the output)."""
    fixed = STREAM_RING_EXTRA + STREAM_STAGES * STREAM_STAGE_BYTES[dtype] + STREAM_EPI_BYTES
    lists = STREAM_BQ * k * 8
    if fixed + lists <= SMEM_BLOCK_MAX:
        return "shared", fixed + lists
    return "global", fixed


def dense_stream_plan(
    q: int, n: int, d: int, k: int, dtype: torch.dtype, sms: int, blocks_per_sm: int
) -> StreamPlan:
    """Pure tile plan of the streaming kernel for Q = ``q`` queries, N = ``n``
    rows of width ``d`` (a multiple of 8), lists of ``k`` (at most n), on a
    card of ``sms`` SMs that holds ``blocks_per_sm`` of its blocks each.

    One wave: the corpus splits into as many parts as the card's resident
    block slots leave for each 128-query tile (a grid of more tiles than
    slots takes one part, the fewest waves there are), at most one part per
    ``STREAM_PART_K * k`` rows, so parts never grow with k (each part's list
    fills with k candidates that all insert) and no part is empty."""
    if min(q, n, d, k, sms, blocks_per_sm) < 1 or d % 8:
        raise ValueError(f"no stream plan for q={q} n={n} d={d} k={k} sms={sms} "
                         f"blocks_per_sm={blocks_per_sm}")
    k = min(k, n)
    lists, smem = dense_stream_layout(k, dtype)
    q_tiles = -(-q // STREAM_BQ)
    slots = sms * blocks_per_sm
    parts = max(1, min(slots // q_tiles, -(-n // STREAM_BN), n // (STREAM_PART_K * k)))
    part_rows = _round_up(-(-n // parts), STREAM_BN)
    parts = -(-n // part_rows)
    return StreamPlan(
        bq=STREAM_BQ, bn=STREAM_BN, bk=STREAM_BK, stages=STREAM_STAGES, k_slices=-(-d // STREAM_BK),
        q_tiles=q_tiles, part_rows=part_rows, parts=parts, lists=lists, smem_bytes=smem,
        slots=slots, waves=-(-(q_tiles * parts) // slots),
    )


def _stream_plan_on_card(q: int, n: int, d: int, k: int, dtype: torch.dtype,
                         device: torch.device) -> StreamPlan:
    """The plan :func:`dense_topk_stream` launches on ``device``: its SM count and
    the kernel's resident blocks an SM at the plan's shared memory."""
    k = min(k, n)
    smem = dense_stream_layout(k, dtype)[1]
    bps = _stream_blocks_per_sm(device, dtype == torch.bfloat16, smem)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return dense_stream_plan(q, n, d, k, dtype, sms, bps)


_BLOCKS_PER_SM: dict = {}


def _stream_blocks_per_sm(device: torch.device, bf16: bool, smem: int) -> int:
    """Resident blocks of the streaming kernel an SM holds at ``smem`` bytes,
    from the CUDA occupancy calculator (its registers and shared memory)."""
    key = (device.index, bf16, smem)
    if key not in _BLOCKS_PER_SM:
        fn = cuda_build.load("dense_topk_stream").dense_topk_stream_blocks_per_sm
        fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
        blocks = ctypes.c_int(0)
        with torch.cuda.device(device):
            cuda_build.check_launch(fn(int(bf16), smem, ctypes.byref(blocks)), "dense_topk_stream")
        if blocks.value < 1:
            raise RuntimeError(f"dense_topk_stream: no block fits an SM at {smem} bytes")
        _BLOCKS_PER_SM[key] = blocks.value
    return _BLOCKS_PER_SM[key]


def _bounded_tile_n(q: int) -> int:
    """Corpus rows per step of a tiled scan: a [q, tile] f32 score tile of
    about 512 MB at any q."""
    return max(8192, min(131072, ((512 << 20) // max(1, q * 4)) // 128 * 128))


def dense_topk_plain(
    queries: torch.Tensor, corpus: torch.Tensor, k: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`dense_topk_stream`: the same
    ``(-score, id)`` top-k by a tiled scan with bounded score tiles."""
    return dense_topk_scan(queries, corpus, k, tile_n=_bounded_tile_n(queries.shape[0]))


def dense_topk_stream(
    queries: torch.Tensor, corpus: torch.Tensor, k: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Streaming exact dense top-k (JAX ``dense_topk_pallas``): queries and
    corpus both f32 or both bf16, f32 accumulation, the [Q, N] scores never
    materialized, any k and any d. CUDA tensors launch
    ``csrc/dense_topk_stream.cu``; CPU tensors take :func:`dense_topk_plain`.
    Returns (scores [Q, k], ids [Q, k]) in ``(-score, id)`` order."""
    if queries.dtype != corpus.dtype:
        raise ValueError("queries and corpus must share a dtype")
    n = corpus.shape[0]
    k_eff = min(k, n)
    if not queries.is_cuda:
        return dense_topk_plain(queries, corpus, k)
    _require_exact_f32()
    queries, corpus = _kernel_operands(
        queries, corpus, ("queries", "corpus"), (torch.float32, torch.bfloat16)
    )
    if k_eff == 0 or queries.shape[0] == 0:
        empty = torch.empty((queries.shape[0], 0), device=queries.device)
        return pad_to_k(empty, empty.to(torch.int32), k, 0)
    q, d = queries.shape
    dev = queries.device
    plan = _stream_plan_on_card(q, n, d, k_eff, queries.dtype, dev)
    out_s = torch.empty((q, plan.parts, k_eff), dtype=torch.float32, device=dev)
    out_i = torch.empty((q, plan.parts, k_eff), dtype=torch.int32, device=dev)
    lib = cuda_build.load("dense_topk_stream")
    fn = (
        lib.dense_topk_stream_bf16_launch
        if queries.dtype == torch.bfloat16
        else lib.dense_topk_stream_f32_launch
    )
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rc = fn(
        queries.data_ptr(), corpus.data_ptr(), out_s.data_ptr(), out_i.data_ptr(),
        q, n, d, k_eff, plan.part_rows, plan.parts, int(plan.lists == "shared"),
        plan.smem_bytes, torch.cuda.current_stream(dev).cuda_stream,
    )
    cuda_build.check_launch(rc, "dense_topk_stream")
    count_call(LAUNCHES, "dense_topk_stream")
    scores, ids = merge_topk(out_s, out_i, k_eff)
    return pad_to_k(scores, ids, k, k_eff)


def dense_topk_two_stage(
    queries: torch.Tensor, corpus: torch.Tensor, k: int, tile: int = 2048
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact dense top-k by hierarchical selection (JAX
    ``dense_topk_xla_two_stage``): the [Q, N] scores cut into segments of
    ``tile`` columns (at least k rounded up to 128), one ``(-score, id)``
    top-k per segment, then one over the survivors. The global winners lie
    among the segments' winners, so ids and order equal the one-pass
    selection's."""
    _require_exact_f32()
    n = corpus.shape[0]
    k_eff = min(k, n)
    tile = max(tile, _round_up(k_eff, 128))
    scores = _scores(queries, corpus)
    n_pad = _round_up(n, tile)
    if n_pad != n:
        scores = torch.nn.functional.pad(scores, (0, n_pad - n), value=NEG_INF)
    t = n_pad // tile
    tile_s, tile_loc = topk_ordered(scores.view(-1, t, tile), k_eff)
    base = (torch.arange(t, dtype=torch.int32, device=scores.device) * tile)[None, :, None]
    cand_i = (tile_loc + base).reshape(-1, t * k_eff)
    out_s, out_i = sort_topk(tile_s.reshape(-1, t * k_eff), cand_i, k_eff)
    return pad_to_k(out_s, out_i, k, k_eff)


def dense_topk_approx(
    queries: torch.Tensor, corpus: torch.Tensor, k: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """The approx serving mode (JAX ``dense_topk_approx``): the [Q, N] scores
    plus a top-k. ``lax.approx_max_k`` is a TPU primitive and lowers to an
    exact top-k elsewhere; the port selects exactly in ``(-score, id)`` order
    on every device, so its ids equal ``full``'s (at least the documented
    recall, with no ``recall_target`` to set)."""
    return dense_topk_full(queries, corpus, k)


def dense_topk(
    queries: torch.Tensor, corpus: torch.Tensor, k: int, method: str = "auto"
) -> tuple[torch.Tensor, torch.Tensor]:
    """Dispatch by shape: ``full`` while the [Q, N] f32 scores fit
    ``FULL_MATERIALIZE_BUDGET``; beyond it ``kernel`` (the streaming CUDA
    kernel, or its plain version for CPU tensors). Every method takes any k;
    ``scan``, ``two_stage`` and ``approx`` only when asked for."""
    if method == "auto":
        if queries.shape[0] * corpus.shape[0] * 4 <= FULL_MATERIALIZE_BUDGET:
            method = "full"
        else:
            method = "kernel"
    if method == "full":
        return dense_topk_full(queries, corpus, k)
    if method == "scan":
        return dense_topk_scan(queries, corpus, k)
    if method == "kernel":
        return dense_topk_stream(queries, corpus, k)
    if method == "two_stage":
        return dense_topk_two_stage(queries, corpus, k)
    if method == "approx":
        return dense_topk_approx(queries, corpus, k)
    raise ValueError(f"unknown dense_topk method: {method}")


# ------------------------------------------------------------- int8 serving
# rows quantized at a time on the host, chunks in threads
_QUANTIZE_CHUNK_ROWS = 65536


def quantize_int8(x):
    """Per-row symmetric int8 quantization: ``x ~= q * scale[:, None]``.

    Returns (q int8 [N, d], scale f32 [N]); zero rows get scale 0. numpy in,
    numpy out (the index build path: quantize once on the host, ship 4x fewer
    bytes), with ``absmax / 127`` as the JAX package's numpy path computes
    it; a tensor stays on its device, with ``absmax * f32(1/127)``, what the
    JAX package's jitted device paths compute (XLA turns the division by the
    constant into that product, which differs in the last bit for ~4% of
    rows). Both round half to even, as ``np.rint`` / ``jnp.round`` do."""
    if isinstance(x, np.ndarray):
        q = np.empty(x.shape, np.int8)
        scale = np.empty(x.shape[0], np.float32)

        def part(rows: slice) -> None:  # rows are independent: chunks in threads
            absmax = np.max(np.abs(x[rows]), axis=1)
            s = absmax / 127.0
            safe = np.where(s == 0, 1.0, s)
            q[rows] = np.clip(np.rint(x[rows] / safe[:, None]), -127, 127)
            scale[rows] = s

        map_row_chunks(part, x.shape[0], _QUANTIZE_CHUNK_ROWS)
        return q, scale
    absmax = torch.amax(torch.abs(x), dim=1)
    scale = absmax * torch.tensor(1.0 / 127.0, dtype=torch.float32)
    safe = torch.where(scale == 0, torch.ones_like(scale), scale)
    q = torch.clamp(torch.round(x / safe[:, None]), -127, 127).to(torch.int8)
    return q, scale.float()


def quantize_int8_global(x) -> tuple[np.ndarray, float]:
    """ONE symmetric scale for the whole matrix: ``x ~= q * scale``. With a
    global scale the s32 scores are already rank-faithful, so selection needs
    no per-doc dequantization. Host (numpy) input only: the build path."""
    x = np.asarray(x)
    scale = float(np.max(np.abs(x))) / 127.0
    safe = scale if scale > 0 else 1.0
    q = np.clip(np.rint(x / safe), -127, 127).astype(np.int8)
    return q, scale


def int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact s8 x s8 -> s32 products ``a @ b.T`` of ``a`` [M, K] and ``b``
    [N, K] through ``torch._int_mm``. On the card it takes M > 16 and K, N
    in multiples of 8; the operands are zero-padded to that (zeros add
    nothing to an integer sum) and the result cut back to [M, N]. N goes to
    a multiple of 16: cuBLASLt finds no int8 algorithm for some larger N
    that are only a multiple of 8 (on an H100 with CUDA 12.8: N = 11,784,
    13,960 and 58,504 at K = 16 and 64) and serves them padded to 16. That
    pad copies ``b``: the indexes store their int8 corpora already aligned
    (:func:`int8_rows`, :func:`device_width`), so a search never copies."""
    m, kd = a.shape
    n = b.shape[0]
    if m == 0 or n == 0:
        return torch.zeros((m, n), dtype=torch.int32, device=a.device)
    k8 = _round_up(max(kd, 1), 8)

    def padded(x, rows):
        if x.shape[1] == k8 and x.shape[0] == rows:
            return x.contiguous()
        return torch.nn.functional.pad(x, (0, k8 - kd, 0, rows - x.shape[0])).contiguous()

    out = torch._int_mm(padded(a, max(m, 17)), padded(b, _round_up(n, 16)).T)
    return out[:m, :n] if out.shape != (m, n) else out


def _as_scale(corpus_scale, device) -> tuple[torch.Tensor, bool]:
    """(f32 scale tensor, per_doc): a python float or 0-d tensor is a global
    scale, an [N] tensor per-row scales."""
    t = torch.as_tensor(corpus_scale, dtype=torch.float32, device=device)
    return t, t.ndim != 0


def dense_topk_int8(
    queries: torch.Tensor,
    corpus_q: torch.Tensor,
    corpus_scale,
    k: int,
    tile_n: int = INT8_TILE_N,
    n_valid: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Dense top-k over an int8-quantized corpus (JAX ``dense_topk_int8``):
    per-row scales [N] (``quantize_int8``) or one global scale
    (``quantize_int8_global``). Queries quantize per row on the device; the
    s32 products convert to f32, the per-doc scales fold into the scores
    before selection and the per-query scale multiplies the k winners (with a
    global scale both scales multiply the winners). One flat product while
    the [Q, N] scores fit ``FULL_MATERIALIZE_BUDGET``, else a scan over
    ``tile_n``-row corpus tiles with a running merge. Rows from ``n_valid``
    on (zero rows an index stores for :func:`int8_rows`) never win.

    Contract: APPROXIMATE against f32 (quantization error), deterministic
    within the quantized scores: selection is always exact ``(-score, id)``,
    so the JAX ``exact`` flag has no counterpart (its ``approx_max_k`` lowers
    to an exact top-k off the TPU)."""
    if queries.shape[0] * corpus_q.shape[0] * 4 <= FULL_MATERIALIZE_BUDGET:
        return _dense_topk_int8_flat(queries, corpus_q, corpus_scale, k, n_valid)
    return _dense_topk_int8_scan(queries, corpus_q, corpus_scale, k, tile_n, n_valid)


def _dense_topk_int8_flat(queries, corpus_q, corpus_scale, k: int, n_valid: int | None = None):
    n_valid = corpus_q.shape[0] if n_valid is None else n_valid
    k_eff = min(k, n_valid)
    q_q, q_scale = quantize_int8(queries.float())
    scale, per_doc = _as_scale(corpus_scale, queries.device)
    s = int8_matmul(q_q, corpus_q).float()
    if per_doc:
        s = s * scale[None, :]
    s[:, n_valid:] = NEG_INF
    out_s, out_i = topk_ordered(s, k_eff)
    if not per_doc:
        # global scale: the s32 scores are rank-faithful; both scales go to
        # the k winners only
        out_s = out_s * (q_scale[:, None] * scale)
        return pad_to_k(out_s, out_i, k, k_eff)
    out_s = out_s * q_scale[:, None]
    return pad_to_k(out_s, out_i, k, k_eff)


def _dense_topk_int8_scan(
    queries, corpus_q, corpus_scale, k: int, tile_n: int, n_valid: int | None = None
):
    """Bounded-memory int8 top-k (JAX ``_dense_topk_int8_scan``): the same
    selection values as the flat leg, so equal ids, tie order included."""
    q = queries.shape[0]
    n = corpus_q.shape[0]
    n_valid = n if n_valid is None else n_valid
    k_eff = min(k, n_valid)
    dev = queries.device
    q_q, q_scale = quantize_int8(queries.float())
    scale, per_doc = _as_scale(corpus_scale, dev)
    tile_n = min(tile_n, _round_up(n, 128))
    out_s = torch.full((q, k_eff), NEG_INF, dtype=torch.float32, device=dev)
    out_i = torch.full((q, k_eff), INT_MAX, dtype=torch.int32, device=dev)
    for base in range(0, n, tile_n):
        s = int8_matmul(q_q, corpus_q[base : base + tile_n]).float()
        if per_doc:
            s = s * scale[base : base + tile_n][None, :]
        s[:, max(n_valid - base, 0) :] = NEG_INF
        tile_s, tile_i = topk_ordered(s, min(k_eff, s.shape[1]))
        out_s, out_i = sort_topk(
            torch.cat([out_s, tile_s], dim=1), torch.cat([out_i, tile_i + base], dim=1), k_eff
        )
    if not per_doc:
        out_s = out_s * scale
    out_s = out_s * q_scale[:, None]
    return pad_to_k(out_s, out_i, k, k_eff)


# ------------------------------------------------------- verified exact fast
_SIDECAR_CHUNK_ROWS = 65536


def build_verified_sidecar(corpus, rep: str = "int8", pad_rows_to: int | None = None) -> dict:
    """Host-side prescreen sidecar for :func:`dense_topk_verified`.

    Returns ``{"corpus_lo", "corpus_scale", "nd_max", "r_max"}`` with
    ``corpus_lo`` a CPU tensor: per-row int8 (``rep="int8"``, with per-row
    f32 ``corpus_scale``) or bf16 (``rep="bf16"``, ``corpus_scale`` None).
    ``nd_max`` = max ||d|| and ``r_max`` = max ||d - dequant(lo(d))|| are
    computed in float64 and rounded UP, so they bound the device's f32
    arithmetic. ``pad_rows_to`` zero-pads ``corpus_lo`` to a row multiple;
    the prescreen masks pad rows by the valid-row count."""
    c = np.asarray(corpus, dtype=np.float32)
    if c.size == 0:
        raise ValueError("cannot build a verified sidecar for an empty corpus")
    if rep == "int8":
        lo_np, scale_np = quantize_int8(c)
        corpus_lo, corpus_scale = torch.from_numpy(lo_np), torch.from_numpy(scale_np)
    elif rep == "bf16":
        corpus_lo = torch.from_numpy(c).to(torch.bfloat16)
        corpus_scale = None
    else:
        raise ValueError(f"unknown verified prescreen rep: {rep}")

    def _up(x: float) -> float:
        x32 = np.float32(x * (1.0 + 1e-6))
        return float(np.nextafter(x32, np.float32(np.inf)))

    # float64 row norms over row chunks in threads: the same per-row values,
    # and so the same maxima, as over the whole matrix, without float64
    # copies of it
    def part(rows: slice) -> tuple[float, float]:
        c64 = c[rows].astype(np.float64)
        if rep == "int8":
            deq = lo_np[rows].astype(np.float64) * scale_np[rows].astype(np.float64)[:, None]
        else:
            deq = corpus_lo[rows].float().numpy().astype(np.float64)
        return float(np.linalg.norm(c64 - deq, axis=1).max()), float(np.linalg.norm(c64, axis=1).max())

    maxima = map_row_chunks(part, c.shape[0], _SIDECAR_CHUNK_ROWS)
    r_max = _up(max(m[0] for m in maxima))
    nd_max = _up(max(m[1] for m in maxima))
    if pad_rows_to:
        pad = _round_up(corpus_lo.shape[0], pad_rows_to) - corpus_lo.shape[0]
        if pad:
            corpus_lo = torch.cat(
                [corpus_lo, corpus_lo.new_zeros((pad, corpus_lo.shape[1]))]
            )
            if corpus_scale is not None:
                corpus_scale = torch.cat([corpus_scale, corpus_scale.new_zeros(pad)])
    return {
        "corpus_lo": corpus_lo,
        "corpus_scale": corpus_scale,
        "nd_max": nd_max,
        "r_max": r_max,
    }


def _prescreen_query_side(qf, corpus_lo, corpus_scale):
    """Low-precision query representation + the prescreen error bound inputs."""
    if corpus_lo.dtype == torch.int8:
        q_q, q_scale = quantize_int8(qf)
        q_hat = q_q.float() * q_scale[:, None]
        return (q_q, q_scale), q_hat
    q_lo = qf.to(corpus_lo.dtype)
    return (q_lo, None), q_lo.float()


def _prescreen_eps(qf, q_hat, nd_max: float, r_max: float):
    """Provable per-query error bound: |true(q,d) - shat(q,d)| <= eps for
    EVERY doc d. By Cauchy-Schwarz eps = ||q - q_hat||·nd_max +
    ||q_hat||·r_max; the 1.001 factor and the d·2^-23 term cover the f32
    evaluation rounding (norms, dequant multiplies, the f32 accumulation of
    the low-precision prescreen)."""
    d = qf.shape[1]
    nd = torch.tensor(nd_max, dtype=torch.float32, device=qf.device)
    rm = torch.tensor(r_max, dtype=torch.float32, device=qf.device)
    eq = qf - q_hat
    eqn = torch.sqrt(torch.sum(eq * eq, dim=1))
    qn = torch.sqrt(torch.sum(q_hat * q_hat, dim=1))
    return (eqn * nd + qn * rm) * 1.001 + (d * 2.0**-23) * qn * (nd + rm) + 1e-30


def _seg_stats_plain(q_rep, corpus_lo, corpus_scale, n: int, seg: int):
    """Segment statistics over the materialized prescreen scores (JAX
    ``_seg_stats_xla``) -> (max1 f32, loc1 int32, max2 f32), each [Q, S] with
    S = ceil(rows / seg). Columns >= n are masked to NEG_INF.

    The plain version of :func:`seg_stats_bf16` for a bf16 corpus, and the
    int8 prescreen's only path (neither package has an int8 kernel): int8
    products and their sums are integers, computed exactly in float64."""
    q_lo, q_scale = q_rep
    if corpus_lo.dtype == torch.int8:
        s = torch.matmul(q_lo.double(), corpus_lo.double().T).to(torch.int32)
        shat = s.float() * corpus_scale[None, :] * q_scale[:, None]
    else:
        shat = _scores(q_lo, corpus_lo)
    q_cnt, n_lo = shat.shape
    col = torch.arange(n_lo, device=shat.device)
    shat = shat.masked_fill(col[None, :] >= n, NEG_INF)
    s_cnt = -(-n_lo // seg)
    if s_cnt * seg != n_lo:
        shat = torch.nn.functional.pad(shat, (0, s_cnt * seg - n_lo), value=NEG_INF)
    segv = shat.view(q_cnt, s_cnt, seg)
    max1 = torch.amax(segv, dim=2)
    lane = torch.arange(seg, dtype=torch.int32, device=shat.device).expand_as(segv)
    is_max = segv == max1[:, :, None]
    loc1 = torch.amin(torch.where(is_max, lane, INT_MAX), dim=2)
    max2 = torch.amax(segv.masked_fill(lane == loc1[:, :, None], NEG_INF), dim=2)
    return max1, loc1, max2


class SegStatsPlan(NamedTuple):
    """The work plan of one ``csrc/seg_stats.cu`` launch."""

    bq: int  # queries of an item
    bn: int  # corpus rows of an item: two segments
    bk: int  # k-columns of a staged slice
    stages: int  # slots of the staging ring
    k_slices: int  # slices of one item (d / bk, rounded up)
    q_tiles: int
    c_tiles: int  # corpus tiles of bn rows
    cluster: int  # blocks of a cluster; 2 share each corpus slice by TMA multicast
    q_groups: int  # q_tiles / cluster: the query tiles a cluster's items step over
    items: int  # q_groups x c_tiles, each done by all blocks of a cluster
    grid: int  # blocks launched, a multiple of cluster
    cluster_items: int  # the most items one cluster walks
    smem_bytes: int  # dynamic shared memory of a block
    slots: int  # resident blocks of the card: SMs x blocks an SM
    resident: int  # clusters of this size the card holds at once
    waves: int  # ceil(grid / cluster / resident)


def seg_stats_plan(q: int, n: int, d: int, sms: int, blocks_per_sm: int,
                   resident_clusters: int) -> SegStatsPlan:
    """Pure work plan of the seg-stats kernel for Q = ``q`` queries against
    ``n`` corpus rows of width ``d`` (a multiple of 8) on a card of ``sms`` SMs
    that holds ``blocks_per_sm`` of its blocks each and ``resident_clusters``
    clusters of two at once (the occupancy calculator's count, which knows how
    SMs group: a GPC with an odd number of free SMs leaves one without a
    partner).

    One wave of persistent blocks: as many as the card holds at once, or one a
    work item where there are fewer items. Blocks pair into clusters of two
    whenever the 128-query tiles pair up and the card holds a cluster: the two
    take a pair's query tiles and share every corpus slice by multicast, so no
    block computes a query tile past Q. A cluster walks items with a stride of
    the cluster count, query groups fastest."""
    slots = sms * blocks_per_sm
    if min(q, n, d, sms, blocks_per_sm) < 1 or d % 8 or not 0 <= resident_clusters <= slots // 2:
        raise ValueError(f"no seg-stats plan for q={q} n={n} d={d} sms={sms} "
                         f"blocks_per_sm={blocks_per_sm} resident_clusters={resident_clusters}")
    q_tiles = -(-q // SEG_BQ)
    c_tiles = -(-n // SEG_BN)
    cluster = 2 if q_tiles % 2 == 0 and resident_clusters >= 1 else 1
    resident = resident_clusters if cluster == 2 else slots
    q_groups = q_tiles // cluster
    items = q_groups * c_tiles
    clusters = min(resident, items)
    return SegStatsPlan(
        bq=SEG_BQ, bn=SEG_BN, bk=SEG_BK, stages=SEG_STAGES, k_slices=-(-d // SEG_BK),
        q_tiles=q_tiles, c_tiles=c_tiles, cluster=cluster, q_groups=q_groups, items=items,
        grid=clusters * cluster, cluster_items=-(-items // clusters), smem_bytes=SEG_SMEM_BYTES,
        slots=slots, resident=resident, waves=-(-clusters // resident),
    )


def _seg_occupancy(device: torch.device) -> tuple[int, int]:
    """(blocks an SM, clusters of two the card) of the seg-stats kernel that
    ``device`` holds at once, from the CUDA occupancy calculator."""
    key = ("seg_stats", device.index, SEG_SMEM_BYTES)
    if key not in _BLOCKS_PER_SM:
        lib = cuda_build.load("seg_stats")
        lib.seg_stats_blocks_per_sm.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        lib.seg_stats_max_active_clusters.argtypes = [ctypes.c_int, ctypes.c_int,
                                                      ctypes.POINTER(ctypes.c_int)]
        lib.seg_stats_blocks_per_sm.restype = ctypes.c_int
        lib.seg_stats_max_active_clusters.restype = ctypes.c_int
        blocks, clusters = ctypes.c_int(0), ctypes.c_int(0)
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        with torch.cuda.device(device):
            cuda_build.check_launch(
                lib.seg_stats_blocks_per_sm(SEG_SMEM_BYTES, ctypes.byref(blocks)), "seg_stats_bf16")
            cuda_build.check_launch(lib.seg_stats_max_active_clusters(
                SEG_SMEM_BYTES, 2 * sms, ctypes.byref(clusters)), "seg_stats_bf16")
        if blocks.value < 1:
            raise RuntimeError(f"seg_stats_bf16: no block fits an SM at {SEG_SMEM_BYTES} bytes")
        _BLOCKS_PER_SM[key] = (blocks.value, clusters.value)
    return _BLOCKS_PER_SM[key]


def _seg_plan_on_card(q: int, n: int, d: int, device: torch.device) -> SegStatsPlan:
    """The plan :func:`seg_stats_bf16` launches on ``device``: its SM count and
    the kernel's resident blocks an SM and clusters of two."""
    blocks, clusters = _seg_occupancy(device)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return seg_stats_plan(q, n, d, sms, blocks, clusters)


def seg_stats_bf16(q_lo: torch.Tensor, corpus_lo: torch.Tensor, n: int, seg: int = 128):
    """Fused bf16 prescreen + per-segment (max1, loc1, max2), each [Q, S],
    S = ceil(rows / seg) (JAX ``_seg_stats_pallas``). CUDA tensors launch
    ``csrc/seg_stats.cu`` (seg must be 128) from :func:`seg_stats_plan`; CPU
    tensors take :func:`_seg_stats_plain`."""
    if not q_lo.is_cuda:
        return _seg_stats_plain((q_lo, None), corpus_lo, None, n, seg)
    if seg != 128:
        raise ValueError("the seg_stats kernel takes seg=128 only")
    q_lo, corpus_lo = _kernel_operands(q_lo, corpus_lo, ("q_lo", "corpus_lo"), (torch.bfloat16,))
    q, d = q_lo.shape
    rows = corpus_lo.shape[0]
    if not 0 <= n <= rows:
        raise ValueError(f"valid-row count {n} outside [0, {rows}]")
    s_cnt = -(-rows // seg)
    dev = q_lo.device
    max1 = torch.empty((q, s_cnt), dtype=torch.float32, device=dev)
    loc1 = torch.empty((q, s_cnt), dtype=torch.int32, device=dev)
    max2 = torch.empty((q, s_cnt), dtype=torch.float32, device=dev)
    if q == 0 or rows == 0:
        return max1, loc1, max2
    plan = _seg_plan_on_card(q, rows, d, dev)
    fn = cuda_build.load("seg_stats").seg_stats_bf16_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rc = fn(
        q_lo.data_ptr(), corpus_lo.data_ptr(), max1.data_ptr(), loc1.data_ptr(),
        max2.data_ptr(), q, rows, d, n, s_cnt, plan.cluster, plan.grid, plan.smem_bytes,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    cuda_build.check_launch(rc, "seg_stats_bf16")
    count_call(LAUNCHES, "seg_stats_bf16")
    return max1, loc1, max2


def _exact_scan_masked(qf, corpus, n_valid: int, k_eff: int):
    """Exact f32 top-k as a corpus-tiled loop with an n_valid row mask: the
    bounded-memory exact fallback of the verified path."""
    return _scan_topk(qf, corpus, k_eff, _bounded_tile_n(qf.shape[0]), n_valid)


def _exact_topk_masked(qf, corpus, n_valid: int, k_eff: int):
    """Exact f32 fallback: flat while the scores fit the budget, else the
    tiled scan."""
    if qf.shape[0] * corpus.shape[0] * 4 > FULL_MATERIALIZE_BUDGET:
        return _exact_scan_masked(qf, corpus, n_valid, k_eff)
    return topk_ordered(_masked_scores(qf, corpus, 0, n_valid), k_eff)


def _dense_topk_verified(
    queries, corpus, corpus_lo, corpus_scale, nd_max: float, r_max: float,
    k: int, m: int, j: int, seg: int, second_chance: int, n_valid: int | None = None,
):
    q_cnt = queries.shape[0]
    n = corpus.shape[0]
    # rows >= n_valid (zero padding) are masked out of stats, candidates and
    # the exact fallbacks: they can never surface
    n_valid = n if n_valid is None else int(n_valid)
    k_eff = min(k, n)
    f_cap = min(second_chance, q_cnt)
    qf = queries.float()
    dev = qf.device

    # ---- pass 1: prescreen scores -> per-segment statistics. No large-k
    # selection runs at corpus width: the corpus splits into S segments and
    # three cheap per-segment reductions (max1, its min-lane argmax loc1,
    # runner-up max2) feed a top-k over [Q, S] only.
    q_rep, q_hat = _prescreen_query_side(qf, corpus_lo, corpus_scale)
    eps = _prescreen_eps(qf, q_hat, nd_max, r_max)
    if corpus_lo.dtype == torch.int8:
        max1, loc1, max2 = _seg_stats_plain(q_rep, corpus_lo, corpus_scale, n_valid, seg)
    else:
        max1, loc1, max2 = seg_stats_bf16(q_rep[0], corpus_lo, n_valid, seg)
    s_cnt = max1.shape[1]

    m_eff = min(m, s_cnt)
    j_eff = min(j, s_cnt)
    neg = torch.full((q_cnt,), NEG_INF, dtype=torch.float32, device=dev)
    if s_cnt > m_eff:
        top1_s, top1_i = topk_ordered(max1, m_eff + 1)
        boundary = top1_s[:, m_eff]  # (m+1)-th largest segment max
        sel_seg, sel_val = top1_i[:, :m_eff], top1_s[:, :m_eff]
    else:
        sel_val, sel_seg = topk_ordered(max1, m_eff)
        boundary = neg
    if s_cnt > j_eff:
        top2_s, top2_i = topk_ordered(max2, j_eff + 1)
        m2bound = top2_s[:, j_eff]  # (j+1)-th largest runner-up
        r_seg = top2_i[:, :j_eff]
    else:
        _, r_seg = topk_ordered(max2, j_eff)
        m2bound = neg

    # argmax candidates: drop segments rescored in full below (their argmax
    # would duplicate) and NEG_INF pad segments
    in_r = torch.any(sel_seg[:, :, None] == r_seg[:, None, :], dim=2)
    arg_ids = sel_seg * seg + torch.gather(loc1, 1, sel_seg.long())
    arg_valid = (~in_r) & (sel_val > NEG_INF) & (arg_ids < n_valid)
    # full-segment candidates: every doc of the top-j runner-up segments
    seg_iota = torch.arange(seg, dtype=torch.int32, device=dev)
    full_ids = (r_seg[:, :, None] * seg + seg_iota[None, None, :]).reshape(q_cnt, j_eff * seg)
    full_valid = full_ids < n_valid

    cand_i = torch.cat([arg_ids, full_ids], dim=1)
    cand_valid = torch.cat([arg_valid, full_valid], dim=1)
    safe_i = torch.clamp(cand_i, 0, n - 1).long()
    # gather [Q, m + j*seg, d] f32 rows (about 1 GB at Q=1024, d=768) and
    # rescore them in true f32
    rows = corpus[safe_i].float()
    e = torch.bmm(rows, qf[:, :, None])[:, :, 0]
    e = e.masked_fill(~cand_valid, NEG_INF)
    sort_ids = cand_i.masked_fill(~cand_valid, INT_MAX)
    out_s, out_i = sort_topk(e, sort_ids, k_eff)

    # ---- verification: a doc with true >= e_(k) has shat >= theta =
    # e_(k) - eps. A non-candidate doc is in a non-selected segment (shat <=
    # boundary) or a non-argmax doc of a segment not rescored in full (shat <=
    # m2bound), so two strict comparisons prove the true top-k, tie order
    # included, lies inside the exactly ranked rescore set.
    theta = out_s[:, k_eff - 1] - eps
    ok_q = (boundary < theta) & (m2bound < theta)
    fail_q = ~ok_q

    # ---- second chance: full exact scan for up to f_cap failed queries
    if f_cap > 0:
        ar = torch.arange(q_cnt, dtype=torch.int64, device=dev)
        prio = torch.where(ok_q, q_cnt + ar, ar)
        order = torch.argsort(prio)[:f_cap]
        fs, fi = _exact_topk_masked(qf[order], corpus, n_valid, k_eff)
        take = fail_q[order][:, None]
        out_s[order] = torch.where(take, fs, out_s[order])
        out_i[order] = torch.where(take, fi, out_i[order])

    # ---- batch fallback: more failures than the second chance covers. One
    # host sync per batch reads the failure count (the JAX package decides
    # this inside the device program with lax.cond).
    n_fail = int(fail_q.sum())
    covered = n_fail <= f_cap
    if not covered:
        out_s, out_i = _exact_topk_masked(qf, corpus, n_valid, k_eff)
    out_s, out_i = pad_to_k(out_s, out_i, k, k_eff)
    return out_s, out_i, n_fail, covered


def dense_topk_verified(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    sidecar: dict,
    k: int,
    m: int = 64,
    j: int = 2,
    seg: int = 128,
    second_chance: int = 0,
    return_stats: bool = False,
):
    """GUARANTEED-EXACT dense top-k at prescreen speed.

    Pass 1 scores the whole corpus in low precision (bf16 through
    :func:`seg_stats_bf16`, or int8) and reduces each ``seg``-doc segment to
    its max, min-lane argmax and runner-up. Pass 2 gathers the argmaxes of
    the top-``m`` segments and every doc of the top-``j`` runner-up segments
    from the f32 corpus, rescores them in true f32 and selects by
    ``(-score, doc_id)``. A provable per-query error bound (see
    :func:`build_verified_sidecar`) then checks that no other doc could
    reach the top-k; queries that fail re-run as a full exact scan (up to
    ``second_chance`` per batch; more than that falls back to the whole
    batch). Results equal the full exact scan, tie order included.

    ``sidecar`` holds device tensors (``corpus_lo`` on the corpus's device).
    Returns (scores [Q, k], ids [Q, k]); with ``return_stats=True`` also
    (n_fail, covered) as a Python int and bool.
    """
    _require_exact_f32()
    out_s, out_i, n_fail, covered = _dense_topk_verified(
        queries, corpus, sidecar["corpus_lo"], sidecar["corpus_scale"],
        sidecar["nd_max"], sidecar["r_max"], k, m, j, seg, second_chance,
    )
    if return_stats:
        return out_s, out_i, n_fail, covered
    return out_s, out_i
