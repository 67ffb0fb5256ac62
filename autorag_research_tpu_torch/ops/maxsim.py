"""Multi-vector MaxSim (late interaction) scoring on an NVIDIA GPU.

Counterpart of ``autorag_research_tpu/ops/maxsim.py``: ColBERT/ColPali-style
``score(q, D) = sum_t max_s q_t . d_s`` over documents padded to
``[N, Td, d]`` with token counts ``[N]`` and queries padded to ``[B, Tq, d]``
with counts ``[B]``. Scores are raw MaxSim sums; callers divide by the
query's token count.

- :func:`maxsim_topk_scan` (JAX ``maxsim_topk_xla``): a loop over document
  tiles with a running ``(-score, row)`` merge, bounded memory.
- :func:`maxsim_topk_v2` (JAX ``maxsim_topk_pallas_v2``): the fused kernel
  ``csrc/maxsim_v2.cu``, streaming top-k; CPU tensors take
  :func:`maxsim_topk_v2_plain`.
- :func:`maxsim_scores_v2` (JAX ``maxsim_scores_pallas_v2``): the same
  kernel's raw-scores epilogue, ``[B, N]``; CPU tensors take
  :func:`maxsim_scores_v2_plain`. :func:`maxsim_topk_via_scores` selects
  from it with ``sort_topk``.
- :func:`maxsim_rerank`: exact MaxSim over per-query candidate rows (a
  gather plus a batched product, outside any kernel in both packages).
- :func:`maxsim_topk_verified`: bf16 prescreen, exact f32 rescore of the
  candidates and a per-query proof that they hold the true top-k.

Empty documents (length 0) score ``NEG_INF`` and keep their row, on every
route: the convention of ``maxsim_topk_xla``. (The JAX Pallas kernels let an
empty document's sum overflow to ``-inf``; their top-k then never lists it.)
Rows past the corpus never surface; k beyond the corpus pads with
``(NEG_INF, INT_MAX)``.

Exact paths are true f32 (TF32 off, checked); bf16 operands are upcast to
f32 in the plain versions, so their products are exact and summed in f32,
as ``preferred_element_type=f32`` gives.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from autorag_research_tpu_torch.ops import cuda_build
from autorag_research_tpu_torch.ops.dense import _require_exact_f32, _round_up
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
LAUNCHES = {"maxsim_topk_v2": 0, "maxsim_scores_v2": 0}
# Calls of the plain versions and the scan, whatever the device: a run on the
# card shows with these that its tensors never took a plain route.
PLAIN_CALLS = {"maxsim_topk_scan": 0, "maxsim_topk_v2_plain": 0, "maxsim_scores_v2_plain": 0}

# [B, Tq, tile_n, Td] f32 product budget of one scan step (JAX: the same)
MAXSIM_TILE_BUDGET = 512 << 20
# [Bc, N] f32 score block of one scores-kernel call: queries run in chunks
# that fit it
SCORES_BUDGET = 256 << 20
# the fused kernel serves round_up(min(k, n), 8) <= FUSED_K_MAX on "auto"
FUSED_K_MAX = 16
# results per query the fused kernel holds (64 KB of lists at 16 queries)
KERNEL_K_MAX = 256
# query-token rows and documents per step of the kernel (csrc/maxsim_v2.cu)
_KERNEL_ROWS = 128
_KERNEL_DOCS = 32
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


def _scan(queries, query_lens, docs, doc_lens, k: int, tile_n: int | None):
    b, tq, _ = queries.shape
    n, td, _ = docs.shape
    k_eff = min(k, n)
    dev = queries.device
    scores = torch.full((b, k_eff), NEG_INF, dtype=torch.float32, device=dev)
    ids = torch.full((b, k_eff), INT_MAX, dtype=torch.int32, device=dev)
    if n == 0 or b == 0:
        return pad_to_k(scores, ids, k, k_eff)
    tile_n = min(tile_n or _auto_tile_n(b, tq, td, n), _round_up(n, 8))
    qf = queries.float()
    q_mask = _query_mask(query_lens, b, tq, dev)
    lens = torch.as_tensor(doc_lens, device=dev).reshape(n)
    for base in range(0, n, tile_n):
        tile_s = _tile_scores(qf, q_mask, docs[base : base + tile_n], lens[base : base + tile_n])
        top_s, top_i = topk_ordered(tile_s, min(k_eff, tile_s.shape[1]))
        scores, ids = sort_topk(
            torch.cat([scores, top_s], dim=1), torch.cat([ids, top_i + base], dim=1), k_eff
        )
    return pad_to_k(scores, ids, k, k_eff)


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
    PLAIN_CALLS["maxsim_topk_scan"] += 1
    return _scan(queries, query_lens, docs, doc_lens, k, tile_n)


def maxsim_topk_v2_plain(queries, query_lens, docs, doc_lens, k: int):
    """Plain PyTorch version of :func:`maxsim_topk_v2`: the same
    ``(-score, row)`` top-k by a tiled scan with bounded product tiles."""
    _require_exact_f32()
    PLAIN_CALLS["maxsim_topk_v2_plain"] += 1
    return _scan(queries, query_lens, docs, doc_lens, k, None)


def maxsim_scores_v2_plain(queries, query_lens, docs, doc_lens) -> torch.Tensor:
    """Plain PyTorch version of :func:`maxsim_scores_v2`: raw [B, N] f32
    MaxSim scores, document tile by document tile."""
    _require_exact_f32()
    PLAIN_CALLS["maxsim_scores_v2_plain"] += 1
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


# ----------------------------------------------------------------- kernels
def _kernel_layout(b: int, tq: int) -> tuple[int, int, int, int]:
    """(tq_pad, bq, rt, q_blocks): queries of tq_pad = round_up(Tq, 8) rows,
    bq of them per 128-row tile, or one query over rt tiles when longer."""
    tq_pad = _round_up(max(tq, 1), 8)
    if tq_pad <= _KERNEL_ROWS:
        bq, rt = _KERNEL_ROWS // tq_pad, 1
    else:
        bq, rt = 1, -(-tq_pad // _KERNEL_ROWS)
    return tq_pad, bq, rt, -(-b // bq)


def _pack_queries(queries, query_lens, tq_pad: int, bq: int, rt: int, q_blocks: int):
    """[q_blocks, rt*128, d] query-token rows, zero past each query's length,
    past the last query and past each block's bq * tq_pad rows."""
    b, tq, d = queries.shape
    mask = _query_mask(query_lens, b, tq, queries.device)
    q = queries * mask[:, :, None].to(queries.dtype)
    q = torch.nn.functional.pad(q, (0, 0, 0, tq_pad - tq, 0, q_blocks * bq - b))
    q = q.reshape(q_blocks, bq * tq_pad, d)
    q = torch.nn.functional.pad(q, (0, 0, 0, rt * _KERNEL_ROWS - bq * tq_pad))
    return q.contiguous()


def _kernel_parts(q_blocks: int, n: int, device: torch.device) -> tuple[int, int]:
    """(part_docs, parts): split the documents so the grid holds about eight
    blocks per SM; a part is a multiple of the kernel's 32-document step."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    parts = max(1, min(-(-n // _KERNEL_DOCS), -(-8 * sms // q_blocks)))
    part_docs = _round_up(-(-n // parts), _KERNEL_DOCS)
    return part_docs, -(-n // part_docs)


def _check_kernel_operands(queries, docs, doc_lens):
    for x, name in ((queries, "queries"), (docs, "docs")):
        if not x.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor")
        if x.dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"{name} dtype {x.dtype} not in (float32, bfloat16)")
        if x.ndim != 3 or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 3-D tensor")
        if x.shape[2] % 8 or x.data_ptr() % 16:
            raise ValueError(f"{name}: the kernel needs d % 8 == 0 and 16-byte alignment")
    if queries.dtype != docs.dtype:
        raise ValueError("queries and docs must share a dtype")
    if queries.device != docs.device or queries.shape[2] != docs.shape[2]:
        raise ValueError("queries and docs must share a device and a width")
    if doc_lens.shape != (docs.shape[0],):
        raise ValueError("doc_lens must be [N]")


def _launch(fused: bool, queries, query_lens, docs, doc_lens, k_eff: int):
    """Launch one epilogue of csrc/maxsim_v2.cu -> fused lists [B, P, k_eff]
    (scores, rows) or scores [B, N]."""
    _require_exact_f32()
    dev = queries.device
    dlens = torch.as_tensor(doc_lens).to(dev, torch.int32).contiguous()
    _check_kernel_operands(queries, docs, dlens)
    b, tq, d = queries.shape
    n, td, _ = docs.shape
    tq_pad, bq, rt, q_blocks = _kernel_layout(b, tq)
    qp = _pack_queries(queries, query_lens, tq_pad, bq, rt, q_blocks)
    part_docs, parts = _kernel_parts(q_blocks, n, dev)
    if fused:
        out_s = torch.empty((b, parts, k_eff), dtype=torch.float32, device=dev)
        out_i = torch.empty((b, parts, k_eff), dtype=torch.int32, device=dev)
        name = "maxsim_topk_v2"
    else:
        out_s = torch.empty((b, n), dtype=torch.float32, device=dev)
        out_i = None
        name = "maxsim_scores_v2"
    suffix = "f32" if queries.dtype == torch.float32 else "bf16"
    fn = getattr(cuda_build.load("maxsim_v2"), f"{name}_{suffix}_launch")
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 11 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rc = fn(
        qp.data_ptr(), docs.data_ptr(), dlens.data_ptr(), out_s.data_ptr(),
        out_i.data_ptr() if out_i is not None else None,
        b, n, td, d, tq_pad, bq, rt, k_eff if fused else 0, part_docs, parts, q_blocks,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    cuda_build.check_launch(rc, name)
    LAUNCHES[name] += 1
    return out_s, out_i


def maxsim_topk_v2(
    queries: torch.Tensor,
    query_lens: torch.Tensor,
    docs: torch.Tensor,
    doc_lens: torch.Tensor,
    k: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused MaxSim top-k (JAX ``maxsim_topk_pallas_v2``): queries and docs
    both f32 or both bf16, f32 sums, the [B, N] scores never materialized.
    CUDA tensors launch ``csrc/maxsim_v2.cu`` (at most ``KERNEL_K_MAX``
    results per query, else ``ValueError``); CPU tensors take
    :func:`maxsim_topk_v2_plain`. Returns (scores [B, k], rows [B, k]) in
    ``(-score, row)`` order, empty documents at NEG_INF with their row."""
    if queries.dtype != docs.dtype:
        raise ValueError("queries and docs must share a dtype")
    b = queries.shape[0]
    n = docs.shape[0]
    k_eff = min(k, n)
    if k_eff > KERNEL_K_MAX:
        raise ValueError(f"the fused MaxSim kernel holds at most {KERNEL_K_MAX} results per query")
    if not queries.is_cuda:
        return maxsim_topk_v2_plain(queries, query_lens, docs, doc_lens, k)
    if k_eff == 0 or b == 0:
        empty = torch.empty((b, 0), device=queries.device)
        return pad_to_k(empty, empty.to(torch.int32), k, 0)
    out_s, out_i = _launch(True, queries, query_lens, docs, doc_lens, k_eff)
    scores, ids = merge_topk(out_s, out_i, k_eff)
    return pad_to_k(scores, ids, k, k_eff)


def maxsim_scores_v2(
    queries: torch.Tensor,
    query_lens: torch.Tensor,
    docs: torch.Tensor,
    doc_lens: torch.Tensor,
) -> torch.Tensor:
    """Raw [B, N] f32 MaxSim scores (JAX ``maxsim_scores_pallas_v2``, written
    [B, N] directly). CUDA tensors launch the scores epilogue of
    ``csrc/maxsim_v2.cu``; CPU tensors take :func:`maxsim_scores_v2_plain`.
    Empty documents score NEG_INF."""
    if not queries.is_cuda:
        return maxsim_scores_v2_plain(queries, query_lens, docs, doc_lens)
    if queries.shape[0] == 0 or docs.shape[0] == 0:
        return torch.empty(
            (queries.shape[0], docs.shape[0]), dtype=torch.float32, device=queries.device
        )
    return _launch(False, queries, query_lens, docs, doc_lens, 0)[0]


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
    lens = torch.as_tensor(query_lens, device=queries.device).reshape(b)
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
    ``SCORES_BUDGET``; never the scan. ``xla`` pins the scan,
    ``pallas_v2`` the fused kernel. ``pallas`` (v1) and ``pallas_v3`` have
    no kernel of their own yet and raise."""
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
    if method in ("pallas", "pallas_v3"):
        raise NotImplementedError(
            f"maxsim method={method!r}: its kernel (_maxsim_kernel"
            f"{'_v3' if method == 'pallas_v3' else ''}) is not ported yet; use 'auto' or 'pallas_v2'"
        )
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
    query_lens = torch.as_tensor(query_lens, device=dev).reshape(b)
    q_mask = _query_mask(query_lens, b, tq, dev)

    # ---- pass 1: bf16 prescreen of every document -> top-(k'+1) candidates;
    # on the card through the kernels (k'+1 > 16: the scores kernel)
    q_lo = qf.to(torch.bfloat16)
    q_hat = q_lo.float()
    eps = _maxsim_prescreen_eps(qf, q_hat, q_mask, nd_max, r_max)
    ps, pi = maxsim_topk(q_lo, query_lens, docs_lo, doc_lens, kp_eff + 1, tile_n=tile_n)
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
        out_s, out_i = maxsim_topk(qf, query_lens, docs, doc_lens, k_eff, tile_n=tile_n)
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
