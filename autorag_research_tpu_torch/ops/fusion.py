"""Hybrid fusion: Reciprocal Rank Fusion and Convex Combination.

Exact behavioral parity with the reference's fusers
(``pipelines/retrieval/hybrid.py:46-177``):

- RRF: ``score(d) = sum_i 1/(k + rank_i(d))`` with rank starting at 1;
  documents missing from one list contribute ``1/(k + fetch_k + 1)`` for that
  list (missing-rank floor).
- CC: ``weight * norm(s1) + (1-weight) * norm(s2)`` with normalization in
  {mm, tmm, z, dbsf}; documents missing from a list take that method's
  post-normalization floor (0, 0, -3, 0).
- Ties in the fused ranking break deterministically by doc id (the reference
  relies on Python's stable sort of insertion order; id order is the
  shard-stable equivalent used across this framework).

``fuse_batch_*`` are vectorized PyTorch versions that fuse whole query
batches of padded candidate arrays on the tensors' device, in f32, as the JAX
package's ``jnp`` versions do. The host fusers are the JAX package's
verbatim, so the same leg lists give bitwise its output.
"""

from __future__ import annotations

from typing import Any, Sequence

import torch

from autorag_research_tpu_torch.ops.topk import INT_MAX, sort_topk
from autorag_research_tpu_torch.utils.normalize import (
    MISSING_SCORE_FLOORS,
    normalize_dbsf,
    normalize_minmax,
    normalize_tmm,
    normalize_zscore,
)

Hit = dict[str, Any]  # {"doc_id", "score"}


def id_tiebreak_sort(items, score_of, id_of):
    """Sort by (-score, doc_id) — the framework-wide deterministic order that
    matches sort_topk on device. Falls back to string ids only when a
    collection mixes incomparable id types (pathological)."""
    try:
        return sorted(items, key=lambda it: (-score_of(it), id_of(it)))
    except TypeError:
        return sorted(items, key=lambda it: (-score_of(it), str(id_of(it))))


def _sorted_hits(score_map: dict[Any, float], top_k: int) -> list[Hit]:
    items = id_tiebreak_sort(score_map.items(), lambda kv: kv[1], lambda kv: kv[0])
    return [{"doc_id": d, "score": float(s)} for d, s in items[:top_k]]


def rrf_fuse(
    results_1: Sequence[Hit],
    results_2: Sequence[Hit],
    k: int = 60,
    top_k: int = 10,
    fetch_k: int = 20,
) -> list[Hit]:
    scores: dict[Any, float] = {}
    for rank, hit in enumerate(results_1, start=1):
        scores[hit["doc_id"]] = scores.get(hit["doc_id"], 0.0) + 1.0 / (k + rank)
    for rank, hit in enumerate(results_2, start=1):
        scores[hit["doc_id"]] = scores.get(hit["doc_id"], 0.0) + 1.0 / (k + rank)
    missing = 1.0 / (k + fetch_k + 1)
    ids_1 = {h["doc_id"] for h in results_1}
    ids_2 = {h["doc_id"] for h in results_2}
    for doc_id in ids_1 ^ ids_2:  # present in exactly one list
        scores[doc_id] += missing
    return _sorted_hits(scores, top_k)


_NORMALIZERS = {
    "mm": lambda s, _min: normalize_minmax(s),
    "tmm": lambda s, _min: normalize_tmm(s, _min if _min is not None else 0.0),
    "z": lambda s, _min: normalize_zscore(s),
    "dbsf": lambda s, _min: normalize_dbsf(s),
}


def cc_fuse(
    results_1: Sequence[Hit],
    results_2: Sequence[Hit],
    weight: float = 0.5,
    top_k: int = 10,
    normalize_method: str = "mm",
    pipeline_1_min: float | None = None,
    pipeline_2_min: float | None = None,
) -> list[Hit]:
    if normalize_method not in _NORMALIZERS:
        raise ValueError(f"unknown normalization method: {normalize_method}")
    if normalize_method == "tmm" and (pipeline_1_min is None or pipeline_2_min is None):
        raise ValueError("tmm normalization requires pipeline_1_min and pipeline_2_min")
    map_1 = {h["doc_id"]: float(h["score"]) for h in results_1}
    map_2 = {h["doc_id"]: float(h["score"]) for h in results_2}
    all_ids = list(dict.fromkeys([*map_1, *map_2]))
    s1 = [map_1.get(d) for d in all_ids]
    s2 = [map_2.get(d) for d in all_ids]
    n1 = _NORMALIZERS[normalize_method](s1, pipeline_1_min)
    n2 = _NORMALIZERS[normalize_method](s2, pipeline_2_min)
    floor = MISSING_SCORE_FLOORS[normalize_method]
    fused = {
        d: weight * (a if a is not None else floor)
        + (1 - weight) * (b if b is not None else floor)
        for d, a, b in zip(all_ids, n1, n2)
    }
    return _sorted_hits(fused, top_k)


# ------------------------------------------------------------------- device
def _as_scores(scores, device) -> torch.Tensor:
    # f64 input is computed in f32, as the JAX package (x64 off) computes it
    return torch.as_tensor(scores).to(device=device, dtype=torch.float32)


def _first_occurrence(eq: torch.Tensor) -> torch.Tensor:
    """[B, M, M] id equality -> [B, M] True where a slot holds the first
    occurrence of its id (``argmax`` returns the first maximal index; it has
    no ``bool`` kernel on the CPU)."""
    m = eq.shape[-1]
    first = torch.argmax(eq.to(torch.uint8), dim=-1)
    return first == torch.arange(m, device=eq.device)[None, :]


def fuse_batch_rrf(ids_1, ids_2, k: int, top_k: int, fetch_k: int):
    """Vectorized RRF over padded candidate-id arrays [B, F] (pad = -1/INT_MAX
    sentinel ids never matching). Returns (scores [B, top_k], fused ids) —
    the same (scores, ids) order as :func:`fuse_batch_cc` and ``sort_topk``.

    Device variant of :func:`rrf_fuse` using rank arithmetic + the
    deterministic (-score, id) merge, on the device of ``ids_1``; used when
    fusing large query batches without host round-trips.
    """
    ids_1 = torch.as_tensor(ids_1)
    ids_2 = torch.as_tensor(ids_2).to(ids_1.device)
    b, f = ids_1.shape
    union = torch.cat([ids_1, ids_2], dim=1)  # [B, 2F]
    ranks = torch.arange(1, f + 1, dtype=torch.float32, device=union.device)
    base = torch.cat([1.0 / (k + ranks)] * 2)[None, :].expand(b, -1)  # [B, 2F]
    # score of each occurrence slot; duplicates resolved by matching ids
    eq = union[:, :, None] == union[:, None, :]  # [B, 2F, 2F]
    occ_scores = (eq * base[:, None, :]).sum(-1)  # summed over matching slots
    missing = 1.0 / (k + fetch_k + 1)
    dup = eq.sum(-1) > 1  # appears in both lists
    scores = torch.where(dup, occ_scores, occ_scores + missing)
    # pads: the kernels emit INT_MAX for short result lists, callers may use -1
    valid = (union >= 0) & (union != INT_MAX)
    neg_inf = torch.tensor(-torch.inf, device=union.device)
    scores = torch.where(valid, scores, neg_inf)
    # dedup: keep first occurrence only
    scores = torch.where(_first_occurrence(eq), scores, neg_inf)
    return sort_topk(scores, union, top_k)


def fuse_batch_cc(
    ids_1,
    scores_1,
    ids_2,
    scores_2,
    weight: float,
    top_k: int,
    normalize_method: str = "mm",
    pipeline_1_min: float | None = None,
    pipeline_2_min: float | None = None,
):
    """Vectorized convex-combination fusion over padded candidate arrays
    [B, F] (pad ids < 0 or INT_MAX). Device variant of :func:`cc_fuse` with
    identical normalization/floor semantics, computed per query row in f32 on
    the device of ``ids_1``.

    Returns (fused scores [B, top_k], fused ids [B, top_k]).
    """
    ids_1 = torch.as_tensor(ids_1)
    dev = ids_1.device
    ids_2 = torch.as_tensor(ids_2).to(dev)
    scores_1, scores_2 = _as_scores(scores_1, dev), _as_scores(scores_2, dev)
    union = torch.cat([ids_1, ids_2], dim=1)  # [B, 2F]
    valid = (union >= 0) & (union != INT_MAX)
    # docs in both lists appear twice in the union; statistics must count each
    # doc once (the host fuser dedups via a set), so restrict to first
    # occurrences
    eq_union = union[:, :, None] == union[:, None, :]
    first_occ = _first_occurrence(eq_union) & valid
    nan = torch.tensor(torch.nan, device=dev)

    def lookup(ids_src, scores_src):
        # score of each union candidate in a source list; NaN = missing
        eq = union[:, :, None] == ids_src[:, None, :]  # [B, 2F, F]
        present = eq.any(-1) & valid
        val = (eq * scores_src[:, None, :]).sum(-1)
        return torch.where(present, val, nan)

    s1 = lookup(ids_1, scores_1)
    s2 = lookup(ids_2, scores_2)

    def norm(s, theo_min):
        m = ~torch.isnan(s) & first_occ
        cnt = m.sum(1, keepdim=True).clamp(min=1)
        if normalize_method in ("mm", "tmm"):
            hi = torch.where(m, s, -torch.inf).amax(1, keepdim=True)
            if normalize_method == "mm":
                lo = torch.where(m, s, torch.inf).amin(1, keepdim=True)
            else:
                lo = torch.full_like(hi, theo_min if theo_min is not None else 0.0)
            rng = hi - lo
            out = torch.where(rng == 0, 0.5, (s - lo) / torch.where(rng == 0, 1.0, rng))
        elif normalize_method in ("z", "dbsf"):
            mean = torch.where(m, s, 0.0).sum(1, keepdim=True) / cnt
            var = torch.where(m, (s - mean) ** 2, 0.0).sum(1, keepdim=True) / cnt
            std = torch.sqrt(var)
            if normalize_method == "z":
                out = torch.where(std == 0, 0.0, (s - mean) / torch.where(std == 0, 1.0, std))
            else:
                lo = mean - 3 * std
                out = torch.where(
                    std == 0, 0.5,
                    torch.clip((s - lo) / torch.where(std == 0, 1.0, 6 * std), 0.0, 1.0),
                )
        else:
            raise ValueError(f"unknown normalization method: {normalize_method}")
        floor = MISSING_SCORE_FLOORS[normalize_method]
        return torch.where(m, out, floor)

    fused = weight * norm(s1, pipeline_1_min) + (1 - weight) * norm(s2, pipeline_2_min)
    fused = torch.where(first_occ, fused, -torch.inf)
    return sort_topk(fused, union, top_k)
