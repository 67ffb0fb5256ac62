"""Retrieval metrics with AND/OR group semantics and graded relevance.

Exact behavioral parity with the reference
``evaluation/metrics/retrieval.py:11-227``:

- ``retrieval_gt`` is a 2-D list — outer = AND groups, inner = OR alternatives.
- recall = fraction of groups hit; precision = fraction of retrieved ids that
  hit any group; f1 harmonic of the two.
- ndcg: a retrieved item contributes to DCG only when it is the FIRST to
  satisfy a previously unsatisfied group; gain is ``2^rel - 1`` with graded
  relevance from ``relevance_scores`` (default 1); IDCG from the best score
  per group, sorted descending.
- full_recall: binary, 1.0 iff every group is satisfied.
- mrr: mean over groups of 1/rank of first hit (groups with no hit contribute
  nothing to the sum but the denominator is the number of groups).
- map: mean over groups of average precision against that group.

Implemented over plain Python sets (metric inputs are <= top_k ids; this is
not a hot path — the hot path is the device index).
"""

from __future__ import annotations

import itertools
import math
from collections.abc import Callable

from autorag_research_tpu_torch.evaluation.metrics.util import metric
from autorag_research_tpu_torch.schema import MetricInput


@metric(fields_to_check=["retrieval_gt"])
def retrieval_recall(metric_input: MetricInput) -> float:
    gt, pred = metric_input.retrieval_gt, metric_input.retrieved_ids
    if pred is None or gt is None:
        return 0.0
    pred_set = set(pred)
    hits = sum(1 for group in gt if pred_set & set(group))
    return hits / len(gt) if gt else 0.0


@metric(fields_to_check=["retrieval_gt"])
def retrieval_precision(metric_input: MetricInput) -> float:
    gt, pred = metric_input.retrieval_gt, metric_input.retrieved_ids
    if pred is None or gt is None:
        return 0.0
    gt_sets = [set(g) for g in gt]
    # NOTE: iterate over the *set* of predictions, as the reference does
    # (``retrieval.py:64-67`` uses ``pred_set``), so duplicate retrieved ids
    # count once in the numerator but the denominator is len(pred).
    hits = sum(1 for pid in set(pred) if any(pid in s for s in gt_sets))
    return hits / len(pred) if pred else 0.0


@metric(fields_to_check=["retrieval_gt"])
def retrieval_f1(metric_input: MetricInput) -> float:
    r = retrieval_recall.__wrapped__(metric_input)
    p = retrieval_precision.__wrapped__(metric_input)
    if r + p == 0:
        return 0.0
    return 2 * r * p / (r + p)


@metric(fields_to_check=["retrieval_gt"])
def retrieval_ndcg(metric_input: MetricInput) -> float:
    """AND/OR-group nDCG with graded relevance.

    Contract (reference ``retrieval.py:71-144``, bit-parity enforced by
    ``tests/test_reference_oracle.py``): a retrieved doc earns gain
    ``2^rel - 1`` at its rank iff it is the *first* doc in the ranking to
    satisfy some group; redundant hits of already-satisfied groups earn
    nothing. IDCG places each group's best achievable gain at the top ranks.

    Computed here as a group-satisfaction fold: per group, find the rank of
    its earliest hit; the set of those first-hit ranks is exactly the set of
    gain-earning positions (a doc first-hitting several groups at once still
    earns its gain once, since rank positions dedup).
    """
    gt, pred = metric_input.retrieval_gt, metric_input.retrieved_ids
    if pred is None or gt is None:
        return 0.0

    groups = [frozenset(it for it in g if it) for g in gt if g and g != [""]]
    if not groups:
        return 0.0

    grade = metric_input.relevance_scores or dict.fromkeys(
        itertools.chain.from_iterable(groups), 1
    )

    def gain_at(rank: int) -> float:
        return (2 ** grade.get(pred[rank], 0) - 1) / math.log2(rank + 2)

    earning_ranks = {
        rank
        for members in groups
        for rank in (next((r for r, d in enumerate(pred) if d in members), None),)
        if rank is not None
    }
    dcg = sum(gain_at(r) for r in earning_ranks)

    ideal_gains = sorted(
        (max((grade.get(it, 0) for it in members), default=0) for members in groups),
        reverse=True,
    )
    idcg = sum((2**s - 1) / math.log2(i + 2) for i, s in enumerate(ideal_gains))
    return dcg / idcg if idcg > 0 else 0.0


@metric(fields_to_check=["retrieval_gt"])
def retrieval_full_recall(metric_input: MetricInput) -> float:
    gt, pred = metric_input.retrieval_gt, metric_input.retrieved_ids
    if pred is None or gt is None:
        return 0.0
    pred_set = set(pred)
    return 1.0 if all(pred_set & set(group) for group in gt) else 0.0


@metric(fields_to_check=["retrieval_gt"])
def retrieval_mrr(metric_input: MetricInput) -> float:
    gt, pred = metric_input.retrieval_gt, metric_input.retrieved_ids
    if pred is None or gt is None:
        return 0.0
    rr_sum = 0.0
    any_hit = False
    for group in gt:
        group_set = set(group)
        for rank, pid in enumerate(pred):
            if pid in group_set:
                rr_sum += 1.0 / (rank + 1)
                any_hit = True
                break
    return rr_sum / len(gt) if any_hit else 0.0


@metric(fields_to_check=["retrieval_gt"])
def retrieval_map(metric_input: MetricInput) -> float:
    gt, pred = metric_input.retrieval_gt, metric_input.retrieved_ids
    if pred is None or gt is None:
        return 0.0
    ap_values = []
    for group in gt:
        group_set = set(group)
        hits = 0
        precisions = []
        for rank, pid in enumerate(pred):
            if pid in group_set:
                hits += 1
                precisions.append(hits / (rank + 1))
        ap_values.append(sum(precisions) / len(precisions) if precisions else 0.0)
    return sum(ap_values) / len(gt) if ap_values else 0.0


# ----------------------------------------------------------------- registry
RETRIEVAL_METRICS: dict[str, Callable] = {
    "recall": retrieval_recall,
    "full_recall": retrieval_full_recall,
    "precision": retrieval_precision,
    "f1": retrieval_f1,
    "ndcg": retrieval_ndcg,
    "mrr": retrieval_mrr,
    "map": retrieval_map,
}

