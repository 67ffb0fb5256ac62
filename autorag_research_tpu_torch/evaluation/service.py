"""Evaluation engine: metric-agnostic scoring over persisted pipeline results.

Behavioral parity with the reference evaluation services
(``orm/service/base_evaluation.py:120-513``, ``retrieval_evaluation.py:161-217``,
``generation_evaluation.py:104-209``):

- granularity ``"query"``: paginate queries, skip already-evaluated
  (pipeline, metric, query) triples, score incrementally, persist per-query
  ``EvaluationResult`` rows;
- granularity ``"dataset"``: delete existing rows for the (pipeline, metric),
  collect ALL inputs, score in one call (for corpus-level metrics);
- retrieval inputs: retrieved ids from both result tables, prefixed
  ``chunk_``/``image_chunk_``, sorted by rel_score desc; AND/OR ground truth +
  graded relevance from relation rows;
- generation inputs: generated text + generation_gt + retrieved contents
  resolved through the evidence-metadata contract
  (``context_chunk_ids`` canonical, legacy fallbacks, then persisted
  retrieval rows).

The port's copy of the JAX package's ``evaluation/service.py``: host code
over the port's catalog.
"""

from __future__ import annotations

import json
import logging
from collections.abc import Callable
from dataclasses import dataclass
from typing import Any

from autorag_research_tpu_torch.schema import (
    GENERATION_CONTEXT_CHUNK_ID_KEYS,
    GENERATION_LEGACY_RETRIEVED_CHUNK_ID_KEYS,
    MetricInput,
)
from autorag_research_tpu_torch.store.catalog import Catalog
from autorag_research_tpu_torch.store.gt import build_retrieval_gt_from_relations

logger = logging.getLogger("AutoRAG-Research-TPU")


@dataclass
class EvaluationSummary:
    metric_id: int
    count: int
    average: float | None


class BaseEvaluationService:
    metric_type = "unknown"

    def __init__(self, catalog: Catalog):
        self.catalog = catalog

    # -------------------------------------------------------------- interface
    def build_metric_input(self, query_row, pipeline_id: int) -> MetricInput:
        raise NotImplementedError

    def evaluate(
        self,
        pipeline_id: int,
        metric_name: str,
        metric_func: Callable[[list[MetricInput]], list[float | None]],
        batch_size: int = 128,
        granularity: str = "query",
        query_ids: list[Any] | None = None,
    ) -> EvaluationSummary:
        metric_id = self.catalog.get_or_create_metric(metric_name, self.metric_type)
        if granularity == "dataset":
            summary = self._evaluate_dataset(pipeline_id, metric_id, metric_func, query_ids)
        else:
            summary = self._evaluate_per_query(
                pipeline_id, metric_id, metric_func, batch_size, query_ids
            )
        return summary

    # --------------------------------------------------------------- engines
    def _iter_query_rows(self, batch_size: int, query_ids):
        if query_ids is not None:
            # explicit id list (health checks etc.): direct fetch instead of
            # paginating the whole table
            ids = list(query_ids)
            for lo in range(0, len(ids), batch_size):
                chunk = ids[lo : lo + batch_size]
                qs = ",".join("?" for _ in chunk)
                rows = self.catalog.connect().execute(
                    f"SELECT * FROM query WHERE id IN ({qs}) ORDER BY id", chunk
                ).fetchall()
                if rows:
                    yield rows
            return
        offset = 0
        while True:
            rows = self.catalog.get_queries(limit=batch_size, offset=offset)
            if not rows:
                return
            offset += len(rows)
            yield rows

    def _evaluate_per_query(
        self, pipeline_id, metric_id, metric_func, batch_size, query_ids
    ) -> EvaluationSummary:
        done = self.catalog.get_evaluated_query_ids(pipeline_id, metric_id)
        for rows in self._iter_query_rows(batch_size, query_ids):
            pending = [r for r in rows if r["id"] not in done]
            if not pending:
                continue
            inputs = [self.build_metric_input(r, pipeline_id) for r in pending]
            values = metric_func(inputs)
            # persist only SCORED queries (reference _evaluate_query_level
            # filters 'score is not None'): a None means not-evaluable-yet
            # (missing GT / missing executor result) and must be RETRIED on
            # the next run, not counted as done forever
            self.catalog.add_evaluation_results(
                pipeline_id,
                metric_id,
                [
                    (r["id"], float(v))
                    for r, v in zip(pending, values, strict=True)
                    if v is not None
                ],
            )
        return self._summarize(pipeline_id, metric_id, query_ids)

    def _evaluate_dataset(
        self, pipeline_id, metric_id, metric_func, query_ids
    ) -> EvaluationSummary:
        # whole-set metrics are delete-and-recompute over the FULL query set
        # (reference ``base_evaluation.py:418-456`` iterates every query):
        # recomputing only a query_ids window after the delete would destroy
        # a prior full run's persisted rows. The window still scopes the
        # REPORTED average via _summarize below.
        self.catalog.delete_evaluation_results(pipeline_id, metric_id)
        all_rows: list[Any] = []
        for rows in self._iter_query_rows(512, None):
            all_rows.extend(rows)
        if not all_rows:
            return EvaluationSummary(metric_id, 0, None)
        inputs = [self.build_metric_input(r, pipeline_id) for r in all_rows]
        values = metric_func(inputs)
        self.catalog.add_evaluation_results(
            pipeline_id,
            metric_id,
            [
                (r["id"], float(v))
                for r, v in zip(all_rows, values, strict=True)
                if v is not None
            ],
        )
        return self._summarize(pipeline_id, metric_id, query_ids)

    def _summarize(self, pipeline_id, metric_id, query_ids=None) -> EvaluationSummary:
        """Average over the evaluated window. With an explicit query_ids
        window, only that window's rows count (a prior full run's rows must
        not contaminate a limited run's report); the persisted Summary row is
        only refreshed by full-set evaluations."""
        values = self.catalog.get_evaluation_values(pipeline_id, metric_id, query_ids)
        avg = sum(values) / len(values) if values else None
        if avg is not None and query_ids is None:
            self.catalog.upsert_summary(pipeline_id, metric_id, avg, len(values))
        return EvaluationSummary(metric_id, len(values), avg)

    def verify_completion(self, pipeline_id, metric_id, query_ids=None) -> bool:
        expected = set(query_ids) if query_ids is not None else set(self.catalog.get_all_query_ids())
        return expected <= self.catalog.get_evaluated_query_ids(pipeline_id, metric_id)

    # ------------------------------------------------------------ shared bits
    def _retrieved_prefixed(self, query_id, pipeline_id) -> list[str]:
        """Both result tables, prefixed, globally sorted by rel_score desc
        (reference ``retrieval_evaluation.py:197-205``)."""
        merged = [
            (float(r["rel_score"]) if r["rel_score"] is not None else 0.0, f"chunk_{r['doc_id']}")
            for r in self.catalog.get_retrieved(query_id, pipeline_id, "chunk")
        ] + [
            (float(r["rel_score"]) if r["rel_score"] is not None else 0.0, f"image_chunk_{r['doc_id']}")
            for r in self.catalog.get_retrieved(query_id, pipeline_id, "image_chunk")
        ]
        merged.sort(key=lambda t: -t[0])
        return [pid for _, pid in merged]

    def _gt_for_query(self, query_id):
        rels = [dict(r) for r in self.catalog.get_relations_by_query(query_id)]
        return build_retrieval_gt_from_relations(rels)


class RetrievalEvaluationService(BaseEvaluationService):
    metric_type = "retrieval"

    def build_metric_input(self, query_row, pipeline_id: int) -> MetricInput:
        gt, scores = self._gt_for_query(query_row["id"])
        return MetricInput(
            query=query_row["contents"],
            retrieval_gt=gt or None,
            relevance_scores=scores or None,
            retrieved_ids=self._retrieved_prefixed(query_row["id"], pipeline_id) or None,
        )


class GenerationEvaluationService(BaseEvaluationService):
    metric_type = "generation"

    def build_metric_input(self, query_row, pipeline_id: int) -> MetricInput:
        qid = query_row["id"]
        res = self.catalog.get_executor_result(qid, pipeline_id)
        generated = res["generation_result"] if res else None
        metadata = {}
        if res and res["result_metadata"]:
            try:
                metadata = json.loads(res["result_metadata"])
            except (TypeError, ValueError):
                metadata = {}

        retrieved_contents = self._resolve_evidence_contents(qid, pipeline_id, metadata)
        gt, scores = self._gt_for_query(qid)
        gt_contents = self._gt_contents(gt)
        generation_gt = None
        raw_gt = query_row["generation_gt"]
        if raw_gt:
            try:
                parsed = json.loads(raw_gt)
            except (TypeError, ValueError):
                parsed = None
            if isinstance(parsed, list):
                generation_gt = [str(a) for a in parsed if a is not None]
            else:
                # a bare scalar answer ('2019', 'true', '"Paris"') parses
                # to a non-list — treat the RAW stored string as one answer
                # instead of crashing or iterating it character-wise
                generation_gt = [str(raw_gt)]
        return MetricInput(
            query=query_row["contents"],
            generated_texts=generated,
            generation_gt=generation_gt or None,
            retrieved_contents=retrieved_contents or None,
            retrieval_gt=gt or None,
            relevance_scores=scores or None,
            retrieval_gt_contents=gt_contents or None,
        )

    def _resolve_evidence_contents(self, qid, pipeline_id, metadata: dict) -> list[str]:
        """Evidence resolution order (reference
        ``generation_evaluation.py:138-199``): canonical/alias metadata keys ->
        persisted retrieval rows -> legacy metadata keys."""
        for key in GENERATION_CONTEXT_CHUNK_ID_KEYS:
            if key in metadata:
                # the first PRESENT key decides (reference
                # _get_metadata_chunk_ids): an explicit [] means the
                # generator USED no context — falling through to persisted
                # retrieval rows would score faithfulness against evidence
                # it never conditioned on
                return self._contents_for(metadata[key] or [])
        rows = self.catalog.get_retrieved(qid, pipeline_id, "chunk")
        if rows:
            return self._contents_for([r["doc_id"] for r in rows])
        for key in GENERATION_LEGACY_RETRIEVED_CHUNK_ID_KEYS:
            if key in metadata:
                return self._contents_for(metadata[key] or [])
        return []

    def _contents_for(self, chunk_ids) -> list[str]:
        # dedup preserving order and drop Nones (reference
        # _deduplicate_chunk_ids) — repeated ids from multi-round pipelines
        # would double-count context text
        ids = list(dict.fromkeys(c for c in chunk_ids if c is not None))
        if not ids:
            return []
        lookup = dict(self.catalog.get_chunk_contents(ids))
        # json round-trips stringify non-native id types; catalog PKs may be
        # int — remap like _gt_contents does or stringified ids drop evidence
        int_forms = []
        for cid in ids:
            if cid not in lookup and isinstance(cid, str):
                try:
                    int_forms.append(int(cid))
                except ValueError:
                    pass
        if int_forms:
            for k, v in self.catalog.get_chunk_contents(int_forms).items():
                lookup[str(k)] = v
        return [lookup[cid] for cid in ids if cid in lookup]

    def _gt_contents(self, gt: list[list[str]]) -> list[list[str]]:
        """Resolve text contents per GT group; image ids have no text and are
        skipped (grouping mirrors ``generation_evaluation.py:181-189``).
        One batched lookup covers all groups (string + int id forms both
        queried once — catalog PKs may be either)."""
        per_group_ids: list[list[str]] = [
            [pid.removeprefix("chunk_") for pid in group if pid.startswith("chunk_")]
            for group in gt
        ]
        all_ids = [cid for group in per_group_ids for cid in group]
        if not all_ids:
            return []
        lookup = dict(self.catalog.get_chunk_contents(all_ids))
        int_forms = []
        for cid in all_ids:
            if cid not in lookup:
                try:
                    int_forms.append(int(cid))
                except (TypeError, ValueError):
                    pass
        if int_forms:
            for k, v in self.catalog.get_chunk_contents(int_forms).items():
                lookup[str(k)] = v
        out = []
        for group_ids in per_group_ids:
            resolved = [lookup[cid] for cid in group_ids if cid in lookup]
            if resolved:
                out.append(resolved)
        return out
