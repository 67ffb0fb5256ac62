"""Retrieval pipeline base + the batched run engine.

Behavioral parity with the reference's pipeline/run contract
(``pipelines/retrieval/base.py:49-199`` + the batch engine in
``orm/service/retrieval_pipeline.py:184-307``): paginated query fetch,
skip-already-completed resume, per-query failure isolation, persistence routed
by ``retrieval_unit``, and a stats dict
``{pipeline_id, total_queries, total_results, failed_queries}``.

The accelerator-shaped difference: the hot path is *batch-first*. Device pipelines
(vector search, BM25, MaxSim) override ``_retrieve_batch_by_ids`` to score an
entire query batch in one kernel launch; only LLM-wrapper pipelines fall back
to the base implementation, which fans out per-query ``_retrieve_by_id``
coroutines under a concurrency limit with retries — the reference's model,
where it is the right one.
"""

from __future__ import annotations

import logging
from abc import abstractmethod
from typing import Any

from autorag_research_tpu_torch.exceptions import RetrievalUnitError
from autorag_research_tpu_torch.pipelines.base import BasePipeline
from autorag_research_tpu_torch.utils.concurrency import RetryPolicy, run_async, run_with_concurrency_limit

logger = logging.getLogger("AutoRAG-Research-TPU")

VALID_RETRIEVAL_UNITS = ("chunk", "image_chunk", "mixed")


class BaseRetrievalPipeline(BasePipeline):
    retrieval_unit: str = "chunk"

    def __init__(self, catalog, name: str):
        if self.retrieval_unit not in VALID_RETRIEVAL_UNITS:
            raise RetrievalUnitError(f"invalid retrieval_unit: {self.retrieval_unit}")
        super().__init__(catalog, name)

    # -------------------------------------------------------------- retrieval
    @abstractmethod
    async def _retrieve_by_id(self, query_id: Any, top_k: int) -> list[dict[str, Any]]:
        """Retrieve for one catalog query id -> [{"doc_id", "score"}, ...]."""

    @abstractmethod
    async def _retrieve_by_text(self, query_text: str, top_k: int) -> list[dict[str, Any]]:
        """Retrieve for ad-hoc text (may embed on the fly)."""

    async def retrieve(self, query_text: str, top_k: int = 10) -> list[dict[str, Any]]:
        """Single-query entry used by generation pipelines: prefer stored
        embeddings when the text matches a catalog query."""
        rows = self.catalog.find_queries_by_contents(query_text)
        if rows:
            return await self._retrieve_by_id(rows[0]["id"], top_k)
        return await self._retrieve_by_text(query_text, top_k)

    def _retrieve_batch_by_ids(
        self,
        query_ids: list[Any],
        top_k: int,
        max_concurrency: int = 16,
        max_retries: int = 3,
        retry_delay: float = 1.0,
    ) -> dict[Any, list[dict[str, Any]] | BaseException]:
        """Default batch engine: async fan-out of `_retrieve_by_id` with
        bounded concurrency and exponential-backoff retries. Device pipelines
        override this with a single batched kernel call."""

        async def runner():
            return await run_with_concurrency_limit(
                query_ids,
                lambda qid: self._retrieve_by_id(qid, top_k),
                max_concurrency=max_concurrency,
                retry=RetryPolicy(max_attempts=max_retries, base_delay=retry_delay),
            )

        results = run_async(runner())
        return dict(zip(query_ids, results))

    def _retrieve_batch_by_texts(
        self, texts: list[str], top_k: int
    ) -> list[list[dict[str, Any]]]:
        """Batched ad-hoc-text retrieval (the serving micro-batch path).
        Default: async fan-out of `_retrieve_by_text`. Device pipelines
        override with one embed + one kernel launch for the whole batch.

        Per-query failures are ISOLATED: one transient error (e.g. an LLM
        call inside a wrapper pipeline) returns empty results for that query
        instead of erroring the whole serving micro-batch — the batcher would
        otherwise stamp the error on every coalesced request."""
        import asyncio
        import logging

        async def gather():
            return await asyncio.gather(
                *[self._retrieve_by_text(t, top_k) for t in texts],
                return_exceptions=True,
            )

        out: list[list[dict[str, Any]]] = []
        for text, res in zip(texts, run_async(gather())):
            if isinstance(res, BaseException):
                logging.getLogger("AutoRAG-Research-TPU").warning(
                    "batched retrieval failed for %r: %s", text[:80], res
                )
                out.append([])
            else:
                out.append(res)
        return out

    # -------------------------------------------------------------------- run
    def run(
        self,
        top_k: int = 10,
        batch_size: int = 128,
        max_concurrency: int = 16,
        max_retries: int = 3,
        retry_delay: float = 1.0,
        query_limit: int | None = None,
    ) -> dict[str, Any]:
        if self.retrieval_unit == "mixed":
            raise RetrievalUnitError(
                "mixed retrieval_unit persistence is not supported; override run()"
            )
        unit = self.retrieval_unit
        completed = self.catalog.get_queries_with_results(self.pipeline_id, unit)
        # query_limit defines a FIXED window (the first N catalog query ids) so
        # retries/resumes never drift into out-of-window queries — the same
        # window completion verification and evaluation use
        allowed = (
            set(self.catalog.get_all_query_ids()[:query_limit])
            if query_limit is not None
            else None
        )

        total_queries = 0
        total_results = 0
        failed: list[Any] = []
        empty: list[Any] = []
        offset = 0
        while True:
            rows = self.catalog.get_queries(limit=batch_size, offset=offset)
            if not rows:
                break
            offset += len(rows)
            pending = [
                r["id"]
                for r in rows
                if r["id"] not in completed and (allowed is None or r["id"] in allowed)
            ]
            if not pending:
                continue
            batch = self._retrieve_batch_by_ids(
                pending, top_k, max_concurrency, max_retries, retry_delay
            )
            persist_rows = []
            for qid in pending:
                res = batch.get(qid)
                if isinstance(res, BaseException):
                    logger.warning("query %s failed: %s", qid, res)
                    failed.append(qid)
                    continue
                if res is None:
                    failed.append(qid)
                    continue
                total_queries += 1
                if not res:
                    # legitimately zero hits (e.g. no term overlap in BM25):
                    # nothing to persist, but the query IS processed
                    empty.append(qid)
                    continue
                for hit in res:
                    persist_rows.append((qid, hit["doc_id"], float(hit["score"])))
            if persist_rows:
                self.catalog.add_retrieved_results(self.pipeline_id, persist_rows, unit)
                total_results += len(persist_rows)

        if failed:
            logger.warning(
                "pipeline '%s': %d queries failed after retries: %s",
                self.name, len(failed), failed[:10],
            )
        return {
            "pipeline_id": self.pipeline_id,
            "total_queries": total_queries,
            "total_results": total_results,
            "failed_queries": failed,
            "empty_queries": empty,
        }
