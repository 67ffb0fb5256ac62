"""Generation pipeline base + batch run engine.

Behavioral parity with the reference (``pipelines/generation/base.py:21-147``
+ ``orm/service/generation_pipeline.py:128-258``):

- composition: a generation pipeline *has a* retrieval pipeline and an LLM;
- subclasses implement async ``_generate(query_id, top_k) ->
  GenerationResult(text, token_usage, metadata)``;
- ``run()`` paginates queries, skips those with persisted results (resume),
  fans out under a concurrency limit with retries, records per-query
  wall-clock ``execution_time`` in ms, and persists
  ``ExecutorResult(generation_result, token_usage, execution_time,
  result_metadata)``;
- result metadata MUST carry the final evidence ids under
  ``context_chunk_ids`` (contract in ``schema.py``).

The port's copy of the JAX package's ``pipelines/generation/base.py``.
"""

from __future__ import annotations

import logging
import time
from abc import abstractmethod
from dataclasses import dataclass, field
from typing import Any

from autorag_research_tpu_torch.pipelines.base import BasePipeline
from autorag_research_tpu_torch.schema import GENERATION_CONTEXT_CHUNK_ID_KEY
from autorag_research_tpu_torch.utils.concurrency import RetryPolicy, run_async, run_with_concurrency_limit

logger = logging.getLogger("AutoRAG-Research-TPU")


def select_top_evidence(evidence: dict[Any, float], k: int) -> list[Any]:
    """Deterministic evidence selection by the repo-wide ``(-score, doc_id)``
    order, which every selection keeps. Sorting by score alone lets tied docs fall
    back to dict INSERTION order, which varies with retriever shard count —
    the persisted context_chunk_ids would then differ across device meshes."""
    return sorted(evidence, key=lambda d: (-evidence[d], d))[:k]


@dataclass
class GenerationResult:
    text: str
    token_usage: dict[str, int] | None = None
    metadata: dict[str, Any] = field(default_factory=dict)
    retrieved: list[dict[str, Any]] | None = None
    """Final retrieval hits ({"doc_id", "score"}). When set, the run loop
    persists them under THIS pipeline's id so retrieval metrics evaluate
    against what the generator actually used. (The reference stores only
    metadata ids and leaves the generation pipeline's retrieved-result table
    empty — its retrieval metrics on generation pipelines read empty sets,
    ``orm/service/retrieval_evaluation.py:161-217``; persisting here is a
    deliberate improvement.)"""


class BaseGenerationPipeline(BasePipeline):
    def __init__(self, catalog, name: str, retrieval_pipeline=None, llm=None):
        self.retrieval_pipeline = retrieval_pipeline
        self.llm = llm
        super().__init__(catalog, name)

    # ------------------------------------------------------------- interface
    @abstractmethod
    async def _generate(self, query_id: Any, top_k: int) -> GenerationResult:
        ...

    def get_query_text(self, query_id: Any) -> str:
        text = self.catalog.get_query_text(query_id)
        if text is None:
            raise ValueError(f"query {query_id} not found")
        return text

    def get_chunk_contents(self, chunk_ids) -> list[str]:
        lookup = self.catalog.get_chunk_contents(list(chunk_ids))
        return [lookup[cid] for cid in chunk_ids if cid in lookup]

    async def retrieve_for(self, query_id: Any, top_k: int) -> list[dict[str, Any]]:
        """Retrieve evidence via the composed retrieval pipeline. Prefers the
        stored-embedding id path; ad-hoc queries without embeddings (e.g.
        staged by the serving layer) fall back to text retrieval."""
        if self.retrieval_pipeline is None:
            return []
        from autorag_research_tpu_torch.exceptions import EmbeddingMissingError

        try:
            return await self.retrieval_pipeline._retrieve_by_id(query_id, top_k)
        except EmbeddingMissingError:
            text = self.catalog.get_query_text(query_id)
            if text is None:
                raise
            return await self.retrieval_pipeline._retrieve_by_text(text, top_k)

    # -------------------------------------------------------------------- run
    def run(
        self,
        top_k: int = 10,
        batch_size: int = 32,
        max_concurrency: int = 16,
        max_retries: int = 3,
        retry_delay: float = 1.0,
        query_limit: int | None = None,
    ) -> dict[str, Any]:
        completed = self.catalog.get_queries_with_executor_results(self.pipeline_id)
        # fixed first-N window, matching verification/evaluation (see the
        # retrieval engine's note)
        allowed = (
            set(self.catalog.get_all_query_ids()[:query_limit])
            if query_limit is not None
            else None
        )
        total = 0
        failed: list[Any] = []
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

            async def one(qid):
                start = time.perf_counter()
                result = await self._generate(qid, top_k)
                elapsed_ms = (time.perf_counter() - start) * 1000.0
                return qid, result, elapsed_ms

            async def runner():
                return await run_with_concurrency_limit(
                    pending,
                    one,
                    max_concurrency=max_concurrency,
                    retry=RetryPolicy(max_attempts=max_retries, base_delay=retry_delay),
                )

            for qid, outcome in zip(pending, run_async(runner())):
                if isinstance(outcome, BaseException):
                    logger.warning("generation failed for query %s: %s", qid, outcome)
                    failed.append(qid)
                    continue
                _, result, elapsed_ms = outcome
                metadata = dict(result.metadata)
                metadata.setdefault(GENERATION_CONTEXT_CHUNK_ID_KEY, [])
                if result.retrieved:
                    # route by the composed retriever's unit (image pipelines
                    # must land in the image result table or metrics zero out)
                    unit = getattr(self.retrieval_pipeline, "retrieval_unit", "chunk")
                    if unit in ("chunk", "image_chunk"):
                        # a crash AFTER this insert but BEFORE the executor
                        # result commits leaves the query pending; the resumed
                        # attempt may retrieve a different (LLM-driven) doc
                        # set — clear the stale rows or metrics evaluate the
                        # contaminated union
                        self.catalog.delete_retrieved_for_query(
                            qid, self.pipeline_id, unit
                        )
                        self.catalog.add_retrieved_results(
                            self.pipeline_id,
                            [
                                (qid, h["doc_id"], float(h.get("score", 0.0)))
                                for h in result.retrieved
                            ],
                            unit,
                        )
                self.catalog.add_executor_result(
                    qid,
                    self.pipeline_id,
                    result.text,
                    token_usage=result.token_usage,
                    execution_time=elapsed_ms,
                    result_metadata=metadata,
                )
                total += 1
        return {
            "pipeline_id": self.pipeline_id,
            "total_queries": total,
            "total_results": total,
            "failed_queries": failed,
        }
