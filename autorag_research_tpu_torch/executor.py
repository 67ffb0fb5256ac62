"""Experiment executor: run configured pipelines, evaluate applicable metrics.

Behavioral parity with the reference ``executor.py:99-583``:

- pipelines run sequentially; each gets (1) an optional health check — a
  temporary ``"<name>_health_check"`` pipeline run over N trial queries with
  metric evaluation, then full artifact cleanup (``executor.py:308-381``);
  (2) a retry loop around the real run (``:383-463``); (3) completion
  verification — every query must have result rows (``:465-481``); and
  (4) metric evaluation (``:483-583``).
- metric applicability: retrieval pipelines get retrieval metrics only;
  generation pipelines get both retrieval and generation metrics
  (``executor.py:108-111, 499-513``).
- results come back as ``PipelineResult``/``MetricResult``/``ExecutorResult``
  dataclasses (``:32-96``).

The port's copy of the JAX package's ``executor.py``. With no build context
it builds ``BuildContext()``, whose pipelines run on the card (``"cuda"``);
a caller passes ``BuildContext(device="cpu")`` for the CPU.
"""

from __future__ import annotations

import logging
import time
import traceback
from dataclasses import dataclass, field
from typing import Any

from autorag_research_tpu_torch.config import BaseMetricConfig, BasePipelineConfig, BuildContext, ExecutorConfig
from autorag_research_tpu_torch.evaluation.service import (
    GenerationEvaluationService,
    RetrievalEvaluationService,
)
from autorag_research_tpu_torch.exceptions import HealthCheckError, NoQueryInDBError
from autorag_research_tpu_torch.pipelines.loader import PipelineLoader
from autorag_research_tpu_torch.store.catalog import Catalog
from autorag_research_tpu_torch.utils.profiling import SpanRecorder

logger = logging.getLogger("AutoRAG-Research-TPU")


@dataclass
class MetricResult:
    metric_name: str
    metric_type: str
    count: int = 0
    average: float | None = None
    error: str | None = None

    @property
    def success(self) -> bool:
        return self.error is None


@dataclass
class PipelineResult:
    name: str
    kind: str
    success: bool = False
    attempts: int = 0
    execution_time: float = 0.0
    stats: dict = field(default_factory=dict)
    error: str | None = None
    metrics: list[MetricResult] = field(default_factory=list)


@dataclass
class ExecutorResult:
    pipelines: list[PipelineResult] = field(default_factory=list)
    spans: dict[str, float] = field(default_factory=dict)
    """Aggregated wall-clock ms per executor stage (pipeline run, health
    check, each metric) — first-class tracing the reference lacks
    (SURVEY.md §5)."""

    @property
    def success(self) -> bool:
        return all(p.success for p in self.pipelines)

    def report(self) -> str:
        lines = []
        for p in self.pipelines:
            status = "ok" if p.success else f"FAILED ({p.error})"
            lines.append(f"pipeline {p.name} [{p.kind}]: {status} in {p.execution_time:.1f}s")
            for m in p.metrics:
                val = f"{m.average:.4f}" if m.average is not None else "n/a"
                suffix = "" if m.success else f"  ERROR: {m.error}"
                lines.append(f"  {m.metric_type}/{m.metric_name}: {val} over {m.count} queries{suffix}")
        return "\n".join(lines)


class Executor:
    def __init__(
        self,
        catalog: Catalog,
        config: ExecutorConfig,
        context: BuildContext | None = None,
    ):
        self.catalog = catalog
        self.config = config
        self.context = context or BuildContext()
        for pc in config.pipelines:
            self.context.pipeline_configs.setdefault(pc.name, pc)
        self.loader = PipelineLoader(catalog, self.context)
        self.retrieval_eval = RetrievalEvaluationService(catalog)
        self.generation_eval = GenerationEvaluationService(catalog)
        self.tracer = SpanRecorder()

    # ---------------------------------------------------------------- helpers
    def _metrics_for(self, kind: str) -> list[BaseMetricConfig]:
        if kind == "generation":
            return list(self.config.metrics)
        return [m for m in self.config.metrics if m.metric_type == "retrieval"]

    def _service_for(self, metric_type: str):
        return self.generation_eval if metric_type == "generation" else self.retrieval_eval

    # -------------------------------------------------------------------- run
    def run(self) -> ExecutorResult:
        if self.catalog.count("query") == 0:
            raise NoQueryInDBError("catalog has no queries")
        result = ExecutorResult()
        for pconfig in self.config.pipelines:
            result.pipelines.append(self._run_one(pconfig))
        result.spans = self.tracer.summary()
        return result

    def _run_one(self, pconfig: BasePipelineConfig) -> PipelineResult:
        pres = PipelineResult(name=pconfig.name, kind=pconfig.kind)
        start = time.monotonic()
        try:
            if self.config.health_check:
                with self.tracer.span(f"{pconfig.name}/health_check"):
                    self._health_check(pconfig)
            with self.tracer.span(f"{pconfig.name}/run"):
                self._run_with_retry(pconfig, pres)
            if pres.success and self.config.evaluate:
                pipeline = self.loader.load(pconfig.name)
                for mconfig in self._metrics_for(pconfig.kind):
                    with self.tracer.span(f"{pconfig.name}/metric/{mconfig.name}"):
                        pres.metrics.append(
                            self._evaluate_metric(pipeline, pconfig, mconfig)
                        )
        except Exception as exc:  # noqa: BLE001 - per-pipeline isolation
            logger.error("pipeline %s failed: %s", pconfig.name, traceback.format_exc())
            pres.error = f"{type(exc).__name__}: {exc}"
            pres.success = False
        pres.execution_time = time.monotonic() - start
        return pres

    # ----------------------------------------------------------- health check
    def _health_check(self, pconfig: BasePipelineConfig) -> None:
        """Dry-run a temp clone of the pipeline on N queries + evaluate metrics,
        then remove every artifact (reference ``executor.py:308-381``)."""
        import copy

        hc_config = copy.copy(pconfig)
        hc_config.name = f"{pconfig.name}_health_check"
        hc_config.query_limit = self.config.health_check_queries
        # purge stale artifacts from a previous run killed mid-health-check
        # (resume-by-presence would otherwise skip everything and the
        # total_queries==0 probe would spuriously fail)
        stale = self.catalog.get_pipeline(hc_config.name)
        if stale is not None:
            self.catalog.delete_pipeline_artifacts(int(stale["id"]))
        hc_loader = PipelineLoader(self.catalog, self._hc_context(hc_config))
        pipeline = None
        try:
            pipeline = hc_loader.load(hc_config.name)
            stats = pipeline.run(**hc_config.run_kwargs())
            if stats.get("total_queries", 0) == 0 and not stats.get("failed_queries"):
                raise HealthCheckError(f"{pconfig.name}: health check processed no queries")
            if stats.get("failed_queries"):
                raise HealthCheckError(
                    f"{pconfig.name}: health check failed on queries {stats['failed_queries']}"
                )
            hc_query_ids = self._result_query_ids(pipeline)
            for mconfig in self._metrics_for(pconfig.kind):
                service = self._service_for(mconfig.metric_type)
                summary = service.evaluate(
                    pipeline.pipeline_id,
                    mconfig.name,
                    mconfig.metric_func(self.context),
                    granularity=mconfig.granularity,
                    query_ids=hc_query_ids,
                )
                if summary.count == 0:
                    # NOT an error (reference executor.py:280-288 fails only
                    # on metric exceptions): trial queries may legitimately
                    # return zero hits or lack GT for this metric
                    logger.info(
                        "health check: metric %s scored no trial queries for %s",
                        mconfig.name, pconfig.name,
                    )
        finally:
            if pipeline is not None:
                self.catalog.delete_pipeline_artifacts(pipeline.pipeline_id)

    def _hc_context(self, hc_config) -> BuildContext:
        ctx = BuildContext(
            device=self.context.device,
            models=self.context.models,
            pipeline_configs=dict(self.context.pipeline_configs),
        )
        ctx.pipeline_configs[hc_config.name] = hc_config
        return ctx

    def _result_query_ids(self, pipeline) -> list[Any]:
        ids = set(self.catalog.get_queries_with_results(pipeline.pipeline_id, "chunk"))
        ids |= self.catalog.get_queries_with_results(pipeline.pipeline_id, "image_chunk")
        ids |= self.catalog.get_queries_with_executor_results(pipeline.pipeline_id)
        return sorted(ids, key=str)

    # ------------------------------------------------------------------ retry
    def _run_with_retry(self, pconfig: BasePipelineConfig, pres: PipelineResult) -> None:
        last_error: str | None = None
        for attempt in range(self.config.max_retries + 1):
            pres.attempts = attempt + 1
            try:
                pipeline = self.loader.load(pconfig.name)
                stats = pipeline.run(**pconfig.run_kwargs())
                pres.stats = stats
                if self._verify_completion(pipeline, pconfig, stats):
                    pres.success = True
                    return
                last_error = f"incomplete: failed queries {stats.get('failed_queries')}"
            except Exception as exc:  # noqa: BLE001
                last_error = f"{type(exc).__name__}: {exc}"
                logger.warning(
                    "pipeline %s attempt %d failed: %s", pconfig.name, attempt + 1, last_error
                )
        pres.success = False
        pres.error = last_error

    def _verify_completion(self, pipeline, pconfig, stats) -> bool:
        """Every (limited) query must have persisted rows OR have been
        processed with legitimately empty results this run (reference
        ``executor.py:465-481``; the empty-result case would otherwise fail
        verification forever)."""
        if stats.get("failed_queries"):
            return False
        expected = self.catalog.get_all_query_ids()
        if pconfig.query_limit is not None:
            expected = expected[: pconfig.query_limit]
        done = set(self._result_query_ids(pipeline))
        done |= set(stats.get("empty_queries", []))
        return set(expected) <= done

    # ------------------------------------------------------------ evaluation
    def _evaluate_metric(
        self, pipeline, pconfig: BasePipelineConfig, mconfig: BaseMetricConfig
    ) -> MetricResult:
        mres = MetricResult(metric_name=mconfig.name, metric_type=mconfig.metric_type)
        try:
            service = self._service_for(mconfig.metric_type)
            query_ids = None
            if pconfig.query_limit is not None:
                query_ids = self.catalog.get_all_query_ids()[: pconfig.query_limit]
            summary = service.evaluate(
                pipeline.pipeline_id,
                mconfig.name,
                mconfig.metric_func(self.context),
                granularity=mconfig.granularity,
                query_ids=query_ids,
            )
            mres.count = summary.count
            mres.average = summary.average
        except Exception as exc:  # noqa: BLE001
            logger.error("metric %s failed: %s", mconfig.name, traceback.format_exc())
            mres.error = f"{type(exc).__name__}: {exc}"
        return mres
