"""Named pipeline resolution with nested-dependency + cycle detection.

Behavioral parity with the reference ``pipelines/retrieval/loader.py:21-132``:
wrapper pipelines reference other pipelines by name via config fields
(``retrieval_pipeline_name``, ``inner_retrieval_pipeline_name``,
``retrieval_pipeline_1_name`` / ``_2_name``); the loader resolves them
recursively, caches instances per experiment so two hybrids can share a BM25
sub-pipeline, and rejects cycles. The port's copy of the JAX package's
``pipelines/loader.py``.
"""

from __future__ import annotations

from typing import Any

from autorag_research_tpu_torch.config import BasePipelineConfig, BuildContext
from autorag_research_tpu_torch.exceptions import PipelineCycleError, PipelineNotFoundError

DEPENDENCY_FIELDS = (
    "retrieval_pipeline_name",
    "inner_retrieval_pipeline_name",
    "retrieval_pipeline_1_name",
    "retrieval_pipeline_2_name",
    "base_retrieval_pipeline_name",
    "complementary_retrieval_pipeline_name",
    "candidate_retrieval_pipeline_name",
    "sparse_retrieval_pipeline_name",
)


class PipelineLoader:
    def __init__(self, catalog, context: BuildContext):
        self.catalog = catalog
        self.context = context
        self.context.loader = self  # wrapper configs resolve deps through this
        self._cache: dict[str, Any] = {}
        self._stack: tuple[str, ...] = ()

    def load(self, name: str) -> Any:
        if name in self._cache:
            return self._cache[name]
        if name in self._stack:
            raise PipelineCycleError(" -> ".join((*self._stack, name)))
        config = self.context.pipeline_configs.get(name)
        if config is None:
            raise PipelineNotFoundError(name)
        prev = self._stack
        self._stack = (*self._stack, name)
        try:
            # config.build() may call context.loader.load(<dep name>) for its
            # wrapped pipelines — recursion shares this loader's cache/stack.
            pipeline = config.build(self.catalog, self.context)
        finally:
            self._stack = prev
        self._cache[name] = pipeline
        return pipeline

    def load_config(self, config: BasePipelineConfig) -> Any:
        """Build from an explicit config (registering it by name first)."""
        self.context.pipeline_configs.setdefault(config.name, config)
        return self.load(config.name)
