"""Typed experiment configuration.

Role parity with the reference ``config.py:34-298`` (pipeline/metric config
dataclasses) and its Hydra ``_target_`` instantiation
(``cli/commands/run.py:144-156``), re-designed without Hydra: configs are
plain dataclasses registered under a ``type`` name; YAML files carry
``type: <name>`` plus constructor kwargs. Generation configs name their LLM
and retrieval pipeline; resolution happens in the loader (``pipelines/loader.py``)
with the same nested-dependency + cycle-detection semantics as the reference
``pipelines/retrieval/loader.py:21-132``.

The port's copy of the JAX package's ``config.py``. Its registry is its own
dict, so a process that imports both packages resolves each package's
``from_dict({"type": ...})`` to that package's class. ``BuildContext`` takes
the ``device`` every built pipeline runs on (``"cuda"`` unless the caller
asks for another) where the JAX package takes a mesh.
"""

from __future__ import annotations

from dataclasses import dataclass, field, fields
from typing import Any, Callable, ClassVar

from autorag_research_tpu_torch.evaluation.metrics.retrieval import RETRIEVAL_METRICS
from autorag_research_tpu_torch.exceptions import MetricNotFoundError


@dataclass(kw_only=True)
class BasePipelineConfig:
    """Common pipeline knobs (reference ``BasePipelineConfig`` ``config.py:34-105``)."""

    name: str
    top_k: int = 10
    batch_size: int = 128
    max_concurrency: int = 16
    max_retries: int = 3
    retry_delay: float = 1.0
    query_limit: int | None = None

    registry: ClassVar[dict[str, type["BasePipelineConfig"]]] = {}
    config_type: ClassVar[str] = ""
    kind: ClassVar[str] = "retrieval"  # "retrieval" | "generation"

    def __init_subclass__(cls, **kw):
        super().__init_subclass__(**kw)
        if getattr(cls, "config_type", ""):
            BasePipelineConfig.registry[cls.config_type] = cls

    # ------------------------------------------------------------------ build
    def build(self, catalog, context: "BuildContext") -> Any:
        """Instantiate the pipeline object against a catalog."""
        raise NotImplementedError

    def run_kwargs(self) -> dict:
        return {
            "top_k": self.top_k,
            "batch_size": self.batch_size,
            "max_concurrency": self.max_concurrency,
            "max_retries": self.max_retries,
            "retry_delay": self.retry_delay,
            "query_limit": self.query_limit,
        }

    @classmethod
    def from_dict(cls, data: dict) -> "BasePipelineConfig":
        data = dict(data)
        type_name = data.pop("type")
        sub = BasePipelineConfig.registry.get(type_name)
        if sub is None:
            raise KeyError(
                f"unknown pipeline type '{type_name}'; known: {sorted(BasePipelineConfig.registry)}"
            )
        allowed = {f.name for f in fields(sub)}
        unknown = set(data) - allowed
        if unknown:
            raise TypeError(f"unknown keys for {type_name}: {sorted(unknown)}")
        return sub(**data)


@dataclass(kw_only=True)
class BaseMetricConfig:
    """Metric name + kwargs + compute granularity (reference
    ``BaseMetricConfig.get_metric_func/get_compute_granularity``
    ``config.py:180-244``)."""

    name: str
    metric_type: str = "retrieval"  # "retrieval" | "generation"
    granularity: str = "query"  # "query" | "dataset"
    kwargs: dict = field(default_factory=dict)

    def metric_func(self, context: "BuildContext") -> Callable:
        if self.metric_type == "retrieval":
            fn = RETRIEVAL_METRICS.get(self.name)
        else:
            from autorag_research_tpu_torch.evaluation.metrics.generation import (
                GENERATION_METRICS,
            )

            fn = GENERATION_METRICS.get(self.name)
        if fn is None:
            raise MetricNotFoundError(f"{self.metric_type} metric '{self.name}'")
        kwargs = dict(self.kwargs)
        kwargs.update(context.metric_extras(self))
        if kwargs:
            return lambda inputs: fn(inputs, **kwargs)
        return fn

    @classmethod
    def from_dict(cls, data: dict) -> "BaseMetricConfig":
        return cls(**data)


class BuildContext:
    """Shared build-time services: model loading, device, mesh, named pipeline
    lookup. With a ``mesh`` (``parallel/mesh.py``) the retrieval pipelines
    shard their indexes over its corpus axis."""

    def __init__(self, device="cuda", models=None, pipeline_configs=None, mesh=None):
        self.device = device
        self.mesh = mesh
        self.models = models  # a model registry (load_embedding / load_llm / load_reranker) | None
        self.pipeline_configs: dict[str, BasePipelineConfig] = pipeline_configs or {}
        self.loader = None  # set by PipelineLoader; used by wrapper configs

    def load_pipeline(self, name: str):
        """Resolve a named sub-pipeline through the active loader."""
        if self.loader is None:
            raise ValueError(f"no pipeline loader active to resolve '{name}'")
        return self.loader.load(name)

    def load_embedding(self, name_or_obj):
        if name_or_obj is None or not isinstance(name_or_obj, str):
            return name_or_obj
        if self.models is None:
            raise ValueError(f"no model registry to resolve embedding '{name_or_obj}'")
        return self.models.load_embedding(name_or_obj)

    def load_llm(self, name_or_obj):
        if name_or_obj is None or not isinstance(name_or_obj, str):
            return name_or_obj
        if self.models is None:
            raise ValueError(f"no model registry to resolve llm '{name_or_obj}'")
        return self.models.load_llm(name_or_obj)

    def load_reranker(self, name_or_obj):
        if name_or_obj is None or not isinstance(name_or_obj, str):
            return name_or_obj
        if self.models is None:
            raise ValueError(f"no model registry to resolve reranker '{name_or_obj}'")
        return self.models.load_reranker(name_or_obj)

    def metric_extras(self, metric_config: BaseMetricConfig) -> dict:
        """Resolve llm/embedding names inside metric kwargs (the reference's
        @with_llm/@with_embedding decorators, ``injection.py:344-370``), and
        give a model-backed generation metric this context's device unless
        its kwargs name one."""
        extras = {}
        if metric_config.metric_type == "generation" and "device" not in metric_config.kwargs:
            from autorag_research_tpu_torch.evaluation.metrics.generation import (
                MODEL_SCORER_METRICS,
            )

            if metric_config.name in MODEL_SCORER_METRICS:
                extras["device"] = str(self.device)
        for key in ("llm", "embedding_model", "reranker"):
            if key in metric_config.kwargs:
                val = metric_config.kwargs[key]
                if isinstance(val, str):
                    loader = {
                        "llm": self.load_llm,
                        "embedding_model": self.load_embedding,
                        "reranker": self.load_reranker,
                    }[key]
                    extras[key] = loader(val)
        return extras


@dataclass(kw_only=True)
class ExecutorConfig:
    """Experiment spec: pipelines + metrics + health-check knobs (reference
    ``ExecutorConfig`` ``config.py:267-298``)."""

    pipelines: list[BasePipelineConfig] = field(default_factory=list)
    metrics: list[BaseMetricConfig] = field(default_factory=list)
    health_check: bool = True
    health_check_queries: int = 2
    max_retries: int = 1
    evaluate: bool = True
