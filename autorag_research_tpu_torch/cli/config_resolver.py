"""Name-based YAML config resolution.

Role parity with the reference ``cli/config_resolver.py:23-96``: the
experiment file lists pipeline/metric *names*; each name maps to
``configs/pipelines/{retrieval,generation}/<name>.yaml`` or
``configs/metrics/{retrieval,generation}/<name>.yaml``, which carries
``type:`` + constructor kwargs (the Hydra ``_target_`` replacement — see
``config.BasePipelineConfig.from_dict``). Files may omit ``name``; it
defaults to the file stem.

The port's copy of the JAX package's ``cli/config_resolver.py``. It resolves
against the port's own config registry, which holds every retrieval and
generation pipeline; a file naming an unknown type is refused by
``BasePipelineConfig.from_dict``, as in the JAX package.
"""

from __future__ import annotations

from pathlib import Path

import yaml

from autorag_research_tpu_torch.config import BaseMetricConfig, BasePipelineConfig, ExecutorConfig
from autorag_research_tpu_torch.exceptions import MetricNotFoundError, PipelineNotFoundError

# importing the pipeline packages populates the config-type registry
import autorag_research_tpu_torch.pipelines.generation  # noqa: F401
import autorag_research_tpu_torch.pipelines.retrieval  # noqa: F401


class ConfigResolver:
    def __init__(self, config_dir: str | Path = "./configs"):
        self.config_dir = Path(config_dir)

    # -------------------------------------------------------------- pipelines
    def pipeline_path(self, kind: str, name: str) -> Path:
        return self.config_dir / "pipelines" / kind / f"{name}.yaml"

    def resolve_pipeline(self, kind: str, name: str) -> BasePipelineConfig:
        path = self.pipeline_path(kind, name)
        if not path.exists():
            raise PipelineNotFoundError(f"{name} (looked at {path})")
        data = yaml.safe_load(path.read_text()) or {}
        data.setdefault("name", name)
        return BasePipelineConfig.from_dict(data)

    def all_pipeline_names(self, kind: str) -> list[str]:
        d = self.config_dir / "pipelines" / kind
        return sorted(p.stem for p in d.glob("*.yaml")) if d.exists() else []

    # ---------------------------------------------------------------- metrics
    def resolve_metric(self, kind: str, name: str) -> BaseMetricConfig:
        path = self.config_dir / "metrics" / kind / f"{name}.yaml"
        if path.exists():
            data = yaml.safe_load(path.read_text()) or {}
            data.setdefault("name", name)
            data.setdefault("metric_type", kind)
            return BaseMetricConfig.from_dict(data)
        # bare metric names resolve directly to builtin metric functions
        try:
            return BaseMetricConfig(name=name, metric_type=kind)
        except Exception as exc:  # noqa: BLE001
            raise MetricNotFoundError(name) from exc

    # ------------------------------------------------------------- experiment
    def load_experiment(self, experiment_path: str | Path | None = None) -> ExecutorConfig:
        """Experiment YAML -> ExecutorConfig with all named configs resolved,
        including transitive wrapper dependencies."""
        path = Path(experiment_path) if experiment_path else self.config_dir / "experiment.yaml"
        spec = yaml.safe_load(path.read_text()) or {}
        pipelines: list[BasePipelineConfig] = []
        pspec = spec.get("pipelines", {})
        for kind in ("retrieval", "generation"):
            for name in pspec.get(kind, []) or []:
                pipelines.append(self.resolve_pipeline(kind, name))
        # resolve named dependencies not in the run list (wrappers reference
        # sub-pipelines by name; they must exist as configs too)
        extra = self.resolve_transitive_dependencies(pipelines)

        metrics = []
        mspec = spec.get("metrics", {})
        for kind in ("retrieval", "generation"):
            for name in mspec.get(kind, []) or []:
                metrics.append(self.resolve_metric(kind, name))

        executor_kwargs = spec.get("executor", {}) or {}
        config = ExecutorConfig(pipelines=pipelines, metrics=metrics, **executor_kwargs)
        config.extra_pipeline_configs = extra  # type: ignore[attr-defined]
        return config

    def resolve_transitive_dependencies(
        self, configs: list[BasePipelineConfig] | dict[str, BasePipelineConfig]
    ) -> dict[str, BasePipelineConfig]:
        """Resolve every named sub-pipeline a set of configs references
        (wrappers name their dependencies via DEPENDENCY_FIELDS), returning
        only the NEWLY resolved configs. Shared by experiment loading and
        serve_workspace so dependency semantics live in one place."""
        from autorag_research_tpu_torch.pipelines.loader import DEPENDENCY_FIELDS

        seed = list(configs.values()) if isinstance(configs, dict) else list(configs)
        extra: dict[str, BasePipelineConfig] = {}
        frontier = list(seed)
        known = {c.name for c in seed}
        while frontier:
            config = frontier.pop()
            for field_name in DEPENDENCY_FIELDS:
                dep = getattr(config, field_name, None)
                if isinstance(dep, str) and dep not in known:
                    known.add(dep)
                    dep_config = self._resolve_any_pipeline(dep)
                    extra[dep] = dep_config
                    frontier.append(dep_config)
        return extra

    def _resolve_any_pipeline(self, name: str) -> BasePipelineConfig:
        for kind in ("retrieval", "generation"):
            if self.pipeline_path(kind, name).exists():
                return self.resolve_pipeline(kind, name)
        raise PipelineNotFoundError(name)
