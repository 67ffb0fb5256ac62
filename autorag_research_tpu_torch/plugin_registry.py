"""Third-party plugin discovery and scaffolding.

Role parity with the reference ``plugin_registry.py:44-259`` +
``cli/commands/plugin.py:25-504``: plugins are installed packages exposing
entry points in the groups ``autorag_research_tpu_torch.pipelines``,
``autorag_research_tpu_torch.metrics``, ``autorag_research_tpu_torch.ingestors``;
loading an entry point registers its config dataclasses / metric functions /
ingestor classes. ``plugin sync`` copies any YAML the plugin ships into the
local config tree (never overwriting); ``plugin create`` scaffolds a full
plugin project.

The port's copy of the JAX package's ``plugin_registry.py``: its entry-point
groups and scaffold name the port's package.
"""

from __future__ import annotations

import shutil
from importlib.metadata import entry_points
from pathlib import Path

PLUGIN_GROUPS = (
    "autorag_research_tpu_torch.pipelines",
    "autorag_research_tpu_torch.metrics",
    "autorag_research_tpu_torch.ingestors",
)


def load_plugins() -> dict[str, list[str]]:
    """Import every plugin entry point; returns {group: [loaded names]}."""
    loaded: dict[str, list[str]] = {}
    for group in PLUGIN_GROUPS:
        names = []
        try:
            eps = entry_points(group=group)
        except Exception:  # noqa: BLE001
            continue
        for ep in eps:
            try:
                ep.load()
                names.append(ep.name)
            except Exception:  # noqa: BLE001 - plugin isolation
                continue
        loaded[group] = names
    return loaded


def register_metric(name: str, metric_type: str, func) -> None:
    """Register a plugin metric into the builtin registries."""
    if metric_type == "retrieval":
        from autorag_research_tpu_torch.evaluation.metrics.retrieval import RETRIEVAL_METRICS

        RETRIEVAL_METRICS[name] = func
    else:
        from autorag_research_tpu_torch.evaluation.metrics.generation import GENERATION_METRICS

        GENERATION_METRICS[name] = func


def sync_plugin_configs(config_dir: Path) -> list[Path]:
    """Copy YAMLs shipped inside installed plugin packages into the local
    config tree; never overwrites existing files."""
    copied: list[Path] = []
    for group in PLUGIN_GROUPS:
        try:
            eps = entry_points(group=group)
        except Exception:  # noqa: BLE001
            continue
        for ep in eps:
            try:
                module = ep.load()
            except Exception:  # noqa: BLE001
                continue
            pkg_dir = Path(getattr(module, "__file__", "") or "").parent
            configs = pkg_dir / "configs"
            if not configs.is_dir():
                continue
            for src in configs.rglob("*.yaml"):
                rel = src.relative_to(configs)
                dst = config_dir / rel
                if dst.exists():
                    continue
                dst.parent.mkdir(parents=True, exist_ok=True)
                shutil.copy(src, dst)
                copied.append(dst)
    return copied


_SCAFFOLD_PIPELINE = '''"""Example plugin retrieval pipeline."""

from dataclasses import dataclass
from typing import Any

from autorag_research_tpu_torch.config import BasePipelineConfig
from autorag_research_tpu_torch.pipelines.retrieval.base import BaseRetrievalPipeline


class {cls}Pipeline(BaseRetrievalPipeline):
    retrieval_unit = "chunk"

    def _get_pipeline_config(self) -> dict[str, Any]:
        return {{"type": "{name}"}}

    async def _retrieve_by_id(self, query_id, top_k):
        return []  # implement me

    async def _retrieve_by_text(self, query_text, top_k):
        return []  # implement me


@dataclass(kw_only=True)
class {cls}Config(BasePipelineConfig):
    config_type = "{name}"
    kind = "retrieval"

    def build(self, catalog, context):
        return {cls}Pipeline(catalog, name=self.name)
'''

_SCAFFOLD_PYPROJECT = """[project]
name = "{name}"
version = "0.1.0"
dependencies = []

[project.entry-points."autorag_research_tpu_torch.pipelines"]
{name} = "{name}.pipeline"

[build-system]
requires = ["setuptools"]
build-backend = "setuptools.build_meta"
"""

_SCAFFOLD_TEST = '''from {name}.pipeline import {cls}Config


def test_config_registers():
    from autorag_research_tpu_torch.config import BasePipelineConfig

    assert BasePipelineConfig.registry["{name}"] is {cls}Config
'''


def create_plugin_scaffold(name: str, parent: Path) -> Path:
    """Scaffold a complete plugin project (pyproject + pipeline + YAML + test)."""
    cls = "".join(part.capitalize() for part in name.split("_"))
    root = parent / name
    pkg = root / name
    pkg.mkdir(parents=True, exist_ok=True)
    (root / "pyproject.toml").write_text(_SCAFFOLD_PYPROJECT.format(name=name))
    (pkg / "__init__.py").write_text("")
    (pkg / "pipeline.py").write_text(_SCAFFOLD_PIPELINE.format(name=name, cls=cls))
    configs = pkg / "configs" / "pipelines" / "retrieval"
    configs.mkdir(parents=True, exist_ok=True)
    (configs / f"{name}.yaml").write_text(f"type: {name}\ntop_k: 10\n")
    tests = root / "tests"
    tests.mkdir(exist_ok=True)
    (tests / f"test_{name}.py").write_text(_SCAFFOLD_TEST.format(name=name, cls=cls))
    return root
