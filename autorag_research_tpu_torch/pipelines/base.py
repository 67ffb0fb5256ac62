"""Pipeline base: catalog binding + resume identity.

Role parity with the reference's ``pipelines/base.py`` + ``BasePipelineService``
(``orm/service/base_pipeline.py:16-77``): a pipeline is identified by name in
the catalog; re-instantiating with the same name resumes it.
"""

from __future__ import annotations

import logging
from abc import ABC, abstractmethod
from typing import Any

from autorag_research_tpu_torch.store.catalog import Catalog

logger = logging.getLogger("AutoRAG-Research-TPU")


class BasePipeline(ABC):
    def __init__(self, catalog: Catalog, name: str):
        self.catalog = catalog
        self.name = name
        existed = catalog.get_pipeline(name) is not None
        self.pipeline_id = catalog.get_or_create_pipeline(name, self._get_pipeline_config())
        self._is_new_pipeline = not existed
        if existed:
            logger.info("Resuming existing pipeline '%s' (id=%s)", name, self.pipeline_id)

    @abstractmethod
    def _get_pipeline_config(self) -> dict[str, Any]:
        """Serializable config persisted with the pipeline row."""
