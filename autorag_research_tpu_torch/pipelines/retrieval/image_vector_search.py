"""Dense / MaxSim retrieval over image chunks (visual document retrieval).

Counterpart of ``autorag_research_tpu/pipelines/retrieval/image_vector_search.py``:
the search machinery of :class:`VectorSearchPipeline` over the
``image_chunk`` table, persisting to the image result table
(``retrieval_unit="image_chunk"``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from autorag_research_tpu_torch.config import BasePipelineConfig
from autorag_research_tpu_torch.pipelines.retrieval.vector_search import VectorSearchPipeline


class ImageVectorSearchPipeline(VectorSearchPipeline):
    retrieval_unit = "image_chunk"

    def __init__(
        self,
        catalog,
        name: str = "image_vector_search",
        search_mode: str = "single",
        embedding_model=None,
        device: str | torch.device = "cuda",
    ):
        super().__init__(
            catalog,
            name=name,
            search_mode=search_mode,  # type: ignore[arg-type]
            embedding_model=embedding_model,
            table="image_chunk",
            device=device,
        )

    def _get_pipeline_config(self) -> dict[str, Any]:
        config = super()._get_pipeline_config()
        config["type"] = "image_vector_search"
        return config


@dataclass(kw_only=True)
class ImageVectorSearchConfig(BasePipelineConfig):
    config_type = "image_vector_search"
    kind = "retrieval"

    search_mode: str = "single"
    embedding_model: Any = None

    def build(self, catalog, context):
        return ImageVectorSearchPipeline(
            catalog,
            name=self.name,
            search_mode=self.search_mode,
            embedding_model=context.load_embedding(self.embedding_model),
            device=context.device,
        )
