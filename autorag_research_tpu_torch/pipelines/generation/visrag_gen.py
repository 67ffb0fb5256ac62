"""VisRAG generation: a VLM answers directly from retrieved page images.

Capability parity with the reference ``pipelines/generation/visrag_gen.py:78``
(VisRAG — no OCR/parsing; the vision LLM reads the retrieved page images).
The LLM adapter receives the raw image bytes via the ``images=`` kwarg of
``agenerate`` (vision-capable adapters encode them; text-only adapters may
ignore or raise; ``TorchLM``, like ``JaxLM``, ignores them).

The port's copy of the JAX package's ``pipelines/generation/visrag_gen.py``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

from autorag_research_tpu_torch.config import BasePipelineConfig
from autorag_research_tpu_torch.pipelines.generation.base import BaseGenerationPipeline, GenerationResult
from autorag_research_tpu_torch.schema import GENERATION_CONTEXT_CHUNK_ID_KEY
from autorag_research_tpu_torch.utils.tokens import TokenUsageTracker

VISRAG_PROMPT = (
    "Answer the question using the attached page images.\n\n"
    "Question: {query}\nAnswer:"
)


class VisRAGGenerationPipeline(BaseGenerationPipeline):
    def __init__(
        self,
        catalog,
        name: str = "visrag_gen",
        retrieval_pipeline=None,  # must produce image_chunk results
        llm=None,
        prompt_template: str = VISRAG_PROMPT,
        max_images: int = 3,
        image_processing_mode: str = "multi_image",
        concatenation_direction: str = "horizontal",
    ):
        if image_processing_mode not in ("multi_image", "concatenate"):
            raise ValueError(
                f"unknown image_processing_mode '{image_processing_mode}'"
            )
        self.prompt_template = prompt_template
        self.max_images = max_images
        self.image_processing_mode = image_processing_mode
        self.concatenation_direction = concatenation_direction
        super().__init__(catalog, name, retrieval_pipeline, llm)

    def _get_pipeline_config(self) -> dict[str, Any]:
        return {
            "type": "visrag_gen",
            "max_images": self.max_images,
            "image_processing_mode": self.image_processing_mode,
        }

    async def _generate(self, query_id, top_k) -> GenerationResult:
        query = self.get_query_text(query_id)
        tracker = TokenUsageTracker()
        hits = await self.retrieve_for(query_id, top_k)
        ids = [h["doc_id"] for h in hits][: self.max_images]
        rows = self.catalog.get_image_chunks(ids)
        images = [rows[i]["image"] for i in ids if i in rows and rows[i]["image"]]
        if self.image_processing_mode == "concatenate" and len(images) > 1:
            # single-image VLM fallback (reference visrag_gen.py:40-43):
            # merge the pages into one composite
            from autorag_research_tpu_torch.utils.images import concatenate_images

            images = [concatenate_images(images, self.concatenation_direction)]
        response = await self.llm.agenerate(
            self.prompt_template.format(query=query), images=images
        )
        tracker.record(response)
        return GenerationResult(
            text=response.text.strip(),
            token_usage=tracker.total,
            metadata={
                GENERATION_CONTEXT_CHUNK_ID_KEY: ids,
                "image_chunk_ids": ids,
            },
            # base.run() persists these into the image_chunk result table —
            # without them retrieval metrics for this pipeline read empty sets
            retrieved=hits,
        )


@dataclass(kw_only=True)
class VisRAGGenConfig(BasePipelineConfig):
    config_type = "visrag_gen"
    kind = "generation"

    retrieval_pipeline_name: str
    llm: Any = None
    max_images: int = 3
    image_processing_mode: str = "multi_image"
    concatenation_direction: str = "horizontal"

    def build(self, catalog, context):
        return VisRAGGenerationPipeline(
            catalog,
            name=self.name,
            retrieval_pipeline=context.load_pipeline(self.retrieval_pipeline_name),
            llm=context.load_llm(self.llm),
            max_images=self.max_images,
            image_processing_mode=self.image_processing_mode,
            concatenation_direction=self.concatenation_direction,
        )
