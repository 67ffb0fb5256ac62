"""Query rewrite: LLM rewrites the query, inner pipeline retrieves.

Capability parity with the reference ``pipelines/retrieval/query_rewrite.py:76``.

The port's copy of the JAX package's ``pipelines/retrieval/query_rewrite.py``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

from autorag_research_tpu_torch.config import BasePipelineConfig
from autorag_research_tpu_torch.pipelines.retrieval.base import BaseRetrievalPipeline

DEFAULT_REWRITE_PROMPT = (
    "Rewrite the following search query to be clearer and more specific for a "
    "search engine. Output only the rewritten query.\n\nQuery: {query}\n\nRewritten query:"
)


class QueryRewritePipeline(BaseRetrievalPipeline):
    def __init__(
        self,
        catalog,
        name: str = "query_rewrite",
        llm=None,
        inner_retrieval_pipeline=None,
        prompt_template: str = DEFAULT_REWRITE_PROMPT,
    ):
        self.llm = llm
        self.inner = inner_retrieval_pipeline
        self.prompt_template = prompt_template
        self.retrieval_unit = getattr(inner_retrieval_pipeline, "retrieval_unit", "chunk")
        super().__init__(catalog, name)

    def _get_pipeline_config(self) -> dict[str, Any]:
        return {
            "type": "query_rewrite",
            "prompt_template": self.prompt_template,
            "retrieval_unit": self.retrieval_unit,
        }

    async def _rewrite(self, query_text: str) -> str:
        response = await self.llm.agenerate(self.prompt_template.format(query=query_text))
        return response.text.strip().strip('"') or query_text

    async def _retrieve_by_id(self, query_id, top_k):
        text = self.catalog.get_query_text(query_id)
        if text is None:
            raise ValueError(f"query {query_id} not found")
        rewritten = await self._rewrite(text)
        return await self.inner._retrieve_by_text(rewritten, top_k)

    async def _retrieve_by_text(self, query_text, top_k):
        rewritten = await self._rewrite(query_text)
        return await self.inner._retrieve_by_text(rewritten, top_k)


@dataclass(kw_only=True)
class QueryRewriteConfig(BasePipelineConfig):
    config_type = "query_rewrite"
    kind = "retrieval"

    inner_retrieval_pipeline_name: str
    llm: Any = None
    prompt_template: str = DEFAULT_REWRITE_PROMPT

    def build(self, catalog, context):
        return QueryRewritePipeline(
            catalog,
            name=self.name,
            llm=context.load_llm(self.llm),
            inner_retrieval_pipeline=context.load_pipeline(self.inner_retrieval_pipeline_name),
            prompt_template=self.prompt_template,
        )
