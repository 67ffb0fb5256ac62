"""HyDE: Hypothetical Document Embeddings retrieval.

Capability parity with the reference ``pipelines/retrieval/hyde.py:89``
("Precise Zero-Shot Dense Retrieval without Relevance Labels",
arXiv:2212.10496): the LLM writes a hypothetical answer passage, the passage
is embedded, and dense search runs on that embedding (the reference's
``vector_search_by_embedding`` path).

The port's copy of the JAX package's ``pipelines/retrieval/hyde.py``. Its
dense search is a ``VectorSearchPipeline`` on the build context's device;
``index_options`` (the port's addition, ``None`` by default: the JAX
package's exact index) names that index's mode, so ``{"mode": "verified"}``
shares the verified index of a ``vector_search_verified`` pipeline over the
same catalog. A ``mesh`` goes to that search, which shards its index.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from autorag_research_tpu_torch.config import BasePipelineConfig
from autorag_research_tpu_torch.pipelines.retrieval.base import BaseRetrievalPipeline
from autorag_research_tpu_torch.pipelines.retrieval.vector_search import VectorSearchPipeline

DEFAULT_HYDE_PROMPT = (
    "Please write a passage to answer the question.\nQuestion: {query}\nPassage:"
)


class HyDEPipeline(BaseRetrievalPipeline):
    retrieval_unit = "chunk"

    def __init__(
        self,
        catalog,
        name: str = "hyde",
        llm=None,
        embedding_model=None,
        prompt_template: str = DEFAULT_HYDE_PROMPT,
        mesh=None,
        index_options: dict | None = None,
        device: str | torch.device = "cuda",
    ):
        if "{query}" not in prompt_template:
            raise ValueError("prompt_template must contain '{query}'")
        self.llm = llm
        self.embedding_model = embedding_model
        self.prompt_template = prompt_template
        self.index_options = index_options
        self._dense = VectorSearchPipeline(
            catalog, name=f"{name}__dense", embedding_model=embedding_model,
            index_options=index_options, device=device, mesh=mesh,
        )
        super().__init__(catalog, name)

    def _get_pipeline_config(self) -> dict[str, Any]:
        config = {"type": "hyde", "prompt_template": self.prompt_template}
        if self.index_options:  # the JAX package's config when unset
            config["index_options"] = self.index_options
        return config

    async def _hyde_search(self, query_text: str, top_k: int):
        response = await self.llm.agenerate(self.prompt_template.format(query=query_text))
        hypothetical_doc = response.text.strip() or query_text
        embedding = await self.embedding_model.aembed_query(hypothetical_doc)
        return self._dense.search_by_embedding(embedding, top_k)

    async def _retrieve_by_id(self, query_id, top_k):
        text = self.catalog.get_query_text(query_id)
        if text is None:
            raise ValueError(f"query {query_id} not found")
        return await self._hyde_search(text, top_k)

    async def _retrieve_by_text(self, query_text, top_k):
        return await self._hyde_search(query_text, top_k)


@dataclass(kw_only=True)
class HyDEConfig(BasePipelineConfig):
    config_type = "hyde"
    kind = "retrieval"

    llm: Any = None
    embedding_model: Any = None
    prompt_template: str = DEFAULT_HYDE_PROMPT
    index_options: dict | None = None

    def build(self, catalog, context):
        return HyDEPipeline(
            catalog,
            name=self.name,
            llm=context.load_llm(self.llm),
            embedding_model=context.load_embedding(self.embedding_model),
            prompt_template=self.prompt_template,
            index_options=self.index_options,
            mesh=context.mesh,
            device=context.device,
        )
