"""Basic RAG: retrieve once -> prompt -> one LLM call.

Capability parity with the reference ``pipelines/generation/basic_rag.py:78``.
The port's copy of the JAX package's ``pipelines/generation/basic_rag.py``.
"""

from __future__ import annotations

from dataclasses import dataclass

from autorag_research_tpu_torch.config import BasePipelineConfig
from autorag_research_tpu_torch.pipelines.generation.base import BaseGenerationPipeline, GenerationResult
from autorag_research_tpu_torch.schema import GENERATION_CONTEXT_CHUNK_ID_KEY
from autorag_research_tpu_torch.utils.tokens import TokenUsageTracker

DEFAULT_PROMPT = (
    "Answer the question using only the provided context.\n\n"
    "Context:\n{context}\n\nQuestion: {query}\n\nAnswer:"
)


class BasicRAGPipeline(BaseGenerationPipeline):
    def __init__(
        self,
        catalog,
        name: str = "basic_rag",
        retrieval_pipeline=None,
        llm=None,
        prompt_template: str = DEFAULT_PROMPT,
    ):
        self.prompt_template = prompt_template
        super().__init__(catalog, name, retrieval_pipeline, llm)

    def _get_pipeline_config(self):
        return {"type": "basic_rag", "prompt_template": self.prompt_template}

    def generate_batch_by_texts(
        self, texts: list[str], top_k: int
    ) -> list[GenerationResult]:
        """Serving micro-batch path: ONE batched retrieval + ONE batched
        decode for the whole micro-batch (``TorchLM.generate_batch_results``
        decodes the batch in one call)."""
        hits_per = self.retrieval_pipeline._retrieve_batch_by_texts(texts, top_k)
        prompts, ids_per = [], []
        for q, hits in zip(texts, hits_per):
            chunk_ids = [h["doc_id"] for h in hits]
            contents = self.get_chunk_contents(chunk_ids)
            context = "\n\n".join(contents) if contents else "(no context retrieved)"
            prompts.append(self.prompt_template.format(context=context, query=q))
            ids_per.append(chunk_ids)
        if hasattr(self.llm, "generate_batch_results"):
            # full LLMResult rows: batched serving reports real token_usage
            results = self.llm.generate_batch_results(prompts)
        elif hasattr(self.llm, "generate_batch"):
            from autorag_research_tpu_torch.llm.base import LLMResult

            outs = self.llm.generate_batch(prompts)
            results = [LLMResult(text=t) for t in outs]
        else:
            import asyncio

            from autorag_research_tpu_torch.utils.concurrency import run_async

            async def gather():
                return await asyncio.gather(*[self.llm.agenerate(p) for p in prompts])

            results = run_async(gather())
        if len(results) != len(prompts):
            # fail fast into the batcher's error path — zip would silently
            # drop the tail and strand those serving clients until timeout
            raise RuntimeError(
                f"batched LLM returned {len(results)} results for "
                f"{len(prompts)} prompts"
            )
        out = []
        for res, chunk_ids, hits in zip(results, ids_per, hits_per):
            tracker = TokenUsageTracker()
            tracker.record(res)
            out.append(
                GenerationResult(
                    text=res.text,
                    token_usage=tracker.total,
                    metadata={
                        GENERATION_CONTEXT_CHUNK_ID_KEY: chunk_ids,
                        "retrieved_chunk_ids": chunk_ids,
                    },
                    retrieved=hits,
                )
            )
        return out

    async def _generate(self, query_id, top_k) -> GenerationResult:
        query = self.get_query_text(query_id)
        hits = await self.retrieve_for(query_id, top_k)
        chunk_ids = [h["doc_id"] for h in hits]
        contents = self.get_chunk_contents(chunk_ids)
        context = "\n\n".join(contents) if contents else "(no context retrieved)"
        tracker = TokenUsageTracker()
        response = await self.llm.agenerate(
            self.prompt_template.format(context=context, query=query)
        )
        tracker.record(response)
        return GenerationResult(
            text=response.text,
            token_usage=tracker.total,
            metadata={
                GENERATION_CONTEXT_CHUNK_ID_KEY: chunk_ids,
                "retrieved_chunk_ids": chunk_ids,
            },
            retrieved=hits,
        )


@dataclass(kw_only=True)
class BasicRAGConfig(BasePipelineConfig):
    config_type = "basic_rag"
    kind = "generation"

    retrieval_pipeline_name: str
    llm: object = None
    prompt_template: str = DEFAULT_PROMPT

    def build(self, catalog, context):
        return BasicRAGPipeline(
            catalog,
            name=self.name,
            retrieval_pipeline=context.load_pipeline(self.retrieval_pipeline_name),
            llm=context.load_llm(self.llm),
            prompt_template=self.prompt_template,
        )
