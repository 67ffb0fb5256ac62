from autorag_research_tpu_torch.rerankers.base import BaseReranker, RerankResult
from autorag_research_tpu_torch.rerankers.local import (
    EmbeddingSimilarityReranker,
    MockReranker,
)
from autorag_research_tpu_torch.rerankers.llm import LLMListwiseReranker

__all__ = [
    "BaseReranker",
    "RerankResult",
    "EmbeddingSimilarityReranker",
    "MockReranker",
    "LLMListwiseReranker",
]
