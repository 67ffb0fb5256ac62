from autorag_research_tpu_torch.embeddings.base import (
    BaseEmbedding,
    MultiVectorEmbedding,
    MockEmbedding,
    MockMultiVectorEmbedding,
)

__all__ = [
    "BaseEmbedding",
    "MultiVectorEmbedding",
    "MockEmbedding",
    "MockMultiVectorEmbedding",
]
