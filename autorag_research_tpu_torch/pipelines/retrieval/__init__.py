from autorag_research_tpu_torch.pipelines.retrieval.base import BaseRetrievalPipeline
from autorag_research_tpu_torch.pipelines.retrieval.bm25 import BM25Pipeline
from autorag_research_tpu_torch.pipelines.retrieval.image_vector_search import (
    ImageVectorSearchPipeline,
)
from autorag_research_tpu_torch.pipelines.retrieval.vector_search import VectorSearchPipeline

__all__ = ["BaseRetrievalPipeline", "BM25Pipeline", "ImageVectorSearchPipeline", "VectorSearchPipeline"]
