from autorag_research_tpu_torch.pipelines.retrieval.base import BaseRetrievalPipeline
from autorag_research_tpu_torch.pipelines.retrieval.bm25 import BM25Config, BM25Pipeline
from autorag_research_tpu_torch.pipelines.retrieval.gqr_hybrid import (
    GQRHybridConfig,
    GQRHybridPipeline,
)
from autorag_research_tpu_torch.pipelines.retrieval.hybrid import (
    HybridCCConfig,
    HybridCCPipeline,
    HybridRRFConfig,
    HybridRRFPipeline,
)
from autorag_research_tpu_torch.pipelines.retrieval.image_vector_search import (
    ImageVectorSearchConfig,
    ImageVectorSearchPipeline,
)
from autorag_research_tpu_torch.pipelines.retrieval.vector_search import (
    VectorSearchConfig,
    VectorSearchPipeline,
)

__all__ = [
    "BaseRetrievalPipeline",
    "BM25Config", "BM25Pipeline",
    "GQRHybridConfig", "GQRHybridPipeline",
    "HybridCCConfig", "HybridCCPipeline",
    "HybridRRFConfig", "HybridRRFPipeline",
    "ImageVectorSearchConfig", "ImageVectorSearchPipeline",
    "VectorSearchConfig", "VectorSearchPipeline",
]
