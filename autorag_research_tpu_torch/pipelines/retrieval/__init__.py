from autorag_research_tpu_torch.pipelines.retrieval.base import BaseRetrievalPipeline
from autorag_research_tpu_torch.pipelines.retrieval.bm25 import BM25Config, BM25Pipeline
from autorag_research_tpu_torch.pipelines.retrieval.gqr_hybrid import (
    GQRHybridConfig,
    GQRHybridPipeline,
)
from autorag_research_tpu_torch.pipelines.retrieval.heaven import HEAVENConfig, HEAVENPipeline
from autorag_research_tpu_torch.pipelines.retrieval.hybrid import (
    HybridCCConfig,
    HybridCCPipeline,
    HybridRRFConfig,
    HybridRRFPipeline,
)
from autorag_research_tpu_torch.pipelines.retrieval.hyde import HyDEConfig, HyDEPipeline
from autorag_research_tpu_torch.pipelines.retrieval.image_vector_search import (
    ImageVectorSearchConfig,
    ImageVectorSearchPipeline,
)
from autorag_research_tpu_torch.pipelines.retrieval.power_of_noise import (
    PowerOfNoiseConfig,
    PowerOfNoisePipeline,
)
from autorag_research_tpu_torch.pipelines.retrieval.query_rewrite import (
    QueryRewriteConfig,
    QueryRewritePipeline,
)
from autorag_research_tpu_torch.pipelines.retrieval.question_decomposition import (
    QuestionDecompositionConfig,
    QuestionDecompositionPipeline,
)
from autorag_research_tpu_torch.pipelines.retrieval.rerank import RerankConfig, RerankPipeline
from autorag_research_tpu_torch.pipelines.retrieval.retro_star import (
    RetroStarConfig,
    RetroStarPipeline,
)
from autorag_research_tpu_torch.pipelines.retrieval.vector_search import (
    VectorSearchConfig,
    VectorSearchPipeline,
)

__all__ = [
    "BaseRetrievalPipeline",
    "BM25Config", "BM25Pipeline",
    "GQRHybridConfig", "GQRHybridPipeline",
    "HEAVENConfig", "HEAVENPipeline",
    "HybridCCConfig", "HybridCCPipeline",
    "HybridRRFConfig", "HybridRRFPipeline",
    "HyDEConfig", "HyDEPipeline",
    "ImageVectorSearchConfig", "ImageVectorSearchPipeline",
    "PowerOfNoiseConfig", "PowerOfNoisePipeline",
    "QueryRewriteConfig", "QueryRewritePipeline",
    "QuestionDecompositionConfig", "QuestionDecompositionPipeline",
    "RerankConfig", "RerankPipeline",
    "RetroStarConfig", "RetroStarPipeline",
    "VectorSearchConfig", "VectorSearchPipeline",
]
