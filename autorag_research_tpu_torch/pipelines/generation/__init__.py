from autorag_research_tpu_torch.pipelines.generation.base import (
    BaseGenerationPipeline,
    GenerationResult,
)
from autorag_research_tpu_torch.pipelines.generation.basic_rag import (
    BasicRAGConfig,
    BasicRAGPipeline,
)
from autorag_research_tpu_torch.pipelines.generation.visrag_gen import (
    VisRAGGenConfig,
    VisRAGGenerationPipeline,
)

__all__ = [
    "BaseGenerationPipeline", "GenerationResult",
    "BasicRAGConfig", "BasicRAGPipeline",
    "VisRAGGenConfig", "VisRAGGenerationPipeline",
]
