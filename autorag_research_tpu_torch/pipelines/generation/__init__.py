from autorag_research_tpu_torch.pipelines.generation.adaptive_rag import AdaptiveRAGConfig, AdaptiveRAGPipeline
from autorag_research_tpu_torch.pipelines.generation.autothinkrag import AutoThinkRAGConfig, AutoThinkRAGPipeline
from autorag_research_tpu_torch.pipelines.generation.base import BaseGenerationPipeline, GenerationResult
from autorag_research_tpu_torch.pipelines.generation.basic_rag import BasicRAGConfig, BasicRAGPipeline
from autorag_research_tpu_torch.pipelines.generation.deep_rag import DeepRAGConfig, DeepRAGPipeline
from autorag_research_tpu_torch.pipelines.generation.dynamic_rag import DynamicRAGConfig, DynamicRAGPipeline
from autorag_research_tpu_torch.pipelines.generation.et2rag import ET2RAGConfig, ET2RAGPipeline
from autorag_research_tpu_torch.pipelines.generation.hybrid_deep_searcher import (
    HybridDeepSearcherConfig,
    HybridDeepSearcherPipeline,
)
from autorag_research_tpu_torch.pipelines.generation.interact_rag import InteractRAGConfig, InteractRAGPipeline
from autorag_research_tpu_torch.pipelines.generation.ircot import IRCoTConfig, IRCoTPipeline
from autorag_research_tpu_torch.pipelines.generation.main_rag import MainRAGConfig, MainRAGPipeline
from autorag_research_tpu_torch.pipelines.generation.question_decomposition import (
    QuestionDecompositionGenConfig,
    QuestionDecompositionGenerationPipeline,
)
from autorag_research_tpu_torch.pipelines.generation.rag_critic import RAGCriticConfig, RAGCriticPipeline
from autorag_research_tpu_torch.pipelines.generation.ras import RASConfig, RASPipeline
from autorag_research_tpu_torch.pipelines.generation.search_r1 import SearchR1Config, SearchR1Pipeline
from autorag_research_tpu_torch.pipelines.generation.self_rag import SelfRAGConfig, SelfRAGPipeline
from autorag_research_tpu_torch.pipelines.generation.spd_rag import SPDRAGConfig, SPDRAGPipeline
from autorag_research_tpu_torch.pipelines.generation.visrag_gen import VisRAGGenConfig, VisRAGGenerationPipeline

__all__ = [
    "BaseGenerationPipeline", "GenerationResult",
    "AdaptiveRAGConfig", "AdaptiveRAGPipeline",
    "AutoThinkRAGConfig", "AutoThinkRAGPipeline",
    "BasicRAGConfig", "BasicRAGPipeline",
    "DeepRAGConfig", "DeepRAGPipeline",
    "DynamicRAGConfig", "DynamicRAGPipeline",
    "ET2RAGConfig", "ET2RAGPipeline",
    "HybridDeepSearcherConfig", "HybridDeepSearcherPipeline",
    "InteractRAGConfig", "InteractRAGPipeline",
    "IRCoTConfig", "IRCoTPipeline",
    "MainRAGConfig", "MainRAGPipeline",
    "QuestionDecompositionGenConfig", "QuestionDecompositionGenerationPipeline",
    "RAGCriticConfig", "RAGCriticPipeline",
    "RASConfig", "RASPipeline",
    "SearchR1Config", "SearchR1Pipeline",
    "SelfRAGConfig", "SelfRAGPipeline",
    "SPDRAGConfig", "SPDRAGPipeline",
    "VisRAGGenConfig", "VisRAGGenerationPipeline",
]
