"""Domain exceptions (role parity with reference ``exceptions.py:1-215``)."""

from __future__ import annotations


class AutoRAGTPUError(Exception):
    """Base class for all framework errors."""


class HealthCheckError(AutoRAGTPUError):
    """A pre-flight health check (model, store, or pipeline dry run) failed."""


class NoQueryInDBError(AutoRAGTPUError):
    """The catalog contains no queries to run against."""


class NoChunkInDBError(AutoRAGTPUError):
    """The catalog contains no chunks/corpus to index."""


class DuplicateRetrievalGTError(AutoRAGTPUError):
    """A (query, group_index, group_order) GT cell was inserted twice."""


class EmptyIterableError(AutoRAGTPUError):
    """or_all/and_all received an empty iterable."""


class PipelineConfigError(AutoRAGTPUError):
    """Invalid or inconsistent pipeline configuration."""


class PipelineCycleError(PipelineConfigError):
    """Wrapper pipelines form a dependency cycle."""


class PipelineNotFoundError(AutoRAGTPUError):
    """Named pipeline YAML/config could not be resolved."""


class MetricNotFoundError(AutoRAGTPUError):
    """Named metric config could not be resolved."""


class ModelLoadError(AutoRAGTPUError):
    """An embedding model / LLM / reranker failed to load or health-check."""


class IndexError_(AutoRAGTPUError):
    """Index build/load/search failure."""


class IndexNotBuiltError(IndexError_):
    """Search was attempted before the index artifact was built/loaded."""


class EmbeddingMissingError(IndexError_):
    """Rows required for an index build are missing embeddings."""


class IngestionError(AutoRAGTPUError):
    """Dataset ingestion failed."""


class StoreError(AutoRAGTPUError):
    """Catalog store failure."""


class RetrievalUnitError(AutoRAGTPUError):
    """Invalid retrieval unit namespace (must be chunk/image_chunk/mixed)."""


class LLMError(AutoRAGTPUError):
    """LLM invocation failure."""


class TokenizerError(AutoRAGTPUError):
    """BM25 tokenizer failure or unknown tokenizer name."""
