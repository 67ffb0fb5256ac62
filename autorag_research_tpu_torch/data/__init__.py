from autorag_research_tpu_torch.data.base import (
    DataIngestor,
    MultiModalDataIngestor,
    TextDataIngestor,
)
from autorag_research_tpu_torch.data.registry import get_ingestor, list_ingestors, register_ingestor

__all__ = [
    "DataIngestor",
    "MultiModalDataIngestor",
    "TextDataIngestor",
    "get_ingestor",
    "list_ingestors",
    "register_ingestor",
]
