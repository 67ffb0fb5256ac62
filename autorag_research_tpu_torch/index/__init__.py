from autorag_research_tpu_torch.index.base import SearchHit
from autorag_research_tpu_torch.index.dense import DenseIndex

__all__ = ["SearchHit", "DenseIndex"]
