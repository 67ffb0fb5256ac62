from autorag_research_tpu_torch.index.base import SearchHit
from autorag_research_tpu_torch.index.dense import DenseIndex
from autorag_research_tpu_torch.index.multi_vector import MultiVectorIndex
from autorag_research_tpu_torch.index.sparse import SparseIndex

__all__ = ["SearchHit", "DenseIndex", "MultiVectorIndex", "SparseIndex"]
