from autorag_research_tpu_torch.index.base import SearchHit
from autorag_research_tpu_torch.index.dense import DenseIndex
from autorag_research_tpu_torch.index.ivf import IVFIndex
from autorag_research_tpu_torch.index.ivf_contiguous import IVFContiguousIndex
from autorag_research_tpu_torch.index.multi_vector import MultiVectorIndex
from autorag_research_tpu_torch.index.sparse import SparseIndex

__all__ = ["SearchHit", "DenseIndex", "IVFIndex", "IVFContiguousIndex", "MultiVectorIndex", "SparseIndex"]
