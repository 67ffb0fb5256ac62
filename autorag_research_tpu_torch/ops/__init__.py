from autorag_research_tpu_torch.ops.topk import merge_topk, sort_topk, topk_ordered
from autorag_research_tpu_torch.ops.dense import (
    dense_topk,
    dense_topk_full,
    dense_topk_scan,
    dense_topk_stream,
    dense_topk_verified,
)
from autorag_research_tpu_torch.ops.maxsim import (
    maxsim_rerank,
    maxsim_topk,
    maxsim_topk_verified,
)

__all__ = [
    "merge_topk",
    "sort_topk",
    "topk_ordered",
    "dense_topk",
    "dense_topk_full",
    "dense_topk_scan",
    "dense_topk_stream",
    "dense_topk_verified",
    "maxsim_rerank",
    "maxsim_topk",
    "maxsim_topk_verified",
]
