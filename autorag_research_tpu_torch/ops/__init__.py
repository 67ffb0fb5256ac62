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
from autorag_research_tpu_torch.ops.sparse import (
    bm25_topk,
    bm25_topk_packed,
    bm25_topk_probe,
    bm25_topk_probe_packed,
    bm25_topk_scan,
    bm25_topk_v1,
    bm25_topk_v2,
    bm25_topk_v2_skip,
    bm25_topk_wand,
    build_tile_bitmaps,
    pack_slots,
    tile_match,
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
    "bm25_topk",
    "bm25_topk_packed",
    "bm25_topk_probe",
    "bm25_topk_probe_packed",
    "bm25_topk_scan",
    "bm25_topk_v1",
    "bm25_topk_v2",
    "bm25_topk_v2_skip",
    "bm25_topk_wand",
    "build_tile_bitmaps",
    "pack_slots",
    "tile_match",
]
