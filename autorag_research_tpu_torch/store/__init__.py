from autorag_research_tpu_torch.store.catalog import Catalog
from autorag_research_tpu_torch.store.gt import (
    GTItem,
    and_all,
    and_all_mixed,
    build_retrieval_gt_from_relations,
    image,
    normalize_gt,
    or_all,
    or_all_mixed,
    text,
)

__all__ = [
    "Catalog",
    "GTItem",
    "and_all",
    "and_all_mixed",
    "build_retrieval_gt_from_relations",
    "image",
    "normalize_gt",
    "or_all",
    "or_all_mixed",
    "text",
]
