from autorag_research_tpu_torch.evaluation.metrics.retrieval import (
    retrieval_f1,
    retrieval_full_recall,
    retrieval_map,
    retrieval_mrr,
    retrieval_ndcg,
    retrieval_precision,
    retrieval_recall,
)

__all__ = [
    "retrieval_f1",
    "retrieval_full_recall",
    "retrieval_map",
    "retrieval_mrr",
    "retrieval_ndcg",
    "retrieval_precision",
    "retrieval_recall",
]
