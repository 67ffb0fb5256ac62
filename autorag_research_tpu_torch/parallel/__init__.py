from autorag_research_tpu_torch.parallel.mesh import (
    corpus_mesh,
    get_default_mesh,
    hybrid_corpus_mesh,
    set_default_mesh,
)
from autorag_research_tpu_torch.parallel.sharded import shard_corpus, sharded_dense_topk

__all__ = [
    "corpus_mesh",
    "get_default_mesh",
    "hybrid_corpus_mesh",
    "set_default_mesh",
    "sharded_dense_topk",
    "shard_corpus",
]
