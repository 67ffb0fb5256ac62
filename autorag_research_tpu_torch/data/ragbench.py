"""RAGBench ingestor: retrieval + generation ground truth.

Capability parity with the reference ``data/ragbench.py`` (329 LoC): the
rungalileo/ragbench HF dataset — 12 domain subsets, each row a question with
its supporting documents and a reference response. Documents become chunks
(deduplicated by content hash); per-query GT covers the row's documents, and
the response becomes ``generation_gt``.

The port's copy of the JAX package's ``data/ragbench.py``: ``datasets`` is imported
lazily through ``data/hf_util.py``, and every ``_doc_id`` hash and
subsample is the JAX ingestor's, so both packages write the same catalog.
"""

from __future__ import annotations

import hashlib
import random
from typing import Literal

from autorag_research_tpu_torch.data.base import RANDOM_SEED, TextDataIngestor
from autorag_research_tpu_torch.data.hf_util import load_hf_dataset, sample_ids
from autorag_research_tpu_torch.data.registry import register_ingestor
from autorag_research_tpu_torch.store.gt import or_all

RAGBENCH_SUBSETS = (
    "covidqa", "cuad", "delucionqa", "emanual", "expertqa", "finqa",
    "hagrid", "hotpotqa", "msmarco", "pubmedqa", "tatqa", "techqa",
)


def _doc_id(text: str) -> str:
    return "rb_" + hashlib.md5(text.encode("utf-8")).hexdigest()[:16]


@register_ingestor(
    name="ragbench",
    description="RAGBench: retrieval + generation GT across 12 domains",
    hf_repo="ragbench-dumps",
)
class RAGBenchIngestor(TextDataIngestor):
    def __init__(self, embedding_model=None, subset_name: str = "covidqa", data=None):
        super().__init__(embedding_model)
        self.subset_name = subset_name
        self._data = data

    def detect_primary_key_type(self) -> Literal["bigint", "string"]:
        return "string"

    def _load(self, subset: str):
        if self._data is not None:
            return self._data
        return load_hf_dataset("rungalileo/ragbench", self.subset_name, split=subset)

    def ingest(self, subset: str = "test", query_limit=None, min_corpus_cnt=None) -> None:
        service = self._require_service()
        rows = list(self._load(subset))
        rng = random.Random(RANDOM_SEED)
        picked = sample_ids(list(range(len(rows))), query_limit, rng)

        chunks: dict[str, str] = {}
        queries = []
        gts = []
        for i in picked:
            row = rows[i]
            qid = str(row.get("id", f"{self.subset_name}_{i}"))
            docs = row.get("documents") or []
            doc_ids = []
            for doc in docs:
                did = _doc_id(doc)
                chunks[did] = doc
                doc_ids.append(did)
            queries.append(
                {
                    "id": qid,
                    "contents": row["question"],
                    "generation_gt": [row["response"]] if row.get("response") else None,
                }
            )
            if doc_ids:
                gts.append((qid, or_all(doc_ids)))

        service.add_chunks([{"id": did, "contents": text} for did, text in chunks.items()])
        service.add_queries(queries)
        for qid, gt in gts:
            service.add_retrieval_gt(qid, gt, chunk_type="text")
        service.clean()
