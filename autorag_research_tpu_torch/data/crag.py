"""CRAG (Comprehensive RAG Benchmark) ingestor.

Capability parity with the reference ``data/crag.py`` (270 LoC): CRAG task-1
rows carry a question, an answer, and search results (page snippets); page
snippets become chunks (content-hash ids), the row's pages form the GT
OR-group, and the answer feeds ``generation_gt``.

The port's copy of the JAX package's ``data/crag.py``: ``datasets`` is imported
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


def _doc_id(text: str) -> str:
    return "crag_" + hashlib.md5(text.encode("utf-8")).hexdigest()[:16]


@register_ingestor(
    name="crag",
    description="CRAG comprehensive RAG benchmark (questions + web snippets)",
    hf_repo="crag-dumps",
)
class CRAGIngestor(TextDataIngestor):
    def __init__(
        self,
        embedding_model=None,
        hf_path: str = "lighthouzai/crag",
        data=None,
    ):
        super().__init__(embedding_model)
        self.hf_path = hf_path
        self._data = data

    def detect_primary_key_type(self) -> Literal["bigint", "string"]:
        return "string"

    def _load(self, subset: str):
        if self._data is not None:
            return self._data
        return load_hf_dataset(self.hf_path, split=subset)

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
            qid = str(row.get("interaction_id", row.get("id", f"crag_{i}")))
            snippets = []
            for result in row.get("search_results") or []:
                text = (result.get("page_snippet") or result.get("snippet") or "").strip()
                if text:
                    snippets.append(text)
            doc_ids = []
            for text in snippets:
                did = _doc_id(text)
                chunks[did] = text
                doc_ids.append(did)
            answer = row.get("answer")
            queries.append(
                {
                    "id": qid,
                    "contents": row.get("query", row.get("question", "")),
                    "generation_gt": [answer] if answer else None,
                    "metadata": {"domain": row.get("domain"), "question_type": row.get("question_type")},
                }
            )
            if doc_ids:
                gts.append((qid, or_all(doc_ids)))

        service.add_chunks([{"id": d, "contents": t} for d, t in chunks.items()])
        service.add_queries(queries)
        for qid, gt in gts:
            service.add_retrieval_gt(qid, gt, chunk_type="text")
        service.clean()
