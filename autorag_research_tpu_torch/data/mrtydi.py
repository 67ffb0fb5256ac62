"""Mr. TyDi multilingual retrieval ingestor.

Capability parity with the reference ``data/mrtydi.py`` (322 LoC): the
castorini/mr-tydi dataset, 11 languages; each row has a query plus
positive/negative passage lists — positives become GT, and the corpus is the
union of positives + negatives (plus the standard corpus subsampling).

The port's copy of the JAX package's ``data/mrtydi.py``: ``datasets`` is imported
lazily through ``data/hf_util.py``, and every ``_doc_id`` hash and
subsample is the JAX ingestor's, so both packages write the same catalog.
"""

from __future__ import annotations

import random
from typing import Literal

from autorag_research_tpu_torch.data.base import RANDOM_SEED, TextDataIngestor
from autorag_research_tpu_torch.data.hf_util import load_hf_dataset, sample_ids
from autorag_research_tpu_torch.data.registry import register_ingestor
from autorag_research_tpu_torch.store.gt import or_all

MRTYDI_LANGUAGES = (
    "arabic", "bengali", "english", "finnish", "indonesian", "japanese",
    "korean", "russian", "swahili", "telugu", "thai",
)


@register_ingestor(
    name="mrtydi",
    description="Mr. TyDi multilingual retrieval (11 languages)",
    hf_repo="mrtydi-dumps",
)
class MrTyDiIngestor(TextDataIngestor):
    def __init__(self, embedding_model=None, language: str = "english", data=None):
        super().__init__(embedding_model)
        self.language = language
        self._data = data

    def detect_primary_key_type(self) -> Literal["bigint", "string"]:
        return "string"

    def _load(self, subset: str):
        if self._data is not None:
            return self._data
        return load_hf_dataset("castorini/mr-tydi", self.language, split=subset)

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
            qid = str(row["query_id"])
            positives = row.get("positive_passages") or []
            negatives = row.get("negative_passages") or []
            pos_ids = []
            for p in positives:
                did = str(p["docid"])
                chunks[did] = ((p.get("title") or "") + " " + (p.get("text") or "")).strip()
                pos_ids.append(did)
            for p in negatives:
                did = str(p["docid"])
                chunks.setdefault(
                    did, ((p.get("title") or "") + " " + (p.get("text") or "")).strip()
                )
            queries.append({"id": qid, "contents": row["query"]})
            if pos_ids:
                gts.append((qid, or_all(pos_ids)))

        service.add_chunks([{"id": d, "contents": t} for d, t in chunks.items()])
        service.add_queries(queries)
        for qid, gt in gts:
            service.add_retrieval_gt(qid, gt, chunk_type="text")
        service.clean()
