"""BRIGHT reasoning-intensive retrieval ingestor.

Capability parity with the reference ``data/bright.py`` (276 LoC): the
xlangai/BRIGHT benchmark — examples carry ``gold_ids`` into a shared documents
split plus gold answers; GT is the gold-id OR-group and the gold answer feeds
``generation_gt``.

The port's copy of the JAX package's ``data/bright.py``: ``datasets`` is imported
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

BRIGHT_SUBSETS = (
    "biology", "earth_science", "economics", "psychology", "robotics",
    "stackoverflow", "sustainable_living", "pony", "leetcode", "aops",
    "theoremqa_theorems", "theoremqa_questions",
)


@register_ingestor(
    name="bright",
    description="BRIGHT reasoning-intensive retrieval with gold answers",
    hf_repo="bright-dumps",
)
class BRIGHTIngestor(TextDataIngestor):
    def __init__(self, embedding_model=None, subset_name: str = "biology", data=None):
        super().__init__(embedding_model)
        self.subset_name = subset_name
        self._data = data

    def detect_primary_key_type(self) -> Literal["bigint", "string"]:
        return "string"

    def _load(self):
        if self._data is not None:
            return self._data
        return {
            "examples": load_hf_dataset("xlangai/BRIGHT", "examples", split=self.subset_name),
            "documents": load_hf_dataset("xlangai/BRIGHT", "documents", split=self.subset_name),
        }

    def ingest(self, subset: str = "test", query_limit=None, min_corpus_cnt=None) -> None:
        service = self._require_service()
        data = self._load()
        rng = random.Random(RANDOM_SEED)
        examples = list(data["examples"])
        picked = sample_ids(list(range(len(examples))), query_limit, rng)

        gold: set[str] = set()
        queries = []
        gts = []
        for i in picked:
            row = examples[i]
            qid = str(row["id"])
            gold_ids = [str(g) for g in (row.get("gold_ids") or [])]
            gold.update(gold_ids)
            answer = row.get("gold_answer")
            queries.append(
                {
                    "id": qid,
                    "contents": row["query"],
                    "generation_gt": [answer] if answer else None,
                }
            )
            if gold_ids:
                gts.append((qid, or_all(gold_ids)))

        from autorag_research_tpu_torch.data.hf_util import gold_preserving_subsample

        docs = {str(r["id"]): r["content"] for r in data["documents"]}
        doc_ids = gold_preserving_subsample(list(docs), gold, min_corpus_cnt, rng)
        doc_set = set(doc_ids)

        service.add_chunks([{"id": d, "contents": docs[d]} for d in doc_ids])
        service.add_queries(queries)
        for qid, gt in gts:
            service.add_retrieval_gt(qid, gt, chunk_type="text")
        service.clean()
