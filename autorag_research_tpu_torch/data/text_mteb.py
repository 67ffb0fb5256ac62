"""MTEB retrieval-task ingestor.

Capability parity with the reference ``data/text_mteb.py`` (319 LoC): any
MTEB retrieval task (HF ``mteb/{task}`` repos with corpus/queries/qrels
configs), with a relevance-score threshold for GT inclusion and the standard
gold-preserving subsampling.

The port's copy of the JAX package's ``data/text_mteb.py``: ``datasets`` is imported
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


@register_ingestor(
    name="text_mteb",
    description="Any MTEB retrieval task (corpus/queries/qrels configs)",
    hf_repo="text_mteb-dumps",
    aliases=("mteb",),
)
class TextMTEBIngestor(TextDataIngestor):
    def __init__(
        self,
        embedding_model=None,
        task_name: str = "SciFact",
        score_threshold: int = 1,
        data=None,
        data_dir: str | None = None,
    ):
        super().__init__(embedding_model)
        self.task_name = task_name
        self.score_threshold = score_threshold
        self._data = data
        # offline turnkey path: a datasets.save_to_disk snapshot with
        # corpus/ queries/ qrels/ subdirectories
        self.data_dir = data_dir

    def detect_primary_key_type(self) -> Literal["bigint", "string"]:
        return "string"

    def _load(self, subset: str):
        if self._data is not None:
            return self._data
        repo = f"mteb/{self.task_name.lower()}"
        return {
            "corpus": load_hf_dataset(repo, "corpus", split="corpus", data_dir=self.data_dir),
            "queries": load_hf_dataset(repo, "queries", split="queries", data_dir=self.data_dir),
            "qrels": load_hf_dataset(repo, "default", split=subset, data_dir=self.data_dir),
        }

    def ingest(self, subset: str = "test", query_limit=None, min_corpus_cnt=None) -> None:
        service = self._require_service()
        data = self._load(subset)
        rng = random.Random(RANDOM_SEED)

        qrels: dict[str, dict[str, int]] = {}
        for row in data["qrels"]:
            score = int(row.get("score", 1))
            qrels.setdefault(str(row["query-id"]), {})[str(row["corpus-id"])] = score

        qids = sample_ids([str(r["_id"]) for r in data["queries"] if str(r["_id"]) in qrels],
                          query_limit, rng)
        qid_set = set(qids)
        queries = {str(r["_id"]): r["text"] for r in data["queries"]}

        gold: set[str] = set()
        if min_corpus_cnt is not None:
            for qid in qids:
                gold.update(d for d, s in qrels.get(qid, {}).items() if s >= self.score_threshold)

        from autorag_research_tpu_torch.data.hf_util import gold_preserving_subsample

        corpus_rows = list(data["corpus"])
        corpus_ids = [str(r["_id"]) for r in corpus_rows]
        if min_corpus_cnt is not None:
            keep = set(gold_preserving_subsample(corpus_ids, gold, min_corpus_cnt, rng))
            corpus_rows = [r for r in corpus_rows if str(r["_id"]) in keep]
            corpus_ids = [str(r["_id"]) for r in corpus_rows]
        corpus_set = set(corpus_ids)

        service.add_queries([{"id": qid, "contents": queries[qid]} for qid in qids])
        service.add_chunks(
            [
                {
                    "id": str(r["_id"]),
                    "contents": ((r.get("title") or "") + " " + (r.get("text") or "")).strip(),
                }
                for r in corpus_rows
            ]
        )
        for qid in qids:
            gt_ids = [
                d for d, s in qrels.get(qid, {}).items()
                if s >= self.score_threshold and d in corpus_set
            ]
            if gt_ids:
                service.add_retrieval_gt(qid, or_all(gt_ids), chunk_type="text")
        service.clean()
