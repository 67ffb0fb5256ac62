"""Generic local-files ingestor (JSONL), fully offline.

No direct reference counterpart (the reference always pulls from HF/BEIR
mirrors); this is the self-contained entry path for an offline
deployment and for user-supplied corpora. Format:

- ``corpus.jsonl``: {"id", "contents"} per line
- ``queries.jsonl``: {"id", "contents", optional "generation_gt": [...],
  optional "gt": [[id, ...], ...]} — ``gt`` is AND-of-OR groups.

The port's copy of the JAX package's ``data/local.py``.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Literal

from autorag_research_tpu_torch.data.base import TextDataIngestor
from autorag_research_tpu_torch.data.registry import register_ingestor
from autorag_research_tpu_torch.exceptions import IngestionError
from autorag_research_tpu_torch.store.gt import or_all, and_all_mixed, or_all_mixed, text


@register_ingestor(
    name="local",
    description="Local JSONL corpus + queries (+ optional GT groups)",
    aliases=("jsonl",),
)
class LocalJSONLIngestor(TextDataIngestor):
    def __init__(self, embedding_model=None, data_dir: str = "."):
        super().__init__(embedding_model)
        self.data_dir = Path(data_dir)
        if not (self.data_dir / "corpus.jsonl").exists():
            raise IngestionError(f"no corpus.jsonl under {self.data_dir}")

    def detect_primary_key_type(self) -> Literal["bigint", "string"]:
        with open(self.data_dir / "corpus.jsonl", encoding="utf-8") as f:
            first = json.loads(next(iter(f)))
        return "bigint" if isinstance(first["id"], int) else "string"

    def ingest(
        self,
        subset: str = "test",
        query_limit: int | None = None,
        min_corpus_cnt: int | None = None,
    ) -> None:
        service = self._require_service()
        chunks = []
        with open(self.data_dir / "corpus.jsonl", encoding="utf-8") as f:
            for line in f:
                row = json.loads(line)
                chunks.append({"id": row["id"], "contents": row["contents"]})
        service.add_chunks(chunks)

        queries_path = self.data_dir / "queries.jsonl"
        if not queries_path.exists():
            return
        query_rows = []
        gt_rows = []
        with open(queries_path, encoding="utf-8") as f:
            for line in f:
                if query_limit is not None and len(query_rows) >= query_limit:
                    break
                row = json.loads(line)
                query_rows.append(
                    {
                        "id": row["id"],
                        "contents": row["contents"],
                        "query_to_llm": row.get("query_to_llm"),
                        "generation_gt": row.get("generation_gt"),
                    }
                )
                gt = row.get("gt")
                if gt:
                    groups = [or_all_mixed([text(i) for i in group]) for group in gt]
                    expr = groups[0]
                    for g in groups[1:]:
                        expr = expr & g
                    gt_rows.append((row["id"], expr))
        service.add_queries(query_rows)
        for qid, expr in gt_rows:
            service.add_retrieval_gt(qid, expr)
        service.clean()
