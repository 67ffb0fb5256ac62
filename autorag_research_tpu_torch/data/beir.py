"""BEIR benchmark ingestor.

Behavioral parity with the reference ``data/beir.py:42-199``:

- gold-ID-preserving corpus subsampling with seed 42 (``RANDOM_SEED``): sample
  ``query_limit`` queries, collect their positive qrel doc ids, keep all gold
  docs plus random fill up to ``min_corpus_cnt``;
- chunk contents = ``title + " " + text`` stripped;
- GT: hotpotqa -> ``and_all`` (multi-hop), every other dataset -> ``or_all``;
  only qrels with score > 0 count, and only for docs kept in the corpus;
- string/bigint primary-key detection from the id types.

Data source: a BEIR-format directory (``corpus.jsonl``, ``queries.jsonl``,
``qrels/{split}.tsv``). With network access the standard BEIR zip is
downloaded to the cache dir; offline deployments pass ``data_dir`` pointing at
an existing copy.

The port's copy of the JAX package's ``data/beir.py``; ``_download`` uses only
the standard library.
"""

from __future__ import annotations

import csv
import json
import random
from pathlib import Path
from typing import Literal

from autorag_research_tpu_torch.data.base import DATA_DIR, RANDOM_SEED, TextDataIngestor
from autorag_research_tpu_torch.data.registry import register_ingestor
from autorag_research_tpu_torch.exceptions import IngestionError
from autorag_research_tpu_torch.store.gt import and_all, or_all

BEIR_DATASETS = Literal[
    "msmarco", "trec-covid", "nfcorpus", "nq", "hotpotqa", "fiqa",
    "arguana", "webis-touche2020", "cqadupstack", "quora", "dbpedia-entity",
    "scidocs", "fever", "climate-fever", "scifact",
]

BEIR_URL = "https://public.ukp.informatik.tu-darmstadt.de/thakur/BEIR/datasets/{name}.zip"


def load_beir_dir(data_dir: Path, split: str = "test"):
    """Read BEIR-format files -> (corpus dict, queries dict, qrels dict)."""
    corpus = {}
    with open(data_dir / "corpus.jsonl", encoding="utf-8") as f:
        for line in f:
            row = json.loads(line)
            corpus[str(row["_id"])] = {
                "title": row.get("title", ""),
                "text": row.get("text", ""),
            }
    queries = {}
    with open(data_dir / "queries.jsonl", encoding="utf-8") as f:
        for line in f:
            row = json.loads(line)
            queries[str(row["_id"])] = row["text"]
    qrels: dict[str, dict[str, int]] = {}
    qrels_path = data_dir / "qrels" / f"{split}.tsv"
    with open(qrels_path, encoding="utf-8") as f:
        reader = csv.reader(f, delimiter="\t")
        header = next(reader, None)
        if header and header[0] not in ("query-id", "qid"):
            f.seek(0)
            reader = csv.reader(f, delimiter="\t")
        for row in reader:
            if len(row) < 3:
                continue
            qid, did, score = str(row[0]), str(row[1]), int(float(row[2]))
            qrels.setdefault(qid, {})[did] = score
    # only keep queries present in this split's qrels (BEIR convention)
    queries = {qid: q for qid, q in queries.items() if qid in qrels}
    return corpus, queries, qrels


@register_ingestor(
    name="beir",
    description="BEIR benchmark datasets for information retrieval",
    hf_repo="beir-dumps",
)
class BEIRIngestor(TextDataIngestor):
    def __init__(
        self,
        embedding_model=None,
        dataset_name: str = "scifact",
        data_dir: str | None = None,
    ):
        super().__init__(embedding_model)
        self.dataset_name = dataset_name
        if data_dir is not None:
            self.data_path = Path(data_dir)
        else:
            self.data_path = DATA_DIR / "beir" / dataset_name
            if not self.data_path.exists():
                self._download()
        if not (self.data_path / "corpus.jsonl").exists():
            raise IngestionError(
                f"BEIR data not found at {self.data_path}; pass data_dir= pointing "
                "to an extracted BEIR dataset (corpus.jsonl/queries.jsonl/qrels/)"
            )

    def _download(self) -> None:
        import io
        import urllib.request
        import zipfile

        url = BEIR_URL.format(name=self.dataset_name)
        self.data_path.parent.mkdir(parents=True, exist_ok=True)
        try:
            with urllib.request.urlopen(url, timeout=120) as resp:
                payload = resp.read()
        except Exception as exc:  # noqa: BLE001
            raise IngestionError(
                f"cannot download BEIR '{self.dataset_name}' (offline?); "
                f"pass data_dir= with a local copy"
            ) from exc
        with zipfile.ZipFile(io.BytesIO(payload)) as zf:
            zf.extractall(self.data_path.parent)
        extracted = self.data_path.parent / self.dataset_name
        if extracted != self.data_path:
            extracted.rename(self.data_path)

    def detect_primary_key_type(self) -> Literal["bigint", "string"]:
        corpus, queries, _ = load_beir_dir(self.data_path)
        ids = list(corpus) + list(queries)
        return "string" if any(not i.isdigit() for i in ids) else "bigint"

    def ingest(
        self,
        subset: str = "test",
        query_limit: int | None = None,
        min_corpus_cnt: int | None = None,
    ) -> None:
        service = self._require_service()
        corpus, queries, qrels = load_beir_dir(self.data_path, subset)
        rng = random.Random(RANDOM_SEED)

        # 1. sample queries (+ collect gold ids when subsampling the corpus)
        qids = list(queries)
        if query_limit is not None and query_limit < len(qids):
            qids = rng.sample(qids, query_limit)
        gold_ids: set[str] = set()
        kept_qrels = {}
        for qid in qids:
            if qid not in qrels:
                continue
            kept_qrels[qid] = qrels[qid]
            if min_corpus_cnt is not None:
                gold_ids.update(d for d, s in qrels[qid].items() if s > 0)

        # 2. gold-preserving corpus filter
        from autorag_research_tpu_torch.data.hf_util import gold_preserving_subsample

        corpus_ids = gold_preserving_subsample(list(corpus), gold_ids, min_corpus_cnt, rng)
        corpus_set = set(corpus_ids)

        # 3. write
        service.add_queries([{"id": qid, "contents": queries[qid]} for qid in qids])
        service.add_chunks(
            [
                {
                    "id": cid,
                    "contents": (corpus[cid]["title"] + " " + corpus[cid]["text"]).strip(),
                }
                for cid in corpus_ids
            ]
        )
        for qid, rel in kept_qrels.items():
            gt_ids = [d for d, s in rel.items() if s > 0 and d in corpus_set]
            if not gt_ids:
                continue
            expr = and_all(gt_ids) if self.dataset_name == "hotpotqa" else or_all(gt_ids)
            service.add_retrieval_gt(qid, expr, chunk_type="text")
        service.clean()
