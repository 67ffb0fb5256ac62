"""VisRAG and Korean visual-document benchmarks.

Capability parity with the reference ``data/visrag.py`` (459),
``sds_kopub_vdr.py`` (384), ``kovidorev2.py`` (451): all follow the
corpus/queries/qrels split shape over page images; the VisRAG collections add
``generation_gt`` answers for the generation track.

The port's copy of the JAX package's ``data/visrag.py``.
"""

from __future__ import annotations

import random
from typing import Literal

from autorag_research_tpu_torch.data.base import MultiModalDataIngestor, RANDOM_SEED
from autorag_research_tpu_torch.data.hf_util import load_hf_dataset, sample_ids
from autorag_research_tpu_torch.data.registry import register_ingestor
from autorag_research_tpu_torch.data.vidore import _SplitVidore, image_to_png_bytes
from autorag_research_tpu_torch.store.gt import image as image_gt, or_all


@register_ingestor(
    name="visrag",
    description="VisRAG page-image QA (retrieval + generation GT)",
    hf_repo="visrag-dumps",
)
class VisRAGIngestor(MultiModalDataIngestor):
    def __init__(
        self,
        embedding_model=None,
        dataset_name: str = "openbmb/VisRAG-Ret-Test-ArxivQA",
        data=None,
    ):
        super().__init__(embedding_model)
        self.dataset_name = dataset_name
        self._data = data

    def detect_primary_key_type(self) -> Literal["bigint", "string"]:
        return "string"

    def _load(self):
        if self._data is not None:
            return self._data
        return {
            "corpus": load_hf_dataset(self.dataset_name, "corpus", split="train"),
            "queries": load_hf_dataset(self.dataset_name, "queries", split="train"),
            "qrels": load_hf_dataset(self.dataset_name, "qrels", split="train"),
        }

    def ingest(self, subset: str = "test", query_limit=None, min_corpus_cnt=None) -> None:
        # subset is accepted-but-ignored ON PURPOSE: VisRAG collections ship a
        # single 'train' split (reference data/visrag.py:376-380 documents the
        # same); min_corpus_cnt subsamples gold-preserving like the reference
        service = self._require_service()
        data = self._load()
        rng = random.Random(RANDOM_SEED)

        qrels: dict[str, dict[str, int]] = {}
        for row in data["qrels"]:
            qid = str(row.get("query-id", row.get("query_id")))
            did = str(row.get("corpus-id", row.get("corpus_id")))
            qrels.setdefault(qid, {})[did] = int(row.get("score", 1))

        query_rows = {}
        for r in data["queries"]:
            qid = str(r.get("query-id", r.get("query_id", r.get("_id"))))
            query_rows[qid] = r
        # queries must have text contents (empty rows would crash embedding)
        usable = [
            q for q in query_rows
            if q in qrels
            and (query_rows[q].get("query") or query_rows[q].get("text"))
        ]
        qids = sample_ids(usable, query_limit, rng)

        pages = {}
        for r in data["corpus"]:
            did = str(r.get("corpus-id", r.get("corpus_id", r.get("_id"))))
            pages[did] = r["image"]

        if min_corpus_cnt is not None and min_corpus_cnt < len(pages):
            # gold-ID-preserving subsampling (reference _filter_corpus:
            # keep every selected query's gold pages, fill remaining slots
            # deterministically)
            gold = {d for q in qids for d, s in qrels[q].items() if s > 0 and d in pages}
            others = sorted(set(pages) - gold)
            fill = rng.sample(others, min(max(0, min_corpus_cnt - len(gold)), len(others)))
            keep = gold | set(fill)
            pages = {d: img for d, img in pages.items() if d in keep}

        service.add_image_chunks(
            [
                {"id": d, "image": image_to_png_bytes(img), "mimetype": "image/png"}
                for d, img in pages.items()
            ]
        )
        service.add_queries(
            [
                {
                    "id": qid,
                    "contents": query_rows[qid].get("query") or query_rows[qid].get("text"),
                    "generation_gt": [query_rows[qid]["answer"]]
                    if query_rows[qid].get("answer")
                    else None,
                }
                for qid in qids
            ]
        )
        for qid in qids:
            gt_ids = [d for d, s in qrels[qid].items() if s > 0 and d in pages]
            if gt_ids:
                service.add_retrieval_gt(
                    qid, or_all(gt_ids, wrapper_fn=image_gt), chunk_type="image"
                )


@register_ingestor(
    name="sds_kopub_vdr",
    description="SDS KoPub VDR Korean visual document retrieval",
    hf_repo="sds_kopub_vdr-dumps",
)
class SDSKoPubVDRIngestor(_SplitVidore):
    """Korean public-document VDR: page images + OCR text chunks, graded
    qrels with image/text/mixed modes (reference ``sds_kopub_vdr.py:99-365``;
    no multi-hop — GT is always OR alternatives, ``:349``)."""

    dataset_name = "SamsungSDS-Research/KoPub-VDR-benchmark"
    text_field = "text"


@register_ingestor(
    name="kovidorev2",
    description="KoViDoRe v2 Korean visual document retrieval",
    hf_repo="kovidorev2-dumps",
)
class KoViDoReV2Ingestor(_SplitVidore):
    """KoViDoRe v2: page images + markdown text chunks, graded qrels with
    image/text/mixed modes, multi-hop AND queries (reference
    ``kovidorev2.py:56-433``)."""

    dataset_name = "yjoonjang/kovidore-v2-public"
    text_field = "markdown"
    supports_multi_hop = True
