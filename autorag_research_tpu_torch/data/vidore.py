"""ViDoRe visual document retrieval ingestors (v1 / v2 / v3).

Capability parity with the reference ``data/vidore.py`` (314),
``vidorev2.py`` (285), ``vidorev3.py`` (492): document page images become
ImageChunk rows (PNG bytes + mimetype), queries carry text, and qrels map
queries to relevant pages. v1 collections are single datasets with
query/image pairs per row; v2/v3 ship corpus/queries/qrels splits.

The port's copy of the JAX package's ``data/vidore.py``; the pages are
embedded by whichever image embedder the ingestor is given.
"""

from __future__ import annotations

import io
import random
from typing import Literal

from autorag_research_tpu_torch.data.base import MultiModalDataIngestor, RANDOM_SEED
from autorag_research_tpu_torch.data.hf_util import load_hf_dataset, sample_ids
from autorag_research_tpu_torch.data.registry import register_ingestor
from autorag_research_tpu_torch.store.gt import (
    and_all_mixed,
    image as image_gt,
    or_all_mixed,
    text as text_gt,
)


def image_to_png_bytes(img) -> bytes:
    """PIL image (or raw bytes) -> PNG bytes."""
    if isinstance(img, (bytes, bytearray)):
        return bytes(img)
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    return buf.getvalue()


class _VidoreBase(MultiModalDataIngestor):
    def detect_primary_key_type(self) -> Literal["bigint", "string"]:
        return "string"

    def _write_pages(self, service, pages: dict, page_links: dict | None = None) -> None:
        page_links = page_links or {}
        service.add_image_chunks(
            [
                {
                    "id": pid,
                    "image": image_to_png_bytes(img),
                    "mimetype": "image/png",
                    "page_id": page_links.get(pid),
                }
                for pid, img in pages.items()
            ]
        )


@register_ingestor(
    name="vidore",
    description="ViDoRe v1 visual document retrieval (query/page pairs)",
    hf_repo="vidore-dumps",
)
class ViDoReIngestor(_VidoreBase):
    def __init__(
        self,
        embedding_model=None,
        dataset_name: str = "vidore/docvqa_test_subsampled",
        data=None,
        data_dir: str | None = None,
    ):
        super().__init__(embedding_model)
        self.dataset_name = dataset_name
        self._data = data
        self.data_dir = data_dir  # local datasets.save_to_disk snapshot

    def _load(self, subset: str):
        if self._data is not None:
            return self._data
        return load_hf_dataset(self.dataset_name, split=subset, data_dir=self.data_dir)

    def ingest(self, subset: str = "test", query_limit=None, min_corpus_cnt=None) -> None:
        service = self._require_service()
        rows = list(self._load(subset))
        rng = random.Random(RANDOM_SEED)
        picked = sample_ids(list(range(len(rows))), query_limit, rng)

        pages: dict[str, object] = {}
        query_rows = []
        gts = []
        for i in picked:
            row = rows[i]
            qid = f"{self.dataset_name.split('/')[-1]}_q{i}"
            page_id = str(row.get("image_filename", f"page_{i}"))
            pages[page_id] = row["image"]
            query_text = row.get("query") or row.get("question") or ""
            if not query_text:
                continue
            query_rows.append({"id": qid, "contents": query_text})
            gts.append((qid, page_id))
        service.add_queries(query_rows)
        for qid, page_id in gts:
            service.add_retrieval_gt(qid, image_gt(page_id), chunk_type="image")
        self._write_pages(service, pages)


class _SplitVidore(_VidoreBase):
    """corpus/queries/qrels-split visual benchmarks (ViDoRe v2/v3 shape).

    Capability parity with the reference split-shape family
    (``data/vidorev2.py``, ``kovidorev2.py:56-433``, ``sds_kopub_vdr.py:99-365``,
    ``vidorev3.py:348-474``):

    - ``qrels_mode``: how qrels map to chunks — ``"image"`` (ImageChunk only,
      default), ``"text"`` (text chunks built from the corpus' page-text
      column), ``"mixed"`` (per page, text OR image satisfies the qrel).
      Text/mixed require a corpus with a ``text_field`` column (markdown/OCR);
      image-only collections (ViDoRe v2) reject them at construction.
    - graded relevance: qrels ``score`` values (>0; score=0 rows are dropped,
      reference ``vidorev3.py:375``) are carried onto every GT item so graded
      nDCG sees the true grades via ``relevance_scores``.
    - multi-hop: collections whose queries carry ``query_types`` containing
      ``"multi-hop"`` get AND semantics across pages (reference
      ``kovidorev2.py:349,406-408``, ``vidorev3.py:436-437``).
    """

    dataset_name: str = ""
    # corpus column carrying page text ("markdown" for KoViDoRe/ViDoRe v3,
    # "text" for SDS KoPub); None = image-only collection
    text_field: str | None = None
    # AND semantics for queries tagged "multi-hop" in query_types
    supports_multi_hop: bool = False

    def __init__(
        self, embedding_model=None, dataset_name: str | None = None, data=None,
        data_dir: str | None = None, qrels_mode: str = "image",
    ):
        super().__init__(embedding_model)
        if dataset_name:
            self.dataset_name = dataset_name
        if qrels_mode not in ("image", "text", "mixed"):
            raise ValueError(f"qrels_mode must be image|text|mixed, got {qrels_mode!r}")
        if qrels_mode != "image" and self.text_field is None:
            raise ValueError(
                f"{type(self).__name__} is an image-only collection "
                f"(no page-text column); qrels_mode={qrels_mode!r} needs one"
            )
        self.qrels_mode = qrels_mode
        self._data = data
        self.data_dir = data_dir  # local datasets.save_to_disk snapshot

    def _load(self):
        if self._data is not None:
            return self._data
        return {
            "corpus": load_hf_dataset(self.dataset_name, "corpus", split="test", data_dir=self.data_dir),
            "queries": load_hf_dataset(self.dataset_name, "queries", split="test", data_dir=self.data_dir),
            "qrels": load_hf_dataset(self.dataset_name, "qrels", split="test", data_dir=self.data_dir),
        }

    def _write_hierarchy(self, service, data, pages: dict) -> dict:
        """Optional document/page hierarchy (ViDoRe v3). Returns
        ``{corpus_id: page_db_id}`` links for the image chunks."""
        return {}

    def ingest(self, subset: str = "test", query_limit=None, min_corpus_cnt=None) -> None:
        service = self._require_service()
        data = self._load()
        rng = random.Random(RANDOM_SEED)

        # graded qrels, score>0 only (score=0 means "judged not relevant")
        qrels: dict[str, dict[str, int]] = {}
        for row in data["qrels"]:
            qid = str(row.get("query-id", row.get("query_id")))
            did = str(row.get("corpus-id", row.get("corpus_id")))
            score = int(row.get("score", 1))
            if score > 0:
                qrels.setdefault(qid, {})[did] = score

        queries: dict[str, dict] = {}
        for r in data["queries"]:
            qid = str(r.get("query-id", r.get("query_id", r.get("_id"))))
            queries[qid] = r
        usable = [
            q for q in queries
            if q in qrels and (queries[q].get("query") or queries[q].get("text"))
        ]
        qids = sample_ids(usable, query_limit, rng)

        from autorag_research_tpu_torch.data.hf_util import gold_preserving_subsample

        pages: dict[str, object] = {}
        texts: dict[str, str] = {}
        for r in data["corpus"]:
            did = str(r.get("corpus-id", r.get("corpus_id", r.get("_id"))))
            pages[did] = r["image"]
            if self.text_field:
                t = str(r.get(self.text_field) or "").strip()
                if t:
                    texts[did] = t
        if min_corpus_cnt is not None:
            gold = {d for q in qids for d in qrels.get(q, {})}
            keep = set(gold_preserving_subsample(list(pages), gold, min_corpus_cnt, rng))
            pages = {d: img for d, img in pages.items() if d in keep}
            texts = {d: t for d, t in texts.items() if d in keep}

        service.add_queries(
            [
                {
                    "id": qid,
                    "contents": queries[qid].get("query") or queries[qid].get("text"),
                    "generation_gt": [queries[qid]["answer"]]
                    if queries[qid].get("answer")
                    else None,
                }
                for qid in qids
            ]
        )
        for qid in qids:
            pairs = [(d, s) for d, s in qrels[qid].items() if d in pages]
            qt = queries[qid].get("query_types")
            multi_hop = (
                self.supports_multi_hop
                and isinstance(qt, (list, tuple))
                and "multi-hop" in qt
            )
            gt = self._build_gt(pairs, texts.keys(), multi_hop)
            if gt is not None:
                service.add_retrieval_gt(qid, gt, chunk_type=self.qrels_mode)
        page_links = self._write_hierarchy(service, data, pages)
        self._write_pages(service, pages, page_links)
        if texts:
            service.add_chunks([{"id": d, "contents": t} for d, t in texts.items()])

    def _build_gt(self, pairs, text_ids, multi_hop: bool):
        """(corpus_id, score) pairs -> graded GT expression per qrels_mode.

        Same shapes as the reference builders
        (``vidorev3.py:403-474``, ``kovidorev2.py:361-433``): multi-hop ANDs
        across pages; mixed mode makes text/image OR-alternatives per page.
        """
        if not pairs:
            return None
        if self.qrels_mode == "image":
            items = [image_gt(d, score=s) for d, s in pairs]
        elif self.qrels_mode == "text":
            items = [text_gt(d, score=s) for d, s in pairs if d in text_ids]
        else:  # mixed
            groups = []
            for d, s in pairs:
                alts = [image_gt(d, score=s)]
                if d in text_ids:
                    alts.append(text_gt(d, score=s))
                groups.append(alts)
            if multi_hop:
                return and_all_mixed([or_all_mixed(g) for g in groups])
            return or_all_mixed([item for g in groups for item in g])
        if not items:
            return None
        if multi_hop:
            return and_all_mixed(items)
        return or_all_mixed(items)


@register_ingestor(
    name="vidorev2",
    description="ViDoRe v2 visual retrieval (corpus/queries/qrels splits)",
    hf_repo="vidorev2-dumps",
)
class ViDoReV2Ingestor(_SplitVidore):
    dataset_name = "vidore/esg_reports_v2"


@register_ingestor(
    name="vidorev3",
    description="ViDoRe v3 visual retrieval (graded qrels, markdown text chunks, doc hierarchy)",
    hf_repo="vidorev3-dumps",
)
class ViDoReV3Ingestor(_SplitVidore):
    """ViDoRe v3: page images + whole-page markdown text chunks, graded
    qrels with image/text/mixed modes, multi-hop AND queries, and the
    file -> document -> page hierarchy (reference ``vidorev3.py:56-474``).
    Corpus ids serve as both image-chunk and text-chunk ids
    (reference ``vidorev3.py:267``)."""

    dataset_name = "vidore/vidore_v3_industrial"
    text_field = "markdown"
    supports_multi_hop = True

    def _load(self):
        if self._data is not None:
            return self._data
        data = super()._load()
        try:
            data["documents_metadata"] = load_hf_dataset(
                self.dataset_name, "documents_metadata", split="test",
                data_dir=self.data_dir,
            )
        except Exception:  # older snapshots ship without the metadata split
            data["documents_metadata"] = None
        return data

    def _write_hierarchy(self, service, data, pages: dict) -> dict:
        """file/document rows from documents_metadata + one page row per
        (doc_id, page_number_in_doc); image chunks link via page_id
        (reference ``vidorev3.py:202-318``)."""
        by_doc: dict[str, dict] = {}
        page_links: dict[str, str] = {}
        for r in data["corpus"]:
            did = str(r.get("corpus-id", r.get("corpus_id", r.get("_id"))))
            if did not in pages:
                continue
            doc_id = r.get("doc_id")
            if doc_id is None:
                continue
            doc_id = str(doc_id)
            page_num = int(r.get("page_number_in_doc", 0) or 0)
            by_doc.setdefault(doc_id, {})
            page_db_id = f"{doc_id}_p{page_num}"
            by_doc[doc_id][page_num] = page_db_id
            page_links[did] = page_db_id
        if not by_doc:
            return {}

        meta_rows: dict[str, dict] = {}
        meta_split = data.get("documents_metadata")
        if meta_split is not None:
            for r in meta_split:
                meta_rows[str(r.get("doc_id"))] = dict(r)

        doc_ids = sorted(by_doc)
        service.add_files(
            [
                {"id": d, "path": meta_rows.get(d, {}).get("url", "") or ""}
                for d in doc_ids
            ]
        )
        service.add_documents(
            [
                {
                    "id": d,
                    "file_id": d,
                    "title": meta_rows.get(d, {}).get("file_name"),
                    "metadata": {
                        k: meta_rows[d][k]
                        for k in ("doc_type", "doc_language", "doc_year", "license")
                        if d in meta_rows and meta_rows[d].get(k) is not None
                    }
                    or None,
                }
                for d in doc_ids
            ]
        )
        service.add_pages(
            [
                {"id": pid, "document_id": d, "page_number": n}
                for d in doc_ids
                for n, pid in sorted(by_doc[d].items())
            ]
        )
        return page_links
