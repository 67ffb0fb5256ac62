"""Open-RAGBench: arXiv-PDF text + image RAG ingestor.

Capability parity with the reference ``data/open_ragbench.py`` (247 LoC):
questions over arXiv PDFs where both parsed text chunks and page images are
available; text chunks land in ``chunk``, page renders in ``image_chunk``,
and each question's GT references its source chunk/page.

The port's copy of the JAX package's ``data/open_ragbench.py``: ``datasets`` is imported
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
from autorag_research_tpu_torch.data.vidore import image_to_png_bytes
from autorag_research_tpu_torch.store.gt import image as image_gt, or_all_mixed, text as text_gt


def _doc_id(text: str) -> str:
    return "orb_" + hashlib.md5(text.encode("utf-8")).hexdigest()[:16]


@register_ingestor(
    name="open_ragbench",
    description="Open-RAGBench arXiv PDF RAG (text + page images)",
    hf_repo="open_ragbench-dumps",
)
class OpenRAGBenchIngestor(TextDataIngestor):
    def __init__(
        self,
        embedding_model=None,
        hf_path: str = "vectara/open_ragbench",
        data=None,
    ):
        super().__init__(embedding_model)
        self.hf_path = hf_path
        self._data = data

    def detect_primary_key_type(self) -> Literal["bigint", "string"]:
        return "string"

    def embed_all(self, batch_size: int = 256):
        """Text chunks + queries via the text path, PLUS the ingested page
        images when the embedding model can embed images (the reference's
        embed_all override does the same, open_ragbench.py:231-237) — image
        rows must not be dead weight that can never be searched."""
        out = super().embed_all(batch_size)
        if hasattr(self.embedding_model, "embed_image") or hasattr(
            self.embedding_model, "aembed_image"
        ):
            service = self._require_service()
            image_stats = service.embed_table(
                self.embedding_model, "image_chunk", min(batch_size, 64), image=True
            )
            try:
                out["image_chunk"] = image_stats
            except TypeError:
                pass  # embed_all variants returning non-dict stats
        return out

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
        images: dict[str, object] = {}
        queries = []
        gts = []
        for i in picked:
            row = rows[i]
            qid = str(row.get("id", f"orb_q{i}"))
            doc_ids = []
            for text in row.get("contexts") or row.get("chunks") or []:
                if not text:
                    continue
                did = _doc_id(text)
                chunks[did] = text
                doc_ids.append(did)
            page_img = row.get("page_image") or row.get("image")
            page_id = None
            if page_img is not None:
                page_id = f"{qid}_page"
                images[page_id] = page_img
            answer = row.get("answer") or row.get("response")
            queries.append(
                {
                    "id": qid,
                    "contents": row.get("question") or row.get("query", ""),
                    "generation_gt": [answer] if answer else None,
                }
            )
            # mixed-mode GT like the reference (open_ragbench.py:217-229):
            # the source text chunks OR the page image all count as hits
            members = [text_gt(d) for d in doc_ids]
            if page_id is not None:
                members.append(image_gt(page_id))
            if members:
                gts.append((qid, or_all_mixed(members)))

        service.add_chunks([{"id": d, "contents": t} for d, t in chunks.items()])
        if images:
            service.add_image_chunks(
                [
                    {"id": pid, "image": image_to_png_bytes(img), "mimetype": "image/png"}
                    for pid, img in images.items()
                ]
            )
        service.add_queries(queries)
        for qid, gt in gts:
            # items are explicitly wrapped (text/image), so chunk_type only
            # matters for bare ids — none exist here
            service.add_retrieval_gt(qid, gt)
        service.clean()
