"""Ingestion service: bulk catalog writes + the embedding loop.

Behavioral parity with the reference ``orm/service/base_ingestion.py:82-817``
(+ text/multimodal variants): bulk add of chunks/queries/relations, and the
resumable embedding loop — count un-embedded rows, fetch batches excluding
rows that already failed this run (quarantine, ``:386-401``), embed with
bounded async concurrency, partition success/failure, persist. The
multi-vector path writes ragged token matrices (reference's PG array
literals, ``orm/repository/base.py:428-485``).

Device embedders (``embeddings/torch_encoder.py``) are batch-synchronous:
the loop calls them with full batches instead of per-item coroutines; API
embedders still fan out under the concurrency limit.

The port's copy of the JAX package's ``store/ingestion.py``. The pipelined
path takes the embedder's device tensor (``embed_texts_device``) and reads it
back to the host only for the catalog write, so the blobs are the same bytes
as the JAX package writes for the same float32 vectors.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Any, Sequence

import numpy as np
import torch

from autorag_research_tpu_torch.store.catalog import Catalog

logger = logging.getLogger("AutoRAG-Research-TPU")


def _to_host(arr) -> np.ndarray:
    """A batch of device embeddings as a float32 host array."""
    if isinstance(arr, torch.Tensor):
        return arr.detach().to(torch.float32).cpu().numpy()
    return np.asarray(arr, np.float32)


@dataclass
class EmbedStats:
    total: int = 0
    embedded: int = 0
    failed_ids: list = field(default_factory=list)


class IngestionService:
    def __init__(self, catalog: Catalog):
        self.catalog = catalog

    # ------------------------------------------------------------- bulk adds
    def add_chunks(self, rows: Sequence[dict]) -> int:
        return self.catalog.add_chunks(rows)

    def add_queries(self, rows: Sequence[dict]) -> int:
        return self.catalog.add_queries(rows)

    def add_image_chunks(self, rows: Sequence[dict]) -> int:
        return self.catalog.add_image_chunks(rows)

    def add_files(self, rows) -> None:
        self.catalog.add_files(rows)

    def add_documents(self, rows) -> None:
        self.catalog.add_documents(rows)

    def add_pages(self, rows) -> None:
        self.catalog.add_pages(rows)

    def add_retrieval_gt(self, query_id, gt, chunk_type: str = "chunk") -> int:
        # accept the reference's "text"/"image" names as well
        mapped = {"text": "chunk", "image": "image_chunk"}.get(chunk_type, chunk_type)
        return self.catalog.add_retrieval_gt(query_id, gt, mapped, upsert=True)

    def clean(self) -> dict:
        return self.catalog.clean()

    def stats(self) -> dict:
        return self.catalog.stats()

    # -------------------------------------------------------- embedding loop
    def embed_table(
        self,
        embedding_model,
        table: str = "chunk",
        batch_size: int = 256,
        multi: bool = False,
        image: bool = False,
        max_batches: int | None = None,
    ) -> EmbedStats:
        """Embed every row of ``table`` lacking an embedding. Resumable: rows
        with embeddings are skipped by construction; rows that fail are
        quarantined for this run and reported."""
        stats = EmbedStats(total=self.catalog.count_unembedded(table, multi=multi))
        if stats.total == 0:
            return stats
        logger.info("embedding %d %s rows (multi=%s)", stats.total, table, multi)
        if not multi and not image and hasattr(embedding_model, "embed_texts_device"):
            return self._embed_table_pipelined(
                embedding_model, table, batch_size, stats, max_batches
            )
        batches_done = 0
        after = None  # every row up to this id is embedded or quarantined
        while True:
            rows = self.catalog.fetch_unembedded(
                table, batch_size, exclude_ids=stats.failed_ids, multi=multi, after_id=after
            )
            if not rows or (max_batches is not None and batches_done >= max_batches):
                break
            batches_done += 1
            ids = [r["id"] for r in rows]
            after = ids[-1]
            if image:
                inputs: list[Any] = [r["image"] for r in rows]
            else:
                inputs = [r["contents"] for r in rows]
            try:
                if multi:
                    if image:
                        mats = embedding_model.embed_images_multi(inputs)
                    else:
                        mats = embedding_model.embed_texts_multi(inputs)
                    good = [
                        (rid, np.asarray(m, np.float32))
                        for rid, m in zip(ids, mats)
                        if m is not None and len(m)
                    ]
                    self.catalog.set_multi_embeddings(table, good)
                else:
                    if image:
                        vecs = embedding_model.embed_images(inputs)
                    else:
                        vecs = embedding_model.embed_texts(inputs)
                    good = [(rid, v) for rid, v in zip(ids, vecs) if v is not None]
                    self.catalog.set_embeddings(table, good)
                stats.embedded += len(good)
                bad = set(ids) - {rid for rid, _ in good}
                stats.failed_ids.extend(bad)
            except Exception as exc:  # noqa: BLE001 - batch-level quarantine
                logger.warning("embed batch failed (%s); retrying per item", exc)
                for rid, item in zip(ids, inputs):
                    try:
                        if multi:
                            m = (
                                embedding_model.embed_images_multi([item])
                                if image
                                else embedding_model.embed_texts_multi([item])
                            )[0]
                            if m is None or not len(m):
                                # same guard as the batch path: an EMPTY
                                # matrix stored here breaks every subsequent
                                # multi-vector read of the whole table
                                raise ValueError("empty multi-vector matrix")
                            self.catalog.set_multi_embeddings(
                                table, [(rid, np.asarray(m, np.float32))]
                            )
                        else:
                            v = (
                                embedding_model.embed_images([item])
                                if image
                                else embedding_model.embed_texts([item])
                            )[0]
                            self.catalog.set_embeddings(table, [(rid, v)])
                        stats.embedded += 1
                    except Exception as item_exc:  # noqa: BLE001
                        logger.warning("quarantining %s row %s: %s", table, rid, item_exc)
                        stats.failed_ids.append(rid)
        if stats.failed_ids:
            logger.warning(
                "%d %s rows failed embedding: %s",
                len(stats.failed_ids), table, stats.failed_ids[:10],
            )
        return stats

    def _embed_rows_per_item(
        self, embedding_model, table: str, ids, texts, stats: EmbedStats
    ) -> None:
        """Per-item quarantine fallback (shared by the sync and pipelined
        paths): embed each row alone; rows that still fail are quarantined
        for this run (reference ``base_ingestion.py:386-401``)."""
        for rid, text in zip(ids, texts):
            try:
                v = embedding_model.embed_texts([text])[0]
                if v is None:
                    raise ValueError("embedder returned None")
                self.catalog.set_embeddings(table, [(rid, v)])
                stats.embedded += 1
            except Exception as item_exc:  # noqa: BLE001
                logger.warning("quarantining %s row %s: %s", table, rid, item_exc)
                stats.failed_ids.append(rid)

    def _embed_table_pipelined(
        self, embedding_model, table: str, batch_size: int,
        stats: EmbedStats, max_batches: int | None,
    ) -> EmbedStats:
        """Double-buffered device embedding for single-vector text tables.

        Dispatch batch i+1 BEFORE reading back batch i: CUDA launches are
        asynchronous, so the host tokenizes and enqueues the next batch
        while the device still computes the previous one; the readback
        (which waits for the device) and the catalog write follow.
        Resume/quarantine semantics identical to the synchronous path."""
        batches_done = 0
        pending: tuple | None = None  # (ids, texts, device array)
        inflight: list = []
        after = None  # every row up to this id is written, in flight or quarantined
        while True:
            rows = []
            if max_batches is None or batches_done < max_batches:
                rows = self.catalog.fetch_unembedded(
                    table, batch_size,
                    exclude_ids=list(stats.failed_ids) + inflight, after_id=after,
                )
            ids: list = []
            texts: list = []
            dev = None
            if rows:
                batches_done += 1
                ids = [r["id"] for r in rows]
                texts = [r["contents"] for r in rows]
                after = ids[-1]
                try:
                    dev = embedding_model.embed_texts_device(texts)
                except Exception as exc:  # noqa: BLE001 - batch-level quarantine
                    logger.warning(
                        "device embed dispatch failed (%s); retrying per item", exc
                    )
                    self._embed_rows_per_item(embedding_model, table, ids, texts, stats)
                    ids, texts = [], []
            if pending is not None:
                pids, ptexts, parr = pending
                try:
                    vecs = _to_host(parr)  # blocks; overlaps the new dispatch
                    self.catalog.set_embeddings(table, list(zip(pids, vecs)))
                    stats.embedded += len(pids)
                except Exception as exc:  # noqa: BLE001
                    logger.warning(
                        "pipelined embed readback failed (%s); retrying per item", exc
                    )
                    self._embed_rows_per_item(
                        embedding_model, table, pids, ptexts, stats
                    )
            pending = (ids, texts, dev) if dev is not None else None
            inflight = ids if dev is not None else []
            if not rows and pending is None:
                break
        if stats.failed_ids:
            logger.warning(
                "%d %s rows failed embedding: %s",
                len(stats.failed_ids), table, stats.failed_ids[:10],
            )
        return stats

    def embed_all(self, embedding_model, batch_size: int = 256) -> dict[str, EmbedStats]:
        """Single-vector: chunks + queries (reference ``data/base.py:57-89``)."""
        if self.catalog.embedding_dim is None:
            dim = getattr(embedding_model, "dim", None) or embedding_model.health_check()
            self.catalog.embedding_dim = int(dim)
        return {
            "chunk": self.embed_table(embedding_model, "chunk", batch_size),
            "query": self.embed_table(embedding_model, "query", batch_size),
        }

    def embed_all_late_interaction(
        self, embedding_model, batch_size: int = 64, image: bool = False
    ) -> dict[str, EmbedStats]:
        """Multi-vector: chunks/image-chunks + queries
        (reference ``data/base.py:90-125``)."""
        if self.catalog.embedding_dim is None:
            dim = getattr(embedding_model, "dim", None) or embedding_model.health_check()
            self.catalog.embedding_dim = int(dim)
        table = "image_chunk" if image else "chunk"
        return {
            table: self.embed_table(
                embedding_model, table, batch_size, multi=True, image=image
            ),
            "query": self.embed_table(embedding_model, "query", batch_size, multi=True),
        }
