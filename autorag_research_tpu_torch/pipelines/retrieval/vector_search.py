"""Vector search pipeline (single-vector cosine / multi-vector MaxSim).

Counterpart of ``autorag_research_tpu/pipelines/retrieval/vector_search.py``:

- ``search_mode="single"``: cosine top-k over the index of ``index_type``:
  ``"exact"`` the :class:`DenseIndex` (modes through
  ``index_options={"mode": ...}``), ``"ivf"`` the :class:`IVFIndex`,
  ``"ivf_contiguous"`` the :class:`IVFContiguousIndex` (ANN); score = cosine
  similarity (the reference's ``1 - distance``). ``index_options`` are the
  index's build options and part of its cache and artifact identity, so two
  configs with different options never share an index. A JAX config's
  ``device`` option of ``ivf_contiguous`` (``"tpu"`` / ``"host"``) is read as
  its placement.
- ``search_mode="multi"``: MaxSim over the :class:`MultiVectorIndex`; score =
  MaxSim / n_query_vectors. ``maxsim_prefilter`` opts into the two-stage
  proxy prefilter plus exact rerank.

With a ``mesh`` (``BuildContext(mesh=)``) the index is placed over it on
first use (``index/registry.py::shard``): dense and multi-vector indexes
row-sharded, IVF as per-shard sub-indexes; ``ivf_contiguous`` has no sharded
form and is refused at its first search.

The batch path scores every pending query of a page in one search.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Literal

import numpy as np
import torch

from autorag_research_tpu_torch.config import BasePipelineConfig
from autorag_research_tpu_torch.exceptions import EmbeddingMissingError
from autorag_research_tpu_torch.index import registry
from autorag_research_tpu_torch.index.dense import DenseIndex
from autorag_research_tpu_torch.index.ivf import IVFIndex
from autorag_research_tpu_torch.index.ivf_contiguous import IVFContiguousIndex, placement_of
from autorag_research_tpu_torch.index.multi_vector import MultiVectorIndex
from autorag_research_tpu_torch.pipelines.retrieval.base import BaseRetrievalPipeline


# index_type -> (registry kind, index class) of a single-vector search
_INDEX_CLASSES = {
    "exact": ("dense", DenseIndex),
    "ivf": ("ivf", IVFIndex),
    "ivf_contiguous": ("ivf_contiguous", IVFContiguousIndex),
}


class VectorSearchPipeline(BaseRetrievalPipeline):
    retrieval_unit = "chunk"

    def __init__(
        self,
        catalog,
        name: str = "vector_search",
        search_mode: Literal["single", "multi"] = "single",
        embedding_model=None,
        table: str = "chunk",
        index_type: Literal["exact", "ivf", "ivf_contiguous"] = "exact",
        index_options: dict | None = None,
        maxsim_prefilter: int | None = None,
        device: str | torch.device = "cuda",
        mesh=None,
    ):
        if search_mode not in ("single", "multi"):
            raise ValueError(f"unknown search_mode: {search_mode}")
        if index_type not in _INDEX_CLASSES:
            raise ValueError(f"unknown index_type: {index_type!r} (one of {', '.join(_INDEX_CLASSES)})")
        self.search_mode = search_mode
        self.embedding_model = embedding_model
        self.table = table
        self.index_type = index_type
        self.index_options = index_options or {}
        # multi mode only: two-stage search over k * maxsim_prefilter candidates
        self.maxsim_prefilter = maxsim_prefilter
        self.device = torch.device(device)
        self.mesh = mesh
        # result persistence routes by the searched table
        self.retrieval_unit = "image_chunk" if table == "image_chunk" else "chunk"
        super().__init__(catalog, name)

    def _get_pipeline_config(self) -> dict[str, Any]:
        # the JAX package's config keys, so both packages see one pipeline
        return {
            "type": "vector_search",
            "search_mode": self.search_mode,
            "retrieval_unit": self.retrieval_unit,
            "table": self.table,
            "index_type": self.index_type,
            "index_options": self.index_options,
            "maxsim_prefilter": self.maxsim_prefilter,
        }

    # ------------------------------------------------------------------ index
    def _index(self):
        if self.search_mode == "multi":  # index_type is for single vectors
            kind, cls = "multi_vector", MultiVectorIndex
        else:
            kind, cls = _INDEX_CLASSES[self.index_type]
        options = dict(self.index_options)
        if kind == "ivf_contiguous" and "device" in options:
            options["placement"] = placement_of(options.pop("device"))
        idx = registry.get_or_build(
            self.catalog,
            kind,
            self.table,
            builder=lambda: cls.from_catalog(self.catalog, self.table, device=self.device, **options),
            device=self.device,
            **{str(k): str(v) for k, v in sorted(options.items())},
        )
        if self.mesh is None:
            return idx
        if kind == "ivf_contiguous":  # its JAX to_device takes no mesh either
            raise ValueError("ivf_contiguous has no mesh-sharded form; run it without a mesh")
        return registry.shard(idx, self.mesh)

    # ----------------------------------------------------------------- search
    def _query_embeddings(self, query_ids: list[Any]):
        multi = self.search_mode == "multi"
        embs = []
        for qid in query_ids:
            e = self.catalog.get_embedding("query", qid, multi=multi)
            if e is None:
                raise EmbeddingMissingError(
                    f"query {qid} has no {'multi-vector ' if multi else ''}embedding"
                )
            embs.append(e)
        return embs

    def _multi_search(self, idx, mats, top_k):
        if self.maxsim_prefilter:
            return idx.search(mats, top_k, prefilter=self.maxsim_prefilter)
        return idx.search(mats, top_k)

    def search_by_embedding(self, embedding, top_k: int) -> list[dict[str, Any]]:
        """Direct search from a raw embedding (a [Tq, d] matrix in multi mode)."""
        idx = self._index()
        if self.search_mode == "multi":
            hits = self._multi_search(idx, [np.atleast_2d(embedding)], top_k)[0]
        else:
            hits = idx.search(np.atleast_2d(embedding), top_k)[0]
        return [h.as_dict() for h in hits]

    def _retrieve_batch_by_ids(
        self, query_ids, top_k, max_concurrency=16, max_retries=3, retry_delay=1.0
    ):
        idx = self._index()
        out: dict[Any, Any] = {}
        valid_ids, embs = [], []
        for qid in query_ids:
            try:
                embs.append(self._query_embeddings([qid])[0])
                valid_ids.append(qid)
            except EmbeddingMissingError as exc:
                out[qid] = exc
        if valid_ids:
            if self.search_mode == "multi":
                batches = self._multi_search(idx, embs, top_k)
            else:
                batches = idx.search(np.stack(embs), top_k)
            for qid, hits in zip(valid_ids, batches):
                out[qid] = [h.as_dict() for h in hits]
        return out

    def _retrieve_batch_by_texts(self, texts, top_k):
        """Serving hot path: one batched embed + one search for the whole
        micro-batch; an on-device single-vector embedder chains into the
        search with no device -> host copy in between."""
        if self.embedding_model is None:
            raise EmbeddingMissingError("no embedding model configured for text retrieval")
        idx = self._index()
        if self.search_mode == "multi":
            mats = self.embedding_model.embed_texts_multi(list(texts))
            batches = self._multi_search(idx, mats, top_k)
        elif hasattr(self.embedding_model, "embed_texts_device"):
            batches = idx.search(self.embedding_model.embed_texts_device(list(texts)), top_k)
        else:
            batches = idx.search(np.asarray(self.embedding_model.embed_texts(list(texts))), top_k)
        return [[h.as_dict() for h in hits] for hits in batches]

    async def _retrieve_by_id(self, query_id, top_k):
        res = self._retrieve_batch_by_ids([query_id], top_k)[query_id]
        if isinstance(res, BaseException):
            raise res
        return res

    async def _retrieve_by_text(self, query_text, top_k):
        if self.embedding_model is None:
            raise EmbeddingMissingError("no embedding model configured for text retrieval")
        if self.search_mode == "multi":
            mat = (await self.embedding_model.aembed_texts_multi([query_text]))[0]
            return self.search_by_embedding(mat, top_k)
        vec = await self.embedding_model.aembed_query(query_text)
        return self.search_by_embedding(vec, top_k)


@dataclass(kw_only=True)
class VectorSearchConfig(BasePipelineConfig):
    config_type = "vector_search"
    kind = "retrieval"

    search_mode: str = "single"
    embedding_model: Any = None
    table: str = "chunk"
    index_type: str = "exact"
    index_options: dict | None = None
    maxsim_prefilter: int | None = None

    def build(self, catalog, context):
        return VectorSearchPipeline(
            catalog,
            name=self.name,
            search_mode=self.search_mode,  # type: ignore[arg-type]
            embedding_model=context.load_embedding(self.embedding_model),
            table=self.table,
            index_type=self.index_type,  # type: ignore[arg-type]
            index_options=self.index_options,
            maxsim_prefilter=self.maxsim_prefilter,
            device=context.device,
            mesh=context.mesh,
        )
