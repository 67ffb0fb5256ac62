"""HEAVEN: two-stage visual retrieval with query-vector budgeting.

Capability parity with the reference ``pipelines/retrieval/heaven.py:142``:

1. stage 1 — single-vector cosine search over image chunks produces
   ``stage1_candidate_count`` candidates;
2. the multi-vector query is split into "key" vectors (first
   ``ceil(ratio * n)``) and the remainder;
3. key vectors MaxSim-score all candidates; the top
   ``max(top_k, ceil(|candidates| * stage2_refine_ratio))`` survive;
4. non-key vectors score only the refined set;
5. final score = stage1_weight * stage1 + (1 - stage1_weight) *
   normalized MaxSim (key + non-key where available), top_k returned.

MaxSim over candidate subsets runs vectorized numpy (candidate pools are
small); the full-corpus stage uses the device DenseIndex.

The port's copy of the JAX package's ``pipelines/retrieval/heaven.py``.
Stage 1 is the exact ``DenseIndex`` over ``image_chunk`` on the pipeline's
device (``"cuda"`` unless the caller asks for another), from the index
registry under the key an ``image_vector_search`` in single mode uses, so
the two share one index. The candidate MaxSim stays host numpy, as in the
JAX package. With a ``mesh`` the stage-1 index is row-sharded over it
(``index/registry.py::shard``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from autorag_research_tpu_torch.config import BasePipelineConfig
from autorag_research_tpu_torch.exceptions import EmbeddingMissingError
from autorag_research_tpu_torch.index import registry
from autorag_research_tpu_torch.index.dense import DenseIndex
from autorag_research_tpu_torch.pipelines.retrieval.base import BaseRetrievalPipeline


def estimate_key_vector_count(query_text: str, total: int, default_ratio: float) -> int:
    """Budget: one key vector per distinct content word, bounded to [1, total];
    falls back to the default ratio when the text gives no signal."""
    words = {w for w in query_text.lower().split() if len(w) > 2}
    if words:
        return max(1, min(total, len(words)))
    return max(1, min(total, math.ceil(total * default_ratio)))


def maxsim_subset(query_vectors: np.ndarray, doc_matrices: dict) -> dict:
    """Normalized MaxSim of query vectors against each candidate's matrix."""
    if query_vectors.size == 0:
        return dict.fromkeys(doc_matrices, 0.0)
    out = {}
    nq = len(query_vectors)
    for did, mat in doc_matrices.items():
        if mat is None or len(mat) == 0:
            out[did] = 0.0
            continue
        sims = query_vectors @ np.asarray(mat).T  # [nq, nd]
        out[did] = float(sims.max(axis=1).sum() / nq)
    return out


class HEAVENPipeline(BaseRetrievalPipeline):
    retrieval_unit = "image_chunk"

    def __init__(
        self,
        catalog,
        name: str = "heaven",
        stage1_candidate_count: int = 200,
        stage2_refine_ratio: float = 0.25,
        stage1_weight: float = 0.3,
        default_key_token_ratio: float = 0.5,
        single_vector_embedding_model=None,
        multi_vector_embedding_model=None,
        mesh=None,
        device: str | torch.device = "cuda",
    ):
        if stage1_candidate_count <= 0:
            raise ValueError("stage1_candidate_count must be positive")
        if not 0 < stage2_refine_ratio <= 1:
            raise ValueError("stage2_refine_ratio must be in (0, 1]")
        if not 0 <= stage1_weight <= 1:
            raise ValueError("stage1_weight must be in [0, 1]")
        self.stage1_candidate_count = stage1_candidate_count
        self.stage2_refine_ratio = stage2_refine_ratio
        self.stage1_weight = stage1_weight
        self.default_key_token_ratio = default_key_token_ratio
        self.single_model = single_vector_embedding_model
        self.multi_model = multi_vector_embedding_model
        self.device = torch.device(device)
        self.mesh = mesh
        super().__init__(catalog, name)

    def _get_pipeline_config(self) -> dict[str, Any]:
        return {
            "type": "heaven",
            "retrieval_unit": self.retrieval_unit,
            "stage1_candidate_count": self.stage1_candidate_count,
            "stage2_refine_ratio": self.stage2_refine_ratio,
            "stage1_weight": self.stage1_weight,
        }

    def _stage1_index(self) -> DenseIndex:
        idx = registry.get_or_build(
            self.catalog,
            "dense",
            "image_chunk",
            builder=lambda: DenseIndex.from_catalog(self.catalog, "image_chunk", device=self.device),
            device=self.device,
        )
        return idx if self.mesh is None else registry.shard(idx, self.mesh)

    def _candidate_multi(self, ids: list) -> dict:
        out = {}
        for did in ids:
            mat = self.catalog.get_embedding("image_chunk", did, multi=True)
            if mat is not None:
                out[did] = mat
        return out

    def _search(self, query_text: str, single_vec, multi_mat, top_k: int):
        limit = max(top_k, self.stage1_candidate_count)
        stage1 = self._stage1_index().search(np.atleast_2d(single_vec), limit)[0]
        if not stage1:
            return []
        stage1_hits = [{"doc_id": h.doc_id, "score": h.score} for h in stage1]
        candidate_ids = [h["doc_id"] for h in stage1_hits]
        cand_multi = self._candidate_multi(candidate_ids)
        multi_mat = np.asarray(multi_mat) if multi_mat is not None else None
        if not cand_multi or multi_mat is None or len(multi_mat) == 0:
            return stage1_hits[:top_k]

        n_key = estimate_key_vector_count(
            query_text, len(multi_mat), self.default_key_token_ratio
        )
        key_vecs, non_key_vecs = multi_mat[:n_key], multi_mat[n_key:]
        key_scores = maxsim_subset(key_vecs, cand_multi)

        refine_count = min(
            len(candidate_ids),
            max(top_k, math.ceil(len(candidate_ids) * self.stage2_refine_ratio)),
        )
        refined = sorted(candidate_ids, key=lambda d: -key_scores.get(d, 0.0))[:refine_count]
        non_key_scores = (
            maxsim_subset(non_key_vecs, {d: cand_multi[d] for d in refined if d in cand_multi})
            if len(non_key_vecs)
            else {}
        )

        # reference ``_combine_heaven_scores`` (heaven.py:83-103): every
        # stage-1 candidate is scored (key + stage1); only refined candidates
        # also receive the non-key contribution
        refined_set = set(refined)
        stage1_map = {h["doc_id"]: h["score"] for h in stage1_hits}
        final = []
        for did in candidate_ids:
            late = key_scores.get(did, 0.0) + (
                non_key_scores.get(did, 0.0) if did in refined_set else 0.0
            )
            score = self.stage1_weight * stage1_map.get(did, 0.0) + (1 - self.stage1_weight) * late
            final.append({"doc_id": did, "score": float(score)})
        from autorag_research_tpu_torch.ops.fusion import id_tiebreak_sort

        final = id_tiebreak_sort(final, lambda h: h["score"], lambda h: h["doc_id"])
        return final[:top_k]

    def _stored_query(self, query_id):
        row = self.catalog.get_query(query_id)
        if row is None:
            raise ValueError(f"query {query_id} not found")
        single = self.catalog.get_embedding("query", query_id)
        multi = self.catalog.get_embedding("query", query_id, multi=True)
        if single is None:
            raise EmbeddingMissingError(f"query {query_id} has no single-vector embedding")
        if multi is None:
            raise EmbeddingMissingError(f"query {query_id} has no multi-vector embeddings")
        return row["contents"], single, multi

    async def _retrieve_by_id(self, query_id, top_k):
        text, single, multi = self._stored_query(query_id)
        return self._search(text, single, multi, top_k)

    async def _retrieve_by_text(self, query_text, top_k):
        if self.single_model is None or self.multi_model is None:
            raise EmbeddingMissingError("heaven needs both embedding models for text queries")
        single = await self.single_model.aembed_query(query_text)
        multi = (await self.multi_model.aembed_texts_multi([query_text]))[0]
        return self._search(query_text, single, multi, top_k)


@dataclass(kw_only=True)
class HEAVENConfig(BasePipelineConfig):
    config_type = "heaven"
    kind = "retrieval"

    stage1_candidate_count: int = 200
    stage2_refine_ratio: float = 0.25
    stage1_weight: float = 0.3
    default_key_token_ratio: float = 0.5
    single_vector_embedding_model: Any = None
    multi_vector_embedding_model: Any = None

    def build(self, catalog, context):
        return HEAVENPipeline(
            catalog,
            name=self.name,
            stage1_candidate_count=self.stage1_candidate_count,
            stage2_refine_ratio=self.stage2_refine_ratio,
            stage1_weight=self.stage1_weight,
            default_key_token_ratio=self.default_key_token_ratio,
            single_vector_embedding_model=context.load_embedding(self.single_vector_embedding_model),
            multi_vector_embedding_model=context.load_embedding(self.multi_vector_embedding_model),
            mesh=context.mesh,
            device=context.device,
        )
