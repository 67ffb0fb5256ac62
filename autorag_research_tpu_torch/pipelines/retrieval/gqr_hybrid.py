"""GQR: Guided Query Refinement hybrid retrieval.

Capability parity with the reference ``pipelines/retrieval/gqr_hybrid.py:181``:
test-time optimization of the primary query embedding guided by a
complementary retriever's score distribution over a shared candidate pool —

1. fetch candidate pools from the primary (dense) and complementary
   retrievers;
2. per step: build softmax distributions from primary cosine scores and the
   (fixed) complementary scores; form a consensus target distribution
   (geometric mixture); ascend the query vector along the cosine-score
   gradient toward the target (vectorized numpy, as in the reference);
3. rerank the union pool by the refined query's cosine scores.

Falls back to score-space refinement when candidate embeddings are missing
(same degradation note as the reference header). The port's copy of the
JAX package's ``pipelines/retrieval/gqr_hybrid.py``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np

from autorag_research_tpu_torch.config import BasePipelineConfig
from autorag_research_tpu_torch.pipelines.retrieval.base import BaseRetrievalPipeline


def _softmax(x: np.ndarray, temperature: float) -> np.ndarray:
    if x.size == 0:
        return x
    t = max(temperature, 1e-6)
    z = (x - x.max()) / t
    e = np.exp(z)
    s = e.sum()
    if not np.isfinite(s) or s <= 0:
        return np.full_like(x, 1.0 / x.size)
    return e / s


def _missing_floor(scores: dict) -> float:
    if not scores:
        return 0.0
    vals = list(scores.values())
    return min(vals) - max(1.0, max(vals) - min(vals))


class GQRHybridPipeline(BaseRetrievalPipeline):

    def __init__(
        self,
        catalog,
        name: str = "gqr_hybrid",
        primary_retrieval_pipeline=None,
        complementary_retrieval_pipeline=None,
        n_steps: int = 25,
        lr: float = 0.05,
        temperature: float = 1.0,
        consensus_weight: float = 0.5,
        pool_multiplier: int = 4,
    ):
        self.primary = primary_retrieval_pipeline
        self.complementary = complementary_retrieval_pipeline
        self.n_steps = n_steps
        self.lr = lr
        self.temperature = temperature
        self.consensus_weight = consensus_weight
        self.pool_multiplier = pool_multiplier
        self.retrieval_unit = getattr(
            primary_retrieval_pipeline, "retrieval_unit", "chunk"
        )
        super().__init__(catalog, name)

    def _get_pipeline_config(self) -> dict[str, Any]:
        return {
            "type": "gqr_hybrid",
            "n_steps": self.n_steps,
            "lr": self.lr,
            "temperature": self.temperature,
            "consensus_weight": self.consensus_weight,
            "retrieval_unit": self.retrieval_unit,
        }

    def _candidate_embeddings(self, doc_ids: list, multi: bool = False) -> dict[Any, np.ndarray]:
        out = {}
        for did in doc_ids:
            emb = self.catalog.get_embedding("chunk", did, multi=multi)
            if emb is not None:
                if multi:
                    n = np.linalg.norm(emb, axis=1, keepdims=True)
                    out[did] = emb / np.where(n == 0, 1.0, n)
                else:
                    n = np.linalg.norm(emb)
                    out[did] = emb / n if n > 0 else emb
        return out

    def _refine_multi(
        self,
        q_mat: np.ndarray,           # [T, d] query token vectors
        cand_mats: list[np.ndarray],
        comp_dist: np.ndarray,
        pool_ids: list,
        top_k: int,
    ) -> list[dict]:
        """MaxSim variant (reference ``_maxsim_scores``/``_maxsim_gradients``
        ``gqr_hybrid.py:93-122``): score = sum of per-query-token maxes / nq;
        the argmax doc vectors are the subgradient wrt the query matrix."""
        nq = max(len(q_mat), 1)
        norms = np.linalg.norm(q_mat, axis=1, keepdims=True)
        q = q_mat / np.where(norms == 0, 1.0, norms)

        def scores_and_grads(qm):
            scores = np.empty(len(cand_mats))
            grads = []
            for i, m in enumerate(cand_mats):
                sims = qm @ m.T  # [T, Ti]
                arg = sims.argmax(axis=1)
                scores[i] = sims.max(axis=1).sum() / nq
                grads.append(m[arg] / nq)  # [T, d]
            return scores, grads

        for _ in range(self.n_steps):
            scores, grads = scores_and_grads(q)
            primary_dist = _softmax(scores, self.temperature)
            target = (
                self.consensus_weight * primary_dist
                + (1 - self.consensus_weight) * comp_dist
            )
            weights = target - primary_dist
            step = np.zeros_like(q)
            for w, g in zip(weights, grads):
                step += w * g
            q = q + self.lr * step
            n = np.linalg.norm(q, axis=1, keepdims=True)
            q = q / np.where(n == 0, 1.0, n)
        final, _ = scores_and_grads(q)

        from autorag_research_tpu_torch.ops.fusion import id_tiebreak_sort

        order = id_tiebreak_sort(
            zip(pool_ids, final), lambda t: t[1], lambda t: t[0]
        )[:top_k]
        return [{"doc_id": d, "score": float(s)} for d, s in order]

    def _refine(
        self,
        query_vec: np.ndarray,
        primary_hits: list[dict],
        comp_hits: list[dict],
        top_k: int,
    ) -> list[dict]:
        pool_ids = list(
            dict.fromkeys([h["doc_id"] for h in primary_hits] + [h["doc_id"] for h in comp_hits])
        )
        comp_map = {h["doc_id"]: float(h["score"]) for h in comp_hits}
        comp_floor = _missing_floor(comp_map)
        comp_scores = np.array([comp_map.get(d, comp_floor) for d in pool_ids])

        if query_vec is not None and np.asarray(query_vec).ndim == 2:
            # multi-vector primary: MaxSim refinement (argmax subgradients)
            mv_map = self._candidate_embeddings(pool_ids, multi=True)
            if len(mv_map) == len(pool_ids):
                return self._refine_multi(
                    np.asarray(query_vec, np.float32),
                    [mv_map[d] for d in pool_ids],
                    _softmax(comp_scores, self.temperature),
                    pool_ids,
                    top_k,
                )
            query_vec = None  # degrade to score-space below
        emb_map = self._candidate_embeddings(pool_ids)

        if len(emb_map) == len(pool_ids) and query_vec is not None:
            # embedding-space refinement (primary path)
            cand = np.stack([emb_map[d] for d in pool_ids])  # [P, d] normalized
            q = query_vec / (np.linalg.norm(query_vec) or 1.0)
            comp_dist = _softmax(comp_scores, self.temperature)
            for _ in range(self.n_steps):
                cos = cand @ q  # normalized cand; q kept ~unit
                primary_dist = _softmax(cos, self.temperature)
                target = (
                    self.consensus_weight * primary_dist
                    + (1 - self.consensus_weight) * comp_dist
                )
                # gradient of sum_i (target_i - primary_i) * cos_i wrt q
                weights = target - primary_dist
                grad = cand.T @ weights
                q = q + self.lr * grad
                q = q / (np.linalg.norm(q) or 1.0)
            final = cand @ q
        else:
            # degraded score-space fallback (reference's fallback loop)
            prim_map = {h["doc_id"]: float(h["score"]) for h in primary_hits}
            prim_floor = _missing_floor(prim_map)
            final = np.array([prim_map.get(d, prim_floor) for d in pool_ids])
            comp_dist = _softmax(comp_scores, self.temperature)
            for _ in range(self.n_steps):
                primary_dist = _softmax(final, self.temperature)
                target = (
                    self.consensus_weight * primary_dist
                    + (1 - self.consensus_weight) * comp_dist
                )
                final = final + self.lr * (target - primary_dist)

        from autorag_research_tpu_torch.ops.fusion import id_tiebreak_sort

        order = id_tiebreak_sort(
            zip(pool_ids, final), lambda t: t[1], lambda t: t[0]
        )[:top_k]
        return [{"doc_id": d, "score": float(s)} for d, s in order]

    async def _retrieve_by_id(self, query_id, top_k):
        fetch_k = top_k * self.pool_multiplier
        primary_hits = await self.primary._retrieve_by_id(query_id, fetch_k)
        comp_hits = await self.complementary._retrieve_by_id(query_id, fetch_k)
        multi = getattr(self.primary, "search_mode", "single") == "multi"
        qvec = self.catalog.get_embedding("query", query_id, multi=multi)
        return self._refine(qvec, primary_hits, comp_hits, top_k)

    async def _retrieve_by_text(self, query_text, top_k):
        fetch_k = top_k * self.pool_multiplier
        primary_hits = await self.primary._retrieve_by_text(query_text, fetch_k)
        comp_hits = await self.complementary._retrieve_by_text(query_text, fetch_k)
        qvec = None
        model = getattr(self.primary, "embedding_model", None)
        if model is not None:
            if hasattr(model, "aembed_texts_multi"):
                # multi-vector primary: keep the [T, d] query matrix so
                # _refine takes the MaxSim branch like the id path does
                # (MultiVectorEmbedding has no aembed_query)
                qvec = np.asarray((await model.aembed_texts_multi([query_text]))[0])
            else:
                qvec = np.asarray(await model.aembed_query(query_text))
        return self._refine(qvec, primary_hits, comp_hits, top_k)


@dataclass(kw_only=True)
class GQRHybridConfig(BasePipelineConfig):
    config_type = "gqr_hybrid"
    kind = "retrieval"

    retrieval_pipeline_1_name: str  # primary (dense)
    retrieval_pipeline_2_name: str  # complementary
    n_steps: int = 25
    lr: float = 0.05
    temperature: float = 1.0
    consensus_weight: float = 0.5
    pool_multiplier: int = 4

    def build(self, catalog, context):
        return GQRHybridPipeline(
            catalog,
            name=self.name,
            primary_retrieval_pipeline=context.load_pipeline(self.retrieval_pipeline_1_name),
            complementary_retrieval_pipeline=context.load_pipeline(self.retrieval_pipeline_2_name),
            n_steps=self.n_steps,
            lr=self.lr,
            temperature=self.temperature,
            consensus_weight=self.consensus_weight,
            pool_multiplier=self.pool_multiplier,
        )
