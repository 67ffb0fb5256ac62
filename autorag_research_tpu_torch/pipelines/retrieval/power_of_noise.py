"""Power of Noise: inject seeded random corpus noise into retrieval results.

Capability parity with the reference ``pipelines/retrieval/power_of_noise.py:64``
("The Power of Noise: Redefining Retrieval for RAG Systems"): wrap a base
retriever, sample noise documents from the corpus with a fixed seed, and place
them at a configured position (retrieved_first / noise_first / interleave).
``answer_aware_random`` mode excludes the query's ground-truth documents from
the noise pool so noise is guaranteed irrelevant.

Persisted scores encode the constructed order (results are read back sorted by
rel_score desc): position i gets score (n - i).

The port's copy of the JAX package's ``pipelines/retrieval/power_of_noise.py``:
the same noise draw (``random.Random(f"{seed}:{seed_key}").sample`` over the
ids in ``id`` order), so both packages inject the same noise, id for id.
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Any

from autorag_research_tpu_torch.config import BasePipelineConfig
from autorag_research_tpu_torch.pipelines.retrieval.base import BaseRetrievalPipeline


class PowerOfNoisePipeline(BaseRetrievalPipeline):
    def __init__(
        self,
        catalog,
        name: str = "power_of_noise",
        base_retrieval_pipeline=None,
        noise_count: int = 0,
        noise_ratio: float | None = None,
        noise_order: str = "retrieved_first",
        noise_mode: str = "random",
        seed: int = 0,
    ):
        if noise_count < 0:
            raise ValueError("noise_count must be >= 0")
        if noise_ratio is not None and not 0 <= noise_ratio <= 1:
            raise ValueError("noise_ratio must be in [0, 1]")
        if noise_order not in ("retrieved_first", "noise_first", "interleave"):
            raise ValueError(f"unknown noise_order: {noise_order}")
        if noise_mode not in ("random", "answer_aware_random"):
            raise ValueError(f"unknown noise_mode: {noise_mode}")
        self.base = base_retrieval_pipeline
        self.noise_count = noise_count
        self.noise_ratio = noise_ratio
        self.noise_order = noise_order
        self.noise_mode = noise_mode
        self.seed = seed
        self.retrieval_unit = getattr(base_retrieval_pipeline, "retrieval_unit", "chunk")
        super().__init__(catalog, name)

    def _get_pipeline_config(self) -> dict[str, Any]:
        return {
            "type": "power_of_noise",
            "noise_count": self.noise_count,
            "noise_ratio": self.noise_ratio,
            "noise_order": self.noise_order,
            "noise_mode": self.noise_mode,
            "seed": self.seed,
            "retrieval_unit": self.retrieval_unit,
        }

    def _n_noise(self, top_k: int) -> int:
        # reference _resolve_noise_count (power_of_noise.py:132-143): noise is
        # CAPPED at top_k and noise_count takes precedence over noise_ratio
        if top_k <= 0:
            return 0
        if self.noise_count > 0:
            return min(top_k, self.noise_count)
        if self.noise_ratio is None:
            return 0
        return min(top_k, max(0, round(top_k * self.noise_ratio)))

    def _sample_noise(
        self, exclude: set, n: int, query_id: Any | None, seed_key: Any = None
    ) -> list:
        if n <= 0:
            return []
        # sample from the table matching the base pipeline's unit so image
        # pipelines get image noise (and never cross-table ids)
        unit = self.retrieval_unit if self.retrieval_unit in ("chunk", "image_chunk") else "chunk"
        gt_col = "chunk_id" if unit == "chunk" else "image_chunk_id"
        if self.noise_mode == "answer_aware_random" and query_id is not None:
            for rel in self.catalog.get_relations_by_query(query_id):
                if rel[gt_col] is not None:
                    exclude.add(rel[gt_col])
            if unit == "chunk":
                # the reference additionally excludes any chunk whose CONTENTS
                # contain a generation answer (power_of_noise.py:206-213) —
                # "guaranteed irrelevant" noise must not carry the answer text
                row = self.catalog.get_query(query_id)
                answers = []
                if row is not None and row["generation_gt"]:
                    import json as _json

                    answers = [
                        a.casefold() for a in _json.loads(row["generation_gt"]) if a
                    ]
                if answers:
                    lookup = self.catalog.get_chunk_contents(
                        [i for i in self._noise_pool(unit) if i not in exclude]
                    )
                    for cid, contents in lookup.items():
                        text = (contents or "").casefold()
                        if any(a in text for a in answers):
                            exclude.add(cid)
        pool = [i for i in self._noise_pool(unit) if i not in exclude]
        rng = random.Random(f"{self.seed}:{seed_key}")
        return rng.sample(pool, min(n, len(pool)))

    def _noise_pool(self, unit: str) -> list:
        # the corpus is immutable during a run: fetch the id list ONCE per
        # pipeline instance instead of O(N) rows per query
        cache = getattr(self, "_noise_pool_cache", None)
        if cache is None or cache[0] != unit:
            rows = self.catalog.connect().execute(
                f"SELECT id FROM {unit} ORDER BY id"
            ).fetchall()
            cache = (unit, [r["id"] for r in rows])
            self._noise_pool_cache = cache
        return cache[1]

    def _compose(self, retrieved: list[dict], noise_ids: list) -> list[dict]:
        noise = [{"doc_id": nid, "score": None} for nid in noise_ids]
        if self.noise_order == "retrieved_first":
            ordered = retrieved + noise
        elif self.noise_order == "noise_first":
            ordered = noise + retrieved
        else:  # interleave
            ordered = []
            for i in range(max(len(retrieved), len(noise))):
                if i < len(retrieved):
                    ordered.append(retrieved[i])
                if i < len(noise):
                    ordered.append(noise[i])
        n = len(ordered)
        return [
            {"doc_id": h["doc_id"], "score": float(n - i)} for i, h in enumerate(ordered)
        ]

    async def _retrieve_by_id(self, query_id, top_k):
        n_noise = self._n_noise(top_k)
        base_k = max(top_k - n_noise, 0)
        # reference: skip the base call entirely at base_top_k == 0
        retrieved = (
            await self.base._retrieve_by_id(query_id, base_k) if base_k > 0 else []
        )
        noise = self._sample_noise(
            {h["doc_id"] for h in retrieved}, n_noise, query_id, seed_key=query_id
        )
        return self._compose(retrieved, noise)

    async def _retrieve_by_text(self, query_text, top_k):
        n_noise = self._n_noise(top_k)
        base_k = max(top_k - n_noise, 0)
        retrieved = (
            await self.base._retrieve_by_text(query_text, base_k) if base_k > 0 else []
        )
        # seed by the query TEXT (reference _build_seed_key) — seeding every
        # text query identically would inject the same noise set everywhere
        noise = self._sample_noise(
            {h["doc_id"] for h in retrieved}, n_noise, None, seed_key=query_text
        )
        return self._compose(retrieved, noise)


@dataclass(kw_only=True)
class PowerOfNoiseConfig(BasePipelineConfig):
    config_type = "power_of_noise"
    kind = "retrieval"

    base_retrieval_pipeline_name: str
    noise_count: int = 0
    noise_ratio: float | None = None
    noise_order: str = "retrieved_first"
    noise_mode: str = "random"
    seed: int = 0

    def build(self, catalog, context):
        return PowerOfNoisePipeline(
            catalog,
            name=self.name,
            base_retrieval_pipeline=context.load_pipeline(self.base_retrieval_pipeline_name),
            noise_count=self.noise_count,
            noise_ratio=self.noise_ratio,
            noise_order=self.noise_order,
            noise_mode=self.noise_mode,
            seed=self.seed,
        )
