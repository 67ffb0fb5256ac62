"""LLM-based rerankers.

Capability parity with the reference's RankGPT / dynamic_rag rerankers
(``rerankers/rankgpt.py``, ``rerankers/dynamic_rag.py``): an instruction-tuned
LLM orders a candidate list.

The port's copy of the JAX package's ``rerankers/llm.py``: the same prompt,
the same sliding order and the same ``_parse_ranking``.
"""

from __future__ import annotations

import re
from typing import Sequence

from autorag_research_tpu_torch.rerankers.base import BaseReranker
from autorag_research_tpu_torch.utils.concurrency import run_async

LISTWISE_PROMPT = (
    "Rank the following {n} passages by relevance to the query.\n"
    "Query: {query}\n\n{passages}\n\n"
    "Output the passage numbers in order of decreasing relevance, separated "
    "by ' > ' (for example: 3 > 1 > 2). Output only the ranking."
)


class LLMListwiseReranker(BaseReranker):
    """RankGPT-style listwise permutation reranking.

    Candidate lists up to ``window`` rank in one LLM call; longer lists use
    the RankGPT sliding-window pass (windows of ``window`` sliding from the
    tail to the head with stride ``window // 2``), so strong tail candidates
    bubble forward without ever exceeding one window per prompt."""

    def __init__(self, llm, window: int = 20):
        self.llm = llm
        self.window = max(2, window)
        self.model_name = f"llm_listwise({getattr(llm, 'model_name', 'llm')})"

    def _rank_window(self, query: str, texts: list[str]) -> list[int]:
        passages = "\n".join(f"[{i + 1}] {t}" for i, t in enumerate(texts))
        prompt = LISTWISE_PROMPT.format(n=len(texts), query=query, passages=passages)
        response = run_async(self.llm.agenerate(prompt))
        return self._parse_ranking(response.text, len(texts))

    def rerank(self, query: str, texts: Sequence[str], top_k: int | None = None):
        if not texts:
            return []
        order = list(range(len(texts)))
        w = self.window
        if len(texts) <= w:
            order = [order[i] for i in self._rank_window(query, list(texts))]
        else:
            step = max(1, w // 2)
            end = len(texts)
            while True:
                start = max(0, end - w)
                seg = order[start:end]
                ranked = self._rank_window(query, [texts[i] for i in seg])
                order[start:end] = [seg[i] for i in ranked]
                if start == 0:
                    break
                end -= step
        # score = descending rank position; unranked passages appended last
        scored = [
            (idx, texts[idx], float(len(texts) - pos))
            for pos, idx in enumerate(order)
        ]
        return self._finalize(scored, top_k)

    @staticmethod
    def _parse_ranking(text: str, n: int) -> list[int]:
        ranked = []
        for tok in re.findall(r"\d+", text):
            idx = int(tok) - 1
            if 0 <= idx < n and idx not in ranked:
                ranked.append(idx)
        for idx in range(n):  # append anything the LLM dropped
            if idx not in ranked:
                ranked.append(idx)
        return ranked
