"""Multi-vector cells: the program's ``MultiVectorIndex`` over pages of token vectors.

The pages are drawn on the device from the seed and handed to the index as a
list of host token matrices [T_i, d] of raw vectors, as a catalog hands them;
the index normalizes, pads and uploads them. A call is
``MultiVectorIndex.search`` of one page of query token matrices, the call a
multi-vector retrieval pipeline makes.
"""

from __future__ import annotations

import numpy as np
import torch

from autorag_research_tpu_torch.index.multi_vector import MultiVectorIndex
from portbench import inputs


def make_corpus(cfg: dict, seed: int, device: torch.device) -> dict:
    tokens, lens = inputs.pages_host(cfg["corpus"], seed, int(cfg["n_docs"]), int(cfg["dim"]), device)
    return {"tokens": tokens, "lens": lens}


def make_pool(cfg: dict, traffic: dict, seed: int, corpus: dict) -> list[list[np.ndarray]]:
    """``pool_calls`` pages of ``queries_per_call`` query token matrices."""
    q, calls = int(traffic["queries_per_call"]), int(traffic["pool_calls"])
    mats = inputs.gold_page_queries(traffic["query"], seed, q * calls, corpus["tokens"], corpus["lens"])
    return [mats[i * q : (i + 1) * q] for i in range(calls)]


def build_index(cfg: dict, corpus: dict, device: torch.device) -> MultiVectorIndex:
    """The index as a pipeline builds it; the raw tokens are released to it."""
    tokens, lens = corpus.pop("tokens"), corpus["lens"]
    mats = [tokens[i, : lens[i]] for i in range(len(lens))]
    del tokens
    index = MultiVectorIndex(range(len(mats)), mats, normalize=True, mode=cfg["mode"], device=device)
    del mats
    return index.to_device()


def search(index: MultiVectorIndex, page: list, k: int) -> list:
    return index.search(page, k)


def proof_failures(index: MultiVectorIndex) -> int | None:
    """Queries of the last call whose verified proof failed (None: no proof)."""
    return None if index.last_stats is None else int(index.last_stats[0])


def work_shape(cfg: dict, traffic: dict, corpus: dict) -> dict:
    q = int(traffic["queries_per_call"])
    return {"queries": q, "query_tokens": q * int(traffic["query"]["tokens"]),
            "page_tokens": int(corpus["lens"].sum()), "d": int(cfg["dim"]), "k": int(traffic["k"])}
