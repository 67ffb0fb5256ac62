"""Dense cells: the program's ``DenseIndex`` over a corpus of the configuration's law.

The corpus is drawn on the device from the seed and handed to the index as
one host array of raw rows, as a catalog hands it; the index normalizes,
uploads and builds its own device state. A call is ``DenseIndex.search`` of
one page of raw query embeddings (a host array), the call every dense
retrieval pipeline makes.
"""

from __future__ import annotations

import numpy as np
import torch

from autorag_research_tpu_torch.index.dense import DenseIndex
from portbench import inputs


def make_corpus(cfg: dict, seed: int, device: torch.device) -> dict:
    return {"rows": inputs.dense_rows_host(cfg["corpus"], seed, int(cfg["n_docs"]), int(cfg["dim"]), device)}


def make_pool(cfg: dict, traffic: dict, seed: int, corpus: dict) -> list[np.ndarray]:
    """``pool_calls`` pages of ``queries_per_call`` query embeddings."""
    q, calls = int(traffic["queries_per_call"]), int(traffic["pool_calls"])
    rows = inputs.dense_queries(traffic["query"], seed, q * calls, int(cfg["dim"]))
    return [rows[i * q : (i + 1) * q] for i in range(calls)]


def build_index(cfg: dict, corpus: dict, device: torch.device) -> DenseIndex:
    """The index as a pipeline builds it; the raw rows are released to it."""
    index = DenseIndex(range(int(cfg["n_docs"])), corpus.pop("rows"), metric=cfg["metric"],
                       dtype=cfg["dtype"], mode=cfg["mode"], device=device)
    return index.to_device()


def search(index: DenseIndex, page: np.ndarray, k: int) -> list:
    return index.search(page, k)


def proof_failures(index: DenseIndex) -> int | None:
    """Queries of the last call whose verified proof failed (None: no proof)."""
    return None if index.last_stats is None else int(index.last_stats[0])


def work_shape(cfg: dict, traffic: dict, corpus: dict) -> dict:
    return {"queries": int(traffic["queries_per_call"]), "n": int(cfg["n_docs"]),
            "d": int(cfg["dim"]), "k": int(traffic["k"])}
