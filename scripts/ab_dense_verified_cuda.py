#!/usr/bin/env python3
"""Wall time of a verified ``DenseIndex`` search with two or more source trees
in turns, on one NVIDIA GPU.

    python3 scripts/ab_dense_verified_cuda.py PARENT_DIR . . PARENT_DIR

Each tree (a checkout holding ``autorag_research_tpu_torch/``, e.g. a
``git archive`` of the parent commit) runs in its own process, in the order
given: a seeded 500,000 x 768 f32 corpus in a verified ``DenseIndex`` on the
card, 1,024 seeded queries already on the card, k = 10, three warm-up
searches, then 5 x 20 searches, each group timed on the host clock up to a
``torch.cuda.synchronize()``. Prints one JSON line per tree: its path, the
five wall ms a search and the proof's failures. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

N_DOCS, DIM, Q, K = 500_000, 768, 1024, 10


def measure(tree: str) -> dict:
    sys.path.insert(0, tree)
    import numpy as np
    import torch

    from autorag_research_tpu_torch.index.dense import DenseIndex

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    rng = np.random.default_rng(0)
    corpus = rng.standard_normal((N_DOCS, DIM), dtype=np.float32)
    corpus /= np.linalg.norm(corpus, axis=1, keepdims=True)
    idx = DenseIndex(list(range(N_DOCS)), corpus, mode="verified", device="cuda").to_device()
    q = torch.from_numpy(rng.standard_normal((Q, DIM), dtype=np.float32)).cuda()
    for _ in range(3):
        idx.topk_rows(q, K)
    torch.cuda.synchronize()
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(20):
            idx.topk_rows(q, K)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3 / 20)
    return {"tree": tree, "wall_ms": walls, "n_fail": idx.last_stats[0]}


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--one":
        print(json.dumps(measure(sys.argv[2])), flush=True)
        return 0
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    for tree in sys.argv[1:]:
        subprocess.run([sys.executable, __file__, "--one", tree], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
