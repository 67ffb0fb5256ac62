#!/usr/bin/env python3
"""Check corpus-sharded retrieval (``parallel/*``) across the cards of one machine.

    python3 probe_sharded_cards.py [--cpu]

Needs 4 NVIDIA GPUs (``--cpu``: a small rehearsal on 4 CPU "devices" and
gloo). Builds the kernels, then, against one card unsharded, with the ms a
batch of each:

1. one process over a mesh of the 4 cards (``corpus_mesh()``, one shard a
   card, the shards searched in one thread a card): a verified
   ``DenseIndex`` of 500,000 x 768 unit-norm rows, 1,024 queries at k = 10
   (ids equal but at sub-ulp near-ties, #1 once a shard); a flat BM25 index
   of 100,000 Zipf texts, 1,024 queries (hits equal, #3 once a shard); an
   exact and a verified ``MultiVectorIndex`` of 1,500 pages x 512-1,024 x
   128, 128 queries of 32 tokens (ids equal; #9 / #10 once a shard);
2. 4 processes of one card each, joined by NCCL
   (``initialize_distributed``, ``global_corpus_mesh``): the same dense and
   BM25 searches, each process searching its shard and all-gathering the
   lists; rank 0's results against one card's.

Prints one JSON object a part. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from autorag_research_tpu_torch.index.dense import DenseIndex  # noqa: E402
from autorag_research_tpu_torch.index.multi_vector import MultiVectorIndex  # noqa: E402
from autorag_research_tpu_torch.index.sparse import SparseIndex  # noqa: E402
from autorag_research_tpu_torch.ops import dense as td  # noqa: E402
from autorag_research_tpu_torch.ops import maxsim as tm  # noqa: E402
from autorag_research_tpu_torch.ops import sparse as ts  # noqa: E402
from autorag_research_tpu_torch.parallel.mesh import corpus_mesh  # noqa: E402

N_CARDS, K = 4, 10


def sync(cpu: bool) -> None:
    if not cpu:
        torch.cuda.synchronize()


def wall_ms(fn, cpu: bool, reps: int = 5) -> float:
    fn()
    sync(cpu)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    sync(cpu)
    return (time.perf_counter() - t0) * 1e3 / reps


def ids_agree(ids, scores, ref_ids, ref_scores) -> tuple[int, bool]:
    """(mismatches, all within f32 reduction-order resolution)."""
    mism = ids != ref_ids
    diff = np.abs(scores[mism] - ref_scores[mism])
    return int(mism.sum()), bool((diff <= 4e-7 * (1 + np.abs(ref_scores[mism]))).all())


def worker(rank: int, port: int, data: str, out: str, cpu: bool) -> None:
    """One process of the NCCL (gloo with ``--cpu``) group: one shard each."""
    from autorag_research_tpu_torch.parallel.distributed import (
        global_corpus_mesh,
        initialize_distributed,
    )

    if cpu:
        dev = torch.device("cpu")
    else:
        torch.cuda.set_device(rank)
        dev = torch.device("cuda", rank)
    if not initialize_distributed(f"tcp://127.0.0.1:{port}", N_CARDS, rank,
                                  backend="gloo" if cpu else None):
        raise SystemExit("no process group")
    mesh = global_corpus_mesh(local_devices=[dev])
    d = np.load(data)
    res: dict = {"ranks": mesh.ranks}
    idx = DenseIndex(list(range(len(d["emb"]))), d["emb"], metric="ip", mode="verified",
                     device=dev).to_device(mesh)
    td.reset_launch_counts()
    s, r = idx.topk_rows(d["q"], K)
    res["dense"] = [r.tolist(), s.tolist(), dict(td.LAUNCHES), list(idx.last_stats)]
    res["dense_ms"] = wall_ms(lambda: idx.topk_rows(d["q"], K), cpu)
    docs = [str(x) for x in d["docs"]]
    sp = SparseIndex(list(range(len(docs))), docs, device=dev).to_device(mesh)
    ts.reset_launch_counts()
    s, r = sp.topk_rows([str(x) for x in d["queries"]], K)
    res["bm25"] = [r.tolist(), s.tolist(), dict(ts.LAUNCHES)]
    if rank == 0:
        with open(out, "w") as f:
            json.dump(res, f)
    import torch.distributed as dist

    dist.destroy_process_group()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true", help="rehearse on the CPU at small sizes")
    ap.add_argument("--worker", nargs=4, metavar=("RANK", "PORT", "DATA", "OUT"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        rank, port, data, out = args.worker
        worker(int(rank), int(port), data, out, args.cpu)
        return 0

    import chip_smoke as cs

    cpu = args.cpu
    if not cpu:
        if torch.cuda.device_count() < N_CARDS:
            print(f"FAIL: needs {N_CARDS} CUDA devices", file=sys.stderr)
            return 1
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, check=True).stdout.strip()
        print(card.replace("\n", "; "), flush=True)
        from autorag_research_tpu_torch import native
        from autorag_research_tpu_torch.ops import cuda_build

        native.build()
        print("build", json.dumps(cuda_build.build_all(("seg_stats", "dense_topk_stream", "bm25_v2",
                                                         "maxsim_v2"))), flush=True)
    dev0 = torch.device("cpu") if cpu else torch.device("cuda", 0)
    n, n_bm25, n_pages, q_cnt = (6_000, 3_000, 60, 64) if cpu else (500_000, 100_000, 1_500, 1_024)
    rng = np.random.default_rng(0)
    emb = rng.standard_normal((n, 768), dtype=np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    q = rng.standard_normal((q_cnt, 768), dtype=np.float32)
    words = [f"t{i}" for i in range(200_000)]
    docs = cs.zipf_texts(rng, words, n_bm25, 40, 120)
    queries = cs.zipf_texts(rng, words, q_cnt, 6, 16)
    mesh = (corpus_mesh(devices=[torch.device("cpu", i) for i in range(N_CARDS)]) if cpu
            else corpus_mesh())
    report: dict = {"mesh": str(mesh)}

    # ---- 1. one process, one shard a card --------------------------------
    base = DenseIndex(list(range(n)), emb, metric="ip", mode="verified", device=dev0).to_device()
    ref = base.topk_rows(q, K)
    report["dense_one_card_ms"] = wall_ms(lambda: base.topk_rows(q, K), cpu)
    del base
    sh = DenseIndex(list(range(n)), emb, metric="ip", mode="verified", device=dev0).to_device(mesh)
    td.reset_launch_counts()
    got = sh.topk_rows(q, K)
    mism, ok = ids_agree(got[1], got[0], ref[1], ref[0])
    report["dense_cards"] = {"mismatches": mism, "sub_ulp": ok, "launches": dict(td.LAUNCHES),
                             "n_fail_covered": list(sh.last_stats),
                             "ms": wall_ms(lambda: sh.topk_rows(q, K), cpu)}
    del sh
    sp = SparseIndex(list(range(n_bm25)), docs, device=dev0)
    sp.tile_skip = False  # the v2 kernel, as each shard runs it
    bref = sp.topk_rows(queries, K)
    report["bm25_one_card_ms"] = wall_ms(lambda: sp.topk_rows(queries, K), cpu, 3)
    sp.to_device(mesh)
    ts.reset_launch_counts()
    bgot = sp.topk_rows(queries, K)
    report["bm25_cards"] = {
        "equal": bool(np.array_equal(bgot[1], bref[1]) and np.array_equal(bgot[0], bref[0])),
        "launches": dict(ts.LAUNCHES), "ms": wall_ms(lambda: sp.topk_rows(queries, K), cpu, 3)}
    del sp
    mats, _ = cs.mv_corpus(n_pages, 64 if cpu else 1024, 22, dev0)
    qm = [mats[i % n_pages][:32] + 0.05 * rng.standard_normal((min(32, len(mats[i % n_pages])), 128),
                                                             dtype=np.float32) for i in range(128)]
    for mode in ("exact", "verified"):
        mv = MultiVectorIndex(list(range(n_pages)), mats, mode=mode, device=dev0)
        mref = mv.topk_rows(qm, K)
        one_ms = wall_ms(lambda: mv.topk_rows(qm, K), cpu, 3)
        mv.to_device(mesh)
        tm.reset_launch_counts()
        mgot = mv.topk_rows(qm, K)
        report[f"maxsim_{mode}_cards"] = {
            "ids_equal": bool(np.array_equal(mgot[1], mref[1])),
            "max_abs_d_score": float(np.abs(mgot[0] - mref[0]).max()),
            "launches": dict(tm.LAUNCHES), "ms": wall_ms(lambda: mv.topk_rows(qm, K), cpu, 3),
            "one_card_ms": one_ms}
        del mv
    print(json.dumps(report), flush=True)

    # ---- 2. one process a card, NCCL ---------------------------------------
    with tempfile.TemporaryDirectory() as tmp:
        data, out = os.path.join(tmp, "data.npz"), os.path.join(tmp, "rank0.json")
        np.savez(data, emb=emb, q=q, docs=np.array(docs), queries=np.array(queries))
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        cmd = [sys.executable, os.path.abspath(__file__), *(["--cpu"] if cpu else []), "--worker"]
        procs = [subprocess.Popen([*cmd, str(r), str(port), data, out], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True) for r in range(N_CARDS)]
        try:
            for p in procs:
                log, _ = p.communicate(timeout=300)
                if p.returncode:
                    print(log[-3000:], file=sys.stderr)
                    return 1
        finally:
            for p in procs:
                p.kill()
        with open(out) as f:
            res = json.load(f)
    mism, ok = ids_agree(np.array(res["dense"][0]), np.array(res["dense"][1], np.float32),
                            ref[1], ref[0])
    print(json.dumps({
        "ranks": res["ranks"], "dense_mismatches": mism, "dense_sub_ulp": ok,
        "dense_launches_rank0": res["dense"][2], "dense_n_fail_covered_rank0": res["dense"][3],
        "dense_ms_rank0": res["dense_ms"],
        "bm25_equal": res["bm25"][0] == bref[1].tolist() and np.allclose(res["bm25"][1], bref[0]),
        "bm25_launches_rank0": res["bm25"][2]}), flush=True)
    ok_all = (report["dense_cards"]["sub_ulp"] and report["bm25_cards"]["equal"] and ok
              and all(report[f"maxsim_{m}_cards"]["ids_equal"] for m in ("exact", "verified")))
    print("ok" if ok_all else "FAIL: sharded results differ from one card's", flush=True)
    return 0 if ok_all else 1


if __name__ == "__main__":
    sys.exit(main())
