#!/usr/bin/env python3
"""Chip smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Drives the port's dense, MaxSim and BM25 (flat, packed, bucketed) retrieval
paths (``autorag_research_tpu_torch``), the MaxSim pins, the int8 and approx
serving modes and the hybrid pipelines through the ``Executor`` at full width
and fails (non-zero exit) on any fault:

1. the card's name and power limit, then a parallel build of every CUDA
   kernel from ``autorag_research_tpu_torch/csrc`` (one ``nvcc`` per source),
   with one more ``nvcc -Xptxas -v`` each of the seg-stats kernel, the
   streaming kernel and the MaxSim tile body's three sources
   (``maxsim_v2.cu``, ``maxsim_v1.cu``, ``maxsim_v3.cu``) beside it
   (registers, spills and ``setmaxnreg`` of their instantiations);
2. each kernel against its plain PyTorch version on the card, at the shapes
   the main path gives it, with its time, the plain version's, one PyTorch
   library yardstick's and the least time the card could take; the
   seg-stats kernel with its work plan (``seg_stats_plan``), the clusters
   of two the card holds at once, ``torch.mm(q, c.T, out_dtype=f32)`` alone
   beside the GEMM + reductions yardstick and the SM clock and power sampled
   beside its timing; the
   streaming kernel also at k = 100 (checked) and 1,000 (timed), its tile
   plan at the main path, ``torch.matmul(q, c.T)`` alone beside matmul +
   ``topk``, the SM clock and power sampled beside its timing, a
   ``torch.profiler`` split of its device time (kernel against
   ``merge_topk``), and its bf16 instantiation at the same shapes (k = 10,
   100, against its plain version, its own bound and library call); the
   ``full`` path (scores within the 2 GiB budget) at Q = 1024 with its peak
   memory;
3. the main path with every launch count at 0 just before it: the encoder
   (hidden 512, 6 layers, 8 heads, seq 128, out 768, random weights from the
   seed) embeds 1024 query texts on the device and ``DenseIndex`` verified
   mode searches a seeded 500,000 x 768 f32 corpus with them (seg-stats
   kernel); 2048 embedded queries then go through ``DenseIndex`` exact mode,
   whose [Q, N] scores exceed the 2 GiB budget (streaming top-k kernel).
   Verified ids must equal the exact ones (sub-ulp near-ties aside) and every
   kernel must have launched; a ``torch.profiler`` split of one verified
   search (#1, the selections, the rescore's gather and ``bmm``, the rest,
   and the wall time beside the device total);
4. a SciFact-size catalog run (5,183 chunks, 300 queries, one planted gold
   chunk each) through ``VectorSearchPipeline`` verified, persisted and
   scored with recall@10 / ndcg@10, its rows held against an exact search;
5. the MaxSim path's corpora, seeded unit-norm tokens of d = 128: text scale
   (50,000 docs of 64-128 tokens, ColBERT) in an exact ``MultiVectorIndex``,
   page scale (10,000 pages of 512-1,024 tokens, ColPali) in a verified one,
   and 128 query texts of up to 32 words through the multi-vector encoder
   (hidden 512, 6 layers, 8 heads, seq 128, out 128, random weights);
6. both MaxSim kernels (``csrc/maxsim_v2.cu`` on the tile body
   ``csrc/maxsim_tile.cuh``) against their plain versions at those shapes:
   fused top-k in f32 at text scale (k = 10) and bf16 at page scale, raw
   scores in bf16 at page scale (the verified prescreen's k'+1 = 65) and f32
   at text scale (k = 100), each with its launch plan (``maxsim_plan``: rows
   computed / valid, tokens walked / valid), its time with the SM clock and
   power sampled beside it, the plain version's, a chunked-matmul
   yardstick's and its bound; #11 (the ``pallas`` pin, the tile body's
   ``bias`` policy) timed beside #9 at the text shape;
7. the MaxSim main path with every launch count at 0 just before it: embed
   the 128 texts, exact search at k = 10 (fused kernel) and k = 100 (scores
   kernel), verified page-scale search at k = 10 (scores-kernel prescreen)
   with its own ``(n_fail, covered)``. Both kernels must have launched, no
   plain version or scan may have run, and verified ids must equal exact
   mode's on the same corpus (near-ties within the f32 rounding term aside);
   a ``torch.profiler`` split of the exact text search and the verified page
   search (kernels against the rest of their device time);
8. a SciFact-size multi-vector catalog run through
   ``VectorSearchPipeline(search_mode="multi")`` verified: 3,000 rows,
   recall@10 / ndcg@10, rows held against an exact search, the scores kernel
   launched;
9. the three BM25 kernels (``csrc/bm25_v2.cu``'s launchers of the hash body
   ``csrc/bm25_hash.cuh``: v2's whole-corpus walk, the skip walk, and the
   probe as the skip walk over masks built from its candidate lists; each
   launch's tile plan logged) against their plain
   versions at the repo's BM25 benchmark shapes (500,000 docs x 128 slots of
   unique terms, 25% padded at random places, vocabulary 200,000; 32
   queries x 16 terms): v2 at k = 10, 100 and 1,000, the skip kernel in both
   modes, and on a clustered variant (where tiles prune) the skip kernel and
   the probe kernel over the exact candidate tiles; the skip walk's own
   counts of (query, document) pairs that probed nothing and (query tile,
   document) pairs never staged printed, for the probe with the density of
   its group masks and, at these sub-millisecond shapes, its kernel's own
   device time by ``torch.profiler`` beside the call's CUDA-event time; each
   bitwise equal to its plain version, with its
   time, the plain version's, a CSR ``sparse.mm`` + ``topk`` yardstick's and
   its bound;
10. the BM25 main path with every launch count at 0 just before it: a
    ``SparseIndex`` built from 500,000 texts of 40-120 Zipf(1.1) words over a
    200,000-word vocabulary (host build time printed), searched by 1,024
    queries of 6-16 words at k = 10, 100 and 1,000 with ``tile_skip`` on (the
    pruned legs: tile-WAND, falling back to the skip kernel) and off (v2
    kernel), and by 1,024 rare-term lookups (two words of document frequency
    <= 7, a selective batch: the probe kernel) at k = 10 and 1,000. The routes
    give the same hits, equal to an exact scan of the same device tensors;
    every kernel launched, no plain version or scan; then each kernel at the
    main path's shapes, v1 (#4, v2's kernel under the pin's name) and the
    skip kernel in v2 mode (#5) bitwise equal to v2 (#3) there, the hash
    body's tile plans and the skip walk's counts on the Zipf batch logged,
    and v2, the skip kernel and the probe (at k = 10 and 1,000; its plan,
    mask density, counters and a profiler split logged too) timed with their
    query tiles capped at 64, 128 (the default) and 256;
11. SciFact-size catalog runs through ``BM25Pipeline``, defaults and
    ``bucketize=2`` on the same catalog: 3,000 rows each, rows equal to an exact
    scan, equal recall@10 / ndcg@10, a pruned leg launched by the flat run;
12. BM25 slice B's kernels against their plain versions: the packed kernel
    (the hash body over the packed layout) at 500,000 docs x 16 unique terms
    (pack 8) beside the v2 kernel over the flat layout of the same arrays,
    bitwise equal to both, k = 10 and 100; the packed probe at 500,000
    clustered log-uniform short docs (256-row tiles, 32 rare-term queries x 8
    terms, k = 10) beside the flat probe (both the skip walk over
    candidate-list masks; the packed probe's plan, mask density, counters and
    profiler split logged); the v1 kernel (v2's hash body under the pin's
    name) at phase 9's uniform shapes; each with its time, the plain
    version's, the CSR yardstick's and its bound;
13. the short-doc main path with every launch count at 0 just before it: a
    packed ``SparseIndex`` of 522,931 texts of 4-19 Zipf words (BEIR Quora's
    size; L, pack and stride printed), 1,024 queries of 6-13 words at k = 10
    and 100 with and without ``tile_skip`` and at k = 1,000, 1,024 rare-term
    lookups at k = 10, the ``pallas`` (v1) and ``pallas_v2`` pins at k = 10;
    each search logs its route and launches; hits equal to the v2 kernel over
    a flat upload of the same index; the three new kernels launched, no plain
    version; then each new kernel at the main path's shapes, the packed
    kernel (pack 6, dead lanes: whole rows staged) bitwise equal to v2 over
    the flat upload, its tile plan logged, the packed probe (pack 6: whole
    packed rows staged on the skip walk) with its plan, mask density and
    counters, timed at QB = 64, 128 and 256;
14. a bucketed ``SparseIndex`` (``bucketize=2``) of 500,000 texts, 90% of
    10-16 and 10% of 100-128 Zipf words: its buckets and ``device_bytes``
    against the flat layout's, 1,024 NQ-like queries at k = 10 and 100, hits
    equal to the flat layout's, the packed kernel launched;
15. the last slice's kernels: #11 (``csrc/maxsim_v1.cu``, the ``pallas``
    pin) and #12 (``csrc/maxsim_v3.cu``, the ``pallas_v3`` pin), both on the
    tile body ``csrc/maxsim_tile.cuh`` (policies ``bias`` and ``lane``),
    against their plain versions at phase 6's shapes (f32 text scale and bf16
    page scale, k = 10), each launched on prebuilt inputs with its launch
    plan logged (rows computed / valid, tokens walked / valid, k-boxes and
    staged bytes) and #9 timed beside it, #11's bias build and #12's operand
    build timed apart;
    lists of any k (#11 and #2 at k = 1,000, #9 at k = 300, #2 at the main
    path's Q = 2,048 x 500,000 x 768, in f32 and bf16) and an odd width
    (d = 100: #1, also timed on operands stored at 104 with its plan, #2
    in both dtypes, #9);
16. the slice's path with every launch count at 0 just before it: the text
    ``MultiVectorIndex`` with the ``pallas`` and ``pallas_v3`` pins at k = 10
    (hits equal to auto's), an int8 page-scale ``MultiVectorIndex`` and the
    approx and int8 ``DenseIndex`` at 500,000 x 768 searched by 1,024 and 2,048
    embedded queries (approx ids equal to exact mode's, int8's top-10
    agreement printed, int8 at Q = 2,048 on the scan leg); both new kernels
    launched, no plain version; device bytes of the int8 indexes against f32;
    the first 64 queries' int8 dense hits bitwise equal to the same op on CPU
    tensors (4 queries within 1e-5 for int8 MaxSim); an int8 ``DenseIndex``
    of 499,993 rows (stored padded to 500,000, masked) with the full one's
    hits, timed beside the op on the unaligned rows;
17. config #3 (HotpotQA hybrid) through the port's ``Executor`` with every
    launch count at 0 just before its run: a catalog of 500,000 passages of
    20-72 Zipf(1.1) words with seeded unit-norm 768-d embeddings and 1,024
    queries of 12-23 words on two gold passages each (ingest time and both
    index builds printed), ``Executor(catalog, ExecutorConfig(...))`` with no
    context (so on the card), health checks on 2 queries, recall@10 /
    ndcg@10, over ``vector_search`` (verified), ``bm25`` (defaults),
    ``hybrid_rrf``, ``hybrid_cc`` (mm), ``hybrid_cc_tmm`` and ``gqr_hybrid``
    (its first 128 queries); every pipeline and metric succeeds with 10 rows a
    query and no health-check pipeline left; the dense leg equals an exact
    ``DenseIndex`` search (sub-ulp near-ties aside), the BM25 leg an exact
    scan; each RRF / CC pipeline's rows equal the host fusers over the legs'
    fetch_k = 20 lists read back page by page; ``fuse_batch_rrf`` /
    ``fuse_batch_cc`` on the card give those ids (near-ties within 1e-6
    aside) and scores within 1e-6 relative; #1 and a BM25 kernel launched, no
    plain version or scan. Pipelines' wall times, spans, metrics and the BM25
    route are printed.

Prints a ``{"kernels": [...]}`` line and, last, ``{"ok": true, "device":
{...}}``. Exits non-zero, printing neither, without a CUDA device or without
the package beside it. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np

N_DOCS, DIM, K, K_LONG = 500_000, 768, 10, 100
Q_VERIFIED, Q_EXACT = 1024, 2048
ENCODER = dict(hidden=512, layers=6, heads=8, max_len=128, out_dim=768, vocab_size=32768)
SCIFACT_CHUNKS, SCIFACT_QUERIES = 5183, 300
# MaxSim: ColBERT-scale text (scripts/bench_maxsim_verified.py) and
# ColPali-scale pages (scripts/bench_maxsim_page.py), d = 128, 32 query tokens
MV_ENCODER = dict(hidden=512, layers=6, heads=8, max_len=128, out_dim=128, vocab_size=32768,
                  multi_vector=True)
MV_Q, MV_TQ, MV_DIM = 128, 32, 128
TEXT_N, TEXT_TD = 50_000, 128
PAGE_N, PAGE_TD = 10_000, 1024
K_PRESCREEN = 65
# BM25: the repo's benchmark shapes (scripts/bench_bm25.py: 500k docs x 128
# slots, 25% padded, vocabulary 200k, 32 queries x 16 terms), and a BEIR-scale
# text corpus (Zipf(1.1) words) searched by 1,024 NQ-like short questions
BM25_N, BM25_L, BM25_V, BM25_B, BM25_T = 500_000, 128, 200_000, 32, 16
BM25_WINDOW = 2000  # term window of a clustered doc or query
BM25_Q, BM25_K_LONG = 1024, 1000
BM25_ZIPF = 1.1
# BM25 slice B: the packed kernel at scripts/bench_bm25_packed.py's shapes
# (500k docs x 16 unique terms, pack 8), the packed probe at
# scripts/bench_bm25_probe_packed.py's (width 16, 8 query terms, vocabulary
# 500k, cluster_doc_order, 256 packed rows a tile; 5M docs cut to 500k),
# a short-doc main path at BEIR Quora's size (522,931 docs, mean 11.44 words;
# BEIR Table 1) and a bucketed one (scripts/bench_bm25_bucketed.py's 90/10)
PACKED_W, PROBE_T, PROBE_V, PROBE_ROWS = 16, 8, 500_000, 256
# the last slice: lists of any k (a TREC-style top-1,000; past the kernels'
# 256 shared-memory entries), an odd width, and the int8 modes' sanity floors
# on this synthetic data (the JAX package documents 98% top-10 on real dense
# embeddings; its MaxSim int8 test asserts top-5 >= 0.8)
K_ANY, K_F1_MAXSIM, ODD_DIM = 1000, 300, 100
INT8_AGREE_MIN, MV_INT8_AGREE_MIN = 0.9, 0.8
# the int8 searches held against the same ops on CPU tensors for a slice of
# their queries; an int8 corpus whose size is not a multiple of 16
INT8_CPU_Q, MV_INT8_CPU_Q, INT8_ODD_N = 64, 4, N_DOCS - 7
QUORA_N, QUORA_WORDS, QUORA_QWORDS = 522_931, (4, 19), (6, 13)
BUCKET_N, BUCKET_SHORT, BUCKET_LONG = 500_000, (10, 16), (100, 128)
# config #3 through the Executor at HotpotQA's shape (BEIR, Table 1: 5,233,329
# passages of 46.30 words on average, 7,405 test queries of 17.61 words, 2.0
# relevant passages a query), cut to 500,000 passages and 1,024 queries;
# GQR's refinement is host numpy, so it runs the first 128 queries
HOTPOT_N, HOTPOT_Q, HOTPOT_GQR_Q = 500_000, 1024, 128
HOTPOT_WORDS, HOTPOT_QWORDS, HOTPOT_FETCH_K = (20, 72), (12, 23), 20
HOTPOT_NOISE = 0.12  # per-dimension noise on a query's summed gold embeddings

# published dense peaks (NVIDIA data sheets): bf16 tensor FLOP/s, f32
# non-tensor FLOP/s, HBM bytes/s
PEAKS = {
    "sxm": {"bf16": 989e12, "f32": 67e12, "hbm": 3.35e12},
    "pcie": {"bf16": 756e12, "f32": 51e12, "hbm": 2.0e12},
}


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_ms(fn, reps: int) -> float:
    """Mean device ms of ``fn`` over ``reps`` calls, after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def wall_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def timed(fn):
    """(result, device ms) of one call of ``fn``, timed with CUDA events: for
    plain versions whose one call takes seconds."""
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def bound(flops: float, bytes_: float, peak_flops: float, peak_bw: float) -> tuple[float, str]:
    t_ops, t_bytes = flops / peak_flops * 1e3, bytes_ / peak_bw * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def ids_agree(ids, scores, ref_ids, ref_scores) -> tuple[int, bool]:
    """(mismatches, all explained): an id mismatch is allowed only between
    scores within f32 reduction-order resolution, 4e-7 * (1 + |s|)."""
    mism = ids != ref_ids
    diff = np.abs(scores[mism] - ref_scores[mism])
    return int(mism.sum()), bool((diff <= 4e-7 * (1 + np.abs(ref_scores[mism]))).all())


def make_texts(rng, vocab: list[str], n: int, lo: int, hi: int) -> list[str]:
    lens = rng.integers(lo, hi, size=n)
    return [" ".join(rng.choice(vocab, size=int(m))) for m in lens]


def mv_corpus(n: int, td: int, seed: int, dev):
    """``n`` token matrices with lengths uniform in [td/2, td], unit-norm
    random tokens drawn on the card from ``seed``: (list of [len_i, d]
    views, lens)."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)
    docs = np.empty((n, td, MV_DIM), dtype=np.float32)
    for lo in range(0, n, 2048):  # in slabs: one f32 copy on the card at a time
        x = torch.randn((min(2048, n - lo), td, MV_DIM), generator=gen, device=dev)
        docs[lo : lo + 2048] = (x / torch.linalg.vector_norm(x, dim=2, keepdim=True)).cpu().numpy()
    lens = np.random.default_rng(seed).integers(td // 2, td + 1, size=n)
    return [docs[i, : lens[i]] for i in range(n)], lens


def mv_tol(q: "torch.Tensor", q_lens, d_max: float):
    """Per-query f32 rounding term of the verified proof, (d + Tq) 2^-23
    sum_t ||q_t|| max ||d_s||: kernel and plain version may split a tie
    only between scores this close."""
    import torch

    qn = torch.linalg.vector_norm(q.float(), dim=2)
    mask = torch.arange(q.shape[1], device=q.device)[None, :] < q_lens[:, None]
    return (q.shape[2] + q.shape[1]) * 2.0**-23 * (qn * mask).sum(dim=1) * d_max


def mv_agree(s, i, rs, ri, tol) -> tuple[int, bool, float]:
    """(id mismatches, all scores within ``tol`` [B] of the reference's at
    the same rank, max |d score|) of two [B, k] top-k results: an id may
    differ only where two documents lie within the rounding term."""
    import torch

    s, i, rs, ri, tol = (torch.as_tensor(x).cpu().float() for x in (s, i, rs, ri, tol))
    err = (s - rs).abs()
    return int((i != ri).sum()), bool((err <= tol[:, None]).all()), float(err.max())


def mv_library(q, q_lens, docs, dlens, k: int | None):
    """One PyTorch yardstick of the MaxSim function: chunked ``torch.matmul``
    of the same operands (f32 with TF32 off; bf16 operands with f32 output
    where ``mm`` takes ``out_dtype``, else upcast), masked ``amax`` over doc
    tokens, sum over query tokens, and ``torch.topk`` when ``k`` is given.
    No single PyTorch call computes MaxSim."""
    import torch

    b, tq, d = q.shape
    n, td, _ = docs.shape
    q2 = q.reshape(b * tq, d)
    qmask = torch.arange(tq, device=q.device)[None, :] < q_lens[:, None]
    tile = max(1, (512 << 20) // (b * tq * td * 4))
    tok = torch.arange(td, device=q.device)
    out = []
    for lo in range(0, n, tile):
        c = docs[lo : lo + tile].reshape(-1, d)
        if q.dtype == torch.bfloat16 and q.is_cuda and hasattr(torch.ops.aten.mm, "dtype"):
            s = torch.mm(q2, c.T, out_dtype=torch.float32)
        else:
            s = torch.matmul(q2.float(), c.float().T)
        s = s.view(b, tq, -1, td).masked_fill(~(tok[None, :] < dlens[lo : lo + tile, None]), -3.4e38)
        out.append((s.amax(dim=3) * qmask[:, :, None]).sum(dim=1))
    scores = torch.cat(out, dim=1)
    return torch.topk(scores, k) if k else scores


def mv_bound(q_lens, dlens, d: int, elt: int, out_bytes: int, peak_flops: float, peak_bw: float):
    """Least time for the MaxSim work this run's data needs: the valid query
    and document tokens only (the kernel never loads a doc token past its
    length), each input read once, the output written once."""
    q_tok = float(q_lens.sum())
    d_tok = float(dlens.sum())
    flops = 2.0 * q_tok * d_tok * d
    bytes_ = (q_tok + d_tok) * d * elt + dlens.numel() * 4 + out_bytes
    return bound(flops, bytes_, peak_flops, peak_bw)


def maxsim_phases(seed: int, dev, peak: dict, kernels: list, vocab: list[str]) -> None:
    """The MaxSim path: kernels vs plain at text and page scale, the main
    path (encoder -> exact and verified ``MultiVectorIndex``) with its own
    launch window, and a SciFact-size multi-vector catalog run."""
    import torch

    from autorag_research_tpu_torch.embeddings.torch_encoder import (
        TorchEncoderMultiVectorEmbedding,
    )
    from autorag_research_tpu_torch.evaluation.metrics.retrieval import (
        retrieval_ndcg,
        retrieval_recall,
    )
    from autorag_research_tpu_torch.index.dense import l2_normalize
    from autorag_research_tpu_torch.index.multi_vector import MultiVectorIndex, pad_ragged
    from autorag_research_tpu_torch.models.encoder import EncoderConfig
    from autorag_research_tpu_torch.ops import dense as td
    from autorag_research_tpu_torch.ops import maxsim as tm
    from autorag_research_tpu_torch.pipelines.retrieval.vector_search import (
        VectorSearchPipeline,
    )
    from autorag_research_tpu_torch.schema import MetricInput
    from autorag_research_tpu_torch.store.catalog import Catalog
    from autorag_research_tpu_torch.store.gt import build_retrieval_gt_from_relations

    # ---- 5. corpora, indexes, encoder ------------------------------------
    t0 = time.perf_counter()
    text_mats, text_lens = mv_corpus(TEXT_N, TEXT_TD, seed + 10, dev)
    ids_text = list(range(TEXT_N))
    index_text = MultiVectorIndex(ids_text, text_mats, device=dev).to_device()
    del text_mats
    page_mats, page_lens = mv_corpus(PAGE_N, PAGE_TD, seed + 11, dev)
    index_page = MultiVectorIndex(list(range(PAGE_N)), page_mats, mode="verified", device=dev)
    index_page.to_device()
    del page_mats
    torch.cuda.synchronize()
    log(f"multi-vector indexes on device: text {TEXT_N} x {TEXT_TD} x {MV_DIM} f32 (lengths "
        f"{TEXT_TD // 2}-{TEXT_TD}), page {PAGE_N} x {PAGE_TD} x {MV_DIM} f32 + bf16 sidecar "
        f"(lengths {PAGE_TD // 2}-{PAGE_TD}); {index_text.device_bytes() / 1e9:.2f} + "
        f"{index_page.device_bytes() / 1e9:.2f} GB ({time.perf_counter() - t0:.2f} s)")
    rng = np.random.default_rng(seed + 12)
    mv_texts = make_texts(rng, vocab, MV_Q, 8, MV_TQ + 1)
    mv_embedder = TorchEncoderMultiVectorEmbedding(
        EncoderConfig(**MV_ENCODER), seed=seed, batch_size=512, device=dev
    )
    q_mats = mv_embedder.embed_texts_multi(mv_texts)
    q_np, ql_np = pad_ragged([l2_normalize(m) for m in q_mats])
    q32 = torch.from_numpy(q_np).to(dev)
    ql = torch.from_numpy(ql_np).to(dev)
    q16 = q32.to(torch.bfloat16)
    docs_t, lens_t = index_text._device
    docs_p, lens_p = index_page._device
    side = index_page._sidecar
    docs_lo = side["docs_lo"]

    # ---- 6. kernels vs plain at main-path shapes ---------------------------
    ql_h = torch.from_numpy(ql_np)  # host lengths, as MultiVectorIndex passes them

    def plan_note(label, q, docs, dlens, k):
        plan = tm.v2_plan_on_card(ql_np, docs.shape[0], docs.shape[1], q.shape[2], k, q.dtype,
                                  dev, doc_lens=dlens.cpu().numpy())
        log(f"  plan, {label}: {plan.note()}")

    def fused_case(label, q, docs, dlens, k, d_max, pk, elt):
        s, i = tm.maxsim_topk_v2(q, ql_h, docs, dlens, k)
        rs, ri = tm.maxsim_topk_v2_plain(q, ql, docs, dlens, k)
        n_mism, ok, err = mv_agree(s, i, rs, ri, mv_tol(q, ql, d_max))
        log(f"maxsim_topk_v2 vs plain, {label}: ids mismatches {n_mism}/{i.numel()} (all within "
            f"the rounding term: {ok}), max|d score| = {err:.3e}")
        if not ok:
            fail(f"maxsim_topk_v2 disagrees with its plain version ({label})")
        plan_note(label, q, docs, dlens, k)
        with SmiSampler() as smi:
            ms = cuda_ms(lambda: tm.maxsim_topk_v2(q, ql_h, docs, dlens, k), 3)
        log(f"  beside the kernel's timing: {smi.summary()}")
        plain_ms = cuda_ms(lambda: tm.maxsim_topk_v2_plain(q, ql, docs, dlens, k), 1)
        lib_ms = cuda_ms(lambda: mv_library(q, ql, docs, dlens, k), 1)
        b_ms, b_by = mv_bound(ql, dlens, MV_DIM, elt, q.shape[0] * k * 8, peak[pk], peak["hbm"])
        log(f"  kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, chunked matmul + amax + topk "
            f"{lib_ms:.3f} ms, bound {b_ms:.3f} ms ({b_by})")
        kernels.append({
            "name": "maxsim_topk_v2", "case": label, "route": "cuda",
            "source": "autorag_research_tpu_torch/csrc/maxsim_v2.cu",
            "replaces": "autorag_research_tpu/ops/maxsim.py:311",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
        })

    def scores_case(label, q, docs, dlens, k, d_max, pk, elt):
        got = tm.maxsim_scores_v2(q, ql_h, docs, dlens)
        ref = tm.maxsim_scores_v2_plain(q, ql, docs, dlens)
        tol = mv_tol(q, ql, d_max)
        err_t = (got - ref).abs()
        err = float(err_t.max())
        s, i = tm.maxsim_topk_via_scores(q, ql_h, docs, dlens, k)
        rs, ri = tm.maxsim_topk_v2_plain(q, ql, docs, dlens, k)
        n_mism, ok, _ = mv_agree(s, i, rs, ri, tol)
        log(f"maxsim_scores_v2 vs plain, {label}: max|d score| = {err:.3e} over [{q.shape[0]}, "
            f"{docs.shape[0]}] (bound {float(tol.max()):.3e}); top-{k} ids mismatches "
            f"{n_mism}/{i.numel()} (all within the rounding term: {ok})")
        if not (bool((err_t <= tol[:, None]).all()) and ok):
            fail(f"maxsim_scores_v2 disagrees with its plain version ({label})")
        plan_note(label, q, docs, dlens, 0)
        with SmiSampler() as smi:
            ms = cuda_ms(lambda: tm.maxsim_scores_v2(q, ql_h, docs, dlens), 3)
        log(f"  beside the kernel's timing: {smi.summary()}")
        plain_ms = cuda_ms(lambda: tm.maxsim_scores_v2_plain(q, ql, docs, dlens), 1)
        lib_ms = cuda_ms(lambda: mv_library(q, ql, docs, dlens, None), 1)
        b_ms, b_by = mv_bound(ql, dlens, MV_DIM, elt, q.shape[0] * docs.shape[0] * 4,
                              peak[pk], peak["hbm"])
        log(f"  kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, chunked matmul + amax "
            f"{lib_ms:.3f} ms, bound {b_ms:.3f} ms ({b_by})")
        kernels.append({
            "name": "maxsim_scores_v2", "case": label, "route": "cuda",
            "source": "autorag_research_tpu_torch/csrc/maxsim_v2.cu",
            "replaces": "autorag_research_tpu/ops/maxsim.py:442",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
        })

    td._require_exact_f32()
    text = f"text scale B={MV_Q} x {TEXT_N} docs x {TEXT_TD} x {MV_DIM}"
    page = f"page scale B={MV_Q} x {PAGE_N} pages x {PAGE_TD} x {MV_DIM}"
    fused_case(f"f32 {text}, k={K}", q32, docs_t, lens_t, K, 1.0, "f32", 4)
    # #11 (the pallas pin: the tile body's bias policy, every token walked)
    # beside #9 on the same card, in turns
    pin_ms = [cuda_ms(lambda: fn(q32, ql_h, docs_t, lens_t, K), 3)
              for fn in (tm.maxsim_topk_v1, tm.maxsim_topk_v2, tm.maxsim_topk_v2,
                         tm.maxsim_topk_v1)]
    log(f"  #11 maxsim_topk_v1 (the tile body's bias policy, bias built per call) f32 {text}, "
        f"k={K}: {pin_ms[0]:.3f} / {pin_ms[3]:.3f} ms; #9 beside it {pin_ms[1]:.3f} / "
        f"{pin_ms[2]:.3f} ms")
    fused_case(f"bf16 {page}, k={K}", q16, docs_lo, lens_p, K, 1.0, "bf16", 2)
    scores_case(f"bf16 {page}, k'+1={K_PRESCREEN}", q16, docs_lo, lens_p, K_PRESCREEN, 1.0,
                "bf16", 2)
    scores_case(f"f32 {text}, k={K_LONG}", q32, docs_t, lens_t, K_LONG, 1.0, "f32", 4)

    # ---- 7. main path, launch counts from 0 --------------------------------
    td.reset_launch_counts()
    tm.reset_launch_counts()
    t0 = time.perf_counter()
    q_mats = mv_embedder.embed_texts_multi(mv_texts)
    se, re = index_text.topk_rows(q_mats, K)[:2]
    sl, rl = index_text.topk_rows(q_mats, K_LONG)[:2]
    sv, rv = index_page.topk_rows(q_mats, K)[:2]
    n_fail, covered = index_page.last_stats
    main_s = time.perf_counter() - t0
    launches = {**td.LAUNCHES, **tm.LAUNCHES}
    plain_calls = dict(tm.PLAIN_CALLS)
    log(f"MaxSim main path launches: {json.dumps(launches)}, plain calls "
        f"{json.dumps(plain_calls)} ({main_s:.2f} s, first calls)")
    if min(tm.LAUNCHES[n] for n in ("maxsim_topk_v2", "maxsim_scores_v2")) < 1 or any(
        plain_calls.values()
    ):
        fail("the MaxSim main path skipped a kernel or took a plain route on the card")
    for k in kernels:
        if k["name"] in tm.LAUNCHES:
            k["launches"] = tm.LAUNCHES[k["name"]]
    # exact mode on the page corpus, the same tensors, for the verified check
    es, ei = tm.maxsim_topk(q32, ql, docs_p, lens_p, K)
    tol = mv_tol(q32, ql, 1.0)
    n_mism, explained, _ = mv_agree(sv, rv, es, ei, tol)
    log(f"verified (page scale) vs exact ids: {n_mism}/{rv.size} mismatches (all within "
        f"the rounding term: {explained}); n_fail {n_fail}/{MV_Q}, covered {covered} (from the "
        f"search itself)")
    if not explained:
        fail("verified MaxSim ids diverge from exact mode beyond sub-ulp near-ties")
    for name, s, r, k in (("exact k=10", se, re, K), ("exact k=100", sl, rl, K_LONG),
                          ("verified", sv, rv, K)):
        if not (np.isfinite(s).all() and s.shape == (MV_Q, k) and (r < 2**31 - 1).all()):
            fail(f"MaxSim {name} results are not finite [B, k] hits")
    if not mv_agree(sl[:, :K], rl[:, :K], se, re, tol)[1]:
        fail("MaxSim top-100 does not extend top-10 beyond the rounding term")
    embed_ms = wall_ms(lambda: mv_embedder.embed_texts_multi(mv_texts), 3)
    ex_ms = wall_ms(lambda: index_text.topk_rows(q_mats, K), 3)
    ex100_ms = wall_ms(lambda: index_text.topk_rows(q_mats, K_LONG), 2)
    ver_ms = wall_ms(lambda: index_page.topk_rows(q_mats, K), 3)
    log(f"multi-vector embed {MV_Q} texts: {embed_ms:.3f} ms/batch")
    log(f"MaxSim exact search, text scale, k={K} (fused kernel): {ex_ms:.3f} ms/batch, "
        f"{MV_Q / ex_ms * 1e3:.1f} QPS; k={K_LONG} (scores kernel): {ex100_ms:.3f} ms/batch")
    log(f"MaxSim verified search, page scale, k={K}: {ver_ms:.3f} ms/batch, "
        f"{MV_Q / ver_ms * 1e3:.1f} QPS (n_fail {n_fail})")
    device_breakdown(f"MaxSim exact search, text scale, k={K}",
                     lambda: index_text.topk_rows(q_mats, K))
    device_breakdown(f"MaxSim verified search, page scale, k={K}",
                     lambda: index_page.topk_rows(q_mats, K))
    del index_text, index_page, docs_t, lens_t, docs_p, lens_p, side, docs_lo, es, ei
    torch.cuda.empty_cache()

    # ---- 8. SciFact-size multi-vector catalog run --------------------------
    crng = np.random.default_rng(seed + 1)
    chunk_texts = make_texts(crng, vocab, SCIFACT_CHUNKS, 40, 121)
    gold = crng.choice(SCIFACT_CHUNKS, size=SCIFACT_QUERIES, replace=False)
    q_texts = [" ".join(crng.choice(chunk_texts[g].split(), size=12)) for g in gold]
    chunk_mats = mv_embedder.embed_texts_multi(chunk_texts)
    query_mats = mv_embedder.embed_texts_multi(q_texts)
    with tempfile.TemporaryDirectory() as tmp:
        cat = Catalog(f"{tmp}/scifact_mv.db", embedding_dim=MV_DIM)
        cat.add_chunks({"id": i, "contents": t} for i, t in enumerate(chunk_texts))
        cat.set_multi_embeddings("chunk", enumerate(chunk_mats))
        cat.add_queries({"id": j, "contents": t} for j, t in enumerate(q_texts))
        cat.set_multi_embeddings("query", enumerate(query_mats))
        for j, g in enumerate(gold):
            cat.add_retrieval_gt(j, int(g))
        tm.reset_launch_counts()
        pipe = VectorSearchPipeline(
            cat, name="maxsim_verified", search_mode="multi",
            index_options={"mode": "verified"}, device=dev,
        )
        stats = pipe.run(top_k=K)
        cat_launches = dict(tm.LAUNCHES)
        rows = {j: cat.get_retrieved(j, pipe.pipeline_id) for j in range(SCIFACT_QUERIES)}
        inputs = []
        for j in range(SCIFACT_QUERIES):
            gt, _ = build_retrieval_gt_from_relations(
                [dict(r) for r in cat.get_relations_by_query(j)]
            )
            inputs.append(MetricInput(
                retrieval_gt=gt, retrieved_ids=[f"chunk_{r['doc_id']}" for r in rows[j]]
            ))
        cat.close()
    recall = float(np.mean(retrieval_recall(inputs)))
    ndcg = float(np.mean(retrieval_ndcg(inputs)))
    got_ids = np.array([[r["doc_id"] for r in rows[j]] for j in range(SCIFACT_QUERIES)])
    got_s = np.array([[r["rel_score"] for r in rows[j]] for j in range(SCIFACT_QUERIES)])
    ref = MultiVectorIndex(list(range(SCIFACT_CHUNKS)), chunk_mats, device=dev)
    ref_s, ref_i, ref_ql = ref.topk_rows(query_mats, K)
    ref_s = ref_s / np.maximum(ref_ql[:, None], 1)
    # normalized scores: the rounding term over the query's tokens, per token
    cat_tol = np.full(SCIFACT_QUERIES, (MV_DIM + MV_TQ) * 2.0**-23)
    n_mism, explained, _ = mv_agree(got_s, got_ids, ref_s, ref_i, cat_tol)
    log(f"SciFact-size multi-vector catalog run: {stats['total_results']} rows persisted for "
        f"{stats['total_queries']} queries, launches {json.dumps(cat_launches)}, "
        f"recall@10 {recall:.4f}, ndcg@10 {ndcg:.4f}, vs exact search {n_mism} id mismatches "
        f"(all within the rounding term: {explained})")
    if stats["total_results"] != SCIFACT_QUERIES * K or stats["failed_queries"]:
        fail(f"MaxSim catalog run persisted {stats['total_results']} rows, failed "
             f"{stats['failed_queries']}")
    if not explained or cat_launches["maxsim_scores_v2"] < 1:
        fail("MaxSim catalog run diverged from the exact search or skipped the scores kernel")
    if not (0.0 <= recall <= 1.0 and 0.0 <= ndcg <= 1.0 and math.isfinite(ndcg)):
        fail(f"MaxSim metrics out of range: recall {recall}, ndcg {ndcg}")


def unique_rows(n: int, width: int, lo, span: int, gen, dev):
    """[n, width] int64 ids, each row ``width`` distinct values drawn from
    ``[lo, lo + span)`` (``lo`` [n, 1]) in random order, as an index build
    gives a document's unique terms: duplicates are redrawn until none is
    left."""
    import torch

    ids = lo + torch.randint(0, span, (n, width), generator=gen, device=dev)
    while True:
        ids = ids.sort(dim=1).values
        dup = torch.zeros_like(ids, dtype=torch.bool)
        dup[:, 1:] = ids[:, 1:] == ids[:, :-1]
        if not bool(dup.any()):
            break
        ids = torch.where(dup, lo + torch.randint(0, span, (n, width), generator=gen, device=dev), ids)
    return ids.gather(1, torch.rand((n, width), generator=gen, device=dev).argsort(dim=1))


def bm25_arrays(seed: int, dev, clustered: bool):
    """Slot arrays at the benchmark shapes, drawn on the card: doc ids
    [N, L] int32 of unique terms with 25% of slots padded at random places,
    weights uniform in [0, 1) f32; B x T distinct query terms with weights in
    [0.1, 2.1). ``clustered``: doc n draws from a window of BM25_WINDOW ids
    around n V / N and each query from one random window, the layout
    ``cluster_doc_order`` produces."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)
    if clustered:
        center = torch.arange(BM25_N, device=dev) * BM25_V // BM25_N
        lo = (center - BM25_WINDOW // 2).clamp(0, BM25_V - BM25_WINDOW)[:, None]
        q_lo = torch.randint(0, BM25_V - BM25_WINDOW, (BM25_B, 1), generator=gen, device=dev)
        span = BM25_WINDOW
    else:
        lo = torch.zeros((BM25_N, 1), dtype=torch.int64, device=dev)
        q_lo = torch.zeros((BM25_B, 1), dtype=torch.int64, device=dev)
        span = BM25_V
    ids = unique_rows(BM25_N, BM25_L, lo, span, gen, dev)
    w = torch.rand((BM25_N, BM25_L), generator=gen, device=dev)
    pad = torch.rand((BM25_N, BM25_L), generator=gen, device=dev) < 0.25
    doc_ids = ids.masked_fill(pad, -1).to(torch.int32).contiguous()
    doc_w = w.masked_fill(pad, 0.0).contiguous()
    q_ids = unique_rows(BM25_B, BM25_T, q_lo, span, gen, dev).to(torch.int32).contiguous()
    q_w = (torch.rand((BM25_B, BM25_T), generator=gen, device=dev) * 2 + 0.1).contiguous()
    return q_ids, q_w, doc_ids, doc_w


def bm25_library(q_ids, q_w, doc_ids, doc_w, vocab: int = BM25_V):
    """Yardstick of the BM25 function (never called by the port): the
    doc-term CSR [N, V] f32 by the dense [V, B] query weights with one sparse
    product (cuSPARSE), then ``torch.topk``. Returns a callable of k (None:
    the [B, N] scores)."""
    import torch

    n = doc_ids.shape[0]
    ids_sorted, perm = doc_ids.sort(dim=1)
    w_sorted = doc_w.gather(1, perm)
    live = ids_sorted >= 0
    crow = torch.zeros(n + 1, dtype=torch.int64, device=doc_ids.device)
    crow[1:] = live.sum(dim=1).cumsum(0)
    with warnings.catch_warnings():  # PyTorch calls its CSR support beta
        warnings.simplefilter("ignore", UserWarning)
        csr = torch.sparse_csr_tensor(
            crow, ids_sorted[live].long(), w_sorted[live], size=(n, vocab), check_invariants=False
        )
    qmat = torch.zeros((vocab, q_ids.shape[0]), dtype=torch.float32, device=doc_ids.device)
    qb, qt = torch.nonzero(q_ids >= 0, as_tuple=True)
    qmat[q_ids[qb, qt].long(), qb] = q_w[qb, qt]

    def run(k):
        s = (csr @ qmat).T
        return torch.topk(s, k) if k else s

    return run


def zipf_texts(rng, words: list[str], n: int, lo: int, hi: int) -> list[str]:
    """``n`` texts of lo..hi words drawn from ``words`` by Zipf(BM25_ZIPF) rank."""
    cdf = np.cumsum(1.0 / np.arange(1, len(words) + 1) ** BM25_ZIPF)
    cdf /= cdf[-1]
    lens = rng.integers(lo, hi + 1, size=n)
    idx = np.minimum(np.searchsorted(cdf, rng.random(int(lens.sum())), side="right"), len(words) - 1)
    seq = list(map(words.__getitem__, idx.tolist()))
    ends = np.cumsum(lens).tolist()
    return [" ".join(seq[e - m : e]) for e, m in zip(ends, lens.tolist())]


# source file and TPU kernel line (autorag_research_tpu/ops/sparse.py) of
# each BM25 kernel wrapper (all six run the hash body, launched from
# bm25_v2.cu)
BM25_KERNELS = {
    "bm25_topk_v2": ("bm25_hash.cuh", 295),
    "bm25_topk_v2_skip": ("bm25_hash.cuh", 474),
    "bm25_topk_probe": ("bm25_hash.cuh", 722),
    "bm25_topk_packed": ("bm25_hash.cuh", 934),
    "bm25_topk_probe_packed": ("bm25_hash.cuh", 1088),
    "bm25_topk_v1": ("bm25_hash.cuh", 107),
}


def bm25_bound(peak: dict, q_ids, doc_bytes: int, out_bytes, n: int = BM25_N, tiles=None,
               block_n: int = 2048):
    """Least time for the BM25 function on this run's data: one multiply and
    one add per (live query term, document), kept apart by the function's
    rounding (no FMA: half the f32 FMA peak), for every document or, with
    ``tiles`` [q_tiles, n_tiles] bool, only the doc tiles of ``block_n``
    documents a query tile must score; the slot arrays (``doc_bytes`` per
    document) of the documents some query reads, read once."""
    import torch

    dev = q_ids.device
    live = (q_ids >= 0).sum(dim=1).double()
    if tiles is None:
        pair_terms, docs = float(live.sum()) * n, n
    else:
        sizes = torch.full((tiles.shape[1],), float(block_n), dtype=torch.float64, device=dev)
        sizes[-1] = n - block_n * (tiles.shape[1] - 1)
        live_tile = torch.zeros(tiles.shape[0], dtype=torch.float64, device=dev)
        live_tile.index_add_(0, torch.arange(len(live), device=dev) // 8, live)
        pair_terms = float((live_tile[:, None] * tiles.double() * sizes).sum())
        docs = float((tiles.any(dim=0).double() * sizes).sum())
    return bound(2.0 * pair_terms, docs * doc_bytes + q_ids.numel() * 8 + out_bytes,
                 peak["f32"] / 2, peak["hbm"])


def bm25_record(kernels: list, name, case, err, ms, plain_ms, lib_ms, b_ms, b_by) -> None:
    log(f"  kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, CSR sparse.mm + topk yardstick "
        f"{lib_ms:.3f} ms, bound {b_ms:.3f} ms ({b_by})")
    src, line = BM25_KERNELS[name]
    kernels.append({
        "name": name, "case": case, "route": "cuda",
        "source": f"autorag_research_tpu_torch/csrc/{src}",
        "replaces": f"autorag_research_tpu/ops/sparse.py:{line}",
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
    })


def bm25_check_equal(label, got, ref) -> float:
    """Fail unless a kernel's (scores, rows) equal its reference bitwise;
    returns max |d score|."""
    import torch

    (s, i), (rs, ri) = got, ref
    err = float((s - rs).abs().max())
    n_mism = int((i != ri).sum())
    same = bool(torch.equal(s, rs) and torch.equal(i, ri))
    log(f"{label}: ids mismatches {n_mism}/{i.numel()}, max|d score| = {err:.3e} (bitwise: {same})")
    if not same:
        fail(f"{label}: the kernel is not bitwise equal to its reference")
    return err


def hash_plan_note(label: str, q_ids, doc_ids, k: int, block_n: int | None = None,
                   n_docs: int | None = None, pack: int = 1, qb_max: int | None = None):
    """Log the hash body's tile plan (csrc/bm25_hash.cuh) that a launch on
    these operands takes (the skip walk's with ``block_n``, the packed
    walk's with ``n_docs`` and ``pack``): D, QB, the table, the
    shared-memory bytes, the lists' placement, the parts, and the blocks per
    SM the plan counts on (its estimate from shared memory and the kernel's
    launch bounds, not a measured residency). Returns the plan."""
    import torch

    from autorag_research_tpu_torch.ops import sparse as ts

    (b, t), n, slots = q_ids.shape, doc_ids.shape[0], doc_ids.shape[1]
    if pack > 1:  # a power-of-two pack's rows are the flat array
        n, slots, pack = n_docs, 128 // pack, 1 if pack & (pack - 1) == 0 else pack
    sms = torch.cuda.get_device_properties(doc_ids.device).multi_processor_count
    plan = ts.bm25_tile_plan(b, t, n, slots, min(k, n), sms, qb_max or ts.HASH_QB, block_n, pack)
    log(f"  hash plan, {label}: D={plan.docs}, QB={plan.qb}, table {plan.table} entries, "
        f"{plan.smem} B shared memory, lists in "
        f"{'shared memory' if plan.list_smem else 'the output'}, "
        f"{'staged' if plan.staged else 'unstaged (global scratch)'}"
        f"{f', packed rows of {pack} staged whole' if pack > 1 else ''}, {plan.q_tiles} query "
        f"tiles x {plan.parts} parts of {plan.part} docs, planned for "
        f"{plan.blocks_per_sm} blocks/SM")
    return plan


def skip_counts(label: str, args, bitmaps, k: int, positive_only: bool, ref) -> dict:
    """One skip-walk launch with its device counters (outside any launch
    window; its result held bitwise against ``ref``): the share of (query,
    document) pairs that probed nothing and of (query tile, document) pairs
    never staged, logged and returned (each skip tile weighted by its
    documents)."""
    import torch

    from autorag_research_tpu_torch.ops import sparse as ts

    stats = torch.zeros(2, dtype=torch.int64, device=args[0].device)
    got = ts._hash_topk("bm25_topk_v2_skip", *args, k, group_masks=skip_masks(args[0], bitmaps),
                        block_n=ts.SKIP_BLOCK_N, positive_only=positive_only, stats=stats)
    bm25_check_equal(f"  bm25_topk_v2_skip with its counters, {label}", got, ref)
    sms = torch.cuda.get_device_properties(args[0].device).multi_processor_count
    (b, t), (n, slots) = args[0].shape, args[2].shape
    plan = ts.bm25_hash_plan(b, t, n, slots, min(k, n), sms, block_n=ts.SKIP_BLOCK_N)
    pairs, docs = stats.tolist()
    out = {"pairs_skipped": pairs / (b * n), "docs_unstaged": docs / (plan.q_tiles * n)}
    log(f"  skip walk, {label}: (query, document) pairs that probed nothing {pairs}/{b * n} "
        f"= {out['pairs_skipped']:.4f}; (query tile of {plan.qb}, document) pairs never staged "
        f"{docs}/{plan.q_tiles * n} = {out['docs_unstaged']:.4f}")
    return out


def skip_masks(q_ids, bitmaps):
    """The skip walk's Bloom masks as ``bm25_topk_v2_skip`` builds them, a
    function of the plan's query tile."""
    from autorag_research_tpu_torch.ops import sparse as ts

    return lambda qb: ts.tile_group_masks(q_ids, bitmaps, qb)


def probe_masks(cand, count, b: int, n: int, block_n: int):
    """The probes' masks as ``bm25_topk_probe`` builds them from its lists, a
    function of the plan's query tile."""
    from autorag_research_tpu_torch.ops import sparse as ts

    return lambda qb: ts.probe_group_masks(cand, count, b, qb, -(-n // block_n))


def probe_note(label: str, name: str, args, cand, count, k: int, block_n: int, ref,
               n_docs: int | None = None, pack: int = 1) -> None:
    """One probe launch (``name``: ``bm25_topk_probe`` or
    ``bm25_topk_probe_packed``; ``block_n`` in documents) with the skip
    walk's counters, outside any launch window, its result held bitwise
    against ``ref``. Logs its plan (QB, D, parts), the density
    of its group masks (the (8-query group, skip tile) pairs a list names,
    and the (query tile, skip tile) pairs some group names: the tiles a
    block stages) and the counters' shares: (query, document) pairs that
    probed nothing, (query tile, document) pairs never staged."""
    import torch

    from autorag_research_tpu_torch.ops import sparse as ts

    q_ids, doc_ids = args[0], args[2]
    b = q_ids.shape[0]
    n = doc_ids.shape[0] if n_docs is None else n_docs
    stats = torch.zeros(2, dtype=torch.int64, device=q_ids.device)
    got = ts._hash_topk(name, *args, k, ts.HASH_QB_MAX, block_n=block_n, n_docs=n_docs, pack=pack,
                        stats=stats, group_masks=probe_masks(cand, count, b, n, block_n))
    bm25_check_equal(f"  {name} with its counters, {label}", got, ref)
    plan = hash_plan_note(label, q_ids, doc_ids, k, block_n=block_n, n_docs=n_docs, pack=pack,
                          qb_max=ts.HASH_QB_MAX)
    n_tiles = -(-n // block_n)
    masks = ts.probe_group_masks(cand, count, b, plan.qb, n_tiles)
    bits = (masks.long()[..., None] >> torch.arange(32, device=masks.device)) & 1
    pairs, docs = stats.tolist()
    log(f"  probe walk, {label}: QB={plan.qb}, D={plan.docs}, {plan.q_tiles} query tiles x "
        f"{plan.parts} parts; (8-query group, skip tile of {block_n}) pairs listed "
        f"{float(bits.sum()) / (-(-b // 8) * n_tiles):.4f}, (query tile, skip tile) pairs staged "
        f"{float((masks != 0).float().mean()):.4f}; (query, document) pairs that probed nothing "
        f"{pairs}/{b * n} = {pairs / (b * n):.4f}; (query tile, document) pairs never staged "
        f"{docs}/{plan.q_tiles * n} = {docs / (plan.q_tiles * n):.4f}")


def qb_sweep(label: str, fn) -> None:
    """Log the device ms of ``fn(qb)``, a hash-body launch with its query
    tile capped at ``qb`` (``bm25_tile_plan``), for QB = 64, 128 and 256, in
    the order 128, 64, 256, 256, 64, 128."""
    qb_ms = {}
    for qb in (128, 64, 256, 256, 64, 128):
        qb_ms.setdefault(qb, []).append(cuda_ms(lambda: fn(qb), 5))
    log(f"  {label}, by query tile: " + ", ".join(
        f"QB={qb}: {' / '.join(f'{m:.3f}' for m in ms)} ms" for qb, ms in sorted(qb_ms.items())))


def device_breakdown(label: str, fn, calls: int = 3):
    """Log the device time per kernel name of ``calls`` runs of ``fn`` under
    ``torch.profiler`` (CUPTI): ms a launch and the launches traced, largest
    total first (the trace may drop a launch, so no per-run sums); "not
    measured" where the trace holds no device time. Returns the rows (ms a
    launch, launches, kernel name), the trace's ``key_averages()`` and the
    wall ms a call under the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / calls
    events = prof.key_averages()
    rows = []
    for e in events:
        if not str(e.device_type).endswith("CUDA"):
            continue
        us = getattr(e, "self_device_time_total", None)
        us = getattr(e, "self_cuda_time_total", 0) if us is None else us
        if us > 0:
            rows.append((us / 1e3 / max(e.count, 1), e.count, e.key))
    if not rows:
        log(f"  device time by kernel, {label}: not measured (the trace holds no device time)")
        return rows, events, wall
    rows.sort(key=lambda r: r[0] * r[1], reverse=True)
    log(f"  device time by kernel, {label}: {sum(r[1] for r in rows)} launches traced in {calls} "
        f"runs; " + "; ".join(f"{ms:.3f} ms a launch x{n} {name[:70]}" for ms, n, name in rows[:8]))
    return rows, events, wall


def tile_mask(cand, count, n_tiles: int):
    """[q_tiles, n_tiles] bool: the live entries of candidate lists."""
    import torch

    dev = cand.device
    live = torch.arange(cand.shape[1], device=dev)[None] < count[:, None]
    mask = torch.zeros((cand.shape[0], n_tiles), dtype=torch.bool, device=dev)
    rows = torch.arange(cand.shape[0], device=dev)[:, None].expand_as(cand)
    mask[rows[live], cand[live].long()] = True
    return mask


def bm25_phases(seed: int, dev, peak: dict, kernels: list, vocab: list[str]) -> None:
    """The BM25 path: the three kernels vs their plain versions at the
    benchmark shapes, the main path (a BEIR-scale ``SparseIndex`` built from
    text and searched through the pruned legs and the v2 kernel) with its own
    launch window, and a SciFact-size catalog run through ``BM25Pipeline``,
    flat and bucketed."""
    import torch

    from autorag_research_tpu_torch.evaluation.metrics.retrieval import (
        retrieval_ndcg,
        retrieval_recall,
    )
    from autorag_research_tpu_torch.index.sparse import SparseIndex
    from autorag_research_tpu_torch.ops import dense as td
    from autorag_research_tpu_torch.ops import maxsim as tm
    from autorag_research_tpu_torch.ops import sparse as ts
    from autorag_research_tpu_torch.pipelines.retrieval.bm25 import BM25Pipeline
    from autorag_research_tpu_torch.schema import MetricInput
    from autorag_research_tpu_torch.store.catalog import Catalog
    from autorag_research_tpu_torch.store.gt import build_retrieval_gt_from_relations

    elt_bytes = BM25_N * BM25_L * 8  # ids + weights, each read once

    # ---- 9. kernels vs plain at the benchmark shapes -----------------------
    t0 = time.perf_counter()
    uni = bm25_arrays(seed + 20, dev, clustered=False)
    clu = bm25_arrays(seed + 21, dev, clustered=True)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    bm_uni = torch.from_numpy(ts.build_tile_bitmaps(uni[2].cpu().numpy(), ts.SKIP_BLOCK_N)).to(dev)
    clu_ids_np = clu[2].cpu().numpy()
    bm_clu = torch.from_numpy(ts.build_tile_bitmaps(clu_ids_np, ts.SKIP_BLOCK_N)).to(dev)
    t2 = time.perf_counter()
    indptr, tiles = ts.build_term_tile_lists(clu_ids_np, ts.SKIP_BLOCK_N)
    log(f"BM25 slot arrays on device: 2 x {BM25_N} x {BM25_L} (ids + weights, 25% pads), "
        f"{2 * elt_bytes / 1e9:.3f} GB, drawn in {t1 - t0:.2f} s; tile bitmaps "
        f"{tuple(bm_uni.shape)} uniform, {tuple(bm_clu.shape)} clustered, built on the host in "
        f"{t2 - t1:.2f} s; clustered term -> tile lists {time.perf_counter() - t2:.2f} s")
    lib_uni = bm25_library(*uni)
    shapes = f"B={BM25_B} x T={BM25_T} vs {BM25_N} x {BM25_L}"
    for k in (K, K_LONG, BM25_K_LONG):
        label = f"bm25_topk_v2 vs plain, uniform {shapes}, k={k}"
        err = bm25_check_equal(label, ts.bm25_topk_v2(*uni, k), ts.bm25_topk_v2_plain(*uni, k))
        hash_plan_note(f"uniform {shapes}, k={k}", uni[0], uni[2], k)
        bm25_record(kernels, "bm25_topk_v2", f"uniform {shapes}, k={k}", err,
                    cuda_ms(lambda: ts.bm25_topk_v2(*uni, k), 10),
                    cuda_ms(lambda: ts.bm25_topk_v2_plain(*uni, k), 2),
                    cuda_ms(lambda: lib_uni(k), 5), *bm25_bound(peak, uni[0], BM25_L * 8, BM25_B * k * 8))
    match_uni = ts.tile_match(uni[0], bm_uni)
    for pos, k in ((True, K), (True, K_LONG), (False, K)):
        case = f"uniform {shapes}, k={k}, positive_only={pos}"
        got = ts.bm25_topk_v2_skip(*uni, bm_uni, k, positive_only=pos)
        err = bm25_check_equal(f"bm25_topk_v2_skip vs plain, {case}", got,
                               ts.bm25_topk_v2_skip_plain(*uni, bm_uni, k, positive_only=pos))
        log(f"  (8-query group, doc tile) pairs the Bloom predicate clears: "
            f"{1 - float(match_uni.float().mean()):.4f}")
        hash_plan_note(case, uni[0], uni[2], k, block_n=ts.SKIP_BLOCK_N)
        skip_counts(case, uni, bm_uni, k, pos, got)
        bm25_record(kernels, "bm25_topk_v2_skip", case, err,
                    cuda_ms(lambda: ts.bm25_topk_v2_skip(*uni, bm_uni, k, positive_only=pos), 10),
                    cuda_ms(lambda: ts.bm25_topk_v2_skip_plain(*uni, bm_uni, k, positive_only=pos), 2),
                    cuda_ms(lambda: lib_uni(k), 5),
                    *bm25_bound(peak, uni[0], BM25_L * 8, BM25_B * k * 8, tiles=match_uni))
    # the clustered layout: the predicate prunes, the exact candidate lists more
    match_clu = ts.tile_match(clu[0], bm_clu)
    skipped = 1 - float(match_clu.float().mean())
    lib_clu = bm25_library(*clu)
    case = f"clustered {shapes}, k={K}, positive_only=True"
    got = ts.bm25_topk_v2_skip(*clu, bm_clu, K, positive_only=True)
    err = bm25_check_equal(f"bm25_topk_v2_skip vs plain, {case}", got,
                           ts.bm25_topk_v2_skip_plain(*clu, bm_clu, K, positive_only=True))
    log(f"  (8-query group, doc tile) pairs the Bloom predicate clears: {skipped:.4f}; doc tiles "
        f"some group scores: {int(match_clu.any(dim=0).sum())}/{bm_clu.shape[0]}")
    hash_plan_note(case, clu[0], clu[2], K, block_n=ts.SKIP_BLOCK_N)
    skip_counts(case, clu, bm_clu, K, True, got)
    skip_counts(f"clustered {shapes}, k={K}, positive_only=False", clu, bm_clu, K, False,
                ts.bm25_topk_v2(*clu, K))
    clu_v2_ms = cuda_ms(lambda: ts.bm25_topk_v2(*clu, K), 10)
    log(f"  v2 kernel (no skip) on the same clustered arrays: {clu_v2_ms:.3f} ms")
    bm25_record(kernels, "bm25_topk_v2_skip", case, err,
                cuda_ms(lambda: ts.bm25_topk_v2_skip(*clu, bm_clu, K, positive_only=True), 10),
                cuda_ms(lambda: ts.bm25_topk_v2_skip_plain(*clu, bm_clu, K, positive_only=True), 2),
                cuda_ms(lambda: lib_clu(K), 5),
                *bm25_bound(peak, clu[0], BM25_L * 8, BM25_B * K * 8, tiles=match_clu))
    n_tiles = bm_clu.shape[0]
    cand_np, count_np, maxc = ts.probe_candidates(clu[0].cpu().numpy(), indptr, tiles, ts.BLOCK_Q, n_tiles)
    cand, count = torch.from_numpy(cand_np).to(dev), torch.from_numpy(count_np).to(dev)
    probe_tiles = tile_mask(cand, count, n_tiles)
    for k in (K, K_LONG):
        case = f"clustered {shapes}, k={k}, exact candidate tiles"
        err = bm25_check_equal(f"bm25_topk_probe vs plain, {case}",
                               ts.bm25_topk_probe(*clu, cand, count, k),
                               ts.bm25_topk_probe_plain(*clu, cand, count, k))
        log(f"  candidate tiles per query tile: max {maxc}, mean {float(count.float().mean()):.1f} "
            f"of {n_tiles}; (query tile, doc tile) pairs scored "
            f"{float(probe_tiles.float().mean()):.4f} (Bloom predicate: {1 - skipped:.4f})")
        probe_note(case, "bm25_topk_probe", clu, cand, count, k, ts.SKIP_BLOCK_N,
                   ts.bm25_topk_probe(*clu, cand, count, k))
        ms = cuda_ms(lambda: ts.bm25_topk_probe(*clu, cand, count, k), 10)
        log(f"  bm25_topk_probe call {ms:.3f} ms by CUDA events")
        device_breakdown(f"bm25_topk_probe, {case}", lambda: ts.bm25_topk_probe(*clu, cand, count, k),
                         calls=10)
        bm25_record(kernels, "bm25_topk_probe", case, err, ms,
                    cuda_ms(lambda: ts.bm25_topk_probe_plain(*clu, cand, count, k), 2),
                    cuda_ms(lambda: lib_clu(k), 5),
                    *bm25_bound(peak, clu[0], BM25_L * 8, BM25_B * k * 8, tiles=probe_tiles))
    del uni, clu, bm_uni, bm_clu, lib_uni, lib_clu, match_uni, match_clu, cand, count, probe_tiles
    torch.cuda.empty_cache()

    # ---- 10. main path: a BEIR-scale index from text, launch counts from 0 --
    rng = np.random.default_rng(seed + 22)
    words = [f"t{i}" for i in range(BM25_V)]
    t0 = time.perf_counter()
    texts = zipf_texts(rng, words, BM25_N, 40, 120)
    queries = zipf_texts(rng, words, BM25_Q, 6, 16)
    t1 = time.perf_counter()
    index = SparseIndex(list(range(BM25_N)), texts, device=dev).to_device()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t1
    del texts
    # rare-term lookups (names, codes): two words of document frequency <= 7,
    # so that a query tile of 8 lists at most 112 of the 245 doc tiles
    rare_words = np.array(list(index.vocab))[(index.doc_freq >= 1) & (index.doc_freq <= 7)]
    lookups = [" ".join(rng.choice(rare_words, size=2, replace=False)) for _ in range(BM25_Q)]
    log(f"BM25 index from text: {BM25_N} docs of 40-120 Zipf({BM25_ZIPF}) words over {BM25_V} "
        f"(texts drawn in {t1 - t0:.2f} s); host build {build_s:.2f} s; {len(index.vocab)} terms, "
        f"{index._slot_ids.shape[1]} slots, {index.device_bytes() / 1e9:.3f} GB on device; "
        f"{len(rare_words)} words of df <= 7 for the lookups")
    td.reset_launch_counts()
    tm.reset_launch_counts()
    ts.reset_launch_counts()
    t0 = time.perf_counter()
    runs = (("NQ-like", queries, True, (K, K_LONG, BM25_K_LONG)),
            ("NQ-like", queries, False, (K, K_LONG, BM25_K_LONG)),
            ("rare-term lookups", lookups, True, (K, BM25_K_LONG)))
    hits = {}
    for label, qs, skip, ks in runs:
        index.tile_skip = skip
        for k in ks:
            before = dict(ts.LAUNCHES)
            t1 = time.perf_counter()
            hits[label, skip, k] = index.search(qs, k)
            delta = {n: c - before[n] for n, c in ts.LAUNCHES.items() if c != before[n]}
            log(f"BM25 search {label}, tile_skip={skip}, k={k}: {time.perf_counter() - t1:.2f} s "
                f"(first call), launches {json.dumps(delta)}")
    index.tile_skip = True
    main_s = time.perf_counter() - t0
    launches = dict(ts.LAUNCHES)
    plain_calls = {**ts.PLAIN_CALLS, **tm.PLAIN_CALLS}
    log(f"BM25 main path launches: {json.dumps(launches)}, plain calls {json.dumps(plain_calls)} "
        f"({main_s:.2f} s, first calls, host term -> tile lists and bitmaps included)")
    flat_kernels = ("bm25_topk_v2", "bm25_topk_v2_skip", "bm25_topk_probe")
    if min(launches[n] for n in flat_kernels) < 1 or any(plain_calls.values()):
        fail("the BM25 main path skipped a kernel or took a plain route on the card")
    for entry in kernels:
        if entry["name"] in flat_kernels:
            entry["launches"] = launches[entry["name"]]

    def as_pairs(rows):
        return [[(h.doc_id, h.score) for h in row] for row in rows]

    # an exact scan of the same device tensors, outside the counted window
    di, dw = index._device
    for label, qs, ks in (("NQ-like", queries, (K, K_LONG, BM25_K_LONG)),
                          ("rare-term lookups", lookups, (K, BM25_K_LONG))):
        q_ids, q_w = index.encode_queries(qs)
        ss, si = ts.bm25_topk_scan(torch.from_numpy(q_ids).to(dev), torch.from_numpy(q_w).to(dev),
                                   di, dw, BM25_K_LONG)
        ref = [[(index.ids[int(r)], float(s)) for s, r in zip(qs_, qr) if s > 0]
               for qs_, qr in zip(ss.cpu().numpy(), si.cpu().numpy())]
        for k in ks:
            got = as_pairs(hits[label, True, k])
            same = label != "NQ-like" or got == as_pairs(hits[label, False, k])
            exact = got == [row[:k] for row in ref]
            log(f"BM25 search {label} k={k}: {sum(len(r) for r in got)} hits; pruned == v2: {same}; "
                f"== exact scan: {exact}")
            if not (same and exact):
                fail(f"BM25 hits of {label} at k={k} differ between routes or from the exact scan")
    del hits

    # where a search's time goes: the wall time of SparseIndex.search against
    # its route below encode_queries (pruned legs with their host work, or
    # the v2 kernel and merge)
    q_ids, q_w = index.encode_queries(queries)
    r_ids, r_w = index.encode_queries(lookups)
    qi, qw = torch.from_numpy(q_ids).to(dev), torch.from_numpy(q_w).to(dev)
    enc_ms = wall_ms(lambda: index.encode_queries(queries), 3)
    log(f"BM25 encode_queries Q={BM25_Q} (host tokenizer + idf): {enc_ms:.3f} ms")
    for label, qs, qn, k, skip in (("NQ-like", queries, (q_ids, q_w), K, True),
                                   ("NQ-like", queries, (q_ids, q_w), K_LONG, True),
                                   ("NQ-like", queries, (q_ids, q_w), BM25_K_LONG, True),
                                   ("NQ-like", queries, (q_ids, q_w), K, False),
                                   ("NQ-like", queries, (q_ids, q_w), BM25_K_LONG, False),
                                   ("rare-term lookups", lookups, (r_ids, r_w), K, True)):
        index.tile_skip = skip
        ms = wall_ms(lambda: index.search(qs, k), 3)
        if skip:
            route_ms = wall_ms(lambda: index._search_pruned(*qn, di, dw, k, "auto"), 3)
            what = "pruned legs incl. host bounds"
        else:
            route_ms = cuda_ms(lambda: ts.bm25_topk_v2(qi, qw, di, dw, k), 3)
            what = "v2 kernel + merge on the device"
        log(f"BM25 search {label} Q={BM25_Q}, k={k}, tile_skip={skip}: {ms:.3f} ms/batch, "
            f"{BM25_Q / ms * 1e3:.1f} QPS; {what} {route_ms:.3f} ms")
    index.tile_skip = True

    # each kernel at the main path's shapes against its plain version
    slots = di.shape[1]
    main_shape = f"main path Q={BM25_Q} x T={qi.shape[1]} vs {BM25_N} x {slots} Zipf"
    bitmaps = index._ensure_bitmaps()
    ri, rw = torch.from_numpy(r_ids).to(dev), torch.from_numpy(r_w).to(dev)
    p_tiles = -(-BM25_N // index.probe_block_n)
    cand_np, count_np, maxc = ts.probe_candidates(r_ids, *index._ensure_term_tiles(index.probe_block_n),
                                                 ts.BLOCK_Q, p_tiles)
    cap = ts.candidate_cap(maxc, p_tiles)
    cand = torch.from_numpy(np.ascontiguousarray(cand_np[:, :cap])).to(dev)
    count = torch.from_numpy(count_np).to(dev)
    log(f"rare-term lookups: candidate tiles per query tile max {maxc}, mean "
        f"{float(count.float().mean()):.1f} of {p_tiles}")
    # the NQ-like pruned legs at k = 10, split: host candidate unions, host
    # WAND bounds, then the skip kernel (tile_match, kernel, merge)
    term_tiles = index._ensure_term_tiles(index.probe_block_n)
    trip = index._ensure_term_tiles_maxw(index.probe_block_n)
    cand_ms = wall_ms(lambda: ts.probe_candidates(q_ids, *term_tiles, ts.BLOCK_Q, p_tiles), 3)
    ub_ms = wall_ms(lambda: ts.wand_upper_bounds(q_ids, q_w, *trip, p_tiles), 3)
    skip_ms = cuda_ms(lambda: ts.bm25_topk_v2_skip(qi, qw, di, dw, bitmaps, K, positive_only=True), 3)
    log(f"BM25 pruned legs, NQ-like Q={BM25_Q}, k={K}: host candidate unions {cand_ms:.3f} ms, "
        f"host WAND bounds {ub_ms:.3f} ms, skip kernel + tile_match + merge {skip_ms:.3f} ms")
    lib_main = bm25_library(qi, qw, di, dw)
    lib_rare = bm25_library(ri, rw, di, dw)
    cases = (
        ("bm25_topk_v2_skip", f"{main_shape}, k={K}, positive_only=True", qi,
         ts.tile_match(qi, bitmaps), lib_main,
         lambda: ts.bm25_topk_v2_skip(qi, qw, di, dw, bitmaps, K, positive_only=True),
         lambda: ts.bm25_topk_v2_skip_plain(qi, qw, di, dw, bitmaps, K, positive_only=True)),
        ("bm25_topk_v2", f"{main_shape}, k={K}", qi, None, lib_main,
         lambda: ts.bm25_topk_v2(qi, qw, di, dw, K), lambda: ts.bm25_topk_v2_plain(qi, qw, di, dw, K)),
        ("bm25_topk_probe", f"main path {BM25_Q} rare-term lookups x T={ri.shape[1]} vs {BM25_N} x "
         f"{slots} Zipf, k={K}", ri, tile_mask(cand, count, p_tiles), lib_rare,
         lambda: ts.bm25_topk_probe(ri, rw, di, dw, cand, count, K),
         lambda: ts.bm25_topk_probe_plain(ri, rw, di, dw, cand, count, K)),
    )
    for name, case, q_used, tiles_needed, lib, kern, plain in cases:
        ref, plain_ms = timed(plain)
        got = kern()
        same = all(map(torch.equal, got, ref))
        err = float((got[0] - ref[0]).abs().max())
        log(f"{name} vs plain, {case}: bitwise equal {same}, max|d score| = {err:.3e}")
        if not same:
            fail(f"{name} is not bitwise equal to its plain version at the main path's shapes")
        if name == "bm25_topk_v2":
            for k in (K, BM25_K_LONG):
                hash_plan_note(f"{main_shape}, k={k}", qi, di, k)
            # #4 (v1) is #3's kernel under the pin's name: held against #3 once;
            # #5 in v2 mode is #3's function too
            bm25_check_equal(f"bm25_topk_v1 vs bm25_topk_v2, {case}",
                             ts.bm25_topk_v1(qi, qw, di, dw, K), got)
            bm25_check_equal(f"bm25_topk_v2_skip (positive_only=False) vs bm25_topk_v2, {case}",
                             ts.bm25_topk_v2_skip(qi, qw, di, dw, bitmaps, K, positive_only=False),
                             got)
            qb_sweep(f"v2 at the main path, k={K}",
                     lambda qb: ts._hash_topk("bm25_topk_v2", qi, qw, di, dw, K, qb_max=qb))
        if name == "bm25_topk_v2_skip":
            hash_plan_note(case, qi, di, K, block_n=ts.SKIP_BLOCK_N)
            skip_counts(case, (qi, qw, di, dw), bitmaps, K, True, got)
            skip_counts(f"{main_shape}, k={K}, positive_only=False", (qi, qw, di, dw), bitmaps, K,
                        False, ts.bm25_topk_v2(qi, qw, di, dw, K))
            qb_sweep(f"skip kernel at the main path, k={K}, positive_only=True",
                     lambda qb: ts._hash_topk("bm25_topk_v2_skip", qi, qw, di, dw, K, qb_max=qb,
                                              group_masks=skip_masks(qi, bitmaps),
                                              block_n=ts.SKIP_BLOCK_N, positive_only=True))
            device_breakdown(f"bm25_topk_v2_skip, {case}", kern)
            device_breakdown(f"bm25_topk_v2, {main_shape}, k={K}",
                             lambda: ts.bm25_topk_v2(qi, qw, di, dw, K))
        if name == "bm25_topk_probe":
            pbn = index.probe_block_n
            probe_note(case, name, (ri, rw, di, dw), cand, count, K, pbn, got)
            probe_note(f"main path rare-term lookups, k={BM25_K_LONG}", name, (ri, rw, di, dw), cand,
                       count, BM25_K_LONG, pbn, ts.bm25_topk_probe(ri, rw, di, dw, cand, count,
                                                                   BM25_K_LONG))
            for k in (K, BM25_K_LONG):
                qb_sweep(f"probe at the main path, k={k}",
                         lambda qb: ts._hash_topk(name, ri, rw, di, dw, k, qb_max=qb, block_n=pbn,
                                                  group_masks=probe_masks(cand, count, BM25_Q, BM25_N,
                                                                          pbn)))
            device_breakdown(f"bm25_topk_probe, {case}", kern)
        del got, ref
        bm25_record(kernels, name, case, err, cuda_ms(kern, 5), plain_ms, cuda_ms(lambda: lib(K), 3),
                    *bm25_bound(peak, q_used, slots * 8, BM25_Q * K * 8, tiles=tiles_needed))
        kernels[-1]["launches"] = launches[name]
    del index, ss, si, qi, qw, ri, rw, di, dw, bitmaps, lib_main, lib_rare, cand, count
    torch.cuda.empty_cache()

    # ---- 11. SciFact-size catalog runs through BM25Pipeline, flat and bucketed
    crng = np.random.default_rng(seed + 1)
    chunk_texts = make_texts(crng, vocab, SCIFACT_CHUNKS, 40, 121)
    gold = crng.choice(SCIFACT_CHUNKS, size=SCIFACT_QUERIES, replace=False)
    q_texts = [" ".join(crng.choice(chunk_texts[g].split(), size=12)) for g in gold]

    def catalog_run(cat, name, **opts):
        """(stats, launches, rows, recall@10, ndcg@10, buckets, plain calls)
        of one pipeline run with its own launch window."""
        ts.reset_launch_counts()
        pipe = BM25Pipeline(cat, name=name, device=dev, **opts)
        stats = pipe.run(top_k=K)
        launches = {n: c for n, c in ts.LAUNCHES.items() if c}
        plain = sum(ts.PLAIN_CALLS.values())
        rows = [cat.get_retrieved(j, pipe.pipeline_id) for j in range(SCIFACT_QUERIES)]
        inputs = []
        for j in range(SCIFACT_QUERIES):
            gt, _ = build_retrieval_gt_from_relations(
                [dict(r) for r in cat.get_relations_by_query(j)]
            )
            inputs.append(MetricInput(
                retrieval_gt=gt, retrieved_ids=[f"chunk_{r['doc_id']}" for r in rows[j]]
            ))
        buckets = pipe._index()._device_buckets
        return (stats, launches, [[(r["doc_id"], r["rel_score"]) for r in row] for row in rows],
                float(np.mean(retrieval_recall(inputs))), float(np.mean(retrieval_ndcg(inputs))),
                [(b["pack"], len(b["rows"])) for b in buckets] if buckets else None, plain)

    with tempfile.TemporaryDirectory() as tmp:
        cat = Catalog(f"{tmp}/scifact_bm25.db")
        cat.add_chunks({"id": i, "contents": t} for i, t in enumerate(chunk_texts))
        cat.add_queries({"id": j, "contents": t} for j, t in enumerate(q_texts))
        for j, g in enumerate(gold):
            cat.add_retrieval_gt(j, int(g))
        runs = {"flat": catalog_run(cat, "bm25"), "bucketize=2": catalog_run(cat, "bm25_bk", bucketize=2)}
        cat.close()
    ref_idx = SparseIndex(list(range(SCIFACT_CHUNKS)), chunk_texts, device=dev).to_device()
    q_ids, q_w = ref_idx.encode_queries(q_texts)
    ss, si = ts.bm25_topk_scan(torch.from_numpy(q_ids).to(dev), torch.from_numpy(q_w).to(dev),
                               *ref_idx._device, K)
    ref = [[(int(r), float(s)) for s, r in zip(qs, qr) if s > 0]
           for qs, qr in zip(ss.cpu().numpy(), si.cpu().numpy())]
    for label, (stats, launches, got, recall, ndcg, buckets, plain) in runs.items():
        n_mism = sum(a != b for a, b in zip(got, ref))
        log(f"SciFact-size BM25 catalog run, {label}: {stats['total_results']} rows persisted for "
            f"{stats['total_queries']} queries, buckets (pack, docs) {buckets}, launches "
            f"{json.dumps(launches)}, recall@10 {recall:.4f}, ndcg@10 {ndcg:.4f}, vs exact scan "
            f"{n_mism} queries differ")
        if stats["total_results"] != SCIFACT_QUERIES * K or stats["failed_queries"]:
            fail(f"BM25 catalog run ({label}) persisted {stats['total_results']} rows, failed "
                 f"{stats['failed_queries']}")
        if n_mism:
            fail(f"BM25 catalog run ({label}) diverged from the exact scan")
        if not (0.0 <= recall <= 1.0 and 0.0 <= ndcg <= 1.0 and math.isfinite(ndcg)):
            fail(f"BM25 metrics out of range ({label}): recall {recall}, ndcg {ndcg}")
        if plain:
            fail(f"BM25 catalog run ({label}) took a plain route on the card")
    flat_run, bk_run = runs.values()
    if flat_run[1].get("bm25_topk_v2_skip", 0) + flat_run[1].get("bm25_topk_probe", 0) < 1:
        fail("the flat BM25 catalog run took no pruned leg")
    if bk_run[0]["total_results"] != flat_run[0]["total_results"] or bk_run[3:5] != flat_run[3:5] \
            or not bk_run[5] or len(bk_run[5]) != 2:
        fail("the bucketed BM25 catalog run differs from the flat run's rows, metrics or layout")


def log_uniform_short_docs(n: int, gen, dev):
    """scripts/bench_bm25_probe_packed.py's short documents, drawn on the
    card: 4-15 slots of log-uniform term ids in [1, PROBE_V) (``V ** u``),
    weights uniform in [0.2, 2.0), a repeated id in a row made a pad (an
    index build's unique terms)."""
    import torch

    cnt = torch.randint(4, PACKED_W, (n, 1), generator=gen, device=dev)
    u = torch.rand((n, PACKED_W), generator=gen, device=dev, dtype=torch.float64)
    terms = torch.pow(float(PROBE_V), u).long().clamp(max=PROBE_V - 1)
    live = torch.arange(PACKED_W, device=dev)[None, :] < cnt
    ids = torch.where(live, terms, -1).sort(dim=1).values
    dup = torch.zeros_like(live)
    dup[:, 1:] = (ids[:, 1:] == ids[:, :-1]) & (ids[:, 1:] >= 0)
    ids = ids.masked_fill(dup, -1).to(torch.int32)
    w = torch.rand((n, PACKED_W), generator=gen, device=dev) * 1.8 + 0.2
    return ids, w.masked_fill(ids < 0, 0.0)


def bm25_packed_phases(seed: int, dev, peak: dict, kernels: list) -> None:
    """BM25 slice B: the packed kernels and the v1 kernel vs their plain
    versions at the benchmark shapes (the packed kernel beside v2 over the
    flat layout of the same arrays), the short-doc main path (a BEIR
    Quora-size packed ``SparseIndex``) in a launch window of its own, and a
    bucketed index of a 90/10 skewed corpus."""
    import torch

    from autorag_research_tpu_torch.index.sparse import SparseIndex
    from autorag_research_tpu_torch.ops import dense as td
    from autorag_research_tpu_torch.ops import maxsim as tm
    from autorag_research_tpu_torch.ops import sparse as ts

    def as_pairs(rows):
        return [[(h.doc_id, h.score) for h in row] for row in rows]

    # ---- 12. packed, packed probe and v1 kernels at the benchmark shapes ---
    gen = torch.Generator(device=dev).manual_seed(seed + 30)
    zero = torch.zeros((BM25_N, 1), dtype=torch.int64, device=dev)
    ids16 = unique_rows(BM25_N, PACKED_W, zero, BM25_V, gen, dev).to(torch.int32).contiguous()
    w16 = torch.rand((BM25_N, PACKED_W), generator=gen, device=dev).contiguous()
    q_ids = unique_rows(BM25_B, BM25_T, zero[:BM25_B], BM25_V, gen, dev).to(torch.int32).contiguous()
    q_w = (torch.rand((BM25_B, BM25_T), generator=gen, device=dev) * 2 + 0.1).contiguous()
    t0 = time.perf_counter()
    p_np, pw_np, pack = ts.pack_slots(ids16.cpu().numpy(), w16.cpu().numpy(), PACKED_W)
    pids, pw = torch.from_numpy(p_np).to(dev), torch.from_numpy(pw_np).to(dev)
    log(f"packed benchmark arrays: {BM25_N} docs x {PACKED_W} unique terms (vocabulary {BM25_V}), "
        f"pack {pack}, {tuple(pids.shape)} packed rows, {2 * pids.numel() * 4 / 1e6:.1f} MB; "
        f"pack_slots on the host {time.perf_counter() - t0:.2f} s")
    flat16 = (q_ids, q_w, ids16, w16)
    lib16 = bm25_library(*flat16)
    shapes = f"B={BM25_B} x T={BM25_T} vs {BM25_N} x {PACKED_W} packed {pack}"
    for k in (K, K_LONG):
        got = ts.bm25_topk_packed(q_ids, q_w, pids, pw, BM25_N, k, pack)
        ref, plain_ms = timed(lambda: ts.bm25_topk_packed_plain(q_ids, q_w, pids, pw, BM25_N, k, pack))
        err = bm25_check_equal(f"bm25_topk_packed vs plain, {shapes}, k={k}", got, ref)
        hash_plan_note(f"{shapes}, k={k}", q_ids, pids, k, n_docs=BM25_N, pack=pack)
        bm25_check_equal(f"bm25_topk_packed vs bm25_topk_v2 over the flat layout, k={k}", got,
                         ts.bm25_topk_v2(*flat16, k))
        ms = cuda_ms(lambda: ts.bm25_topk_packed(q_ids, q_w, pids, pw, BM25_N, k, pack), 10)
        v2_ms = cuda_ms(lambda: ts.bm25_topk_v2(*flat16, k), 10)
        ms_again = cuda_ms(lambda: ts.bm25_topk_packed(q_ids, q_w, pids, pw, BM25_N, k, pack), 10)
        log(f"  packed {ms:.3f} / {ms_again:.3f} ms against v2 over the flat [N, {PACKED_W}] layout "
            f"{v2_ms:.3f} ms (packed, v2, packed): packed / flat {ms / v2_ms:.3f}")
        bm25_record(kernels, "bm25_topk_packed", f"{shapes}, k={k}", err, ms, plain_ms,
                    cuda_ms(lambda: lib16(k), 5),
                    *bm25_bound(peak, q_ids, PACKED_W * 8, BM25_B * k * 8))
        kernels[-1]["flat_v2_ms"] = v2_ms
    del ids16, w16, pids, pw, flat16, lib16, got, ref

    # the packed probe: log-uniform short docs, clustered, rare-term queries
    t0 = time.perf_counter()
    ids_c, w_c = log_uniform_short_docs(BM25_N, gen, dev)
    ids_np, w_np = ids_c.cpu().numpy(), w_c.cpu().numpy()
    df = np.bincount(ids_np[ids_np >= 0], minlength=PROBE_V)
    order = ts.cluster_doc_order(ids_np, df)
    ids_np, w_np = ids_np[order], w_np[order]
    p_np, pw_np, pack = ts.pack_slots(ids_np, w_np, PACKED_W)
    tile = PROBE_ROWS * pack
    indptr, tiles = ts.build_term_tile_lists(ids_np, tile)
    pids, pw = torch.from_numpy(p_np).to(dev), torch.from_numpy(pw_np).to(dev)
    ids_c, w_c = torch.from_numpy(ids_np).to(dev), torch.from_numpy(w_np).to(dev)
    half = torch.full((BM25_B, 1), PROBE_V // 2, dtype=torch.int64, device=dev)
    rq = unique_rows(BM25_B, PROBE_T, half, PROBE_V // 2, gen, dev).to(torch.int32).contiguous()
    rw = (torch.rand((BM25_B, PROBE_T), generator=gen, device=dev) + 0.5).contiguous()
    n_tiles = -(-BM25_N // tile)
    cand_np, count_np, maxc = ts.probe_candidates(rq.cpu().numpy(), indptr, tiles, ts.BLOCK_Q, n_tiles)
    cap = ts.candidate_cap(maxc, n_tiles)
    cand = torch.from_numpy(np.ascontiguousarray(cand_np[:, :cap])).to(dev)
    count = torch.from_numpy(count_np).to(dev)
    log(f"packed probe arrays: {BM25_N} log-uniform docs of 4-15 unique terms (vocabulary {PROBE_V}, "
        f"the benchmark's 5M docs cut to {BM25_N}), cluster_doc_order, pack {pack}, tiles of "
        f"{PROBE_ROWS} rows = {tile} docs; {BM25_B} rare-term queries x T={PROBE_T}: candidate tiles "
        f"max {maxc}, mean {float(count.float().mean()):.1f} of {n_tiles} "
        f"(host {time.perf_counter() - t0:.2f} s)")
    case = f"clustered B={BM25_B} x T={PROBE_T} rare terms vs {BM25_N} x {PACKED_W} packed {pack}, k={K}"
    got = ts.bm25_topk_probe_packed(rq, rw, pids, pw, BM25_N, pack, cand, count, K, PROBE_ROWS)
    ref, plain_ms = timed(lambda: ts.bm25_topk_probe_packed_plain(rq, rw, pids, pw, BM25_N, pack, cand,
                                                                  count, K, PROBE_ROWS))
    err = bm25_check_equal(f"bm25_topk_probe_packed vs plain, {case}", got, ref)
    bm25_check_equal("bm25_topk_probe_packed vs bm25_topk_probe over the flat layout", got,
                     ts.bm25_topk_probe(rq, rw, ids_c, w_c, cand, count, K, tile))
    ms = cuda_ms(lambda: ts.bm25_topk_probe_packed(rq, rw, pids, pw, BM25_N, pack, cand, count, K,
                                                   PROBE_ROWS), 10)
    flat_ms = cuda_ms(lambda: ts.bm25_topk_probe(rq, rw, ids_c, w_c, cand, count, K, tile), 10)
    full_ms = cuda_ms(lambda: ts.bm25_topk_packed(rq, rw, pids, pw, BM25_N, K, pack), 10)
    log(f"  packed probe call {ms:.3f} ms by CUDA events; probe over the flat layout {flat_ms:.3f} ms; "
        f"full packed walk {full_ms:.3f} ms")
    probe_note(case, "bm25_topk_probe_packed", (rq, rw, pids, pw), cand, count, K, tile, got, BM25_N,
               pack)
    device_breakdown(f"bm25_topk_probe_packed, {case}",
                     lambda: ts.bm25_topk_probe_packed(rq, rw, pids, pw, BM25_N, pack, cand, count, K,
                                                       PROBE_ROWS), calls=10)
    bm25_record(kernels, "bm25_topk_probe_packed", case, err, ms, plain_ms,
                cuda_ms(lambda: bm25_library(rq, rw, ids_c, w_c, PROBE_V)(K), 5),
                *bm25_bound(peak, rq, PACKED_W * 8, BM25_B * K * 8,
                            tiles=tile_mask(cand, count, n_tiles), block_n=tile))
    del pids, pw, ids_c, w_c, got, ref

    # v1 at scripts/bench_bm25.py's shapes (phase 9's uniform arrays, where
    # phase 9 timed v2, the same kernel)
    uni = bm25_arrays(seed + 20, dev, clustered=False)
    lib_uni = bm25_library(*uni)
    shapes = f"B={BM25_B} x T={BM25_T} vs {BM25_N} x {BM25_L}"
    for k in (K, K_LONG):
        got = ts.bm25_topk_v1(*uni, k)
        ref, plain_ms = timed(lambda: ts.bm25_topk_v1_plain(*uni, k))
        err = bm25_check_equal(f"bm25_topk_v1 vs plain, uniform {shapes}, k={k}", got, ref)
        hash_plan_note(f"uniform {shapes}, k={k}", uni[0], uni[2], k)
        bm25_record(kernels, "bm25_topk_v1", f"uniform {shapes}, k={k}", err,
                    cuda_ms(lambda: ts.bm25_topk_v1(*uni, k), 5), plain_ms,
                    cuda_ms(lambda: lib_uni(k), 5), *bm25_bound(peak, uni[0], BM25_L * 8, BM25_B * k * 8))
    del uni, lib_uni, got, ref
    torch.cuda.empty_cache()

    # ---- 13. short-doc main path: a Quora-size packed index, launches from 0
    rng = np.random.default_rng(seed + 31)
    words = [f"t{i}" for i in range(BM25_V)]
    t0 = time.perf_counter()
    texts = zipf_texts(rng, words, QUORA_N, *QUORA_WORDS)
    queries = zipf_texts(rng, words, BM25_Q, *QUORA_QWORDS)
    t1 = time.perf_counter()
    index = SparseIndex(list(range(QUORA_N)), texts, device=dev).to_device()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t1
    del texts
    width, pack = index._slot_ids.shape[1], index._device_pack
    stride = 128 // pack
    rare_words = np.array(list(index.vocab))[(index.doc_freq >= 1) & (index.doc_freq <= 7)]
    lookups = [" ".join(rng.choice(rare_words, size=2, replace=False)) for _ in range(BM25_Q)]
    flat_bytes = QUORA_N * (-(-width // 4) * 4) * 8
    bn_rows = ts.packed_block_rows(index.probe_block_n, pack)
    log(f"BM25 short-doc index from text: {QUORA_N} docs of {QUORA_WORDS[0]}-{QUORA_WORDS[1]} "
        f"Zipf({BM25_ZIPF}) words over {BM25_V} (texts drawn in {t1 - t0:.2f} s); host build "
        f"{build_s:.2f} s; L = {width} slots, pack {pack}, stride {stride}, "
        f"{128 - pack * stride} dead lanes; {index.device_bytes() / 1e6:.1f} MB packed against "
        f"{flat_bytes / 1e6:.1f} MB flat; candidate tiles of {bn_rows} rows = {bn_rows * pack} docs")
    if pack < 2:
        fail("the short-doc index did not pack")
    td.reset_launch_counts()
    tm.reset_launch_counts()
    ts.reset_launch_counts()
    t0 = time.perf_counter()
    runs = (("NQ-like", queries, True, "auto", (K, K_LONG, BM25_K_LONG)),
            ("NQ-like", queries, False, "auto", (K, K_LONG)),
            ("rare-term lookups", lookups, True, "auto", (K,)),
            ("NQ-like", queries, True, "pallas", (K,)),
            ("NQ-like", queries, True, "pallas_v2", (K,)))
    hits = {}
    first_pruned_s = None
    for label, qs, skip, method, ks in runs:
        index.tile_skip = skip
        for k in ks:
            route = ts.bm25_route(method, QUORA_N, k, "cuda", skip, "packed", pack, index.probe_block_n)
            before = dict(ts.LAUNCHES)
            t1 = time.perf_counter()
            hits[label, skip, method, k] = index.search(qs, k, method=method)
            secs = time.perf_counter() - t1
            if first_pruned_s is None and route == "pruned_packed":
                first_pruned_s = secs
            delta = {n: c - before[n] for n, c in ts.LAUNCHES.items() if c != before[n]}
            log(f"BM25 short-doc search {label}, tile_skip={skip}, method={method}, k={k}: route "
                f"{route}, {secs:.2f} s (first call), launches {json.dumps(delta)}")
    index.tile_skip = True
    main_s = time.perf_counter() - t0
    launches = dict(ts.LAUNCHES)
    plain_calls = {**ts.PLAIN_CALLS, **tm.PLAIN_CALLS}
    log(f"BM25 short-doc main path launches: {json.dumps(launches)}, plain calls "
        f"{json.dumps(plain_calls)} ({main_s:.2f} s, first calls; first pruned search "
        f"{first_pruned_s:.2f} s with its host term -> tile lists and maxima)")
    new_kernels = ("bm25_topk_packed", "bm25_topk_probe_packed", "bm25_topk_v1")
    if min(launches[n] for n in new_kernels) < 1 or any(plain_calls.values()):
        fail("the short-doc main path skipped a kernel or took a plain route on the card")
    for entry in kernels:
        if entry["name"] in new_kernels:
            entry["launches"] = launches[entry["name"]]

    # the v2 kernel over a flat upload of the same index, outside the window
    di, dw = index._flat_device()
    for label, qs in (("NQ-like", queries), ("rare-term lookups", lookups)):
        q_ids, q_w = index.encode_queries(qs)
        ss, si = ts.bm25_topk_v2(torch.from_numpy(q_ids).to(dev), torch.from_numpy(q_w).to(dev), di, dw,
                                 BM25_K_LONG)
        ref = [[(index.ids[int(r)], float(s)) for s, r in zip(qs_, qr) if s > 0]
               for qs_, qr in zip(ss.cpu().numpy(), si.cpu().numpy())]
        for (lab, skip, method, k), got in hits.items():
            if lab != label:
                continue
            same = as_pairs(got) == [row[:k] for row in ref]
            log(f"BM25 short-doc search {label}, tile_skip={skip}, method={method}, k={k}: "
                f"{sum(len(r) for r in got)} hits; == v2 over the flat upload: {same}")
            if not same:
                fail(f"BM25 short-doc hits ({label}, {method}, k={k}) differ from the flat v2 route")
    del hits

    # where a search's time goes, and each new kernel at the main path's shapes
    q_ids, q_w = index.encode_queries(queries)
    r_ids, r_w = index.encode_queries(lookups)
    qi, qw = torch.from_numpy(q_ids).to(dev), torch.from_numpy(q_w).to(dev)
    ri, rw = torch.from_numpy(r_ids).to(dev), torch.from_numpy(r_w).to(dev)
    pids, pw = index._device
    for label, qs, k, skip in (("NQ-like", queries, K, True), ("NQ-like", queries, K_LONG, True),
                               ("NQ-like", queries, K, False), ("NQ-like", queries, BM25_K_LONG, True),
                               ("rare-term lookups", lookups, K, True)):
        index.tile_skip = skip
        ms = wall_ms(lambda: index.search(qs, k), 3)
        log(f"BM25 short-doc search {label} Q={BM25_Q}, k={k}, tile_skip={skip}: {ms:.3f} ms/batch, "
            f"{BM25_Q / ms * 1e3:.1f} QPS")
    index.tile_skip = True
    p_tiles = -(-QUORA_N // (bn_rows * pack))
    term_tiles = index._ensure_term_tiles(bn_rows * pack)
    cand_np, count_np, maxc = ts.probe_candidates(r_ids, *term_tiles, ts.BLOCK_Q, p_tiles)
    cap = ts.candidate_cap(maxc, p_tiles)
    cand = torch.from_numpy(np.ascontiguousarray(cand_np[:, :cap])).to(dev)
    count = torch.from_numpy(count_np).to(dev)
    log(f"short-doc rare-term lookups: candidate tiles per query tile max {maxc}, mean "
        f"{float(count.float().mean()):.1f} of {p_tiles}")
    v2_ms = cuda_ms(lambda: ts.bm25_topk_v2(qi, qw, di, dw, K), 5)
    lib_main = bm25_library(qi, qw, di, dw)
    lib_rare = bm25_library(ri, rw, di, dw)
    main_shape = f"main path Q={BM25_Q} x T={qi.shape[1]} vs {QUORA_N} x {width} Zipf packed {pack}"
    cases = (
        ("bm25_topk_packed", f"{main_shape}, k={K}", qi, None, stride * 8, lib_main,
         lambda: ts.bm25_topk_packed(qi, qw, pids, pw, QUORA_N, K, pack),
         lambda: ts.bm25_topk_packed_plain(qi, qw, pids, pw, QUORA_N, K, pack)),
        ("bm25_topk_probe_packed", f"main path {BM25_Q} rare-term lookups x T={ri.shape[1]} vs "
         f"{QUORA_N} x {width} packed {pack}, k={K}", ri, tile_mask(cand, count, p_tiles), stride * 8,
         lib_rare,
         lambda: ts.bm25_topk_probe_packed(ri, rw, pids, pw, QUORA_N, pack, cand, count, K, bn_rows),
         lambda: ts.bm25_topk_probe_packed_plain(ri, rw, pids, pw, QUORA_N, pack, cand, count, K, bn_rows)),
        ("bm25_topk_v1", f"main path Q={BM25_Q} x T={qi.shape[1]} vs {QUORA_N} x {di.shape[1]} flat "
         f"upload, k={K}", qi, None, di.shape[1] * 8, lib_main,
         lambda: ts.bm25_topk_v1(qi, qw, di, dw, K), lambda: ts.bm25_topk_v1_plain(qi, qw, di, dw, K)),
    )
    for name, case, q_used, tiles_needed, doc_bytes, lib, kern, plain in cases:
        ref, plain_ms = timed(plain)
        got = kern()
        err = bm25_check_equal(f"{name} vs plain, {case}", got, ref)
        if name == "bm25_topk_packed":  # #7 is #3's function over the same slots
            bm25_check_equal(f"bm25_topk_packed vs bm25_topk_v2 over the flat upload, {case}", got,
                             ts.bm25_topk_v2(qi, qw, di, dw, K))
            hash_plan_note(case, qi, pids, K, n_docs=QUORA_N, pack=pack)
        if name == "bm25_topk_probe_packed":  # pack 6: whole packed rows on the skip walk
            probe_note(case, name, (ri, rw, pids, pw), cand, count, K, bn_rows * pack, got, QUORA_N,
                       pack)
            bm25_check_equal(f"bm25_topk_probe_packed vs bm25_topk_probe over the flat upload, {case}",
                             got, ts.bm25_topk_probe(ri, rw, di, dw, cand, count, K, bn_rows * pack))
            tile = bn_rows * pack
            qb_sweep(f"packed probe at the short-doc main path, k={K}",
                     lambda qb: ts._hash_topk(name, ri, rw, pids, pw, K, qb_max=qb, block_n=tile,
                                              n_docs=QUORA_N, pack=pack,
                                              group_masks=probe_masks(cand, count, BM25_Q, QUORA_N, tile)))
            device_breakdown(f"bm25_topk_probe_packed, {case}", kern)
        del ref, got
        bm25_record(kernels, name, case, err, cuda_ms(kern, 5), plain_ms, cuda_ms(lambda: lib(K), 3),
                    *bm25_bound(peak, q_used, doc_bytes, BM25_Q * K * 8, QUORA_N, tiles_needed,
                                bn_rows * pack))
        kernels[-1]["launches"] = launches[name]
        if name == "bm25_topk_v1":
            hash_plan_note(case, qi, di, K)
    log(f"  v2 over the flat upload at the main path, k={K}: {v2_ms:.3f} ms")
    kernels[-3]["flat_v2_ms"] = v2_ms
    del index, qi, qw, ri, rw, di, dw, pids, pw, lib_main, lib_rare, cand, count
    torch.cuda.empty_cache()

    # ---- 14. bucketed path: a 90/10 skewed corpus, bucketize=2 -------------
    rng = np.random.default_rng(seed + 32)
    is_long = rng.random(BUCKET_N) < 0.1
    n_long = int(is_long.sum())
    t0 = time.perf_counter()
    short = iter(zipf_texts(rng, words, BUCKET_N - n_long, *BUCKET_SHORT))
    long_ = iter(zipf_texts(rng, words, n_long, *BUCKET_LONG))
    texts = [next(long_) if x else next(short) for x in is_long]
    queries = zipf_texts(rng, words, BM25_Q, 6, 16)
    t1 = time.perf_counter()
    index = SparseIndex(list(range(BUCKET_N)), texts, bucketize=2, device=dev).to_device()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t1
    del texts
    di, dw = index._flat_device()
    flat_bytes = (di.numel() + dw.numel()) * 4
    layout = [(b["pack"], len(b["rows"]), tuple(b["arrays"][0].shape)) for b in index._device_buckets]
    log(f"BM25 bucketed index from text: {BUCKET_N} docs, {n_long} of {BUCKET_LONG[0]}-{BUCKET_LONG[1]} "
        f"Zipf words and the rest of {BUCKET_SHORT[0]}-{BUCKET_SHORT[1]} (texts {t1 - t0:.2f} s); "
        f"host build {build_s:.2f} s; buckets (pack, docs, device shape) {layout}; device_bytes "
        f"{index.device_bytes() / 1e6:.1f} MB bucketed against {flat_bytes / 1e6:.1f} MB flat "
        f"(L = {index._slot_ids.shape[1]})")
    if len(layout) != 2 or layout[0][0] < 2:
        fail("the bucketed index has no packed short bucket")
    q_ids, q_w = index.encode_queries(queries)
    ss, si = ts.bm25_topk_v2(torch.from_numpy(q_ids).to(dev), torch.from_numpy(q_w).to(dev), di, dw,
                             K_LONG)
    ref = [[(index.ids[int(r)], float(s)) for s, r in zip(qs_, qr) if s > 0]
           for qs_, qr in zip(ss.cpu().numpy(), si.cpu().numpy())]
    for k in (K, K_LONG):
        ts.reset_launch_counts()
        t1 = time.perf_counter()
        got = index.search(queries, k)
        secs = time.perf_counter() - t1
        launches = {n: c for n, c in ts.LAUNCHES.items() if c}
        same = as_pairs(got) == [row[:k] for row in ref]
        log(f"BM25 bucketed search NQ-like k={k}: {secs:.2f} s (first call), launches "
            f"{json.dumps(launches)}, plain calls {sum(ts.PLAIN_CALLS.values())}; "
            f"{sum(len(r) for r in got)} hits == the flat layout's v2 hits: {same}")
        if not same or launches.get("bm25_topk_packed", 0) < 1 or any(ts.PLAIN_CALLS.values()):
            fail(f"BM25 bucketed search at k={k} differs from the flat layout or missed the packed kernel")
        ms = wall_ms(lambda: index.search(queries, k), 3)
        log(f"BM25 bucketed search NQ-like Q={BM25_Q}, k={k}: {ms:.3f} ms/batch, "
            f"{BM25_Q / ms * 1e3:.1f} QPS")
    del index, di, dw, ss, si
    torch.cuda.empty_cache()


def pin_serving_phases(seed: int, dev, peak: dict, kernels: list, vocab: list[str],
                       corpus: np.ndarray, query_texts: list[str]) -> None:
    """The last slice: kernels #11 and #12 beside #9 at the MaxSim shapes, the
    kernels at any k and any d (phase 15); the pins and the serving modes
    through the indexes in their own launch window (phase 16). The corpora,
    queries and encoders are those of phases 1-7, remade from the same seeds."""
    import torch

    from autorag_research_tpu_torch.embeddings.torch_encoder import (
        TorchEncoderEmbedding,
        TorchEncoderMultiVectorEmbedding,
    )
    from autorag_research_tpu_torch.index.dense import (
        DenseIndex,
        _l2_normalize_device,
        l2_normalize,
    )
    from autorag_research_tpu_torch.index.multi_vector import MultiVectorIndex, pad_ragged
    from autorag_research_tpu_torch.models.encoder import EncoderConfig
    from autorag_research_tpu_torch.ops import dense as td
    from autorag_research_tpu_torch.ops import maxsim as tm

    t0 = time.perf_counter()
    text_mats, _ = mv_corpus(TEXT_N, TEXT_TD, seed + 10, dev)
    index_text = MultiVectorIndex(list(range(TEXT_N)), text_mats, device=dev).to_device()
    del text_mats
    page_mats, _ = mv_corpus(PAGE_N, PAGE_TD, seed + 11, dev)
    index_page = MultiVectorIndex(list(range(PAGE_N)), page_mats, device=dev).to_device()
    index_page8 = MultiVectorIndex(list(range(PAGE_N)), page_mats, mode="int8", device=dev)
    index_page8.to_device()
    del page_mats
    doc_ids = list(range(N_DOCS))
    index_e = DenseIndex(doc_ids, corpus, device=dev).to_device()
    index_a = DenseIndex(doc_ids, corpus, mode="approx", device=dev).to_device()
    index_8 = DenseIndex(doc_ids, corpus, mode="int8", device=dev).to_device()
    index_8o = DenseIndex(doc_ids[:INT8_ODD_N], corpus[:INT8_ODD_N], mode="int8", device=dev)
    index_8o.to_device()
    mv_texts = make_texts(np.random.default_rng(seed + 12), vocab, MV_Q, 8, MV_TQ + 1)
    mv_embedder = TorchEncoderMultiVectorEmbedding(
        EncoderConfig(**MV_ENCODER), seed=seed, batch_size=512, device=dev
    )
    embedder = TorchEncoderEmbedding(
        EncoderConfig(**ENCODER), seed=seed, batch_size=512, device=dev
    )
    q_mats = mv_embedder.embed_texts_multi(mv_texts)
    q_np, ql_np = pad_ragged([l2_normalize(m) for m in q_mats])
    q32 = torch.from_numpy(q_np).to(dev)
    ql = torch.from_numpy(ql_np).to(dev)
    ql_h = torch.from_numpy(ql_np)  # host lengths for #9's launch plans
    q16 = q32.to(torch.bfloat16)
    docs_t, lens_t = index_text._device
    docs_p, lens_p = index_page._device
    docs_p16 = docs_p.to(torch.bfloat16)
    torch.cuda.synchronize()
    log(f"slice corpora remade: text and page MultiVectorIndex (f32), page int8, DenseIndex "
        f"exact / approx / int8 at {N_DOCS} x {DIM} ({time.perf_counter() - t0:.2f} s)")

    # ---- 15. kernels #11 and #12 beside #9; any k, any d ------------------
    names = {"maxsim_topk_v1": ("maxsim_v1.cu", 125), "maxsim_topk_v3": ("maxsim_v3.cu", 572)}

    def pin_case(name, label, q, docs, dlens, k, pk, elt):
        # each pin launched as its wrapper launches it, on inputs built once:
        # #11 on the masked queries and the [N, Td] bias, #12 on the
        # augmented operands; the builds, the wrappers' own per-call work,
        # timed apart
        kernel, plain = getattr(tm, name), getattr(tm, f"{name}_plain")
        n, td = docs.shape[0], docs.shape[1]
        if name == "maxsim_topk_v3":
            build_ms = cuda_ms(lambda: tm.maxsim_v3_operands(q, ql_h, docs, dlens), 2)
            qa, da = tm.maxsim_v3_operands(q, ql_h, docs, dlens)
            mask, width = "lane", qa.shape[2]

            def call():
                return tm._v3_topk(qa, ql_h, da, dlens, k)
        else:
            def build():
                return tm._masked_queries(q, ql_h), tm.v1_bias(dlens, n, td, dev)
            build_ms = cuda_ms(build, 2)
            qm, bias = build()
            mask, width = "bias", q.shape[2]

            def call():
                return tm._tile_topk(name, qm, ql_h, docs, bias, k)
        plan = tm.v2_plan_on_card(ql_np, n, td, width, k, q.dtype, dev,
                                  doc_lens=dlens.cpu().numpy(), mask=mask)
        log(f"  plan, {name} {label}: {plan.note()}; staged {plan.k_boxes * 128} B a token "
            f"(data {width * elt} B)")
        rs, ri = plain(q, ql, docs, dlens, k)
        tol = mv_tol(q, ql, 1.0)
        # the wrapper's whole call (its bias or operand build, host lengths)
        # and the launch on the prebuilt inputs, each against the plain version
        errs = []
        for what_run, run in (("the wrapper's whole call", lambda: kernel(q, ql_h, docs, dlens, k)),
                              ("the launch on prebuilt inputs", call)):
            s, i = run()
            n_mism, ok, err = mv_agree(s, i, rs, ri, tol)
            log(f"{name} vs plain, {label}, {what_run}: ids mismatches {n_mism}/{i.numel()} "
                f"(all within the rounding term: {ok}), max|d score| = {err:.3e}")
            if not ok:
                fail(f"{name} disagrees with its plain version ({label}, {what_run})")
            errs.append(err)
        err = max(errs)
        with SmiSampler() as smi:
            ms = cuda_ms(call, 3)
        v2_ms = cuda_ms(lambda: tm.maxsim_topk_v2(q, ql_h, docs, dlens, k), 3)
        wrapper_ms = cuda_ms(lambda: kernel(q, ql_h, docs, dlens, k), 2)
        plain_ms = cuda_ms(lambda: plain(q, ql, docs, dlens, k), 1)
        lib_ms = cuda_ms(lambda: mv_library(q, ql, docs, dlens, k), 1)
        b_ms, b_by = mv_bound(ql, dlens, MV_DIM, elt, q.shape[0] * k * 8, peak[pk], peak["hbm"])
        what = "operand" if mask == "lane" else "bias"
        log(f"  kernel {ms:.3f} ms ({b_ms / ms:.1%} of the bound; {smi.summary()}), + {what} "
            f"build {build_ms:.3f} ms, the wrapper's whole call {wrapper_ms:.3f} ms; #9 "
            f"(maxsim_topk_v2) beside it {v2_ms:.3f} ms, plain {plain_ms:.3f} ms, chunked "
            f"matmul + amax + topk {lib_ms:.3f} ms, bound {b_ms:.3f} ms ({b_by})")
        src, line = names[name]
        entry = {
            "name": name, "case": label, "route": "cuda",
            "source": f"autorag_research_tpu_torch/csrc/{src}",
            "replaces": f"autorag_research_tpu/ops/maxsim.py:{line}",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms, "v2_ms": v2_ms,
            f"{what}_build_ms": build_ms, "wrapper_ms": wrapper_ms,
            "tokens_walked_per_valid": plan.tokens_walked / plan.tokens_valid,
        }
        kernels.append(entry)

    td._require_exact_f32()
    text = f"text scale B={MV_Q} x {TEXT_N} docs x {TEXT_TD} x {MV_DIM}"
    page = f"page scale B={MV_Q} x {PAGE_N} pages x {PAGE_TD} x {MV_DIM}"
    for name in names:
        pin_case(name, f"f32 {text}, k={K}", q32, docs_t, lens_t, K, "f32", 4)
        pin_case(name, f"bf16 {page}, k={K}", q16, docs_p16, lens_p, K, "bf16", 2)

    def any_case(label, got, ref, check):
        (s, i), ms = got
        rs, ri = ref
        ok, detail = check(s, i, rs, ri)
        log(f"{label}: {detail}, kernel {ms:.3f} ms")
        if not ok:
            fail(f"{label}: the kernel disagrees with its plain version")

    def mv_check(s, i, rs, ri):
        n_mism, ok, err = mv_agree(s, i, rs, ri, mv_tol(q32, ql, 1.0))
        return ok, (f"ids mismatches {n_mism}/{i.numel()} (within the rounding term: {ok}), "
                    f"max|d score| = {err:.3e}")

    def dense_check(s, i, rs, ri):
        s, i, rs, ri = (t.cpu().numpy() for t in (s, i, rs, ri))
        n_mism, ok = ids_agree(i, s, ri, rs)
        ok = ok and bool((np.abs(s - rs) <= 1e-6 * np.abs(rs) + 4e-7).all())
        return ok, (f"ids mismatches {n_mism}/{i.size} (all sub-ulp: {ok}), "
                    f"max|d score| = {np.abs(s - rs).max():.3e}")

    # the pins with query lengths on the card (one copy to the host each call)
    any_case(f"maxsim_topk_v1 f32 {text}, k={K_ANY} (lists in the output)",
             timed(lambda: tm.maxsim_topk_v1(q32, ql, docs_t, lens_t, K_ANY)),
             tm.maxsim_topk_v1_plain(q32, ql, docs_t, lens_t, K_ANY), mv_check)
    any_case(f"maxsim_topk_v3 f32 {text}, k={K_ANY} (lists in the output)",
             timed(lambda: tm.maxsim_topk_v3(q32, ql, docs_t, lens_t, K_ANY)),
             tm.maxsim_topk_v3_plain(q32, ql, docs_t, lens_t, K_ANY), mv_check)
    any_case(f"maxsim_topk_v2 f32 {text}, k={K_F1_MAXSIM} (lists in the output)",
             timed(lambda: tm.maxsim_topk_v2(q32, ql_h, docs_t, lens_t, K_F1_MAXSIM)),
             tm.maxsim_topk_v2_plain(q32, ql, docs_t, lens_t, K_F1_MAXSIM), mv_check)
    q_ex = index_e._device.new_tensor(l2_normalize(embedder.embed_texts(query_texts)))
    c_f32 = index_e._device
    any_case(f"dense_topk_stream @ Q={Q_EXACT} x N={N_DOCS} x d={DIM} f32, k={K_ANY} "
             f"(lists in the output)",
             timed(lambda: td.dense_topk_stream(q_ex, c_f32, K_ANY)),
             td.dense_topk_plain(q_ex, c_f32, K_ANY), dense_check)
    # d = 100: the wrappers zero-pad to 104 (a copy per call)
    q100 = q_ex[:, :ODD_DIM].contiguous()
    c100 = c_f32[:, :ODD_DIM].contiguous()
    any_case(f"dense_topk_stream @ Q={Q_EXACT} x N={N_DOCS} x d={ODD_DIM} f32, k={K}",
             timed(lambda: td.dense_topk_stream(q100, c100, K)),
             td.dense_topk_plain(q100, c100, K), dense_check)
    # the bf16 instantiation at k = 1,000 and d = 100
    q16, c16 = q_ex.to(torch.bfloat16), c_f32.to(torch.bfloat16)
    any_case(f"dense_topk_stream @ Q={Q_EXACT} x N={N_DOCS} x d={DIM} bf16, k={K_ANY} "
             f"(lists in the output)",
             timed(lambda: td.dense_topk_stream(q16, c16, K_ANY)),
             td.dense_topk_plain(q16, c16, K_ANY), dense_check)
    del c16
    q16, c16 = q100.to(torch.bfloat16), c100.to(torch.bfloat16)
    any_case(f"dense_topk_stream @ Q={Q_EXACT} x N={N_DOCS} x d={ODD_DIM} bf16, k={K}",
             timed(lambda: td.dense_topk_stream(q16, c16, K)),
             td.dense_topk_plain(q16, c16, K), dense_check)
    del q16, c16
    q100b = q100[:Q_VERIFIED].to(torch.bfloat16)
    c100b = c100.to(torch.bfloat16)
    (got, seg_ms) = timed(lambda: td.seg_stats_bf16(q100b, c100b, N_DOCS))
    ref = td._seg_stats_plain((q100b, None), c100b, None, N_DOCS, 128)
    qn = torch.linalg.vector_norm(q100b.float(), dim=1, keepdim=True)
    tol = ODD_DIM * 2.0**-23 * qn * torch.linalg.vector_norm(c100b.float(), dim=1).max()
    err = max(float((got[0] - ref[0]).abs().max()), float((got[2] - ref[2]).abs().max()))
    loc_bad = int(((got[1] != ref[1]) & ((ref[0] - ref[2]) > 2 * tol)).sum())
    within = bool(((got[0] - ref[0]).abs() <= tol).all() and ((got[2] - ref[2]).abs() <= tol).all())
    log(f"seg_stats_bf16 @ Q={Q_VERIFIED} x N={N_DOCS} x d={ODD_DIM}: max|d max1,max2| = "
        f"{err:.3e} (within the reduction-order bound: {within}), loc1 mismatches not near-ties "
        f"{loc_bad}, kernel {seg_ms:.3f} ms")
    if not within or loc_bad:
        fail("seg_stats_bf16 disagrees with its plain version at d = 100")
    q104, c104 = td.pad_width(q100b, 104).contiguous(), td.pad_width(c100b, 104).contiguous()
    log(f"seg_stats_bf16 @ Q={Q_VERIFIED} x N={N_DOCS} x d={ODD_DIM}, operands stored at 104 "
        f"(no pad copy a call): {cuda_ms(lambda: td.seg_stats_bf16(q104, c104, N_DOCS), 20):.3f} "
        f"ms; plan {td._seg_plan_on_card(Q_VERIFIED, N_DOCS, 104, dev)}")
    del q104, c104
    del got, ref, q100, c100, q100b, c100b
    docs_t100 = docs_t[:, :, :ODD_DIM].contiguous()
    q32_100 = q32[:, :, :ODD_DIM].contiguous()
    s, i = tm.maxsim_topk_v2(q32_100, ql_h, docs_t100, lens_t, K)
    rs, ri = tm.maxsim_topk_v2_plain(q32_100, ql, docs_t100, lens_t, K)
    n_mism, ok, err = mv_agree(s, i, rs, ri, mv_tol(q32_100, ql, 1.0))
    v2_100_ms = cuda_ms(lambda: tm.maxsim_topk_v2(q32_100, ql_h, docs_t100, lens_t, K), 2)
    log(f"maxsim_topk_v2 f32 text scale d={ODD_DIM}, k={K}: ids mismatches {n_mism}/{i.numel()} "
        f"(within the rounding term: {ok}), max|d score| = {err:.3e}, kernel {v2_100_ms:.3f} ms")
    if not ok:
        fail("maxsim_topk_v2 disagrees with its plain version at d = 100")
    del docs_t100, q32_100, docs_p16
    torch.cuda.empty_cache()

    # ---- 16. the slice's path, launch counts from 0 ------------------------
    td.reset_launch_counts()
    tm.reset_launch_counts()
    t0 = time.perf_counter()
    q_mats = mv_embedder.embed_texts_multi(mv_texts)
    s_v1, r_v1 = index_text.topk_rows(q_mats, K, method="pallas")[:2]
    s_v3, r_v3 = index_text.topk_rows(q_mats, K, method="pallas_v3")[:2]
    s_p8, r_p8 = index_page8.topk_rows(q_mats, K)[:2]
    emb = embedder.embed_texts_device(query_texts)
    dense_out = {}
    for q_cnt in (Q_VERIFIED, Q_EXACT):
        dense_out["approx", q_cnt] = index_a.topk_rows(emb[:q_cnt], K)
        dense_out["int8", q_cnt] = index_8.topk_rows(emb[:q_cnt], K)
        dense_out["int8_odd", q_cnt] = index_8o.topk_rows(emb[:q_cnt], K)
    slice_s = time.perf_counter() - t0
    launches = {**td.LAUNCHES, **tm.LAUNCHES}
    plain_calls = dict(tm.PLAIN_CALLS)
    log(f"slice path launches: {json.dumps(launches)}, plain calls {json.dumps(plain_calls)} "
        f"({slice_s:.2f} s, first calls)")
    if tm.LAUNCHES["maxsim_topk_v1"] < 1 or tm.LAUNCHES["maxsim_topk_v3"] < 1:
        fail("the slice path did not launch the v1 and v3 kernels")
    if any(plain_calls.values()):
        fail("the slice path took a plain route on the card")
    for k in kernels:
        if k["name"] in names:
            k["launches"] = tm.LAUNCHES[k["name"]]

    s_auto, r_auto = index_text.topk_rows(q_mats, K)[:2]
    tol = mv_tol(q32, ql, 1.0)
    for pin, s, r in (("pallas", s_v1, r_v1), ("pallas_v3", s_v3, r_v3)):
        n_mism, ok, err = mv_agree(s, r, s_auto, r_auto, tol)
        same = bool(np.array_equal(r, r_auto) and np.array_equal(s, s_auto))
        log(f"MultiVectorIndex text scale, the {pin} pin vs auto (fused v2), k={K}: ids "
            f"mismatches {n_mism}/{r.size} (within the rounding term: {ok}; bitwise: {same}), "
            f"max|d score| = {err:.3e}")
        if not ok or not np.isfinite(s).all():
            fail(f"the {pin} pin's hits differ from auto's")
    pin_ms = {m: wall_ms(lambda m=m: index_text.topk_rows(q_mats, K, method=m), 2)
              for m in ("auto", "pallas", "pallas_v3")}
    log("MultiVectorIndex text scale search, k=10, ms/batch: "
        + ", ".join(f"{m} {v:.3f}" for m, v in pin_ms.items()))

    def agree(a, b):
        return float(np.mean([len(set(x) & set(y)) / len(x) for x, y in zip(a, b)]))

    def int8_cpu_slice(index, q_cnt, label):
        """The card's first INT8_CPU_Q results against dense_topk_int8 on CPU
        tensors, the same normalized queries and stored corpus: the s32
        products are exact and every f32 step after them an IEEE operation in
        one order, so ids and scores are bitwise equal."""
        got_s, got_i = dense_out[label, q_cnt]
        n = index.n_docs
        qn = _l2_normalize_device(emb[:q_cnt].float())[:INT8_CPU_Q].cpu()
        qn = td.pad_width(qn, index._device.shape[1])
        ref_s, ref_i = td.dense_topk_int8(
            qn, index._device[:n].cpu(), index._device_scale[:n].cpu(), K
        )
        same = bool(np.array_equal(got_i[:INT8_CPU_Q], ref_i.numpy())
                    and np.array_equal(got_s[:INT8_CPU_Q], ref_s.numpy()))
        log(f"DenseIndex int8 {n} rows (stored {index._device.shape[0]}), Q={q_cnt}: the "
            f"first {INT8_CPU_Q} queries' hits bitwise equal to dense_topk_int8 on CPU "
            f"tensors: {same}")
        if not same:
            fail(f"the card's int8 dense hits differ from the CPU's ({n} rows, Q={q_cnt})")

    for q_cnt in (Q_VERIFIED, Q_EXACT):
        es, ei = index_e.topk_rows(emb[:q_cnt], K)
        a_s, a_i = dense_out["approx", q_cnt]
        n_mism, explained = ids_agree(a_i, a_s, ei, es)
        i8_s, i8_i = dense_out["int8", q_cnt]
        i8_agree = agree(i8_i, ei)
        a_ms = wall_ms(lambda: index_a.topk_rows(emb[:q_cnt], K), 2)
        i8_ms = wall_ms(lambda: index_8.topk_rows(emb[:q_cnt], K), 2)
        e_ms = wall_ms(lambda: index_e.topk_rows(emb[:q_cnt], K), 2)
        leg = "flat" if q_cnt * N_DOCS * 4 <= td.FULL_MATERIALIZE_BUDGET else "scan"
        log(f"DenseIndex Q={q_cnt} x {N_DOCS} x {DIM}, k={K}: approx vs exact ids {n_mism}/"
            f"{a_i.size} mismatches (all sub-ulp: {explained}), {a_ms:.3f} ms/batch; int8 "
            f"({leg} leg) top-{K} agreement with exact {i8_agree:.4f}, {i8_ms:.3f} ms/batch; "
            f"exact {e_ms:.3f} ms/batch")
        if not explained:
            fail(f"approx ids diverge from exact mode beyond sub-ulp near-ties at Q={q_cnt}")
        if i8_agree < INT8_AGREE_MIN or not np.isfinite(i8_s).all():
            fail(f"int8 top-{K} agreement {i8_agree} below {INT8_AGREE_MIN} at Q={q_cnt}")
        int8_cpu_slice(index_8, q_cnt, "int8")
        # INT8_ODD_N rows, stored with zero rows up to a multiple of 16 and
        # masked: the hits of the full corpus wherever none of its last 7 rows
        # made the top-k, and no pad row listed
        o_s, o_i = dense_out["int8_odd", q_cnt]
        keep = (i8_i < INT8_ODD_N).all(axis=1)
        same = bool(np.array_equal(o_i[keep], i8_i[keep]) and np.array_equal(o_s[keep], i8_s[keep]))
        o_ms = wall_ms(lambda: index_8o.topk_rows(emb[:q_cnt], K), 2)
        log(f"DenseIndex int8 {INT8_ODD_N} rows (not a multiple of 16), Q={q_cnt}: hits equal "
            f"the {N_DOCS}-row index's on {int(keep.sum())} queries: {same}, no pad row: "
            f"{bool((o_i < INT8_ODD_N).all())}; {o_ms:.3f} ms/batch against {i8_ms:.3f}")
        if not same or not (o_i < INT8_ODD_N).all():
            fail(f"the int8 index of {INT8_ODD_N} rows disagrees with the full one at Q={q_cnt}")
        int8_cpu_slice(index_8o, q_cnt, "int8_odd")
    # the cost the stored pad rows avoid: the same search through the op on
    # the unaligned rows, which int8_matmul pads (copies) on every product
    qn = td.pad_width(_l2_normalize_device(emb[:Q_VERIFIED].float()), index_8o._device.shape[1])
    c_odd = index_8o._device[:INT8_ODD_N]
    s_odd = index_8o._device_scale[:INT8_ODD_N]
    unal_ms = cuda_ms(lambda: td.dense_topk_int8(qn, c_odd, s_odd, K), 2)
    al_ms = cuda_ms(lambda: td.dense_topk_int8(qn, index_8o._device, index_8o._device_scale, K,
                                               n_valid=INT8_ODD_N), 2)
    log(f"dense_topk_int8 @ Q={Q_VERIFIED} x {INT8_ODD_N} x {DIM}: stored rows (a multiple of "
        f"16, masked) {al_ms:.3f} ms, the unaligned rows (padded per product) {unal_ms:.3f} ms")
    del qn, c_odd, s_odd
    log(f"DenseIndex device bytes: int8 {index_8.device_bytes()} (1 byte per dim + a f32 scale "
        f"per row), exact f32 {index_e.device_bytes()}")
    if not index_8.device_bytes() * 3.9 < index_e.device_bytes():
        fail("the int8 dense index does not hold about 4x fewer device bytes")

    pe_s, pe_i = tm.maxsim_topk(q32, ql, docs_p, lens_p, K)
    p8_agree = agree(r_p8, pe_i.cpu().numpy())
    p8_ms = wall_ms(lambda: index_page8.topk_rows(q_mats, K), 2)
    log(f"MultiVectorIndex int8 page scale, k={K}: top-{K} agreement with exact f32 "
        f"{p8_agree:.4f}, {p8_ms:.3f} ms/batch; device bytes int8 {index_page8.device_bytes()} "
        f"against f32 {index_page.device_bytes()}")
    if p8_agree < MV_INT8_AGREE_MIN or not np.isfinite(s_p8).all():
        fail(f"MaxSim int8 top-{K} agreement {p8_agree} below {MV_INT8_AGREE_MIN}")
    # the card's first MV_INT8_CPU_Q results against maxsim_topk_int8 on CPU
    # tensors: s32 products exact, the token sums in another order (1e-5)
    q8_np, ql8_np = index_page8._queries(q_mats)
    docs8, lens8 = index_page8._device
    c_s, c_i = tm.maxsim_topk_int8(
        torch.from_numpy(q8_np[:MV_INT8_CPU_Q]), torch.from_numpy(ql8_np[:MV_INT8_CPU_Q]),
        docs8.cpu(), index_page8._scales_device.cpu(), lens8.cpu(), K,
    )
    c_s, c_i = c_s.numpy(), c_i.numpy()
    g_s, g_i = s_p8[:MV_INT8_CPU_Q], r_p8[:MV_INT8_CPU_Q]
    close = bool(np.allclose(g_s, c_s, rtol=1e-5, atol=1e-5))
    mism = g_i != c_i
    ok = close and bool((np.abs(g_s - c_s)[mism] <= 1e-5).all())
    log(f"MultiVectorIndex int8 page scale: the first {MV_INT8_CPU_Q} queries against "
        f"maxsim_topk_int8 on CPU tensors: ids mismatches {int(mism.sum())}/{g_i.size} (all "
        f"within 1e-5: {ok}), max|d score| = {np.abs(g_s - c_s).max():.3e}")
    if not ok:
        fail("the card's int8 MaxSim hits differ from the CPU's")
    del docs8, lens8
    if not index_page8.device_bytes() * 3.5 < index_page.device_bytes():
        fail("the int8 MaxSim index does not hold about 4x fewer device bytes")
    del index_text, index_page, index_page8, index_e, index_a, index_8, index_8o, docs_t, docs_p
    del emb
    torch.cuda.empty_cache()


PTXAS_SOURCES = ("seg_stats", "dense_topk_stream", "maxsim_v2", "maxsim_v1", "maxsim_v3")


def hotpot_corpus(seed: int, n: int, q_cnt: int):
    """HotpotQA's shape: ``n`` passages of 20-72 Zipf words over BM25_V with
    seeded unit-norm 768-d embeddings; ``q_cnt`` queries, each on two distinct
    gold passages, of 12-23 words drawn from both golds with 1-3 Zipf noise
    words, embedded as the normalized sum of the gold embeddings plus noise."""
    rng = np.random.default_rng(seed)
    words = [f"h{i}" for i in range(BM25_V)]
    texts = zipf_texts(rng, words, n, *HOTPOT_WORDS)
    emb = rng.standard_normal((n, DIM), dtype=np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    noise_words = zipf_texts(rng, words, q_cnt, 1, 3)
    gold = np.stack([rng.choice(n, size=2, replace=False) for _ in range(q_cnt)])
    q_texts = []
    for j, (g1, g2) in enumerate(gold):
        noise = noise_words[j].split()
        m = int(rng.integers(HOTPOT_QWORDS[0], HOTPOT_QWORDS[1] + 1)) - len(noise)
        part = list(rng.choice(texts[g1].split(), size=m // 2)) + \
            list(rng.choice(texts[g2].split(), size=m - m // 2)) + noise
        rng.shuffle(part)
        q_texts.append(" ".join(part))
    q_emb = emb[gold[:, 0]] + emb[gold[:, 1]]
    q_emb += HOTPOT_NOISE * rng.standard_normal(q_emb.shape, dtype=np.float32)
    q_emb /= np.linalg.norm(q_emb, axis=1, keepdims=True)
    return texts, emb, q_texts, q_emb, gold


def fused_agree(dev_out, host_full: list, top_k: int) -> tuple[int, bool, float]:
    """A device fuser's [Q, top_k] (scores, ids) against the host fuser's
    Python-double lists over the same legs (``host_full``: every fused
    document): (id mismatches, all of them near-ties within 1e-6 relative,
    max relative score error). Scores must lie within 1e-6 relative."""
    scores, ids = (t.cpu().numpy() for t in dev_out)
    mism, explained, worst = 0, True, 0.0
    for r, full in enumerate(host_full):
        score_of = {h["doc_id"]: h["score"] for h in full}
        for j, h in enumerate(full[:top_k]):
            ref = h["score"]
            err = abs(float(scores[r, j]) - ref) / abs(ref) if ref else abs(float(scores[r, j]))
            worst = max(worst, err)
            if int(ids[r, j]) != h["doc_id"]:
                mism += 1
                other = score_of.get(int(ids[r, j]))
                explained &= other is not None and abs(other - ref) <= 1e-6 * abs(ref)
    return mism, explained, worst


def hybrid_executor_phase(seed: int, dev, n: int = HOTPOT_N, q_cnt: int = HOTPOT_Q,
                          gqr_q: int = HOTPOT_GQR_Q) -> None:
    """Phase 17: BASELINE config #3 (HotpotQA, hybrid RRF + CC of a dense and a
    BM25 pipeline, plus GQR) through the port's ``Executor`` on the card."""
    import torch

    from autorag_research_tpu_torch.config import BaseMetricConfig, ExecutorConfig
    from autorag_research_tpu_torch.executor import Executor
    from autorag_research_tpu_torch.index.dense import DenseIndex
    from autorag_research_tpu_torch.ops import dense as td
    from autorag_research_tpu_torch.ops import maxsim as tm
    from autorag_research_tpu_torch.ops import sparse as ts
    from autorag_research_tpu_torch.ops.fusion import (
        cc_fuse,
        fuse_batch_cc,
        fuse_batch_rrf,
        rrf_fuse,
    )
    from autorag_research_tpu_torch.ops.topk import INT_MAX, NEG_INF
    from autorag_research_tpu_torch.pipelines.retrieval import (
        BM25Config,
        GQRHybridConfig,
        HybridCCConfig,
        HybridRRFConfig,
        VectorSearchConfig,
    )
    from autorag_research_tpu_torch.store.catalog import Catalog
    from autorag_research_tpu_torch.store.gt import and_all

    t0 = time.perf_counter()
    texts, emb, q_texts, q_emb, gold = hotpot_corpus(seed + 40, n, q_cnt)
    gen_s = time.perf_counter() - t0
    legs = dict(retrieval_pipeline_1_name="vector_search", retrieval_pipeline_2_name="bm25")
    cfg = ExecutorConfig(
        pipelines=[
            VectorSearchConfig(name="vector_search", top_k=K, index_options={"mode": "verified"}),
            BM25Config(name="bm25", top_k=K),
            HybridRRFConfig(name="hybrid_rrf", top_k=K, rrf_k=60, fetch_k_multiplier=2, **legs),
            HybridCCConfig(name="hybrid_cc", top_k=K, normalize_method="mm", **legs),
            HybridCCConfig(name="hybrid_cc_tmm", top_k=K, normalize_method="tmm", **legs),
            GQRHybridConfig(name="gqr_hybrid", top_k=K, query_limit=gqr_q, **legs),
        ],
        metrics=[BaseMetricConfig(name="recall"), BaseMetricConfig(name="ndcg")],
        health_check=True,
        health_check_queries=2,
    )
    names = [p.name for p in cfg.pipelines]
    with tempfile.TemporaryDirectory() as tmp:
        t1 = time.perf_counter()
        cat = Catalog(f"{tmp}/hotpotqa.db", embedding_dim=DIM)
        cat.add_chunks({"id": i, "contents": t, "embedding": e} for i, (t, e) in enumerate(zip(texts, emb)))
        cat.add_queries({"id": j, "contents": t, "embedding": e}
                        for j, (t, e) in enumerate(zip(q_texts, q_emb)))
        for j, (g1, g2) in enumerate(gold):
            cat.add_retrieval_gt(j, and_all([int(g1), int(g2)]))
        ingest_s = time.perf_counter() - t1
        log(f"hybrid (config #3, HotpotQA's shape): {n} passages of {HOTPOT_WORDS[0]}-"
            f"{HOTPOT_WORDS[1]} Zipf({BM25_ZIPF}) words over {BM25_V} (mean "
            f"{sum(len(t.split()) for t in texts) / n:.2f}) x {DIM} f32, {q_cnt} queries of "
            f"{HOTPOT_QWORDS[0]}-{HOTPOT_QWORDS[1]} words (mean "
            f"{sum(len(t.split()) for t in q_texts) / q_cnt:.2f}), two gold passages each; drawn "
            f"in {gen_s:.2f} s; catalog ingest {ingest_s:.2f} s")
        del texts

        # Executor(catalog, config) with no context: BuildContext() on the card;
        # the legs' indexes built through its loader first (the run would build
        # them in its first health checks), each build and upload timed
        ex = Executor(cat, cfg)
        if str(ex.context.device) != "cuda":
            fail(f"Executor without a context builds for {ex.context.device}, not the card")
        dense, bm25 = ex.loader.load("vector_search"), ex.loader.load("bm25")
        for label, pipe in (("dense verified", dense), ("BM25", bm25)):
            t1 = time.perf_counter()
            idx = pipe._index()
            t2 = time.perf_counter()
            idx.to_device()
            torch.cuda.synchronize()
            log(f"hybrid: {label} index built from the catalog (artifact saved) in {t2 - t1:.2f} s, "
                f"on {idx.device} (upload{', bf16 sidecar' if label.startswith('dense') else ''}) "
                f"in {time.perf_counter() - t2:.2f} s")
        sparse = bm25._index()

        td.reset_launch_counts()
        tm.reset_launch_counts()
        ts.reset_launch_counts()
        t1 = time.perf_counter()
        result = ex.run()
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t1
        launches = {**{k: v for k, v in td.LAUNCHES.items() if v},
                    **{k: v for k, v in ts.LAUNCHES.items() if v},
                    **{k: v for k, v in tm.LAUNCHES.items() if v}}
        plain_calls = {k: v for k, v in {**ts.PLAIN_CALLS, **tm.PLAIN_CALLS}.items() if v}
        log(f"hybrid Executor.run: {run_s:.2f} s for {len(names)} pipelines; launches "
            f"{json.dumps(launches)}; plain calls {json.dumps(plain_calls)}")
        log(f"hybrid Executor spans (ms): {json.dumps({k: round(v, 1) for k, v in result.spans.items()})}")
        routes = {k: ts.bm25_route("auto", sparse.n_docs, k, dev.type, sparse.tile_skip,
                                   sparse._layout(), sparse._device_pack, sparse.probe_block_n)
                  for k in (K, HOTPOT_FETCH_K)}
        log(f"hybrid: BM25 layout {sparse._layout()} (pack {sparse._device_pack}), routes by k "
            f"{json.dumps(routes)}")
        log(result.report())
        for p in result.pipelines:
            log(f"hybrid pipeline {p.name}: ok {p.success}, attempts {p.attempts}, execution_time "
                f"{p.execution_time:.3f} s, run span {result.spans.get(f'{p.name}/run', 0):.1f} ms, "
                f"{p.stats.get('total_results')} rows for {p.stats.get('total_queries')} queries, "
                + ", ".join(f"{m.metric_name}@{K} {m.average} over {m.count}" for m in p.metrics))
        if not result.success:
            fail(f"hybrid Executor run failed: {result.report()}")
        for p in result.pipelines:
            want = gqr_q if p.name == "gqr_hybrid" else q_cnt
            if p.stats["total_results"] != want * K or p.stats["failed_queries"]:
                fail(f"hybrid pipeline {p.name} persisted {p.stats['total_results']} rows "
                     f"(want {want * K}), failed {p.stats['failed_queries']}")
            if len(p.metrics) != 2 or any(not m.success or m.count != want for m in p.metrics):
                fail(f"hybrid pipeline {p.name}: a metric failed or missed queries: {p.metrics}")
        left = [nm for nm in names if cat.get_pipeline(f"{nm}_health_check") is not None]
        if left:
            fail(f"health-check pipelines left in the catalog: {left}")
        if launches.get("seg_stats_bf16", 0) < 1 or plain_calls:
            fail("the hybrid run skipped #1 or took a plain route on the card")
        if not any(launches.get(k, 0) for k in ts.LAUNCHES):
            fail("the hybrid run launched no BM25 kernel")
        if launches.get("dense_topk_stream"):
            log(f"hybrid: the verified proof sent {launches['dense_topk_stream']} launches of the "
                f"streaming kernel (#2) to its exact fallback")

        # persisted rows of each pipeline, in query order
        qids = cat.get_all_query_ids()
        pid = {p.name: p.stats["pipeline_id"] for p in result.pipelines}
        rows = {nm: [[(r["doc_id"], r["rel_score"]) for r in cat.get_retrieved(q, pid[nm])]
                     for q in (qids[:gqr_q] if nm == "gqr_hybrid" else qids)] for nm in names}

        # the dense leg against an exact DenseIndex search of the same rows
        ref_s, ref_i = DenseIndex(list(range(n)), emb, mode="exact", device=dev).topk_rows(q_emb, K)
        got_i = np.array([[d for d, _ in r] for r in rows["vector_search"]])
        got_s = np.array([[s for _, s in r] for r in rows["vector_search"]], np.float32)
        n_mism, explained = ids_agree(got_i, got_s, ref_i, ref_s)
        log(f"hybrid dense leg vs exact DenseIndex: {n_mism} id mismatches (all sub-ulp: {explained})")
        if not explained:
            fail("the hybrid dense leg diverged from the exact search")
        del emb
        # the BM25 leg against an exact scan of the same device tensors
        q_ids, q_w = sparse.encode_queries(q_texts)
        ss, si = ts.bm25_topk_scan(torch.from_numpy(q_ids).to(dev), torch.from_numpy(q_w).to(dev),
                                   *sparse._flat_device(), K)
        ref = [[(sparse.ids[int(r)], float(s)) for s, r in zip(a, b) if s > 0]
               for a, b in zip(ss.cpu().numpy(), si.cpu().numpy())]
        n_diff = sum(a != b for a, b in zip(rows["bm25"], ref))
        log(f"hybrid BM25 leg vs exact scan: {n_diff} of {q_cnt} queries differ")
        if n_diff:
            fail("the hybrid BM25 leg diverged from the exact scan")

        # the legs' fetch_k lists, read back page by page as the run paged
        l1, l2 = {}, {}
        t1 = time.perf_counter()
        for lo in range(0, q_cnt, cfg.pipelines[0].batch_size):
            page = qids[lo : lo + cfg.pipelines[0].batch_size]
            l1.update(dense._retrieve_batch_by_ids(page, HOTPOT_FETCH_K))
            l2.update(bm25._retrieve_batch_by_ids(page, HOTPOT_FETCH_K))
        log(f"hybrid: legs read back at fetch_k={HOTPOT_FETCH_K} in {time.perf_counter() - t1:.2f} s")
        # the device's share of one page of the hybrid batch path (both legs'
        # batched searches at fetch_k, then the host fuser)
        rrf_pipe = ex.loader.load("hybrid_rrf")
        page = qids[: cfg.pipelines[0].batch_size]
        rows_, _, wall = device_breakdown(f"hybrid_rrf, a page of {len(page)} queries",
                                          lambda: rrf_pipe._retrieve_batch_by_ids(page, K), calls=2)
        if rows_:
            busy = sum(ms * cnt for ms, cnt, _ in rows_) / 2
            log(f"hybrid_rrf page: device busy {busy:.3f} ms of {wall:.3f} ms wall a call under the "
                f"profiler ({busy / wall:.1%}; idle {1 - busy / wall:.1%})")
        tmm = (-1.0, 0.0)  # _theoretical_min of a cosine leg and of BM25

        def host_fuse(name, top_k):
            if name == "hybrid_rrf":
                return [rrf_fuse(l1[q], l2[q], k=60, top_k=top_k, fetch_k=HOTPOT_FETCH_K) for q in qids]
            method, mins = ("mm", (None, None)) if name == "hybrid_cc" else ("tmm", tmm)
            return [cc_fuse(l1[q], l2[q], weight=0.5, top_k=top_k, normalize_method=method,
                            pipeline_1_min=mins[0], pipeline_2_min=mins[1]) for q in qids]

        host_full = {}
        for name in ("hybrid_rrf", "hybrid_cc", "hybrid_cc_tmm"):
            t1 = time.perf_counter()
            top = host_fuse(name, K)
            host_ms = (time.perf_counter() - t1) * 1e3
            same = rows[name] == [[(h["doc_id"], h["score"]) for h in hits] for hits in top]
            log(f"hybrid {name}: persisted rows == host fuser over the legs' fetch_k lists: {same} "
                f"(host fuser {host_ms:.1f} ms for {q_cnt} queries)")
            if not same:
                fail(f"{name}'s rows differ from the host fuser over its legs' lists")
            host_full[name] = host_fuse(name, 2 * HOTPOT_FETCH_K)

        # the device fusers on the card over the same lists as [Q, fetch_k] tensors
        def padded(lists, f):
            ids = np.full((q_cnt, f), INT_MAX, np.int32)
            sc = np.full((q_cnt, f), NEG_INF, np.float32)
            for r, q in enumerate(qids):
                for j, h in enumerate(lists[q][:f]):
                    ids[r, j], sc[r, j] = h["doc_id"], h["score"]
            return torch.from_numpy(ids).to(dev), torch.from_numpy(sc).to(dev)

        i1, s1 = padded(l1, HOTPOT_FETCH_K)
        i2, s2 = padded(l2, HOTPOT_FETCH_K)
        device_fusers = {
            "hybrid_rrf": lambda: fuse_batch_rrf(i1, i2, k=60, top_k=K, fetch_k=HOTPOT_FETCH_K),
            "hybrid_cc": lambda: fuse_batch_cc(i1, s1, i2, s2, weight=0.5, top_k=K),
            "hybrid_cc_tmm": lambda: fuse_batch_cc(i1, s1, i2, s2, weight=0.5, top_k=K,
                                                   normalize_method="tmm", pipeline_1_min=tmm[0],
                                                   pipeline_2_min=tmm[1]),
        }
        for name, fn in device_fusers.items():
            out = fn()
            n_mism, explained, worst = fused_agree(out, host_full[name], K)
            ms = cuda_ms(fn, 10)
            log(f"hybrid {name}: device fuser on the card [{q_cnt}, {HOTPOT_FETCH_K}] x 2 -> top-{K}: "
                f"{n_mism} id mismatches against the host fuser (all near-ties within 1e-6: "
                f"{explained}), max relative score error {worst:.3e}; {ms:.3f} ms")
            if out[0].device.type != "cuda" or not explained or worst > 1e-6:
                fail(f"the device fuser of {name} disagrees with the host fuser on the card")
        cat.close()

def ptxas_start(cuda_build, tmp: str, name: str):
    """Start one more nvcc of csrc/<name>.cu with ``-Xptxas -v`` (registers,
    shared memory and spills of each instantiation)."""
    src = cuda_build.CSRC_DIR / f"{name}.cu"
    return subprocess.Popen(
        [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
         f"{tmp}/ptxas_{name}.so", str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )


def ptxas_log(proc, name: str, lib: str) -> None:
    """Log each instantiation's registers, spills and anything ptxas says of
    ``setmaxnreg``: f32 or bf16, for the MaxSim tile body the fused
    (``Lb1``) or scores (``Lb0``) epilogue and the mask policy (``Li0E``
    lens, ``Li1E`` bias, ``Li2E`` lane), for the seg-stats kernel clusters of
    two (``ILi2E``) or single blocks (``ILi1E``)."""
    out, _ = proc.communicate()
    if proc.returncode != 0:
        fail(f"nvcc -Xptxas -v of {name}.cu failed:\n{out}")
    kernel = None
    for line in out.splitlines():
        if "Compiling entry function" in line and "seg_stats_kernel" in line:
            kernel = "bf16 clusters of two" if "ILi2E" in line else "bf16 single blocks"
        elif "Compiling entry function" in line:
            kernel = "bf16" if "BF16" in line else "f32"
            if "maxsim_tile_kernel" in line:
                kernel += " fused" if "Lb1" in line else " scores"
                kernel += " bias" if "Li1E" in line else " lane" if "Li2E" in line else " lens"
        elif kernel and ("registers" in line or "spill" in line or "setmaxnreg" in line):
            log(f"{name} {kernel} ptxas: {line.split(':', 1)[-1].strip()}")
    if name.startswith("maxsim"):
        sass_setmaxreg(lib, name)


def sass_setmaxreg(lib: str, name: str) -> None:
    """Log the register moves (``SETMAXREG``) each tile-body kernel of the
    library ``lib`` keeps in its machine code (``cuobjdump -sass``): the
    producer's release and the consumers' claim of ``setmaxnreg``."""
    from autorag_research_tpu_torch.ops import cuda_build

    tool = os.path.join(os.path.dirname(cuda_build.nvcc_path()), "cuobjdump")
    if not os.path.exists(tool):
        log(f"{name}: no cuobjdump beside nvcc, SASS not read")
        return
    out = subprocess.run([tool, "-sass", lib], capture_output=True, text=True, timeout=300).stdout
    fn, moves = None, {}
    for line in out.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            moves[fn] = []
        elif fn and "SETMAXREG" in line:
            moves[fn].append(line.split("*/", 1)[-1].split(";")[0].strip())
    for fn, ops in moves.items():
        if "maxsim_tile_kernel" in fn:
            log(f"{name} SASS {fn[:60]}: {len(ops)} SETMAXREG ({'; '.join(ops)})")


VERIFIED_PARTS = (  # (part, substrings of its kernels' names), first match wins
    ("#1 seg_stats", ("seg_stats_kernel",)),
    ("rescore bmm", ("gemm", "gemv", "xmma", "cutlass", "bmm")),
    ("selection (topk / sort)", ("topk", "sort", "radix", "bitonic", "scan")),  # gatherTopK too
    ("rescore gather", ("index", "gather")),
)


def verified_breakdown(label: str, fn, calls: int = 3) -> None:
    """Log where one verified search spends its time, from one
    :func:`device_breakdown` trace: device ms a call of #1, the rescore's
    ``bmm`` and gather, the selections (``topk_ordered`` over [Q, S] and the
    candidates), and the rest (the proof, masks, casts), with the kernels
    counted under each part; the device total against the wall time a call,
    whose difference is host work and the proof's host sync (the CPU time of
    its ``.item``-style reads is logged too)."""
    rows, events, wall = device_breakdown(label, fn, calls)
    if not rows:
        return
    parts: dict = {}
    for ms, n, name in rows:
        key = name.lower()
        part = next((p for p, subs in VERIFIED_PARTS if any(x in key for x in subs)), "other")
        parts.setdefault(part, []).append((ms * n / calls, name))
    sync_ms = sum(e.cpu_time_total for e in events
                  if e.key in ("aten::_local_scalar_dense", "cudaStreamSynchronize")) / 1e3 / calls
    total = {p: sum(ms for ms, _ in ks) for p, ks in parts.items()}
    dev_ms = sum(total.values())
    log(f"  {label}, device ms a call by part: " + "; ".join(
        f"{p} {ms:.3f}" for p, ms in sorted(total.items(), key=lambda kv: -kv[1])) +
        f"; device total {dev_ms:.3f} ms against {wall:.3f} ms wall a call under the profiler "
        f"(host and the proof's sync {wall - dev_ms:.3f} ms; CPU time in host reads of device "
        f"values {sync_ms:.3f} ms)")
    for p in sorted(total, key=lambda p: -total[p]):
        log(f"  {label}, kernels under {p}: " + "; ".join(
            f"{ms:.3f} ms {name[:60]}" for ms, name in sorted(parts[p], reverse=True)))


class SmiSampler:
    """``nvidia-smi --query-gpu=clocks.sm,power.draw`` every 100 ms while a
    ``with`` block runs; ``summary()`` gives the samples' range and mean."""

    def __enter__(self):
        self.proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw", "--format=csv,noheader,nounits",
             "-lms", "100"], stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
        )
        return self

    def __exit__(self, *exc):
        self.proc.terminate()
        out, _ = self.proc.communicate(timeout=30)
        self.rows = []
        for line in out.splitlines():
            try:
                self.rows.append(tuple(float(v) for v in line.split(",")[:2]))
            except ValueError:
                continue

    def summary(self) -> str:
        if not self.rows:
            return "no samples"
        mhz = [r[0] for r in self.rows]
        w = [r[1] for r in self.rows]
        return (f"{len(self.rows)} samples: SM clock {min(mhz):.0f}-{max(mhz):.0f} MHz "
                f"(mean {sum(mhz) / len(mhz):.0f}), power {min(w):.1f}-{max(w):.1f} W "
                f"(mean {sum(w) / len(w):.1f})")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device: this smoke run measures the GPU port", file=sys.stderr)
        return 1
    try:
        from autorag_research_tpu_torch.ops import cuda_build
    except ImportError as exc:
        print(f"FAIL: the port package is not beside this script: {exc}", file=sys.stderr)
        return 2
    from autorag_research_tpu_torch.embeddings.torch_encoder import TorchEncoderEmbedding
    from autorag_research_tpu_torch.evaluation.metrics.retrieval import (
        retrieval_ndcg,
        retrieval_recall,
    )
    from autorag_research_tpu_torch.index.dense import DenseIndex
    from autorag_research_tpu_torch.models.encoder import EncoderConfig
    from autorag_research_tpu_torch.ops import dense as td
    from autorag_research_tpu_torch.pipelines.retrieval.vector_search import (
        VectorSearchPipeline,
    )
    from autorag_research_tpu_torch.schema import MetricInput
    from autorag_research_tpu_torch.store.catalog import Catalog
    from autorag_research_tpu_torch.store.gt import build_retrieval_gt_from_relations

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log(card)
    log(f"device: {kind}, count {torch.cuda.device_count()}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    peak = PEAKS["pcie" if "PCIe" in kind else "sxm"]

    # ---- 1. build -----------------------------------------------------------
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        # beside the build, not in it
        ptxas = {n: ptxas_start(cuda_build, tmp, n) for n in PTXAS_SOURCES}
        secs = cuda_build.build_all()
        log(f"kernel build: {json.dumps({n: round(s, 2) for n, s in secs.items()})} "
            f"({time.perf_counter() - t0:.2f} s in all)")
        for n, proc in ptxas.items():
            ptxas_log(proc, n, f"{tmp}/ptxas_{n}.so")

    # ---- data and indexes ---------------------------------------------------
    rng = np.random.default_rng(args.seed)
    corpus = rng.standard_normal((N_DOCS, DIM), dtype=np.float32)
    corpus /= np.linalg.norm(corpus, axis=1, keepdims=True)
    doc_ids = list(range(N_DOCS))
    t0 = time.perf_counter()
    index_v = DenseIndex(doc_ids, corpus, mode="verified", device=dev).to_device()
    index_e = DenseIndex(doc_ids, corpus, mode="exact", device=dev).to_device()
    torch.cuda.synchronize()
    log(f"indexes on device: {N_DOCS} x {DIM} f32 + bf16 sidecar "
        f"({time.perf_counter() - t0:.2f} s)")
    vocab = [f"tok{i}" for i in range(20000)]
    query_texts = make_texts(rng, vocab, Q_EXACT, 8, 33)
    embedder = TorchEncoderEmbedding(
        EncoderConfig(**ENCODER), seed=args.seed, batch_size=512, device=dev
    )

    # ---- 2. kernels vs plain at main-path shapes ----------------------------
    kernels = []
    with torch.inference_mode():
        q_emb = embedder.embed_texts_device(query_texts)
        q_norm = q_emb / torch.linalg.vector_norm(q_emb, dim=1, keepdim=True)
    side = index_v._sidecar
    q_lo = q_norm[:Q_VERIFIED].to(torch.bfloat16).contiguous()
    c_lo = side["corpus_lo"]
    got = td.seg_stats_bf16(q_lo, c_lo, N_DOCS)
    ref = td._seg_stats_plain((q_lo, None), c_lo, None, N_DOCS, 128)
    torch.cuda.synchronize()
    qn = torch.linalg.vector_norm(q_lo.float(), dim=1, keepdim=True)
    cn = torch.linalg.vector_norm(c_lo.float(), dim=1).max()
    tol = DIM * 2.0**-23 * qn * cn  # f32 reduction-order bound per query row
    err1 = (got[0] - ref[0]).abs()
    err2 = (got[2] - ref[2]).abs()
    seg_err = max(err1.max().item(), err2.max().item())
    if not (bool((err1 <= tol).all()) and bool((err2 <= tol).all())):
        fail(f"seg_stats_bf16 max1/max2 beyond the reduction-order bound: {seg_err}")
    loc_mism = got[1] != ref[1]
    near_tie = (ref[0] - ref[2]) <= 2 * tol
    unexplained = int((loc_mism & ~near_tie).sum())
    log(f"seg_stats_bf16 vs plain @ Q={Q_VERIFIED} x N_pad={c_lo.shape[0]} x d={DIM}: "
        f"max|d max1,max2| = {seg_err:.3e} (bound {tol.max().item():.3e}), "
        f"loc1 mismatches {int(loc_mism.sum())}/{loc_mism.numel()}, "
        f"{unexplained} not near-ties")
    if unexplained:
        fail("seg_stats_bf16 loc1 disagrees with the plain version beyond near-ties")
    s_cnt = got[0].shape[1]

    # yardstick: one cuBLAS GEMM of the same bf16 operands with f32 output
    # (``mm`` with ``out_dtype`` where this PyTorch has it, else the operands
    # upcast to f32 with TF32 off, the same products summed in f32)
    td._require_exact_f32()
    if hasattr(torch.ops.aten.mm, "dtype"):
        lib_name = "mm(bf16, bf16, out_dtype=f32)"

        def seg_gemm():
            return torch.mm(q_lo, c_lo.T, out_dtype=torch.float32)
    else:
        lib_name = "matmul(f32(bf16), f32(bf16)), TF32 off"

        def seg_gemm():
            return torch.matmul(q_lo.float(), c_lo.float().T)
    ref_gemm = td._scores(q_lo[:64], c_lo[:4096])
    if not torch.allclose(seg_gemm()[:64, :4096], ref_gemm, rtol=1e-6, atol=1e-5):
        fail(f"seg_stats yardstick {lib_name} does not give f32 scores of the bf16 operands")
    log(f"seg_stats_bf16 library yardstick: {lib_name} + [Q, S, 128] reductions")

    def seg_library():
        s = seg_gemm().view(Q_VERIFIED, s_cnt, 128)
        m1, l1 = s.max(dim=2)
        return m1, l1, s.scatter(2, l1[:, :, None], td.NEG_INF).amax(dim=2)

    n_pad = c_lo.shape[0]
    seg_plan = td._seg_plan_on_card(Q_VERIFIED, n_pad, DIM, dev)
    log(f"seg_stats_bf16 plan @ Q={Q_VERIFIED} x N_pad={n_pad} x d={DIM}: {seg_plan}")
    # 10 launches, as #1 was timed before its redesign and as the main path
    # meets it (one launch a batch); then about a second back to back, with
    # clock and power sampled: at 700 W the card lowers its clock under this load
    seg_ms = cuda_ms(lambda: td.seg_stats_bf16(q_lo, c_lo, N_DOCS), 10)
    with SmiSampler() as smi:
        seg_sustained_ms = cuda_ms(lambda: td.seg_stats_bf16(q_lo, c_lo, N_DOCS), 800)
    seg_plain_ms = cuda_ms(lambda: td._seg_stats_plain((q_lo, None), c_lo, None, N_DOCS, 128), 3)
    seg_lib_ms = cuda_ms(seg_library, 3)
    seg_mm_ms = cuda_ms(seg_gemm, 10)
    seg_bound, seg_by = bound(
        2.0 * Q_VERIFIED * n_pad * DIM,
        (Q_VERIFIED + n_pad) * DIM * 2 + 3 * Q_VERIFIED * s_cnt * 4,
        peak["bf16"], peak["hbm"],
    )
    log(f"seg_stats_bf16 @ Q={Q_VERIFIED} x N_pad={n_pad} x d={DIM}: {seg_ms:.3f} ms over 10 "
        f"launches, {seg_sustained_ms:.3f} ms over 800 ({smi.summary()}); bound {seg_bound:.3f} "
        f"ms ({seg_by}, {seg_bound / seg_ms:.1%} of it over 10, "
        f"{seg_bound / seg_sustained_ms:.1%} over 800); "
        f"{lib_name} alone {seg_mm_ms:.3f} ms, with the reductions {seg_lib_ms:.3f} ms; plain "
        f"{seg_plain_ms:.3f} ms")
    kernels.append({
        "name": "seg_stats_bf16", "route": "cuda",
        "source": "autorag_research_tpu_torch/csrc/seg_stats.cu",
        "replaces": "autorag_research_tpu/ops/dense.py:690",
        "max_abs_err": seg_err, "ms": seg_ms, "plain_ms": seg_plain_ms,
        "bound_ms": seg_bound, "bound_by": seg_by, "library_ms": seg_lib_ms,
        "matmul_ms": seg_mm_ms, "sustained_ms": seg_sustained_ms,
    })
    del got, ref, err1, err2

    q_ex = q_norm.contiguous()
    c_f32 = index_e._device
    s_k, i_k = td.dense_topk_stream(q_ex, c_f32, K)
    s_p, i_p = td.dense_topk_plain(q_ex, c_f32, K)
    s_k, i_k, s_p, i_p = (t.cpu().numpy() for t in (s_k, i_k, s_p, i_p))
    n_mism, explained = ids_agree(i_k, s_k, i_p, s_p)
    stream_err = float(np.abs(s_k - s_p).max())
    log(f"dense_topk_stream vs plain @ Q={Q_EXACT} x N={N_DOCS} x d={DIM} f32: "
        f"ids mismatches {n_mism}/{i_k.size} (all sub-ulp: {explained}), "
        f"max|d score| = {stream_err:.3e}")
    if not explained or not (np.abs(s_k - s_p) <= 1e-6 * np.abs(s_p) + 4e-7).all():
        fail("dense_topk_stream disagrees with its plain version")
    # a list longer than a warp (recall@100) through the same kernel
    s_k, i_k = td.dense_topk_stream(q_ex, c_f32, K_LONG)
    s_p, i_p = td.dense_topk_plain(q_ex, c_f32, K_LONG)
    s_k, i_k, s_p, i_p = (t.cpu().numpy() for t in (s_k, i_k, s_p, i_p))
    n_mism, explained = ids_agree(i_k, s_k, i_p, s_p)
    long_err = float(np.abs(s_k - s_p).max())
    long_ms = cuda_ms(lambda: td.dense_topk_stream(q_ex, c_f32, K_LONG), 2)
    log(f"dense_topk_stream vs plain @ Q={Q_EXACT} x N={N_DOCS} x d={DIM} f32, k={K_LONG}: "
        f"ids mismatches {n_mism}/{i_k.size} (all sub-ulp: {explained}), "
        f"max|d score| = {long_err:.3e}, kernel {long_ms:.3f} ms")
    if not explained or not (np.abs(s_k - s_p) <= 1e-6 * np.abs(s_p) + 4e-7).all():
        fail(f"dense_topk_stream disagrees with its plain version at k={K_LONG}")
    del s_k, i_k, s_p, i_p
    # the plan the wrapper takes at the main path, from this card's SMs and
    # the kernel's resident blocks an SM (the occupancy calculator)
    for dt in (torch.float32, torch.bfloat16):
        log(f"dense_topk_stream plan @ Q={Q_EXACT} x N={N_DOCS} x d={DIM} {str(dt)[6:]}, k={K}: "
            f"{td._stream_plan_on_card(Q_EXACT, N_DOCS, DIM, K, dt, dev)}")
    with SmiSampler() as smi:
        stream_ms = cuda_ms(lambda: td.dense_topk_stream(q_ex, c_f32, K), 30)
    log(f"  beside the k={K} timing: {smi.summary()}")
    k1000_ms = cuda_ms(lambda: td.dense_topk_stream(q_ex, c_f32, K_ANY), 2)
    stream_plain_ms = cuda_ms(lambda: td.dense_topk_plain(q_ex, c_f32, K), 2)
    with SmiSampler() as smi:
        mm_ms = cuda_ms(lambda: torch.matmul(q_ex, c_f32.T), 30)
    stream_lib_ms = cuda_ms(lambda: torch.topk(torch.matmul(q_ex, c_f32.T), K), 2)
    stream_bound, stream_by = bound(
        2.0 * Q_EXACT * N_DOCS * DIM,
        (Q_EXACT + N_DOCS) * DIM * 4 + Q_EXACT * K * 8,
        peak["f32"], peak["hbm"],
    )
    log(f"dense_topk_stream f32 @ Q={Q_EXACT} x N={N_DOCS} x d={DIM}: k={K} / {K_LONG} / {K_ANY} "
        f"{stream_ms:.3f} / {long_ms:.3f} / {k1000_ms:.3f} ms; bound {stream_bound:.3f} ms "
        f"({stream_bound / stream_ms:.1%} of it at k={K}); torch.matmul(q, c.T) alone "
        f"{mm_ms:.3f} ms ({smi.summary()}), matmul + topk {stream_lib_ms:.3f} ms; plain "
        f"{stream_plain_ms:.3f} ms")
    device_breakdown(f"dense_topk_stream f32 k={K} (kernel against merge_topk)",
                     lambda: td.dense_topk_stream(q_ex, c_f32, K))
    kernels.append({
        "name": "dense_topk_stream", "route": "cuda",
        "source": "autorag_research_tpu_torch/csrc/dense_topk_stream.cu",
        "replaces": "autorag_research_tpu/ops/dense.py:166",
        "max_abs_err": stream_err, "ms": stream_ms, "plain_ms": stream_plain_ms,
        "bound_ms": stream_bound, "bound_by": stream_by, "library_ms": stream_lib_ms,
        "matmul_ms": mm_ms, "k100_ms": long_ms, "k1000_ms": k1000_ms,
    })
    # the bf16 instantiation at the same shapes (mma.sync, f32 sums), its own
    # bound at the bf16 tensor rate and its own library call
    q16, c16 = q_ex.to(torch.bfloat16), c_f32.to(torch.bfloat16)
    b16_err = 0.0
    for kk in (K, K_LONG):
        s_k, i_k = td.dense_topk_stream(q16, c16, kk)
        s_p, i_p = td.dense_topk_plain(q16, c16, kk)
        s_k, i_k, s_p, i_p = (t.cpu().numpy() for t in (s_k, i_k, s_p, i_p))
        n_mism, explained = ids_agree(i_k, s_k, i_p, s_p)
        err = float(np.abs(s_k - s_p).max())
        b16_err = max(b16_err, err)
        log(f"dense_topk_stream vs plain @ Q={Q_EXACT} x N={N_DOCS} x d={DIM} bf16, k={kk}: "
            f"ids mismatches {n_mism}/{i_k.size} (all sub-ulp: {explained}), "
            f"max|d score| = {err:.3e}")
        if not explained or not (np.abs(s_k - s_p) <= 1e-6 * np.abs(s_p) + 4e-7).all():
            fail(f"dense_topk_stream bf16 disagrees with its plain version at k={kk}")
    del s_k, i_k, s_p, i_p
    b16_ms = cuda_ms(lambda: td.dense_topk_stream(q16, c16, K), 5)
    b16_plain_ms = cuda_ms(lambda: td.dense_topk_plain(q16, c16, K), 2)
    b16_lib_ms = cuda_ms(lambda: torch.topk(torch.matmul(q16, c16.T), K), 2)
    b16_bound, b16_by = bound(
        2.0 * Q_EXACT * N_DOCS * DIM,
        (Q_EXACT + N_DOCS) * DIM * 2 + Q_EXACT * K * 8,
        peak["bf16"], peak["hbm"],
    )
    log(f"dense_topk_stream bf16 @ Q={Q_EXACT} x N={N_DOCS} x d={DIM}, k={K}: {b16_ms:.3f} ms, "
        f"bound {b16_bound:.3f} ms ({b16_by}), topk(matmul(q16, c16.T)) {b16_lib_ms:.3f} ms, "
        f"plain {b16_plain_ms:.3f} ms")
    kernels.append({
        "name": "dense_topk_stream", "case": f"bf16 Q={Q_EXACT} x N={N_DOCS} x d={DIM}, k={K}",
        "route": "cuda", "source": "autorag_research_tpu_torch/csrc/dense_topk_stream.cu",
        "replaces": "autorag_research_tpu/ops/dense.py:166",
        "max_abs_err": b16_err, "ms": b16_ms, "plain_ms": b16_plain_ms,
        "bound_ms": b16_bound, "bound_by": b16_by, "library_ms": b16_lib_ms,
    })
    del q16, c16

    # the ``full`` path (scores within the 2 GiB budget): time and peak memory
    q_full = q_ex[:Q_VERIFIED]
    fs, fi = td.dense_topk_full(q_full, c_f32, K)
    ks, ki = td.dense_topk_stream(q_full, c_f32, K)
    n_mism, explained = ids_agree(
        fi.cpu().numpy(), fs.cpu().numpy(), ki.cpu().numpy(), ks.cpu().numpy()
    )
    if not explained:
        fail("dense_topk_full disagrees with the streaming kernel")
    torch.cuda.synchronize()
    base_mem = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    full_ms = cuda_ms(lambda: td.dense_topk_full(q_full, c_f32, K), 3)
    full_peak = torch.cuda.max_memory_allocated() - base_mem
    log(f"dense_topk_full @ Q={Q_VERIFIED} x N={N_DOCS} x d={DIM} f32: {full_ms:.3f} ms, "
        f"peak {full_peak / 2**30:.3f} GiB above the resident tensors "
        f"(scores {Q_VERIFIED * N_DOCS * 4 / 2**30:.3f} GiB); vs kernel {n_mism} id "
        f"mismatches (all sub-ulp: {explained})")
    del fs, fi, ks, ki

    # ---- 3. main path, launch counts from 0 ---------------------------------
    td.reset_launch_counts()
    t0 = time.perf_counter()
    emb_v = embedder.embed_texts_device(query_texts[:Q_VERIFIED])
    sv, rv = index_v.topk_rows(emb_v, K)
    ver_stats = index_v.last_stats
    emb_e = embedder.embed_texts_device(query_texts)
    se, re = index_e.topk_rows(emb_e, K)
    main_s = time.perf_counter() - t0
    launches = dict(td.LAUNCHES)
    log(f"main path launches: {json.dumps(launches)} ({main_s:.2f} s, first calls)")
    if min(launches.values()) < 1:
        fail(f"a kernel of the main path never launched: {launches}")
    for k in kernels:
        k["launches"] = launches[k["name"]]
    n_fail, covered = ver_stats
    n_mism, explained = ids_agree(rv, sv, re[:Q_VERIFIED], se[:Q_VERIFIED])
    log(f"verified vs exact ids: {n_mism}/{rv.size} mismatches (all sub-ulp: {explained}); "
        f"n_fail {n_fail}/{Q_VERIFIED}, covered {covered}")
    if not explained:
        fail("verified ids diverge from the exact scan beyond sub-ulp near-ties")
    if not (np.isfinite(sv).all() and sv.shape == (Q_VERIFIED, K)):
        fail("verified scores are not finite [Q, k]")
    embed_ms = wall_ms(lambda: embedder.embed_texts_device(query_texts[:Q_VERIFIED]), 3)
    ver_ms = wall_ms(lambda: index_v.topk_rows(emb_v, K), 5)
    ex_ms = wall_ms(lambda: index_e.topk_rows(emb_e, K), 2)
    log(f"embed {Q_VERIFIED} texts: {embed_ms:.3f} ms/batch ({Q_VERIFIED / embed_ms * 1e3:.1f} texts/s)")
    log(f"verified search Q={Q_VERIFIED}: {ver_ms:.3f} ms/batch, {Q_VERIFIED / ver_ms * 1e3:.1f} QPS")
    verified_breakdown(f"verified search Q={Q_VERIFIED}", lambda: index_v.topk_rows(emb_v, K))
    log(f"exact search Q={Q_EXACT} (streaming kernel): {ex_ms:.3f} ms/batch, "
        f"{Q_EXACT / ex_ms * 1e3:.1f} QPS")
    del index_e, c_f32, q_ex, emb_e

    # ---- 4. SciFact-size catalog run ---------------------------------------
    crng = np.random.default_rng(args.seed + 1)
    chunk_texts = make_texts(crng, vocab, SCIFACT_CHUNKS, 40, 121)
    gold = crng.choice(SCIFACT_CHUNKS, size=SCIFACT_QUERIES, replace=False)
    q_texts = [" ".join(crng.choice(chunk_texts[g].split(), size=12)) for g in gold]
    chunk_emb = embedder.embed_texts(chunk_texts)
    query_emb = embedder.embed_texts(q_texts)
    with tempfile.TemporaryDirectory() as tmp:
        cat = Catalog(f"{tmp}/scifact.db", embedding_dim=DIM)
        cat.add_chunks(
            {"id": i, "contents": t, "embedding": e}
            for i, (t, e) in enumerate(zip(chunk_texts, chunk_emb))
        )
        cat.add_queries(
            {"id": j, "contents": t, "embedding": e}
            for j, (t, e) in enumerate(zip(q_texts, query_emb))
        )
        for j, g in enumerate(gold):
            cat.add_retrieval_gt(j, int(g))
        td.reset_launch_counts()
        pipe = VectorSearchPipeline(
            cat, name="dense_verified", index_options={"mode": "verified"}, device=dev
        )
        stats = pipe.run(top_k=K)
        cat_launches = dict(td.LAUNCHES)
        rows = {
            j: cat.get_retrieved(j, pipe.pipeline_id) for j in range(SCIFACT_QUERIES)
        }
        inputs = []
        for j in range(SCIFACT_QUERIES):
            gt, _ = build_retrieval_gt_from_relations(
                [dict(r) for r in cat.get_relations_by_query(j)]
            )
            inputs.append(MetricInput(
                retrieval_gt=gt, retrieved_ids=[f"chunk_{r['doc_id']}" for r in rows[j]]
            ))
        cat.close()
    recall = float(np.mean(retrieval_recall(inputs)))
    ndcg = float(np.mean(retrieval_ndcg(inputs)))
    got_ids = np.array([[r["doc_id"] for r in rows[j]] for j in range(SCIFACT_QUERIES)])
    got_s = np.array([[r["rel_score"] for r in rows[j]] for j in range(SCIFACT_QUERIES)])
    ref_s, ref_i = DenseIndex(
        list(range(SCIFACT_CHUNKS)), chunk_emb, device=dev
    ).topk_rows(query_emb, K)
    n_mism, explained = ids_agree(got_ids, got_s.astype(np.float32), ref_i, ref_s)
    log(f"SciFact-size catalog run: {stats['total_results']} rows persisted for "
        f"{stats['total_queries']} queries, launches {json.dumps(cat_launches)}, "
        f"recall@10 {recall:.4f}, ndcg@10 {ndcg:.4f}, "
        f"vs exact search {n_mism} id mismatches (all sub-ulp: {explained})")
    if stats["total_results"] != SCIFACT_QUERIES * K or stats["failed_queries"]:
        fail(f"catalog run persisted {stats['total_results']} rows, failed "
             f"{stats['failed_queries']}")
    if not explained or cat_launches["seg_stats_bf16"] < 1:
        fail("catalog run diverged from the exact search or skipped the kernel")
    if not (0.0 <= recall <= 1.0 and 0.0 <= ndcg <= 1.0 and math.isfinite(ndcg)):
        fail(f"metrics out of range: recall {recall}, ndcg {ndcg}")

    del index_v, side, c_lo, q_lo, q_emb, q_norm, emb_v, embedder, chunk_emb
    torch.cuda.empty_cache()

    log(f"phases 1-4: {time.perf_counter() - t_start:.1f} s")

    # ---- 5-8. the MaxSim path --------------------------------------------
    t0 = time.perf_counter()
    maxsim_phases(args.seed, dev, peak, kernels, vocab)
    log(f"phases 5-8: {time.perf_counter() - t0:.1f} s")

    # ---- 9-11. the BM25 path ----------------------------------------------
    t0 = time.perf_counter()
    bm25_phases(args.seed, dev, peak, kernels, vocab)
    log(f"phases 9-11: {time.perf_counter() - t0:.1f} s")

    # ---- 12-14. BM25 slice B: packed and bucketed layouts, the v1 pin ------
    t0 = time.perf_counter()
    bm25_packed_phases(args.seed, dev, peak, kernels)
    log(f"phases 12-14: {time.perf_counter() - t0:.1f} s")

    # ---- 15-16. the MaxSim pins (#11, #12), any k and d, the serving modes ----
    t0 = time.perf_counter()
    pin_serving_phases(args.seed, dev, peak, kernels, vocab, corpus, query_texts)
    log(f"phases 15-16: {time.perf_counter() - t0:.1f} s")
    del corpus
    torch.cuda.empty_cache()

    # ---- 17. config #3 (hybrid) through the Executor ----------------------
    t0 = time.perf_counter()
    hybrid_executor_phase(args.seed, dev)
    log(f"phase 17 (hybrid Executor run): {time.perf_counter() - t0:.1f} s")

    log(f"total {time.perf_counter() - t_start:.1f} s; card {card}")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
