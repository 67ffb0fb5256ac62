// bm25_v2: the launchers of every BM25 kernel of the port, six names onto
// one scoring body, bm25_hash.cuh (a per-document term hash in shared
// memory, probed once per (live query term, document); query tiles of up to
// 256 queries per staged document tile; cp.async double-buffered staging;
// a fused streaming top-k). Its note gives the design and the bound.
//
// Each launcher replaces a kernel of autorag_research_tpu/ops/sparse.py:
//   bm25_topk_v2_launch            ::_bm25_kernel_v2 (bm25_topk_pallas_v2), the
//                                  whole-corpus walk over the flat layout;
//   bm25_topk_v1_launch            ::_bm25_kernel (bm25_topk_pallas, the v1 pin),
//                                  the same walk under its own name;
//   bm25_topk_v2_skip_launch       ::_bm25_kernel_v2_skip
//                                  (bm25_topk_pallas_v2_skip), the skip walk over
//                                  the Bloom predicate's masks, both modes;
//   bm25_topk_packed_launch        ::_bm25_kernel_packed (bm25_topk_pallas_packed),
//                                  the whole-corpus walk over the packed layout;
//   bm25_topk_probe_launch         ::_bm25_kernel_probe (bm25_topk_pallas_probe),
//                                  the skip walk in positive_only mode over masks
//                                  built from candidate lists;
//   bm25_topk_probe_packed_launch  ::_bm25_kernel_probe_packed
//                                  (bm25_topk_pallas_probe_packed), the same over
//                                  the packed layout.
// All six TPU kernels compute one function, as the Pallas kernels share
// _slot_match_scores:
//
//   score(b, n) = sum over t = 0..T-1, in order, of
//                 (sum_l [doc_ids[n, l] == q_ids[b, t]] * doc_w[n, l]) * q_w[b, t]
//
// each product and each partial sum rounded on its own (__fmul_rn /
// __fadd_rn forbid FMA contraction), so every walk equals the plain PyTorch
// version bitwise. Pads (doc -1, query -2) never match, wherever they sit.
//
// The probe walks. A probe lists, per tile of 8 queries, the doc tiles of
// block_n documents its queries may score (ops/sparse.py::probe_candidates,
// or tile-WAND's passes); documents of other tiles stay out even where they
// would score > 0. That is the skip walk's contract in positive_only mode
// with one 32-bit mask per (query tile of QB, skip tile): bit g set iff the
// tile is a live entry of the list of the 8-query group g
// (ops/sparse.py::probe_group_masks, built on the device from the lists). A
// query whose bit is 0 probes nothing there and offers nothing, and a skip
// tile no group lists is neither staged nor given tables. The walk meets
// documents in row order by construction, so the lists need no sorting.
//
// Bound on this card: one multiply and one add per (live query term,
// document scored), 2 operations that the rounding keeps apart (no FMA), so
// at most 33.5 TFLOP/s, half the FMA peak; and the id and weight arrays of
// the doc tiles some query must score, read once, at 3.35 TB/s.

#include "bm25_hash.cuh"

// The whole-corpus walk over the flat layout.
extern "C" int bm25_topk_v2_launch(BM25_HASH_ARGS) {
  return bm25_hash::launch(bm25_hash::FULL, BM25_HASH_PASS);
}

// The v1 pin. Replaces autorag_research_tpu/ops/sparse.py::_bm25_kernel
// (Pallas, wrapper bm25_topk_pallas / _launch_bm25_pallas, block_n = 1024),
// which a SparseIndex search reaches only through method="pallas". The pin
// keeps the TPU kernel's function, not its blocks: the TPU's v1 walked
// 1,024-document tiles one (query, term) pair per step, a structure its own
// v2 replaced, so here it is the whole-corpus walk's kernel under its own
// name (the wrapper counts its launches apart).
extern "C" int bm25_topk_v1_launch(BM25_HASH_ARGS) {
  return bm25_hash::launch(bm25_hash::FULL, BM25_HASH_PASS);
}

// The skip walk, walk = SKIP_POS (positive_only) or SKIP_V2.
extern "C" int bm25_topk_v2_skip_launch(BM25_HASH_ARGS) {
  return bm25_hash::launch(bm25_hash::SKIP_POS, BM25_HASH_PASS);
}

// The whole-corpus walk over the packed layout (pack > 1 where the pack is
// no power of two; the wrapper passes a power of two's rows as the flat
// [R pack, 128 / pack] array, pack = 1).
extern "C" int bm25_topk_packed_launch(BM25_HASH_ARGS) {
  return bm25_hash::launch(bm25_hash::FULL, BM25_HASH_PASS);
}

// The probe: the skip walk, positive_only only, over candidate-list masks.
extern "C" int bm25_topk_probe_launch(BM25_HASH_ARGS) {
  if (walk != bm25_hash::SKIP_POS) return (int)cudaErrorInvalidValue;
  return bm25_hash::launch(bm25_hash::SKIP_POS, BM25_HASH_PASS);
}

// The packed probe: the same over the packed layout (as
// bm25_topk_packed_launch, a power-of-two pack comes as the flat array).
extern "C" int bm25_topk_probe_packed_launch(BM25_HASH_ARGS) {
  if (walk != bm25_hash::SKIP_POS) return (int)cudaErrorInvalidValue;
  return bm25_hash::launch(bm25_hash::SKIP_POS, BM25_HASH_PASS);
}
