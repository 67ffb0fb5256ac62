// maxsim_v2: multi-vector MaxSim (late interaction) scoring, with a fused
// streaming top-k or with raw scores.
//
// Replaces autorag_research_tpu/ops/maxsim.py::_maxsim_kernel_v2 (Pallas,
// wrapper maxsim_topk_pallas_v2) and ::_maxsim_kernel_v2_scores (wrappers
// _scores_chunk_pallas / maxsim_scores_pallas_v2, used by
// maxsim_topk_via_scores). Both share one tile body, as the two Pallas
// kernels share _v2_tile_scores (here maxsim_kernel.cuh, LENS policy):
//
//   score(b, n) = sum_{t < Tq_pad} max_{s < len_n} q[b, t] . doc[n, s]
//
// over zero-padded query-token rows (pad rows add +0 to a non-empty doc) and
// the first len_n tokens of each document only; tokens at or past len_n are
// never loaded. An empty document (len 0) scores NEG_INF with its own row,
// the convention of maxsim_topk_xla (the Pallas kernels let its sum overflow
// to -inf instead). dlens [N] int32 is the aux input. The fused epilogue
// writes per-part lists [B, P, k], any k; the scores epilogue writes [B, N]
// f32 directly (the Pallas kernel wrote [N, B] for the TPU's lane rule).
//
// Bound on this card, as chip_smoke.py's mv_bound computes it over the valid
// query and document tokens: at the text scale (128 queries of up to 32
// tokens against 50,000 docs of 64-128 tokens x 128 dims, f32) 50.7 ms at
// 67 TFLOP/s against about 1 ms for the tokens' bytes, and at the page scale
// (10,000 pages of 512-1,024 tokens, bf16) 5.5 ms at 989 TFLOP/s: both are
// bound by operations.

#include "maxsim_kernel.cuh"

MAXSIM_LAUNCHER(maxsim_topk_v2_f32_launch, TileF32, true, maxsim::LENS)
MAXSIM_LAUNCHER(maxsim_topk_v2_bf16_launch, TileBF16, true, maxsim::LENS)
MAXSIM_LAUNCHER(maxsim_scores_v2_f32_launch, TileF32, false, maxsim::LENS)
MAXSIM_LAUNCHER(maxsim_scores_v2_bf16_launch, TileBF16, false, maxsim::LENS)
