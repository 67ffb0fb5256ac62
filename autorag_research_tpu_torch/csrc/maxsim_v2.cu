// maxsim_v2: multi-vector MaxSim (late interaction) scoring, with a fused
// streaming top-k or with raw scores.
//
// Replaces autorag_research_tpu/ops/maxsim.py::_maxsim_kernel_v2 (Pallas,
// line 311; wrapper maxsim_topk_pallas_v2) and ::_maxsim_kernel_v2_scores
// (line 442; wrappers _scores_chunk_pallas / maxsim_scores_pallas_v2, used by
// maxsim_topk_via_scores). Both share one tile body, as the two Pallas
// kernels share _v2_tile_scores: here maxsim_tile.cuh, whose header sets out
// the design.
//
//   score(b, n) = sum_{t < len_b} max_{s < len_n} q[b, t] . doc[n, s]
//
// over each query's own token rows (the plan packs whole queries into row
// tiles, so no pad row is computed) and each document's first len_n tokens,
// walked in chunks of 16. An empty document (len 0) scores NEG_INF with its
// own row, the convention of maxsim_topk_xla (the Pallas kernels let its sum
// overflow to -inf instead). The fused epilogue writes per-part lists
// [B, P, k], any k; the scores epilogue writes [B, N] f32 directly (the
// Pallas kernel wrote [N, B] for the TPU's lane rule).
//
// Bound on this card, as chip_smoke.py's mv_bound computes it over the valid
// query and document tokens: at the text scale (128 queries of up to 32
// tokens against 50,000 docs of 64-128 tokens x 128 dims, f32) 50.7 ms at
// 67 TFLOP/s against about 1 ms for the tokens' bytes, and at the page scale
// (10,000 pages of 512-1,024 tokens, bf16) 5.5 ms at 989 TFLOP/s: both are
// bound by operations. The design's answer: compute no pad row and walk
// tokens close to each document's length (the plan reports both ratios),
// keep the query rows resident, stage tokens by TMA from a producer warp,
// and run bf16 on wgmma.

#include "maxsim_tile.cuh"

MAXSIM_LAUNCHER(maxsim_topk_v2_f32_launch, F32, true, LENS)
MAXSIM_LAUNCHER(maxsim_topk_v2_bf16_launch, BF16, true, LENS)
MAXSIM_LAUNCHER(maxsim_scores_v2_f32_launch, F32, false, LENS)
MAXSIM_LAUNCHER(maxsim_scores_v2_bf16_launch, BF16, false, LENS)

// This layout's shared-memory bytes for a block (-1 past a block's limit);
// the same for every Mask policy.
extern "C" int maxsim_v2_smem_bytes(int bf16, int k_boxes, int stages, int resident,
                                    int smem_lists, int k) {
  const int rows = bf16 ? mtile::BF16::ROWS : mtile::F32::ROWS;
  const long long b =
      mtile::layout_bytes(rows, k_boxes, stages, resident != 0, smem_lists != 0, k);
  return b > mtile::SMEM_MAX ? -1 : (int)b;
}

extern "C" int maxsim_v2_blocks_per_sm(int bf16, int fused, int smem_bytes, int* blocks) {
  return mtile::blocks_per_sm_of<mtile::LENS>(bf16, fused, smem_bytes, blocks);
}
