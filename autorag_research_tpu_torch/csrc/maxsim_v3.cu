// maxsim_v3: fused MaxSim top-k with the document-token mask folded into the
// product through a bias lane.
//
// Replaces autorag_research_tpu/ops/maxsim.py::_maxsim_kernel_v3 (Pallas,
// line 572; wrapper maxsim_topk_pallas_v3, reached by the "pallas_v3" method
// pin). The wrapper writes lane d of both padded operands: a document token
// carries 0 (real) or -1e30 (pad), and every query row carries 1, pad rows
// included. The product then arrives masked: a pad token's product is about
// -1e30, a real token's is exact, and the kernel reads no lengths. Here the
// tile body maxsim_tile.cuh runs with its LANE policy:
//
//   score(b, n) = sum_{t < rows_b} max_{s < Td} q'[b, t] . doc'[n, s]
//
// over all Td tokens of every document, the last chunk's positions past Td
// masked. The plan packs each query's own rows (one row for a query of
// length 0, lane d still 1); the TPU kernel's other pad rows add exactly 0
// to a document with a real token (the lane product is 0), so leaving them
// out changes no bit. -1e30 stays finite in bf16 (NEG_INF would round to
// -inf there), and rows x -1e30 stays finite in f32. On the TPU the bias
// lane cost a whole 128-lane block at d = 128; here it costs the 8 lanes of
// the next multiple of 8 (d 128 -> 136): the last k-box (the fifth in f32,
// the third in bf16) is staged whole, zero-filled by TMA past 136, but
// multiplied over its 8 live lanes only (two k-quads in f32, one k16 wgmma
// step in bf16). An empty document sums to rows x -1e30, below every real
// score; the wrapper resets it to NEG_INF with its row after selection,
// which keeps the order and gives the ranking of the other routes.
//
// Bound on this card: the one of maxsim_v1.cu and maxsim_v2.cu (valid tokens
// over d lanes, chip_smoke.py's mv_bound): at the text scale (f32) 50.7 ms,
// bound by operations. v3 does more work than the bound counts: all Td
// tokens over d + 8 lanes, about 1.41x the valid ones at the main path.

#include "maxsim_tile.cuh"

MAXSIM_LAUNCHER(maxsim_topk_v3_f32_launch, F32, true, LANE)
MAXSIM_LAUNCHER(maxsim_topk_v3_bf16_launch, BF16, true, LANE)

extern "C" int maxsim_v3_blocks_per_sm(int bf16, int fused, int smem_bytes, int* blocks) {
  return mtile::blocks_per_sm_of<mtile::LANE>(bf16, fused, smem_bytes, blocks);
}
