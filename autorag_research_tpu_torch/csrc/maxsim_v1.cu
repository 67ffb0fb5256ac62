// maxsim_v1: fused MaxSim top-k with an additive document-token bias.
//
// Replaces autorag_research_tpu/ops/maxsim.py::_maxsim_kernel (Pallas, line
// 125; wrapper maxsim_topk_pallas, reached by the "pallas" method pin). The
// TPU kernel multiplies token-flattened [BQ*Tq, d] x [BN*Td, d] tiles, adds a
// [BN, Td] f32 bias (0 for real tokens, NEG_INF for pads) before the
// per-token max and sums each query's rows with a 0/1 grouping matmul. Here
// the tile body maxsim_tile.cuh runs with its BIAS policy:
//
//   score(b, n) = sum_{t < rows_b} max_{s < Td} (q[b, t] . doc[n, s] + bias[n, s])
//
// The kernel reads the bias (aux, [N, Td] f32, built per call by the
// wrapper) where v2 reads lengths, and walks all Td tokens of every document
// in chunks of 16, the last chunk's positions past Td masked. The plan packs
// each query's own rows (one zero row for a query of length 0); the TPU
// kernel's pad rows add max_s (0 + bias) = 0 to a document with a real token,
// so leaving them out changes no bit. The grouping matmul becomes an f32 sum
// in token order. An empty document's rows are all NEG_INF and their sum
// overflows to -inf; the kernel clamps it to NEG_INF and lists it with its
// row, the convention of every port route (the TPU kernel drops it).
//
// Bound on this card: the one of maxsim_v2.cu, as chip_smoke.py's mv_bound
// computes it over the valid query and document tokens (the work the
// function needs): at the text scale (f32) 50.7 ms, bound by operations.
// v1 cannot skip a pad token (its bias says which count), so it does more
// work than the bound counts: all Td tokens, about 1.33x the valid ones at
// the main path's lengths. Its design answer is the tile body's (resident
// query rows, no pad rows, TMA-staged chunks, bf16 wgmma) with the bias
// loaded per chunk before the tile's products; the bias is 25.6 MB at the
// text scale, read once per row block.

#include "maxsim_tile.cuh"

MAXSIM_LAUNCHER(maxsim_topk_v1_f32_launch, F32, true, BIAS)
MAXSIM_LAUNCHER(maxsim_topk_v1_bf16_launch, BF16, true, BIAS)

extern "C" int maxsim_v1_blocks_per_sm(int bf16, int fused, int smem_bytes, int* blocks) {
  return mtile::blocks_per_sm_of<mtile::BIAS>(bf16, fused, smem_bytes, blocks);
}
