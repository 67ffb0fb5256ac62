// maxsim_v3: fused MaxSim top-k with the document-token mask folded into the
// product through a bias lane.
//
// Replaces autorag_research_tpu/ops/maxsim.py::_maxsim_kernel_v3 (Pallas;
// wrapper maxsim_topk_pallas_v3, reached by the "pallas_v3" method pin). The
// wrapper writes lane d of both padded operands: a document token carries 0
// (real) or -1e30 (pad), and every query row carries 1, pad rows included.
// The product then arrives masked: a pad token's product is about -1e30, a
// real token's is exact, and the kernel reads no lengths (LANE policy of
// maxsim_kernel.cuh):
//
//   score(b, n) = sum_{t < Tq_pad} max_{s < Td} q'[b, t] . doc'[n, s]
//
// -1e30 stays finite in bf16 (NEG_INF would round to -inf there), and
// Tq_pad x -1e30 stays finite in f32. On the TPU the bias lane cost a whole
// 128-lane block at d = 128; here it costs the 8 lanes of the next multiple
// of 8 (d 128 -> 136). An empty document sums to Tq_pad x -1e30, below every
// real score and above the pad rows; the wrapper resets it to NEG_INF with
// its row after selection, which keeps the order and gives the ranking of
// the other routes.
//
// Bound on this card: the one of maxsim_v1.cu and maxsim_v2.cu (valid tokens
// over d lanes, chip_smoke.py's mv_bound): at the text scale (f32) 50.7 ms,
// bound by operations. v3 does more work than the bound counts: all Td
// tokens over d + 8 lanes, 4.6e12 FLOP at the text scale.

#include "maxsim_kernel.cuh"

MAXSIM_LAUNCHER(maxsim_topk_v3_f32_launch, TileF32, maxsim::LANE)
MAXSIM_LAUNCHER(maxsim_topk_v3_bf16_launch, TileBF16, maxsim::LANE)
