// maxsim_v1: fused MaxSim top-k with an additive document-token bias.
//
// Replaces autorag_research_tpu/ops/maxsim.py::_maxsim_kernel (Pallas, the
// v1 kernel; wrapper maxsim_topk_pallas, reached by the "pallas" method pin).
// The TPU kernel multiplies token-flattened [BQ*Tq, d] x [BN*Td, d] tiles,
// adds a [BN, Td] f32 bias (0 for real tokens, NEG_INF for pads) before the
// per-token max and sums each query's rows with a 0/1 grouping matmul. Here
// the tile body of maxsim_kernel.cuh runs with the BIAS policy:
//
//   score(b, n) = sum_{t < Tq_pad} max_{s < Td} (q[b, t] . doc[n, s] + bias[n, s])
//
// The kernel reads the bias (aux, [N, Td] f32, built per call by the
// wrapper) where v2 reads lengths, and walks all Td tokens of every document.
// Pad query rows are zero, so they add max_s bias = 0 to a document with a
// real token. The grouping matmul becomes a plain f32 sum in token order.
// An empty document's rows are all NEG_INF and their sum overflows to -inf;
// the kernel lists it at NEG_INF with its row, the convention of every port
// route (the TPU kernel drops it from its top-k).
//
// Bound on this card: the one of maxsim_v2.cu, as chip_smoke.py's mv_bound
// computes it over the valid query and document tokens (the work the
// function needs): at the text scale (f32) 50.7 ms, bound by operations.
// v1 cannot skip a pad token (its bias says which count), so it does more
// work than the bound counts: all Td tokens, 4.3e12 FLOP at the text scale.

#include "maxsim_kernel.cuh"

MAXSIM_LAUNCHER(maxsim_topk_v1_f32_launch, TileF32, maxsim::BIAS)
MAXSIM_LAUNCHER(maxsim_topk_v1_bf16_launch, TileBF16, maxsim::BIAS)
