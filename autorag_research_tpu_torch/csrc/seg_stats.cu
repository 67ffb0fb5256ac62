// seg_stats_bf16: fused bf16 prescreen matmul + per-segment statistics.
//
// Replaces autorag_research_tpu/ops/dense.py::_seg_stats_kernel (Pallas,
// wrapper _seg_stats_pallas). For queries q [Q, d] and a prescreen corpus
// c [N, d], both bf16, it computes the f32-accumulated scores q @ c^T and,
// for every 128-doc segment s and query row i:
//   max1[i, s] = max of the segment's scores,
//   loc1[i, s] = the lowest lane (0..127) holding that max,
//   max2[i, s] = max over the segment's other lanes (= max1 on an exact tie),
// with every column >= n (a run-time count) masked to NEG_INF. The [Q, N]
// score matrix never reaches device memory: only [Q, S] x 3 is written.
//
// Bound on this card: at Q = 1024, N = 501,760, d = 768 the work is
// 7.9e11 bf16 FLOP (0.8 ms at 989 TFLOP/s) against 0.77 GB of corpus reads
// (0.23 ms at 3.35 TB/s), so it is bound by tensor-core operations.
//
// Design: one block per (128-query tile, 128-doc segment), query tiles
// fastest in the 1-D grid so the blocks sharing a corpus segment run
// together and read it from L2. Eight warps run mma.sync m16n8k16 bf16 -> f32
// over k chunks of 64 staged in padded shared tiles; each warp owns a 32 x 64
// sub-tile. The epilogue works on the accumulator registers: each thread
// reduces its 16 columns of a row in increasing column order, the four
// threads of a quad merge by shuffles, and the two column halves merge
// through shared memory. This is the simple correct form: wgmma, TMA and a
// pipelined persistent grid are later work.

#include "common.cuh"

namespace {

constexpr int BQ = 128;
constexpr int SEG = 128;
constexpr int BK = 64;
constexpr int LDS = BK + 8;  // padded row stride (elements): conflict-free fragments
constexpr int THREADS = 256;

struct Top2 {
  float m1;
  int l1;
  float m2;
};

// Merge another (max, argmax, runner-up) triple into t; on an exact tie the
// lower lane wins, and the loser's max becomes the runner-up.
__device__ __forceinline__ void merge(Top2& t, float om1, int ol1, float om2) {
  if (om1 > t.m1 || (om1 == t.m1 && ol1 < t.l1)) {
    t.m2 = fmaxf(t.m1, om2);
    t.m1 = om1;
    t.l1 = ol1;
  } else {
    t.m2 = fmaxf(t.m2, om1);
  }
}

__global__ void __launch_bounds__(THREADS)
seg_stats_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ c,
                 float* __restrict__ max1, int* __restrict__ loc1, float* __restrict__ max2,
                 int Q, int N, int d, int n, int S, int q_tiles) {
  __shared__ __align__(16) __nv_bfloat16 As[BQ * LDS];
  __shared__ __align__(16) __nv_bfloat16 Bs[SEG * LDS];
  __shared__ float red_m1[2][BQ];
  __shared__ int red_l1[2][BQ];
  __shared__ float red_m2[2][BQ];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int qt = blockIdx.x % q_tiles;
  const int seg = blockIdx.x / q_tiles;
  const int q0 = qt * BQ, c0 = seg * SEG;
  const int warp_m = warp & 3, warp_n = warp >> 2;  // 4 x 2 warps of 32 x 64

  float acc[2][8][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  for (int k0 = 0; k0 < d; k0 += BK) {
    load_tile_bf16<BQ, BK / 8, THREADS>(As, LDS, q, q0, Q, k0, d, tid);
    load_tile_bf16<SEG, BK / 8, THREADS>(Bs, LDS, c, c0, N, k0, d, tid);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t a[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) load_a_frag(a[mi], As, LDS, warp_m * 32 + mi * 16, kk, lane);
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        uint32_t b[2];
        load_b_frag(b, Bs, LDS, warp_n * 64 + ni * 8, kk, lane);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) mma_bf16_16816(acc[mi][ni], a[mi], b);
      }
    }
    __syncthreads();
  }

  // ---- epilogue: per-row (max1, loc1, max2) over the segment's 128 lanes
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      Top2 r{-INFINITY, ARTPU_INT_MAX, -INFINITY};
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int lane_col = warp_n * 64 + ni * 8 + 2 * t + e;
          float v = acc[mi][ni][2 * h + e];
          if (c0 + lane_col >= n) v = ARTPU_NEG_INF;
          // columns arrive in increasing order: a tie keeps the earlier lane
          if (v > r.m1) {
            r.m2 = r.m1;
            r.m1 = v;
            r.l1 = lane_col;
          } else {
            r.m2 = fmaxf(r.m2, v);
          }
        }
      }
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        const float om1 = __shfl_xor_sync(0xffffffffu, r.m1, off);
        const int ol1 = __shfl_xor_sync(0xffffffffu, r.l1, off);
        const float om2 = __shfl_xor_sync(0xffffffffu, r.m2, off);
        merge(r, om1, ol1, om2);
      }
      if (t == 0) {
        const int row = warp_m * 32 + mi * 16 + h * 8 + g;
        red_m1[warp_n][row] = r.m1;
        red_l1[warp_n][row] = r.l1;
        red_m2[warp_n][row] = r.m2;
      }
    }
  }
  __syncthreads();
  if (tid < BQ && q0 + tid < Q) {
    Top2 r{red_m1[0][tid], red_l1[0][tid], red_m2[0][tid]};
    merge(r, red_m1[1][tid], red_l1[1][tid], red_m2[1][tid]);
    const size_t o = (size_t)(q0 + tid) * S + seg;
    max1[o] = r.m1;
    loc1[o] = r.l1;
    max2[o] = r.m2;
  }
}

}  // namespace

// q [Q, d] and c [N, d] bf16 row-major (d % 8 == 0, 16-byte aligned);
// outputs [Q, S] with S = ceil(N / 128). Returns cudaGetLastError().
extern "C" int seg_stats_bf16_launch(const void* q, const void* c, void* max1, void* loc1,
                                     void* max2, int Q, int N, int d, int n, int S,
                                     void* stream) {
  if (Q == 0 || S == 0) return 0;
  const int q_tiles = (Q + BQ - 1) / BQ;
  const long long blocks = (long long)q_tiles * S;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
  seg_stats_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)c, (float*)max1, (int*)loc1,
      (float*)max2, Q, N, d, n, S, q_tiles);
  return (int)cudaGetLastError();
}
