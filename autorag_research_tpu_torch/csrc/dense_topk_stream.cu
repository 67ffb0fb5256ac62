// dense_topk_stream: tiled exact dense scoring with a streaming top-k.
//
// Replaces autorag_research_tpu/ops/dense.py::_dense_topk_kernel (Pallas,
// wrapper dense_topk_pallas). For queries q [Q, d] and a corpus c [N, d]
// (both f32, or both bf16) each block owns a 64-query tile and one contiguous
// part of the corpus rows, scores it tile by tile and keeps, per query row,
// the k best (score, id) pairs of its part in (-score, id) order. Blocks run
// in parallel, so the output is P partial lists per row, [Q, P, k], which the
// wrapper merges with merge_topk (exactly as the JAX package merges per-group
// lists of its packed BM25 kernel).
//
// Arithmetic: f32 inputs are scored in true f32 on the CUDA cores (FFMA; no
// TF32, no tensor cores), as the exact paths require. bf16 inputs use
// mma.sync m16n8k16 with f32 accumulation.
//
// Bound on this card: at Q = 2048, N = 500,000, d = 768 in f32 the work is
// 1.57e12 FLOP, 23 ms at the 67 TFLOP/s FP32 rate, against 1.5 GB of corpus
// reads (0.46 ms), so it is bound by FP32 operations.
//
// Design: 256 threads score a 64 x 64 tile (f32: 4 x 4 outputs a thread from
// k chunks of 16 staged transposed in shared memory; bf16: 8 warps of
// 16 x 32 mma tiles), park it in shared memory, and then each warp maintains
// the lists of 8 rows. A row's list holds k sorted entries, in dynamic
// shared memory up to k = KSMEM = 256 (64 * k * 8 bytes per block) and in
// place in the output beyond (global memory, L2-cached; a template parameter,
// so the shared-memory kernel keeps its registers), so any k is served; its
// k-th score lives in a register. A ballot finds the tile's columns that
// beat the row's k-th score; when there are none (the usual case once the
// list is warm) the row costs one ballot, which is the merge skip of the
// Pallas kernel. Each winner is placed by list_insert (common.cuh, shared with
// the MaxSim kernels): a ballot-count rank over the list and a warp-wide shift
// of the entries below it, 32 at a time. Corpus rows increase along a block's
// walk, so an equal score never outranks an entry already held and ties
// resolve to the lower id.

#include "common.cuh"

namespace {

constexpr int BQ = 64;
constexpr int BN = 64;
constexpr int THREADS = 256;
constexpr int LDT = BN + 1;  // score tile row stride
constexpr int KSMEM = 256;  // list entries per row held in shared memory

// ---- f32 tile: C-core FFMA, 4 x 4 outputs per thread
constexpr int BK32 = 16;
constexpr int LDF = 64 + 4;  // transposed operand row stride (floats)

struct SmemF32 {
  __align__(16) float A[BK32 * LDF];
  __align__(16) float B[BK32 * LDF];
};

__device__ __forceinline__ void load_tile_f32_t(float* s, const float* g, int row0, int row_lim,
                                                int k0, int d, int tid) {
  // 64 rows x 16 k = 256 float4, one per thread, stored transposed s[k][row]
  const int r = tid >> 2, kc = (tid & 3) * 4;
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (row0 + r < row_lim && k0 + kc < d) {
    v = *reinterpret_cast<const float4*>(g + (size_t)(row0 + r) * d + k0 + kc);
  }
  s[(kc + 0) * LDF + r] = v.x;
  s[(kc + 1) * LDF + r] = v.y;
  s[(kc + 2) * LDF + r] = v.z;
  s[(kc + 3) * LDF + r] = v.w;
}

__device__ __forceinline__ void score_tile(const float* q, const float* c, SmemF32& sm,
                                           float* St, int q0, int Q, int c0, int c_lim, int d,
                                           int tid) {
  const int ty = tid >> 4, tx = tid & 15;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < d; k0 += BK32) {
    load_tile_f32_t(sm.A, q, q0, Q, k0, d, tid);
    load_tile_f32_t(sm.B, c, c0, c_lim, k0, d, tid);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK32; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(sm.A + kk * LDF + ty * 4);
      const float4 b = *reinterpret_cast<const float4*>(sm.B + kk * LDF + tx * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) St[(ty * 4 + i) * LDT + tx * 4 + j] = acc[i][j];
}

// ---- bf16 tile: mma.sync, 8 warps of 16 x 32
constexpr int BK16 = 32;
constexpr int LDH = BK16 + 8;

struct SmemBF16 {
  __align__(16) __nv_bfloat16 A[BQ * LDH];
  __align__(16) __nv_bfloat16 B[BN * LDH];
};

__device__ __forceinline__ void score_tile(const __nv_bfloat16* q, const __nv_bfloat16* c,
                                           SmemBF16& sm, float* St, int q0, int Q, int c0,
                                           int c_lim, int d, int tid) {
  const int lane = tid & 31, warp = tid >> 5;
  const int warp_m = warp & 3, warp_n = warp >> 2;
  float acc[4][4];
#pragma unroll
  for (int ni = 0; ni < 4; ++ni)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[ni][e] = 0.f;
  for (int k0 = 0; k0 < d; k0 += BK16) {
    load_tile_bf16<BQ, BK16 / 8, THREADS>(sm.A, LDH, q, q0, Q, k0, d, tid);
    load_tile_bf16<BN, BK16 / 8, THREADS>(sm.B, LDH, c, c0, c_lim, k0, d, tid);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK16; kk += 16) {
      uint32_t a[4];
      load_a_frag(a, sm.A, LDH, warp_m * 16, kk, lane);
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        uint32_t b[2];
        load_b_frag(b, sm.B, LDH, warp_n * 32 + ni * 8, kk, lane);
        mma_bf16_16816(acc[ni], a, b);
      }
    }
    __syncthreads();
  }
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    const int col = warp_n * 32 + ni * 8 + 2 * t;
    const int row = warp_m * 16 + g;
    St[row * LDT + col] = acc[ni][0];
    St[row * LDT + col + 1] = acc[ni][1];
    St[(row + 8) * LDT + col] = acc[ni][2];
    St[(row + 8) * LDT + col + 1] = acc[ni][3];
  }
}

// GLOBAL: the lists live in place in the output (k > KSMEM); rows past Q
// have no list there and take no candidate.
template <typename T, typename Smem, bool GLOBAL>
__global__ void __launch_bounds__(THREADS)
dense_topk_stream_kernel(const T* __restrict__ q, const T* __restrict__ c,
                         float* __restrict__ out_s, int* __restrict__ out_i, int Q, int N,
                         int d, int k, int part_rows, int parts, int q_tiles) {
  __shared__ Smem sm;
  __shared__ float St[BQ * LDT];
  extern __shared__ __align__(16) unsigned char list_mem[];
  float* Ls = reinterpret_cast<float*>(list_mem);                  // [BQ, k]
  int* Li = reinterpret_cast<int*>(list_mem + sizeof(float) * BQ * k);  // [BQ, k]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int qt = blockIdx.x % q_tiles;
  const int p = blockIdx.x / q_tiles;
  const int q0 = qt * BQ;
  const int row_begin = p * part_rows;
  const int row_end = min(N, row_begin + part_rows);
  const unsigned full = 0xffffffffu;

  if (GLOBAL) {
    for (int r = 0; r < 8; ++r) {
      const int row = warp * 8 + r;
      if (q0 + row >= Q) continue;  // warp-uniform
      const size_t o = ((size_t)(q0 + row) * parts + p) * k;
      for (int i = lane; i < k; i += 32) {
        out_s[o + i] = -INFINITY;
        out_i[o + i] = ARTPU_INT_MAX;
      }
    }
  } else {
    for (int i = tid; i < BQ * k; i += THREADS) {
      Ls[i] = -INFINITY;
      Li[i] = ARTPU_INT_MAX;
    }
  }
  __syncthreads();
  // k-th score of each of the warp's 8 rows, the same in every lane
  float kth[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) kth[r] = -INFINITY;

  for (int base = row_begin; base < row_end; base += BN) {
    score_tile(q, c, sm, St, q0, Q, base, row_end, d, tid);
    __syncthreads();
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int row = warp * 8 + r;
      float* ls = GLOBAL ? out_s + ((size_t)(q0 + row) * parts + p) * k : Ls + row * k;
      int* li = GLOBAL ? out_i + ((size_t)(q0 + row) * parts + p) * k : Li + row * k;
      const bool live = !GLOBAL || q0 + row < Q;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = h * 32 + lane;
        const float s = St[row * LDT + col];
        unsigned want = __ballot_sync(full, live && base + col < row_end && s > kth[r]);
        while (want) {
          const int src = __ffs(want) - 1;
          want &= want - 1;
          const float cs = __shfl_sync(full, s, src);
          if (cs > kth[r]) {
            list_insert(ls, li, k, cs, base + h * 32 + src, lane);
            kth[r] = ls[k - 1];
          }
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int row = warp * 8 + r;
    if (q0 + row < Q) {
      const size_t o = ((size_t)(q0 + row) * parts + p) * k;
      for (int i = lane; i < k; i += 32) {
        const float v = GLOBAL ? out_s[o + i] : Ls[row * k + i];
        out_s[o + i] = v == -INFINITY ? ARTPU_NEG_INF : v;
        if (!GLOBAL) out_i[o + i] = Li[row * k + i];
      }
    }
  }
}

template <typename T, typename Smem>
int launch(const void* q, const void* c, void* out_s, void* out_i, int Q, int N, int d, int k,
           int part_rows, int parts, void* stream) {
  if (Q == 0 || parts == 0) return 0;
  if (k < 1 || d < 8 || d % 8) return (int)cudaErrorInvalidValue;
  const int q_tiles = (Q + BQ - 1) / BQ;
  const long long blocks = (long long)q_tiles * parts;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
  const bool global = k > KSMEM;
  const int list_bytes = global ? 0 : BQ * k * (int)(sizeof(float) + sizeof(int));
  auto kernel = global ? dense_topk_stream_kernel<T, Smem, true>
                       : dense_topk_stream_kernel<T, Smem, false>;
  if (list_bytes > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, list_bytes);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<(unsigned)blocks, THREADS, list_bytes, (cudaStream_t)stream>>>(
      (const T*)q, (const T*)c, (float*)out_s, (int*)out_i, Q, N, d, k, part_rows, parts,
      q_tiles);
  return (int)cudaGetLastError();
}

}  // namespace

// q [Q, d], c [N, d] row-major (d % 8 == 0, 16-byte aligned); outputs
// [Q, parts, k], any k >= 1, with part p covering rows [p*part_rows,
// (p+1)*part_rows).
// Returns cudaGetLastError().
extern "C" int dense_topk_stream_f32_launch(const void* q, const void* c, void* out_s,
                                            void* out_i, int Q, int N, int d, int k,
                                            int part_rows, int parts, void* stream) {
  return launch<float, SmemF32>(q, c, out_s, out_i, Q, N, d, k, part_rows, parts, stream);
}

extern "C" int dense_topk_stream_bf16_launch(const void* q, const void* c, void* out_s,
                                             void* out_i, int Q, int N, int d, int k,
                                             int part_rows, int parts, void* stream) {
  return launch<__nv_bfloat16, SmemBF16>(q, c, out_s, out_i, Q, N, d, k, part_rows, parts,
                                         stream);
}
