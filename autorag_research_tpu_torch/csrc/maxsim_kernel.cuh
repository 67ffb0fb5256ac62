// The MaxSim tile body and kernel shared by maxsim_v1.cu and maxsim_v3.cu
// (the pins; maxsim_v2.cu runs maxsim_tile.cuh). The two differ only in how
// document tokens past a document's length are kept out of the per-token max
// (the Mask policy):
//
//   BIAS (v1): the kernel walks all Td tokens and adds a [N, Td] f32 bias (0
//              or NEG_INF) to each product before the max;
//   LANE (v3): it walks all Td tokens; the mask arrives inside the product,
//              through a bias lane the wrapper wrote into both operands.
//
//   score(b, n) = sum_{t < Tq_pad} max_{s < Td} (q[b, t] . doc[n, s] (+ bias[n, s]))
//
// Inputs: q [QB, RT*ROWS, d], the wrapper's packing of BQ queries x Tq_pad
// tokens per block of query rows (one ROWS-row tile, or RT tiles of one long
// query); docs [N, Td, d] row-major and read in place. The epilogue writes
// per-part lists [B, P, k] in (-score, row) order, merged by the wrapper with
// merge_topk.
//
// Arithmetic: f32 inputs run FFMA on the CUDA cores (no TF32, the
// Precision.HIGHEST counterpart); bf16 inputs run mma.sync m16n8k16 with f32
// accumulators (exact products, f32 sums). Each query's Tq_pad row maxima are
// summed in f32 in increasing token order.
//
// Design: a block owns one block of query rows and one contiguous part of
// the documents, and walks its part 32 documents per step. For each document
// it computes 128 query-token rows x 64 document tokens product tiles over
// the Td tokens (f32: 8 x 4 outputs a thread from k chunks of 16 staged
// transposed in shared memory; bf16: 8 warps of 16 x 64 mma tiles) and keeps
// a running max per row in registers; a shuffle reduction leaves each row's
// max in shared memory. After the step's 32 documents one thread per (query,
// document) adds the query's row maxima in order. The epilogue then
// offers the 32 scores of each query row to its k-best list (list_insert,
// common.cuh), one document per lane: a ballot finds the scores above the
// list's k-th, so a warm list costs one ballot per row and step. Lists of up
// to KSMEM entries live in shared memory; longer ones live in place in the
// output (global memory, L2-cached), so any k is served. Documents increase
// along a block's walk, so ties resolve to the lower row. Operands are staged
// with synchronous loads: wgmma, TMA and a persistent grid are later work.
#pragma once

#include "common.cuh"

namespace maxsim {

constexpr int ROWS = 128;         // query-token rows of a product tile
constexpr int TOK = 64;           // document tokens of a product tile
constexpr int DOCS = 32;          // documents per step, one per lane of a list update
constexpr int THREADS = 256;
constexpr int BQ_MAX = ROWS / 8;  // queries of a block (Tq_pad >= 8)
constexpr int KSMEM = 256;        // list entries per query held in shared memory
constexpr int LDR = DOCS + 1;     // row-maxima stride

enum Mask { BIAS = 1, LANE = 2 };

// ---- f32 tile: CUDA-core FFMA, 8 rows x 4 tokens per thread
constexpr int BK32 = 16;
constexpr int LDA32 = ROWS + 4;  // transposed operand strides (floats)
constexpr int LDB32 = TOK + 4;

struct TileF32 {
  using T = float;
  struct Smem {
    __align__(16) float A[BK32 * LDA32];
    __align__(16) float B[BK32 * LDB32];
  };

  // Max over the first `len` tokens of `doc` of each of the ROWS rows of q,
  // plus brow[token] when HAS_BIAS, written to rm[row * LDR]; -inf when
  // len == 0. Called by the whole block.
  template <bool HAS_BIAS>
  static __device__ __forceinline__ void rowmax(const float* q, const float* doc, int len,
                                                const float* brow, int d, Smem& sm, float* rm,
                                                int tid) {
    const int ty = tid >> 4, tx = tid & 15;
    float mx[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) mx[i] = -INFINITY;
    for (int t0 = 0; t0 < len; t0 += TOK) {
      float acc[8][4];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      for (int k0 = 0; k0 < d; k0 += BK32) {
        // query rows: 128 x 16 = 512 float4, two per thread, stored transposed
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int v = tid + i * THREADS;
          const int r = v >> 2, kc = (v & 3) * 4;
          float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
          if (k0 + kc < d) a = *reinterpret_cast<const float4*>(q + (size_t)r * d + k0 + kc);
          sm.A[(kc + 0) * LDA32 + r] = a.x;
          sm.A[(kc + 1) * LDA32 + r] = a.y;
          sm.A[(kc + 2) * LDA32 + r] = a.z;
          sm.A[(kc + 3) * LDA32 + r] = a.w;
        }
        // document tokens: 64 x 16 = 256 float4, one per thread; past len zero
        {
          const int r = tid >> 2, kc = (tid & 3) * 4;
          float4 b = make_float4(0.f, 0.f, 0.f, 0.f);
          if (t0 + r < len && k0 + kc < d) {
            b = *reinterpret_cast<const float4*>(doc + (size_t)(t0 + r) * d + k0 + kc);
          }
          sm.B[(kc + 0) * LDB32 + r] = b.x;
          sm.B[(kc + 1) * LDB32 + r] = b.y;
          sm.B[(kc + 2) * LDB32 + r] = b.z;
          sm.B[(kc + 3) * LDB32 + r] = b.w;
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < BK32; ++kk) {
          const float4 a0 = *reinterpret_cast<const float4*>(sm.A + kk * LDA32 + ty * 8);
          const float4 a1 = *reinterpret_cast<const float4*>(sm.A + kk * LDA32 + ty * 8 + 4);
          const float4 b = *reinterpret_cast<const float4*>(sm.B + kk * LDB32 + tx * 4);
          const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
          const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
        }
        __syncthreads();
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = t0 + tx * 4 + j;
        if (col < len) {
          if (HAS_BIAS) {
            const float bj = brow[col];
#pragma unroll
            for (int i = 0; i < 8; ++i) mx[i] = fmaxf(mx[i], acc[i][j] + bj);
          } else {
#pragma unroll
            for (int i = 0; i < 8; ++i) mx[i] = fmaxf(mx[i], acc[i][j]);
          }
        }
      }
    }
    // rows ty*8 + i are shared by the 16 lanes tx of a half-warp
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], off));
      }
    }
    if (tx == 0) {
#pragma unroll
      for (int i = 0; i < 8; ++i) rm[(ty * 8 + i) * LDR] = mx[i];
    }
  }
};

// ---- bf16 tile: mma.sync, 8 warps of 16 rows x 64 tokens
constexpr int BK16 = 32;
constexpr int LDH = BK16 + 8;

struct TileBF16 {
  using T = __nv_bfloat16;
  struct Smem {
    __align__(16) __nv_bfloat16 A[ROWS * LDH];
    __align__(16) __nv_bfloat16 B[TOK * LDH];
  };

  template <bool HAS_BIAS>
  static __device__ __forceinline__ void rowmax(const __nv_bfloat16* q,
                                                const __nv_bfloat16* doc, int len,
                                                const float* brow, int d, Smem& sm, float* rm,
                                                int tid) {
    const int lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, t = lane & 3;
    float mx0 = -INFINITY, mx1 = -INFINITY;  // rows warp*16 + g and + g + 8
    for (int t0 = 0; t0 < len; t0 += TOK) {
      float acc[8][4];
#pragma unroll
      for (int ni = 0; ni < 8; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[ni][e] = 0.f;
      for (int k0 = 0; k0 < d; k0 += BK16) {
        load_tile_bf16<ROWS, BK16 / 8, THREADS>(sm.A, LDH, q, 0, ROWS, k0, d, tid);
        load_tile_bf16<TOK, BK16 / 8, THREADS>(sm.B, LDH, doc, t0, len, k0, d, tid);
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < BK16; kk += 16) {
          uint32_t a[4];
          load_a_frag(a, sm.A, LDH, warp * 16, kk, lane);
#pragma unroll
          for (int ni = 0; ni < 8; ++ni) {
            uint32_t b[2];
            load_b_frag(b, sm.B, LDH, ni * 8, kk, lane);
            mma_bf16_16816(acc[ni], a, b);
          }
        }
        __syncthreads();
      }
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        const int col = t0 + ni * 8 + 2 * t;
        if (col < len) {
          const float b0 = HAS_BIAS ? brow[col] : 0.f;
          mx0 = fmaxf(mx0, HAS_BIAS ? acc[ni][0] + b0 : acc[ni][0]);
          mx1 = fmaxf(mx1, HAS_BIAS ? acc[ni][2] + b0 : acc[ni][2]);
        }
        if (col + 1 < len) {
          const float b1 = HAS_BIAS ? brow[col + 1] : 0.f;
          mx0 = fmaxf(mx0, HAS_BIAS ? acc[ni][1] + b1 : acc[ni][1]);
          mx1 = fmaxf(mx1, HAS_BIAS ? acc[ni][3] + b1 : acc[ni][3]);
        }
      }
    }
    // a row's columns are spread over the 4 lanes t of its group
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    if (t == 0) {
      rm[(warp * 16 + g) * LDR] = mx0;
      rm[(warp * 16 + g + 8) * LDR] = mx1;
    }
  }
};

// aux: f32 bias [N, Td] (BIAS), unused (LANE).
template <typename Tile, int MASK>
__global__ void __launch_bounds__(THREADS, 2)
maxsim_kernel(const typename Tile::T* __restrict__ q, const typename Tile::T* __restrict__ docs,
              const void* __restrict__ aux, float* __restrict__ out_s, int* __restrict__ out_i,
              int B, int N, int Td, int d, int tq_pad, int bq, int rt_count, int k,
              int part_docs, int parts, int q_blocks, int list_smem) {
  using T = typename Tile::T;
  __shared__ typename Tile::Smem sm;
  __shared__ float rm[ROWS * LDR];      // row maxima of the current row tile, per document
  __shared__ float ps[BQ_MAX * DOCS];   // per (query, document) sums
  extern __shared__ __align__(16) unsigned char list_mem[];
  const int list_n = list_smem ? bq * k : 0;
  float* Ls = reinterpret_cast<float*>(list_mem);  // [bq, k] when in shared memory
  int* Li = reinterpret_cast<int*>(Ls + list_n);   // [bq, k]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int qb = blockIdx.x % q_blocks;
  const int p = blockIdx.x / q_blocks;
  const int b0 = qb * bq;
  const int doc_begin = p * part_docs;
  const int doc_end = min(N, doc_begin + part_docs);
  const T* qblk = q + (size_t)qb * rt_count * ROWS * d;
  const float* bias = static_cast<const float*>(aux);
  const unsigned full = 0xffffffffu;
  // query qi's list: shared memory, or its own slice of the output
  auto list_s = [&](int qi) {
    return list_smem ? Ls + qi * k : out_s + ((size_t)(b0 + qi) * parts + p) * k;
  };
  auto list_i = [&](int qi) {
    return list_smem ? Li + qi * k : out_i + ((size_t)(b0 + qi) * parts + p) * k;
  };

  for (int qi = warp; qi < bq; qi += THREADS / 32) {
    if (b0 + qi >= B) continue;  // warp-uniform
    float* ls = list_s(qi);
    int* li = list_i(qi);
    for (int i = lane; i < k; i += 32) {
      ls[i] = -INFINITY;
      li[i] = ARTPU_INT_MAX;
    }
  }

  for (int base = doc_begin; base < doc_end; base += DOCS) {
    const int nd = min(DOCS, doc_end - base);
    for (int i = tid; i < BQ_MAX * DOCS; i += THREADS) ps[i] = 0.f;
    __syncthreads();
    for (int rt = 0; rt < rt_count; ++rt) {
      const T* qt = qblk + (size_t)rt * ROWS * d;
      for (int j = 0; j < nd; ++j) {
        const T* doc = docs + (size_t)(base + j) * Td * d;
        Tile::template rowmax<MASK == BIAS>(
            qt, doc, Td, MASK == BIAS ? bias + (size_t)(base + j) * Td : nullptr, d, sm,
            rm + j, tid);
      }
      __syncthreads();
      // add this tile's rows of each query, in increasing token order
      for (int pr = tid; pr < bq * nd; pr += THREADS) {
        const int qi = pr / nd, j = pr - qi * nd;
        const int lo = max(0, qi * tq_pad - rt * ROWS);
        const int hi = min(ROWS, (qi + 1) * tq_pad - rt * ROWS);
        float s = ps[qi * DOCS + j];
        for (int r = lo; r < hi; ++r) s += rm[r * LDR + j];
        ps[qi * DOCS + j] = s;
      }
      __syncthreads();
    }
    for (int qi = warp; qi < bq; qi += THREADS / 32) {
      if (b0 + qi >= B) continue;  // warp-uniform
      float* ls = list_s(qi);
      int* li = list_i(qi);
      float s = -INFINITY;
      if (lane < nd) {
        s = ps[qi * DOCS + lane];
        // BIAS: an empty document's sum of NEG_INF row maxima overflows to
        // -inf and becomes NEG_INF; LANE: the wrapper resets empty documents
        // after selection
        if (MASK == BIAS) s = fmaxf(s, ARTPU_NEG_INF);
      }
      float kth = ls[k - 1];
      unsigned want = __ballot_sync(full, s > kth);
      while (want) {
        const int src = __ffs(want) - 1;
        want &= want - 1;
        const float cs = __shfl_sync(full, s, src);
        if (cs > kth) {
          list_insert(ls, li, k, cs, base + src, lane);
          kth = ls[k - 1];
        }
      }
    }
    __syncthreads();
  }

  for (int qi = warp; qi < bq; qi += THREADS / 32) {
    if (b0 + qi >= B) continue;
    const float* ls = list_s(qi);
    const int* li = list_i(qi);
    const size_t o = ((size_t)(b0 + qi) * parts + p) * k;
    for (int i = lane; i < k; i += 32) {
      const float v = ls[i];
      const int id = li[i];
      out_s[o + i] = v == -INFINITY ? ARTPU_NEG_INF : v;
      out_i[o + i] = id;
    }
  }
}

template <typename Tile, int MASK>
int launch(const void* q, const void* docs, const void* aux, void* out_s, void* out_i, int B,
           int N, int Td, int d, int tq_pad, int bq, int rt_count, int k, int part_docs,
           int parts, int q_blocks, void* stream) {
  if (B == 0 || N == 0 || parts == 0) return 0;
  if (bq < 1 || bq > BQ_MAX || rt_count < 1 || d < 8 || d % 8 || tq_pad % 8 ||
      bq * tq_pad > rt_count * ROWS || (long long)q_blocks * bq < B ||
      (long long)parts * part_docs < N || part_docs % DOCS || Td < 1 || k < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const long long blocks = (long long)q_blocks * parts;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
  const int list_smem = k <= KSMEM;
  const int list_bytes = list_smem ? bq * k * (int)(sizeof(float) + sizeof(int)) : 0;
  auto kernel = maxsim_kernel<Tile, MASK>;
  if (list_bytes > 0) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, list_bytes);
    if (e != cudaSuccess) return (int)e;
  }
  using T = typename Tile::T;
  kernel<<<(unsigned)blocks, THREADS, list_bytes, (cudaStream_t)stream>>>(
      (const T*)q, (const T*)docs, aux, (float*)out_s, (int*)out_i, B, N, Td, d, tq_pad, bq,
      rt_count, k, part_docs, parts, q_blocks, list_smem);
  return (int)cudaGetLastError();
}

}  // namespace maxsim

// q [q_blocks, rt_count*128, d] packed query-token rows (bq queries of tq_pad
// rows each per block, zero-padded); docs [N, Td, d]; aux as the kernel's
// Mask reads it; d % 8 == 0, 16-byte aligned. out_s / out_i [B, parts, k]
// with part p covering documents [p*part_docs, (p+1)*part_docs), any k >= 1.
// Each returns cudaGetLastError().
#define MAXSIM_LAUNCHER(name, Tile, MASK)                                             \
  extern "C" int name(const void* q, const void* docs, const void* aux, void* out_s,        \
                      void* out_i, int B, int N, int Td, int d, int tq_pad, int bq,          \
                      int rt_count, int k, int part_docs, int parts, int q_blocks,           \
                      void* stream) {                                                         \
    return maxsim::launch<maxsim::Tile, MASK>(q, docs, aux, out_s, out_i, B, N, Td,         \
                                                     d, tq_pad, bq, rt_count, k, part_docs,  \
                                                     parts, q_blocks, stream);               \
  }
