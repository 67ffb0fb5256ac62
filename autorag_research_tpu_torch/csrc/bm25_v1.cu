// bm25_v1: BM25 over the flat slot-padded layout with a fused streaming
// top-k, one (query, term) pair per step.
//
// Replaces autorag_research_tpu/ops/sparse.py::_bm25_kernel (Pallas, wrapper
// bm25_topk_pallas / _launch_bm25_pallas, block_n = 1024), the kernel that a
// SparseIndex search reaches only through the method="pallas" pin. It computes
// the function of bm25_v2.cu,
//
//   score(b, n) = sum over t = 0..T-1, in order, of
//                 (sum_l [doc_ids[n, l] == q_ids[b, t]] * doc_w[n, l]) * q_w[b, t]
//
// with each product and each add of the term sum rounded on its own
// (__fmul_rn / __fadd_rn). A row of unique terms holds at most one matching
// slot, so the slot sum is that one weight whatever its order (here a
// reduction across a warp's lanes): the results equal bm25_topk_v2's
// bitwise, and the plain PyTorch version's.
//
// v1's own structure, kept from the TPU kernel: a block owns a query tile of
// BQ = 8 queries and a part of the corpus, which it walks in tiles of TILE =
// 1,024 documents. For each tile the [BQ, TILE] scores live in shared memory;
// the loop runs over the (query, term) pairs in query-major order, and each
// step adds that one pair's contribution to its query's row for every
// document of the tile: warp w takes documents w, w + 8, ..., its lanes read
// a document's slots side by side (coalesced) and sum their matches with a
// butterfly. Pairs of pad terms add zero and are skipped. Then each warp
// offers its query row to its k-best list (list_insert, common.cuh), 32
// documents per ballot in increasing order, so ties go to the lower row.
// Lists of up to KSMEM entries live in shared memory, longer ones in place
// in the output, so any k is served. Outputs: per-part lists [B, parts, k]
// in (-score, row) order, merged by the wrapper.
//
// Bound on this card: as bm25_v2.cu's (2 operations per live query term and
// document at 33.5 TFLOP/s without FMA, or the slot arrays read once at
// 3.35 TB/s). What this design does instead: every step re-reads the tile's
// slots from L1 / L2, 8 T times per tile, and reduces each document across
// a warp; the TPU's v2 removed that cost by going term-major, as
// bm25_v2.cu does. The kernel stays as the reference's v1 pin, not as a
// route to tune.

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int BQ = THREADS / 32;  // queries of a block (and warps)
constexpr int TILE = 1024;        // documents per tile
constexpr int KSMEM = 1024;       // longest list kept in shared memory
constexpr int TMAX = 2048;        // query terms staged per query
constexpr int QUERY_PAD = -2;

__global__ void __launch_bounds__(THREADS)
bm25_v1_kernel(const int* __restrict__ q_ids, const float* __restrict__ q_w,
               const int* __restrict__ doc_ids, const float* __restrict__ doc_w,
               float* __restrict__ out_s, int* __restrict__ out_i, int B, int T, int N, int L,
               int k, int part, int parts, int q_tiles, int list_smem) {
  __shared__ float s_sc[BQ * TILE];
  extern __shared__ __align__(16) unsigned char dyn[];
  const int list_n = list_smem ? BQ * k : 0;
  float* Ls = reinterpret_cast<float*>(dyn);               // [BQ, k] when in shared memory
  int* Li = reinterpret_cast<int*>(Ls + list_n);           // [BQ, k]
  int* sq_id = Li + list_n;                                // [BQ, T]
  float* sq_w = reinterpret_cast<float*>(sq_id + BQ * T);  // [BQ, T]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int qt = blockIdx.x % q_tiles;
  const int p = blockIdx.x / q_tiles;
  const int b = qt * BQ + warp;
  const bool active = b < B;  // warp-uniform
  const int live_q = min(BQ, B - qt * BQ);
  const unsigned full = 0xffffffffu;
  const size_t o = ((size_t)(active ? b : 0) * parts + p) * k;
  float* ls = list_smem ? Ls + warp * k : out_s + o;
  int* li = list_smem ? Li + warp * k : out_i + o;

  for (int i = tid; i < BQ * T; i += THREADS) {
    const int bb = qt * BQ + i / T;
    sq_id[i] = bb < B ? q_ids[(size_t)bb * T + i % T] : QUERY_PAD;
    sq_w[i] = bb < B ? q_w[(size_t)bb * T + i % T] : 0.f;
  }
  if (active) {
    for (int i = lane; i < k; i += 32) {
      ls[i] = -INFINITY;
      li[i] = ARTPU_INT_MAX;
    }
  }

  const int begin = p * part;
  const int end = min(N, begin + part);
  for (int tb = begin; tb < end; tb += TILE) {
    const int nd = min(TILE, end - tb);
    for (int i = tid; i < BQ * TILE; i += THREADS) s_sc[i] = 0.f;
    __syncthreads();
    // one (query, term) pair per step, query-major; each (row, document)
    // entry has one owner (lane 0 of warp j % BQ), so the steps need no
    // barrier
    for (int step = 0; step < live_q * T; ++step) {
      const int term = sq_id[step];  // block-uniform
      if (term == QUERY_PAD) continue;
      const int qb = step / T;
      const float qw = sq_w[step];
      for (int j = warp; j < nd; j += BQ) {
        const int* row = doc_ids + (size_t)(tb + j) * L;
        const float* wr = doc_w + (size_t)(tb + j) * L;
        float c = 0.f;
        for (int l = lane; l < L; l += 32) c = __fadd_rn(c, __ldg(row + l) == term ? __ldg(wr + l) : 0.f);
#pragma unroll
        for (int off = 16; off; off >>= 1) c = __fadd_rn(c, __shfl_xor_sync(full, c, off));
        if (lane == 0) {
          float* sc = s_sc + qb * TILE + j;
          *sc = __fadd_rn(*sc, __fmul_rn(c, qw));
        }
      }
    }
    __syncthreads();
    if (active) {  // warp-uniform
      for (int base = 0; base < nd; base += 32) {
        const float s = lane < nd - base ? s_sc[warp * TILE + base + lane] : -INFINITY;
        float kth = ls[k - 1];
        unsigned want = __ballot_sync(full, s > kth);
        while (want) {
          const int src = __ffs(want) - 1;
          want &= want - 1;
          const float cs = __shfl_sync(full, s, src);
          if (cs > kth) {
            list_insert(ls, li, k, cs, tb + base + src, lane);
            kth = ls[k - 1];
          }
        }
      }
    }
    __syncthreads();
  }

  if (active) {
    for (int i = lane; i < k; i += 32) {
      const float v = ls[i];
      const int id = li[i];
      out_s[o + i] = v == -INFINITY ? ARTPU_NEG_INF : v;
      out_i[o + i] = id;
    }
  }
}

}  // namespace

// q_ids / q_w [B, T]; doc_ids / doc_w [N, L], contiguous. out_s / out_i
// [B, parts, k]; part p covers documents [p*part, (p+1)*part), a multiple of
// the 1,024-document tile. Returns cudaGetLastError().
extern "C" int bm25_topk_v1_launch(const void* q_ids, const void* q_w, const void* doc_ids,
                                   const void* doc_w, void* out_s, void* out_i, int B, int T,
                                   int N, int L, int k, int part, int parts, int q_tiles,
                                   void* stream) {
  if (B == 0 || N == 0 || parts == 0) return 0;
  if (T < 0 || T > TMAX || L < 0 || k < 1 || part < 1 || part % TILE ||
      (long long)q_tiles * BQ < B || (long long)parts * part < N) {
    return (int)cudaErrorInvalidValue;
  }
  const long long blocks = (long long)q_tiles * parts;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
  const int list_smem = k <= KSMEM;
  const int dyn_bytes = (list_smem ? BQ * k * (int)(sizeof(float) + sizeof(int)) : 0) +
                        BQ * T * (int)(sizeof(int) + sizeof(float));
  const cudaError_t e = cudaFuncSetAttribute(
      bm25_v1_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, dyn_bytes);
  if (e != cudaSuccess) return (int)e;
  bm25_v1_kernel<<<(unsigned)blocks, THREADS, dyn_bytes, (cudaStream_t)stream>>>(
      (const int*)q_ids, (const float*)q_w, (const int*)doc_ids, (const float*)doc_w,
      (float*)out_s, (int*)out_i, B, T, N, L, k, part, parts, q_tiles, list_smem);
  return (int)cudaGetLastError();
}
