// bm25_v2: BM25 over the slot-padded layout, flat or lane-packed, with a
// fused streaming top-k: the launchers of every BM25 kernel of the port.
//
// Replaces autorag_research_tpu/ops/sparse.py::_bm25_kernel_v2 (Pallas,
// wrapper bm25_topk_pallas_v2 / _launch_bm25_pallas), ::_bm25_kernel (the v1
// pin, bm25_topk_pallas), ::_bm25_kernel_v2_skip (bm25_topk_pallas_v2_skip),
// ::_bm25_kernel_packed (bm25_topk_pallas_packed), ::_bm25_kernel_probe
// (bm25_topk_pallas_probe) and ::_bm25_kernel_probe_packed
// (bm25_topk_pallas_probe_packed). All six compute one function, as the
// Pallas kernels share _slot_match_scores:
//
//   score(b, n) = sum over t = 0..T-1, in order, of
//                 (sum_l [doc_ids[n, l] == q_ids[b, t]] * doc_w[n, l]) * q_w[b, t]
//
// each product and each partial sum rounded on its own (__fmul_rn /
// __fadd_rn forbid FMA contraction), so every walk equals the plain PyTorch
// version bitwise. Pads (doc -1, query -2) never match, wherever they sit.
//
// Two bodies. Every walk that scores whole document tiles runs
// bm25_hash.cuh, whose note gives its design and bound: a per-document term
// hash in shared memory, probed once per (query term, document), query
// tiles of up to 256 queries per staged document tile, cp.async
// double-buffered staging. Its launchers: the whole-corpus walk over the
// flat layout (bm25_topk_v2_launch, and bm25_topk_v1_launch for the v1
// pin), the skip walk (bm25_topk_v2_skip_launch: doc tiles that the Bloom
// predicate clears for a query's 8-query group are skipped, both modes) and
// the whole-corpus walk over the packed layout (bm25_topk_packed_launch).
//
// The probe walks below (bm25_topk_probe_launch, bm25_topk_probe_packed_
// launch) keep the first body, because their candidate lists come per query
// tile of BQ = 8 queries (ops/sparse.py::probe_candidates). Inputs: q_ids /
// q_w [B, T] int32 / f32; the documents read in place, in one of two
// layouts (the LAYOUT template parameter):
//   FLAT    doc_ids / doc_w [N, L] int32 / f32, document n in row n;
//   PACKED  ops/sparse.py::pack_slots's [R, 128]: pack = P documents of
//           stride L = 128 / P lanes share a row, document n in lanes
//           [(n % P) L, (n % P + 1) L) of row n / P; the 128 - P L dead tail
//           lanes are never scored.
// cand [q_tiles, cap] int32 lists the doc tiles of each query tile in
// increasing order and count [q_tiles] its live entries (a packed tile of
// block_n packed rows is block_n * P documents: the wrapper passes that as
// block_n). Each walk writes per-part lists [B, parts, k] in (-score, row)
// order, merged by the wrapper with merge_topk as dense_topk_stream's are.
//
// Bound on this card: the function is one multiply and one add per (live
// query term, document) pair, 2 operations that the rounding keeps apart (no
// FMA), so at most 33.5 TFLOP/s, half the FMA peak; and the id and weight
// arrays of the candidate tiles read once at 3.35 TB/s.
//
// What the first body does instead: T x L compares per (query, document).
// A block owns one query tile (one warp per query) and a part of its
// candidate list, and walks each candidate tile 32 documents per step: the
// step's [32, L] ids and weights are staged in shared memory synchronously,
// two barriers a step (FLAT: 16-byte loads where L % 4 == 0; PACKED: the
// whole 128-word rows the step's documents lie in, 16-byte loads at any
// stride, each word moved to its document's staged row; the staged row
// stride is padded so the 32 lanes, one per document, read 32 banks), and
// each lane compares every slot of its document against 16 query terms held
// in registers. The epilogue offers the 32 scores of each query row to its
// k-best list (list_insert, common.cuh): a ballot finds the scores above the
// list's k-th; documents increase along a block's walk, so ties go to the
// lower row. Only scores > 0 enter (the lists start at 0.0), rows with fewer
// hits keep (0.0, INT_MAX). Lists of up to KSMEM entries live in shared
// memory; longer ones live in place in the output (global memory,
// L2-cached), so any k is served. Moving these walks onto bm25_hash.cuh
// needs their candidate lists per query tile of the hash body's QB.

#include "bm25_hash.cuh"
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int BQ = THREADS / 32;  // queries of a block, one warp each
constexpr int DOCS = 32;          // documents per step, one per lane
constexpr int TC = 16;            // query terms held in registers at once
constexpr int LC = 128;           // slots staged at once
constexpr int LDS = LC + 1;       // staged row stride (32-bit words)
constexpr int KSMEM = 1024;       // longest list kept in shared memory
constexpr int TMAX = 2048;        // query terms staged per query
constexpr int QUERY_PAD = -2;
constexpr int PACKED_LANES = 128;  // words in a packed row

enum Layout { FLAT = 0, PACKED = 1 };

// Documents [base, base + nd) and slots [l0, l0 + lc) of the FLAT layout
// into shared memory, row stride LDS.
__device__ __forceinline__ void stage_flat(const int* __restrict__ doc_ids,
                                           const float* __restrict__ doc_w, int base, int nd,
                                           int L, int l0, int lc, bool vec, int* s_ids,
                                           float* s_w, int tid) {
  if (vec) {
    const int v4 = lc >> 2;
    for (int v = tid; v < nd * v4; v += THREADS) {
      const int r = v / v4, c = (v - r * v4) * 4;
      const size_t g = (size_t)(base + r) * L + l0 + c;
      const int4 a = *reinterpret_cast<const int4*>(doc_ids + g);
      const float4 w = *reinterpret_cast<const float4*>(doc_w + g);
      int* si = s_ids + r * LDS + c;
      float* sw = s_w + r * LDS + c;
      si[0] = a.x;
      si[1] = a.y;
      si[2] = a.z;
      si[3] = a.w;
      sw[0] = w.x;
      sw[1] = w.y;
      sw[2] = w.z;
      sw[3] = w.w;
    }
  } else {
    for (int v = tid; v < nd * lc; v += THREADS) {
      const int r = v / lc, c = v - r * lc;
      const size_t g = (size_t)(base + r) * L + l0 + c;
      s_ids[r * LDS + c] = doc_ids[g];
      s_w[r * LDS + c] = doc_w[g];
    }
  }
}

// Documents [base, base + nd) of the PACKED layout (stride L, pack a row)
// into the same staged rows as stage_flat: the packed rows they lie in are
// read whole, 16 bytes a load when vec (a row is 512 bytes, so any stride
// aligns), and each word goes to its document's staged row; the dead tail
// lanes and the documents of the neighbouring steps are dropped.
__device__ __forceinline__ void stage_packed(const int* __restrict__ doc_ids,
                                             const float* __restrict__ doc_w, int base, int nd,
                                             int L, int pack, bool vec, int* s_ids, float* s_w,
                                             int tid) {
  constexpr int V4 = PACKED_LANES / 4;
  const int r0 = base / pack;
  const int nr = (base + nd - 1) / pack - r0 + 1;
  const int d0 = base - r0 * pack;  // the first document's place in row r0
  for (int v = tid; v < nr * V4; v += THREADS) {
    const int r = v / V4, c = (v - r * V4) * 4;
    const size_t g = (size_t)(r0 + r) * PACKED_LANES + c;
    int a[4];
    float w[4];
    if (vec) {
      const int4 a4 = *reinterpret_cast<const int4*>(doc_ids + g);
      const float4 w4 = *reinterpret_cast<const float4*>(doc_w + g);
      a[0] = a4.x;
      a[1] = a4.y;
      a[2] = a4.z;
      a[3] = a4.w;
      w[0] = w4.x;
      w[1] = w4.y;
      w[2] = w4.z;
      w[3] = w4.w;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        a[e] = doc_ids[g + e];
        w[e] = doc_w[g + e];
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = (c + e) / L;        // the row's document (pack: a dead lane)
      const int d = r * pack + j - d0;  // its place in this step
      if (j < pack && d >= 0 && d < nd) {
        s_ids[d * LDS + c + e - j * L] = a[e];
        s_w[d * LDS + c + e - j * L] = w[e];
      }
    }
  }
}

template <int LAYOUT>
__global__ void __launch_bounds__(THREADS)
bm25_probe_kernel(const int* __restrict__ q_ids, const float* __restrict__ q_w,
                  const int* __restrict__ doc_ids, const float* __restrict__ doc_w,
                  const int* __restrict__ cand, const int* __restrict__ count,
                  float* __restrict__ out_s, int* __restrict__ out_i, int B, int T, int N, int L,
                  int k, int part, int parts, int q_tiles, int n_tiles, int cap, int block_n,
                  int vec, int list_smem, int pack) {
  __shared__ int s_ids[DOCS * LDS];
  __shared__ float s_w[DOCS * LDS];
  extern __shared__ __align__(16) unsigned char dyn[];
  const int list_n = list_smem ? BQ * k : 0;
  float* Ls = reinterpret_cast<float*>(dyn);                // [BQ, k] when in shared memory
  int* Li = reinterpret_cast<int*>(Ls + list_n);            // [BQ, k]
  int* sq_id = Li + list_n;                                 // [BQ, T]
  float* sq_w = reinterpret_cast<float*>(sq_id + BQ * T);   // [BQ, T]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int qt = blockIdx.x % q_tiles;
  const int p = blockIdx.x / q_tiles;
  const int b = qt * BQ + warp;
  const bool active = b < B;  // warp-uniform
  const unsigned full = 0xffffffffu;
  // this warp's list: shared memory, or its own slice of the output
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
      ls[i] = 0.f;  // only scores > 0 enter
      li[i] = ARTPU_INT_MAX;
    }
  }
  __syncthreads();

  // this block's slice of the query tile's candidate list
  const int begin = p * part;
  const int end = min(min(count[qt], cap), begin + part);
  const int n_walk = max(0, end - begin);
  const int n_lc = (L + LC - 1) / LC;
  const int* qid_row = sq_id + warp * T;
  const float* qw_row = sq_w + warp * T;

  for (int w = 0; w < n_walk; ++w) {
    const int tile = cand[(size_t)qt * cap + begin + w];  // block-uniform
    if (tile < 0 || tile >= n_tiles) continue;
    const int tb = tile * block_n;
    const int te = min(N, tb + block_n);
    for (int base = tb; base < te; base += DOCS) {
      const int nd = min(DOCS, te - base);
      const bool mine = active && lane < nd;
      float score = 0.f;
      for (int t0 = 0; t0 < T; t0 += TC) {
        int qid[TC];
        float m[TC];
#pragma unroll
        for (int j = 0; j < TC; ++j) {
          qid[j] = t0 + j < T ? qid_row[t0 + j] : QUERY_PAD;
          m[j] = 0.f;
        }
        for (int lci = 0; lci < n_lc; ++lci) {
          const int l0 = lci * LC;
          const int lc = min(LC, L - l0);
          if (n_lc > 1 || t0 == 0) {
            __syncthreads();
            if (LAYOUT == PACKED) {  // L <= 64: one chunk, l0 = 0
              stage_packed(doc_ids, doc_w, base, nd, L, pack, vec != 0, s_ids, s_w, tid);
            } else {
              stage_flat(doc_ids, doc_w, base, nd, L, l0, lc, vec != 0, s_ids, s_w, tid);
            }
            __syncthreads();
          }
          if (mine) {
            const int* row = s_ids + lane * LDS;
            const float* wr = s_w + lane * LDS;
            for (int l = 0; l < lc; ++l) {
              const int id = row[l];
              const float wt = wr[l];
#pragma unroll
              for (int j = 0; j < TC; ++j) m[j] = __fadd_rn(m[j], id == qid[j] ? wt : 0.f);
            }
          }
        }
        if (mine) {
#pragma unroll
          for (int j = 0; j < TC; ++j) {
            if (t0 + j < T) score = __fadd_rn(score, __fmul_rn(m[j], qw_row[t0 + j]));
          }
        }
      }
      if (active) {  // warp-uniform
        // the list starts at 0.0, so only scores > 0 can enter
        const float s = lane < nd ? score : -INFINITY;
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
    }
  }

  if (active) {
    for (int i = lane; i < k; i += 32) {
      out_s[o + i] = ls[i];
      out_i[o + i] = li[i];
    }
  }
}

template <int LAYOUT>
int launch(const void* q_ids, const void* q_w, const void* doc_ids, const void* doc_w,
           const void* cand, const void* count, void* out_s, void* out_i, int B, int T, int N,
           int L, int k, int part, int parts, int q_tiles, int n_tiles, int cap, int block_n,
           int vec, int pack, void* stream) {
  if (B == 0 || N == 0 || parts == 0) return 0;
  if (T < 0 || T > TMAX || L < 0 || k < 1 || part < 1 || (long long)q_tiles * BQ < B ||
      block_n < 1 || (long long)n_tiles * block_n < N || (long long)(n_tiles - 1) * block_n >= N ||
      cand == nullptr || count == nullptr || cap < 1 || (long long)parts * part < cap) {
    return (int)cudaErrorInvalidValue;
  }
  if (vec && LAYOUT == FLAT && L % 4) return (int)cudaErrorInvalidValue;
  if (LAYOUT == FLAT ? pack != 1 : (pack < 2 || (long long)pack * L > PACKED_LANES)) {
    return (int)cudaErrorInvalidValue;
  }
  const long long blocks = (long long)q_tiles * parts;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
  const int list_smem = k <= KSMEM;
  const int dyn_bytes = (list_smem ? BQ * k * (int)(sizeof(float) + sizeof(int)) : 0) +
                        BQ * T * (int)(sizeof(int) + sizeof(float));
  auto kernel = bm25_probe_kernel<LAYOUT>;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, dyn_bytes);
  if (e != cudaSuccess) return (int)e;
  kernel<<<(unsigned)blocks, THREADS, dyn_bytes, (cudaStream_t)stream>>>(
      (const int*)q_ids, (const float*)q_w, (const int*)doc_ids, (const float*)doc_w,
      (const int*)cand, (const int*)count, (float*)out_s, (int*)out_i, B, T, N, L, k, part,
      parts, q_tiles, n_tiles, cap, block_n, vec, list_smem, pack);
  return (int)cudaGetLastError();
}

}  // namespace

// q_ids / q_w [B, T]; doc_ids / doc_w [N, L] (FLAT, pack = 1) or [ceil(N /
// pack), 128] (PACKED, L = 128 / pack the stride), contiguous, 16-byte
// aligned when vec != 0 (then, FLAT, L % 4 == 0). out_s / out_i [B, parts,
// k]: part p covers candidate entries [p*part, (p+1)*part) of cand
// [q_tiles, cap] int32 (tile indices, increasing; a tile is block_n
// documents), count [q_tiles] int32. Each returns cudaGetLastError().
#define BM25_PROBE_ARGS                                                                      \
  const void *q_ids, const void *q_w, const void *doc_ids, const void *doc_w,                 \
      const void *cand, const void *count, void *out_s, void *out_i, int B, int T, int N,      \
      int L, int k, int part, int parts, int q_tiles, int n_tiles, int cap, int block_n,      \
      int vec, int pack, void *stream
#define BM25_PROBE_PASS                                                                      \
  q_ids, q_w, doc_ids, doc_w, cand, count, out_s, out_i, B, T, N, L, k, part, parts, q_tiles, \
      n_tiles, cap, block_n, vec, pack, stream

// The whole-corpus walk over the flat layout: bm25_hash.cuh's body, with the
// arguments of bm25_hash::launch.
extern "C" int bm25_topk_v2_launch(BM25_HASH_ARGS) {
  return bm25_hash::launch(bm25_hash::FULL, BM25_HASH_PASS);
}

// The v1 pin. Replaces autorag_research_tpu/ops/sparse.py::_bm25_kernel
// (Pallas, wrapper bm25_topk_pallas / _launch_bm25_pallas, block_n = 1024),
// which a SparseIndex search reaches only through method="pallas". The pin
// keeps the TPU kernel's function, not its blocks: the TPU's v1 walked
// 1,024-document tiles one (query, term) pair per step, a structure its own
// v2 replaced, so here it is the whole-corpus walk's kernel under its own
// name (the wrapper counts its launches apart), with that kernel's bound and
// design (bm25_hash.cuh).
extern "C" int bm25_topk_v1_launch(BM25_HASH_ARGS) {
  return bm25_hash::launch(bm25_hash::FULL, BM25_HASH_PASS);
}

// The skip walk, walk = SKIP_POS (positive_only) or SKIP_V2, on the hash body.
extern "C" int bm25_topk_v2_skip_launch(BM25_HASH_ARGS) {
  return bm25_hash::launch(bm25_hash::SKIP_POS, BM25_HASH_PASS);
}

// The whole-corpus walk over the packed layout, on the hash body (pack > 1
// where the pack is no power of two; the wrapper passes a power of two's
// rows as the flat [R pack, 128 / pack] array, pack = 1).
extern "C" int bm25_topk_packed_launch(BM25_HASH_ARGS) {
  return bm25_hash::launch(bm25_hash::FULL, BM25_HASH_PASS);
}

extern "C" int bm25_topk_probe_launch(BM25_PROBE_ARGS) { return launch<FLAT>(BM25_PROBE_PASS); }

extern "C" int bm25_topk_probe_packed_launch(BM25_PROBE_ARGS) {
  return launch<PACKED>(BM25_PROBE_PASS);
}
