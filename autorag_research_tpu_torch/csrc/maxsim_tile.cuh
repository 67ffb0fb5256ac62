// The MaxSim tile body for Hopper, behind every MaxSim launcher: maxsim_v2.cu
// (#9 the fused top-k and #10 the raw scores), maxsim_v1.cu (#11, the pallas
// pin) and maxsim_v3.cu (#12, the pallas_v3 pin), each in f32 and bf16. The
// three differ only in how a document token past the document's length is
// kept out of the per-token max, the Mask policy:
//
//   LENS (#9, #10): score(b, n) = sum_{t < len_b} max_{s < len_n} q[b, t] . doc[n, s];
//                   the lengths are read and a document is walked to round_up(len, 16)
//   BIAS (#11):     ... max_{s < Td} (q[b, t] . doc[n, s] + bias[n, s]), bias [N, Td]
//                   f32 (0 or NEG_INF) added before the max; no lengths read
//   LANE (#12):     ... max_{s < Td} q'[b, t] . doc'[n, s] over operands that carry
//                   the mask in lane d (1 on query rows, 0 or -1e30 on tokens)
//
// BIAS and LANE walk all Td tokens of every document, as their TPU kernels do;
// a chunk's positions past Td (the next document's rows in the [N*Td, d]
// view) are masked by position in every policy.
//
// Inputs. qp [q_rows, d]: the token rows of whole queries, packed by
// ops/maxsim.py::maxsim_plan into row tiles of ROWS (128 in f32, 256 in bf16;
// a longer query takes consecutive tiles of its own block), zero rows after
// a tile's last query (BIAS and LANE keep one row of a query of length 0:
// with none its sums would be 0 against an empty document too); docs
// [N, Td, d] row-major, read in place; aux (dlens [N] or bias [N, Td]); the
// plan's tables blk [blocks, 4] (first query, queries, row tiles, first packed
// row) and qrow [B, 2] (packed row, rows). Outputs: per-part lists [B, P, k] in
// (-score, row) order, merged by the wrapper with merge_topk, or [B, N] f32
// (LENS only). An empty document scores NEG_INF with its own row under LENS
// and BIAS (its rows' NEG_INF maxima overflow, and the sum is clamped); under
// LANE it scores rows x -1e30, which the wrapper resets after selection.
//
// Arithmetic: f32 runs FFMA on the CUDA cores (no TF32, the exact paths'
// rule); bf16 runs wgmma m64n128k16 with f32 accumulators (exact products,
// f32 sums). Each query's row maxima are summed in f32 in token order.
//
// Design. A block holds 8 consumer warps and a producer warpgroup, of which
// one warp works; setmaxnreg moves the producers' registers to the consumers.
// It walks work items (row block, part of the documents) in a grid-stride
// loop; the plan sizes the grid to the card's resident block slots and picks
// the parts so the items fill whole waves. For each item:
// - Query rows stay resident: the producer stages a row tile's k-boxes (ROWS
//   rows x 128 bytes each, the 128-byte TMA swizzle) once per item (per pass
//   when a query spans row tiles). Where they do not fit beside the ring
//   (d past 320 in f32, 256 in bf16) each ring slot carries the query k-box
//   beside the tokens' instead ("streamed").
// - Documents come in groups of 32, one per lane. Each warp derives the
//   group's chunk list in registers: a document is walked in chunks of 16
//   tokens up to round_up(len, 16), and a 128-token product tile is 8
//   chunks, which may belong to several documents (under BIAS and LANE every
//   document has the same chunks, so a chunk's document is arithmetic, the
//   same in the producer and the consumers). The producer stages each
//   chunk as one TMA box of 16 token rows x 128 bytes of the [N*Td, d] view
//   into a ring of 3-6 slots of 16 KB (one k-box of a tile), counted on the
//   slot's full mbarrier; consumers release a slot on its empty mbarrier.
//   No block-wide barrier runs inside the walk.
// - f32: each consumer thread holds 8 x 8 accumulators, rows ty + 16 i and
//   tokens tx + 16 j (so chunk j), read from the swizzled slices as in
//   dense_topk_stream.cu; a row's 16 tx share one half-warp. bf16: two
//   warpgroups of 128 rows each issue two wgmma (64 rows each) per k-step
//   from the resident query k-box and the slot; a thread holds 4 rows x 32
//   tokens, 4 of them per chunk. Each staged token is multiplied by 256 query
//   rows: staging, not the tensor cores, bounds a tile of 128 rows.
// - LANE multiplies the last k-box of a row over its live lanes only (d is
//   a multiple of 8): at d' = 136 the bias lane costs 8 lanes, not a whole
//   k-box. (The other policies keep one k-box loop: at d = 128 a second
//   one cost #9 about 3% in bf16.)
// - After a tile each thread folds its valid chunk columns into running row
//   maxima in registers (BIAS: each product plus its token's bias, loaded
//   before the tile's products so that the loads overlap them); at a
//   document's last chunk the maxima are reduced
//   across the lanes that share the rows (16 in f32, a quad in bf16) and
//   written to a [32 docs, ROWS] table in shared memory.
// - After a group (two barriers of the consumer warps) one warp per query
//   adds its rows' maxima for the 32 documents, one per lane, and either
//   writes the scores or offers them to the query's k-best list with
//   list_insert's ballot rule (a warm list costs one ballot per query and
//   group). Lists of up to QMAX x k entries live in shared memory, longer
//   ones in place in the output, so any k is served. Documents increase
//   along a part, so ties resolve to the lower row.
#pragma once

#include "common.cuh"
#include "tma.cuh"
#include "wgmma.cuh"

namespace mtile {

constexpr int CHUNK = 16;                  // document tokens of a chunk (one TMA box)
constexpr int CPT = 8;                     // chunks of a 128-token product tile
constexpr int GROUP = 32;                  // documents of a group, one per lane
constexpr int QMAX = 32;                   // queries of a row tile
constexpr int CWARPS = 8;                   // consumer warps (two warpgroups)
constexpr int THREADS = CWARPS * 32 + 128;  // and a producer warpgroup: one warp works
// registers a thread after setmaxnreg: 256 x 232 + 128 x 40 <= 65,536
constexpr int CONSUMER_REGS = 232, PRODUCER_REGS = 40;
constexpr int TOKENS = CPT * CHUNK;        // tokens of a product tile
constexpr int BOX = TOKENS * 128;          // a staged token k-box: 128 tokens x 128 bytes
constexpr int CHUNK_BYTES = CHUNK * 128;
constexpr int ALIGN = 1024;                // the 128-byte swizzle repeats every 1,024 bytes
constexpr long long SMEM_MAX = 232448;     // a block's shared memory on sm_90
constexpr unsigned FULL = 0xffffffffu;

// slack, [resident query k-boxes of `rows` x 128 bytes], ring, row maxima
// [32, rows + 1], barriers (full and empty per slot, the query pair), [lists
// of QMAX queries x k]
inline long long layout_bytes(int rows, int k_boxes, int stages, bool resident, bool smem_lists,
                              int k) {
  const long long qbox = rows * 128LL;
  const long long q = resident ? k_boxes * qbox : 0;
  const long long slot = resident ? BOX : BOX + qbox;
  return ALIGN + q + stages * slot + GROUP * (rows + 1) * 4LL + 16LL * (stages + 1) +
         (smem_lists ? (long long)QMAX * k * 8 : 0);
}

enum Mask { LENS = 0, BIAS = 1, LANE = 2 };

struct Args {
  const void* aux;  // LENS: int32 lengths [N]; BIAS: f32 bias [N, Td]; LANE: unused
  const int* blk;   // [blocks, 4]
  const int* qrow;  // [B, 2]
  float* out_s;
  int* out_i;
  // live: elements of a row's last k-box that hold data (the rest are TMA's
  // zeros); LANE multiplies only those
  int N, Td, k, blocks, parts, part_docs, k_boxes, live, stages, resident, smem_lists;
};

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(CWARPS * 32) : "memory");
}

// One group of up to 32 documents from `base`, lane j holding document
// base + j: its tokens walked (LENS: its length clamped to [0, Td]; BIAS and
// LANE: all Td) and its chunk range [start, end) in the group's chunk list.
struct Group {
  int nd, len, start, end, total;
};

template <int MASK>
__device__ __forceinline__ Group group_at(const Args& a, int base, int doc_end, int lane) {
  Group g;
  g.nd = min(GROUP, doc_end - base);
  if (lane >= g.nd) {
    g.len = 0;
  } else if (MASK == LENS) {
    g.len = min(max(__ldg(static_cast<const int*>(a.aux) + base + lane), 0), a.Td);
  } else {
    g.len = a.Td;
  }
  const int nch = (g.len + CHUNK - 1) / CHUNK;
  int end = nch;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int v = __shfl_up_sync(FULL, end, off);
    if (lane >= off) end += v;
  }
  g.end = end;
  g.start = end - nch;
  g.total = __shfl_sync(FULL, end, 31);
  return g;
}

// The document (lane) that owns chunk cc < total: the last lane whose range
// starts at or before cc (empty documents share their successor's start).
__device__ __forceinline__ int chunk_owner(const Group& g, int cc) {
  return 31 - __clz(__ballot_sync(FULL, g.start <= cc));
}

// BIAS and LANE walk every document over the same nch chunks, so chunk cc
// of a group is chunk cc % nch of its document cc / nch: a tile's chunks
// need no ballot. The producer's staging, the bias loads and the fold all
// take their chunks from here. (j, m) starts at tile t's first chunk; next()
// steps it.
struct UniformChunk {
  int nch, j, m;
  __device__ __forceinline__ UniformChunk(int Td, int t) {
    nch = (Td + CHUNK - 1) / CHUNK;
    j = t * CPT / nch;
    m = t * CPT - j * nch;
  }
  __device__ __forceinline__ void next() {
    if (++m == nch) {
      m = 0;
      ++j;
    }
  }
};

// BIAS: bv[c] = the bias of token lane % 16 of tile t's chunk c (0 past the
// walk or past Td), loaded before the tile's products so that they hide the
// loads' latency.
__device__ __forceinline__ void tile_bias(const Args& a, const Group& g, int base, int t,
                                          int lane, float (&bv)[CPT]) {
  const float* bias = static_cast<const float*>(a.aux);
  UniformChunk u(a.Td, t);
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    const int pos = u.m * CHUNK + (lane & 15);
    bv[c] = t * CPT + c < g.total && pos < a.Td
                ? __ldg(bias + (size_t)(base + u.j) * a.Td + pos)
                : 0.f;
    u.next();
  }
}

// ---- f32: FFMA, 8 x 8 accumulators a thread
struct F32 {
  using T = float;
  static constexpr int ROWS = 128;  // query-token rows of a tile
  static constexpr int BOX_K = 32;  // elements of a k-box row (128 bytes)
  static constexpr CUtensorMapDataType TYPE = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  struct State {
    float acc[64];  // acc[i * 8 + j]: row ty + 16 i, token tx + 16 j
    float run[8];   // running maxima of rows ty + 16 i over the current document
    int ty, tx;
  };

  __device__ __forceinline__ static void init(State& st, int ctid) {
    st.ty = ((ctid >> 5) << 1) | ((ctid & 31) >> 4);
    st.tx = ctid & 15;
#pragma unroll
    for (int i = 0; i < 8; ++i) st.run[i] = -INFINITY;
  }

  __device__ __forceinline__ static void tile_begin(State& st) {
#pragma unroll
    for (int i = 0; i < 64; ++i) st.acc[i] = 0.f;
  }

  // one k-box: k-quad kq of a box row r sits at 16-byte chunk kq ^ (r % 8);
  // TAIL: only the quads of the `live` elements that hold data
  template <bool TAIL>
  __device__ __forceinline__ static void mma(State& st, const unsigned char* A,
                                             const unsigned char* B, int, int live) {
    const float* As = reinterpret_cast<const float*>(A) + st.ty * BOX_K;
    const float* Bs = reinterpret_cast<const float*>(B) + st.tx * BOX_K;
#pragma unroll
    for (int kq = 0; kq < BOX_K / 4; ++kq) {
      if (TAIL && kq * 4 >= live) break;
      const int ca = (kq ^ (st.ty & 7)) * 4, cb = (kq ^ (st.tx & 7)) * 4;
      float4 a[8], b[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = *reinterpret_cast<const float4*>(As + 16 * i * BOX_K + ca);
#pragma unroll
      for (int j = 0; j < 8; ++j) b[j] = *reinterpret_cast<const float4*>(Bs + 16 * j * BOX_K + cb);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) st.acc[i * 8 + j] = fmaf(a[i].x, b[j].x, st.acc[i * 8 + j]);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) st.acc[i * 8 + j] = fmaf(a[i].y, b[j].y, st.acc[i * 8 + j]);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) st.acc[i * 8 + j] = fmaf(a[i].z, b[j].z, st.acc[i * 8 + j]);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) st.acc[i * 8 + j] = fmaf(a[i].w, b[j].w, st.acc[i * 8 + j]);
    }
  }

  // the slot's shared loads are done once the warp is
  static constexpr bool ASYNC = false;
  __device__ __forceinline__ static void wait_prev() {}
  __device__ __forceinline__ static void tile_end(State&) {}

  // fold chunk c's valid tokens (positions < nv) into the running maxima, each
  // product plus its token's bias b under BIAS (this thread's token tx is
  // lane % 16, whose bias tile_bias loaded); c is a constant once the
  // caller's loop is unrolled
  template <int MASK>
  __device__ __forceinline__ static void chunk(State& st, int c, int nv, float b) {
    if (st.tx < nv) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
        st.run[i] = fmaxf(st.run[i], MASK == BIAS ? st.acc[i * 8 + c] + b : st.acc[i * 8 + c]);
    }
  }

  // the document ended: its row maxima to rm_doc[row], maxima reset
  __device__ __forceinline__ static void emit(State& st, float* rm_doc) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float v = st.run[i];
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, off));
      if (st.tx == 0) rm_doc[st.ty + 16 * i] = v;
      st.run[i] = -INFINITY;
    }
  }
};

// ---- bf16: wgmma m64n128k16 (wgmma.cuh), f32 accumulators; warpgroup w owns rows 64 w..
struct BF16 {
  using T = __nv_bfloat16;
  static constexpr int ROWS = 256;
  static constexpr int BOX_K = 64;
  static constexpr CUtensorMapDataType TYPE = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  // acc[h][4 i + e] is row r0 + 64 h (e < 2) or r0 + 64 h + 8 (e >= 2),
  // token 8 i + 2 t + e % 2; run[2 h + (e >= 2)] the running maxima
  struct State {
    float acc[2][64];
    float run[4];
    int r0, t;
  };

  __device__ __forceinline__ static void init(State& st, int ctid) {
    const int warp = ctid >> 5, lane = ctid & 31;
    st.r0 = (warp >> 2) * 128 + (warp & 3) * 16 + (lane >> 2);
    st.t = lane & 3;
#pragma unroll
    for (int r = 0; r < 4; ++r) st.run[r] = -INFINITY;
  }

  __device__ __forceinline__ static void tile_begin(State&) {}  // the first wgmma scales by 0

  // one k-box: per k = 16 (32 bytes along the swizzled 128-byte rows) two
  // wgmma, the warpgroup's 64-row halves against the same staged tokens;
  // TAIL: only the k-steps of the `live` elements that hold data
  template <bool TAIL>
  __device__ __forceinline__ static void mma(State& st, const unsigned char* A,
                                             const unsigned char* B, int kb, int live) {
    const unsigned char* Aw = A + (st.r0 >> 7) * 128 * 128;
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (TAIL && kk * 16 >= live) break;
      const uint64_t db = sw128_desc(B + kk * 32);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        wgmma_m64n128k16(st.acc[h], sw128_desc(Aw + h * 64 * 128 + kk * 32), db,
                         kb > 0 || kk > 0);
      }
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  }

  // a slot is free once its group of wgmma has completed: the previous one
  // after this k-box's issue, the last at the tile's end
  static constexpr bool ASYNC = true;
  __device__ __forceinline__ static void wait_prev() {
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
  }
  __device__ __forceinline__ static void tile_end(State& st) {
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    wgmma_fence_acc(st.acc[0]);
    wgmma_fence_acc(st.acc[1]);
  }

  // a thread holds tokens 8 ii + 2 t + e of a chunk; under BIAS lane l holds
  // the bias of token l % 16, so each token's bias is one shuffle away
  template <int MASK>
  __device__ __forceinline__ static void chunk(State& st, int c, int nv, float b) {
    float bt[4] = {0.f, 0.f, 0.f, 0.f};
    if (MASK == BIAS) {
#pragma unroll
      for (int x = 0; x < 4; ++x) bt[x] = __shfl_sync(FULL, b, 8 * (x >> 1) + 2 * st.t + (x & 1));
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v0 = -INFINITY, v1 = -INFINITY;
#pragma unroll
      for (int ii = 0; ii < 2; ++ii) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (8 * ii + 2 * st.t + e < nv) {
            const float bb = bt[2 * ii + e];
            const float p0 = st.acc[h][4 * (2 * c + ii) + e];
            const float p1 = st.acc[h][4 * (2 * c + ii) + 2 + e];
            v0 = fmaxf(v0, MASK == BIAS ? p0 + bb : p0);
            v1 = fmaxf(v1, MASK == BIAS ? p1 + bb : p1);
          }
        }
      }
      st.run[2 * h] = fmaxf(st.run[2 * h], v0);
      st.run[2 * h + 1] = fmaxf(st.run[2 * h + 1], v1);
    }
  }

  __device__ __forceinline__ static void emit(State& st, float* rm_doc) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float v = st.run[r];
      v = fmaxf(v, __shfl_xor_sync(FULL, v, 1));
      v = fmaxf(v, __shfl_xor_sync(FULL, v, 2));
      if (st.t == 0) rm_doc[st.r0 + 64 * (r >> 1) + 8 * (r & 1)] = v;
      st.run[r] = -INFINITY;
    }
  }
};

// A pass of the item over one group needs the query tile staged: at the
// item's first pass, and at every pass of a query that spans row tiles.
__device__ __forceinline__ bool needs_q(const Args& a, int rt_count, bool first) {
  return a.resident && (rt_count > 1 || first);
}

template <class Op, bool FUSED, int MASK>
__global__ void __launch_bounds__(THREADS, 1)
maxsim_tile_kernel(const Args a, const __grid_constant__ CUtensorMap map_q,
                   const __grid_constant__ CUtensorMap map_d) {
  constexpr int ROWS = Op::ROWS, QBOX = ROWS * 128, LDR = ROWS + 1;  // LDR: row-maxima stride
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((ALIGN - smem_addr(smem_raw) % ALIGN) % ALIGN);
  unsigned char* qres = smem;
  unsigned char* ring = qres + (a.resident ? a.k_boxes * QBOX : 0);
  const int slot_bytes = a.resident ? BOX : BOX + QBOX;
  float* rm = reinterpret_cast<float*>(ring + a.stages * slot_bytes);
  unsigned char* bar_mem = reinterpret_cast<unsigned char*>(rm + GROUP * LDR);
  const unsigned full0 = smem_addr(bar_mem);
  const unsigned empty0 = full0 + 8 * a.stages;
  const unsigned qfull = full0 + 16 * a.stages, qempty = qfull + 8;
  float* Ls = reinterpret_cast<float*>(bar_mem + 16 * (a.stages + 1));  // [QMAX, k]
  int* Li = reinterpret_cast<int*>(Ls + (a.smem_lists ? QMAX * a.k : 0));

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
    for (int s = 0; s < a.stages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, CWARPS);
    }
    mbar_init(qfull, 1);
    mbar_init(qempty, CWARPS);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();  // the roles split here and never meet again

  const int items = a.blocks * a.parts;
  int slot = 0;
  unsigned phase = 0;  // parity of the slot's current round
  unsigned qloads = 0;
  auto next_slot = [&]() {
    if (++slot == a.stages) {
      slot = 0;
      phase ^= 1;
    }
  };

  if (warp >= CWARPS) {
    // ---- producer warp: query tiles and document chunks, in the consumers' order
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (warp > CWARPS) return;
    for (int it = blockIdx.x; it < items; it += gridDim.x) {
      const int4 blk = reinterpret_cast<const int4*>(a.blk)[it % a.blocks];
      const int d0 = (it / a.blocks) * a.part_docs, d1 = min(a.N, d0 + a.part_docs);
      for (int base = d0; base < d1; base += GROUP) {
        const Group g = group_at<MASK>(a, base, d1, lane);
        const int tiles = (g.total + CPT - 1) / CPT;
        for (int rt = 0; rt < blk.z; ++rt) {
          const int q_row = blk.w + rt * ROWS;
          if (needs_q(a, blk.z, base == d0 && rt == 0)) {
            if (qloads > 0) mbar_wait(qempty, (qloads - 1) & 1);
            if (lane == 0) {
              mbar_expect_tx(qfull, a.k_boxes * QBOX);
              for (int kb = 0; kb < a.k_boxes; ++kb)
                tma_load_2d(smem_addr(qres + kb * QBOX), &map_q, qfull, kb * Op::BOX_K, q_row);
            }
            ++qloads;
          }
          for (int t = 0; t < tiles; ++t) {
            // lane c < 8 stages chunk c of the tile: its first token row
            int row = 0;
            if constexpr (MASK == LENS) {
#pragma unroll
              for (int c = 0; c < CPT; ++c) {
                const int cc = t * CPT + c;
                if (cc < g.total) {
                  const int j = chunk_owner(g, cc);
                  const int st = __shfl_sync(FULL, g.start, j);
                  if (lane == c) row = (base + j) * a.Td + (cc - st) * CHUNK;
                }
              }
            } else {
              UniformChunk u(a.Td, t);
#pragma unroll
              for (int c = 0; c < CPT; ++c) {
                if (lane == c) row = (base + u.j) * a.Td + u.m * CHUNK;
                u.next();
              }
            }
            const int nch = min(CPT, g.total - t * CPT);
            for (int kb = 0; kb < a.k_boxes; ++kb) {
              mbar_wait(empty0 + 8 * slot, phase ^ 1);
              unsigned char* s = ring + slot * slot_bytes;
              const unsigned bar = full0 + 8 * slot;
              if (lane == 0) mbar_expect_tx(bar, nch * CHUNK_BYTES + (a.resident ? 0 : QBOX));
              __syncwarp();
              if (lane < nch)
                tma_load_2d(smem_addr(s + lane * CHUNK_BYTES), &map_d, bar, kb * Op::BOX_K, row);
              if (!a.resident && lane == 0)
                tma_load_2d(smem_addr(s + BOX), &map_q, bar, kb * Op::BOX_K, q_row);
              next_slot();
            }
          }
        }
      }
    }
    return;
  }

  // ---- consumer warps
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  typename Op::State st;
  Op::init(st, tid);
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const int4 blk = reinterpret_cast<const int4*>(a.blk)[it % a.blocks];
    const int p = it / a.blocks;
    const int d0 = p * a.part_docs, d1 = min(a.N, d0 + a.part_docs);
    // query qi's list: shared memory (owned by warp qi % 8), or its slice of the output
    auto list_s = [&](int qi) {
      return a.smem_lists ? Ls + qi * a.k : a.out_s + ((size_t)(blk.x + qi) * a.parts + p) * a.k;
    };
    auto list_i = [&](int qi) {
      return a.smem_lists ? Li + qi * a.k : a.out_i + ((size_t)(blk.x + qi) * a.parts + p) * a.k;
    };
    if (FUSED) {
      for (int qi = warp; qi < blk.y; qi += CWARPS) {
        float* ls = list_s(qi);
        int* li = list_i(qi);
        for (int i = lane; i < a.k; i += 32) {
          ls[i] = -INFINITY;
          li[i] = ARTPU_INT_MAX;
        }
      }
      __syncwarp();
    }
    for (int base = d0; base < d1; base += GROUP) {
      const Group g = group_at<MASK>(a, base, d1, lane);
      const int tiles = (g.total + CPT - 1) / CPT;
      float carry = 0.f;  // a long query's sums over its earlier row tiles
      for (int rt = 0; rt < blk.z; ++rt) {
        if (needs_q(a, blk.z, base == d0 && rt == 0)) {
          mbar_wait(qfull, qloads & 1);
          ++qloads;
        }
        for (int t = 0; t < tiles; ++t) {
          float bv[CPT];
          if constexpr (MASK == BIAS) tile_bias(a, g, base, t, lane, bv);
          Op::tile_begin(st);
          int prev = -1;
          for (int kb = 0; kb < a.k_boxes; ++kb) {
            mbar_wait(full0 + 8 * slot, phase);
            const unsigned char* s = ring + slot * slot_bytes;
            const unsigned char* qk = a.resident ? qres + kb * QBOX : s + BOX;
            if (MASK == LANE && kb + 1 == a.k_boxes && a.live < Op::BOX_K) {
              Op::template mma<true>(st, qk, s, kb, a.live);
            } else {
              Op::template mma<false>(st, qk, s, kb, Op::BOX_K);
            }
            if constexpr (!Op::ASYNC) {
              __syncwarp();
              if (lane == 0) mbar_arrive(empty0 + 8 * slot);
            } else {
              if (prev >= 0) {
                Op::wait_prev();
                if (lane == 0) mbar_arrive(empty0 + 8 * prev);
              }
              prev = slot;
            }
            next_slot();
          }
          Op::tile_end(st);
          if (prev >= 0 && lane == 0) mbar_arrive(empty0 + 8 * prev);
          // fold the tile's chunks into the running maxima, in order
          UniformChunk u(a.Td, t);
#pragma unroll
          for (int c = 0; c < CPT; ++c) {
            const int cc = t * CPT + c;
            if (cc < g.total) {  // uniform
              if constexpr (MASK == LENS) {
                const int j = chunk_owner(g, cc);
                const int st0 = __shfl_sync(FULL, g.start, j);
                const int end = __shfl_sync(FULL, g.end, j);
                const int len = __shfl_sync(FULL, g.len, j);
                Op::template chunk<MASK>(st, c, len - (cc - st0) * CHUNK, 0.f);
                if (cc == end - 1) Op::emit(st, rm + j * LDR);
              } else {
                Op::template chunk<MASK>(st, c, a.Td - u.m * CHUNK, MASK == BIAS ? bv[c] : 0.f);
                if (u.m == u.nch - 1) Op::emit(st, rm + u.j * LDR);
              }
            }
            if constexpr (MASK != LENS) u.next();
          }
        }
        // the query tile is free once the pass ends, where the next pass restages it
        if (a.resident && (blk.z > 1 || (base + GROUP >= d1 && rt == blk.z - 1))) {
          __syncwarp();
          if (lane == 0) mbar_arrive(qempty);
        }
        consumer_sync();  // every document's row maxima are in rm
        for (int qi = warp; qi < blk.y; qi += CWARPS) {
          const int b = blk.x + qi;
          const int2 qr = reinterpret_cast<const int2*>(a.qrow)[b];
          const int rs = qr.x - blk.w - rt * ROWS;
          const int lo = max(0, rs), hi = min(ROWS, rs + qr.y);
          float sum = rt > 0 ? carry : 0.f;
          for (int r = lo; r < hi; ++r) sum += rm[lane * LDR + r];
          if (rt + 1 < blk.z) {
            carry = sum;  // blk.z > 1: one query, warp 0
            continue;
          }
          // an empty document keeps its row at NEG_INF: LENS knows it by its
          // length, BIAS by its rows' NEG_INF maxima, whose sum overflows
          if (MASK == LENS && g.len == 0) sum = ARTPU_NEG_INF;
          if (MASK == BIAS) sum = fmaxf(sum, ARTPU_NEG_INF);
          if (FUSED) {
            float* ls = list_s(qi);
            int* li = list_i(qi);
            const float s = lane < g.nd ? sum : -INFINITY;
            float kth = ls[a.k - 1];
            unsigned want = __ballot_sync(FULL, s > kth);
            while (want) {
              const int src = __ffs(want) - 1;
              want &= want - 1;
              const float cs = __shfl_sync(FULL, s, src);
              if (cs > kth) {
                list_insert(ls, li, a.k, cs, base + src, lane);
                kth = ls[a.k - 1];
              }
            }
          } else if (lane < g.nd) {
            a.out_s[(size_t)b * a.N + base + lane] = sum;
          }
        }
        consumer_sync();  // rm is free for the next pass
      }
    }
    if (FUSED) {
      for (int qi = warp; qi < blk.y; qi += CWARPS) {
        const float* ls = list_s(qi);
        const int* li = list_i(qi);
        const size_t o = ((size_t)(blk.x + qi) * a.parts + p) * a.k;
        for (int i = lane; i < a.k; i += 32) {
          const float v = ls[i];
          const int id = li[i];
          a.out_s[o + i] = v == -INFINITY ? ARTPU_NEG_INF : v;
          a.out_i[o + i] = id;
        }
      }
      __syncwarp();
    }
  }
}

template <class Op, bool FUSED, int MASK>
int launch(const void* qp, const void* docs, const void* aux, const int* table, void* out_s,
           void* out_i, int B, int N, int Td, int d, int q_rows, int k, int blocks, int parts,
           int part_docs, int grid, int stages, int resident, int smem_lists, int smem_bytes,
           void* stream) {
  if (B == 0 || N == 0) return 0;
  if (Td < 1 || d < 8 || d % 8 || q_rows < Op::ROWS || q_rows % Op::ROWS || blocks < 1 ||
      grid < 1 || stages < 2 || part_docs < 1 || part_docs % GROUP || (long long)N * Td > 2147483647LL ||
      (FUSED ? k < 1 : k != 0) || (!FUSED && smem_lists) || (MASK != LENS && !FUSED) ||
      (MASK != LANE && aux == nullptr))
    return (int)cudaErrorInvalidValue;
  // the parts cover the N documents exactly, none empty
  if (parts < 1 || (long long)(parts - 1) * part_docs >= N || (long long)parts * part_docs < N)
    return (int)cudaErrorInvalidValue;
  const int k_boxes = (d * (int)sizeof(typename Op::T) + 127) / 128;
  const long long want =
      layout_bytes(Op::ROWS, k_boxes, stages, resident != 0, smem_lists != 0, k);
  if (want != smem_bytes || want > SMEM_MAX) return (int)cudaErrorInvalidValue;
  CUtensorMap map_q = {}, map_d = {};
  if (!tma_map_2d(&map_q, Op::TYPE, sizeof(typename Op::T), qp, q_rows, d, Op::BOX_K, Op::ROWS) ||
      !tma_map_2d(&map_d, Op::TYPE, sizeof(typename Op::T), docs, (long long)N * Td, d, Op::BOX_K,
                  CHUNK))
    return (int)cudaErrorInvalidValue;
  auto kernel = maxsim_tile_kernel<Op, FUSED, MASK>;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (e != cudaSuccess) return (int)e;
  const int live = d - (k_boxes - 1) * Op::BOX_K;
  Args a{aux, table, table + 4 * blocks, (float*)out_s, (int*)out_i, N, Td, k, blocks, parts,
         part_docs, k_boxes, live, stages, resident, smem_lists};
  kernel<<<(unsigned)grid, THREADS, smem_bytes, (cudaStream_t)stream>>>(a, map_q, map_d);
  return (int)cudaGetLastError();
}

template <class Op, bool FUSED, int MASK>
int blocks_per_sm(int smem_bytes, int* blocks) {
  auto kernel = maxsim_tile_kernel<Op, FUSED, MASK>;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, THREADS, smem_bytes);
}

// Resident blocks an SM holds at `smem_bytes` of one Mask's fused
// instantiation (or, for LENS, its scores one) in f32 or bf16: the occupancy
// calculator, from the kernel's registers and shared memory. Returns the
// CUDA error.
template <int MASK>
int blocks_per_sm_of(int bf16, int fused, int smem_bytes, int* blocks) {
  if constexpr (MASK == LENS) {
    if (!fused) {
      return bf16 ? blocks_per_sm<BF16, false, LENS>(smem_bytes, blocks)
                  : blocks_per_sm<F32, false, LENS>(smem_bytes, blocks);
    }
  } else if (!fused) {
    return (int)cudaErrorInvalidValue;
  }
  return bf16 ? blocks_per_sm<BF16, true, MASK>(smem_bytes, blocks)
              : blocks_per_sm<F32, true, MASK>(smem_bytes, blocks);
}

}  // namespace mtile

// qp [q_rows, d] packed query rows; docs [N, Td, d]; aux as the launcher's
// Mask reads it (dlens [N] int32, bias [N, Td] f32, or none); table the
// plan's int32 [blocks, 4] then [B, 2]; d % 8 == 0, 16-byte aligned. Fused:
// out_s / out_i [B, parts, k] with part p covering documents
// [p*part_docs, (p+1)*part_docs), any k >= 1. Scores (LENS only): out_s
// [B, N], k = 0. grid, stages, resident, smem_lists and smem_bytes come from
// the plan; the launch is refused unless smem_bytes equals this layout's
// count. Each returns cudaGetLastError().
#define MAXSIM_LAUNCHER(name, Op, FUSED, MASK)                                                 \
  extern "C" int name(const void* qp, const void* docs, const void* aux, const int* table,     \
                      void* out_s, void* out_i, int B, int N, int Td, int d, int q_rows, int k, \
                      int blocks, int parts, int part_docs, int grid, int stages, int resident, \
                      int smem_lists, int smem_bytes, void* stream) {                          \
    return mtile::launch<mtile::Op, FUSED, mtile::MASK>(                                       \
        qp, docs, aux, table, out_s, out_i, B, N, Td, d, q_rows, k, blocks, parts, part_docs,  \
        grid, stages, resident, smem_lists, smem_bytes, stream);                               \
  }
