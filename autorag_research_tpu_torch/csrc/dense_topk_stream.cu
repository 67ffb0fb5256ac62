// dense_topk_stream: tiled exact dense scoring with a streaming top-k.
//
// Replaces autorag_research_tpu/ops/dense.py::_dense_topk_kernel (line 166,
// Pallas, called at line 240 by dense_topk_pallas). For queries q [Q, d] and
// a corpus c [N, d] (both f32, or both bf16; d a multiple of 8) each block
// owns a 128-query tile and one contiguous part of the corpus rows, scores it
// 128 rows at a time and keeps, per query row, the k best (score, id) pairs
// of its part in (-score, id) order. Blocks run in parallel, so the output is
// P partial lists per row, [Q, P, k], which the wrapper merges with
// merge_topk. The tile plan (part_rows, parts, where the lists live, the
// shared-memory bytes) is ops/dense.py::dense_stream_plan; the launcher
// refuses a plan whose bytes differ from this layout's count.
//
// Arithmetic: f32 inputs are scored in true f32 on the CUDA cores (FFMA
// only; no TF32, no tensor cores), as the exact paths require. bf16 inputs
// use mma.sync m16n8k16 with f32 accumulation.
//
// Bound on this card: at Q = 2,048, N = 500,000, d = 768 in f32 the work is
// 1.57e12 FLOP, 23.5 ms at the 67 TFLOP/s FP32 rate, against 1.5 GB of
// corpus reads (0.46 ms), so it is bound by FP32 operations: every
// instruction slot that is not an FFMA is lost, and so is every cycle the FMA
// pipes wait.
//
// Design.
// - Mainloop (f32). A 128 x 128 block tile; each of 256 threads holds an
//   8 x 8 accumulator: rows ty + 16 i and columns tx + 16 j (i, j < 8; a warp
//   spans 4 ty x 8 tx). Per 4 k-columns a thread loads its 8 rows' and 8
//   columns' k-quads (16 LDS.128) and runs 256 FFMA, so 4 LDS.128 feed 64
//   FFMA, and each LDS.128 of a warp reads 4 or 8 different 16-byte chunks,
//   broadcast within the warp.
// - Staging (f32). Slices of 32 k-columns of both operands come by TMA: one
//   thread asks for a box of 128 rows x 32 floats of each tensor map into a
//   ring of 3 slots, counted on the slot's mbarrier; the ring runs on across
//   tile boundaries, so two slices are in flight while one is multiplied and
//   the next tile's first slices land during the epilogue. Rows past Q or N
//   and columns past d land as zeros. cp.async cannot transpose, and the
//   fragments of a transposed tile would want 4 consecutive rows of one k in
//   one LDS.128; of the two ways open (4-byte cp.async into transposed
//   positions, or a row-major layout read with a swizzle) the second is taken,
//   with the swizzle TMA applies itself: a box row is 128 bytes whose 16-byte
//   chunk c lands at c ^ (row % 8), and a thread's rows ty + 16 i all share
//   row % 8 = ty % 8, so its k-quad kq sits at chunk kq ^ (ty % 8) in every
//   row and the 4 (8) rows a warp reads at once fall in 4 (8) different chunks
//   of the 32 banks. Transposed staging by 4-byte cp.async spent more time in
//   its copies (16 a thread per 16 k-columns) than TMA costs, and row-major
//   16-byte cp.async at a padded stride still paid its copy instructions
//   (PERF.md §6).
// - Mainloop and staging (bf16). The same block tile and ring: 8 warps of
//   64 x 32 (4 x 4 mma tiles), row-major slices of 32 k staged by 16-byte
//   cp.async.
// - Epilogue. Each thread tests its 64 accumulators against the k-th entry
//   of their rows (held in shared memory, read by broadcast), in (-score,
//   id) order; a row slot whose largest score is below it costs 7 FMNMX and
//   one compare. Only a score that beats it leaves the registers: it is
//   appended with its id to its row's buffer of 32 entries in shared memory
//   through a shared counter (atomicAdd). Then one warp per row with a full
//   enough buffer merges it into the row's list: a bitonic sort of the
//   buffer by (score desc, id asc) across the lanes, a binary search of each
//   candidate's rank, and one shift of the list entries below the first
//   rank (each moves down by the candidates above it, four 32-entry chunks
//   loaded a batch), as bm25_hash.cuh's merge_buffer does. A dense copy is
//   kept rather than that function: the buffer fills in atomic order and a
//   tile may bring more than 32 candidates of a row, so its rounds need not
//   arrive in id order, and this merge compares (score, id) pairs everywhere
//   where merge_buffer relies on ids that follow the list's.
//   - A cold list: a tile may offer up to 128 candidates of one row. What the
//     buffer cannot take stays in the thread's pending mask; after the merge
//     has raised the k-th entry, the rest are tested again, in rounds, until
//     none is left.
//   - Ties: a block walks its rows in increasing order and the test is
//     strict in (-score, id) order, so an equal score from a later tile never
//     enters, and inside one buffer the sort's id key restores the order.
// - A buffer is merged once it holds 8 candidates (32 where the lists live
//   in the output), and every buffer at the part's end: the k-th entry lags
//   by at most 7 (31) candidates, so a few more scores pass, but a merge
//   round costs the block three barriers, and merging each tile's first
//   candidate at once spent more time in them than the extra candidates
//   cost. Lists live in shared memory while 128 x k x 8 bytes fit beside
//   the ring and the buffers (k <= 95 in f32, 131 in bf16); beyond that in
//   place in the output, L2-cached, where a list of 1,000 entries is shifted
//   about 32 times less often than one insertion at a time would.
// - Occupancy: one block an SM (8 warps, up to 255 registers a thread);
//   ops/dense.py reads the count (dense_topk_stream_blocks_per_sm) and plans
//   parts so that q_tiles x parts fill one wave.

#include "common.cuh"
#include "tma.cuh"

namespace {

constexpr int BQ = 128;  // queries of a block tile
constexpr int BN = 128;  // corpus rows of a block tile
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int STAGES = 3;  // slots of the staging ring
constexpr int CAP = 32;  // candidate buffer entries per row
// a row's buffer is merged once it holds this many candidates: lists in
// shared memory, lists in the output (and every buffer at a part's end)
constexpr int FLUSH_SHARED = 8, FLUSH_GLOBAL = CAP;
constexpr long long SMEM_MAX = 232448;  // a block's shared memory on sm_90

// f32 slice: TMA boxes of 128 rows x 32 floats, queries then corpus
constexpr int BK32 = 32;
constexpr int STAGE_F32 = 2 * BQ * BK32 * 4;
// bf16 slice: A [BQ][LDH] then B [BN][LDH]
constexpr int BK16 = 32;
constexpr int LDH = BK16 + 8;
constexpr int STAGE_BF16 = 2 * BQ * LDH * 2;
// the ring starts at a 1,024-byte boundary (TMA's 128-byte swizzle repeats
// every 1,024 bytes); the slots' barriers follow it
constexpr int ALIGN_SLACK = 1024;
constexpr int BAR_BYTES = 64;
// kth_s, kth_i, cnt, len [BQ] each, then the buffers [BQ][CAP] of scores and ids
constexpr int EPI_BYTES = 4 * BQ * 4 + 2 * BQ * CAP * 4;

long long layout_bytes(int stage_bytes, int k, bool smem_lists) {
  return ALIGN_SLACK + (long long)STAGES * stage_bytes + BAR_BYTES + EPI_BYTES +
         (smem_lists ? (long long)BQ * k * 8 : 0);
}

__device__ __forceinline__ void cp_async16(void* s, const void* g, bool pred) {
  const unsigned sa = (unsigned)__cvta_generic_to_shared(s);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(sa), "l"(g),
               "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// ---- f32: FFMA on the CUDA cores, 8 x 8 accumulators a thread, TMA staging
struct F32 {
  using T = float;
  static constexpr int BK = BK32;
  static constexpr int STAGE = STAGE_F32;
  static constexpr bool TMA = true;
  struct Src {};  // TMA needs no per-thread source rows

  __device__ static int ty(int tid) { return ((tid >> 5) >> 1) * 4 + ((tid & 31) >> 3); }
  __device__ static int tx(int tid) { return ((tid >> 5) & 1) * 8 + (tid & 7); }

  // k-quad kq of box row r sits at 16-byte chunk kq ^ (r % 8)
  __device__ static void compute(const unsigned char* st, float (&acc)[64], int tid) {
    const int ra = ty(tid), rb = tx(tid);
    const float* As = reinterpret_cast<const float*>(st) + ra * BK32;
    const float* Bs = reinterpret_cast<const float*>(st) + (BQ + rb) * BK32;
#pragma unroll
    for (int kq = 0; kq < BK32 / 4; ++kq) {
      const int ca = (kq ^ (ra & 7)) * 4, cb = (kq ^ (rb & 7)) * 4;
      float4 a[8], b[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = *reinterpret_cast<const float4*>(As + 16 * i * BK32 + ca);
#pragma unroll
      for (int j = 0; j < 8; ++j) b[j] = *reinterpret_cast<const float4*>(Bs + 16 * j * BK32 + cb);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i * 8 + j] = fmaf(a[i].x, b[j].x, acc[i * 8 + j]);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i * 8 + j] = fmaf(a[i].y, b[j].y, acc[i * 8 + j]);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i * 8 + j] = fmaf(a[i].z, b[j].z, acc[i * 8 + j]);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i * 8 + j] = fmaf(a[i].w, b[j].w, acc[i * 8 + j]);
    }
  }

  // The thread's 8 row slots hold 8 accumulators each: idx_of(slot, j) is
  // slot * 8 + j, at tile row row_at(slot) and column col_at(idx).
  __device__ static constexpr int idx_of(int slot, int j) { return slot * 8 + j; }
  __device__ static int row_at(int slot, int tid) { return ty(tid) + 16 * slot; }
  __device__ static int col_at(int idx, int tid) { return tx(tid) + 16 * (idx & 7); }
};

// ---- bf16: mma.sync m16n8k16, f32 accumulation; warp tile 64 x 32
struct BF16 {
  using T = __nv_bfloat16;
  static constexpr int BK = BK16;
  static constexpr int STAGE = STAGE_BF16;
  static constexpr bool TMA = false;
  // 16-byte chunks of each operand a thread copies per slice
  static constexpr int ROWS = BQ * (BK16 / 8) / THREADS;

  // chunk v = tid + 256 j: row v / 4, k-columns 8 (v % 4) of the slice
  struct Src {
    const __nv_bfloat16* a[ROWS];
    const __nv_bfloat16* b[ROWS];
    unsigned ok;
  };

  __device__ static void src_a(Src& s, const __nv_bfloat16* q, int q0, int Q, int d, int tid) {
#pragma unroll
    for (int j = 0; j < ROWS; ++j) {
      const int v = tid + j * THREADS;
      const bool ok = q0 + (v >> 2) < Q;
      s.a[j] = ok ? q + (size_t)(q0 + (v >> 2)) * d + (v & 3) * 8 : q;
      s.ok = (s.ok & ~(1u << j)) | ((unsigned)ok << j);
    }
  }

  __device__ static void src_b(Src& s, const __nv_bfloat16* c, int c0, int c_lim, int d,
                               int tid) {
#pragma unroll
    for (int j = 0; j < ROWS; ++j) {
      const int v = tid + j * THREADS;
      const bool ok = c0 + (v >> 2) < c_lim;
      s.b[j] = ok ? c + (size_t)(c0 + (v >> 2)) * d + (v & 3) * 8 : c;
      s.ok = (s.ok & ~(1u << (ROWS + j))) | ((unsigned)ok << (ROWS + j));
    }
  }

  __device__ static void load(unsigned char* st, const Src& s, int k0, int d, int tid) {
    __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(st);
    __nv_bfloat16* Bs = As + BQ * LDH;
#pragma unroll
    for (int j = 0; j < ROWS; ++j) {
      const int v = tid + j * THREADS;
      const int off = (v >> 2) * LDH + (v & 3) * 8;
      const bool kin = k0 + (v & 3) * 8 < d;
      const bool qa = kin && ((s.ok >> j) & 1u);
      cp_async16(As + off, qa ? s.a[j] + k0 : s.a[j], qa);
      const bool cb = kin && ((s.ok >> (ROWS + j)) & 1u);
      cp_async16(Bs + off, cb ? s.b[j] + k0 : s.b[j], cb);
    }
  }

  __device__ static void compute(const unsigned char* st, float (&acc)[64], int tid) {
    const __nv_bfloat16* As = reinterpret_cast<const __nv_bfloat16*>(st);
    const __nv_bfloat16* Bs = As + BQ * LDH;
    const int lane = tid & 31, warp = tid >> 5;
    const int m0 = (warp & 1) * 64, n0 = (warp >> 1) * 32;
#pragma unroll
    for (int kk = 0; kk < BK16; kk += 16) {
      uint32_t a[4][4], b[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) load_a_frag(a[mi], As, LDH, m0 + mi * 16, kk, lane);
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) load_b_frag(b[ni], Bs, LDH, n0 + ni * 8, kk, lane);
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_bf16_16816(acc + (mi * 4 + ni) * 4, a[mi], b[ni]);
    }
  }

  // accumulator idx = (mi * 4 + ni) * 4 + e (the mma C fragment's layout):
  // slot = 2 mi + e / 2 holds row m0 + 16 mi + g + 8 (e / 2); its j-th entry
  // is ni = j / 2, e = 2 (slot % 2) + j % 2
  __device__ static constexpr int idx_of(int slot, int j) {
    return ((slot >> 1) * 4 + (j >> 1)) * 4 + 2 * (slot & 1) + (j & 1);
  }
  __device__ static int row_at(int slot, int tid) {
    const int lane = tid & 31;
    return ((tid >> 5) & 1) * 64 + (slot >> 1) * 16 + (lane >> 2) + 8 * (slot & 1);
  }
  __device__ static int col_at(int idx, int tid) {
    const int lane = tid & 31;
    return ((tid >> 5) >> 1) * 32 + ((idx >> 2) & 3) * 8 + 2 * (lane & 3) + (idx & 1);
  }
};

__device__ __forceinline__ bool before(float s, int id, float os, int oid) {
  return s > os || (s == os && id < oid);
}

// Merge a row's buffered candidates (bs, bi: m of them, 1 <= m <= 32, in any
// order) into its list (ls, li: `filled` entries in (-score, id) order, room
// for k), keeping the first k. Called by all 32 lanes of a warp. Every
// comparison takes (score, id) pairs, so candidates need not follow the
// list's ids.
__device__ void merge_candidates(float* ls, int* li, int k, int filled, float* bs, int* bi, int m,
                                 int lane) {
  const unsigned full = 0xffffffffu;
  float s = lane < m ? bs[lane] : -INFINITY;
  int r = lane < m ? bi[lane] : ARTPU_INT_MAX;
  for (int size = 2; size <= 32; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const float os = __shfl_xor_sync(full, s, stride);
      const int orow = __shfl_xor_sync(full, r, stride);
      const bool first = before(s, r, os, orow);
      const bool up = (lane & size) == 0, lower = (lane & stride) == 0;
      if ((first == up) != lower) {
        s = os;
        r = orow;
      }
    }
  }
  __syncwarp();
  if (lane < m) {
    bs[lane] = s;
    bi[lane] = r;
  }
  int rank = filled;  // list entries before the candidate
  if (lane < m) {
    int lo = 0, hi = filled;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (before(ls[mid], li[mid], s, r)) lo = mid + 1;
      else hi = mid;
    }
    rank = lo;
  }
  __syncwarp();
  const int first = __shfl_sync(full, rank, 0);
  const int low = first & ~31;
  // entries [first, filled) move down by the candidates before them, top
  // chunks first, four chunks loaded before any is stored: a batch stores at
  // or above its lowest source, which lies above every later batch's
  for (int top = (filled - 1) & ~31; filled > first && top >= low; top -= 128) {
    float v[4];
    int id[4], to[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = top - 32 * u + lane;
      to[u] = k;
      if (top - 32 * u >= low && i >= first && i < filled) {
        v[u] = ls[i];
        id[u] = li[i];
        to[u] = i;
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (to[u] < k) {
        int lo = 0, hi = m;  // the candidates before this entry
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (before(bs[mid], bi[mid], v[u], id[u])) lo = mid + 1;
          else hi = mid;
        }
        to[u] += lo;
      }
    }
    __syncwarp();
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (to[u] < k) {
        ls[to[u]] = v[u];
        li[to[u]] = id[u];
      }
    }
    __syncwarp();
  }
  if (lane < m && rank + lane < k) {
    ls[rank + lane] = s;
    li[rank + lane] = r;
  }
  __syncwarp();
}

template <class Op>
__global__ void __launch_bounds__(THREADS, 1)
dense_topk_stream_kernel(const typename Op::T* __restrict__ q, const typename Op::T* __restrict__ c,
                         float* __restrict__ out_s, int* __restrict__ out_i, int Q, int N, int d,
                         int k, int part_rows, int parts, int q_tiles, int smem_lists,
                         int flush_at, const __grid_constant__ CUtensorMap map_q,
                         const __grid_constant__ CUtensorMap map_c) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((ALIGN_SLACK - (unsigned)__cvta_generic_to_shared(smem_raw) % ALIGN_SLACK) %
                  ALIGN_SLACK);
  const unsigned bars = (unsigned)__cvta_generic_to_shared(smem + STAGES * Op::STAGE);
  float* kth_s = reinterpret_cast<float*>(smem + STAGES * Op::STAGE + BAR_BYTES);
  int* kth_i = reinterpret_cast<int*>(kth_s + BQ);
  int* cnt = kth_i + BQ;
  int* len = cnt + BQ;
  float* buf_s = reinterpret_cast<float*>(len + BQ);
  int* buf_i = reinterpret_cast<int*>(buf_s + BQ * CAP);
  float* Ls = reinterpret_cast<float*>(buf_i + BQ * CAP);  // [BQ, k] when smem_lists
  int* Li = reinterpret_cast<int*>(Ls + (smem_lists ? BQ * k : 0));

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int qt = blockIdx.x % q_tiles;
  const int p = blockIdx.x / q_tiles;
  const int q0 = qt * BQ;
  const int row_begin = p * part_rows;
  const int row_end = min(N, row_begin + part_rows);

  for (int i = tid; i < BQ; i += THREADS) {
    kth_s[i] = -INFINITY;
    kth_i[i] = ARTPU_INT_MAX;
    cnt[i] = 0;
    len[i] = 0;
  }
  // the thread's valid accumulators of a whole tile: those of its row slots
  // that hold a query
  unsigned long long valid = 0;
#pragma unroll
  for (int sl = 0; sl < 8; ++sl) {
    if (q0 + Op::row_at(sl, tid) < Q) {
#pragma unroll
      for (int j = 0; j < 8; ++j) valid |= 1ull << Op::idx_of(sl, j);
    }
  }

  const int nk = (d + Op::BK - 1) / Op::BK;
  const int n_tiles = (row_end - row_begin + BN - 1) / BN;
  typename Op::Src src{};
  if constexpr (Op::TMA) {
    if (tid == 0) {
      for (int s = 0; s < STAGES; ++s) mbar_init(bars + 8 * s, 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
  } else {
    Op::src_a(src, q, q0, Q, d, tid);
    Op::src_b(src, c, row_begin, row_end, d, tid);
  }
  int ld_tile = 0, ld_k = 0, ld_slot = 0;  // the next slice to stage
  auto stage_next = [&]() {
    if (ld_tile < n_tiles) {
      if constexpr (Op::TMA) {
        if (tid == 0) {
          const unsigned dst = (unsigned)__cvta_generic_to_shared(smem + ld_slot * Op::STAGE);
          const unsigned bar = bars + 8 * ld_slot;
          mbar_expect_tx(bar, Op::STAGE);
          tma_load_2d(dst, &map_q, bar, ld_k * Op::BK, q0);
          tma_load_2d(dst + Op::STAGE / 2, &map_c, bar, ld_k * Op::BK, row_begin + ld_tile * BN);
        }
      } else {
        Op::load(smem + ld_slot * Op::STAGE, src, ld_k * Op::BK, d, tid);
      }
      if (++ld_k == nk) {
        ld_k = 0;
        ++ld_tile;
        if constexpr (!Op::TMA) {
          if (ld_tile < n_tiles) Op::src_b(src, c, row_begin + ld_tile * BN, row_end, d, tid);
        }
      }
      ld_slot = ld_slot + 1 == STAGES ? 0 : ld_slot + 1;
    }
    if constexpr (!Op::TMA) cp_async_commit();  // an empty group past the end keeps the count
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) stage_next();

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  int slot = 0;
  unsigned phase = 0;  // parity of the slot's current fill (TMA)
  for (int tile = 0; tile < n_tiles; ++tile) {
    for (int ks = 0; ks < nk; ++ks) {
      if constexpr (!Op::TMA) cp_async_wait<STAGES - 2>();
      __syncthreads();  // every thread is done with the slot staged next
      stage_next();
      if constexpr (Op::TMA) mbar_wait(bars + 8 * slot, phase);
      Op::compute(smem + slot * Op::STAGE, acc, tid);
      if (++slot == STAGES) {
        slot = 0;
        phase ^= 1;
      }
    }

    // ---- epilogue: threshold test in registers, buffered bulk merges
    const int base = row_begin + tile * BN;
    const bool last = tile == n_tiles - 1;
    unsigned long long pending = valid;
    if (base + BN > row_end) {  // the part's ragged last tile
#pragma unroll
      for (int idx = 0; idx < 64; ++idx) {
        if (base + Op::col_at(idx, tid) >= row_end) pending &= ~(1ull << idx);
      }
    }
    while (true) {
      bool need = false, over = false;
      if (pending) {
#pragma unroll
        for (int sl = 0; sl < 8; ++sl) {
          // a slot whose largest score is below its row's k-th offers nothing
          float mx = acc[Op::idx_of(sl, 0)];
#pragma unroll
          for (int j = 1; j < 8; ++j) mx = fmaxf(mx, acc[Op::idx_of(sl, j)]);
          const int row = Op::row_at(sl, tid);
          const float ks = kth_s[row];
          if (!(mx >= ks)) continue;
          const int ki = kth_i[row];
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int idx = Op::idx_of(sl, j);
            if (!((pending >> idx) & 1ull)) continue;
            const int id = base + Op::col_at(idx, tid);
            if (before(acc[idx], id, ks, ki)) {
              const int at = atomicAdd(&cnt[row], 1);
              if (at < CAP) {
                buf_s[row * CAP + at] = acc[idx];
                buf_i[row * CAP + at] = id;
                pending &= ~(1ull << idx);
                need |= at + 1 >= flush_at;
              } else {
                over = true;  // tested again after the merge
              }
            } else {
              pending &= ~(1ull << idx);  // the k-th entry only rises
            }
          }
        }
      }
      if (!__syncthreads_or(need || over || last)) break;
      const bool more = __syncthreads_or(over);
      const int thr = last ? 1 : flush_at;
      for (int r = warp; r < BQ; r += WARPS) {
        const int n = cnt[r];
        if (n == 0 || n < thr) continue;  // warp-uniform
        const int m = min(n, CAP);
        const size_t o = ((size_t)(q0 + r) * parts + p) * k;
        float* ls = smem_lists ? Ls + r * k : out_s + o;
        int* li = smem_lists ? Li + r * k : out_i + o;
        const int filled = len[r];
        merge_candidates(ls, li, k, filled, buf_s + r * CAP, buf_i + r * CAP, m, lane);
        if (lane == 0) {
          const int nl = min(k, filled + m);
          len[r] = nl;
          cnt[r] = 0;
          if (nl == k) {
            kth_s[r] = ls[k - 1];
            kth_i[r] = li[k - 1];
          }
        }
        __syncwarp();
      }
      __syncthreads();
      if (!more) break;
    }
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  }
  if constexpr (!Op::TMA) cp_async_wait<0>();

  // the last tile flushed every buffer; write the lists with their fillers
  for (int r = warp; r < BQ; r += WARPS) {
    if (q0 + r >= Q) continue;  // warp-uniform
    const int n = len[r];
    const size_t o = ((size_t)(q0 + r) * parts + p) * k;
    for (int i = lane; i < k; i += 32) {
      float v = -INFINITY;
      int id = ARTPU_INT_MAX;
      if (i < n) {
        v = smem_lists ? Ls[r * k + i] : out_s[o + i];
        id = smem_lists ? Li[r * k + i] : out_i[o + i];
      }
      out_s[o + i] = v == -INFINITY ? ARTPU_NEG_INF : v;
      out_i[o + i] = id;
    }
  }
}

// The tensor map of a row-major [rows, d] f32 operand in boxes of 128 rows x
// 32 floats with the 128-byte swizzle; rows and columns past the operand
// land as zeros.
bool f32_map(CUtensorMap* map, const void* base, int rows, int d) {
  return tma_map_2d(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, base, rows, d, BK32, BQ);
}

template <class Op>
int launch(const void* q, const void* c, void* out_s, void* out_i, int Q, int N, int d, int k,
           int part_rows, int parts, int smem_lists, int smem_bytes, void* stream) {
  if (Q == 0 || N == 0) return 0;
  if (k < 1 || d < 8 || d % 8 || part_rows < 1 || part_rows % BN || parts < 1)
    return (int)cudaErrorInvalidValue;
  // the parts cover the N rows exactly, none empty
  if ((long long)(parts - 1) * part_rows >= N || (long long)parts * part_rows < N)
    return (int)cudaErrorInvalidValue;
  const long long want = layout_bytes(Op::STAGE, k, smem_lists != 0);
  if (want != smem_bytes || want > SMEM_MAX) return (int)cudaErrorInvalidValue;
  const int q_tiles = (Q + BQ - 1) / BQ;
  const long long blocks = (long long)q_tiles * parts;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
  CUtensorMap map_q = {}, map_c = {};
  if (Op::TMA && !(f32_map(&map_q, q, Q, d) && f32_map(&map_c, c, N, d)))
    return (int)cudaErrorInvalidValue;
  auto kernel = dense_topk_stream_kernel<Op>;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (e != cudaSuccess) return (int)e;
  kernel<<<(unsigned)blocks, THREADS, smem_bytes, (cudaStream_t)stream>>>(
      (const typename Op::T*)q, (const typename Op::T*)c, (float*)out_s, (int*)out_i, Q, N, d, k,
      part_rows, parts, q_tiles, smem_lists, smem_lists ? FLUSH_SHARED : FLUSH_GLOBAL, map_q,
      map_c);
  return (int)cudaGetLastError();
}

template <class Op>
int blocks_per_sm(int smem_bytes, int* blocks) {
  auto kernel = dense_topk_stream_kernel<Op>;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, THREADS, smem_bytes);
}

}  // namespace

// q [Q, d], c [N, d] row-major (d % 8 == 0, 16-byte aligned); outputs
// [Q, parts, k], any k >= 1, with part p covering rows [p*part_rows,
// (p+1)*part_rows) (part_rows a multiple of 128). smem_lists and smem_bytes
// come from the plan; the launch is refused unless smem_bytes equals this
// layout's count. Returns cudaGetLastError().
extern "C" int dense_topk_stream_f32_launch(const void* q, const void* c, void* out_s,
                                            void* out_i, int Q, int N, int d, int k,
                                            int part_rows, int parts, int smem_lists,
                                            int smem_bytes, void* stream) {
  return launch<F32>(q, c, out_s, out_i, Q, N, d, k, part_rows, parts, smem_lists, smem_bytes,
                     stream);
}

extern "C" int dense_topk_stream_bf16_launch(const void* q, const void* c, void* out_s,
                                             void* out_i, int Q, int N, int d, int k,
                                             int part_rows, int parts, int smem_lists,
                                             int smem_bytes, void* stream) {
  return launch<BF16>(q, c, out_s, out_i, Q, N, d, k, part_rows, parts, smem_lists, smem_bytes,
                      stream);
}

// This layout's shared-memory bytes for a block (-1 past a block's limit).
extern "C" int dense_topk_stream_smem_bytes(int bf16, int k, int smem_lists) {
  const long long b = layout_bytes(bf16 ? STAGE_BF16 : STAGE_F32, k, smem_lists != 0);
  return b > SMEM_MAX ? -1 : (int)b;
}

// Resident blocks an SM holds at `smem_bytes` (the occupancy calculator, from
// the kernel's registers and shared memory). Returns the CUDA error.
extern "C" int dense_topk_stream_blocks_per_sm(int bf16, int smem_bytes, int* blocks) {
  return bf16 ? blocks_per_sm<BF16>(smem_bytes, blocks) : blocks_per_sm<F32>(smem_bytes, blocks);
}
