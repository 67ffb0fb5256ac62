// bm25_hash: the BM25 scoring body, with a fused streaming top-k, of every
// BM25 kernel of the port. bm25_v2.cu launches it under six names, each
// replacing a kernel of autorag_research_tpu/ops/sparse.py:
//   bm25_topk_v2_launch            ::_bm25_kernel_v2, the whole-corpus walk (flat);
//   bm25_topk_v1_launch            ::_bm25_kernel, the v1 pin (the same walk);
//   bm25_topk_v2_skip_launch       ::_bm25_kernel_v2_skip, the walk skipping the
//                                  doc tiles that the Bloom predicate clears;
//   bm25_topk_packed_launch        ::_bm25_kernel_packed, the whole-corpus walk
//                                  over the lane-packed [R, 128] layout;
//   bm25_topk_probe_launch         ::_bm25_kernel_probe, the skip walk over the
//                                  doc tiles of candidate lists (positive_only);
//   bm25_topk_probe_packed_launch  ::_bm25_kernel_probe_packed, the same over
//                                  the packed layout.
// All six TPU kernels compute
//
//   score(b, n) = fold over t = 0..T-1, in order: score += m(n, q_ids[b, t]) * q_w[b, t]
//   m(n, term)  = sum of doc_w[n, l] over the slots l with doc_ids[n, l] == term, in slot order
//
// each product and each add rounded on its own (__fmul_rn / __fadd_rn: no
// FMA), so the kernel equals the plain PyTorch version bitwise. Document pads
// (-1) and query pads (-2) never match.
//
// Bound on this card: one multiply and one add per (live query term,
// document), which the rounding keeps apart, so at most 33.5 TFLOP/s (half
// the f32 FMA peak); and the slot arrays read once at 3.35 TB/s. At 1,024
// queries of about 10 live terms over 500,000 documents of 104 slots that is
// 0.3 ms of operations; at 32 queries, 0.15 ms of bytes. What bounds this
// design instead is the instruction stream: a 16-byte shared load, two
// compares and the bookkeeping of a probe for every (live query term,
// document), plus the table builds, B / QB of them per document.
//
// What the design does about it. A document's slots hold its unique terms,
// so the match weight of a query term is one lookup, not a compare against
// every slot:
// - Tiles of D consecutive documents (D a power of two <= 32) are one
//   contiguous span of D L words in each array. The next tile's span is
//   copied into shared memory with cp.async (16 bytes a copy where D L % 4
//   == 0 and the arrays are aligned, else 4) while the warps score the
//   current one: two buffers, one commit group per tile.
// - From the staged slots the block builds one open-addressing table per
//   document: H >= 2 L entries (a power of two, at least 8; the plan gives
//   about 8 L) in H / 2 buckets of two (key, weight) pairs, 16 bytes,
//   multiplicative hash, linear probing over buckets. A lookup reads one
//   bucket with one 16-byte load, which holds the weight of a hit too; a
//   bucket fills in slot order, so one whose second key is empty ends a miss,
//   and with about an eighth of the entries taken a probe rarely needs the
//   next bucket. Buckets are laid out bucket-major and document-minor:
//   bucket j of document i is 16-byte word j D + i, so the lanes that probe D
//   neighbouring documents read neighbouring banks at any j. The build gives
//   a warp's lanes neighbouring documents in the same way (a warp on one
//   document's table would hit one bank 32 times): each slot claims its
//   key's entry with atomicCAS and writes its weight beside it. A slot that
//   finds its key already taken marks its document; only then, after a
//   barrier, every slot of a marked document writes its key's slot-order sum
//   over the row (the same value from each, so the race is benign). No float
//   atomics: the table is the same on every run.
// - A block owns a query tile of QB queries (the wrapper's plan; 128 by
//   default). Their live terms sit compacted in shared memory, each with its
//   first bucket (hashed once), four terms and their weights read as three
//   16-byte broadcasts. Warp w serves queries w, w + 8, ...: its lanes take D
//   documents of 32 / D queries at once, and each lane folds its query's
//   terms in order, one probe each. So the corpus is staged B / QB times,
//   not B / 8 times as with one warp a query.
// - A lane loads the first buckets of four terms at once; a probe whose
//   first bucket is full walks on alone, so the warp waits for the few lanes
//   that collide, not for the longest of all its probes in lockstep. The four
//   products are folded in term order once all are known.
// - The epilogue: a ballot of the lanes whose score beats their list's k-th;
//   each query meets its documents in increasing row order, so ties go to
//   the lower row. Lists of up to 64 entries take each one by list_insert
//   (common.cuh). Longer lists gather up to 32
//   candidates in a buffer in shared memory and merge them in one pass
//   (merge_buffer): an insertion shifts a list of k entries, and v2's lists
//   first fill with k zero scores, so k insertions one by one cost k^2 / 32
//   steps in L2 at k = 1,000. Lists sit in shared memory when the plan finds
//   room, else in place in the output (L2-cached), so any k is served.
// - Rows too wide for even one document's table beside its staged slots
//   (the plan's `staged` = 0) take the same body with D = 1, the table in a
//   global scratch slice of the block's own, and the slots read in place.
// - The skip walk (SKIP_POS, SKIP_V2). A predicate comes as one 32-bit mask
//   per (query tile, skip tile of block_n documents): bit g is set when the
//   tile's 8-query group g may score in the skip tile (the TPU kernels' own
//   rows of 8 queries; D divides block_n, so a staged tile lies in one skip
//   tile; a part may start or end inside one). Warp w serves queries w + 8 j,
//   and query w + 8 j lies in group j, so every warp holds one query of each
//   group and a mask drops the same steps in every warp. A query whose group
//   bit is 0 probes nothing there. Two sources of masks:
//   - the Bloom predicate (ops/sparse.py::tile_group_masks; #5): some query
//     of the group may hold a term of the skip tile. A query whose bit is 0
//     scores exactly 0 on every document there (the filter has no false
//     negatives);
//   - candidate lists (ops/sparse.py::probe_group_masks; the probes #6,
//     #8, positive_only only): the group's list holds the skip tile. A query
//     whose bit is 0 must not score there at all, which positive_only gives.
//   positive_only (SKIP_POS): only scores > 0 enter a list (held at -inf; an
//   unfilled entry leaves as (0.0, INT_MAX)), so such a query offers nothing,
//   and a skip tile whose mask is 0 is neither staged nor given tables: the
//   cp.async prefetch jumps to the next tile some group needs. Each block
//   takes an equal share of the documents its query tile stages
//   (staged_bounds, from a scan of the masks), not of all N, so sparse
//   masks (the probes' lists) do not leave most blocks idle. v2 mode
//   (SKIP_V2): the lists are #3's, zero fill included, so a query whose bit
//   is 0 offers its zeros until its list holds a k-th score > 0; a tile is
//   skipped where its mask is 0 and every list of the block held a k-th > 0
//   when its prefetch was decided (a vote at the barrier before). Lists only
//   rise, so the decision is safe; a tile prefetched before the last lists
//   warmed costs a copy and a table build, never a result.
// - The packed layout (PACKED): ops/sparse.py::pack_slots's [R, 128] rows
//   hold P documents at stride L = 128 / P. Where P is a power of two the
//   rows are the flat [R P, L] array, and the wrapper launches the flat walk
//   on that view. Otherwise (P = 3, 5, 6, 7, ..., 42) a tile of D documents
//   stages the whole rows it lies in, 512 bytes each (16-byte cp.async at
//   any P), at most (P - gcd(D, P) + D - 1) / P + 1 rows: slot l of document
//   n is staged word (n / P - the tile's first row) 128 + (n mod P) L + l,
//   an offset the block writes per tile. The 128 - P L dead lanes are never
//   read. A tile of whole rows instead would hold at most 32 / P rows, none
//   at P = 42, and leave table entries of a power-of-two D empty. The whole
//   walk (#7) and the positive_only skip walk (the packed probe, #8) take
//   this layout.
// Outputs: per-part lists [B, parts, k] in (-score, row) order, merged by the
// wrapper with merge_topk.
#pragma once

#include "common.cuh"

namespace bm25_hash {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int DOC_PAD = -1;  // never inserted; the empty table key
constexpr int QUERY_PAD = -2;
constexpr int TMAX = 2048;
constexpr int MAX_DOCS = 32;
constexpr long long SMEM_MAX = 232448;  // a block's shared memory on sm_90
constexpr int K_DIRECT = 64;  // lists up to this long take list_insert directly
constexpr int CAP = 32;       // candidates a longer list buffers before a merge
constexpr int QB_MAX = THREADS;  // a query tile's 8-query groups fit a 32-bit mask
constexpr int PACKED_LANES = 128;  // words in a packed row

__host__ __device__ inline long long carve(long long& off, long long bytes) {
  const long long o = off;
  off += (bytes + 15) / 16 * 16;
  return o;
}

enum Walk { FULL = 0, SKIP_POS = 1, SKIP_V2 = 2 };

__host__ __device__ inline int gcd(int a, int b) {
  while (b) {
    const int r = a % b;
    a = b;
    b = r;
  }
  return a;
}

// Words of one staged tile of D documents: D rows of L slots, or in the
// packed layout (pack P > 1) the whole 128-word rows they lie in.
__host__ __device__ inline long long stage_words(int D, int L, int pack) {
  if (pack == 1) return (long long)D * L;
  return (long long)((pack - gcd(D, pack) + D - 1) / pack + 1) * PACKED_LANES;
}

// Byte offsets of the dynamic shared memory regions, each rounded to 16
// bytes; ops/sparse.py::_hash_smem computes the same total.
struct Layout {
  // staged buffer s (0, 1): ids at raw + 2 s buf, weights at raw + (2 s + 1) buf
  long long tab, raw, buf, dup, doff, q_id, q_w, q_n, ls, li, bs, bi, bn, total;
  __host__ __device__ Layout(int D, int H, int L, int T, int QB, int k, int list_smem,
                             int staged, int pack) {
    long long off = 0;
    const long long dh = staged ? (long long)D * H : 0;
    const long long dl = staged ? stage_words(D, L, pack) : 0;
    tab = carve(off, dh * 8);
    buf = (dl * 4 + 15) / 16 * 16;
    raw = carve(off, 4 * buf);
    dup = carve(off, MAX_DOCS * 4);
    doff = carve(off, pack > 1 ? MAX_DOCS * 4 : 0);  // the packed tile's document offsets
    // (term, first bucket << log D) pairs and weights, rows of T rounded up to 4
    q_id = carve(off, (long long)QB * ((T + 3) / 4 * 4) * 8);
    q_w = carve(off, (long long)QB * ((T + 3) / 4 * 4) * 4);
    q_n = carve(off, (long long)QB * 4);
    const long long lk = list_smem ? (long long)QB * k : 0;
    ls = carve(off, lk * 4);
    li = carve(off, lk * 4);
    const long long lb = k > K_DIRECT ? (long long)QB : 0;  // candidate buffers
    bs = carve(off, lb * CAP * 4);
    bi = carve(off, lb * CAP * 4);
    bn = carve(off, lb * 4);
    total = off;
  }
};

__device__ __forceinline__ unsigned bucket_of(int key, int log_nb) {
  return ((unsigned)key * 2654435769u) >> (32 - log_nb);
}

// The filled length of a list (its entries > -inf, a prefix), found 32
// chunks per ballot: two ballots for k <= 1,024. Called by all 32 lanes.
__device__ __forceinline__ int filled_len(const float* ls, int k, int lane) {
  const unsigned full = 0xffffffffu;
  int lo = 0, n = k;  // entries [0, lo) are filled, entries [lo + n, k) are not
  while (n > 32) {
    const int step = (n + 31) >> 5;
    const int last = min(lo + (lane + 1) * step, lo + n) - 1;
    const int c = __popc(__ballot_sync(full, lane * step < n && ls[last] > -INFINITY));
    const int nlo = min(lo + c * step, lo + n);  // the last chunk may be short
    n = max(0, min(step, lo + n - nlo));
    lo = nlo;
  }
  return lo + __popc(__ballot_sync(full, lane < n && ls[lo + lane] > -INFINITY));
}

// Merge a query's buffered candidates (bs, bi: m of them, 1 <= m <= 32,
// every row after the list's rows) into its list (ls, li: k entries in
// (-score, row) order, -inf past the filled ones), keeping the first k.
// Called by all 32 lanes of a warp. The candidates are sorted across the
// lanes (bitonic); each lands after the list entries >= its score (a
// binary search), and each list entry from the first landing place on moves
// down by the candidates above it, high chunks first. One merge of m
// candidates shifts the list once, where m insertions would shift it m times.
__device__ void merge_buffer(float* ls, int* li, int k, float* bs, int* bi, int m, int lane) {
  const unsigned full = 0xffffffffu;
  float s = lane < m ? bs[lane] : -INFINITY;
  int r = lane < m ? bi[lane] : ARTPU_INT_MAX;
  for (int size = 2; size <= 32; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const float os = __shfl_xor_sync(full, s, stride);
      const int orow = __shfl_xor_sync(full, r, stride);
      const bool before = s > os || (s == os && r < orow);
      const bool up = (lane & size) == 0, lower = (lane & stride) == 0;
      if ((before == up) != lower) {
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
  const int filled = filled_len(ls, k, lane);
  int rank = filled;  // the list entries >= s come first (their rows are lower)
  if (lane < m) {
    int lo = 0, hi = filled;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (ls[mid] >= s) lo = mid + 1;
      else hi = mid;
    }
    rank = lo;
  }
  __syncwarp();
  const int first = __shfl_sync(full, rank, 0);
  for (int c0 = (filled - 1) & ~31; filled > first && c0 >= (first & ~31); c0 -= 32) {
    const int i = c0 + lane;
    const bool mv = i >= first && i < filled;
    float v = 0.f;
    int id = 0, to = k;
    if (mv) {
      v = ls[i];
      id = li[i];
      int lo = 0, hi = m;  // the candidates above v
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (bs[mid] > v) lo = mid + 1;
        else hi = mid;
      }
      to = i + lo;
    }
    __syncwarp();
    if (mv && to < k) {
      ls[to] = v;
      li[to] = id;
    }
    __syncwarp();
  }
  if (lane < m && lane + rank < k) {
    ls[lane + rank] = s;
    li[lane + rank] = r;
  }
  __syncwarp();
}

__device__ __forceinline__ void cp_async16(void* s, const void* g) {
  const unsigned sa = (unsigned)__cvta_generic_to_shared(s);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(sa), "l"(g));
}

__device__ __forceinline__ void cp_async4(void* s, const void* g) {
  const unsigned sa = (unsigned)__cvta_generic_to_shared(s);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(sa), "l"(g));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait1() { asm volatile("cp.async.wait_group 1;\n" ::); }

// Copy `words` words of each array from word `off` into the staged buffers:
// 16-byte copies when vec (off is then a multiple of 4), the tail past the
// last multiple of 4 in 4-byte ones.
__device__ __forceinline__ void stage(const int* __restrict__ doc_ids,
                                      const float* __restrict__ doc_w, long long off, int words,
                                      bool vec, int* s_ids, float* s_w, int tid) {
  const int w4 = vec ? words & ~3 : 0;
  for (int v = tid * 4; v < w4; v += THREADS * 4) {
    cp_async16(s_ids + v, doc_ids + off + v);
    cp_async16(s_w + v, doc_w + off + v);
  }
  for (int v = w4 + tid; v < words; v += THREADS) {
    cp_async4(s_ids + v, doc_ids + off + v);
    cp_async4(s_w + v, doc_w + off + v);
  }
}

// The positive_only skip walk's part p of `parts`: the documents [x(p W /
// parts), x((p + 1) W / parts)) of the query tile's walk, W the documents of
// the skip tiles whose mask `mrow` is not 0 (the only ones staged) and x(c)
// the place of staged document c rounded down to a multiple of D; part 0
// starts at 0 and the last ends at N. So every part stages about W / parts
// documents: parts of N / parts documents each leave those over unlisted
// skip tiles idle and the others as long as ever. Called by the whole
// block; `scratch`: WARPS + 2 ints of shared memory.
__device__ void staged_bounds(const unsigned* __restrict__ mrow, int n_tiles, int block_n, int N,
                              int p, int parts, int log_d, int* scratch, int& begin, int& end) {
  const unsigned full = 0xffffffffu;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int chunk = (n_tiles + THREADS - 1) / THREADS;  // this thread's skip tiles [j0, j1)
  const int j0 = min(n_tiles, tid * chunk), j1 = min(n_tiles, j0 + chunk);
  auto staged = [&](int j) { return __ldg(mrow + j) ? min(block_n, N - j * block_n) : 0; };
  int mine = 0;
  for (int j = j0; j < j1; ++j) mine += staged(j);
  int incl = mine;  // a scan over the warp, then over the warps
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(full, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) scratch[warp] = incl;
  __syncthreads();
  int first = incl - mine, total = 0;  // staged documents before this thread's tiles, and in all
  for (int w = 0; w < WARPS; ++w) {
    const int v = scratch[w];
    if (w < warp) first += v;
    total += v;
  }
  if (tid < 2) scratch[WARPS + tid] = N;  // a target past the last staged document
  __syncthreads();
  for (int e = 0; e < 2; ++e) {
    const int c = (int)((long long)(p + e) * total / parts);
    if (c >= first && c < first + mine) {  // staged document c lies in this thread's tiles
      int acc = first;
      for (int j = j0; j < j1; ++j) {
        const int s = staged(j);
        if (c < acc + s) {
          scratch[WARPS + e] = j * block_n + (((c - acc) >> log_d) << log_d);
          break;
        }
        acc += s;
      }
    }
  }
  __syncthreads();
  begin = p == 0 ? 0 : scratch[WARPS];
  end = p == parts - 1 ? N : scratch[WARPS + 1];
  __syncthreads();  // the scratch is free again
}

template <bool STAGED, int WALK, bool PACKED>
__global__ void __launch_bounds__(THREADS, 2)
bm25_hash_kernel(const int* __restrict__ q_ids, const float* __restrict__ q_w,
                 const int* __restrict__ doc_ids, const float* __restrict__ doc_w,
                 const unsigned* __restrict__ masks, float* __restrict__ out_s,
                 int* __restrict__ out_i, int* __restrict__ g_tab,
                 unsigned long long* __restrict__ stats, int B, int T, int N, int L, int k,
                 int part, int parts, int q_tiles, int QB, int log_d, int log_h, int list_smem,
                 int vec, int block_n, int n_tiles, int pack) {
  extern __shared__ __align__(16) unsigned char dyn[];
  const Layout lay(1 << log_d, 1 << log_h, L, T, QB, k, list_smem, STAGED, PACKED ? pack : 1);
  const int D = 1 << log_d, H = 1 << log_h;
  const int log_nb = log_h - 1;  // buckets of two entries
  const unsigned nbmask = (1u << log_nb) - 1;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int qt = blockIdx.x % q_tiles;
  const int p = blockIdx.x / q_tiles;
  const unsigned full = 0xffffffffu;
  // bucket j of document i: (k0, w0, k1, w1) at tab[(j << log_d) + i]
  int4* tab = STAGED ? reinterpret_cast<int4*>(dyn + lay.tab)
                     : reinterpret_cast<int4*>(g_tab + (size_t)blockIdx.x * 2 * H);
  int* s_dup = reinterpret_cast<int*>(dyn + lay.dup);
  int* s_off = reinterpret_cast<int*>(dyn + lay.doff);  // PACKED: document i's first staged slot
  int2* sq_id = reinterpret_cast<int2*>(dyn + lay.q_id);
  float* sq_w = reinterpret_cast<float*>(dyn + lay.q_w);
  int* sq_n = reinterpret_cast<int*>(dyn + lay.q_n);
  float* Ls = reinterpret_cast<float*>(dyn + lay.ls);
  int* Li = reinterpret_cast<int*>(dyn + lay.li);
  float* Bs = reinterpret_cast<float*>(dyn + lay.bs);  // [QB, CAP] when k > K_DIRECT
  int* Bi = reinterpret_cast<int*>(dyn + lay.bi);
  int* Bn = reinterpret_cast<int*>(dyn + lay.bn);
  // query qloc of the tile (owned by warp qloc % WARPS): its list
  auto list_s = [&](int qloc) {
    return list_smem ? Ls + (size_t)qloc * k : out_s + ((size_t)(qt * QB + qloc) * parts + p) * k;
  };
  auto list_i = [&](int qloc) {
    return list_smem ? Li + (size_t)qloc * k : out_i + ((size_t)(qt * QB + qloc) * parts + p) * k;
  };
  // the weight word of `key` in document i's table (the key is there)
  auto weight_of = [&](int key, int i) {
    unsigned j = bucket_of(key, log_nb);
    while (true) {
      int* kw = reinterpret_cast<int*>(tab + (j << log_d) + i);
      if (kw[0] == key) return kw + 1;
      if (kw[2] == key) return kw + 3;
      j = (j + 1) & nbmask;
    }
  };

  // the block walks the tiles d = 0, 1, ... of D documents of its part;
  // the skip walks only those of the skip tiles they need, positive_only
  // over parts of equal staged documents
  int begin = p * part, end = min(N, begin + part);
  if (WALK == SKIP_POS) {
    staged_bounds(masks + (size_t)qt * n_tiles, n_tiles, block_n, N, p, parts, log_d, s_dup, begin,
                  end);
  }
  const int n_dt = end > begin ? (end - begin + D - 1) >> log_d : 0;
  // the mask of tile d's skip tile, documents [m_lo, m_hi): loaded, and
  // divided for, once per skip tile (a tile of D documents is a few
  // microseconds of work, a load from L2 a good part of one)
  int m_lo = 0, m_hi = 0;
  unsigned m_word = 0;
  auto tile_mask = [&](int d) {
    const int doc = begin + (d << log_d);
    if (doc < m_lo || doc >= m_hi) {
      const int j = doc / block_n;
      m_lo = j * block_n;
      m_hi = m_lo + block_n;
      m_word = __ldg(masks + (size_t)qt * n_tiles + j);
    }
    return m_word;
  };
  // the first tile after d that the walk needs, n_dt past the last; `warm`:
  // every list of the block held a k-th score > 0 (SKIP_V2)
  auto next_tile = [&](int d, bool warm) {
    ++d;
    while (WALK != FULL && d < n_dt && !(WALK == SKIP_V2 && !warm) && tile_mask(d) == 0) {
      d = (m_hi - begin) >> log_d;  // the next skip tile's first tile
    }
    return min(d, n_dt);
  };
  auto stage_tile = [&](int d, int s) {
    const int base = begin + (d << log_d);
    const int nd = min(D, end - base);
    long long off = (long long)base * L;
    int words = nd * L;
    if (PACKED) {  // the whole rows of the tile's documents
      const int r0 = base / pack;
      off = (long long)r0 * PACKED_LANES;
      words = ((base + nd - 1) / pack - r0 + 1) * PACKED_LANES;
    }
    const long long o = lay.raw + 2 * s * lay.buf;
    stage(doc_ids, doc_w, off, words, vec != 0, reinterpret_cast<int*>(dyn + o),
          reinterpret_cast<float*>(dyn + o + lay.buf), tid);
  };

  int cur = next_tile(-1, false);
  if (STAGED && cur < n_dt) stage_tile(cur, 0);  // the first tile's copy overlaps the prologue
  if (STAGED) cp_async_commit();

  // the warp's queries: live terms compacted in order (the row's tail up
  // to a multiple of 4 an empty key in bucket 0), lists reset
  const int tp = (T + 3) / 4 * 4;
  for (int qloc = warp; qloc < QB; qloc += WARPS) {
    const int b = qt * QB + qloc;
    if (b >= B) continue;  // warp-uniform
    int n = 0;
    for (int t0 = 0; t0 < T; t0 += 32) {
      const int t = t0 + lane;
      const int id = t < T ? q_ids[(size_t)b * T + t] : QUERY_PAD;
      // pads leave the fold as it is (a document pad holds weight 0)
      const bool live = id != QUERY_PAD && id != DOC_PAD;
      const unsigned m = __ballot_sync(full, live);
      if (live) {
        const int pos = n + __popc(m & ((1u << lane) - 1));
        sq_id[qloc * tp + pos] = make_int2(id, (int)(bucket_of(id, log_nb) << log_d));
        sq_w[qloc * tp + pos] = q_w[(size_t)b * T + t];
      }
      n += __popc(m);
    }
    if (lane < 4 && n + lane < tp) {
      sq_id[qloc * tp + n + lane] = make_int2(DOC_PAD, 0);
      sq_w[qloc * tp + n + lane] = 0.f;
    }
    if (lane == 0) {
      sq_n[qloc] = n;
      if (k > K_DIRECT) Bn[qloc] = 0;
    }
    float* ls = list_s(qloc);
    int* li = list_i(qloc);
    for (int i = lane; i < k; i += 32) {
      ls[i] = -INFINITY;
      li[i] = ARTPU_INT_MAX;
    }
  }
  __syncwarp();

  const int i_doc = lane & (D - 1);   // this lane's document in the tile
  const int j_sub = lane >> log_d;    // and its query among the warp's 32 / D
  const int n_sub = 32 >> log_d;
  // the warp's queries w + 8 j of the tile that exist, bit j each (query
  // w + 8 j lies in the 8-query group j: 8 warps)
  const int n_valid = max(0, min(QB, B - qt * QB));
  const int n_mine = n_valid > warp ? (n_valid - warp + WARPS - 1) / WARPS : 0;
  const unsigned mine = n_mine >= 32 ? full : (1u << n_mine) - 1;
  // skip counts (thread 0; the skip walks, when stats is given): (query,
  // document) pairs probed, and documents staged
  long long probed = 0, staged = 0;

  int slot = 0;
  while (cur < n_dt) {
    bool warm = false;
    if (WALK == SKIP_V2) {  // a vote on the lists as the last tile left them
      const bool cold = (mine >> lane & 1) && !(list_s(warp + lane * WARPS)[k - 1] > 0.f);
      warm = !__syncthreads_or(cold);
    } else {
      __syncthreads();  // the last tile's probes done
    }
    const unsigned gmask = WALK == FULL ? full : tile_mask(cur);  // groups that may match
    const int nxt = next_tile(cur, warm);
    if (STAGED) {
      if (nxt < n_dt) stage_tile(nxt, slot ^ 1);
      cp_async_commit();
      cp_async_wait1();  // this tile's group has landed (this thread's copies)
    }
    const int base = begin + (cur << log_d);
    const int nd = min(D, end - base);
    if (WALK != FULL && stats != nullptr && tid == 0) {
      int probing = 0;  // the queries of the groups that may match
      for (unsigned x = gmask; x; x &= x - 1) probing += min(8, max(0, n_valid - 8 * (__ffs(x) - 1)));
      probed += (long long)nd * probing;
      staged += nd;
    }
    {
      const int4 empty = make_int4(DOC_PAD, 0, DOC_PAD, 0);
      for (int e = tid; e < (D * H) >> 1; e += THREADS) tab[e] = empty;
      if (tid < MAX_DOCS) s_dup[tid] = 0;
      if (PACKED && tid < nd) {
        const int n = base + tid;
        s_off[tid] = (n / pack - base / pack) * PACKED_LANES + (n % pack) * L;
      }
    }
    __syncthreads();  // every copy of the tile visible, the tables empty
    const long long o = lay.raw + 2 * slot * lay.buf;
    const int* ids = STAGED ? reinterpret_cast<const int*>(dyn + o) : doc_ids + (size_t)base * L;
    const float* ws =
        STAGED ? reinterpret_cast<const float*>(dyn + o + lay.buf) : doc_w + (size_t)base * L;
    auto row = [&](int i) { return PACKED ? s_off[i] : i * L; };  // document i's first slot
    // items v = l D + i (slot l of document i): a warp's lanes work on
    // neighbouring documents, whose buckets lie in distinct banks
    const int words = L << log_d;
    // each slot claims its key's entry and writes its weight there; a slot
    // that finds its key taken marks the document
    int dup = 0;
    for (int v = tid; v < words; v += THREADS) {
      const int l = v >> log_d, i = v & (D - 1);
      if (i >= nd) continue;
      const int key = ids[row(i) + l];
      if (key == DOC_PAD) continue;
      unsigned j = bucket_of(key, log_nb);
      while (true) {
        int* kw = reinterpret_cast<int*>(tab + (j << log_d) + i);
        int old = atomicCAS(kw, DOC_PAD, key);
        if (old != DOC_PAD && old != key) {
          kw += 2;
          old = atomicCAS(kw, DOC_PAD, key);
        }
        if (old == DOC_PAD) {
          kw[1] = __float_as_int(ws[row(i) + l]);
          break;
        }
        if (old == key) {
          s_dup[i] = 1;
          dup = 1;
          break;
        }
        j = (j + 1) & nbmask;
      }
    }
    if (__syncthreads_or(dup)) {
      // a repeated term: each slot of a marked document writes its key's
      // sum over the row in slot order (the plain version's sum)
      for (int v = tid; v < words; v += THREADS) {
        const int l = v >> log_d, i = v & (D - 1);
        if (i >= nd || !s_dup[i]) continue;
        const int r = row(i);
        const int key = ids[r + l];
        if (key == DOC_PAD) continue;
        float s = 0.f;
        for (int l2 = 0; l2 < L; ++l2) {
          if (ids[r + l2] == key) s = __fadd_rn(s, ws[r + l2]);
        }
        *weight_of(key, i) = __float_as_int(s);
      }
      __syncthreads();
    }

    // the warp's queries on this tile: those of groups that may match, and
    // in v2 mode also those whose lists still take a zero
    const unsigned probe = mine & gmask;
    unsigned act = probe;
    if (WALK == FULL) act = mine;
    if (WALK == SKIP_V2) {
      const bool cold = (mine >> lane & 1) && !(list_s(warp + lane * WARPS)[k - 1] > 0.f);
      act |= mine & __ballot_sync(full, cold);
    }
    // score: lanes take (query, document i_doc) pairs, the step's queries
    // the next n_sub of act, lane group j_sub its j_sub-th (bit j itself
    // where act is a run of low bits, as when nothing is skipped)
    const int n_act = __popc(act);
    const bool run = (act & (act + 1)) == 0;
    for (int r0 = 0; r0 < n_act; r0 += n_sub) {
      const int r = r0 + j_sub;
      int j = r;
      if (!run) {
        unsigned x = act;
        for (int i = 0; i < r && x; ++i) x &= x - 1;
        j = x ? __ffs(x) - 1 : 0;
      }
      const int qloc = warp + j * WARPS;
      const bool valid = r < n_act && i_doc < nd;
      float s = -INFINITY;
      float kth = INFINITY;
      if (valid) {
        s = 0.f;
        // a query of a group that cannot match scores exactly 0: no probes
        const int n = probe >> j & 1 ? sq_n[qloc] : 0;
        const int4* qi = reinterpret_cast<const int4*>(sq_id + qloc * tp);
        const float4* qwr = reinterpret_cast<const float4*>(sq_w + qloc * tp);
        for (int t = 0; t < n; t += 4) {
          // four (term, first bucket) pairs and their weights in three 16-byte loads
          const int4 p01 = qi[t >> 1], p23 = qi[(t >> 1) + 1];
          const float4 w4 = qwr[t >> 2];
          const int qk[4] = {p01.x, p01.z, p23.x, p23.z};
          const int qb[4] = {p01.y, p01.w, p23.y, p23.w};
          const float qw[4] = {w4.x, w4.y, w4.z, w4.w};
          int4 y4[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) y4[u] = tab[qb[u] + i_doc];
          const unsigned live = n - t >= 4 ? 15u : (1u << (n - t)) - 1;
          unsigned hit = 0, pending = 0;
          float m[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int q = qk[u];
            const bool h0 = y4[u].x == q, h1 = y4[u].z == q;
            m[u] = __int_as_float(h0 ? y4[u].y : y4[u].w);
            if (h0 || h1) hit |= 1u << u;
            else if (y4[u].z != DOC_PAD) pending |= 1u << u;  // both pairs taken
          }
          hit &= live;
          pending &= live;
          while (pending) {  // a full first bucket: this probe walks on alone
            const int u = __ffs(pending) - 1;
            pending &= pending - 1;
            const int key = u == 0 ? qk[0] : u == 1 ? qk[1] : u == 2 ? qk[2] : qk[3];
            unsigned jb = (unsigned)(u == 0 ? qb[0] : u == 1 ? qb[1] : u == 2 ? qb[2] : qb[3]) >> log_d;
            while (true) {
              jb = (jb + 1) & nbmask;
              const int4 y = tab[(jb << log_d) + i_doc];
              if (y.x == key || y.z == key) {
                const float w = __int_as_float(y.x == key ? y.y : y.w);
#pragma unroll
                for (int v = 0; v < 4; ++v) {
                  if (v == u) m[v] = w;
                }
                hit |= 1u << u;
                break;
              }
              if (y.z == DOC_PAD) break;
            }
          }
          // the fold in term order; a miss adds nothing, so skipping it is exact
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            if (hit >> u & 1) s = __fadd_rn(s, __fmul_rn(m[u], qw[u]));
          }
        }
        kth = list_s(qloc)[k - 1];
        if (WALK == SKIP_POS) kth = fmaxf(kth, 0.f);  // only scores > 0 enter
      }
      unsigned want = __ballot_sync(full, valid && s > kth);
      if (k <= K_DIRECT) {
        while (want) {  // lane order: per query, increasing rows
          const int src = __ffs(want) - 1;
          want &= want - 1;
          const float cs = __shfl_sync(full, s, src);
          const int sq = warp + __shfl_sync(full, j, src) * WARPS;
          float* ls = list_s(sq);
          if (cs > ls[k - 1]) list_insert(ls, list_i(sq), k, cs, base + (src & (D - 1)), lane);
        }
      } else {
        while (want) {  // each query's candidates into its buffer, in row order
          const int src = __ffs(want) - 1;
          const int jq = src >> log_d;
          const unsigned gm = want & (D == 32 ? full : ((1u << D) - 1) << (jq << log_d));
          want &= ~gm;
          const int sq = warp + __shfl_sync(full, j, src) * WARPS;
          int cnt = Bn[sq];
          const int add = __popc(gm);
          if (cnt + add > CAP) {
            merge_buffer(list_s(sq), list_i(sq), k, Bs + sq * CAP, Bi + sq * CAP, cnt, lane);
            cnt = 0;
          }
          if (gm >> lane & 1) {
            const int pos = cnt + __popc(gm & ((1u << lane) - 1));
            Bs[sq * CAP + pos] = s;
            Bi[sq * CAP + pos] = base + i_doc;
          }
          __syncwarp();
          if (lane == 0) Bn[sq] = cnt + add;
          __syncwarp();
        }
      }
    }
    cur = nxt;
    slot ^= 1;
  }

  for (int qloc = warp; qloc < QB; qloc += WARPS) {
    const int b = qt * QB + qloc;
    if (b >= B) continue;
    if (k > K_DIRECT && Bn[qloc] > 0) {
      merge_buffer(list_s(qloc), list_i(qloc), k, Bs + qloc * CAP, Bi + qloc * CAP, Bn[qloc], lane);
    }
    const float* ls = list_s(qloc);
    const int* li = list_i(qloc);
    const size_t o = ((size_t)b * parts + p) * k;
    for (int i = lane; i < k; i += 32) {
      const float v = ls[i];
      const int id = li[i];
      // positive_only's filler for an unfilled entry is (0.0, INT_MAX)
      out_s[o + i] = v == -INFINITY ? (WALK == SKIP_POS ? 0.f : ARTPU_NEG_INF) : v;
      out_i[o + i] = id;
    }
  }
  if (WALK != FULL && stats != nullptr && tid == 0) {
    const long long docs = max(0, end - begin);
    atomicAdd(stats, (unsigned long long)(docs * n_valid - probed));
    atomicAdd(stats + 1, (unsigned long long)(docs - staged));
  }
}

inline int log2_exact(int x) {
  int r = 0;
  while (r < 31 && (1 << r) < x) ++r;
  return (1 << r) == x ? r : -1;
}

template <bool STAGED, int WALK, bool PACKED>
int start(int smem, int blocks, void* stream, const void* q_ids, const void* q_w,
          const void* doc_ids, const void* doc_w, const void* masks, void* out_s, void* out_i,
          void* g_tab, void* stats, int B, int T, int N, int L, int k, int part, int parts,
          int q_tiles, int qb, int log_d, int log_h, int list_smem, int vec, int block_n,
          int n_tiles, int pack) {
  auto kernel = bm25_hash_kernel<STAGED, WALK, PACKED>;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<(unsigned)blocks, THREADS, smem, (cudaStream_t)stream>>>(
      (const int*)q_ids, (const float*)q_w, (const int*)doc_ids, (const float*)doc_w,
      (const unsigned*)masks, (float*)out_s, (int*)out_i, (int*)g_tab,
      (unsigned long long*)stats, B, T, N, L, k, part, parts, q_tiles, qb, log_d, log_h,
      list_smem, vec, block_n, n_tiles, pack);
  return (int)cudaGetLastError();
}

// q_ids / q_w [B, T]; doc_ids / doc_w [N, L] (pack == 1), or pack_slots's
// [R, 128] rows of pack documents at stride L = 128 / pack (pack > 1, the
// wrapper's choice where pack is no power of two), contiguous, 16-byte
// aligned when vec != 0 (then docs * L % 4 == 0 on the flat layout). out_s /
// out_i [B, parts, k]: part p covers documents [p*part, (p+1)*part), a
// multiple of `docs` (SKIP_POS: an equal share of the staged documents,
// staged_bounds). The plan (qb, docs, table, list_smem, staged, smem) is
// ops/sparse.py::bm25_hash_plan's; smem must equal Layout's total. staged
// == 0: docs == 1, and g_tab holds q_tiles * parts * table (key, weight)
// pairs of scratch, 16-byte aligned. walk: FULL, or a skip walk (SKIP_POS /
// SKIP_V2) with masks [q_tiles, n_tiles] uint32 (ops/sparse.py::
// tile_group_masks or probe_group_masks at qb), n_tiles = ceil(N /
// block_n), block_n a multiple of docs (a part may start inside a skip
// tile; pack > 1 takes FULL or SKIP_POS); stats, when not null, two
// uint64 counters that the skip walks add to: (query, document) pairs that
// probed nothing, and (query tile, document) pairs never staged. `want` is the
// walk the launcher serves (FULL, or SKIP_POS for either skip walk).
// Returns cudaGetLastError(), or the error of a refused shared-memory
// attribute.
inline int launch(int want, const void* q_ids, const void* q_w, const void* doc_ids,
                  const void* doc_w, const void* masks, void* out_s, void* out_i, void* g_tab,
                  void* stats, int B, int T, int N, int L, int k, int part, int parts,
                  int q_tiles, int qb, int docs, int table, int list_smem, int staged, int vec,
                  int smem, int walk, int block_n, int n_tiles, int pack, void* stream) {
  if (B == 0 || N == 0 || parts == 0) return 0;
  const int log_d = log2_exact(docs), log_h = log2_exact(table);
  if (T < 0 || T > TMAX || L < 0 || k < 1 || part < 1 || qb < WARPS || qb % WARPS ||
      qb > QB_MAX || log_d < 0 || docs > MAX_DOCS || log_h < 3 ||
      (long long)table < 2LL * L || part % docs || (long long)q_tiles * qb < B ||
      (long long)parts * part < N || (long long)(parts - 1) * part >= N) {
    return (int)cudaErrorInvalidValue;
  }
  if (want == FULL ? walk != FULL : walk != SKIP_POS && walk != SKIP_V2) {
    return (int)cudaErrorInvalidValue;
  }
  if (walk != FULL && (masks == nullptr || block_n < 1 || block_n % docs ||
                       (long long)N + block_n > 2147483647LL ||
                       (long long)n_tiles * block_n < N ||
                       (long long)(n_tiles - 1) * block_n >= N)) {
    return (int)cudaErrorInvalidValue;
  }
  if (pack < 1 || (pack > 1 && (walk == SKIP_V2 || !staged || L != PACKED_LANES / pack)) ||
      (pack == 1 && vec && (docs * L) % 4)) {
    return (int)cudaErrorInvalidValue;
  }
  if (!staged && (docs != 1 || g_tab == nullptr || (size_t)g_tab % 16)) {
    return (int)cudaErrorInvalidValue;
  }
  const Layout lay(docs, table, L, T, qb, k, list_smem, staged, pack);
  if (lay.total != smem || smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  const long long blocks = (long long)q_tiles * parts;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
#define BM25_HASH_START(S, W, P)                                                             \
  start<S, W, P>(smem, (int)blocks, stream, q_ids, q_w, doc_ids, doc_w, masks, out_s, out_i, \
                 g_tab, stats, B, T, N, L, k, part, parts, q_tiles, qb, log_d, log_h,         \
                 list_smem, vec, block_n, n_tiles, pack)
  if (pack > 1) {
    return walk == SKIP_POS ? BM25_HASH_START(true, SKIP_POS, true) : BM25_HASH_START(true, FULL, true);
  }
  if (walk == SKIP_POS) {
    return staged ? BM25_HASH_START(true, SKIP_POS, false) : BM25_HASH_START(false, SKIP_POS, false);
  }
  if (walk == SKIP_V2) {
    return staged ? BM25_HASH_START(true, SKIP_V2, false) : BM25_HASH_START(false, SKIP_V2, false);
  }
  return staged ? BM25_HASH_START(true, FULL, false) : BM25_HASH_START(false, FULL, false);
#undef BM25_HASH_START
}

}  // namespace bm25_hash

// The C signature of the six launchers (bm25_v2.cu).
#define BM25_HASH_ARGS                                                                        \
  const void *q_ids, const void *q_w, const void *doc_ids, const void *doc_w,                 \
      const void *masks, void *out_s, void *out_i, void *g_tab, void *stats, int B, int T,    \
      int N, int L, int k, int part, int parts, int q_tiles, int qb, int docs, int table,     \
      int list_smem, int staged, int vec, int smem, int walk, int block_n, int n_tiles,       \
      int pack, void *stream
#define BM25_HASH_PASS                                                                        \
  q_ids, q_w, doc_ids, doc_w, masks, out_s, out_i, g_tab, stats, B, T, N, L, k, part, parts,  \
      q_tiles, qb, docs, table, list_smem, staged, vec, smem, walk, block_n, n_tiles, pack,   \
      stream
