// seg_stats_bf16: fused bf16 prescreen matmul + per-segment statistics.
//
// Replaces autorag_research_tpu/ops/dense.py::_seg_stats_kernel (line 690,
// Pallas, called at line 757 by _seg_stats_pallas). For queries q [Q, d] and
// a prescreen corpus c [rows, d], both bf16, it computes the f32-accumulated
// scores q @ c^T and, for every 128-row segment s and query row i:
//   max1[i, s] = max of the segment's scores,
//   loc1[i, s] = the lowest lane (0..127) holding that max,
//   max2[i, s] = max over the segment's other lanes (= max1 on an exact tie),
// with every column >= n (a run-time count) masked to NEG_INF. The [Q, rows]
// score matrix never reaches device memory: only [Q, S] x 3 is written.
//
// Bound on this card: at Q = 1,024, rows = 501,760, d = 768 the work is
// 7.9e11 bf16 FLOP (0.8 ms at 989 TFLOP/s) against 0.77 GB of corpus reads
// (0.23 ms at 3.35 TB/s), so it is bound by tensor-core operations. What
// stands between a kernel and that bound is feeding the tensor cores: every
// staged byte has to be multiplied by enough rows, and the statistics must
// cost little beside the products.
//
// Design.
// - Work items are (query tile of BM = 128 rows, corpus tile of BN = 256 rows,
//   two segments). The plan (ops/dense.py::seg_stats_plan) launches one wave
//   of persistent blocks, one an SM: when the query tiles pair up, as many
//   clusters of two as the card holds at once (the occupancy calculator,
//   seg_stats_max_active_clusters), else single blocks. A cluster's two
//   blocks take the two query tiles of a pair and the
//   same corpus tiles; clusters walk the items with a stride of their count,
//   query pairs fastest, so the blocks resident together read the same corpus
//   tiles, once from device memory and then from L2.
// - Staging: one producer thread issues TMA boxes of 64 bf16 (128 bytes, the
//   128-byte swizzle) x 128 query rows and x 256 corpus rows into a ring of
//   four 48 KB slots, counted on the slot's full mbarrier; consumer warps
//   release a slot on its empty mbarrier. In a cluster each block loads one
//   half of the corpus box and multicasts it into both blocks, so a block
//   reads 32 KB of each 48 KB slot from L2: 6.0 GB in all at the main path's
//   shape, against 9.0 GB unshared. (Each SM still receives all 384 box rows
//   of a slot, and TMA paces box rows: staging alone takes about as long as
//   the products at d = 768 either way, PERF.md.) An empty barrier counts the
//   consumer warps of every block the slot is multicast into, so no block
//   overwrites a slot that its partner still reads. The ring runs on across
//   items: the next item's slices land while the consumers reduce.
// - Products: two consumer warpgroups (setmaxnreg 232; the producer's 40),
//   each issuing wgmma m64n256k16 from the slot (both operands K-major in
//   shared memory, wgmma.cuh) over 64 query rows x 256 corpus rows, f32
//   accumulators in 128 registers a thread. One group of wgmma stays in
//   flight while the next slot is awaited.
// - Epilogue in registers only: in the m64n256 accumulator layout a row's 256
//   columns lie in the four threads of one quad, 32 of each segment in each
//   thread. Each thread reduces its 32 columns of a (row, segment) in
//   increasing column order (a tie keeps the earlier lane), then two
//   __shfl_xor merges with merge()'s tie rule finish the quad. No shared
//   memory, no block barrier; each thread of the quad writes one of its four
//   (row, segment) results.
// - Rows past Q, rows past the corpus and k columns past d land as TMA zeros;
//   a zero adds exactly 0 to a sum, and columns >= n are set to NEG_INF (only
//   in a tile that reaches n).
// - Every mbarrier wait gives up after about 2^34 cycles (seconds) with a
//   trap (mbar_wait_or_trap), so a fault in the protocol ends the launch with
//   an error.

#include "common.cuh"
#include "tma.cuh"
#include "wgmma.cuh"

namespace {

constexpr int BM = 128;  // query rows of a tile
constexpr int BN = 256;  // corpus rows of a tile: two segments
constexpr int BK = 64;   // k of a staged slice: one box row, swizzled across its width
constexpr int ROW = BK * 2;  // bytes of a box row
constexpr int SEG = 128;
constexpr int STAGES = 4;
constexpr int A_BYTES = BM * BK * 2;
constexpr int B_BYTES = BN * BK * 2;
constexpr int STAGE = A_BYTES + B_BYTES;
constexpr int ALIGN = 1024;  // the 128-byte swizzle repeats every 1,024 bytes
constexpr int CWARPS = 8;    // consumer warps: two warpgroups
constexpr int THREADS = CWARPS * 32 + 128;  // and a producer warpgroup: one thread works
constexpr int CONSUMER_REGS = 232, PRODUCER_REGS = 40;
constexpr long long SMEM_MAX = 232448;  // a block's shared memory on sm_90
constexpr long long WATCHDOG = 1LL << 34;
constexpr unsigned FULL = 0xffffffffu;

// slack, the ring, full and empty barriers per slot
constexpr long long layout_bytes() { return ALIGN + (long long)STAGES * STAGE + 16LL * STAGES; }

struct Args {
  float* max1;
  int* loc1;
  float* max2;
  int Q, n, S, k_slices, q_groups, c_tiles;
};

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

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\nbarrier.cluster.wait.acquire.aligned;\n"
               ::: "memory");
}

// arrive on the barrier at this block's offset `bar` in cluster block `rank`,
// with the default release at block scope (with a release at cluster scope on
// every slot the clustered kernel ran 2.3x slower on an H100)
__device__ __forceinline__ void arrive_in(unsigned bar, unsigned rank) {
  unsigned remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(bar), "r"(rank));
  asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];\n" ::"r"(remote) : "memory");
}

// one 2-D box into the same offset `dst` of every block of `mask`, counted on
// the barrier at offset `bar` of each
__device__ __forceinline__ void tma_load_2d_multicast(unsigned dst, const CUtensorMap* map,
                                                      unsigned bar, int x, int y,
                                                      unsigned short mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%3, %4}], [%2], %5;\n" ::"r"(dst),
      "l"(reinterpret_cast<unsigned long long>(map)), "r"(bar), "r"(x), "r"(y), "h"(mask)
      : "memory");
}

// Fold column `col` (increasing along a thread's columns) of value v into t
// without a branch: m2 = max(m2, min(m1, v)) is the runner-up whichever way
// v falls, and a tie (v == m1) keeps the earlier lane.
__device__ __forceinline__ void fold(Top2& t, float v, int col) {
  t.m2 = fmaxf(t.m2, fminf(t.m1, v));
  t.l1 = v > t.m1 ? col : t.l1;
  t.m1 = fmaxf(t.m1, v);
}

// (max1, loc1, max2) of this thread's two rows x two segments of a tile into
// r, in registers and quad shuffles; MASK: the tile reaches column n. The
// four (row, segment) folds interleave, four independent chains; after the
// shuffles every thread of the quad holds all four results.
template <bool MASK>
__device__ __forceinline__ void reduce(const float (&acc)[128], const Args& a, int c0, int t,
                                       Top2 (&r)[4]) {
#pragma unroll
  for (int x = 0; x < 4; ++x) r[x] = Top2{-INFINITY, ARTPU_INT_MAX, -INFINITY};
#pragma unroll
  for (int j = 0; j < 16; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = 8 * j + 2 * t + e;  // the segment's lane
#pragma unroll
      for (int x = 0; x < 4; ++x) {  // x = 2 h + sg: row + 8 h, segment sg
        const int h = x >> 1, sg = x & 1;
        float v = acc[4 * (16 * sg + j) + 2 * h + e];
        if (MASK && c0 + SEG * sg + col >= a.n) v = ARTPU_NEG_INF;
        fold(r[x], v, col);
      }
    }
  }
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const float om1 = __shfl_xor_sync(FULL, r[x].m1, off);
      const int ol1 = __shfl_xor_sync(FULL, r[x].l1, off);
      const float om2 = __shfl_xor_sync(FULL, r[x].m2, off);
      merge(r[x], om1, ol1, om2);
    }
  }
}

// thread t of the quad writes result t: row row0 + 8 (t / 2), segment seg0 + t % 2
__device__ __forceinline__ void store(const Args& a, const Top2 (&r)[4], int row0, int seg0,
                                      int t) {
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    const int row = row0 + 8 * (x >> 1), seg = seg0 + (x & 1);
    if (t == x && row < a.Q && seg < a.S) {
      const size_t o = (size_t)row * a.S + seg;
      a.max1[o] = r[x].m1;
      a.loc1[o] = r[x].l1;
      a.max2[o] = r[x].m2;
    }
  }
}

template <int CL>
__global__ void __launch_bounds__(THREADS, 1)
seg_stats_kernel(const Args a, const __grid_constant__ CUtensorMap map_q,
                 const __grid_constant__ CUtensorMap map_c) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* ring = smem_raw + ((ALIGN - smem_addr(smem_raw) % ALIGN) % ALIGN);
  const unsigned full0 = smem_addr(ring + STAGES * STAGE), empty0 = full0 + 8 * STAGES;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const unsigned rank = CL > 1 ? cluster_rank() : 0;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, CL * CWARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the partner's barriers are ready before any multicast or remote arrival
  if (CL > 1) {
    cluster_sync();
  } else {
    __syncthreads();
  }

  const int cluster = blockIdx.x / CL, clusters = gridDim.x / CL;
  const int items = a.q_groups * a.c_tiles;
  int slot = 0;
  unsigned phase = 0;  // parity of the slot's current round
  auto next_slot = [&]() {
    if (++slot == STAGES) {
      slot = 0;
      phase ^= 1;
    }
  };

  if (warp >= CWARPS) {
    // ---- producer: one thread stages every slice, in the consumers' order
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (tid != CWARPS * 32) return;
    for (int it = cluster; it < items; it += clusters) {
      const int q0 = ((it % a.q_groups) * CL + (int)rank) * BM, c0 = (it / a.q_groups) * BN;
      for (int kb = 0; kb < a.k_slices; ++kb) {
        mbar_wait_or_trap(empty0 + 8 * slot, phase ^ 1, WATCHDOG);
        unsigned char* s = ring + slot * STAGE;
        const unsigned bar = full0 + 8 * slot;
        mbar_expect_tx(bar, STAGE);
        tma_load_2d(smem_addr(s), &map_q, bar, kb * BK, q0);
        if (CL == 1) {
          tma_load_2d(smem_addr(s + A_BYTES), &map_c, bar, kb * BK, c0);
        } else {
          tma_load_2d_multicast(smem_addr(s + A_BYTES + rank * (B_BYTES / 2)), &map_c, bar,
                                kb * BK, c0 + (int)rank * (BN / 2), (unsigned short)3);
        }
        next_slot();
      }
    }
    // stay until every slot in flight is released by the consumers of every
    // block of the cluster, whose last arrivals land on this block's barriers
    for (int s = 0; s < STAGES; ++s) {
      mbar_wait_or_trap(empty0 + 8 * slot, phase ^ 1, WATCHDOG);
      next_slot();
    }
    return;
  }

  // ---- consumers: warpgroup wg owns query rows 64 wg .. 64 wg + 63 of a tile
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  const int wg = warp >> 2, t = lane & 3;
  const int r0 = 64 * wg + 16 * (warp & 3) + (lane >> 2);
  auto release = [&](int s) {
    __syncwarp();
    if (lane == 0) {
      if (CL == 1) {
        mbar_arrive(empty0 + 8 * s);
      } else {
#pragma unroll
        for (int r = 0; r < CL; ++r) arrive_in(empty0 + 8 * s, r);
      }
    }
  };
  float acc[128];
  for (int it = cluster; it < items; it += clusters) {
    const int q0 = ((it % a.q_groups) * CL + (int)rank) * BM, c0 = (it / a.q_groups) * BN;
    int prev = -1;
    for (int kb = 0; kb < a.k_slices; ++kb) {
      mbar_wait_or_trap(full0 + 8 * slot, phase, WATCHDOG);
      const unsigned char* s = ring + slot * STAGE;
      const unsigned char* As = s + wg * 64 * ROW;
      const unsigned char* Bs = s + A_BYTES;
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {  // k16 steps: 32 bytes along the rows
        wgmma_m64n256k16(acc, sw128_desc(As + kk * 32), sw128_desc(Bs + kk * 32),
                         kb > 0 || kk > 0);
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      if (prev >= 0) {
        // the previous slice's group has completed: its slot is free
        asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
        release(prev);
      }
      prev = slot;
      next_slot();
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    wgmma_fence_acc(acc);
    release(prev);
    Top2 res[4];
    if (c0 + BN <= a.n) {
      reduce<false>(acc, a, c0, t, res);
    } else {
      reduce<true>(acc, a, c0, t, res);
    }
    store(a, res, q0 + r0, c0 / SEG, t);
  }
}

template <int CL>
cudaError_t launch_cluster(const Args& a, const CUtensorMap& map_q, const CUtensorMap& map_c,
                           int grid, int smem_bytes, cudaStream_t stream) {
  auto kernel = seg_stats_kernel<CL>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)grid);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = (size_t)smem_bytes;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = CL > 1 ? 1 : 0;
  e = cudaLaunchKernelEx(&cfg, kernel, a, map_q, map_c);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

// q [Q, d] and c [rows, d] bf16 row-major (d % 8 == 0, 16-byte aligned);
// outputs [Q, S] with S = ceil(rows / 128), columns >= n masked. cluster (1 or
// 2, dividing the query tiles), grid (a multiple of cluster) and smem_bytes
// come from the plan; the launch is refused unless smem_bytes equals this
// layout's count. Returns the CUDA error.
extern "C" int seg_stats_bf16_launch(const void* q, const void* c, void* max1, void* loc1,
                                     void* max2, int Q, int rows, int d, int n, int S,
                                     int cluster, int grid, int smem_bytes, void* stream) {
  if (Q == 0 || rows == 0) return 0;
  const int q_tiles = (Q + BM - 1) / BM;
  if (Q < 0 || rows < 0 || d < 8 || d % 8 || n < 0 || n > rows || S != (rows + SEG - 1) / SEG ||
      (cluster != 1 && cluster != 2) || q_tiles % cluster || grid < cluster || grid % cluster)
    return (int)cudaErrorInvalidValue;
  if (smem_bytes != layout_bytes() || layout_bytes() > SMEM_MAX) return (int)cudaErrorInvalidValue;
  CUtensorMap map_q = {}, map_c = {};
  if (!tma_map_2d(&map_q, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, q, Q, d, BK, BM) ||
      !tma_map_2d(&map_c, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, c, rows, d, BK, BN / cluster))
    return (int)cudaErrorInvalidValue;
  const Args a{(float*)max1, (int*)loc1, (float*)max2, Q, n, S, (d + BK - 1) / BK,
               q_tiles / cluster, (rows + BN - 1) / BN};
  const cudaStream_t st = (cudaStream_t)stream;
  return (int)(cluster == 2 ? launch_cluster<2>(a, map_q, map_c, grid, smem_bytes, st)
                            : launch_cluster<1>(a, map_q, map_c, grid, smem_bytes, st));
}

// This layout's shared-memory bytes for a block.
extern "C" int seg_stats_smem_bytes() { return (int)layout_bytes(); }

// Resident blocks an SM holds at `smem_bytes` (the occupancy calculator, from
// the kernel's registers and shared memory). Returns the CUDA error.
extern "C" int seg_stats_blocks_per_sm(int smem_bytes, int* blocks) {
  auto kernel = seg_stats_kernel<1>;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, THREADS, smem_bytes);
}

// Clusters of two the card holds at once at `smem_bytes` (the occupancy
// calculator, which knows how SMs group into clusters). Returns the CUDA error.
extern "C" int seg_stats_max_active_clusters(int smem_bytes, int grid, int* clusters) {
  auto kernel = seg_stats_kernel<2>;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 2;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)grid);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = (size_t)smem_bytes;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg);
}
