// Shared device helpers for the hand-written Hopper kernels.
//
// mma.sync m16n8k16 (bf16 x bf16 -> f32) with the PTX ISA's fragment layout.
// Lane l of a warp has group g = l >> 2 and thread-in-group t = l & 3:
//   A (16x16, row-major): a0 = A[g][2t..2t+1],   a1 = A[g+8][2t..2t+1],
//                          a2 = A[g][2t+8..2t+9], a3 = A[g+8][2t+8..2t+9]
//   B (16x8,  "col"):      b0 = B[2t..2t+1][g],   b1 = B[2t+8..2t+9][g]
//   C/D (16x8, f32):       c0,c1 = D[g][2t..2t+1], c2,c3 = D[g+8][2t..2t+1]
// Each 32-bit register holds two bf16 values, the lower index in the low half.
// With B = C^T for a row-major corpus tile C[n][k], every B register is one
// aligned 32-bit word of a corpus row, so both operands load from row-major
// shared memory tiles without a transpose.
#pragma once

#include <math.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define ARTPU_NEG_INF (-3.4e38f)
#define ARTPU_INT_MAX 2147483647

// the shared-memory address of a generic pointer into shared memory
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mma_bf16_16816(float c[4], const uint32_t a[4],
                                               const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A fragment of rows [row0, row0+16) and k columns [kk, kk+16) of a row-major
// bf16 shared tile with row stride `ld` elements.
__device__ __forceinline__ void load_a_frag(uint32_t a[4], const __nv_bfloat16* s,
                                            int ld, int row0, int kk, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const __nv_bfloat16* p0 = s + (row0 + g) * ld + kk + 2 * t;
  const __nv_bfloat16* p1 = p0 + 8 * ld;
  a[0] = *reinterpret_cast<const uint32_t*>(p0);
  a[1] = *reinterpret_cast<const uint32_t*>(p1);
  a[2] = *reinterpret_cast<const uint32_t*>(p0 + 8);
  a[3] = *reinterpret_cast<const uint32_t*>(p1 + 8);
}

// B fragment for output columns [col0, col0+8): rows col0.. of the row-major
// corpus tile, k columns [kk, kk+16).
__device__ __forceinline__ void load_b_frag(uint32_t b[2], const __nv_bfloat16* s,
                                            int ld, int col0, int kk, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const __nv_bfloat16* p = s + (col0 + g) * ld + kk + 2 * t;
  b[0] = *reinterpret_cast<const uint32_t*>(p);
  b[1] = *reinterpret_cast<const uint32_t*>(p + 8);
}

// Copy a [rows x 8*vecs_per_row] bf16 tile, starting at global row `row0`
// and column `k0`, into a row-major shared tile with row stride `ld`, in
// 16-byte vectors. Rows >= row_lim and columns >= d are zero-filled (d is a
// multiple of 8, so a vector is either wholly inside or wholly outside).
template <int ROWS, int VECS_PER_ROW, int THREADS>
__device__ __forceinline__ void load_tile_bf16(__nv_bfloat16* s, int ld,
                                               const __nv_bfloat16* g, int row0,
                                               int row_lim, int k0, int d, int tid) {
#pragma unroll
  for (int i = 0; i < ROWS * VECS_PER_ROW / THREADS; ++i) {
    const int v = tid + i * THREADS;
    const int r = v / VECS_PER_ROW;
    const int kc = (v % VECS_PER_ROW) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < row_lim && k0 + kc < d) {
      val = *reinterpret_cast<const uint4*>(g + (size_t)(row0 + r) * d + k0 + kc);
    }
    *reinterpret_cast<uint4*>(s + r * ld + kc) = val;
  }
}

// k-best list of one query row in shared memory: k entries (ls scores, li
// ids) sorted in (-score, id) order, filled with (-inf, INT_MAX) at the start.
// Insert (cs, cid), which beats the k-th score, so its rank is < k. Called by
// all 32 lanes of a warp. The rank is the number of entries >= cs (a prefix of
// the list, found 32 entries per ballot); the entries below it shift down by
// one, highest 32 first. A caller that offers ids in increasing order gets
// ties resolved to the lower id: an equal score never outranks an entry
// already held.
__device__ __forceinline__ void list_insert(float* ls, int* li, int k, float cs, int cid,
                                            int lane) {
  const unsigned full = 0xffffffffu;
  int pos = 0;
  for (int c0 = 0; c0 < k; c0 += 32) {
    const unsigned ge = __ballot_sync(full, c0 + lane < k && ls[c0 + lane] >= cs);
    pos += __popc(ge);
    if (ge != full) break;
  }
  for (int c0 = ((k - 1) >> 5) << 5; c0 + 31 > pos; c0 -= 32) {
    const int i = c0 + lane;
    const bool mv = i > pos && i < k;
    float v = 0.f;
    int id = 0;
    if (mv) {
      v = ls[i - 1];
      id = li[i - 1];
    }
    __syncwarp();
    if (mv) {
      ls[i] = v;
      li[i] = id;
    }
    __syncwarp();
  }
  if (lane == 0) {
    ls[pos] = cs;
    li[pos] = cid;
  }
  __syncwarp();
}
