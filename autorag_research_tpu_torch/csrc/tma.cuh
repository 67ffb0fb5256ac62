// TMA staging helpers shared by dense_topk_stream.cu, maxsim_tile.cuh and
// seg_stats.cu: mbarriers in shared memory (init, expected bytes, arrival,
// parity wait, with or without a watchdog),
// 2-D tensor loads counted on a barrier, and the tensor-map encoder.
//
// cuTensorMapEncodeTiled lives in libcuda, which the CUDA runtime has already
// loaded: it is looked up at run time with dlopen / dlsym, so no library
// links against libcuda.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums
#include <dlfcn.h>

__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// arrive once and expect `bytes` more of asynchronous copies in this phase
__device__ __forceinline__ void mbar_expect_tx(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// one try: whether the phase of parity `parity` has completed
__device__ __forceinline__ bool mbar_try_wait(unsigned bar, unsigned parity) {
  unsigned done;
  asm volatile(
      "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  while (!mbar_try_wait(bar, parity)) {
  }
}

// mbar_wait that traps after about `limit` cycles, so a fault in a barrier
// protocol ends the launch with an error instead of hanging the card
__device__ __forceinline__ void mbar_wait_or_trap(unsigned bar, unsigned parity, long long limit) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity)) {
    if (clock64() - t0 > limit) __trap();
  }
}

// one 2-D box of a tensor map (x the inner coordinate) into shared memory,
// counted on the barrier `bar` as it lands
__device__ __forceinline__ void tma_load_2d(unsigned dst, const CUtensorMap* map, unsigned bar,
                                            int x, int y) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<unsigned long long>(map)), "r"(bar), "r"(x), "r"(y)
      : "memory");
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

static EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    if (lib != nullptr) fn = reinterpret_cast<EncodeTiledFn>(dlsym(lib, "cuTensorMapEncodeTiled"));
  }
  return fn;
}

// The tensor map of a row-major [rows, d] operand of `elt`-byte elements in
// boxes of box_rows rows x box_inner elements with the 128-byte swizzle (a
// box row is 128 bytes); rows and columns past the operand land as zeros.
static bool tma_map_2d(CUtensorMap* map, CUtensorMapDataType type, int elt, const void* base,
                       long long rows, int d, int box_inner, int box_rows) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)d, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)d * (cuuint64_t)elt};
  const cuuint32_t box[2] = {(cuuint32_t)box_inner, (cuuint32_t)box_rows};
  const cuuint32_t step[2] = {1, 1};
  return fn(map, type, 2, const_cast<void*>(base), dims, strides, box, step,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}
