// Gauss's 3-product complex contraction on Hopper's tensor cores (sm_90a).
//
// Shared by the port's matrix-DFT kernels. One warpgroup (128 threads)
// owns a 64 x 80 float32 output tile of each of the three Gauss products
//
//   k1 = A_cos . B_(re+im),   k2 = A_cps . B_im,   k3 = A_smc . B_re
//
// and finishes with re = k1 - k2, im = k1 + k3. Each product is issued as
// `wgmma.mma_async ... m64n80k16.f32.bf16.bf16` with both operands in shared
// memory (the plane kernel) or A in registers (the axis kernels),
// accumulated in float32 registers (3 x 40 a thread). Precision
// tiers, those of the TPU kernels (mvtb_tpu/ops/pallas_dft.py:_fast):
//   bf16   (P = 1): one product per term on bf16-rounded operands;
//   bf16x3 (P = 2): x = hi + lo with hi = bf16_rn(x), lo = bf16_rn(x - hi)
//                   (pallas_dft.py:_split_bf16; the residual flushes float32
//                   denormals, as XLA does) on both operands, and
//                   hi.hi + hi.lo + lo.hi summed into one accumulator.
//
// Operand layout in shared memory: K-major, no swizzle. A 64 x 16 (A) or
// 80 x 16 (B) bf16 tile is a grid of 8 x 8 core matrices of 128 contiguous
// bytes (8 rows of 16 bytes); the two core matrices of one 8-row group lie
// side by side along K (leading byte offset 128), and 8-row groups follow
// each other (stride byte offset 256). Element (r, k) of a tile sits at
//   (r / 8) * 256 + (k / 8) * 128 + (r % 8) * 16 + (k % 8) * 2 bytes.
// The writer of a tile must `fence_async_smem()` before the warpgroup's
// `wgmma` reads it. Also here: the tiers' bf16 split, and the copy pieces
// that feed such tiles (cp.async, mbarriers, TMA tensor and bulk copies).

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace gauss_wgmma {

constexpr int TM = 64;              // rows of a warpgroup's tile
constexpr int TN = 80;              // columns of a warpgroup's tile
constexpr int TK = 16;              // depth of one wgmma
constexpr int ACC = TM * TN / 128;  // float32 accumulators a thread, per product
constexpr int LBO = 128;            // bytes between core matrices along K
constexpr int SBO = 256;            // bytes between 8-row groups
constexpr int A_TILE_BYTES = TM * TK * 2;
constexpr int B_TILE_BYTES = TN * TK * 2;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of element (r, k) inside a K-major tile of 16-deep rows.
__device__ __forceinline__ int tile_offset(int r, int k) {
  return (r >> 3) * SBO + (k >> 3) * LBO + (r & 7) * 16 + (k & 7) * 2;
}

// wgmma matrix descriptor: start address, leading and stride byte offsets
// (all in 16-byte units), layout type 0 (no swizzle), base offset 0.
__device__ __forceinline__ uint64_t make_desc(const void* tile) {
  const uint32_t a = smem_addr(tile);
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)(LBO >> 4) << 16) |
         ((uint64_t)(SBO >> 4) << 32);
}

__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of the accumulators across
// an asynchronous wgmma (the registers change under it).
__device__ __forceinline__ void fence_operands(float (&d)[ACC]) {
#pragma unroll
  for (int i = 0; i < ACC; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d += A . B^T for a 64 x 16 A tile and an 80 x 16 B tile, both K-major.
__device__ __forceinline__ void wgmma_m64n80k16(float (&d)[ACC], uint64_t da,
                                                uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %42, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39}, "
      "%40, %41, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "l"(da), "l"(db), "r"(1)  // scale-d = 1: accumulate into d
      : "memory");
}

// d += A . B^T for a 64 x 16 A tile held in registers and an 80 x 16 B tile
// (K-major, shared memory). Each warp w of the warpgroup holds rows 16w..16w+15
// of A; with g = lane / 4 and t = lane % 4, register j holds the bf16 pair
// (lower half first) at row g + 8 (j & 1), columns 2t, 2t + 1 (+ 8 for j >= 2).
// The registers must not change until the wgmma has completed.
__device__ __forceinline__ void wgmma_m64n80k16_rs(float (&d)[ACC], const uint32_t (&a)[4],
                                                   uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39}, "
      "{%40, %41, %42, %43}, %44, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1)
      : "memory");
}

// The three Gauss accumulators of one warpgroup.
struct Acc {
  float k[3][ACC];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int t = 0; t < 3; ++t)
#pragma unroll
      for (int i = 0; i < ACC; ++i) k[t][i] = 0.f;
  }

  __device__ __forceinline__ void fence() {
#pragma unroll
    for (int t = 0; t < 3; ++t) fence_operands(k[t]);
  }
};

// A descriptor `bytes` further into shared memory (a multiple of 16; the
// start address field is the address / 16, and stays below 2^14).
__device__ __forceinline__ uint64_t desc_add(uint64_t desc, int bytes) {
  return desc + (uint64_t)(bytes >> 4);
}

// One 16-deep step of the contraction. Operand part p of term t sits at
// a0 + (t*P + p) * A_STEP bytes (A) and b0 + (t*P + p) * B_STEP bytes (B),
// p = 0 only for P = 1, p = 1 the lo part for P = 2. Issues 3 (P = 1) or
// 9 (P = 2) wgmma and commits them as one group.
template <int P, int A_STEP, int B_STEP>
__device__ __forceinline__ void gauss_step(Acc& acc, uint64_t a0, uint64_t b0) {
  wgmma_fence();
#pragma unroll
  for (int t = 0; t < 3; ++t) {
    const uint64_t ah = desc_add(a0, t * P * A_STEP), bh = desc_add(b0, t * P * B_STEP);
    wgmma_m64n80k16(acc.k[t], ah, bh);
    if constexpr (P == 2) {
      wgmma_m64n80k16(acc.k[t], ah, desc_add(bh, B_STEP));
      wgmma_m64n80k16(acc.k[t], desc_add(ah, A_STEP), bh);
    }
  }
  wgmma_commit();
}

// Row and column, inside the warpgroup's 64 x 80 tile, of accumulator i of
// thread `lane` in warp `warp` (0..3) of the warpgroup.
__device__ __forceinline__ int acc_row(int i, int warp, int lane) {
  return warp * 16 + (lane >> 2) + ((i >> 1) & 1) * 8;
}
__device__ __forceinline__ int acc_col(int i, int lane) {
  return (i >> 2) * 8 + (lane & 3) * 2 + (i & 1);
}

// The Gauss epilogue of accumulator i: (re, im) = (k1 - k2, k1 + k3).
__device__ __forceinline__ float2 gauss_out(const Acc& acc, int i) {
  return make_float2(acc.k[0][i] - acc.k[1][i], acc.k[0][i] + acc.k[2][i]);
}

// x - y rounded to nearest, float32 denormals flushed to zero on input and
// output, as XLA's float32 arithmetic computes the split's residual.
__device__ __forceinline__ float sub_ftz(float x, float y) {
  float r;
  asm("sub.rn.ftz.f32 %0, %1, %2;" : "=f"(r) : "f"(x), "f"(y));
  return r;
}

// Eight values along K as one core-matrix row (16 bytes): bf16_rn of each
// (P = 1), or its (hi, lo) split (P = 2, lo into `lo`).
template <int P>
__device__ __forceinline__ void split8(const float (&x)[8], uint4& hi, uint4& lo) {
  uint32_t h[4], l[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const __nv_bfloat162 hv = __floats2bfloat162_rn(x[2 * e], x[2 * e + 1]);
    h[e] = *reinterpret_cast<const uint32_t*>(&hv);
    if constexpr (P == 2) {
      const float r0 = sub_ftz(x[2 * e], __low2float(hv));
      const float r1 = sub_ftz(x[2 * e + 1], __high2float(hv));
      const __nv_bfloat162 lv = __floats2bfloat162_rn(r0, r1);
      l[e] = *reinterpret_cast<const uint32_t*>(&lv);
    } else {
      l[e] = 0u;
    }
  }
  hi = make_uint4(h[0], h[1], h[2], h[3]);
  lo = make_uint4(l[0], l[1], l[2], l[3]);
}

// Four values along K as half a core-matrix row (8 bytes): as split8.
template <int P>
__device__ __forceinline__ void split4(const float (&x)[4], uint2& hi, uint2& lo) {
  uint32_t h[2], l[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const __nv_bfloat162 hv = __floats2bfloat162_rn(x[2 * e], x[2 * e + 1]);
    h[e] = *reinterpret_cast<const uint32_t*>(&hv);
    if constexpr (P == 2) {
      const float r0 = sub_ftz(x[2 * e], __low2float(hv));
      const float r1 = sub_ftz(x[2 * e + 1], __high2float(hv));
      const __nv_bfloat162 lv = __floats2bfloat162_rn(r0, r1);
      l[e] = *reinterpret_cast<const uint32_t*>(&lv);
    } else {
      l[e] = 0u;
    }
  }
  hi = make_uint2(h[0], h[1]);
  lo = make_uint2(l[0], l[1]);
}

// Asynchronous 4-byte copies global -> shared (cp.async), for rows that are
// not 16-byte aligned.
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)),
               "l"(src)
               : "memory");
}
// The same for 8 bytes, both addresses 8-byte aligned.
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(smem_addr(dst)),
               "l"(src)
               : "memory");
}
// The same for 16 bytes, both addresses 16-byte aligned (bypassing L1).
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// mbarriers in shared memory (one 8-byte word each): init once (then
// fence_mbar_init and a block barrier), arrive announcing the bytes the
// phase's bulk copies bring, wait for the phase of the given parity.
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// Tensor copies global -> shared by the copy engine (TMA): the box of a
// tensor map (a kernel parameter, __grid_constant__) at the given element
// coordinates, innermost first, completing the box's bytes of the barrier's
// transaction count; elements outside the tensor arrive as zeros.
__device__ __forceinline__ void tma_load_2d(void* dst, const void* map, int c0, int c1,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n"
      ::"r"(smem_addr(dst)), "l"(map), "r"(c0), "r"(c1), "r"(smem_addr(bar))
      : "memory");
}
__device__ __forceinline__ void tma_load_3d(void* dst, const void* map, int c0, int c1, int c2,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n"
      ::"r"(smem_addr(dst)), "l"(map), "r"(c0), "r"(c1), "r"(c2), "r"(smem_addr(bar))
      : "memory");
}

// A contiguous copy global -> shared by the copy engine: `bytes` (a multiple
// of 16, both addresses 16-byte aligned), completing that many bytes of the
// barrier's transaction count.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Orders this thread's generic-proxy writes (global and shared) before later
// async-proxy accesses (tensor copies) of the same memory.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async;\n" ::: "memory");
}

}  // namespace gauss_wgmma
