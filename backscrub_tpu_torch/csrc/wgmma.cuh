// Hopper's warpgroup product (wgmma), bulk copy (cp.async.bulk on an
// mbarrier) and the bf16 splits of its A operand, shared by P3 (probes.cu:
// dot_kernel) and the wgmma GEMM tile of K2'' (gemm_wg.cuh).  sm_90a only.
//
// wgmma here is always m64nNk16 bf16 x bf16 -> f32 with A (64 x 16) from
// registers and B (16 x N) from shared memory in the no-swizzle K-major
// core-matrix layout: a core matrix is 8 rows (N) of 16 bytes (8 bf16 of
// K), 128 contiguous bytes; the descriptor gives the byte offsets between
// core matrices neighbouring in K (LBO) and in N (SBO).  A thread's A
// fragment (4 registers, a packed bf16 pair each) is that of mma.sync's
// m16n8k16 for its warp's 16 rows: a[q] holds A[16 w + g + 8 (q & 1)][2 t
// + 8 (q >> 1) + {0, 1}] (warp w of the warpgroup, lane 4 g + t); the
// N / 2 accumulators d[4 j + q] hold D[16 w + g + 8 (q >> 1)][8 j + 2 t +
// (q & 1)].
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "async_copy.cuh"

namespace {
namespace wg {

// -- A fragments: two f32 values (k, k + 1) as packed bf16 pairs ---------------

__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 v0, __nv_bfloat16 v1) {
  return (uint32_t)__bfloat16_as_ushort(v0) | ((uint32_t)__bfloat16_as_ushort(v1) << 16);
}

// rounded to bf16 (one term)
__device__ __forceinline__ uint32_t round2(float v0, float v1) {
  return pack2(__float2bfloat16_rn(v0), __float2bfloat16_rn(v1));
}

// the reference's HIGH split (three terms): hi = bf16_rn(v), lo =
// bf16_rn(v - hi)
__device__ __forceinline__ void split2(float v0, float v1, uint32_t& hi, uint32_t& lo) {
  __nv_bfloat16 h0 = __float2bfloat16_rn(v0), h1 = __float2bfloat16_rn(v1);
  __nv_bfloat16 l0 = __float2bfloat16_rn(v0 - __bfloat162float(h0));
  __nv_bfloat16 l1 = __float2bfloat16_rn(v1 - __bfloat162float(h1));
  hi = pack2(h0, h1);
  lo = pack2(l0, l1);
}

// the six-term split: hi, lo = bf16_rn(v - hi), lo2 = bf16_rn(v - hi - lo)
__device__ __forceinline__ void split3(float v0, float v1, uint32_t& hi, uint32_t& lo,
                                       uint32_t& lo2) {
  __nv_bfloat16 h0 = __float2bfloat16_rn(v0), h1 = __float2bfloat16_rn(v1);
  const float r0 = v0 - __bfloat162float(h0), r1 = v1 - __bfloat162float(h1);
  __nv_bfloat16 l0 = __float2bfloat16_rn(r0), l1 = __float2bfloat16_rn(r1);
  hi = pack2(h0, h1);
  lo = pack2(l0, l1);
  lo2 = pack2(__float2bfloat16_rn(r0 - __bfloat162float(l0)),
              __float2bfloat16_rn(r1 - __bfloat162float(l1)));
}

// -- the product ------------------------------------------------------------------

// the descriptor of a no-swizzle tile at ``p``: start address, LBO and SBO,
// each in 16-byte units; base offset 0, layout type 0 (no swizzle) in bits
// 62-63
__device__ __forceinline__ uint64_t smem_desc(const void* p, int lbo, int sbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

#define BS_F8(d, i)                                                                       \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])
#define BS_WG_IN(a, b) "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1)
#define BS_WG_HEAD(N) \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %" N ", 0;\nwgmma.mma_async.sync.aligned.m64n"

// d (64 x N f32 a warpgroup, N / 2 a thread) += a (64 x 16 bf16,
// registers) . b (16 x N bf16, K-major in shared memory)
template <int N>
__device__ __forceinline__ void mma(float* d, const uint32_t* a, uint64_t b);

template <>
__device__ __forceinline__ void mma<16>(float* d, const uint32_t* a, uint64_t b) {
  asm volatile(BS_WG_HEAD("13") "16k16.f32.bf16.bf16 "
               "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
               : BS_F8(d, 0)
               : BS_WG_IN(a, b));
}

template <>
__device__ __forceinline__ void mma<32>(float* d, const uint32_t* a, uint64_t b) {
  asm volatile(BS_WG_HEAD("21") "32k16.f32.bf16.bf16 "
               "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
               "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
               : BS_F8(d, 0), BS_F8(d, 8)
               : BS_WG_IN(a, b));
}

template <>
__device__ __forceinline__ void mma<48>(float* d, const uint32_t* a, uint64_t b) {
  asm volatile(BS_WG_HEAD("29") "48k16.f32.bf16.bf16 "
               "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
               "%16, %17, %18, %19, %20, %21, %22, %23}, "
               "{%24, %25, %26, %27}, %28, p, 1, 1, 0;\n}\n"
               : BS_F8(d, 0), BS_F8(d, 8), BS_F8(d, 16)
               : BS_WG_IN(a, b));
}

template <>
__device__ __forceinline__ void mma<64>(float* d, const uint32_t* a, uint64_t b) {
  asm volatile(BS_WG_HEAD("37") "64k16.f32.bf16.bf16 "
               "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
               "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, "
               "%31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
               : BS_F8(d, 0), BS_F8(d, 8), BS_F8(d, 16), BS_F8(d, 24)
               : BS_WG_IN(a, b));
}

template <>
__device__ __forceinline__ void mma<80>(float* d, const uint32_t* a, uint64_t b) {
  asm volatile(BS_WG_HEAD("45") "80k16.f32.bf16.bf16 "
               "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
               "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, "
               "%31, %32, %33, %34, %35, %36, %37, %38, %39}, {%40, %41, %42, %43}, %44, p, "
               "1, 1, 0;\n}\n"
               : BS_F8(d, 0), BS_F8(d, 8), BS_F8(d, 16), BS_F8(d, 24), BS_F8(d, 32)
               : BS_WG_IN(a, b));
}

#undef BS_F8
#undef BS_WG_IN
#undef BS_WG_HEAD

// order the warpgroup's register writes before the wgmmas that follow
__device__ __forceinline__ void fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
// close the wgmma group issued since the last commit (an empty group if none)
__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed groups are in flight
template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving register reads or writes across a wgmma
// boundary (the instructions are asynchronous): a value fenced after a
// wait stays in its registers until then
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// shared memory that generic loads and stores touched, handed to the async
// proxy (wgmma's operand reads, bulk copies' writes), or back
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// -- mbarriers and the bulk copy ---------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
// the inits visible to the async proxy (and the other threads, after a
// __syncthreads)
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_inval(uint64_t* bar) {
  asm volatile("mbarrier.inval.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// this thread's arrival, expecting ``bytes`` more of transactions
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
// wait for the phase of parity ``parity`` to complete
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "BS_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra BS_WAIT;\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}
// ``bytes`` (a multiple of 16; both addresses 16-byte aligned) from global
// to shared memory by the bulk-copy engine, completing on ``bar``
__device__ __forceinline__ void bulk_g2s(void* dst, const void* src, int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

}  // namespace wg
}  // namespace
