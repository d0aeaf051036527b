// bs_gemm: the flat continuation's (K2'') tensor-core 1x1 conv as a
// standalone kernel for Hopper (sm_90a), the per-shape probe of the GEMM
// tiles that the persistent kernel runs as its OP_GEMM (body_mega.cu runs
// the deeplab tables): the bf16x3 split on gemm_tc.cuh's mma.sync tile,
// one term and six on gemm_wg.cuh's wgmma tile.  ops/megakernel.py:
// conv1x1_gemm launches it; chip_smoke.py and tools/sweep_gemm_tiles.py
// time it against torch.addmm at each 1x1 shape of the deeplab frame.
//
// Replaces, as the table's GEMM op does, the MXU dots of the TPU kernel
// backscrub_tpu/ops/megakernel.py:BodyMega in its flat mode
// (body_mega_continuation_for): (co, ci) @ (ci, rows*33) emulating XLA's
// HIGH precision as three bf16 passes (megakernel.py:501-515), in the
// bf16 mode its DEFAULT precision as one, or at "highest" the HIGHEST
// precision that it passes to dot_general (megakernel.py:516-518), the
// TPU's six bf16 passes (``terms``).
//
// The regime's GEMMs are small (M = co 16-480, K = ci 16-512, N = 1089):
// 1.3 GFLOP a deeplab frame in 29 of them, so latency and grid fill, not
// the tensor-core peak, set the pace.  Three terms: four warps a CTA and
// several CTAs an SM hide each other's latency; the tile is picked per
// shape on the host (ops/megakernel.py:gemm_config, fitted to
// tools/sweep_gemm_tiles.py) from 64x64, 32x64, 32x32 and 16x32.  One and
// six terms: the table's wgmma tile, 64 positions by a width that makes the
// grid one round over the SMs (gemm_wg.cuh).  A deep K (ci >= 256) whose
// grid falls short is split over blockIdx.z, a second kernel summing the
// partials in a fixed order (no atomics: two runs give the same bits).
// Bias and the activation run in the epilogue (or in the split-K pass).
//
// Bound (H100 SXM): the largest shape (ASPP 256x512 by 512x1089, 0.29
// GFLOP as three bf16 passes) needs ~0.9 us of tensor-core time and moves
// ~3.5 MB (~1 us at 3.35 TB/s); a launch is a few microseconds of latency.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "gemm_tc.cuh"
#include "gemm_wg.cuh"

namespace {

constexpr int NT = 128;     // four warps a CTA

// y = act(W x + b) over the K range [kb, kb + kchunk) of blockIdx.z
// (kb = blockIdx.z * kchunk); with ``part`` the raw sums go to part[z]
// instead (split K).  whi/wlo (M, Kp) bf16; x (K, N), y (M, N) f32.
template <int BM, int BN, int WARPS_M>
__global__ void __launch_bounds__(NT)
gemm_tc_kernel(const __nv_bfloat16* whi, const __nv_bfloat16* wlo, const float* b,
               const float* x, float* y, float* part, int M, int K, int Kp, int N, int act,
               int kchunk) {
  using T = gemm_tc::Tile<BM, BN, WARPS_M, 4 / WARPS_M, 1>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int kb = blockIdx.z * kchunk;
  const gemm_tc::Epilogue ep{b, act, nullptr, 0, y,
                             part == nullptr ? nullptr : part + (size_t)blockIdx.z * M * N};
  T::run(smem, whi, wlo, x, M, Kp, N, blockIdx.y * BM, blockIdx.x * BN, kb,
         min(kb + kchunk, Kp), min(kb + kchunk, K), ep);
}

// y = act(sum_z part[z] + b), the partials summed in z order
__global__ void splitk_sum_kernel(const float* __restrict__ part, const float* __restrict__ b,
                                  float* __restrict__ y, int M, int N, int S, int act) {
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long mn = (long long)M * N;
  if (idx >= mn) return;
  float s = part[idx];
  for (int z = 1; z < S; ++z) s += part[z * mn + idx];
  y[idx] = activate(s + b[idx / N], act);
}

template <int BM, int BN, int WARPS_M>
int launch_gemm(const void* whi, const void* wlo, const void* b, const void* x, void* y,
                void* part, int M, int K, int Kp, int N, int act, int split, int kchunk,
                cudaStream_t stream) {
  constexpr int smem = gemm_tc::Tile<BM, BN, WARPS_M, 4 / WARPS_M, 1>::SMEM_BYTES;
  static bool ready = false;   // the attribute, once per process and instantiation
  if (!ready) {
    cudaError_t e = cudaFuncSetAttribute(gemm_tc_kernel<BM, BN, WARPS_M>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    ready = true;
  }
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, split);
  gemm_tc_kernel<BM, BN, WARPS_M><<<grid, NT, smem, stream>>>(
      (const __nv_bfloat16*)whi, (const __nv_bfloat16*)wlo, (const float*)b, (const float*)x,
      (float*)y, split > 1 ? (float*)part : nullptr, M, K, Kp, N, act, kchunk);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || split == 1) return (int)e;
  long long mn = (long long)M * N;
  splitk_sum_kernel<<<(unsigned)((mn + 255) / 256), 256, 0, stream>>>(
      (const float*)part, (const float*)b, (float*)y, M, N, split, act);
  return (int)cudaGetLastError();
}

int launch_tile(int tile, const void* whi, const void* wlo, const void* b, const void* x,
                void* y, void* part, int co, int ci, int kp, int L, int act, int split,
                int kchunk, cudaStream_t s) {
  switch (tile) {
    case 0: return launch_gemm<64, 64, 2>(whi, wlo, b, x, y, part, co, ci, kp, L, act, split, kchunk, s);
    case 1: return launch_gemm<32, 64, 2>(whi, wlo, b, x, y, part, co, ci, kp, L, act, split, kchunk, s);
    case 2: return launch_gemm<32, 32, 2>(whi, wlo, b, x, y, part, co, ci, kp, L, act, split, kchunk, s);
    case 3: return launch_gemm<16, 32, 1>(whi, wlo, b, x, y, part, co, ci, kp, L, act, split, kchunk, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// the wgmma tile (gemm_wg.cuh) of width BN: y = act(W x + b) over the K
// slices [z * zs, min(z * zs + zs, nks)) of blockIdx.z; with ``part`` the
// raw sums go to part[z] instead (split K).  w: W's pieces laid out for the
// tile (megakernel.py:lay_wgmma), nks slices a co tile.
template <int BN, int TERMS>
__global__ void __launch_bounds__(gemm_wg::NT, 1)
gemm_wg_kernel(const __nv_bfloat16* w, const float* b, const float* x, float* y, float* part,
               int M, int K, int N, int act, int zs) {
  using T = gemm_wg::Tile<BN, TERMS>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int nks = (K + gemm_wg::BK - 1) / gemm_wg::BK, s0 = blockIdx.z * zs;
  const int s1 = min(s0 + zs, nks);
  const gemm_tc::Epilogue ep{b, act, nullptr, 0, y,
                             part == nullptr ? nullptr : part + (size_t)blockIdx.z * M * N};
  T::run(smem, w, x, M, N, nks, blockIdx.y, blockIdx.x * gemm_wg::BM, s0, s1,
         min(s1 * gemm_wg::BK, K), ep);
}

template <int BN, int TERMS>
int launch_wg(const void* w, const void* b, const void* x, void* y, void* part, int M, int K,
              int N, int act, int split, int kchunk, cudaStream_t stream) {
  constexpr int smem = gemm_wg::Tile<BN, TERMS>::SMEM_BYTES;
  static bool ready = false;   // the attribute, once per process and instantiation
  if (!ready) {
    cudaError_t e = cudaFuncSetAttribute(gemm_wg_kernel<BN, TERMS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    ready = true;
  }
  dim3 grid((N + gemm_wg::BM - 1) / gemm_wg::BM, (M + BN - 1) / BN, split);
  gemm_wg_kernel<BN, TERMS><<<grid, gemm_wg::NT, smem, stream>>>(
      (const __nv_bfloat16*)w, (const float*)b, (const float*)x, (float*)y,
      split > 1 ? (float*)part : nullptr, M, K, N, act, kchunk / gemm_wg::BK);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || split == 1) return (int)e;
  long long mn = (long long)M * N;
  splitk_sum_kernel<<<(unsigned)((mn + 255) / 256), 256, 0, stream>>>(
      (const float*)part, (const float*)b, (float*)y, M, N, split, act);
  return (int)cudaGetLastError();
}

template <int TERMS>
int launch_wg_tile(int tile, const void* w, const void* b, const void* x, void* y, void* part,
                   int co, int ci, int L, int act, int split, int kchunk, cudaStream_t s) {
  switch (tile) {
    case 0: return launch_wg<16, TERMS>(w, b, x, y, part, co, ci, L, act, split, kchunk, s);
    case 1: return launch_wg<32, TERMS>(w, b, x, y, part, co, ci, L, act, split, kchunk, s);
    case 2: return launch_wg<48, TERMS>(w, b, x, y, part, co, ci, L, act, split, kchunk, s);
    case 3: return launch_wg<64, TERMS>(w, b, x, y, part, co, ci, L, act, split, kchunk, s);
    case 4: return launch_wg<80, TERMS>(w, b, x, y, part, co, ci, L, act, split, kchunk, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// terms = 3, the bf16x3 split on the mma.sync tile: whi and wlo (co, kp)
// bf16 (wl2 unused), tile 0 = 64x64, 1 = 32x64, 2 = 32x32, 3 = 16x32
// (megakernel.py:_GEMM_TILES), kchunk a multiple of 16.  terms = 1 (one bf16
// pass) or 6 (the six-term split), the wgmma tile: whi holds W's 1 or 3
// pieces laid out for a width of megakernel.py:_WG_TILES[tile] (16, 32, 48,
// 64, 80; lay_wgmma; wlo, wl2 and kp unused), kchunk a multiple of 64 (a
// K slice).  split > 1: ``part`` holds split * co * L floats and kchunk is
// each split's K range.
int bs_gemm(const void* whi, const void* wlo, const void* wl2, const void* b, const void* x,
            void* y, void* part, int co, int ci, int kp, int L, int act, int tile, int split,
            int kchunk, int terms, void* stream) {
  (void)wl2;
  cudaStream_t s = (cudaStream_t)stream;
  if (split < 1 || (split > 1 && part == nullptr) || (terms != 1 && terms != 3 && terms != 6))
    return (int)cudaErrorInvalidValue;
  if (terms == 3) {
    if (kchunk % 16 || kp % 8 || wlo == nullptr) return (int)cudaErrorInvalidValue;
    return launch_tile(tile, whi, wlo, b, x, y, part, co, ci, kp, L, act, split, kchunk, s);
  }
  if (kchunk % gemm_wg::BK || ((uintptr_t)whi & 15)) return (int)cudaErrorInvalidValue;
  if (terms == 6)
    return launch_wg_tile<6>(tile, whi, b, x, y, part, co, ci, L, act, split, kchunk, s);
  return launch_wg_tile<1>(tile, whi, b, x, y, part, co, ci, L, act, split, kchunk, s);
}

}  // extern "C"
