// bs_gemm: the flat continuation's (K2'') tensor-core 1x1 conv as a
// standalone kernel for Hopper (sm_90a), the per-shape probe of the GEMM
// tile that the persistent kernel runs as its OP_GEMM (gemm_tc.cuh holds
// the tile for both; body_mega.cu runs the deeplab tables).
// ops/megakernel.py:conv1x1_gemm launches it; chip_smoke.py and
// tools/sweep_gemm_tiles.py time it against torch.addmm at each 1x1 shape
// of the deeplab frame.
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
// the tensor-core peak, set the pace.  Here four warps a CTA and several
// CTAs an SM hide each other's latency; the tile is picked per shape on the
// host (ops/megakernel.py:gemm_config, fitted to tools/sweep_gemm_tiles.py)
// from 64x64, 32x64, 32x32 and 16x32, and a deep K (ci >= 256) whose
// smallest-tile grid falls short is split over blockIdx.z, a second kernel
// summing the partials in a fixed order (no atomics: two runs give the same
// bits).  Bias and the activation run in the epilogue (or in the split-K
// pass).
//
// Bound (H100 SXM): the largest shape (ASPP 256x512 by 512x1089, 0.29
// GFLOP as three bf16 passes) needs ~0.9 us of tensor-core time and moves
// ~3.5 MB (~1 us at 3.35 TB/s); a launch is a few microseconds of latency.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "gemm_tc.cuh"

namespace {

constexpr int NT = 128;     // four warps a CTA

// y = act(W x + b) over the K range [kb, kb + kchunk) of blockIdx.z
// (kb = blockIdx.z * kchunk); with ``part`` the raw sums go to part[z]
// instead (split K).  whi/wlo/wl2 (M, Kp) bf16; x (K, N), y (M, N) f32.
template <int BM, int BN, int WARPS_M, int TERMS>
__global__ void __launch_bounds__(NT)
gemm_tc_kernel(const __nv_bfloat16* whi, const __nv_bfloat16* wlo, const __nv_bfloat16* wl2,
               const float* b, const float* x, float* y, float* part, int M, int K, int Kp,
               int N, int act, int kchunk) {
  using T = gemm_tc::Tile<BM, BN, WARPS_M, 4 / WARPS_M, 1, TERMS>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int kb = blockIdx.z * kchunk;
  const gemm_tc::Epilogue ep{b, act, nullptr, 0, y,
                             part == nullptr ? nullptr : part + (size_t)blockIdx.z * M * N};
  T::run(smem, whi, wlo, wl2, x, M, Kp, N, blockIdx.y * BM, blockIdx.x * BN, kb,
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

template <int BM, int BN, int WARPS_M, int TERMS>
int launch_gemm(const void* whi, const void* wlo, const void* wl2, const void* b,
                const void* x, void* y, void* part, int M, int K, int Kp, int N, int act,
                int split, int kchunk, cudaStream_t stream) {
  constexpr int smem = gemm_tc::Tile<BM, BN, WARPS_M, 4 / WARPS_M, 1, TERMS>::SMEM_BYTES;
  static bool ready = false;   // the attribute, once per process and instantiation
  if (!ready) {
    cudaError_t e = cudaFuncSetAttribute(gemm_tc_kernel<BM, BN, WARPS_M, TERMS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    ready = true;
  }
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, split);
  gemm_tc_kernel<BM, BN, WARPS_M, TERMS><<<grid, NT, smem, stream>>>(
      (const __nv_bfloat16*)whi, (const __nv_bfloat16*)wlo, (const __nv_bfloat16*)wl2,
      (const float*)b, (const float*)x, (float*)y, split > 1 ? (float*)part : nullptr, M, K,
      Kp, N, act, kchunk);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || split == 1) return (int)e;
  long long mn = (long long)M * N;
  splitk_sum_kernel<<<(unsigned)((mn + 255) / 256), 256, 0, stream>>>(
      (const float*)part, (const float*)b, (float*)y, M, N, split, act);
  return (int)cudaGetLastError();
}

template <int TERMS>
int launch_tile(int tile, const void* whi, const void* wlo, const void* wl2, const void* b,
                const void* x, void* y, void* part, int co, int ci, int kp, int L, int act,
                int split, int kchunk, cudaStream_t s) {
  switch (tile) {
    case 0: return launch_gemm<64, 64, 2, TERMS>(whi, wlo, wl2, b, x, y, part, co, ci, kp, L, act, split, kchunk, s);
    case 1: return launch_gemm<32, 64, 2, TERMS>(whi, wlo, wl2, b, x, y, part, co, ci, kp, L, act, split, kchunk, s);
    case 2: return launch_gemm<32, 32, 2, TERMS>(whi, wlo, wl2, b, x, y, part, co, ci, kp, L, act, split, kchunk, s);
    case 3: return launch_gemm<16, 32, 1, TERMS>(whi, wlo, wl2, b, x, y, part, co, ci, kp, L, act, split, kchunk, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// tile: 0 = 64x64, 1 = 32x64, 2 = 32x32, 3 = 16x32 (megakernel.py:_GEMM_TILES);
// split > 1: ``part`` holds split * co * L floats and kchunk (a multiple of
// 16) is each split's K range; terms: 3 = the bf16x3 split (whi and wlo), 1 =
// one bf16 pass (whi alone; wlo and wl2 may be null), 6 = the six-term
// split (whi, wlo and wl2)
int bs_gemm(const void* whi, const void* wlo, const void* wl2, const void* b, const void* x,
            void* y, void* part, int co, int ci, int kp, int L, int act, int tile, int split,
            int kchunk, int terms, void* stream) {
  if (split < 1 || kchunk % 16 || (split > 1 && part == nullptr) || kp % 8 ||
      (terms != 1 && terms != 3 && terms != 6) || (terms >= 3 && wlo == nullptr) ||
      (terms == 6 && wl2 == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (terms == 6)
    return launch_tile<6>(tile, whi, wlo, wl2, b, x, y, part, co, ci, kp, L, act, split, kchunk, s);
  if (terms == 3)
    return launch_tile<3>(tile, whi, wlo, wl2, b, x, y, part, co, ci, kp, L, act, split, kchunk, s);
  return launch_tile<1>(tile, whi, wlo, wl2, b, x, y, part, co, ci, kp, L, act, split, kchunk, s);
}

}  // extern "C"
