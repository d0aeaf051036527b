// bs_gemm: the flat continuation's (K2'') tensor-core 1x1 conv as a
// standalone kernel for Hopper (sm_90a), the per-shape probe of the GEMM
// tile that the persistent kernel runs as its OP_GEMM (body_mega.cu runs
// the deeplab tables): gemm_wg.cuh's wgmma tile at one, three or six
// terms.  ops/megakernel.py:conv1x1_gemm launches it; chip_smoke.py and
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
// the tensor-core peak, set the pace.  The tile is the table's: 64
// positions by a width that makes the grid one round over the SMs
// (gemm_wg.cuh; the width and split picked on the host by
// ops/megakernel.py:gemm_config, fitted to tools/sweep_gemm_tiles.py).  A
// deep K (ci >= 256) whose grid leaves SMs idle is split over blockIdx.z on
// whole 64-deep slices, a second kernel summing the partials in a fixed
// order (no atomics: two runs give the same bits).  Bias and the
// activation run in the epilogue (or in the split-K pass).
//
// Bound (H100 SXM): at the largest shape (ASPP 256x512 by 512x1089) three
// terms move ~3.9 MB (1.16 us at 3.35 TB/s) and need 0.87 us of the bf16
// rate; a launch is a few microseconds of latency.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "gemm_wg.cuh"

namespace {

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
  const gemm_wg::Epilogue ep{b, act, nullptr, 0, y,
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

// y (co, L) = act(W x + b) for x (ci, L): ``w`` holds W's 1, 2 or 3 bf16
// pieces (terms 1, 3 or 6) laid out for a width of
// megakernel.py:_WG_TILES[tile] (16, 32, 48, 64, 80; lay_wgmma), 16-byte
// aligned; kchunk a multiple of 64 (a K slice).  split > 1: ``part`` holds
// split * co * L floats and kchunk is each split's K range.
int bs_gemm(const void* w, const void* b, const void* x, void* y, void* part, int co, int ci,
            int L, int act, int tile, int split, int kchunk, int terms, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (split < 1 || (split > 1 && part == nullptr) || kchunk % gemm_wg::BK ||
      ((uintptr_t)w & 15))
    return (int)cudaErrorInvalidValue;
  switch (terms) {
    case 1: return launch_wg_tile<1>(tile, w, b, x, y, part, co, ci, L, act, split, kchunk, s);
    case 3: return launch_wg_tile<3>(tile, w, b, x, y, part, co, ci, L, act, split, kchunk, s);
    case 6: return launch_wg_tile<6>(tile, w, b, x, y, part, co, ci, L, act, split, kchunk, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
