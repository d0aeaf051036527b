// Kernels of the flat continuation (K2'') for Hopper (sm_90a): the 1x1
// convs of the 33x33, C >= 96 regime as a tensor-core GEMM, and the 1 -> N
// broadcast of the ASPP pooling branch.  Launched in plan order by
// backscrub_tpu_torch/ops/megakernel.py:BodyPlan(flat=True), beside the
// csrc/body.cu kernels the span also runs (dilated depthwise, global pool,
// elementwise, the pooled-vector 1x1).
//
// Replaces the TPU kernel backscrub_tpu/ops/megakernel.py:BodyMega in its
// flat mode (body_mega_continuation_for, the chain of dense-layout
// kernels).  There the 1x1 convs are (co, ci) @ (ci, rows*33) MXU dots
// emulating XLA's HIGH precision as three bf16 passes
// (megakernel.py:501-515): a = hi + lo with hi = bf16_rn(a) and lo =
// bf16_rn(a - hi), and hi.hi + hi.lo + lo.hi summed in f32, lo.lo dropped.
// Here the same three products run on Hopper's tensor cores as
// mma.sync.aligned.m16n8k16 bf16 -> f32 (warp-level MMA; no wgmma), so the
// kernel stays in the reference's numerics class.  W is a constant of the
// plan: the host splits it once into W_hi and W_lo (bf16, rows padded to a
// multiple of 8 with zeros); X is split here, from the f32 tile in shared
// memory, while the MMA fragments are built.  hi.hi accumulates in one
// f32 register tile and hi.lo + lo.hi in a second, added in the epilogue.
//
// The regime's GEMMs are small (M = co 16-480, K = ci 16-512, N = 1089):
// 1.3 GFLOP a deeplab frame in 29 launches, so latency and grid fill, not
// the tensor-core peak, set the pace.  The design answers both:
// - a ring of STAGES (5) K slices in shared memory filled with cp.async,
//   so slices k+1..k+4 load while slice k multiplies (cp.async.wait_group);
// - the tile is picked per shape on the host (ops/megakernel.py:
//   gemm_config, fitted to tools/sweep_gemm_tiles.py) from 64x64, 32x64,
//   32x32 and 16x32: the largest whose grid reaches 2-3 waves of the SMs,
//   since several CTAs an SM hide each other's latency; a deep K (ci >=
//   256) whose smallest-tile grid falls short is split over blockIdx.z,
//   and a second kernel sums the partials in a fixed order (no atomics:
//   two runs give the same bits);
// - ragged edges (N = 1089, co and ci not multiples of the tile) load as
//   zeros (cp.async with src-size 0) and are not stored.
// Bias and the activation run in the epilogue (or in the split-K pass).
//
// Bound (H100 SXM): the largest shape (ASPP 256x512 by 512x1089, 0.29
// GFLOP as three bf16 passes) needs ~0.9 us of tensor-core time and moves
// ~3.5 MB (~1 us at 3.35 TB/s); each launch is a few microseconds of
// latency: the pipeline depth and the grid fill are what the tile choice
// buys.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "async_copy.cuh"
#include "body_act.cuh"

namespace {

constexpr int BK = 32;      // K depth of a ring stage: two k16 MMA steps
constexpr int STAGES = 5;   // cp.async ring depth
constexpr int NT = 128;     // four warps a CTA
constexpr int WPAD = 8;     // bf16 pad of a W tile row: conflict-free A fragments
constexpr int XPAD = 4;     // f32 pad of an X tile row: conflict-free B fragments

// d += a (16x16 bf16, row) * b (16x8 bf16, col), f32 accumulate
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// the reference's split of two f32 values (k, k+1) into packed bf16 pairs
__device__ __forceinline__ void split2(float v0, float v1, uint32_t& hi, uint32_t& lo) {
  __nv_bfloat16 h0 = __float2bfloat16_rn(v0), h1 = __float2bfloat16_rn(v1);
  __nv_bfloat16 l0 = __float2bfloat16_rn(v0 - __bfloat162float(h0));
  __nv_bfloat16 l1 = __float2bfloat16_rn(v1 - __bfloat162float(h1));
  hi = (uint32_t)__bfloat16_as_ushort(h0) | ((uint32_t)__bfloat16_as_ushort(h1) << 16);
  lo = (uint32_t)__bfloat16_as_ushort(l0) | ((uint32_t)__bfloat16_as_ushort(l1) << 16);
}

template <int BM, int BN>
constexpr int gemm_smem_bytes() {
  return STAGES * (2 * BM * (BK + WPAD) * 2 + BK * (BN + XPAD) * 4);
}

// y[m, n] = act(sum_k w[m, k] * x[k, n] + b[m]) for the K range of
// blockIdx.z ([kb, kb + kchunk)); with ``part`` the raw sums go to
// part[z][m][n] instead (split K).  whi/wlo (M, Kp) bf16, Kp = K rounded
// up to 8 with zero columns; x (K, N), y (M, N) f32, row-major.  The four
// warps tile the CTA's BM x BN block WARPS_M x (4 / WARPS_M); a warp holds
// MF x NF m16n8 accumulators (two sets: hi.hi and the cross terms).
template <int BM, int BN, int WARPS_M>
__global__ void __launch_bounds__(NT)
gemm_tc_kernel(const __nv_bfloat16* __restrict__ whi, const __nv_bfloat16* __restrict__ wlo,
               const float* __restrict__ b, const float* __restrict__ x,
               float* __restrict__ y, float* __restrict__ part, int M, int K, int Kp,
               int N, int act, int kchunk) {
  constexpr int WARPS_N = 4 / WARPS_M;
  constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N;
  constexpr int MF = WM / 16, NF = WN / 8;
  constexpr int WS = BK + WPAD;   // bf16 row stride of a W tile
  constexpr int XS = BN + XPAD;   // f32 row stride of an X tile
  static_assert(MF >= 1 && NF >= 1 && WM % 16 == 0 && WN % 8 == 0, "warp tile");
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sw = reinterpret_cast<__nv_bfloat16*>(smem);     // [STAGES][2][BM][WS]
  float* sx = reinterpret_cast<float*>(smem + STAGES * 2 * BM * WS * 2);  // [STAGES][BK][XS]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int kb = blockIdx.z * kchunk;
  const int kend_w = min(kb + kchunk, Kp), kend_x = min(kb + kchunk, K);
  const int nk = (kend_w - kb + BK - 1) / BK;

  auto load = [&](int stage, int k0) {
    constexpr int WCH = BM * (BK / 8);          // 16-byte chunks of one W tile
    for (int e = tid; e < 2 * WCH; e += NT) {
      int which = e / WCH, r = e % WCH;
      int row = r / (BK / 8), ch = r % (BK / 8);
      int gm = m0 + row, gk = k0 + ch * 8;
      bool ok = gm < M && gk < kend_w;
      const __nv_bfloat16* base = which ? wlo : whi;
      cp_async16(sw + ((stage * 2 + which) * BM + row) * WS + ch * 8,
                 base + (ok ? (size_t)gm * Kp + gk : 0), ok);
    }
    for (int e = tid; e < BK * BN; e += NT) {
      int kk = e / BN, col = e % BN;
      int gk = k0 + kk, gn = n0 + col;
      bool ok = gk < kend_x && gn < N;
      cp_async4(sx + (stage * BK + kk) * XS + col, x + (ok ? (size_t)gk * N + gn : 0), ok);
    }
  };

  float acc[MF][NF][4], cor[MF][NF][4];
#pragma unroll
  for (int i = 0; i < MF; ++i)
#pragma unroll
    for (int j = 0; j < NF; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = cor[i][j][q] = 0.0f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load(s, kb + s * BK);
    cp_async_commit();
  }
  for (int it = 0; it < nk; ++it) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();   // slice ``it`` landed; every warp is done with it - 1
    int nx = it + STAGES - 1;
    if (nx < nk) load(nx % STAGES, kb + nx * BK);
    cp_async_commit();

    const int st = it % STAGES;
    const __nv_bfloat16* ah_s = sw + (st * 2 + 0) * BM * WS;
    const __nv_bfloat16* al_s = sw + (st * 2 + 1) * BM * WS;
    const float* xs = sx + st * BK * XS;
#pragma unroll
    for (int ks = 0; ks < BK; ks += 16) {
      uint32_t ah[MF][4], al[MF][4], bh[NF][2], bl[NF][2];
#pragma unroll
      for (int i = 0; i < MF; ++i) {
        int r = wm * WM + i * 16 + g;
        int c = ks + 2 * t;
        ah[i][0] = *reinterpret_cast<const uint32_t*>(ah_s + r * WS + c);
        ah[i][1] = *reinterpret_cast<const uint32_t*>(ah_s + (r + 8) * WS + c);
        ah[i][2] = *reinterpret_cast<const uint32_t*>(ah_s + r * WS + c + 8);
        ah[i][3] = *reinterpret_cast<const uint32_t*>(ah_s + (r + 8) * WS + c + 8);
        al[i][0] = *reinterpret_cast<const uint32_t*>(al_s + r * WS + c);
        al[i][1] = *reinterpret_cast<const uint32_t*>(al_s + (r + 8) * WS + c);
        al[i][2] = *reinterpret_cast<const uint32_t*>(al_s + r * WS + c + 8);
        al[i][3] = *reinterpret_cast<const uint32_t*>(al_s + (r + 8) * WS + c + 8);
      }
#pragma unroll
      for (int j = 0; j < NF; ++j) {
        int col = wn * WN + j * 8 + g;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          int k = ks + 2 * t + 8 * h;
          split2(xs[k * XS + col], xs[(k + 1) * XS + col], bh[j][h], bl[j][h]);
        }
      }
#pragma unroll
      for (int i = 0; i < MF; ++i)
#pragma unroll
        for (int j = 0; j < NF; ++j) {
          mma_bf16(acc[i][j], ah[i], bh[j]);
          mma_bf16(cor[i][j], ah[i], bl[j]);
          mma_bf16(cor[i][j], al[i], bh[j]);
        }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < MF; ++i)
#pragma unroll
    for (int j = 0; j < NF; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        int row = m0 + wm * WM + i * 16 + g + (q >= 2 ? 8 : 0);
        int col = n0 + wn * WN + j * 8 + 2 * t + (q & 1);
        if (row >= M || col >= N) continue;
        float v = acc[i][j][q] + cor[i][j][q];
        if (part != nullptr)
          part[((size_t)blockIdx.z * M + row) * N + col] = v;
        else
          y[(size_t)row * N + col] = activate(v + b[row], act);
      }
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
  constexpr int smem = gemm_smem_bytes<BM, BN>();
  static bool ready = false;   // the attribute, once per process and instantiation
  if (!ready) {
    cudaError_t e = cudaFuncSetAttribute(gemm_tc_kernel<BM, BN, WARPS_M>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    ready = true;
  }
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, split);
  gemm_tc_kernel<BM, BN, WARPS_M><<<grid, NT, smem, stream>>>(
      (const __nv_bfloat16*)whi, (const __nv_bfloat16*)wlo, (const float*)b,
      (const float*)x, (float*)y, split > 1 ? (float*)part : nullptr, M, K, Kp, N, act,
      kchunk);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || split == 1) return (int)e;
  long long mn = (long long)M * N;
  splitk_sum_kernel<<<(unsigned)((mn + 255) / 256), 256, 0, stream>>>(
      (const float*)part, (const float*)b, (float*)y, M, N, split, act);
  return (int)cudaGetLastError();
}

// y[c, l] = x[c]: a (C, 1) vector made constant over (C, L)
__global__ void bcast_kernel(const float* __restrict__ x, float* __restrict__ y,
                             int C, int L) {
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx < (long long)C * L) y[idx] = x[idx / L];
}

}  // namespace

extern "C" {

// tile: 0 = 64x64, 1 = 32x64, 2 = 32x32, 3 = 16x32 (megakernel.py:_GEMM_TILES);
// split > 1: ``part`` holds split * co * L floats and kchunk (a multiple of
// 16) is each split's K range
int bs_gemm(const void* whi, const void* wlo, const void* b, const void* x, void* y,
            void* part, int co, int ci, int kp, int L, int act, int tile, int split,
            int kchunk, void* stream) {
  if (split < 1 || kchunk % 16 || (split > 1 && part == nullptr) || kp % 8)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (tile) {
    case 0: return launch_gemm<64, 64, 2>(whi, wlo, b, x, y, part, co, ci, kp, L, act, split, kchunk, s);
    case 1: return launch_gemm<32, 64, 2>(whi, wlo, b, x, y, part, co, ci, kp, L, act, split, kchunk, s);
    case 2: return launch_gemm<32, 32, 2>(whi, wlo, b, x, y, part, co, ci, kp, L, act, split, kchunk, s);
    case 3: return launch_gemm<16, 32, 1>(whi, wlo, b, x, y, part, co, ci, kp, L, act, split, kchunk, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

int bs_bcast(const void* x, void* y, int C, int L, void* stream) {
  long long n = (long long)C * L;
  bcast_kernel<<<(unsigned)((n + 255) / 256), 256, 0, (cudaStream_t)stream>>>(
      (const float*)x, (float*)y, C, L);
  return (int)cudaGetLastError();
}

}  // extern "C"
