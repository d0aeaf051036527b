// Kernels of the flat continuation (K2'') for Hopper (sm_90a): the 1x1
// convs of the 33x33, C >= 96 regime as a tiled f32 GEMM, and the 1 -> N
// broadcast of the ASPP pooling branch.  Launched in plan order by
// backscrub_tpu_torch/ops/megakernel.py:BodyPlan(flat=True), beside the
// csrc/body.cu kernels the span also runs (dilated depthwise, global pool,
// elementwise, the pooled-vector 1x1).
//
// Replaces the TPU kernel backscrub_tpu/ops/megakernel.py:BodyMega in its
// flat mode (body_mega_continuation_for, the chain of dense-layout
// kernels).  There the 1x1 convs are (co, ci) @ (ci, rows*33) MXU dots,
// emulating XLA's HIGH precision as three bf16 passes.  Here the dot is
// plain f32 FFMA with f32 accumulation: at least as precise as the
// reference, and exactly the class of the plain PyTorch version (f32
// matmul with TF32 off).  No tensor cores in this version; a 3xTF32 or
// bf16x3 form is later work.
//
// The regime's 1x1 convs are GEMMs of M = co (96-512), K = ci (16-512),
// N = 1089 (deeplab: 1.31 GFLOP a frame in all): FLOPs, not bytes, are
// the work, while the serial-dot conv1x1_kernel of body.cu reads each
// input column once per output channel and issues one dependent FMA
// chain a thread.  Here each CTA computes a 64x64 output tile: 16-deep K
// slices of W and X are staged in shared memory, each of the 256 threads
// keeps a 4x4 register tile, so every shared-memory value read feeds 4
// FMAs and each input element is read from device memory once per 64
// output channels.  Ragged edges (N = 1089, co and ci not multiples of 64
// or 16) are masked: out-of-range W and X elements load as 0,
// out-of-range outputs are not stored.  Bias and the activation run in
// the epilogue.
//
// Bound, as measured on an H100 80GB HBM3 at 700 W: latency, not a roof.
// The 29 GEMMs of a deeplab frame run at ~2.9 TFLOP/s, a few per cent of
// the card's f32 FFMA peak: each K slice waits on its global loads (no
// double buffering), and grids of 36-144 CTAs leave much of the 132 SMs
// idle.  cp.async double buffering, smaller tiles or split-K for the
// narrow GEMMs, and tensor cores are the next steps.

#include <cuda_runtime.h>

#include "body_act.cuh"

namespace {

constexpr int BM = 64, BN = 64, BK = 16;   // output tile and K slice
constexpr int TR = 4, TC = 4;              // register tile a thread
constexpr int NT = (BM / TR) * (BN / TC);  // 256 threads

// y[m, n] = act(sum_k w[m, k] * x[k, n] + b[m]); w (M, K), x (K, N),
// y (M, N), all row-major f32.  Thread (ty, tx) of the 16x16 block owns
// rows ty + 16*i and columns tx + 16*j of the tile, so a warp's reads of
// the W slice are two broadcast addresses and its reads of the X slice
// are 16 consecutive words.
__global__ void __launch_bounds__(NT)
gemm_kernel(const float* __restrict__ w, const float* __restrict__ b,
            const float* __restrict__ x, float* __restrict__ y, int M, int K,
            int N, int act) {
  __shared__ float sw[BK][BM + 1];   // W slice, transposed: sw[k][m]
  __shared__ float sx[BK][BN];       // X slice: sx[k][n]
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TC), ty = tid / (BN / TC);
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  float acc[TR][TC];
#pragma unroll
  for (int i = 0; i < TR; ++i)
#pragma unroll
    for (int j = 0; j < TC; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int r = 0; r < BM * BK / NT; ++r) {
      int e = tid + NT * r;
      int row = e / BK, kk = e % BK;
      int gm = m0 + row, gk = k0 + kk;
      sw[kk][row] = (gm < M && gk < K) ? w[(long long)gm * K + gk] : 0.0f;
    }
#pragma unroll
    for (int r = 0; r < BK * BN / NT; ++r) {
      int e = tid + NT * r;
      int kk = e / BN, col = e % BN;
      int gk = k0 + kk, gn = n0 + col;
      sx[kk][col] = (gk < K && gn < N) ? x[(long long)gk * N + gn] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TR], v[TC];
#pragma unroll
      for (int i = 0; i < TR; ++i) a[i] = sw[kk][ty + (BM / TR) * i];
#pragma unroll
      for (int j = 0; j < TC; ++j) v[j] = sx[kk][tx + (BN / TC) * j];
#pragma unroll
      for (int i = 0; i < TR; ++i)
#pragma unroll
        for (int j = 0; j < TC; ++j) acc[i][j] = fmaf(a[i], v[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TR; ++i) {
    int m = m0 + ty + (BM / TR) * i;
    if (m >= M) continue;
    float bias = b[m];
#pragma unroll
    for (int j = 0; j < TC; ++j) {
      int n = n0 + tx + (BN / TC) * j;
      if (n < N) y[(long long)m * N + n] = activate(acc[i][j] + bias, act);
    }
  }
}

// y[c, l] = x[c]: a (C, 1) vector made constant over (C, L)
__global__ void bcast_kernel(const float* __restrict__ x, float* __restrict__ y,
                             int C, int L) {
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx < (long long)C * L) y[idx] = x[idx / L];
}

}  // namespace

extern "C" {

int bs_gemm(const void* w, const void* b, const void* x, void* y, int co,
            int ci, int L, int act, void* stream) {
  dim3 grid((L + BN - 1) / BN, (co + BM - 1) / BM);
  gemm_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(
      (const float*)w, (const float*)b, (const float*)x, (float*)y, co, ci, L,
      act);
  return (int)cudaGetLastError();
}

int bs_bcast(const void* x, void* y, int C, int L, void* stream) {
  long long n = (long long)C * L;
  bcast_kernel<<<(unsigned)((n + 255) / 256), 256, 0, (cudaStream_t)stream>>>(
      (const float*)x, (float*)y, C, L);
  return (int)cudaGetLastError();
}

}  // extern "C"
