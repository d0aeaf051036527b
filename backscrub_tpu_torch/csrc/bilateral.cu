// Standalone d=5 bilateral filter for Hopper (sm_90a): K5.
//
// Replaces the TPU kernel backscrub_tpu/ops/pallas_kernels.py:
// bilateral5_pallas (_bilateral_kernel), which the classic preprocess runs
// on the letterboxed model canvas (pipeline/maskgen.py:preprocess).  Input
// and output are (N, H, W, 3) f32 holding u8-range values, the JAX
// package's layout; the output is unrounded (the caller rounds).  The TPU
// wrapper transposes to (N, 3, H, W) and reflect-pads in XLA before the
// kernel; here the kernel reads the interleaved frame directly and applies
// reflect-101 while it stages its tile, so the wrapper launches nothing
// but the kernel.
//
// Per pixel: csrc/bilateral.cuh's 13-tap bilateral, the very device code
// K1 (csrc/front.cu) runs, so the two cannot drift apart.
//
// Bound: bytes, barely.  Each pixel reads 12 B and writes 12 B (1.59 MB at
// the 257x257 deeplab canvas, 0.47 us at 3.35 TB/s) and costs 13 expf plus
// ~200 flops (~17 MFLOP at 257x257, ~0.3 us at the 67 TFLOP/s f32 peak).
// At these sizes the launch itself dominates.  One CTA computes a 32x8
// tile, one pixel per thread: it stages the 36x12x3 halo tile (5 KB) in
// shared memory as three planes, reading the interleaved rows with
// consecutive threads on consecutive floats, so each input float is read
// from device memory about 1.7 times (the halo) and each output written
// once.

#include <cuda_runtime.h>

#include "bilateral.cuh"

namespace {

constexpr int TW = 32, TH = 8;        // output pixels per CTA
constexpr int SW = TW + 4, SH = TH + 4;

__device__ __forceinline__ int reflect101(int x, int n) {
  if (x < 0) x = -x;
  if (x >= n) x = 2 * n - 2 - x;
  return x;
}

__global__ void __launch_bounds__(TW * TH)
bilateral_kernel(const float* __restrict__ in, const float* __restrict__ sw,
                 float* __restrict__ out, int H, int W, float inv2sc) {
  __shared__ float s[3][SH][SW + 1];
  __shared__ float s_sw[NTAPS];
  const int tid = threadIdx.x;
  if (tid < NTAPS) s_sw[tid] = sw[tid];
  const long long frame = (long long)blockIdx.z * H * W * 3;
  const int i0 = blockIdx.y * TH, j0 = blockIdx.x * TW;
  for (int idx = tid; idx < SH * SW * 3; idx += TW * TH) {
    const int r = idx / (SW * 3), rem = idx % (SW * 3);
    const int sc = rem / 3, c = rem % 3;
    const int gr = reflect101(i0 - 2 + r, H), gc = reflect101(j0 - 2 + sc, W);
    s[c][r][sc] = in[frame + ((long long)gr * W + gc) * 3 + c];
  }
  __syncthreads();
  const int ty = tid / TW, tx = tid % TW;
  const int i = i0 + ty, j = j0 + tx;
  if (i >= H || j >= W) return;
  float v[3];
  bilateral13(&s[0][ty + 2][tx + 2], &s[1][ty + 2][tx + 2], &s[2][ty + 2][tx + 2],
              SW + 1, s_sw, inv2sc, v);
  float* o = out + frame + ((long long)i * W + j) * 3;
#pragma unroll
  for (int c = 0; c < 3; ++c) o[c] = v[c];
}

}  // namespace

// in, out: (n, h, w, 3) f32, h and w at least 3 (reflect-101 of a 2-px
// halo); sw: the 13 space weights, f32 on the device.
extern "C" int bs_bilateral(const void* in, const void* sw, void* out, int n,
                            int h, int w, float inv2sc, void* stream) {
  if (n <= 0) return 0;
  if (h < 3 || w < 3 || n > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid((w + TW - 1) / TW, (h + TH - 1) / TH, n);
  bilateral_kernel<<<grid, TW * TH, 0, (cudaStream_t)stream>>>(
      (const float*)in, (const float*)sw, (float*)out, h, w, inv2sc);
  return (int)cudaGetLastError();
}
