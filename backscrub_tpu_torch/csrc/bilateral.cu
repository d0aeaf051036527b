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
// Bound: bytes, barely.  Each pixel reads 12 B and writes 12 B (0.37 MB at
// the 96x160 segm canvas, 0.11 us at 3.35 TB/s; 1.59 MB at the 257x257
// deeplab canvas, 0.47 us) and costs ~250 operations (its 13 expf counted
// as one each): ~17 MFLOP at 257x257, ~0.25 us at the 67 TFLOP/s f32
// peak.  At these sizes what costs is one CTA's serial chain (stage, then
// 13 taps) on top of the launch, so the design keeps the chain short and
// the card full:
//   - one CTA computes a 4x32 tile, one pixel a thread, so the 96x160 canvas
//     is 120 CTAs (60 of the earlier 32x8) and the 257x257 canvas 585, one
//     wave on 132 SMs;
//   - it stages the 8 x 36 x 3 halo window with 4-byte cp.async, each warp
//     a window row, lanes on consecutive floats of the interleaved row,
//     into three planes; the reflect-101 row is computed once a row and
//     each lane's columns once a lane, every copy in flight before one
//     commit and one wait.  Rows at 257x257 are 3,084 B apart, not 16-byte
//     aligned, so 4-byte copies serve every shape.

#include <cuda_runtime.h>

#include "async_copy.cuh"
#include "bilateral.cuh"

namespace {

constexpr int TH = 4, TW = 32;        // output pixels per CTA
constexpr int SH = TH + 4, LD = TW + 5; // window rows; plane row pitch

// reflect-101 of x into [0, n), clamped so that window columns and rows
// past the frame's 2-px halo (read by no pixel) stay inside the frame
__device__ __forceinline__ int reflect101(int x, int n) {
  if (x < 0) x = -x;
  if (x >= n) x = 2 * n - 2 - x;
  return min(max(x, 0), n - 1);
}

__global__ void __launch_bounds__(TH * TW)
bilateral_kernel(const float* __restrict__ in, const float* __restrict__ sw,
                 float* __restrict__ out, int H, int W, float inv2sc) {
  constexpr int NWARP = TH * TW / 32;
  constexpr int ROWF = 3 * (TW + 4);         // floats of an interleaved window row
  constexpr int PER = (ROWF + 31) / 32;      // of them a lane
  static_assert((TH * TW) % 32 == 0, "whole warps");
  __shared__ float s[3 * SH * LD];
  __shared__ float s_sw[NTAPS];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long frame = (long long)blockIdx.z * H * W * 3;
  const int i0 = blockIdx.y * TH, j0 = blockIdx.x * TW;

  if (tid < NTAPS) cp_async4(&s_sw[tid], sw + tid, true);
  // a lane's floats f = lane + 32k of a window row: the frame column's
  // offset in an interleaved row, and the plane element it lands in
  int src[PER], dst[PER];
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int f = lane + 32 * k, sc = f / 3, c = f - 3 * sc;
    src[k] = reflect101(j0 - 2 + sc, W) * 3 + c;
    dst[k] = c * SH * LD + sc;
  }
  for (int r = warp; r < SH; r += NWARP) {
    const float* row = in + frame + (long long)reflect101(i0 - 2 + r, H) * W * 3;
#pragma unroll
    for (int k = 0; k < PER; ++k)
      if (lane + 32 * k < ROWF) cp_async4(&s[dst[k] + r * LD], row + src[k], true);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int ty = tid / TW, tx = tid - ty * TW;
  const int i = i0 + ty, j = j0 + tx;
  if (i >= H || j >= W) return;
  const int ctr = (ty + 2) * LD + tx + 2;
  float v[3];
  bilateral13(&s[ctr], &s[SH * LD + ctr], &s[2 * SH * LD + ctr], LD, s_sw, inv2sc, v);
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
  bilateral_kernel<<<grid, TH * TW, 0, (cudaStream_t)stream>>>(
      (const float*)in, (const float*)sw, (float*)out, h, w, inv2sc);
  return (int)cudaGetLastError();
}
