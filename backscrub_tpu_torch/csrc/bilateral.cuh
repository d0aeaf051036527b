// The d=5 bilateral at one pixel, shared by K1 (csrc/front.cu) and K5
// (csrc/bilateral.cu) so that the two cannot drift apart.
//
// cv::bilateralFilter(d=5, sigmaColor=100, sigmaSpace=100) as the JAX
// package computes it (pipeline/image.py:bilateral5): OpenCV's 13-tap
// circular window in backscrub's tap order, L1 colour distance over the
// three channels, weight sw[t] * exp(inv2sc * d * d), num / den last.  The
// expression sequence is the plain version's: expf (not __expf), and
// __fmul_rn / __fadd_rn so that nvcc cannot contract a multiply and an add
// into an FMA.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int NTAPS = 13;

// OpenCV's d=5 bilateral window in backscrub's tap order
__constant__ int c_di[NTAPS] = {-2, -1, -1, -1, 0, 0, 0, 0, 0, 1, 1, 1, 2};
__constant__ int c_dj[NTAPS] = {0, -1, 0, 1, -2, -1, 0, 1, 2, -1, 0, 1, 0};

// p0, p1, p2: the centre pixel in three planes whose rows are ld floats
// apart, with at least a 2-px halo around it; sw: the 13 space weights.
// Writes the unrounded filtered value of each channel to out.
__device__ __forceinline__ void bilateral13(const float* p0, const float* p1,
                                            const float* p2, int ld,
                                            const float* sw, float inv2sc,
                                            float out[3]) {
  const float ctr[3] = {p0[0], p1[0], p2[0]};
  float num[3] = {0.0f, 0.0f, 0.0f}, den = 0.0f;
  for (int t = 0; t < NTAPS; ++t) {
    const int off = c_di[t] * ld + c_dj[t];
    const float nb[3] = {p0[off], p1[off], p2[off]};
    const float cd = __fadd_rn(__fadd_rn(fabsf(nb[0] - ctr[0]), fabsf(nb[1] - ctr[1])),
                               fabsf(nb[2] - ctr[2]));
    const float wgt = __fmul_rn(sw[t], expf(__fmul_rn(__fmul_rn(inv2sc, cd), cd)));
#pragma unroll
    for (int c = 0; c < 3; ++c) num[c] = __fadd_rn(num[c], __fmul_rn(wgt, nb[c]));
    den = __fadd_rn(den, wgt);
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) out[c] = num[c] / den;
}

}  // namespace
