// Fused front for Hopper (sm_90a): bilateral + normalize + 3x3/s2 conv +
// activation on the model canvas.
//
// Replaces the TPU kernel backscrub_tpu/pipeline/edge.py:front_fused_call
// (_front_compute / _front_kernel).  The TPU version reads phase-split
// quadrant planes to dodge Mosaic's lane shifts; here the kernel reads the
// plain reflect-101-padded canvas (3, H+4, W+4) that two resize
// contractions build outside the kernel (as the JAX package builds its
// quadrant planes outside its kernel).
//
// Per canvas pixel: a 13-tap d=5 bilateral (sigma 100, L1 colour
// distance), round half to even, x scale + offset, and zero outside the
// canvas (the conv's SAME border in the normalized domain); then per conv
// output 27 x Cout FMAs with the weights staged in shared memory.  The
// parameter block comes in as a device pointer on every launch, so fronts
// of different models may run on different streams at once (a process-wide
// __constant__ bank reloaded per launch would race between streams).
//
// Bound: arithmetic and latency, not bytes.  A 48x80 conv output reads a
// 100x164x3 f32 canvas (~200 KB) and writes Cout planes (~250 KB at
// Cout = 16), while the bilateral costs 13 expf + ~100 flops per canvas
// pixel.  One CTA computes a 16x16 tile of conv outputs: it stages the
// 37x37x3 canvas tile (2-px bilateral halo + 1-px conv halo, 16 KB) in
// shared memory, computes each of the 33x33 normalized pixels once into
// shared memory, then each thread runs one output pixel's 27 x Cout FMAs
// (every thread reads the same weight at once: a shared-memory broadcast).
//
// Numerics follow the JAX expression sequence: rintf (not roundf) for
// jnp.round; the bilateral is csrc/bilateral.cuh's (shared with K5: expf,
// no contracted FMAs), and the normalization's multiply/add pair uses
// __fmul_rn/__fadd_rn so that nvcc cannot contract it into an FMA.  The 27-tap sum may use FMAs: that is
// the reassociation class the tolerance covers.

#include <cuda_runtime.h>

#include "bilateral.cuh"

namespace {

constexpr int TILE = 16;            // conv outputs per CTA side
constexpr int CT = 2 * TILE + 1;    // normalized pixels per side (33)
constexpr int PT = CT + 4;          // canvas pixels per side (37)
constexpr int MAX_COUT = 64;

__device__ __forceinline__ float activate(float x, int act) {
  if (act == 1) return fminf(fmaxf(x, 0.0f), 6.0f);  // RELU6
  if (act == 2) {                                     // HARD_SWISH
    float r = fminf(fmaxf(x + 3.0f, 0.0f), 6.0f);
    return __fmul_rn(__fmul_rn(x, r), 1.0f / 6.0f);
  }
  return x;
}

__global__ void __launch_bounds__(TILE * TILE)
front_kernel(const float* __restrict__ canvas, const float* __restrict__ params,
             float* __restrict__ out, int H, int W, int oh, int ow, int cout,
             int pad_lo_h, int pad_lo_w, int use_bilateral, float inv2sc,
             float scale, float offset, int act) {
  __shared__ float s_can[3][PT][PT + 1];
  __shared__ float s_nrm[3][CT][CT + 1];
  // rows 0..26: conv taps ((di*3+dj)*3+c) x cout, row 27: bias, then the 13
  // bilateral space weights
  __shared__ float s_par[28 * MAX_COUT + NTAPS];
  const int tid = threadIdx.x;
  for (int idx = tid; idx < 28 * cout + NTAPS; idx += blockDim.x)
    s_par[idx] = params[idx];
  const int i0 = blockIdx.y * TILE, j0 = blockIdx.x * TILE;
  // model coordinates of normalized tile pixel (0, 0)
  const int m0 = 2 * i0 - pad_lo_h, n0 = 2 * j0 - pad_lo_w;
  const int HP = H + 4, WP = W + 4;

  // canvas tile: model rows m0-2 .. m0+CT+1 = padded rows m0 .. m0+PT-1
  for (int idx = tid; idx < 3 * PT * PT; idx += blockDim.x) {
    int c = idx / (PT * PT), r = (idx / PT) % PT, s = idx % PT;
    int pr = m0 + r, pc = n0 + s;
    float v = 0.0f;
    if (pr >= 0 && pr < HP && pc >= 0 && pc < WP)
      v = canvas[((long long)c * HP + pr) * WP + pc];
    s_can[c][r][s] = v;
  }
  __syncthreads();

  const float* sw = s_par + 28 * cout;
  for (int idx = tid; idx < CT * CT; idx += blockDim.x) {
    int r = idx / CT, s = idx % CT;
    int m = m0 + r, n = n0 + s;
    if (m < 0 || m >= H || n < 0 || n >= W) {
      s_nrm[0][r][s] = s_nrm[1][r][s] = s_nrm[2][r][s] = 0.0f;
      continue;
    }
    float val[3] = {s_can[0][r + 2][s + 2], s_can[1][r + 2][s + 2],
                    s_can[2][r + 2][s + 2]};
    if (use_bilateral) {
      bilateral13(&s_can[0][r + 2][s + 2], &s_can[1][r + 2][s + 2],
                  &s_can[2][r + 2][s + 2], PT + 1, sw, inv2sc, val);
#pragma unroll
      for (int c = 0; c < 3; ++c) val[c] = rintf(val[c]);
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) s_nrm[c][r][s] = __fadd_rn(__fmul_rn(val[c], scale), offset);
  }
  __syncthreads();

  const int ty = tid / TILE, tx = tid % TILE;
  const int i = i0 + ty, j = j0 + tx;
  if (i >= oh || j >= ow) return;
  float x[27];
#pragma unroll
  for (int di = 0; di < 3; ++di)
#pragma unroll
    for (int dj = 0; dj < 3; ++dj)
#pragma unroll
      for (int c = 0; c < 3; ++c)
        x[(di * 3 + dj) * 3 + c] = s_nrm[c][2 * ty + di][2 * tx + dj];
  for (int o = 0; o < cout; ++o) {
    float acc = s_par[27 * cout + o];
#pragma unroll
    for (int t = 0; t < 27; ++t) acc = fmaf(x[t], s_par[t * cout + o], acc);
    out[((long long)o * oh + i) * ow + j] = activate(acc, act);
  }
}

}  // namespace

// canvas: (3, H+4, W+4) f32, reflect-101 padded by 2, rounded, planes in
// the weights' input-channel order; params: (28*cout + 13) f32 device
// array (taps x cout, bias, bilateral space weights); out: (cout, oh, ow).
// act: 0 NONE, 1 RELU6, 2 HARD_SWISH.
extern "C" int bs_front(const void* canvas, const void* params, void* out,
                        int H, int W, int oh, int ow, int cout, int pad_lo_h,
                        int pad_lo_w, int use_bilateral, float inv2sc,
                        float scale, float offset, int act, void* stream) {
  if (cout < 1 || cout > MAX_COUT) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  dim3 grid((ow + TILE - 1) / TILE, (oh + TILE - 1) / TILE);
  front_kernel<<<grid, TILE * TILE, 0, s>>>(
      (const float*)canvas, (const float*)params, (float*)out, H, W, oh, ow,
      cout, pad_lo_h, pad_lo_w, use_bilateral, inv2sc, scale, offset, act);
  return (int)cudaGetLastError();
}
