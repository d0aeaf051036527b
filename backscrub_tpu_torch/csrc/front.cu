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
// Bound: latency, not bytes or arithmetic.  A 48x80 conv output reads a
// 100x164x3 f32 canvas (~200 KB) and writes Cout planes (~250 KB at
// Cout = 16): a fraction of a microsecond at HBM rate, and the bilateral's
// 13 expf a canvas pixel is as small next to the card's peak.  What costs
// is one CTA's serial chain, so the design keeps it short and puts several
// CTAs on an SM:
//   - one CTA computes a TH x TW tile of conv outputs in G channel groups,
//     4x8x8 or 4x16x4 (the host picks one per shape and card:
//     pipeline/edge.py:front_tile), so a 48x80 output is 120 CTAs of 4x8
//     and a 129x129 one 297 of 4x16;
//   - it stages the (2TH+5) x (2TW+5) x 3 canvas window (2-px bilateral
//     halo + 1-px conv halo) with 4-byte cp.async, each warp a row, lanes
//     on consecutive floats, zero-filled outside the canvas, and the
//     parameter block the same way, all in flight at once;
//   - its threads compute the (2TH+1) x (2TW+1) normalized pixels, one
//     each (the CTA has at least that many threads), into shared memory;
//   - each thread then runs one output pixel for Cout/G of the channels
//     (G channel groups, a group per warp, so every lane reads the same
//     weights: a broadcast), CHUNK independent accumulators at a time
//     (4, or 2 with 8 groups: Cout = 16 over 8 groups is 2 a thread), the
//     CHUNK weights of a tap in one vector load where Cout allows.
// A stream batch of N canvases (N, 3, H+4, W+4) is one launch: the canvas
// index is blockIdx.z, the grid's x and y the one-canvas grid of the tile
// that pipeline/edge.py:front_tile picks for ONE canvas.  Folding the
// canvases into the tile count instead would buy nothing (the grid has
// room for 65535 canvases) and would make the tile choice and each CTA's
// position depend on N; this way a CTA computes exactly the outputs, from
// exactly the window, of the same CTA of a one-canvas launch, so a batch
// gives each canvas the bits of its own launch.  At 48x80 a canvas is 120
// CTAs: a batch of 8 fills the 132 SMs about seven times, where one canvas
// leaves 12 of them idle.
//
// Numerics follow the JAX expression sequence: rintf (not roundf) for
// jnp.round; the bilateral is csrc/bilateral.cuh's (shared with K5: expf,
// no contracted FMAs), and the normalization's multiply/add pair uses
// __fmul_rn/__fadd_rn so that nvcc cannot contract it into an FMA.  Each
// output's 27-tap sum is one fmaf chain from the bias in tap order
// ((di*3+dj)*3+c): the same bits for every tile shape.  Against the plain
// version (F.conv2d) the sum's order differs: the reassociation class the
// tolerance covers.

#include <cuda_runtime.h>

#include "async_copy.cuh"
#include "bilateral.cuh"

namespace {

constexpr int MAX_COUT = 64;
constexpr int NPAR = 28 * MAX_COUT + NTAPS;

__device__ __forceinline__ float activate(float x, int act) {
  if (act == 1) return fminf(fmaxf(x, 0.0f), 6.0f);  // RELU6
  if (act == 2) {                                     // HARD_SWISH
    float r = fminf(fmaxf(x + 3.0f, 0.0f), 6.0f);
    return __fmul_rn(__fmul_rn(x, r), 1.0f / 6.0f);
  }
  return x;
}

// N consecutive floats of shared memory, 4N-byte aligned, in one load
template <int N>
__device__ __forceinline__ void load_vec(const float* p, float* w);
template <>
__device__ __forceinline__ void load_vec<4>(const float* p, float* w) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
}
template <>
__device__ __forceinline__ void load_vec<2>(const float* p, float* w) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  w[0] = v.x, w[1] = v.y;
}

// One output pixel's channels [o_lo, o_hi): x its 27 normalized inputs in
// tap order, par the parameter block; CHUNK channels at a time, each one
// fmaf chain from the bias in tap order.  A chunk's lanes past o_hi repeat
// channel o_hi - 1 and store nothing.  VEC: cout and o_lo are multiples of
// CHUNK, so a chunk's weights of a tap are CHUNK consecutive, aligned
// floats, read in one load.
template <int CHUNK, bool VEC>
__device__ __forceinline__ void conv_channels(const float* x, const float* par, int cout,
                                              int o_lo, int o_hi, float* dst,
                                              long long plane, int act) {
  for (int o0 = o_lo; o0 < o_hi; o0 += CHUNK) {
    int oc[CHUNK];
    float acc[CHUNK];
#pragma unroll
    for (int k = 0; k < CHUNK; ++k) {
      oc[k] = min(o0 + k, o_hi - 1);
      acc[k] = par[27 * cout + oc[k]];
    }
#pragma unroll
    for (int t = 0; t < 27; ++t) {
      float wt[CHUNK];
      if (VEC) {
        load_vec<CHUNK>(&par[t * cout + o0], wt);
      } else {
#pragma unroll
        for (int k = 0; k < CHUNK; ++k) wt[k] = par[t * cout + oc[k]];
      }
#pragma unroll
      for (int k = 0; k < CHUNK; ++k) acc[k] = fmaf(x[t], wt[k], acc[k]);
    }
#pragma unroll
    for (int k = 0; k < CHUNK; ++k)
      if (o0 + k < o_hi) dst[(o0 + k) * plane] = activate(acc[k], act);
  }
}

// Threads of a CTA: one an (output, channel group), and at least one a
// normalized pixel, in whole warps
__host__ __device__ constexpr int front_threads(int th, int tw, int g) {
  return (((2 * th + 1) * (2 * tw + 1) > th * tw * g ? (2 * th + 1) * (2 * tw + 1)
                                                       : th * tw * g) + 31) / 32 * 32;
}

// TH x TW conv outputs and G channel groups a CTA, the first TH * TW * G
// threads one an (output, group): TH * TW a multiple of 32, so a warp never
// straddles two groups
template <int TH, int TW, int G>
__global__ void __launch_bounds__(front_threads(TH, TW, G))
front_kernel(const float* __restrict__ canvas, const float* __restrict__ params,
             float* __restrict__ out, int H, int W, int oh, int ow, int cout,
             int pad_lo_h, int pad_lo_w, int use_bilateral, float inv2sc,
             float scale, float offset, int act) {
  canvas += (long long)blockIdx.z * 3 * (H + 4) * (W + 4);
  out += (long long)blockIdx.z * cout * oh * ow;
  constexpr int NT = front_threads(TH, TW, G);
  constexpr int NH = 2 * TH + 1, NW = 2 * TW + 1;  // normalized pixels
  constexpr int PH = NH + 4, PW = NW + 4;          // canvas pixels
  static_assert((TH * TW) % 32 == 0, "a warp must hold one channel group");
  __shared__ float s_can[3][PH][PW];
  __shared__ float s_nrm[3][NH][NW];
  // rows 0..26: conv taps ((di*3+dj)*3+c) x cout, row 27: bias, then the 13
  // bilateral space weights
  __shared__ __align__(16) float s_par[NPAR];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int i0 = blockIdx.y * TH, j0 = blockIdx.x * TW;
  // model coordinates of normalized tile pixel (0, 0); the canvas window is
  // padded rows m0 .. m0+PH-1 (model rows m0-2 ..), padded columns n0 ..
  const int m0 = 2 * i0 - pad_lo_h, n0 = 2 * j0 - pad_lo_w;
  const int HP = H + 4, WP = W + 4;

  const int npar = 28 * cout + NTAPS;
  for (int k = tid; k < npar; k += NT) cp_async4(&s_par[k], params + k, true);
  for (int row = warp; row < 3 * PH; row += NT / 32) {
    const int c = row / PH, r = row - c * PH, pr = m0 + r;
    const bool row_ok = pr >= 0 && pr < HP;
    const float* src = canvas + ((long long)c * HP + (row_ok ? pr : 0)) * WP;
    for (int s = lane; s < PW; s += 32) {
      const int pc = n0 + s;
      const bool ok = row_ok && pc >= 0 && pc < WP;
      cp_async4(&s_can[c][r][s], ok ? src + pc : canvas, ok);
    }
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const float* sw = s_par + 28 * cout;
  for (int idx = tid; idx < NH * NW; idx += NT) {
    const int r = idx / NW, s = idx - r * NW;
    const int m = m0 + r, n = n0 + s;
    if (m < 0 || m >= H || n < 0 || n >= W) {
      s_nrm[0][r][s] = s_nrm[1][r][s] = s_nrm[2][r][s] = 0.0f;
      continue;
    }
    float val[3] = {s_can[0][r + 2][s + 2], s_can[1][r + 2][s + 2],
                    s_can[2][r + 2][s + 2]};
    if (use_bilateral) {
      bilateral13(&s_can[0][r + 2][s + 2], &s_can[1][r + 2][s + 2],
                  &s_can[2][r + 2][s + 2], PW, sw, inv2sc, val);
#pragma unroll
      for (int c = 0; c < 3; ++c) val[c] = rintf(val[c]);
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) s_nrm[c][r][s] = __fadd_rn(__fmul_rn(val[c], scale), offset);
  }
  __syncthreads();

  if (tid >= TH * TW * G) return;
  const int g = tid / (TH * TW), q = tid - g * (TH * TW);
  const int ty = q / TW, tx = q - ty * TW;
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
  // group g: channels [o_lo, o_hi) of cout
  constexpr int CHUNK = G >= 8 ? 2 : 4;
  const int per = (cout + G - 1) / G;
  const int o_lo = g * per, o_hi = min(o_lo + per, cout);
  float* dst = out + (long long)i * ow + j;
  if (cout % CHUNK == 0 && per % CHUNK == 0)
    conv_channels<CHUNK, true>(x, s_par, cout, o_lo, o_hi, dst, (long long)oh * ow, act);
  else
    conv_channels<CHUNK, false>(x, s_par, cout, o_lo, o_hi, dst, (long long)oh * ow, act);
}

template <int TH, int TW, int G>
int launch_front(const float* canvas, const float* params, float* out, int n, int H,
                 int W, int oh, int ow, int cout, int pad_lo_h, int pad_lo_w,
                 int use_bilateral, float inv2sc, float scale, float offset, int act,
                 cudaStream_t s) {
  dim3 grid((ow + TW - 1) / TW, (oh + TH - 1) / TH, n);
  front_kernel<TH, TW, G><<<grid, front_threads(TH, TW, G), 0, s>>>(
      canvas, params, out, H, W, oh, ow, cout, pad_lo_h, pad_lo_w, use_bilateral, inv2sc,
      scale, offset, act);
  return (int)cudaGetLastError();
}

}  // namespace

// canvas: (n, 3, H+4, W+4) f32, reflect-101 padded by 2, rounded, planes
// in the weights' input-channel order; params: (28*cout + 13) f32 device
// array (taps x cout, bias, bilateral space weights); out: (n, cout, oh,
// ow).
// act: 0 NONE, 1 RELU6, 2 HARD_SWISH.  th, tw, g: the tile, output rows,
// output columns and channel groups a CTA (pipeline/edge.py:FRONT_TILES):
// (4, 8, 8) or (4, 16, 4).
extern "C" int bs_front(const void* canvas, const void* params, void* out, int n,
                        int H, int W, int oh, int ow, int cout, int pad_lo_h,
                        int pad_lo_w, int use_bilateral, float inv2sc,
                        float scale, float offset, int act, int th, int tw, int g,
                        void* stream) {
  if (cout < 1 || cout > MAX_COUT || n < 1 || n > 65535) return (int)cudaErrorInvalidValue;
  const float* c = (const float*)canvas;
  const float* p = (const float*)params;
  float* o = (float*)out;
  cudaStream_t s = (cudaStream_t)stream;
#define BS_FRONT(TH, TW, G)                                                               \
  launch_front<TH, TW, G>(c, p, o, n, H, W, oh, ow, cout, pad_lo_h, pad_lo_w, use_bilateral, \
                          inv2sc, scale, offset, act, s)
  if (th == 4 && tw == 8 && g == 8) return BS_FRONT(4, 8, 8);
  if (th == 4 && tw == 16 && g == 4) return BS_FRONT(4, 16, 4);
#undef BS_FRONT
  return (int)cudaErrorInvalidValue;
}
