// MJPG decode after the entropy decoder, for Hopper (sm_90a): bs_jpeg_decode.
//
// No pallas_call replaces this: in the JAX package the decode is jnp code
// (backscrub_tpu/pipeline/jpeg.py:decode_jpeg_bgr) that XLA fuses into the
// one jitted frame program (backscrub_tpu/pipeline/frame.py:239-244).
// Eager PyTorch would run that code as ~440 launches a frame, so the port
// decodes in one call of two kernels:
//   1. idct_kernel: dequantize and the islow 8x8 inverse DCT of every block
//      of every component into one u8 sample plane a component (the
//      (bh*8, bw*8) MCU-padded grid);
//   2. color_kernel: one output pixel a thread: each component's sample
//      upsampled at that pixel (libjpeg's fancy h2v1/h2v2/h1v2 triangle
//      filters, or replication for other ratios, clamped at the component's
//      cropped width and height, not at the padded block grid), then
//      YCbCr->BGR (jdcolor.c) or gray replicated, written as (H, W, 3) u8.
// Integer arithmetic throughout, byte-identical to the plain version
// (pipeline/jpeg.py:decode_jpeg_bgr) and so to cv2.imdecode.
//
// idct_kernel: 8 threads a block, BPC blocks a CTA.  Pass 1: thread c
// takes column c (8 coefficient loads, 16 contiguous bytes across the 8
// threads of a row), dequantizes, runs the butterfly, and leaves 8 values
// in shared memory; pass 2: thread r takes row r, runs the butterfly,
// clamps and stores its 8 samples as one 8-byte word.  The butterfly runs
// in unsigned arithmetic, so a corrupt stream's overflow wraps as the plain
// version's int32 tensors do; DESCALE is the arithmetic shift of the
// signed result.
//
// Bound: bytes.  The coefficients in (128 B a block) and the BGR bytes out
// (3 a pixel): 0.92 + 0.92 MB at 640x480 4:2:0, 0.55 us at 3.35 TB/s;
// 2.76 + 2.76 MB at 1280x720, 1.65 us.  The planes (1 B a sample) go out
// and back in through the 50 MB L2.  A simple kernel first; the MJPG
// encode, which has no kernel yet, is ROADMAP's held lead 3.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BPC = 32;  // 8x8 blocks a CTA in idct_kernel
constexpr int CTW = 128; // pixels a CTA (one row segment) in color_kernel

enum Mode { FULL = 0, H2V1 = 1, H2V2 = 2, H1V2 = 3, REPL = 4 };

struct Comp {
  const int16_t* coef;   // (bh, bw, 64) natural order
  int bh, bw;            // MCU-padded block grid
  int first;             // index of its first block among all components'
  int plane_off;         // byte offset of its (bh*8, bw*8) sample plane
  int ch, cw;            // cropped sample grid (before upsampling)
  int mode, he, ve;      // upsampling method; REPL's factors
};

struct Geom {
  Comp c[3];
  int ncomp, total, H, W;
};

typedef unsigned int U;

// One 8-point islow IDCT pass (jidctint.c), as pipeline/jpeg.py:_butterfly8.
__device__ __forceinline__ void butterfly8(U (&v)[8], int descale) {
  const U i0 = v[0], i1 = v[1], i2 = v[2], i3 = v[3];
  const U i4 = v[4], i5 = v[5], i6 = v[6], i7 = v[7];
  U z1 = (i2 + i6) * 4433u;                 // FIX_0_541196100
  const U tmp2 = z1 - i6 * 15137u;          // FIX_1_847759065
  const U tmp3 = z1 + i2 * 6270u;           // FIX_0_765366865
  U t0 = (i0 + i4) << 13;
  U t1 = (i0 - i4) << 13;
  const U tmp10 = t0 + tmp3, tmp13 = t0 - tmp3;
  const U tmp11 = t1 + tmp2, tmp12 = t1 - tmp2;
  t0 = i7; t1 = i5;
  U t2 = i3, t3 = i1;
  z1 = t0 + t3;
  U z2 = t1 + t2, z3 = t0 + t2, z4 = t1 + t3;
  const U z5 = (z3 + z4) * 9633u;           // FIX_1_175875602
  t0 = t0 * 2446u;                          // FIX_0_298631336
  t1 = t1 * 16819u;                         // FIX_2_053119869
  t2 = t2 * 25172u;                         // FIX_3_072711026
  t3 = t3 * 12299u;                         // FIX_1_501321110
  z1 = z1 * (U)-7373;                       // -FIX_0_899976223
  z2 = z2 * (U)-20995;                      // -FIX_2_562915447
  z3 = z3 * (U)-16069 + z5;                 // -FIX_1_961570560
  z4 = z4 * (U)-3196 + z5;                  // -FIX_0_390180644
  t0 = t0 + z1 + z3;
  t1 = t1 + z2 + z4;
  t2 = t2 + z2 + z3;
  t3 = t3 + z1 + z4;
  const U half = 1u << (descale - 1);
  v[0] = (U)((int)(tmp10 + t3 + half) >> descale);
  v[1] = (U)((int)(tmp11 + t2 + half) >> descale);
  v[2] = (U)((int)(tmp12 + t1 + half) >> descale);
  v[3] = (U)((int)(tmp13 + t0 + half) >> descale);
  v[4] = (U)((int)(tmp13 - t0 + half) >> descale);
  v[5] = (U)((int)(tmp12 - t1 + half) >> descale);
  v[6] = (U)((int)(tmp11 - t2 + half) >> descale);
  v[7] = (U)((int)(tmp10 - t3 + half) >> descale);
}

__device__ __forceinline__ U clamp255(int x) { return (U)min(max(x, 0), 255); }

__global__ void __launch_bounds__(BPC * 8)
idct_kernel(const Geom g, const int* __restrict__ q, uint8_t* __restrict__ planes) {
  __shared__ int ws[BPC][8][9];
  const int lb = threadIdx.x >> 3, lane = threadIdx.x & 7;
  const int b = blockIdx.x * BPC + lb;
  const bool live = b < g.total;
  const int c = (g.ncomp > 2 && b >= g.c[2].first) ? 2 : (g.ncomp > 1 && b >= g.c[1].first) ? 1 : 0;
  const Comp& cp = g.c[c];
  const int k = b - cp.first;
  if (live) {
    const int16_t* src = cp.coef + (size_t)k * 64 + lane;
    const int* qc = q + c * 64 + lane;
    U v[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) v[r] = (U)((int)src[r * 8] * __ldg(qc + r * 8));
    butterfly8(v, 11);
#pragma unroll
    for (int r = 0; r < 8; ++r) ws[lb][r][lane] = (int)v[r];
  }
  __syncthreads();
  if (!live) return;
  U v[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = (U)ws[lb][lane][j];
  butterfly8(v, 18);
  U lo = 0, hi = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    lo |= clamp255((int)v[j] + 128) << (8 * j);
    hi |= clamp255((int)v[j + 4] + 128) << (8 * j);
  }
  const int by = k / cp.bw, bx = k - by * cp.bw;
  uint8_t* dst = planes + cp.plane_off + (size_t)(by * 8 + lane) * (cp.bw * 8) + bx * 8;
  *reinterpret_cast<uint2*>(dst) = make_uint2(lo, hi);
}

// Component cp's sample at output pixel (y, x), upsampled as jdsample.c
// (pipeline/jpeg.py:upsample_plane); border neighbours clamp at (ch, cw).
__device__ __forceinline__ int sample(const Comp& cp, const uint8_t* __restrict__ planes,
                                      int y, int x) {
  const uint8_t* p = planes + cp.plane_off;
  const int stride = cp.bw * 8;
  switch (cp.mode) {
    case FULL:
      return p[y * stride + x];
    case H2V1: {
      const uint8_t* row = p + y * stride;
      const int j = x >> 1;
      return (x & 1) ? (3 * row[j] + row[min(j + 1, cp.cw - 1)] + 2) >> 2
                     : (3 * row[j] + row[max(j - 1, 0)] + 1) >> 2;
    }
    case H2V2: {
      const int i = y >> 1, j = x >> 1;
      const int io = (y & 1) ? min(i + 1, cp.ch - 1) : max(i - 1, 0);
      const int jn = (x & 1) ? min(j + 1, cp.cw - 1) : max(j - 1, 0);
      const uint8_t* r0 = p + i * stride;
      const uint8_t* r1 = p + io * stride;
      const int c0 = 3 * r0[j] + r1[j], cn = 3 * r0[jn] + r1[jn];
      return (3 * c0 + cn + ((x & 1) ? 7 : 8)) >> 4;
    }
    case H1V2: {
      const int i = y >> 1;
      const int io = (y & 1) ? min(i + 1, cp.ch - 1) : max(i - 1, 0);
      return (3 * p[i * stride + x] + p[io * stride + x] + ((y & 1) ? 2 : 1)) >> 2;
    }
    default:
      return p[(y / cp.ve) * stride + x / cp.he];
  }
}

__global__ void __launch_bounds__(CTW)
color_kernel(const Geom g, const uint8_t* __restrict__ planes, uint8_t* __restrict__ out) {
  const int y = blockIdx.y, x = blockIdx.x * CTW + threadIdx.x;
  if (x >= g.W) return;
  uint8_t* o = out + ((size_t)y * g.W + x) * 3;
  const int yy = sample(g.c[0], planes, y, x);
  if (g.ncomp == 1) {
    o[0] = o[1] = o[2] = (uint8_t)yy;
    return;
  }
  const int cbm = sample(g.c[1], planes, y, x) - 128;
  const int crm = sample(g.c[2], planes, y, x) - 128;
  o[0] = (uint8_t)clamp255(yy + ((116130 * cbm + 32768) >> 16));
  o[1] = (uint8_t)clamp255(yy + ((-22554 * cbm + 32768 - 46802 * crm) >> 16));
  o[2] = (uint8_t)clamp255(yy + ((91881 * crm + 32768) >> 16));
}

}  // namespace

// geom: host int32[15] = H, W, ncomp, then (h, v, bh, bw) a component.
// planes: device scratch of sum(bh * bw * 64) bytes; out: (H, W, 3) u8.
extern "C" int bs_jpeg_decode(const void* c0, const void* c1, const void* c2,
                              const void* q, void* planes, void* out,
                              const void* geom, void* stream) {
  const int* gh = (const int*)geom;
  Geom g = {};
  g.H = gh[0];
  g.W = gh[1];
  g.ncomp = gh[2];
  if ((g.ncomp != 1 && g.ncomp != 3) || g.H <= 0 || g.W <= 0 || g.H > 65535)
    return (int)cudaErrorInvalidValue;
  const void* coefs[3] = {c0, c1, c2};
  int hmax = 1, vmax = 1;
  for (int c = 0; c < g.ncomp; ++c) {
    hmax = max(hmax, gh[3 + 4 * c]);
    vmax = max(vmax, gh[4 + 4 * c]);
  }
  long long first = 0;
  for (int c = 0; c < g.ncomp; ++c) {
    const int h = gh[3 + 4 * c], v = gh[4 + 4 * c];
    Comp& cp = g.c[c];
    cp.coef = (const int16_t*)coefs[c];
    cp.bh = gh[5 + 4 * c];
    cp.bw = gh[6 + 4 * c];
    cp.first = (int)first;
    cp.plane_off = (int)(first * 64);
    cp.ch = (int)(((long long)g.H * v + vmax - 1) / vmax);
    cp.cw = (int)(((long long)g.W * h + hmax - 1) / hmax);
    if (h <= 0 || v <= 0 || !cp.coef || cp.ch > cp.bh * 8 || cp.cw > cp.bw * 8)
      return (int)cudaErrorInvalidValue;
    if (h == hmax && v == vmax) cp.mode = FULL;
    else if (h * 2 == hmax && v == vmax) cp.mode = H2V1;
    else if (h * 2 == hmax && v * 2 == vmax) cp.mode = H2V2;
    else if (h == hmax && v * 2 == vmax) cp.mode = H1V2;
    else if (hmax % h == 0 && vmax % v == 0) cp.mode = REPL;
    else return (int)cudaErrorInvalidValue;
    cp.he = hmax / h;
    cp.ve = vmax / v;
    first += (long long)cp.bh * cp.bw;
  }
  if (first * 64 > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  g.total = (int)first;
  cudaStream_t s = (cudaStream_t)stream;
  idct_kernel<<<(g.total + BPC - 1) / BPC, BPC * 8, 0, s>>>(g, (const int*)q, (uint8_t*)planes);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  color_kernel<<<dim3((g.W + CTW - 1) / CTW, g.H), CTW, 0, s>>>(g, (const uint8_t*)planes,
                                                                 (uint8_t*)out);
  return (int)cudaGetLastError();
}
