// MJPG decode after the entropy decoder, for Hopper (sm_90a): bs_jpeg_decode.
//
// No pallas_call replaces this: in the JAX package the decode is jnp code
// (backscrub_tpu/pipeline/jpeg.py:decode_jpeg_bgr) that XLA fuses into the
// one jitted frame program (backscrub_tpu/pipeline/frame.py:239-244).
// Eager PyTorch would run that code as ~440 launches a frame, so the port
// decodes in one launch of one kernel, jpeg_decode_kernel: dequantize and
// the islow 8x8 inverse DCT (jidctint.c), libjpeg's fancy h2v1 / h2v2 /
// h1v2 triangle upsampling (or replication for the other ratios), clamped
// at the component's cropped width and height, not at the padded block
// grid, then YCbCr->BGR (jdcolor.c) or gray replicated, written as (H, W,
// 3) u8.  Integer arithmetic throughout, byte-identical to the plain
// version (pipeline/jpeg.py:decode_jpeg_bgr) and so to cv2.imdecode.
//
// Bound: bytes.  The coefficients in (128 B a block) and the BGR bytes out
// (3 a pixel): 0.92 + 0.92 MB at 640x480 4:2:0, 0.55 us at 3.35 TB/s;
// 2.76 + 2.76 MB at 1280x720, 1.65 us.  Far above that bound sits the
// latency of a short launch.  The two kernels this replaced (an IDCT into
// u8 sample planes in global memory, then upsample and colour one pixel a
// thread reading them back through L2) each cost a launch, the planes a
// round trip; the colour kernel made a byte load of every neighbour sample
// and three single-byte stores at a 3-byte stride, and the IDCT loaded its
// coefficients as 2-byte loads and the quant table entry by entry.
//
// The design: one launch, a CTA a tile of MCUs, TILE_H x TILE_W pixels (4
// / vmax MCUs down, TILE_W / 8 / hmax across, made even where hmax is odd
// so that a tile holds whole 16-pixel chunks: 32 x 32 at 4:2:0), nothing
// between its steps leaving shared memory.
// 1. Loads.  Every coefficient block the tile reads goes into shared
//    memory at once, a 16-byte cp.async a block row (8 int16; a component
//    whose coefficients are off 16 bytes takes 2-byte loads), and the
//    quant tables once a CTA.  The blocks are the tile's own and, for a
//    component the fancy upsampling reads across the tile's edge (a
//    one-sample halo: h2v1 across, h1v2 down, h2v2 both), the whole block
//    beyond each edge of its own, clipped to the block grid: a halo block
//    is decoded again by each tile that borders it, from the same
//    coefficients, rather than passed between CTAs (at 4:2:0 a 32 x 32
//    tile decodes up to 48 blocks for its 24).  A block's place in its
//    window comes from a multiply by the window width's reciprocal, not a
//    division.
// 2. The IDCT: 8 threads a block, NT / 8 blocks at a time.  Pass 1: thread
//    c takes column c of the staged block (dequantized by the staged
//    table), runs the butterfly and leaves 8 values in its group's scratch;
//    pass 2: thread r takes row r, runs the butterfly, clamps and stores
//    its 8 samples as one 8-byte word into the component's sample window
//    (WS bytes a row).  The butterfly runs in unsigned arithmetic, so a
//    corrupt stream's overflow wraps as the plain version's int32 tensors
//    do; DESCALE is the arithmetic shift of the signed result.
// 3. Upsample and colour from the windows: a thread SEG = 8 pixels of a
//    row (a full-resolution component's 8 samples as two 4-byte loads, an
//    h2v2 one's 6 column sums each read once), two neighbouring threads a
//    16-pixel chunk of 48 bytes, written as three 16-byte stores (the
//    second thread's first 8 bytes shuffled to the first) where the chunk
//    lies inside the image and starts on 16 bytes, else pixel by pixel (a
//    width that is no multiple of 16, an output off 16 bytes) in the same
//    launch.  A pixel past the image's width is computed from samples
//    clamped into the window and not written.
//
// What bounds it now (tools/sweep_jpeg_tiles.py times it with each step
// taken away; PERF.md section 6): a chain of dependent latencies a CTA,
// the kernel's parameters, then the loads, the IDCT's rounds and the
// colour step's shared loads, which the few CTAs an SM holds at this size
// (300 at 640x480) do not hide from each other.  Designs tried while this
// one was chosen, each slower on the card: 16 pixels a thread, 4 pixels a
// thread (four threads a chunk), two blocks a group at a time in the IDCT,
// and tiles 16 or 64 pixels wide.
//
// Shared memory a CTA (static): MAXB staged blocks of CSTRIDE int16, three
// windows of WIN bytes, the IDCT scratch and the quant tables.  The MJPG
// encode, which has no kernel yet, is ROADMAP's held lead 3.

#include <cuda_runtime.h>
#include <stdint.h>

#include "async_copy.cuh"

namespace {

constexpr int NT = 128;            // threads a CTA: NT / 8 IDCT groups of 8
constexpr int TILE_H = 32;         // pixels a tile down at most (at least 32: vmax 4)
constexpr int TILE_W = 32;         // and across (48 where hmax is 3)
constexpr int SEG = 8;             // pixels a thread: two threads' 16 pixels are 48 bytes
constexpr int CSTRIDE = 72;        // int16 a staged block: 64 + a pad, 16-byte rows
// a component's window at most, in blocks: its own, or half as many and a
// halo block on each side; across, at least the 6 of a tile 48 pixels
// wide at hmax 3 (a tile's width is a multiple of 16 pixels)
constexpr int WROWS = TILE_H / 8 > TILE_H / 16 + 2 ? TILE_H / 8 : TILE_H / 16 + 2;
constexpr int WCOLS = TILE_W / 8 > TILE_W / 16 + 2 ? (TILE_W / 8 > 6 ? TILE_W / 8 : 6)
                      : (TILE_W / 16 + 2 > 6 ? TILE_W / 16 + 2 : 6);
constexpr int WS = WCOLS * 8;               // a window's row of samples, bytes
constexpr int WIN = WROWS * WS * 8;         // bytes of a component's sample window
constexpr int MAXB = 3 * WROWS * WCOLS;     // blocks a CTA

enum Mode { FULL = 0, H2V1 = 1, H2V2 = 2, H1V2 = 3, REPL = 4 };

struct Comp {
  const int16_t* coef;   // (bh, bw, 64) natural order
  int bh, bw;            // MCU-padded block grid
  int h, v;              // sampling factors
  int ch, cw;            // cropped sample grid (before upsampling)
  int mode, he, ve;      // upsampling method; REPL's factors
  int hy, hx;            // halo blocks the method reads beyond an edge: down, across
};

struct Geom {
  Comp c[3];
  int ncomp, H, W;
  int my, mx;            // MCUs a tile, down and across
  int th, tw;            // pixels a tile, down and across
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

// a[c] for a component index known only at run time, by selects (an
// array indexed at run time would go to local memory)
template <typename T>
__device__ __forceinline__ T pick(const T (&a)[3], int c) {
  return c == 2 ? a[2] : c == 1 ? a[1] : a[0];
}

// A component's window in shared memory: its blocks [r0, r0 + rows) x [c0,
// c0 + cols) of the block grid, as samples, WS bytes a row.
struct Win {
  const uint8_t* p;
  int r0, c0;
  __device__ __forceinline__ int at(int i, int j) const {
    return p[(i - 8 * r0) * WS + (j - 8 * c0)];
  }
};

// k / n and k % n for a block's index k < 64 in a window n <= 8 blocks
// wide, by the reciprocal ``mag`` = ceil(2^16 / n): exact there, and a
// multiply where a division would take a few dozen instructions
__device__ __forceinline__ void divmod(int k, int n, int mag, int& ky, int& kx) {
  ky = (k * mag) >> 16;
  kx = k - ky * n;
}

// Component cp's samples at the SEG output pixels (y, xs + k), upsampled as
// jdsample.c (pipeline/jpeg.py:upsample_plane): border neighbours clamp at
// (ch, cw).  A pixel past the image's last column ``xl`` is computed from
// samples clamped into the window (at that column, or at cw - 1), and not
// written.  A full-resolution segment inside the image comes as 4-byte
// words; h2v2 (4:2:0 chroma) takes each column sum 3 * near + far of the
// SEG / 2 + 2 sample columns it reads once.
__device__ __forceinline__ void upsample(const Comp& cp, const Win& w, int y, int xs, int xl,
                                         int (&s)[SEG]) {
  switch (cp.mode) {
    case FULL:
      if (xs + SEG - 1 <= xl) {   // 4-byte aligned: the window starts at the tile's column
        const U* p = reinterpret_cast<const U*>(w.p + (y - 8 * w.r0) * WS + (xs - 8 * w.c0));
#pragma unroll
        for (int k = 0; k < SEG / 4; ++k) {
          const U v = p[k];
#pragma unroll
          for (int b = 0; b < 4; ++b) s[4 * k + b] = (v >> (8 * b)) & 255;
        }
      } else {
#pragma unroll
        for (int k = 0; k < SEG; ++k) s[k] = w.at(y, min(xs + k, xl));
      }
      break;
    case H2V1:
#pragma unroll
      for (int k = 0; k < SEG; ++k) {
        const int j = min(xs + k, xl) >> 1;
        s[k] = (k & 1) ? (3 * w.at(y, j) + w.at(y, min(j + 1, cp.cw - 1)) + 2) >> 2
                       : (3 * w.at(y, j) + w.at(y, max(j - 1, 0)) + 1) >> 2;
      }
      break;
    case H2V2: {
      // the column sums of sample columns xs / 2 - 1 .. xs / 2 + SEG / 2
      const int i = y >> 1, io = (y & 1) ? min(i + 1, cp.ch - 1) : max(i - 1, 0);
      int cs[SEG / 2 + 2];
#pragma unroll
      for (int m = 0; m < SEG / 2 + 2; ++m) {
        const int j = min(max((xs >> 1) - 1 + m, 0), cp.cw - 1);
        cs[m] = 3 * w.at(i, j) + w.at(io, j);
      }
#pragma unroll
      for (int m = 0; m < SEG / 2; ++m) {
        s[2 * m] = (3 * cs[m + 1] + cs[m] + 8) >> 4;
        s[2 * m + 1] = (3 * cs[m + 1] + cs[m + 2] + 7) >> 4;
      }
      break;
    }
    case H1V2: {
      const int i = y >> 1, io = (y & 1) ? min(i + 1, cp.ch - 1) : max(i - 1, 0);
      const int bias = (y & 1) ? 2 : 1;
#pragma unroll
      for (int k = 0; k < SEG; ++k) {
        const int x = min(xs + k, xl);
        s[k] = (3 * w.at(i, x) + w.at(io, x) + bias) >> 2;
      }
      break;
    }
    default: {
      const int i = y / cp.ve;
#pragma unroll
      for (int k = 0; k < SEG; ++k) s[k] = w.at(i, min(xs + k, xl) / cp.he);
    }
  }
}

__global__ void __launch_bounds__(NT)
jpeg_decode_kernel(const Geom g, const int* __restrict__ q, uint8_t* __restrict__ out) {
  __shared__ __align__(16) int16_t stage[MAXB * CSTRIDE];
  __shared__ __align__(16) uint8_t win[3][WIN];
  __shared__ int scr[NT / 8][8][9];
  __shared__ int sq[3][64];
  const int tid = threadIdx.x;

  // each component's window: blocks [r0, r1) x [c0, c0 + cols), its blocks
  // first[c] on in the CTA's block order
  int r0[3], c0[3], cols[3], mag[3], first[4];
  const int16_t* coef[3];
  first[0] = 0;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const Comp& cp = g.c[c];
    int n = 0;
    coef[c] = cp.coef;
    if (c < g.ncomp) {
      const int by = blockIdx.y * g.my * cp.v, bx = blockIdx.x * g.mx * cp.h;
      r0[c] = max(by - cp.hy, 0);
      c0[c] = max(bx - cp.hx, 0);
      cols[c] = min(bx + g.mx * cp.h + cp.hx, cp.bw) - c0[c];
      n = (min(by + g.my * cp.v + cp.hy, cp.bh) - r0[c]) * cols[c];
    } else {
      r0[c] = c0[c] = 0;
      cols[c] = 1;
    }
    mag[c] = (65536 + cols[c] - 1) / cols[c];
    first[c + 1] = first[c] + n;
  }
  const int nb = first[3];

  // 1. the blocks' coefficients and the quant tables into shared memory
  for (int e = tid; e < nb * 8; e += NT) {
    const int b = e >> 3, row = e & 7;
    const int c = b >= first[2] ? 2 : b >= first[1] ? 1 : 0;
    int ky, kx;
    divmod(b - (c == 2 ? first[2] : c == 1 ? first[1] : 0), pick(cols, c), pick(mag, c), ky, kx);
    const int by = pick(r0, c) + ky, bx = pick(c0, c) + kx;
    const int bw = c == 2 ? g.c[2].bw : c == 1 ? g.c[1].bw : g.c[0].bw;
    const int16_t* src = pick(coef, c) + ((size_t)by * bw + bx) * 64 + row * 8;
    int16_t* dst = stage + b * CSTRIDE + row * 8;
    if (((uintptr_t)src & 15) == 0) {
      cp_async16(dst, src, true);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) dst[j] = src[j];
    }
  }
  cp_async_commit();
  for (int i = tid; i < g.ncomp * 64; i += NT) sq[i >> 6][i & 63] = __ldg(q + i);
  cp_async_wait<0>();
  __syncthreads();

  // 2. the IDCT of every block into its component's window
  const int grp = tid >> 3, lane = tid & 7;
  const unsigned gmask = 0xffu << (tid & 24);      // the group's 8 lanes of the warp
  for (int b = grp; b < nb; b += NT / 8) {
    const int c = b >= first[2] ? 2 : b >= first[1] ? 1 : 0;
    const int16_t* blk = stage + b * CSTRIDE + lane;
    U v[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) v[r] = (U)blk[r * 8] * (U)sq[c][r * 8 + lane];
    butterfly8(v, 11);
#pragma unroll
    for (int r = 0; r < 8; ++r) scr[grp][r][lane] = (int)v[r];
    __syncwarp(gmask);
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = (U)scr[grp][lane][j];
    __syncwarp(gmask);                             // the next block's pass 1 reuses scr
    butterfly8(v, 18);
    U lo = 0, hi = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      lo |= clamp255((int)v[j] + 128) << (8 * j);
      hi |= clamp255((int)v[j + 4] + 128) << (8 * j);
    }
    int ky, kx;
    divmod(b - (c == 2 ? first[2] : c == 1 ? first[1] : 0), pick(cols, c), pick(mag, c), ky,
           kx);
    *reinterpret_cast<uint2*>(win[c] + (ky * 8 + lane) * WS + kx * 8) = make_uint2(lo, hi);
  }
  __syncthreads();

  // 3. upsample and colour, SEG pixels a thread; two neighbouring threads
  // take a chunk of 16 pixels, 48 bytes, stored as three 16-byte words
  // where the chunk lies inside the image and starts on 16 bytes
  const int y0 = blockIdx.y * g.th, x0 = blockIdx.x * g.tw;
  const int rows = min(g.th, g.H - y0), segs = 16 / SEG * ((min(g.tw, g.W - x0) + 15) / 16);
  static_assert(SEG == 8, "two threads a 16-pixel chunk");
  const unsigned pmask = 3u << (tid & 30);       // the chunk's two lanes
  Win w[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) w[c] = Win{win[c], r0[c], c0[c]};
  for (int s = tid; s < rows * segs; s += NT) {
    const int y = y0 + s / segs, xs = x0 + (s % segs) * SEG, x16 = xs & ~15;
    uint8_t px[3 * SEG];
    int yy[SEG];
    upsample(g.c[0], w[0], y, xs, g.W - 1, yy);
    if (g.ncomp == 1) {
#pragma unroll
      for (int k = 0; k < SEG; ++k) px[3 * k] = px[3 * k + 1] = px[3 * k + 2] = (uint8_t)yy[k];
    } else {
      int cb[SEG], cr[SEG];
      upsample(g.c[1], w[1], y, xs, g.W - 1, cb);
      upsample(g.c[2], w[2], y, xs, g.W - 1, cr);
#pragma unroll
      for (int k = 0; k < SEG; ++k) {
        const int cbm = cb[k] - 128, crm = cr[k] - 128;
        px[3 * k] = (uint8_t)clamp255(yy[k] + ((116130 * cbm + 32768) >> 16));
        px[3 * k + 1] = (uint8_t)clamp255(yy[k] + ((-22554 * cbm + 32768 - 46802 * crm) >> 16));
        px[3 * k + 2] = (uint8_t)clamp255(yy[k] + ((91881 * crm + 32768) >> 16));
      }
    }
    U wd[3 * SEG / 4];
#pragma unroll
    for (int i = 0; i < 3 * SEG / 4; ++i)
      wd[i] = (U)px[4 * i] | ((U)px[4 * i + 1] << 8) | ((U)px[4 * i + 2] << 16) |
              ((U)px[4 * i + 3] << 24);
    uint8_t* o = out + ((size_t)y * g.W + x16) * 3;
    if (x16 + 16 <= g.W && ((uintptr_t)o & 15) == 0) {
      // the first thread holds the chunk's bytes 0-23, the second 24-47,
      // whose first two words come down to the first
      uint4* v = reinterpret_cast<uint4*>(o);
      const U n0 = __shfl_down_sync(pmask, wd[0], 1, 2), n1 = __shfl_down_sync(pmask, wd[1], 1, 2);
      if (xs == x16) {
        v[0] = make_uint4(wd[0], wd[1], wd[2], wd[3]);
        v[1] = make_uint4(wd[4], wd[5], n0, n1);
      } else {
        v[2] = make_uint4(wd[2], wd[3], wd[4], wd[5]);
      }
    } else {
      o += (xs - x16) * 3;
#pragma unroll
      for (int k = 0; k < SEG; ++k)
        if (xs + k < g.W) {
          o[3 * k] = px[3 * k];
          o[3 * k + 1] = px[3 * k + 1];
          o[3 * k + 2] = px[3 * k + 2];
        }
    }
  }
}

}  // namespace

// geom: host int32[15] = H, W, ncomp, then (h, v, bh, bw) a component.
// q: (ncomp, 64) int32 quant tables; out: (H, W, 3) u8.  One launch.
extern "C" int bs_jpeg_decode(const void* c0, const void* c1, const void* c2, const void* q,
                              void* out, const void* geom, void* stream) {
  const int* gh = (const int*)geom;
  Geom g = {};
  g.H = gh[0];
  g.W = gh[1];
  g.ncomp = gh[2];
  if ((g.ncomp != 1 && g.ncomp != 3) || g.H <= 0 || g.W <= 0 || g.H > 65535 || g.W > 65535)
    return (int)cudaErrorInvalidValue;
  const void* coefs[3] = {c0, c1, c2};
  int hmax = 1, vmax = 1;
  for (int c = 0; c < g.ncomp; ++c) {
    hmax = max(hmax, gh[3 + 4 * c]);
    vmax = max(vmax, gh[4 + 4 * c]);
  }
  if (hmax > 4 || vmax > 4) return (int)cudaErrorInvalidValue;
  g.my = TILE_H / 8 / vmax;
  g.mx = max(1, TILE_W / 8 / hmax);
  if (g.mx * hmax % 2) ++g.mx;     // whole 16-pixel chunks a tile
  g.th = g.my * vmax * 8;
  g.tw = g.mx * hmax * 8;
  int blocks = 0;
  for (int c = 0; c < g.ncomp; ++c) {
    const int h = gh[3 + 4 * c], v = gh[4 + 4 * c];
    Comp& cp = g.c[c];
    cp.coef = (const int16_t*)coefs[c];
    cp.h = h;
    cp.v = v;
    cp.bh = gh[5 + 4 * c];
    cp.bw = gh[6 + 4 * c];
    cp.ch = (int)(((long long)g.H * v + vmax - 1) / vmax);
    cp.cw = (int)(((long long)g.W * h + hmax - 1) / hmax);
    if (h <= 0 || v <= 0 || !cp.coef || ((uintptr_t)cp.coef & 1) || cp.ch > cp.bh * 8 ||
        cp.cw > cp.bw * 8)
      return (int)cudaErrorInvalidValue;
    if (h == hmax && v == vmax) cp.mode = FULL;
    else if (h * 2 == hmax && v == vmax) cp.mode = H2V1;
    else if (h * 2 == hmax && v * 2 == vmax) cp.mode = H2V2;
    else if (h == hmax && v * 2 == vmax) cp.mode = H1V2;
    else if (hmax % h == 0 && vmax % v == 0) cp.mode = REPL;
    else return (int)cudaErrorInvalidValue;
    cp.he = hmax / h;
    cp.ve = vmax / v;
    cp.hy = cp.mode == H2V2 || cp.mode == H1V2;
    cp.hx = cp.mode == H2V2 || cp.mode == H2V1;
    // the window's blocks at most (a tile's own and its halo)
    const int rows = g.my * v + 2 * cp.hy, cols = g.mx * h + 2 * cp.hx;
    if (rows > WROWS || cols > WCOLS) return (int)cudaErrorInvalidValue;
    blocks += rows * cols;
  }
  if (blocks > MAXB || !q || !out) return (int)cudaErrorInvalidValue;
  const dim3 grid((g.W + g.tw - 1) / g.tw, (g.H + g.th - 1) / g.th);
  jpeg_decode_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(g, (const int*)q, (uint8_t*)out);
  return (int)cudaGetLastError();
}
