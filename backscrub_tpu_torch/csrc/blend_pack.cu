// Fused composite + YUYV pack (K3) and composite + 4:2:0 pack (K4) for
// Hopper (sm_90a).
//
// Replaces the TPU kernel backscrub_tpu/ops/pallas_kernels.py:
// blend_pack_yuyv (_blend_pack_kernel): u8 alpha blend
// (bg*m + fr*(255-m)) / 255 with the exact divide (n + 1 + (n >> 8)) >> 8,
// OpenCV's 14-bit fixed-point RGB->YUV (4899/9617/1868, 8061, 14369),
// 4:2:2 chroma pair average with truncating >> 1, written as
// [Y0, C0, Y1, C1] words.  All integer math: byte-identical to
// alpha_blend_u8 + rgb_to_yuyv.
//
// Bound: bytes.  Per pixel it reads 3 + 3 + 1 and writes 2 bytes, 9 B/px:
// 8.3 MB a 720p frame, 2.5 us at HBM rate.  A thread takes 4 consecutive
// pixels in 4-byte words (3 frame, 3 background, 1 mask word in, 2 out);
// across a warp the three frame words of consecutive threads fill the same
// L1 lines, so each line comes from L2 once.  4 pixels at 128 threads a CTA
// was the fastest launch shape at 640x480 and 1280x720, against 8 and 16
// pixels a thread in 8- and 16-byte words (PERF.md §6).  The output is
// flat pixel pairs (a pair never crosses a row: W is even), so the pixel
// range splits into npix / 4 vectors and a tail of at most one pair that a
// thread past the vectors takes (the per-pair path).  A call whose
// pointers are not 4-byte aligned (a view of a frame may start anywhere)
// runs every pair on the per-pair path, in the same kernel.  The TPU row
// tiling has no counterpart: any H and any even W work.  A stream batch
// (S, H, W, 3) is S * H rows of the same flat pairs (a pair never crosses
// a frame either), so one launch packs it, each frame's bytes those of a
// one-frame launch.

// K4 replaces backscrub_tpu/ops/pallas_kernels.py:blend_pack_420
// (_blend_420_kernel): the same blend, then OpenCV's BT.601 video-range
// RGB->YUV at 20-bit fixed point (cv2 COLOR_BGR2YUV_I420), chroma sampled
// at the top-left pixel of each 2x2 block.  Integer math throughout (>>
// on a negative int is arithmetic in nvcc, as on int32 in PyTorch):
// byte-identical to alpha_blend_u8 + _bt601_yuv420.  The layout, NV12
// (the Y plane, then interleaved [U, V] rows) or I420 (Y, U, V planes), is
// a template argument: no select per pixel.
//
// Bound: bytes.  Per pixel it reads 3 + 3 + 1 = 7 B and writes 1.5 B:
// 2.6 MB at 640x480 (0.78 us at 3.35 TB/s), 7.8 MB at 1280x720 (2.34 us).
// K3's design carried to 4:2:0: a thread takes 4 pixels of one row in
// 4-byte words (three frame, three background, one mask word in, one Y
// word out), so across a warp the frame words of consecutive threads fill
// the same L1 lines, at 128 threads a CTA (K3's measured shape).  A
// thread on an even row also holds the top-left pixels of two 2x2 blocks
// and writes their chroma: one [U, V, U, V] word (NV12) or one 2-byte U
// and one 2-byte V store (I420).  Two rows or 8 columns a thread were
// slower at 640x480 (PERF.md §6).  The vector path needs W % 4 == 0 and
// the four pointers on 4-byte boundaries; any other call (W % 4 == 2, a
// frame that is a view off a word boundary) runs every block on the
// per-block path, one thread a 2x2 block in single bytes, in the same
// kernel.  The TPU kernel computed chroma at full height and the wrapper
// dropped the odd rows outside the kernel (Mosaic cannot lower a strided
// row subsample); here the kernel computes only the samples it writes.
// A stream batch is one launch: blockIdx.y is the frame, whose Y-then-chroma
// block (3HW/2 bytes) and inputs lie at that frame's offsets, so each
// frame's layout and bytes are those of a one-frame launch (the JAX
// wrapper folds the frames into rows and builds each frame's layout with a
// concatenate, backscrub_tpu/pipeline/frame.py:306-312).  The frames'
// offsets are multiples of 4 bytes when W % 4 == 0, so the vector path's
// condition is the first frame's.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ int blend(int bg, int fr, int m) {
  int n = bg * m + fr * (255 - m);
  return (n + 1 + (n >> 8)) >> 8;  // exact n / 255 for n in [0, 65025]
}

__device__ __forceinline__ int clamp255(int v) { return min(max(v, 0), 255); }

// One YUYV word from a pixel pair: f, g, m hold the pair's frame,
// background and mask bytes.  CC: correct_colors; REF: the reference's
// chroma order (C0 = V)
template <bool CC, bool REF>
__device__ __forceinline__ uint32_t yuyv_word(const uint8_t* f, const uint8_t* g,
                                              const uint8_t* m) {
  int y[2], u[2], v[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    int comp[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) comp[c] = blend(g[3 * k + c], f[3 * k + c], m[k]);
    // r/b roles: correct_colors=False feeds BGR into the RGB math (the
    // reference's quirk), True swaps them
    int r = comp[CC ? 2 : 0], gr = comp[1], b = comp[CC ? 0 : 2];
    y[k] = (r * 4899 + gr * 9617 + b * 1868 + (1 << 13)) >> 14;
    u[k] = clamp255(((b - y[k]) * 8061 + (128 << 14) + (1 << 13)) >> 14);
    v[k] = clamp255(((r - y[k]) * 14369 + (128 << 14) + (1 << 13)) >> 14);
  }
  int ua = (u[0] + u[1]) >> 1, va = (v[0] + v[1]) >> 1;
  int c0 = REF ? va : ua, c1 = REF ? ua : va;
  // little-endian word: bytes [Y0, C0, Y1, C1]
  return (uint32_t)y[0] | ((uint32_t)c0 << 8) | ((uint32_t)y[1] << 16) |
         ((uint32_t)c1 << 24);
}

constexpr int YUYV_THREADS = 128;

// threads [0, nvec): 4 pixels each (vector path); threads past them: one
// pair each, pairs 2 * nvec .. npairs - 1 (per-pair path)
template <bool CC, bool REF>
__global__ void blend_pack_yuyv_kernel(const uint8_t* __restrict__ fr,
                                       const uint8_t* __restrict__ bg,
                                       const uint8_t* __restrict__ mask,
                                       uint32_t* __restrict__ out, long long nvec,
                                       long long npairs) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t < nvec) {
    union { uint32_t v[3]; uint8_t b[12]; } f, g;
    union { uint32_t v; uint8_t b[4]; } m;
    const uint32_t* fv = reinterpret_cast<const uint32_t*>(fr) + 3 * t;
    const uint32_t* gv = reinterpret_cast<const uint32_t*>(bg) + 3 * t;
#pragma unroll
    for (int k = 0; k < 3; ++k) f.v[k] = __ldg(fv + k);
#pragma unroll
    for (int k = 0; k < 3; ++k) g.v[k] = __ldg(gv + k);
    m.v = __ldg(reinterpret_cast<const uint32_t*>(mask) + t);
    out[2 * t] = yuyv_word<CC, REF>(f.b, g.b, m.b);
    out[2 * t + 1] = yuyv_word<CC, REF>(f.b + 6, g.b + 6, m.b + 2);
    return;
  }
  const long long p = 2 * nvec + (t - nvec);
  if (p >= npairs) return;
  out[p] = yuyv_word<CC, REF>(fr + 6 * p, bg + 6 * p, mask + 2 * p);
}

// BT.601 video-range encode constants (color_yuv ITUR_BT_601_*, shift 20);
// V's R coefficient is CBU (0.5 for both), as in the JAX package.
constexpr int CRY = 269484, CGY = 528482, CBY = 102760;
constexpr int CRU = -155188, CGU = -305135, CBU = 460324;
constexpr int CGV = -385875, CBV = -74448;
constexpr int SHIFT = 20, HALF = 1 << (SHIFT - 1);

__device__ __forceinline__ int luma(int r, int g, int b) {
  return clamp255((r * CRY + g * CGY + b * CBY + HALF + (16 << SHIFT)) >> SHIFT);
}
__device__ __forceinline__ int chroma_u(int r, int g, int b) {
  return clamp255((r * CRU + g * CGU + b * CBU + HALF + (128 << SHIFT)) >> SHIFT);
}
__device__ __forceinline__ int chroma_v(int r, int g, int b) {
  return clamp255((r * CBU + g * CGV + b * CBV + HALF + (128 << SHIFT)) >> SHIFT);
}

constexpr int PACK420_THREADS = 128;

// threads [0, nvec): 4 pixels of one row each (vector path), row-major; a
// thread on an even row also writes the chroma of the two 2x2 blocks whose
// top-left pixels it holds.  Threads [nvec, nvec + nblk): one 2x2 block
// each (per-block path).  The vector path covers every pixel or none (the
// launcher's choice).
template <bool I420>
__global__ void __launch_bounds__(PACK420_THREADS)
blend_pack_420_kernel(const uint8_t* __restrict__ fr, const uint8_t* __restrict__ bg,
                      const uint8_t* __restrict__ mask, uint8_t* __restrict__ out, int h,
                      int w, int nvec, int nblk) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const long long img = blockIdx.y, hw_px = (long long)h * w;
  fr += 3 * img * hw_px, bg += 3 * img * hw_px, mask += img * hw_px;
  out += img * (hw_px + hw_px / 2);
  uint8_t* chroma = out + hw_px;
  const int hw = w / 2;
  if (t < nvec) {
    const int per_row = w / 4, row = t / per_row, col = (t - row * per_row) * 4;
    const long long px = (long long)row * w + col;
    union { uint32_t v[3]; uint8_t b[12]; } f, g;
    union { uint32_t v; uint8_t b[4]; } m;
    const uint32_t* fv = reinterpret_cast<const uint32_t*>(fr + 3 * px);
    const uint32_t* gv = reinterpret_cast<const uint32_t*>(bg + 3 * px);
#pragma unroll
    for (int k = 0; k < 3; ++k) f.v[k] = __ldg(fv + k);
#pragma unroll
    for (int k = 0; k < 3; ++k) g.v[k] = __ldg(gv + k);
    m.v = __ldg(reinterpret_cast<const uint32_t*>(mask + px));
    uint32_t y = 0, u = 0, v = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int b = blend(g.b[3 * k], f.b[3 * k], m.b[k]);
      const int gr = blend(g.b[3 * k + 1], f.b[3 * k + 1], m.b[k]);
      const int r = blend(g.b[3 * k + 2], f.b[3 * k + 2], m.b[k]);
      y |= (uint32_t)luma(r, gr, b) << (8 * k);
      if (k % 2 == 0) {
        u |= (uint32_t)chroma_u(r, gr, b) << (4 * k);
        v |= (uint32_t)chroma_v(r, gr, b) << (4 * k);
      }
    }
    *reinterpret_cast<uint32_t*>(out + px) = y;
    if (row & 1) return;
    const int bi = row / 2;
    if (I420) {
      const long long q = (long long)(h / 2) * hw, at = (long long)bi * hw + col / 2;
      *reinterpret_cast<uint16_t*>(chroma + at) = (uint16_t)u;
      *reinterpret_cast<uint16_t*>(chroma + q + at) = (uint16_t)v;
    } else {
      *reinterpret_cast<uint32_t*>(chroma + (long long)bi * w + col) =
          (u & 0xff) | (v & 0xff) << 8 | (u >> 8) << 16 | (v >> 8) << 24;
    }
    return;
  }
  const int blk = t - nvec;
  if (blk >= nblk) return;
  const int bi = blk / hw, bj = blk - bi * hw;
  int b00 = 0, g00 = 0, r00 = 0;
#pragma unroll
  for (int di = 0; di < 2; ++di) {
#pragma unroll
    for (int dj = 0; dj < 2; ++dj) {
      const long long px = (long long)(2 * bi + di) * w + 2 * bj + dj;
      const int m = mask[px];
      const int b = blend(bg[3 * px], fr[3 * px], m);
      const int g = blend(bg[3 * px + 1], fr[3 * px + 1], m);
      const int r = blend(bg[3 * px + 2], fr[3 * px + 2], m);
      out[px] = (uint8_t)luma(r, g, b);
      if (di == 0 && dj == 0) b00 = b, g00 = g, r00 = r;
    }
  }
  const uint8_t u = (uint8_t)chroma_u(r00, g00, b00), v = (uint8_t)chroma_v(r00, g00, b00);
  if (I420) {
    const long long q = (long long)(h / 2) * hw;
    chroma[(long long)bi * hw + bj] = u;
    chroma[q + (long long)bi * hw + bj] = v;
  } else {
    chroma[(long long)bi * w + 2 * bj] = u;
    chroma[(long long)bi * w + 2 * bj + 1] = v;
  }
}

template <bool I420>
int launch_420(const uint8_t* fr, const uint8_t* bg, const uint8_t* mask, uint8_t* out,
               int n, int h, int w, cudaStream_t s) {
  const long long blocks4 = (long long)(h / 2) * (w / 2);
  if (blocks4 > 0x7fffffffLL || n > 65535) return (int)cudaErrorInvalidValue;
  const bool vec =
      ((uintptr_t)fr | (uintptr_t)bg | (uintptr_t)mask | (uintptr_t)out) % 4 == 0 && w % 4 == 0;
  const long long nvec = vec ? (long long)h * (w / 4) : 0;
  const long long nblk = vec ? 0 : blocks4;
  const long long ctas = (nvec + nblk + PACK420_THREADS - 1) / PACK420_THREADS;
  blend_pack_420_kernel<I420><<<dim3((unsigned)ctas, n), PACK420_THREADS, 0, s>>>(
      fr, bg, mask, out, h, w, (int)nvec, (int)nblk);
  return (int)cudaGetLastError();
}

template <bool CC, bool REF>
int launch_yuyv(const uint8_t* fr, const uint8_t* bg, const uint8_t* mask, uint32_t* out,
                long long npairs, cudaStream_t s) {
  const bool aligned =
      ((uintptr_t)fr | (uintptr_t)bg | (uintptr_t)mask | (uintptr_t)out) % 4 == 0;
  const long long nvec = aligned ? npairs / 2 : 0;
  const long long work = nvec + (npairs - 2 * nvec);
  const long long blocks = (work + YUYV_THREADS - 1) / YUYV_THREADS;
  blend_pack_yuyv_kernel<CC, REF><<<(unsigned)blocks, YUYV_THREADS, 0, s>>>(
      fr, bg, mask, out, nvec, npairs);
  return (int)cudaGetLastError();
}

}  // namespace

// fr, bg: (N, H, W, 3) u8; mask: (N, H, W) u8; H and W even; out: N
// frames of 3HW/2 bytes, each NV12 ((3H/2, W): Y rows, then [U, V] rows)
// or, with i420, I420 (the Y, U and V planes one after the other).
extern "C" int bs_blend_pack_420(const void* fr, const void* bg,
                                 const void* mask, void* out, int n, int h, int w,
                                 int i420, void* stream) {
  if (h % 2 || w % 2) return (int)cudaErrorInvalidValue;
  if (n <= 0 || h <= 0 || w <= 0) return 0;
  const uint8_t *f = (const uint8_t*)fr, *g = (const uint8_t*)bg, *m = (const uint8_t*)mask;
  uint8_t* o = (uint8_t*)out;
  cudaStream_t s = (cudaStream_t)stream;
  return i420 ? launch_420<true>(f, g, m, o, n, h, w, s)
              : launch_420<false>(f, g, m, o, n, h, w, s);
}

// fr, bg: (H, W, 3) u8; mask: (H, W) u8; W even; out: (H, 2W) u8 (4-byte
// aligned); a stream batch of N frames is H = N * (a frame's rows).  The colour and chroma orders are template arguments: no
// selects per pixel.
extern "C" int bs_blend_pack_yuyv(const void* fr, const void* bg,
                                  const void* mask, void* out, int h, int w,
                                  int chroma_reference, int correct_colors,
                                  void* stream) {
  long long npairs = (long long)h * (w / 2);
  if (w % 2 || (uintptr_t)out % 4) return (int)cudaErrorInvalidValue;
  if (npairs <= 0) return 0;
  const uint8_t *f = (const uint8_t*)fr, *g = (const uint8_t*)bg, *m = (const uint8_t*)mask;
  uint32_t* o = (uint32_t*)out;
  cudaStream_t s = (cudaStream_t)stream;
  if (correct_colors)
    return chroma_reference ? launch_yuyv<true, true>(f, g, m, o, npairs, s)
                            : launch_yuyv<true, false>(f, g, m, o, npairs, s);
  return chroma_reference ? launch_yuyv<false, true>(f, g, m, o, npairs, s)
                          : launch_yuyv<false, false>(f, g, m, o, npairs, s);
}
