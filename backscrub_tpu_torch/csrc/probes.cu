// The seven Mosaic capability probes of tools/probe_mosaic.py (P1-P7) for
// Hopper (sm_90a).  ops/probe_kernels.py wraps them; tools/probe_hopper.py
// runs them on the original's seeded inputs (C, H, W = 16, 48, 80: segm's
// first body resolution) and chip_smoke.py holds each against its plain
// PyTorch twin.
//
// Replaces the pallas_calls of tools/probe_mosaic.py:main():
//   P1 :103 k_dw_flat   9-tap stencil on the flat (C, H*W) layout
//   P2 :131 k_dwp       the same 9 taps on the rowpad layout (128-float rows)
//   P3 :140 mk_dot(prec).k  the weight-stationary (16, 16) @ (16, N) dot
//   P4 :159 k_se        squeeze-excite: row means, (16, 16) dot, sigmoid gate
//   P5 :166 k_cat       channel concat
//   P6 :174 k_ls        lane stride-2 slice x[:, 0::2] (Mosaic refused it)
//   P7 :180 k_rs        in-kernel reshape (C, H, W) -> (C, H*W) (refused too)
// Mosaic's refusals (P6's intra-tile lane gather, P7's relayout) are
// constraints of the TPU's (8, 128) tiles; a CUDA thread addresses any
// float, so here they are plain copies.
//
// Bound: bytes, for every probe.  Each moves 0.37-0.98 MB (0.11-0.29 us at
// 3.35 TB/s) and does at most ~6 MFLOP; no probe at these sizes gets under
// the cost of a launch that reads and writes: on an H100 80GB HBM3 (700 W)
// an empty launch takes 0.868 us and one warp that loads 16 bytes a lane
// and stores them 1.045-1.058 us warm, 1.269-1.374 cold (bs_probe_empty,
// bs_probe_touch; chip_smoke.py).  Every probe is laid out for Hopper: P1
// and P2 as one register-window stencil (16-byte loads, the edge taps by
// warp shuffles), P3 on wgmma from one staged tile a warpgroup, P4 on one
// thread-block cluster whose CTAs share their row sums through distributed
// shared memory, P6 and P7 as one strided copy with every load in flight
// before the first store, and P5 as that copy's body on a grid split
// between its two sources (each below).
//
// Arithmetic, so that the plain twins can match bit for bit where asked:
// P1/P2 multiply and add with __fmul_rn/__fadd_rn (no FMA contraction), the
// taps in the original's order (di outer, dj inner, from 0), each weight the
// f32 rounding of the double 0.1 + di + 2 dj; P5-P7 copy.  P3 runs DEFAULT
// as one bf16 wgmma pass (f32 accumulate), HIGH as the bf16x3 split of
// K2''s GEMM (wgmma.cuh's split2), HIGHEST as f32 FFMA; P4 sums each row,
// divides by N (jnp.mean), and gates with 1 / (1 + expf(-z)).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <type_traits>

#include "async_copy.cuh"
#include "launch.cuh"
#include "wgmma.cuh"

namespace cg = cooperative_groups;

namespace {

inline int blocks(long long n, int per) { return (int)((n + per - 1) / per); }

// -- P1, P2: the 9-tap stencils ---------------------------------------------
//
// out[c, p] = sum over a, b in 0..2 (a outer, b inner) of
// x[c, p + off + a * s + b - 1] * f32(0.1 + (di0 + a) + 2 (b - 1)); reads
// outside the row [0, n_in) are zeros (P2's shifted copies xpl and xm).
// P1: off = s = W, di0 = -1; P2: off = 0, s = 128, di0 = 0.
//
// Every input float feeds 9 outputs, so the bound is the bytes; at the
// probe's 0.5-0.8 MB it is the launch and one L2 round trip.  The grid is
// 2-D, blockIdx.y the channel and blockIdx.x a segment of its row, so
// every index within a row is a 32-bit sum (no division).
// dw9_kernel, the register window: a thread DW_VEC adjacent outputs of a
// row, stored as 16-byte vectors.  For each tap row a it loads the DW_VEC
// floats at p0 + off + a s (16-byte aligned) and takes the float left of
// them from the lane below (__shfl_up_sync) and the float right of them
// from the lane above (__shfl_down_sync); a warp's first lane and its last
// lane with outputs load that outer float themselves, zero outside the
// row.  So a warp reads each float of a tap row's window once, and a
// thread's 9 x DW_VEC products come from 3 x (DW_VEC + 2) registers.  All
// of a thread's loads are issued before a fence, then the shuffles: one
// L2 (or HBM) round trip a launch.  Staging the window in shared memory
// instead (the body's dw_op) measured no faster (tools/sweep_dw9.py).
// dw9_scalar_kernel: one output a thread, every tap a guarded load; the
// launcher takes it where dw9_vec says the vectors do not fit.

constexpr int DW_NT = 128;      // threads a CTA of the stencil
constexpr int DW_VEC = 4;       // outputs a thread on the vector path (a multiple of 4)
constexpr int DW_MAX_Y = 65535;  // gridDim.y's limit: more channels loop

__device__ __forceinline__ float dw9_weight(int di, int b) {
  return (float)(0.1 + (double)di + 2.0 * (double)(b - 1));
}

// Loads of 16 and 4 bytes where ``pred``, else zeros (volatile PTX, no
// branch), and a fence behind them.  Left to itself the compiler sank each
// tap row's load down to its use, behind the row before: three L2 round
// trips in a row instead of one (the SASS, and 0.3-0.8 us a launch on the
// card); a load cannot pass the fence, so all of them are in flight before
// the first shuffle.
__device__ __forceinline__ float4 ld4_if(const float* p, bool pred) {
  float4 v;
  asm volatile(
      "{\n"
      ".reg .pred q;\n"
      "setp.ne.b32 q, %5, 0;\n"
      "mov.f32 %0, 0f00000000;\n"
      "mov.f32 %1, 0f00000000;\n"
      "mov.f32 %2, 0f00000000;\n"
      "mov.f32 %3, 0f00000000;\n"
      "@q ld.global.v4.f32 {%0, %1, %2, %3}, [%4];\n"
      "}\n"
      : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
      : "l"(p), "r"((int)pred));
  return v;
}

__device__ __forceinline__ float ld_if(const float* p, bool pred) {
  float v;
  asm volatile(
      "{\n"
      ".reg .pred q;\n"
      "setp.ne.b32 q, %2, 0;\n"
      "mov.f32 %0, 0f00000000;\n"
      "@q ld.global.f32 %0, [%1];\n"
      "}\n"
      : "=f"(v)
      : "l"(p), "r"((int)pred));
  return v;
}

__global__ void __launch_bounds__(DW_NT)
dw9_kernel(const float* __restrict__ x, float* __restrict__ out, int c, int n_in, int n_out,
           int s, int off, int di0) {
  constexpr unsigned FULL = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const int p0 = (blockIdx.x * DW_NT + threadIdx.x) * DW_VEC;
  const bool active = p0 < n_out;
  const bool last = active && (lane == 31 || p0 + DW_VEC >= n_out);  // no outputs above
  float w[3][3];
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int b = 0; b < 3; ++b) w[a][b] = dw9_weight(di0 + a, b);
  for (int ch = blockIdx.y; ch < c; ch += gridDim.y) {
    const float* row = x + (size_t)ch * n_in;
    // every load first, all in flight at once: v[a][1..DW_VEC] the
    // thread's floats of tap row a, v[a][0] and v[a][DW_VEC + 1] the outer
    // floats where this lane loads them
    float v[3][DW_VEC + 2];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const int q = p0 + off + a * s;          // the thread's first float of tap row a
#pragma unroll
      for (int k = 0; k < DW_VEC / 4; ++k) {
        const float4 t = ld4_if(row + q + 4 * k, active);
        v[a][1 + 4 * k] = t.x;
        v[a][2 + 4 * k] = t.y;
        v[a][3 + 4 * k] = t.z;
        v[a][4 + 4 * k] = t.w;
      }
      v[a][0] = ld_if(row + q - 1, active && lane == 0 && q >= 1);
      v[a][DW_VEC + 1] = ld_if(row + q + DW_VEC, last && q + DW_VEC < n_in);
    }
    __threadfence_block();                     // the loads' fence
    float acc[DW_VEC];
#pragma unroll
    for (int j = 0; j < DW_VEC; ++j) acc[j] = 0.0f;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float up = __shfl_up_sync(FULL, v[a][DW_VEC], 1);
      const float down = __shfl_down_sync(FULL, v[a][1], 1);
      if (lane != 0) v[a][0] = up;
      if (!last) v[a][DW_VEC + 1] = down;
#pragma unroll
      for (int b = 0; b < 3; ++b)
#pragma unroll
        for (int j = 0; j < DW_VEC; ++j)
          acc[j] = __fadd_rn(acc[j], __fmul_rn(v[a][j + b], w[a][b]));
    }
    if (active) {
      float4* dst = reinterpret_cast<float4*>(out + (size_t)ch * n_out + p0);
#pragma unroll
      for (int k = 0; k < DW_VEC / 4; ++k)
        dst[k] = make_float4(acc[4 * k], acc[4 * k + 1], acc[4 * k + 2], acc[4 * k + 3]);
    }
  }
}

__global__ void __launch_bounds__(DW_NT)
dw9_scalar_kernel(const float* __restrict__ x, float* __restrict__ out, int c, int n_in,
                  int n_out, int s, int off, int di0) {
  const int p = blockIdx.x * DW_NT + threadIdx.x;
  if (p >= n_out) return;
  for (int ch = blockIdx.y; ch < c; ch += gridDim.y) {
    const float* row = x + (size_t)ch * n_in;
    float acc = 0.0f;
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int b = 0; b < 3; ++b) {
        const int q = p + off + a * s + b - 1;
        const float v = q >= 0 && q < n_in ? __ldg(row + q) : 0.0f;
        acc = __fadd_rn(acc, __fmul_rn(v, dw9_weight(di0 + a, b)));
      }
    out[(size_t)ch * n_out + p] = acc;
  }
}

// -- P3: y = W x, W (16, 16), x (16, n), f32 in and out ---------------------
//
// A CTA is one warpgroup (128 threads) that walks 64-column tiles of x
// (DOT_TILE, wgmma's M), at most one CTA an SM.  Each tile is staged
// into xs (16 rows at an XS-float stride, zero past n; loaded while W is
// read), its output goes through ys and out as row stores.  DEFAULT and HIGH run the
// product transposed, Y^T = X^T W^T, as wgmma.m64n16k16 (M = 64 columns, N
// = 16 output channels, K = 16): A = X^T from registers, each thread's
// fragment read from xs and split to bf16 hi (and lo) in registers (X^T is
// MN-major in memory, which A from shared memory would need transposed);
// B = W^T from shared memory, W split once a CTA into hi and lo in the
// no-swizzle K-major core-matrix layout (W (o, k) row-major is already
// K-major for W^T).  DEFAULT is hi.hi; HIGH adds lo.hi + hi.lo from a
// second accumulator, then acc + cor as gemm_wg.cuh does.  HIGHEST is f32
// FFMA on the same staged tile: a thread 4 consecutive columns of 2 rows,
// k ascending.

constexpr int DOT_NT = 128;           // one warpgroup
constexpr int DOT_TILE = 64;          // columns a tile
constexpr int XS = DOT_TILE + 4;      // xs/ys row stride: A reads and D writes conflict-free
// B's core matrices (8 rows of 16 bytes, 128 bytes each): the K-neighbour
// at LBO bytes, the next 8 output channels at SBO
constexpr int B_LBO = 128, B_SBO = 256;

// byte offset of W[o][k] (bf16) in the K-major core-matrix layout
__device__ __forceinline__ int b_offset(int o, int k) {
  return (o >> 3) * B_SBO + (k >> 3) * B_LBO + (o & 7) * 16 + (k & 7) * 2;
}

// the 16 x 64 tile of x at column c0 (zeros past n) into registers, 8
// floats a thread: two 16-byte vectors where ``VEC``, else single floats;
// then (dot_put) into xs.  Loads through registers measured faster than
// cp.async at this size (PERF.md §6).
template <bool VEC>
__device__ __forceinline__ void dot_load(const float* __restrict__ x, int n, int c0,
                                         float (&v)[8]) {
  const int tid = threadIdx.x;
  if (VEC) {                                       // 16 rows x 16 vectors
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int i = tid + j * DOT_NT, col = c0 + (i & 15) * 4;
      const float4 f = col < n ? __ldg(reinterpret_cast<const float4*>(x + (size_t)(i >> 4) * n
                                                                       + col))
                               : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      v[4 * j] = f.x; v[4 * j + 1] = f.y; v[4 * j + 2] = f.z; v[4 * j + 3] = f.w;
    }
  } else {                                         // 16 rows x 64 floats
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int i = tid + j * DOT_NT, col = c0 + (i & 63);
      v[j] = col < n ? __ldg(x + (size_t)(i >> 6) * n + col) : 0.0f;
    }
  }
}

template <bool VEC>
__device__ __forceinline__ void dot_put(float* xs, const float (&v)[8]) {
  const int tid = threadIdx.x;
  if (VEC) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int i = tid + j * DOT_NT;
      *reinterpret_cast<float4*>(xs + (i >> 4) * XS + (i & 15) * 4) =
          make_float4(v[4 * j], v[4 * j + 1], v[4 * j + 2], v[4 * j + 3]);
    }
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int i = tid + j * DOT_NT;
      xs[(i >> 6) * XS + (i & 63)] = v[j];
    }
  }
}

// MODE 0 DEFAULT, 1 HIGH (wgmma), 2 HIGHEST (FFMA); VEC: n % 4 == 0, x and y
// on 16-byte boundaries
template <int MODE, bool VEC>
__global__ void __launch_bounds__(DOT_NT)
dot_kernel(const float* __restrict__ w, const float* __restrict__ x, float* __restrict__ y,
           int n) {
  __shared__ __align__(16) float xs[16 * XS], ys[16 * XS];
  __shared__ __align__(128) uint8_t bw[2][512];    // W hi, lo (wgmma's B)
  __shared__ __align__(16) float ws[256];          // W in f32 (HIGHEST)
  const int tid = threadIdx.x, tiles = (n + DOT_TILE - 1) / DOT_TILE;
  float v[8];
  dot_load<VEC>(x, n, blockIdx.x * DOT_TILE, v);   // in flight while W is read
  if constexpr (MODE < 2) {
    const int o = tid >> 3, k = (tid & 7) * 2;     // a pair (k, k + 1) a thread
    uint32_t hi, lo;
    wg::split2(__ldg(w + o * 16 + k), __ldg(w + o * 16 + k + 1), hi, lo);
    *reinterpret_cast<uint32_t*>(bw[0] + b_offset(o, k)) = hi;
    if (MODE == 1) *reinterpret_cast<uint32_t*>(bw[1] + b_offset(o, k)) = lo;
    wg::fence_proxy_async();                       // visible to wgmma
  } else {
    ws[tid] = __ldg(w + tid);
    ws[tid + DOT_NT] = __ldg(w + tid + DOT_NT);
  }
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int c0 = tile * DOT_TILE;
    if (tile != blockIdx.x) dot_load<VEC>(x, n, c0, v);
    dot_put<VEC>(xs, v);                           // xs's readers passed the last barrier
    __syncthreads();
    if constexpr (MODE < 2) {
      const int lane = tid & 31, g = lane >> 2, t = lane & 3, m0 = (tid >> 5) * 16 + g;
      uint32_t ah[4], al[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {                // A[m][k], A[m][k + 1] = xs[k][m], xs[k + 1][m]
        const int m = m0 + (q & 1) * 8, k = 2 * t + (q >> 1) * 8;
        wg::split2(xs[k * XS + m], xs[(k + 1) * XS + m], ah[q], al[q]);
      }
      float acc[8] = {}, cor[8] = {};
      wg::reg_fence(acc);
      wg::reg_fence(cor);
      wg::fence();
      wg::mma<16>(acc, ah, wg::smem_desc(bw[0], B_LBO, B_SBO));
      if (MODE == 1) {
        wg::mma<16>(cor, al, wg::smem_desc(bw[0], B_LBO, B_SBO));
        wg::mma<16>(cor, ah, wg::smem_desc(bw[1], B_LBO, B_SBO));
      }
      wg::commit();
      wg::wait<0>();
      wg::reg_fence(acc);
      wg::reg_fence(cor);
      wg::reg_fence(ah);
      wg::reg_fence(al);
#pragma unroll
      for (int i = 0; i < 8; ++i) {                // D[m][o] = y[o][c0 + m]
        const int m = m0 + ((i >> 1) & 1) * 8, o = (i >> 2) * 8 + 2 * t + (i & 1);
        ys[o * XS + m] = MODE == 1 ? acc[i] + cor[i] : acc[i];
      }
    } else {
      const int q = (tid & 15) * 4, r0 = (tid >> 4) * 2;
      float4 xv[16];
#pragma unroll
      for (int k = 0; k < 16; ++k) xv[k] = *reinterpret_cast<const float4*>(xs + k * XS + q);
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const float* wr = ws + (r0 + rr) * 16;
        float4 a = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
        for (int k = 0; k < 16; ++k) {
          a.x = fmaf(wr[k], xv[k].x, a.x);
          a.y = fmaf(wr[k], xv[k].y, a.y);
          a.z = fmaf(wr[k], xv[k].z, a.z);
          a.w = fmaf(wr[k], xv[k].w, a.w);
        }
        *reinterpret_cast<float4*>(ys + (r0 + rr) * XS + q) = a;
      }
    }
    __syncthreads();
    if (VEC) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int i = tid + j * DOT_NT, r = i >> 4, col = c0 + (i & 15) * 4;
        if (col < n)
          *reinterpret_cast<float4*>(y + (size_t)r * n + col) =
              *reinterpret_cast<const float4*>(ys + r * XS + (i & 15) * 4);
      }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int i = tid + j * DOT_NT, r = i >> 6, col = c0 + (i & 63);
        if (col < n) y[(size_t)r * n + col] = ys[r * XS + (i & 63)];
      }
    }
  }
}

// -- P4: out = x * sigmoid(W mean(x, 1)), x (c, n), W (c, c), c <= 32 -------
//
// ONE thread-block cluster of SE_R CTAs.  CTA j owns columns [j S, (j + 1)
// S) of every row (S = ceil(n / SE_R) rounded up to 4).  Warp v takes rows
// v, v + SE_NW, ...; its lanes load the row's slice into registers (16-byte
// vectors where n % 4 == 0 and the pointers are aligned, else floats; lane
// i elements i and i + 32 of each 64-element chunk), all rows' loads in
// flight together, and sum them, then a shuffle tree.  It pushes its c
// partial sums into slot [j][row] of every CTA's ``part`` through
// distributed shared memory, after a cluster barrier whose arrive was
// issued at entry (a CTA is written to only once all have started) and
// before one cluster sync (the pushes visible).  Then each CTA reads only
// its own shared memory: the SE_R partials in rank order (the same order
// on every CTA, so runs are bit-identical), mean = sum / n, the c gates
// (fmaf, k ascending, then 1 / (1 + expf(-z))), and multiplies its slice
// with 16-byte stores, the first chunk from registers.  x is read from
// memory once where a row's slice is one chunk (S <= 256 columns, or 64
// unvectorized; the probe's 240); the rest of a longer slice is read again
// for the multiply.  Staging the slice in shared memory by cp.async
// instead was slower at the probe's shape (PERF.md §6).

constexpr int SE_R = 16;                      // CTAs in the cluster
constexpr int SE_NT = 256, SE_NW = SE_NT / 32;
constexpr int SE_H = 2;                       // elements a lane of a row's chunk
constexpr int SE_CHUNK = 32 * SE_H;           // elements (vectors or floats) a chunk

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ float hsum(float4 v) { return (v.x + v.y) + (v.z + v.w); }
__device__ __forceinline__ float hsum(float v) { return v; }
__device__ __forceinline__ float4 scale(float4 v, float g) {
  return make_float4(v.x * g, v.y * g, v.z * g, v.w * g);
}
__device__ __forceinline__ float scale(float v, float g) { return v * g; }

template <bool VEC>
using SeT = typename std::conditional<VEC, float4, float>::type;

// chunk ``ch`` of the RW rows of warp ``warp`` into v (zeros past E elements
// or c rows), all loads in flight together; then its sums into acc
template <bool VEC, int RW>
__device__ __forceinline__ void se_load(const float* __restrict__ x, int n, int col0, int c,
                                        int E, int ch, float (&acc)[RW],
                                        SeT<VEC> (&v)[RW][SE_H]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < RW; ++j) {
    const SeT<VEC>* row =
        reinterpret_cast<const SeT<VEC>*>(x + (size_t)(warp + j * SE_NW) * n + col0);
#pragma unroll
    for (int h = 0; h < SE_H; ++h) {
      const int e = ch * SE_CHUNK + lane + 32 * h;
      v[j][h] = warp + j * SE_NW < c && e < E ? __ldg(row + e) : SeT<VEC>{};
    }
  }
#pragma unroll
  for (int j = 0; j < RW; ++j)
#pragma unroll
    for (int h = 0; h < SE_H; ++h) acc[j] += hsum(v[j][h]);
}

template <bool VEC, int RW>  // RW rows a warp: c <= SE_NW RW
__global__ void __launch_bounds__(SE_NT)
se_kernel(const float* __restrict__ x, const float* __restrict__ w, float* __restrict__ out,
          int c, int n, int S) {
  using T = SeT<VEC>;
  __shared__ float part[SE_R * 32];               // part[j * 32 + r]: CTA j's sum of row r
  __shared__ float mean[32], gate[32];
  __shared__ float ws[32 * 33];                   // W[r][k] at r * 33 + k: no bank conflicts
  cluster_arrive_relaxed();                       // this CTA has started
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int col0 = rank * S, cols = max(0, min(S, n - col0));
  const int E = VEC ? cols / 4 : cols, nch = (E + SE_CHUNK - 1) / SE_CHUNK;
  for (int i = tid; i < c * c; i += SE_NT) cp_async4(ws + i / c * 33 + i % c, w + i, true);
  cp_async_commit();
  T v[RW][SE_H];                                  // the first chunk, kept for the multiply
  float acc[RW] = {};
  se_load<VEC, RW>(x, n, col0, c, E, 0, acc, v);
  for (int ch = 1; ch < nch; ++ch) {              // a longer slice: read again below
    T u[RW][SE_H];
    se_load<VEC, RW>(x, n, col0, c, E, ch, acc, u);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)                // the rows' shuffle trees side by side
#pragma unroll
    for (int j = 0; j < RW; ++j)
      if (warp + j * SE_NW < c) acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], o);
  cluster_wait();                                 // every CTA has started: push
  constexpr int PER = 32 / SE_R;                  // rows a round: lane l, row l / SE_R to CTA
                                                  // l % SE_R
#pragma unroll
  for (int p = 0; p < RW; p += PER) {
    const int u = lane / SE_R, r = warp + (p + u) * SE_NW;
    float s = acc[p];
#pragma unroll
    for (int k = 1; k < PER && p + k < RW; ++k) s = u == k ? acc[p + k] : s;
    if (p + u < RW && r < c) cluster.map_shared_rank(part, lane % SE_R)[rank * 32 + r] = s;
  }
  cluster_arrive();
  cp_async_wait<0>();
  cluster_wait();                                 // every partial has landed
  if (tid < c) {
    float s = 0.0f;
#pragma unroll
    for (int j = 0; j < SE_R; ++j) s += part[j * 32 + tid];
    mean[tid] = s / (float)n;
  }
  __syncthreads();
  if (tid < c) {
    float z = 0.0f;
    for (int k = 0; k < c; ++k) z = fmaf(ws[tid * 33 + k], mean[k], z);
    gate[tid] = 1.0f / (1.0f + expf(-z));
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < RW; ++j) {
    const int r = warp + j * SE_NW;
    if (r >= c) continue;
    const T* src = reinterpret_cast<const T*>(x + (size_t)r * n + col0);
    T* dst = reinterpret_cast<T*>(out + (size_t)r * n + col0);
    const float g = gate[r];
#pragma unroll
    for (int h = 0; h < SE_H; ++h)                // the first chunk from registers
      if (lane + 32 * h < E) dst[lane + 32 * h] = scale(v[j][h], g);
    for (int e = SE_CHUNK + lane; e < E; e += 32) dst[e] = scale(__ldg(src + e), g);
  }
}

// -- P6, P7: the strided copy -----------------------------------------------
//
// out[r, j] = x[r, S j] for x (c, n) f32 and out (c, ceil(n / S)): P6 is
// S = 2 (x[:, 0::2]), P7 is S = 1 on the flattened (C, H*W) view.  A copy:
// no arithmetic, so kernel and twin agree bit for bit.  Bound: the bytes,
// and at the probe's 0.37-0.49 MB the launch and one L2 round trip.
// strided_copy_kernel, the vector path: where S = 1 or n is even the copy
// is flat, out_flat[k] = x_flat[S k].  A thread loads CP_LOADS 16-byte
// input vectors and stores the CP_LOADS / S output vectors they make,
// CP_NT apart (a warp's stores adjacent); P6 keeps lanes x and z of each
// input vector, so every store is 16 bytes (ptxas then loads only those
// two lanes, 4 bytes each; volatile 16-byte loads measured the same).  All
// of a thread's loads are issued before a fence and the first store: one
// round trip a launch.  A CTA moves the same bytes in for P6 and P7.  1-D
// grid, 32-bit indices, no division.  Neither P6's loads made contiguous
// across a warp (lanes x and z then traded by shuffles) nor P7 by the
// TMA's bulk copies measured faster (tools/sweep_copy.py).
// strided_copy_scalar_kernel: one output a thread on a 2-D grid
// (blockIdx.y the row, looping past DW_MAX_Y; blockIdx.x a segment of
// it), where copy_vec says the vectors do not fit.

constexpr int CP_NT = 128;      // threads a CTA of the copy
constexpr int CP_LOADS = 2;     // input vectors a thread on the vector path (S divides it)

// The vector path's body, shared by P5-P7: CTA ``cta`` of a 1-D grid
// stores output vectors [cta CP_NT V, (cta + 1) CP_NT V) of out's m, V =
// CP_LOADS / S a thread CP_NT apart, each from the S input vectors behind
// it; every load before the fence and the first store.
template <int S>
__device__ __forceinline__ void copy_vectors(const float4* __restrict__ x,
                                             float4* __restrict__ out, int m, int cta) {
  constexpr int V = CP_LOADS / S;              // output vectors a thread
  const int v0 = cta * (CP_NT * V) + threadIdx.x;
  float4 in[V][S];
#pragma unroll
  for (int k = 0; k < V; ++k)
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int v = v0 + k * CP_NT;
      in[k][s] = ld4_if(reinterpret_cast<const float*>(x + S * v + s), v < m);
    }
  __threadfence_block();                       // the loads' fence
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int v = v0 + k * CP_NT;
    if (v >= m) continue;
    if constexpr (S == 1)
      out[v] = in[k][0];
    else
      out[v] = make_float4(in[k][0].x, in[k][0].z, in[k][1].x, in[k][1].z);
  }
}

template <int S>
__global__ void __launch_bounds__(CP_NT)
strided_copy_kernel(const float4* __restrict__ x, float4* __restrict__ out, int m) {
  copy_vectors<S>(x, out, m, blockIdx.x);
}

template <int S>
__global__ void __launch_bounds__(CP_NT)
strided_copy_scalar_kernel(const float* __restrict__ x, float* __restrict__ out, int c, int n,
                           int no) {
  const int j = blockIdx.x * CP_NT + threadIdx.x;
  if (j >= no) return;
  for (int r = blockIdx.y; r < c; r += gridDim.y)
    out[(size_t)r * no + j] = __ldg(x + (size_t)r * n + S * j);
}

// -- P5: the concat, a two-source copy ---------------------------------------
//
// out[0, na) = a, out[na, na + nb) = b (floats): [a; b] on the row axis of
// row-major (Ca, N) and (Cb, N) is the two buffers one after the other.
// One launch on a 1-D grid split between the sources: CTAs [0, ba) copy a
// to out, CTAs [ba, gridDim.x) copy b to out + na, the source chosen once
// a CTA from blockIdx.x.  concat_kernel, where na and nb are whole 16-byte
// vectors and a, b and out aligned (out + na then is too): each half the
// strided copy's vector body at S = 1 (copy_vectors).  concat_scalar_kernel
// otherwise: one float a thread on the same split.

__global__ void __launch_bounds__(CP_NT)
concat_kernel(const float4* __restrict__ a, const float4* __restrict__ b,
              float4* __restrict__ out, int ma, int mb, int ba) {
  const bool first = (int)blockIdx.x < ba;
  copy_vectors<1>(first ? a : b, first ? out : out + ma, first ? ma : mb,
                  first ? (int)blockIdx.x : (int)blockIdx.x - ba);
}

__global__ void __launch_bounds__(CP_NT)
concat_scalar_kernel(const float* __restrict__ a, const float* __restrict__ b,
                     float* __restrict__ out, int na, int nb, int ba) {
  const bool first = (int)blockIdx.x < ba;
  const int i = (first ? (int)blockIdx.x : (int)blockIdx.x - ba) * CP_NT + threadIdx.x;
  if (i < (first ? na : nb)) (first ? out : out + na)[i] = __ldg((first ? a : b) + i);
}

// The floors of a launch: a kernel that does nothing, and one warp whose
// lanes each load 16 bytes and store them to another buffer.
__global__ void empty_kernel() {}

__global__ void touch_kernel(const float4* __restrict__ x, float4* __restrict__ out) {
  out[threadIdx.x] = __ldg(x + threadIdx.x);
}

inline bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

// P1 and P2's vector path: every thread's vectors inside the row and
// 16-byte aligned (off, s and the row length multiples of 4, whole
// vectors of outputs, both pointers aligned); otherwise the scalar path
inline bool dw9_vec(const void* x, const void* out, int n_in, int n_out, int s, int off) {
  return off >= 0 && s >= 0 && off % 4 == 0 && s % 4 == 0 && n_in % 4 == 0 &&
         n_out % DW_VEC == 0 && (long long)n_out + off + 2LL * s <= n_in && aligned16(x) &&
         aligned16(out);
}

// P6 and P7's vector path: the copy flat (S = 1 or n even), whole 16-byte
// vectors of output, the input's floats countable in 32 bits and both
// pointers aligned; otherwise the scalar path
inline bool copy_vec(const void* x, const void* out, int c, int n, int S) {
  return (S == 1 || n % 2 == 0) && (long long)c * n / S % 4 == 0 &&
         (long long)c * n <= INT_MAX && aligned16(x) && aligned16(out);
}

// P5's vector path: both counts whole 16-byte vectors and every pointer
// of a non-empty source aligned; otherwise the scalar path
inline bool concat_vec(const void* a, const void* b, const void* out, int na, int nb) {
  return na % 4 == 0 && nb % 4 == 0 && (na == 0 || aligned16(a)) && (nb == 0 || aligned16(b)) &&
         aligned16(out);
}

// P6 and P7's launch: x (c, n) -> out (c, ceil(n / S)), f32; the path by
// copy_vec, decided before the launch
template <int S>
int strided_copy(const void* x, void* out, int c, int n, void* stream) {
  if (c <= 0 || n <= 0) return 0;
  if (copy_vec(x, out, c, n, S)) {
    const int m = (int)((long long)c * n / S / 4);   // output vectors
    const int per = CP_NT * (CP_LOADS / S);           // output vectors a CTA
    strided_copy_kernel<S><<<blocks(m, per), CP_NT, 0, (cudaStream_t)stream>>>(
        (const float4*)x, (float4*)out, m);
  } else {
    const int no = (n + S - 1) / S;
    const dim3 grid(blocks(no, CP_NT), c < DW_MAX_Y ? c : DW_MAX_Y);
    strided_copy_scalar_kernel<S><<<grid, CP_NT, 0, (cudaStream_t)stream>>>(
        (const float*)x, (float*)out, c, n, no);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// P1 (off = s = W, di0 = -1) and P2 (off = 0, s = 128, di0 = 0): x (c,
// n_in), out (c, n_out), f32.
extern "C" int bs_probe_dw9(const void* x, void* out, int c, int n_in, int n_out, int s,
                            int off, int di0, void* stream) {
  if (c <= 0 || n_out <= 0) return 0;
  const bool vec = dw9_vec(x, out, n_in, n_out, s, off);
  const dim3 grid(blocks(vec ? n_out / DW_VEC : n_out, DW_NT), c < DW_MAX_Y ? c : DW_MAX_Y);
  void (*const kern)(const float*, float*, int, int, int, int, int, int) =
      vec ? &dw9_kernel : &dw9_scalar_kernel;
  kern<<<grid, DW_NT, 0, (cudaStream_t)stream>>>((const float*)x, (float*)out, c, n_in, n_out,
                                                  s, off, di0);
  return (int)cudaGetLastError();
}

// the launch floor: one CTA of one warp of empty_kernel
extern "C" int bs_probe_empty(void* stream) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

// the read-then-write floor: one CTA of one warp of touch_kernel, x and out
// 512 bytes each, 16-byte aligned
extern "C" int bs_probe_touch(const void* x, void* out, void* stream) {
  touch_kernel<<<1, 32, 0, (cudaStream_t)stream>>>((const float4*)x, (float4*)out);
  return (int)cudaGetLastError();
}

// P3: w (16, 16), x (16, n), y (16, n), f32; mode 0 DEFAULT, 1 HIGH, 2 HIGHEST
extern "C" int bs_probe_dot(const void* w, const void* x, void* y, int n, int mode,
                            void* stream) {
  if (n <= 0) return 0;
  if (mode < 0 || mode > 2) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const int tiles = blocks(n, DOT_TILE), grid = tiles < sms ? tiles : sms;
  void (*const kerns[2][3])(const float*, const float*, float*, int) = {
      {&dot_kernel<0, false>, &dot_kernel<1, false>, &dot_kernel<2, false>},
      {&dot_kernel<0, true>, &dot_kernel<1, true>, &dot_kernel<2, true>}};
  const int vec = n % 4 == 0 && aligned16(x) && aligned16(y);
  kerns[vec][mode]<<<grid, DOT_NT, 0, (cudaStream_t)stream>>>((const float*)w, (const float*)x,
                                                               (float*)y, n);
  return (int)cudaGetLastError();
}

// P4: x (c, n), w (c, c), out (c, n), f32, 1 <= c <= 32; one cluster of
// SE_R CTAs, refused (an error, nothing launched) where the card cannot
// hold it
extern "C" int bs_probe_se(const void* x, const void* w, void* out, int c, int n,
                           void* stream) {
  if (c < 1 || c > 32 || n < 1) return (int)cudaErrorInvalidValue;
  const int vec = n % 4 == 0 && aligned16(x) && aligned16(out);
  const int S = (blocks(n, SE_R) + 3) / 4 * 4;          // columns a CTA
  const int rw = blocks(c, SE_NW);                       // rows a warp: 1, 2, 3 or 4
  void (*kern)(const float*, const float*, float*, int, int, int) =
      vec ? (rw == 1 ? &se_kernel<true, 1> : rw == 2 ? &se_kernel<true, 2> : &se_kernel<true, 4>)
          : (rw == 1 ? &se_kernel<false, 1> : rw == 2 ? &se_kernel<false, 2>
                                                     : &se_kernel<false, 4>);
  return launch_cluster(kern, SE_R, SE_NT, 0, (cudaStream_t)stream, (const float*)x,
                        (const float*)w, (float*)out, c, n, S);
}

// the CTAs of P4's cluster
extern "C" int bs_probe_se_cluster(void) { return SE_R; }

// P5: a, b -> out = [a; b]; counts in floats, refused (an error, nothing
// launched) past INT_MAX floats in all, where the kernels' 32-bit indices
// would wrap
extern "C" int bs_probe_cat(const void* a, const void* b, void* out, int na, int nb,
                            void* stream) {
  if (na < 0 || nb < 0 || (long long)na + nb > INT_MAX) return (int)cudaErrorInvalidValue;
  if (na + nb == 0) return 0;
  if (concat_vec(a, b, out, na, nb)) {
    const int ma = na / 4, mb = nb / 4, per = CP_NT * CP_LOADS;    // vectors; a CTA's
    const int ba = blocks(ma, per);
    concat_kernel<<<ba + blocks(mb, per), CP_NT, 0, (cudaStream_t)stream>>>(
        (const float4*)a, (const float4*)b, (float4*)out, ma, mb, ba);
  } else {
    const int ba = blocks(na, CP_NT);
    concat_scalar_kernel<<<ba + blocks(nb, CP_NT), CP_NT, 0, (cudaStream_t)stream>>>(
        (const float*)a, (const float*)b, (float*)out, na, nb, ba);
  }
  return (int)cudaGetLastError();
}

// P6: x (c, n) -> out (c, (n + 1) / 2), f32
extern "C" int bs_probe_stride2(const void* x, void* out, int c, int n, void* stream) {
  return strided_copy<2>(x, out, c, n, stream);
}

// P7: x (c, n) -> out (c, n), f32: (C, H, W) as (C, H*W)
extern "C" int bs_probe_copy(const void* x, void* out, int c, int n, void* stream) {
  return strided_copy<1>(x, out, c, n, stream);
}
