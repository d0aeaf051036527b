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
// 3.35 TB/s) and does at most ~6 MFLOP; a launch costs ~2 us.  So the
// kernels are simple: one thread an output (or a 16-byte vector of them),
// inputs through the read-only path, no staging.
//
// Arithmetic, so that the plain twins can match bit for bit where asked:
// P1/P2 multiply and add with __fmul_rn/__fadd_rn (no FMA contraction), the
// taps in the original's order (di outer, dj inner, from 0), each weight the
// f32 rounding of the double 0.1 + di + 2 dj; P5-P7 copy.  P3 runs DEFAULT
// as one mma.sync.m16n8k16 bf16 pass (f32 accumulate), HIGH as the bf16x3
// split of gemm_tc.cuh (K2''s GEMM), HIGHEST as f32 FFMA; P4 sums each row,
// divides by N (jnp.mean), and gates with 1 / (1 + expf(-z)).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gemm_tc.cuh"

namespace {

constexpr int NT = 256;          // threads a CTA of the elementwise probes
constexpr int SE_NT = 512;       // P4's single CTA: 16 warps

inline int blocks(long long n, int per) { return (int)((n + per - 1) / per); }

// P1, P2: out[c, p] = sum over a, b in 0..2 (a outer, b inner) of
// x[c, p + off + a * s + b - 1] * f32(0.1 + (di0 + a) + 2 (b - 1)); reads
// outside the row [0, n_in) are zeros (P2's shifted copies xpl and xm).
__global__ void __launch_bounds__(NT)
dw9_kernel(const float* __restrict__ x, float* __restrict__ out, int c, int n_in,
           int n_out, int s, int off, int di0) {
  const long long e = (long long)blockIdx.x * NT + threadIdx.x;
  if (e >= (long long)c * n_out) return;
  const int ch = (int)(e / n_out), p = (int)(e % n_out);
  const float* row = x + (size_t)ch * n_in;
  float acc = 0.0f;
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      const float w = (float)(0.1 + (double)(di0 + a) + 2.0 * (double)(b - 1));
      const int q = p + off + a * s + b - 1;
      const float v = q >= 0 && q < n_in ? __ldg(row + q) : 0.0f;
      acc = __fadd_rn(acc, __fmul_rn(v, w));
    }
  out[e] = acc;
}

// P3 DEFAULT (high = 0) and HIGH (high = 1): y = W x for W (16, 16) and x
// (16, n), f32 in and out.  One warp an 8-column tile: W is one m16n8k16 A
// fragment, split to bf16 hi (and lo) in registers; x's 16 x 8 block one B
// fragment.  DEFAULT is hi.hi; HIGH adds hi.lo + lo.hi from a second
// accumulator, as gemm_tc.cuh's tile does.
__global__ void __launch_bounds__(128)
dot_mma_kernel(const float* __restrict__ w, const float* __restrict__ x,
               float* __restrict__ y, int n, int high) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int n0 = (blockIdx.x * 4 + (threadIdx.x >> 5)) * 8;
  if (n0 >= n) return;
  uint32_t ah[4], al[4], bh[2], bl[2];
#pragma unroll
  for (int q = 0; q < 4; ++q) {          // A[g (+8)][2t (+8) .. +1]
    const int r = g + (q & 1) * 8, k = 2 * t + (q >> 1) * 8;
    gemm_tc::split2(__ldg(w + r * 16 + k), __ldg(w + r * 16 + k + 1), ah[q], al[q]);
  }
  const int col = n0 + g;
#pragma unroll
  for (int h = 0; h < 2; ++h) {          // B[2t + 8h .. +1][g]
    const int k = 2 * t + 8 * h;
    const float v0 = col < n ? __ldg(x + (size_t)k * n + col) : 0.0f;
    const float v1 = col < n ? __ldg(x + (size_t)(k + 1) * n + col) : 0.0f;
    gemm_tc::split2(v0, v1, bh[h], bl[h]);
  }
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f}, cor[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  gemm_tc::mma_bf16(acc, ah, bh);
  if (high) {
    gemm_tc::mma_bf16(cor, ah, bl);
    gemm_tc::mma_bf16(cor, al, bh);
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) {          // C[g (+8)][2t (+1)]
    const int r = g + (q >> 1) * 8, cc = n0 + 2 * t + (q & 1);
    if (cc < n) y[(size_t)r * n + cc] = high ? acc[q] + cor[q] : acc[q];
  }
}

// P3 HIGHEST: y = W x in f32 FFMA; a thread computes four rows of one
// column, W staged in shared memory.
__global__ void __launch_bounds__(NT)
dot_f32_kernel(const float* __restrict__ w, const float* __restrict__ x,
               float* __restrict__ y, int n) {
  __shared__ float sw[256];
  for (int i = threadIdx.x; i < 256; i += NT) sw[i] = w[i];
  __syncthreads();
  const long long e = (long long)blockIdx.x * NT + threadIdx.x;
  if (e >= 4LL * n) return;
  const int col = (int)(e % n), m0 = (int)(e / n) * 4;
  float xv[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) xv[k] = __ldg(x + (size_t)k * n + col);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < 16; ++k) acc = fmaf(sw[(m0 + r) * 16 + k], xv[k], acc);
    y[(size_t)(m0 + r) * n + col] = acc;
  }
}

// P4: out = x * sigmoid(W mean(x, 1)) for x (c, n), W (c, c), c <= 32, in
// ONE CTA: warps sum rows (16-byte loads when ``vec``), then c threads the
// gate, then every thread multiplies (x read twice, the second time from
// L2).  The gate needs every row's mean, so one CTA is the simple form; a
// cluster sharing means through distributed shared memory is later work.
__global__ void __launch_bounds__(SE_NT)
se_kernel(const float* __restrict__ x, const float* __restrict__ w, float* __restrict__ out,
          int c, int n, int vec) {
  __shared__ float mean[32], gate[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < c; r += SE_NT / 32) {
    const float* row = x + (size_t)r * n;
    float s = 0.0f;
    if (vec) {
      const float4* r4 = reinterpret_cast<const float4*>(row);
      for (int i = lane; i < n / 4; i += 32) {
        const float4 v = __ldg(r4 + i);
        s += (v.x + v.y) + (v.z + v.w);
      }
    } else {
      for (int i = lane; i < n; i += 32) s += __ldg(row + i);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) mean[r] = s / (float)n;
  }
  __syncthreads();
  if (threadIdx.x < c) {
    float z = 0.0f;
    for (int k = 0; k < c; ++k) z = fmaf(w[threadIdx.x * c + k], mean[k], z);
    gate[threadIdx.x] = 1.0f / (1.0f + expf(-z));
  }
  __syncthreads();
  if (vec) {
    const float4* x4 = reinterpret_cast<const float4*>(x);
    float4* o4 = reinterpret_cast<float4*>(out);
    const int n4 = n / 4;
    for (int i = threadIdx.x; i < c * n4; i += SE_NT) {
      const float gv = gate[i / n4];
      float4 v = x4[i];
      v.x *= gv; v.y *= gv; v.z *= gv; v.w *= gv;
      o4[i] = v;
    }
  } else {
    for (int i = threadIdx.x; i < c * n; i += SE_NT) out[i] = x[i] * gate[i / n];
  }
}

// P5 (and P7 with nb = 0): out[0, na) = a, out[na, na + nb) = b, floats;
// ``vec``: 16-byte loads and stores (na, nb multiples of 4, pointers aligned)
__global__ void __launch_bounds__(NT)
cat_kernel(const float* __restrict__ a, const float* __restrict__ b, float* __restrict__ out,
           int na, int nb, int vec) {
  const int i = blockIdx.x * NT + threadIdx.x;
  if (vec) {
    const int a4 = na / 4;
    if (i >= (na + nb) / 4) return;
    reinterpret_cast<float4*>(out)[i] = i < a4 ? __ldg(reinterpret_cast<const float4*>(a) + i)
                                               : __ldg(reinterpret_cast<const float4*>(b) + i - a4);
  } else if (i < na + nb) {
    out[i] = i < na ? __ldg(a + i) : __ldg(b + i - na);
  }
}

// P6: out[r, j] = x[r, 2j] for x (c, n), out (c, (n + 1) / 2); ``vec`` (n a
// multiple of 4, pointers aligned): a thread reads 16 bytes and stores the
// 8 of its even lanes
__global__ void __launch_bounds__(NT)
stride2_kernel(const float* __restrict__ x, float* __restrict__ out, int c, int n, int vec) {
  const int i = blockIdx.x * NT + threadIdx.x;
  if (vec) {
    if (i >= c * n / 4) return;
    const float4 v = __ldg(reinterpret_cast<const float4*>(x) + i);
    reinterpret_cast<float2*>(out)[i] = make_float2(v.x, v.z);
  } else {
    const int no = (n + 1) / 2;
    if (i < c * no) out[i] = __ldg(x + (size_t)(i / no) * n + 2 * (i % no));
  }
}

inline bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

}  // namespace

// P1 (off = s = W, di0 = -1) and P2 (off = 0, s = 128, di0 = 0): x (c,
// n_in), out (c, n_out), f32.
extern "C" int bs_probe_dw9(const void* x, void* out, int c, int n_in, int n_out, int s,
                            int off, int di0, void* stream) {
  const long long total = (long long)c * n_out;
  if (total <= 0) return 0;
  dw9_kernel<<<blocks(total, NT), NT, 0, (cudaStream_t)stream>>>(
      (const float*)x, (float*)out, c, n_in, n_out, s, off, di0);
  return (int)cudaGetLastError();
}

// P3: w (16, 16), x (16, n), y (16, n), f32; mode 0 DEFAULT, 1 HIGH, 2 HIGHEST
extern "C" int bs_probe_dot(const void* w, const void* x, void* y, int n, int mode,
                            void* stream) {
  if (n <= 0) return 0;
  if (mode < 0 || mode > 2) return (int)cudaErrorInvalidValue;
  if (mode == 2)
    dot_f32_kernel<<<blocks(4LL * n, NT), NT, 0, (cudaStream_t)stream>>>(
        (const float*)w, (const float*)x, (float*)y, n);
  else
    dot_mma_kernel<<<blocks((n + 7) / 8, 4), 128, 0, (cudaStream_t)stream>>>(
        (const float*)w, (const float*)x, (float*)y, n, mode);
  return (int)cudaGetLastError();
}

// P4: x (c, n), w (c, c), out (c, n), f32, 1 <= c <= 32
extern "C" int bs_probe_se(const void* x, const void* w, void* out, int c, int n,
                           void* stream) {
  if (c < 1 || c > 32 || n < 1) return (int)cudaErrorInvalidValue;
  const int vec = n % 4 == 0 && aligned16(x) && aligned16(out);
  se_kernel<<<1, SE_NT, 0, (cudaStream_t)stream>>>((const float*)x, (const float*)w,
                                                   (float*)out, c, n, vec);
  return (int)cudaGetLastError();
}

// P5 (a, b -> out = [a; b]) and P7 (b = null, nb = 0: a plain copy); counts
// in floats
extern "C" int bs_probe_cat(const void* a, const void* b, void* out, int na, int nb,
                            void* stream) {
  if (na + nb <= 0) return 0;
  const int vec = na % 4 == 0 && nb % 4 == 0 && aligned16(a) && aligned16(out) &&
                  (nb == 0 || aligned16(b));
  const int n = vec ? (na + nb) / 4 : na + nb;
  cat_kernel<<<blocks(n, NT), NT, 0, (cudaStream_t)stream>>>(
      (const float*)a, (const float*)b, (float*)out, na, nb, vec);
  return (int)cudaGetLastError();
}

// P6: x (c, n) -> out (c, (n + 1) / 2), f32
extern "C" int bs_probe_stride2(const void* x, void* out, int c, int n, void* stream) {
  if (c <= 0 || n <= 0) return 0;
  const int vec = n % 4 == 0 && aligned16(x) && aligned16(out);
  const int m = vec ? c * n / 4 : c * ((n + 1) / 2);
  stride2_kernel<<<blocks(m, NT), NT, 0, (cudaStream_t)stream>>>(
      (const float*)x, (float*)out, c, n, vec);
  return (int)cudaGetLastError();
}
