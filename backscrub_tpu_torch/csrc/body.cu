// CNN body kernels for Hopper (sm_90a): one kernel per plan-op kind,
// launched in plan order by backscrub_tpu_torch/ops/megakernel.py:BodyPlan.
//
// Replaces the TPU kernel backscrub_tpu/ops/megakernel.py:BodyMega in its
// full-span mode (body_mega_for; plan interpreter _run_plan), which runs
// the whole segm body between the stem conv and the transpose-conv tail as
// one Pallas program with every intermediate in VMEM.  An H100 SM has
// 227 KB of shared memory and the body's largest intermediates do not fit
// one SM (the 72-channel expansion at 24x40 f32 is 276 KB), so here every
// op is its own launch, intermediates stay in device memory and, at a few
// MB per frame, in the 50 MB L2.  Tensors are (C, H*W) f32, row-major:
// a channel-offset slice is contiguous, so a CONCAT is its producers
// writing into one buffer at their channel offsets.
//
// Bound: launch latency.  A segm_lite frame is ~100 small ops (~30 MFLOP
// in all); each kernel is microseconds of work, comparable to its launch.
// Fusing the launches (a persistent kernel or a CUDA graph) is the next
// step; each kernel here is the simple, right form: one thread per output
// element, the 1x1 conv / FC dot product computed in the kernel's own loop
// (no cuBLAS), as the TPU kernel computes its own dots.
//
// The same kernels run the prefix mode (body_mega_prefix_for, K2'): the
// deeplab family's 129x129 and 65x65 stages at C <= 72, 12 launches a
// frame.  Its largest tensor (48x129x129 f32, 3.2 MB) does not fit an SM,
// but the whole 10 MB workspace stays in L2.  On an H100 80GB HBM3 at
// 700 W the span takes ~55 us of device time a frame: ~31 us in the seven
// 1x1 convs (0.046 GFLOP, ~1.5 TFLOP/s) and ~23 us in the four depthwise
// convs.  Neither bytes nor FLOPs bound it there: each thread's serial
// ci-long dot of dependent loads and FMAs sets the pace, with the frame's
// launches (host side) costing more than the device time.

#include <cuda_runtime.h>

#include "body_act.cuh"

namespace {

constexpr int THREADS = 256;

inline unsigned blocks_for(long long n) {
  return (unsigned)((n + THREADS - 1) / THREADS);
}

// y[o, l] = act(sum_k w[o, k] * x[k, l] + b[o]); FC is the L = 1 case
__global__ void conv1x1_kernel(const float* __restrict__ w,
                               const float* __restrict__ b,
                               const float* __restrict__ x,
                               float* __restrict__ y, int co, int ci, int L,
                               int act) {
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)co * L) return;
  int o = (int)(idx / L), l = (int)(idx % L);
  const float* wr = w + (long long)o * ci;
  float acc = 0.0f;
  for (int k = 0; k < ci; ++k) acc = fmaf(wr[k], x[(long long)k * L + l], acc);
  y[idx] = activate(acc + b[o], act);
}

// depthwise fh x fw, stride s, dilation d, SAME zero padding (plo_h,
// plo_w leading); w is (C, fh*fw) with tap t = ti*fw + tj
__global__ void dw_kernel(const float* __restrict__ x,
                          const float* __restrict__ w,
                          const float* __restrict__ b, float* __restrict__ y,
                          int C, int H, int W, int OH, int OW, int fh, int fw,
                          int s, int d, int plo_h, int plo_w, int act) {
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)C * OH * OW) return;
  int oj = (int)(idx % OW);
  int oi = (int)((idx / OW) % OH);
  int c = (int)(idx / ((long long)OW * OH));
  const float* xc = x + (long long)c * H * W;
  const float* wc = w + (long long)c * fh * fw;
  float acc = 0.0f;
  for (int tj = 0; tj < fw; ++tj) {
    int jj = oj * s + tj * d - plo_w;
    if (jj < 0 || jj >= W) continue;
    for (int ti = 0; ti < fh; ++ti) {
      int ii = oi * s + ti * d - plo_h;
      if (ii < 0 || ii >= H) continue;
      acc = fmaf(xc[(long long)ii * W + jj], wc[ti * fw + tj], acc);
    }
  }
  y[idx] = activate(acc + b[c], act);
}

// global average pool: one block per channel, y[c] = act(sum * inv)
__global__ void gpool_kernel(const float* __restrict__ x, float* __restrict__ y,
                             int L, float inv, int act) {
  __shared__ float part[THREADS];
  const float* xc = x + (long long)blockIdx.x * L;
  float s = 0.0f;
  for (int l = threadIdx.x; l < L; l += blockDim.x) s += xc[l];
  part[threadIdx.x] = s;
  __syncthreads();
  for (int k = blockDim.x / 2; k > 0; k >>= 1) {
    if (threadIdx.x < k) part[threadIdx.x] += part[threadIdx.x + k];
    __syncthreads();
  }
  if (threadIdx.x == 0) y[blockIdx.x] = activate(part[0] * inv, act);
}

// y = act(a op b); op 0: unary (b unused), 1: add, 2: mul.  b_vec: b is a
// (C, 1) vector broadcast over L (squeeze-excite gates)
__global__ void eltwise_kernel(const float* __restrict__ a,
                               const float* __restrict__ b,
                               float* __restrict__ y, int C, int L, int op,
                               int b_vec, int act) {
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)C * L) return;
  float v = a[idx];
  if (op) {
    float u = b_vec ? b[idx / L] : b[idx];
    v = op == 1 ? v + u : v * u;
  }
  y[idx] = activate(v, act);
}

// separable bilinear resize with two taps per axis (indices and weights
// from the host's resize_matrix; a missing tap has weight 0): columns
// first, then rows, as the TPU kernel sums
__global__ void resize_kernel(const float* __restrict__ x,
                              const int* __restrict__ ridx,
                              const float* __restrict__ rw,
                              const int* __restrict__ cidx,
                              const float* __restrict__ cw,
                              float* __restrict__ y, int C, int H, int W,
                              int OH, int OW) {
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)C * OH * OW) return;
  int oj = (int)(idx % OW);
  int oi = (int)((idx / OW) % OH);
  int c = (int)(idx / ((long long)OW * OH));
  const float* xc = x + (long long)c * H * W;
  int j0 = cidx[2 * oj], j1 = cidx[2 * oj + 1];
  float w0 = cw[2 * oj], w1 = cw[2 * oj + 1];
  float acc = 0.0f;
  for (int a = 0; a < 2; ++a) {
    const float* row = xc + (long long)ridx[2 * oi + a] * W;
    float colv = __fadd_rn(__fmul_rn(row[j0], w0), __fmul_rn(row[j1], w1));
    acc = __fadd_rn(acc, __fmul_rn(colv, rw[2 * oi + a]));
  }
  y[idx] = acc;
}

__global__ void copy_kernel(const float* __restrict__ src,
                            float* __restrict__ dst, long long n) {
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx < n) dst[idx] = src[idx];
}

}  // namespace

extern "C" {

int bs_conv1x1(const void* w, const void* b, const void* x, void* y, int co,
               int ci, int L, int act, void* stream) {
  conv1x1_kernel<<<blocks_for((long long)co * L), THREADS, 0,
                   (cudaStream_t)stream>>>((const float*)w, (const float*)b,
                                           (const float*)x, (float*)y, co, ci,
                                           L, act);
  return (int)cudaGetLastError();
}

int bs_dw(const void* x, const void* w, const void* b, void* y, int C, int H,
          int W, int OH, int OW, int fh, int fw, int s, int d, int plo_h,
          int plo_w, int act, void* stream) {
  dw_kernel<<<blocks_for((long long)C * OH * OW), THREADS, 0,
              (cudaStream_t)stream>>>((const float*)x, (const float*)w,
                                      (const float*)b, (float*)y, C, H, W, OH,
                                      OW, fh, fw, s, d, plo_h, plo_w, act);
  return (int)cudaGetLastError();
}

int bs_gpool(const void* x, void* y, int C, int L, float inv, int act,
             void* stream) {
  gpool_kernel<<<C, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)x, (float*)y, L, inv, act);
  return (int)cudaGetLastError();
}

int bs_eltwise(const void* a, const void* b, void* y, int C, int L, int op,
               int b_vec, int act, void* stream) {
  eltwise_kernel<<<blocks_for((long long)C * L), THREADS, 0,
                   (cudaStream_t)stream>>>((const float*)a, (const float*)b,
                                           (float*)y, C, L, op, b_vec, act);
  return (int)cudaGetLastError();
}

int bs_resize(const void* x, const void* ridx, const void* rw,
              const void* cidx, const void* cw, void* y, int C, int H, int W,
              int OH, int OW, void* stream) {
  resize_kernel<<<blocks_for((long long)C * OH * OW), THREADS, 0,
                  (cudaStream_t)stream>>>(
      (const float*)x, (const int*)ridx, (const float*)rw, (const int*)cidx,
      (const float*)cw, (float*)y, C, H, W, OH, OW);
  return (int)cudaGetLastError();
}

int bs_copy(const void* src, void* dst, int n, void* stream) {
  copy_kernel<<<blocks_for(n), THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)src, (float*)dst, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
