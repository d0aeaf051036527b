// K2, the segm body's full span, as one persistent launch for Hopper
// (sm_90a): bs_body_mega walks an op table that
// backscrub_tpu_torch/ops/megakernel.py:MegaTable compiles once per plan.
//
// Replaces the TPU kernel backscrub_tpu/ops/megakernel.py:BodyMega in its
// full-span mode (body_mega_for; plan interpreter _run_plan), which runs
// the body between the stem conv and the transpose-conv tail as one Pallas
// program with every intermediate in VMEM.  One SM cannot hold that span
// (the 72-channel expansion at 24x40 f32 is 276 KB), but the whole span is
// ~31 MFLOP over a 3.3 MB workspace, which sits in the 50 MB L2.  So here
// the CTAs of one launch walk the table together: the ops of a phase split
// their tiles over the CTAs, and a barrier separates dependent phases.
// Intermediates go through L2, read with ld.global.cg (L2, never the
// non-coherent or L1 path, since this very launch wrote them).
//
// The barrier: the launch is a cooperative grid of one CTA an SM, and
// cg::this_grid().sync() separates the phases.  It orders every write a
// thread made before it before every read after it by any thread of the
// grid (release/acquire at gpu scope: the arrival is a release atomic,
// the wait an acquire load, each behind a CTA barrier), which is what
// makes one phase's global writes visible to the next.  A thread-block
// cluster (cg::this_cluster().sync(), a hardware barrier with the same
// release/acquire at cluster scope) was the other candidate: its barrier
// costs less (bs_barrier_bench measures both), but 16 CTAs, the most a
// cluster may hold, left the span's phases short of SMs (PERF.md).
//
// The compiler (MegaTable) fuses what the JAX plan's op order allows, so
// only the summation order differs from the plain version: standalone
// activations run in their producer's epilogue, residual ADDs in the
// projection conv's epilogue, and a squeeze-excite block (global pool ->
// FC -> FC -> MUL gate) is split over the two phases around it: the
// depthwise op that produces the pooled tensor pools each channel in the
// CTA that computed it, and the conv that consumes the gated tensor
// computes both FCs in every CTA that has a tile (no barrier between them:
// the weights come into shared memory in one burst) and scales its input
// rows by the gate.  Every other plan op has a generic op code.
//
// Work in a phase: 1x1 convs as output tiles of 256 to 32 outputs, sized
// per op so that the phase's tiles spread over the SMs, with K split over
// the CTA's thread groups (W and X for up to 320 of K staged in shared
// memory by one burst of cp.async; f32 FFMA: the span is too small for the
// split tensor-core product to pay, and f32 keeps the meet family's
// HIGHEST class); depthwise convs as (channel, band of output rows) items with the
// band's input window, halo included, in shared memory; pooled-vector FCs
// and global pools one warp an output; elementwise, resize and copy one
// thread an element.  Every sum has a fixed order (xor-butterfly warp
// sums, fixed block trees), so two runs give the same bits.
//
// Bound: latency.  31 MFLOP and 1.6 MB of compulsory traffic are well
// under a microsecond of the card's f32 or HBM rate; what a run costs is
// the chain of 33 dependent phases, each an L2 round trip or two plus a
// grid barrier (~1.1 us).  So every phase puts all of its loads in flight
// at once (cp.async bursts) rather than in dependent chains.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "async_copy.cuh"
#include "body_act.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 256, NW = NT / 32;

// the op descriptor: DESC int32 fields, in the order of megakernel.py's
// MEGA_FIELDS
enum Field {
  F_CODE, F_SYNC, F_ACT, F_ACT2, F_IN, F_OUT, F_AUX, F_W, F_B,
  F_C, F_CO, F_H, F_WD, F_OH, F_OW, F_FH, F_FW, F_S, F_D, F_PH, F_PW, F_BAND,
  F_N, F_ELT, F_BVEC, F_GATE, F_RES, F_PACT, F_PINV, F_HID, F_W1, F_B1, F_ACT1,
  F_W2, F_B2, F_ACTG, F_POOL, F_POUT, F_TM, F_TN, F_CPI, DESC = 48
};
// op codes (megakernel.py:MEGA_CODES)
enum Code { OP_CONV = 1, OP_FC, OP_DW, OP_GPOOL, OP_ELT, OP_RESIZE, OP_COPY };
// the conv's K staged at once (up to CK) and the SE vectors' capacity
// (megakernel.py:_CONV_K, _SE_MAX_C)
constexpr int CK = 320, SE_MAX_C = 512;

struct Args {
  const float* x;     // the span input (offset -1)
  float* ws;          // the workspace
  const float* ar;    // the weight arena
};

// an operand offset: -1 is the span input, else a workspace float offset
__device__ __forceinline__ const float* operand(const Args& a, int off) {
  return off < 0 ? a.x : a.ws + off;
}

__device__ __forceinline__ float ld(const float* p) { return __ldcg(p); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// out[o] = act(sum_k wt[k, o] * in[k] + b[o]) for o < co: wt is W
// transposed (ci, co), staged in shared memory like in and out (a thread
// an output, conflict-free).  Fewer outputs than threads: the K range is
// cut into G groups whose partial sums (``part``, NT floats) add up in
// group order.
__device__ void fc_shared(const float* wt, const float* b, const float* in, float* out,
                          float* part, int ci, int co, int act) {
  const int G = co >= NT ? 1 : NT / co, kc = (ci + G - 1) / G;
  for (int t = threadIdx.x; t < (G == 1 ? co : G * co); t += NT) {
    const int g = t / co, o = t % co, k1 = min(ci, (g + 1) * kc);
    float s = 0.0f;
#pragma unroll 16
    for (int k = g * kc; k < k1; ++k) s = fmaf(wt[(size_t)k * co + o], in[k], s);
    if (G == 1)
      out[o] = activate(s + b[o], act);
    else
      part[t] = s;
  }
  __syncthreads();
  if (G > 1 && (int)threadIdx.x < co) {
    float s = 0.0f;
    for (int g = 0; g < G; ++g) s += part[g * co + threadIdx.x];
    out[threadIdx.x] = activate(s + b[threadIdx.x], act);
  }
  __syncthreads();
}

// the squeeze-excite gate of a conv's input channels into sg: the pooled
// vector (written by the depthwise op before) -> FC1 -> FC2.  Both FCs'
// transposed weights (contiguous in the arena, 16-byte aligned) land in
// ``sw`` by one burst of 16-byte cp.async, so the CTA waits for L2 once.
__device__ void se_gate(const Args& a, const int* d, float* sw, float* sg, float* sh,
                        float* part) {
  const int C = d[F_C], hid = d[F_HID], n4 = (C * hid + 3) / 4;
  const float* pooled = operand(a, d[F_POUT]);
  float* w1 = sw;
  float* w2 = sw + 4 * n4;
  for (int e = threadIdx.x; e < n4; e += NT) {
    cp_async16(w1 + 4 * e, a.ar + d[F_W1] + 4 * e, true);
    cp_async16(w2 + 4 * e, a.ar + d[F_W2] + 4 * e, true);
  }
  cp_async_commit();
  for (int c = threadIdx.x; c < C; c += NT) sg[c] = ld(pooled + c);
  cp_async_wait<0>();
  __syncthreads();
  fc_shared(w1, a.ar + d[F_B1], sg, sh, part, C, hid, d[F_ACT1]);
  fc_shared(w2, a.ar + d[F_B2], sh, sg, part, hid, C, d[F_ACTG]);
}

// y = act2(act(W x' + b) + r): x' = x, or x * gate by channel (the SE
// block); r the optional residual; W (co, ci), x (ci, L), y (co, L).  A
// CTA owns a TM x TN tile of outputs (F_TM, F_TN: 16x16, 8x16, 8x8 or
// 4x8, picked per op so the phase spreads over the SMs), one output a
// thread in each of G = NT / (TM * TN) thread groups that split K; the
// groups' sums add up in group order.  W and X for up to CK of K land in
// shared memory by one burst of cp.async.  The SE gate is computed first,
// once a CTA, its weights in the same shared memory.
__device__ void conv_op(const Args& a, const int* d, float* sm) {
  const int M = d[F_CO], K = d[F_C], L = d[F_N];
  const int TM = d[F_TM], TN = d[F_TN], T = TM * TN, G = NT / T;
  const int tn = (L + TN - 1) / TN, tiles = ((M + TM - 1) / TM) * tn;
  if ((int)blockIdx.x >= tiles) return;
  const int kcap = min(K, CK);
  const bool gate = d[F_GATE] != 0;
  float* sw = sm;                      // [kcap][TM + 1], W transposed
  float* sx = sw + kcap * (TM + 1);    // [kcap][TN]
  // the SE vectors after both the tile and the FC weights
  float* sg = sm + max(kcap * (TM + 1 + TN), gate ? 8 * ((K * d[F_HID] + 3) / 4) : 0);
  float* sh = sg + SE_MAX_C;           // FC1's output
  float* part = sh + SE_MAX_C;         // NT floats: FC and K-group partial sums
  if (gate) se_gate(a, d, sm, sg, sh, part);
  const float* x = operand(a, d[F_IN]);
  const float* w = a.ar + d[F_W];
  const float* b = a.ar + d[F_B];
  const float* r = d[F_RES] ? operand(a, d[F_AUX]) : nullptr;
  float* y = a.ws + d[F_OUT];
  const int act = d[F_ACT], act2 = d[F_ACT2];
  const int grp = threadIdx.x / T, mi = (threadIdx.x % T) / TN, ni = threadIdx.x % TN;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int m0 = (tile / tn) * TM, n0 = (tile % tn) * TN;
    float acc = 0.0f;
    for (int k0 = 0; k0 < K; k0 += CK) {
      const int kc = min(CK, K - k0);
      for (int e = threadIdx.x; e < TM * kc; e += NT) {
        int m = e / kc, k = e % kc;
        bool ok = m0 + m < M;
        cp_async4(sw + k * (TM + 1) + m, w + (ok ? (size_t)(m0 + m) * K + k0 + k : 0), ok);
      }
      for (int e = threadIdx.x; e < kc * TN; e += NT) {
        int k = e / TN, n = e % TN;
        bool ok = n0 + n < L;
        cp_async4(sx + k * TN + n, x + (ok ? (size_t)(k0 + k) * L + n0 + n : 0), ok);
      }
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      const int kq = (kc + G - 1) / G, ke = min(kc, (grp + 1) * kq);
#pragma unroll 4
      for (int k = grp * kq; k < ke; ++k) {
        float v = sx[k * TN + ni] * (gate ? sg[k0 + k] : 1.0f);
        acc = fmaf(sw[k * (TM + 1) + mi], v, acc);
      }
      __syncthreads();
    }
    if (G > 1) {
      part[threadIdx.x] = acc;
      __syncthreads();
      if ((int)threadIdx.x < T)
        for (int q = 1; q < G; ++q) acc += part[q * T + threadIdx.x];
    }
    const int m = m0 + mi, n = n0 + ni;
    if ((int)threadIdx.x < T && m < M && n < L) {
      float v = activate(acc + b[m], act);
      if (r != nullptr) v = activate(v + ld(r + (size_t)m * L + n), act2);
      y[(size_t)m * L + n] = v;
    }
  }
}

// a pooled-vector FC: y[o] = act(W x + b), one warp an output
__device__ void fc_op(const Args& a, const int* d) {
  const int ci = d[F_C], co = d[F_CO];
  const float* x = operand(a, d[F_IN]);
  const float* w = a.ar + d[F_W];
  const float* b = a.ar + d[F_B];
  float* y = a.ws + d[F_OUT];
  const int lane = threadIdx.x & 31;
  for (int o = blockIdx.x * NW + (threadIdx.x >> 5); o < co; o += gridDim.x * NW) {
    float s = 0.0f;
#pragma unroll 4
    for (int k = lane; k < ci; k += 32) s = fmaf(w[(size_t)o * ci + k], ld(x + k), s);
    s = warp_sum(s);
    if (lane == 0) y[o] = activate(s + b[o], d[F_ACT]);
  }
}

// global average pool: y[c] = act(sum_l x[c, l] * inv), one warp a channel
__device__ void gpool_op(const Args& a, const int* d) {
  const int C = d[F_C], L = d[F_N];
  const float* x = operand(a, d[F_IN]);
  float* y = a.ws + d[F_OUT];
  const float inv = __int_as_float(d[F_PINV]);
  const int lane = threadIdx.x & 31;
  for (int c = blockIdx.x * NW + (threadIdx.x >> 5); c < C; c += gridDim.x * NW) {
    float s = 0.0f;
#pragma unroll 4
    for (int l = lane; l < L; l += 32) s += ld(x + (size_t)c * L + l);
    s = warp_sum(s);
    if (lane == 0) y[c] = activate(s * inv, d[F_ACT]);
  }
}

// depthwise fh x fw, stride s, dilation dd, SAME zero padding: an item is
// (a group of F_CPI channels, a band of F_BAND output rows); the group's
// input windows, halo and zero rows for the padding included, land in
// shared memory by one burst of cp.async.  With F_POOL the band is the whole channel, and the CTA also writes each
// channel's global average (the SE block's pool: act(sum * inv), a
// fixed-order block sum)
__device__ void dw_op(const Args& a, const int* d, float* sm) {
  const int C = d[F_C], H = d[F_H], W = d[F_WD], OH = d[F_OH], OW = d[F_OW];
  const int fh = d[F_FH], fw = d[F_FW], s = d[F_S], dd = d[F_D];
  const int ph = d[F_PH], pw = d[F_PW], band = d[F_BAND], act = d[F_ACT], cpi = d[F_CPI];
  const int nb = (OH + band - 1) / band, R = (band - 1) * s + (fh - 1) * dd + 1;
  const int groups = (C + cpi - 1) / cpi, RW = R * W;
  const bool pool = d[F_POOL] != 0;
  const float* x = operand(a, d[F_IN]);
  const float* w = a.ar + d[F_W];
  const float* b = a.ar + d[F_B];
  float* y = a.ws + d[F_OUT];
  float* win = sm;                     // [cpi][RW]: the item's input windows
  float* red = win + cpi * RW;         // NT floats: the pool's block sum
  for (int item = blockIdx.x; item < groups * nb; item += gridDim.x) {
    const int c0 = (item / nb) * cpi, nc = min(cpi, C - c0);
    const int oh0 = (item % nb) * band, i0 = oh0 * s - ph;
    for (int e = threadIdx.x; e < nc * RW; e += NT) {
      int ci = e / RW, rr = e % RW, ii = i0 + rr / W;
      bool ok = ii >= 0 && ii < H;
      cp_async4(win + e, x + (ok ? ((size_t)(c0 + ci) * H + ii) * W + rr % W : 0), ok);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    for (int ci = 0; ci < nc; ++ci) {
      const int c = c0 + ci;
      const float* xs = win + ci * RW;
      const float* wc = w + (size_t)c * fh * fw;
      const float bias = b[c];
      float sum = 0.0f;
      for (int e = threadIdx.x; e < band * OW; e += NT) {
        int oi = oh0 + e / OW, oj = e % OW;
        if (oi >= OH) continue;
        float acc = 0.0f;
        for (int tj = 0; tj < fw; ++tj) {
          int jj = oj * s + tj * dd - pw;
          if (jj < 0 || jj >= W) continue;
          for (int ti = 0; ti < fh; ++ti)
            acc = fmaf(xs[((oi - oh0) * s + ti * dd) * W + jj], wc[ti * fw + tj], acc);
        }
        float v = activate(acc + bias, act);
        y[((size_t)c * OH + oi) * OW + oj] = v;
        sum += v;
      }
      if (pool) {
        red[threadIdx.x] = sum;
        __syncthreads();
        for (int k = NT / 2; k > 0; k >>= 1) {
          if ((int)threadIdx.x < k) red[threadIdx.x] += red[threadIdx.x + k];
          __syncthreads();
        }
        if (threadIdx.x == 0)
          a.ws[d[F_POUT] + c] = activate(red[0] * __int_as_float(d[F_PINV]), d[F_PACT]);
        __syncthreads();
      }
    }
    __syncthreads();
  }
}

// y = act(a op b) over (C, L): op 0 unary, 1 add, 2 mul (b a (C, 1)
// vector with bvec), 3 the broadcast of the (C, 1) vector a over L
__device__ void elt_op(const Args& a, const int* d) {
  const int C = d[F_C], L = d[F_N], op = d[F_ELT], bvec = d[F_BVEC], act = d[F_ACT];
  const float* x = operand(a, d[F_IN]);
  const float* u = op == 1 || op == 2 ? operand(a, d[F_AUX]) : nullptr;
  float* y = a.ws + d[F_OUT];
  const long long n = (long long)C * L;
  for (long long i = (long long)blockIdx.x * NT + threadIdx.x; i < n;
       i += (long long)gridDim.x * NT) {
    float v = ld(x + (op == 3 ? i / L : i));
    if (op == 1 || op == 2) {
      float o = ld(u + (bvec ? i / L : i));
      v = op == 1 ? v + o : v * o;
    }
    y[i] = activate(v, act);
  }
}

// separable 2-tap bilinear resize, columns then rows (csrc/body.cu's
// resize_kernel); the tap indices are stored in the arena as floats
__device__ void resize_op(const Args& a, const int* d) {
  const int C = d[F_C], H = d[F_H], W = d[F_WD], OH = d[F_OH], OW = d[F_OW];
  const float* x = operand(a, d[F_IN]);
  const float* ridx = a.ar + d[F_W];
  const float* rw = a.ar + d[F_B];
  const float* cidx = a.ar + d[F_W1];
  const float* cw = a.ar + d[F_W2];
  float* y = a.ws + d[F_OUT];
  const long long n = (long long)C * OH * OW;
  for (long long i = (long long)blockIdx.x * NT + threadIdx.x; i < n;
       i += (long long)gridDim.x * NT) {
    int oj = (int)(i % OW), oi = (int)((i / OW) % OH), c = (int)(i / ((long long)OW * OH));
    const float* xc = x + (size_t)c * H * W;
    int j0 = (int)cidx[2 * oj], j1 = (int)cidx[2 * oj + 1];
    float w0 = cw[2 * oj], w1 = cw[2 * oj + 1];
    float acc = 0.0f;
    for (int t = 0; t < 2; ++t) {
      const float* row = xc + (size_t)ridx[2 * oi + t] * W;
      float colv = __fadd_rn(__fmul_rn(ld(row + j0), w0), __fmul_rn(ld(row + j1), w1));
      acc = __fadd_rn(acc, __fmul_rn(colv, rw[2 * oi + t]));
    }
    y[i] = acc;
  }
}

__device__ void copy_op(const Args& a, const int* d) {
  const float* x = operand(a, d[F_IN]);
  float* y = a.ws + d[F_OUT];
  const long long n = d[F_N];
  for (long long i = (long long)blockIdx.x * NT + threadIdx.x; i < n;
       i += (long long)gridDim.x * NT)
    y[i] = ld(x + i);
}

// BARRIER: 0 = cooperative grid of one CTA an SM, grid.sync() (the phase
// barrier of bs_body_mega); 1 = one thread-block cluster, cluster.sync()
// (bs_barrier_bench only)
template <int BARRIER>
__device__ __forceinline__ void phase_barrier() {
  if constexpr (BARRIER == 0)
    cg::this_grid().sync();
  else
    cg::this_cluster().sync();
}

// the table is copied to shared memory once (n_ops * DESC int32 at the
// start of the dynamic shared memory, a multiple of 16 bytes); the ops'
// working memory follows it
__global__ void __launch_bounds__(NT)
body_mega_kernel(const float* x, float* ws, const float* arena, const int* table,
                 int n_ops) {
  extern __shared__ __align__(16) float smem[];
  int* tab = reinterpret_cast<int*>(smem);
  float* sm = smem + n_ops * DESC;
  const Args a{x, ws, arena};
  for (int e = threadIdx.x; e < n_ops * DESC / 4; e += NT)
    cp_async16(tab + 4 * e, table + 4 * e, true);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  for (int i = 0; i < n_ops; ++i) {
    const int* sd = tab + i * DESC;
    switch (sd[F_CODE]) {
      case OP_CONV: conv_op(a, sd, sm); break;
      case OP_FC: fc_op(a, sd); break;
      case OP_DW: dw_op(a, sd, sm); break;
      case OP_GPOOL: gpool_op(a, sd); break;
      case OP_ELT: elt_op(a, sd); break;
      case OP_RESIZE: resize_op(a, sd); break;
      case OP_COPY: copy_op(a, sd); break;
      default: break;
    }
    __syncthreads();   // the next op reuses the working memory
    if (sd[F_SYNC]) phase_barrier<0>();
  }
}

// ``iters`` barriers back to back: the cost of one phase boundary
template <int BARRIER>
__global__ void barrier_bench_kernel(int iters) {
  for (int i = 0; i < iters; ++i) phase_barrier<BARRIER>();
}

// launch ``kern`` on a cooperative grid of one CTA an SM, or as one
// cluster of ``cluster`` CTAs; refuse (return an error, launch nothing)
// where the card cannot make them co-resident
template <int BARRIER, typename... Args_>
int launch_resident(void (*kern)(Args_...), int cluster, int smem, cudaStream_t stream,
                    Args_... args) {
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       smem);
  if (e != cudaSuccess) return (int)e;
  if constexpr (BARRIER == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
    if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return (int)e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, NT, smem);
    if (e != cudaSuccess) return (int)e;
    if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
    void* argv[] = {(void*)&args...};
    e = cudaLaunchCooperativeKernel((const void*)kern, dim3(sms), dim3(NT), argv, smem, stream);
    return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
  } else {
    if (cluster > 8 &&
        (e = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1)) !=
            cudaSuccess)
      return (int)e;
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3(cluster);
    cfg.blockDim = dim3(NT);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int n = 0;
    if ((e = cudaOccupancyMaxActiveClusters(&n, kern, &cfg)) != cudaSuccess) return (int)e;
    if (n < 1) return (int)cudaErrorLaunchOutOfResources;
    e = cudaLaunchKernelEx(&cfg, kern, args...);
    return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
  }
}

}  // namespace

extern "C" {

// one run of the op table: ``n_ops`` descriptors of DESC int32 at
// ``table``, operands in ``ws`` (and ``x``), weights in ``arena``;
// ``smem`` dynamic shared bytes a CTA (MegaTable.smem_bytes)
int bs_body_mega(const void* x, void* ws, const void* arena, const void* table, int n_ops,
                 int smem, void* stream) {
  return launch_resident<0>(body_mega_kernel, 0, smem, (cudaStream_t)stream,
                            (const float*)x, (float*)ws, (const float*)arena,
                            (const int*)table, n_ops);
}

// ``iters`` phase barriers in one launch: barrier 0, a cooperative grid of
// one CTA an SM; 1, one cluster of ``cluster`` CTAs
int bs_barrier_bench(int iters, int barrier, int cluster, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (barrier == 0) return launch_resident<0>(barrier_bench_kernel<0>, 0, 0, s, iters);
  if (barrier == 1) return launch_resident<1>(barrier_bench_kernel<1>, cluster, 0, s, iters);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
