// The body spans, as one persistent launch each, for Hopper (sm_90a):
// bs_body_mega walks an op table that
// backscrub_tpu_torch/ops/megakernel.py:MegaTable compiles once per plan.
// It runs K2, the segm body's full span, and the deeplab body's two spans:
// K2', the prefix at 129x129 and 65x65, and K2'', the flat continuation at
// 33x33 (its 1x1 convs as gemm_wg.cuh's wgmma tile: the bf16x3 split, at
// "highest" the six-term split, in the bf16 mode one bf16 pass).
//
// Replaces the TPU kernel backscrub_tpu/ops/megakernel.py:BodyMega in its
// full-span mode (body_mega_for; plan interpreter _run_plan), its prefix
// mode (body_mega_prefix_for) and its flat mode (body_mega_continuation_for,
// the chain of dense-layout kernels), which run a span as Pallas programs
// with every intermediate in VMEM.  One SM cannot hold a span (the
// 72-channel expansion at 24x40 f32 is 276 KB; deeplab's 48x129x129 is 3.2
// MB), but each span's workspace (segm 3.3 MB, the prefix 10 MB, the
// continuation 38 MB) sits in the 50 MB L2.  So here the CTAs of one
// launch walk the table together: the ops of a phase split their tiles
// over the CTAs, and a barrier separates dependent phases.  Intermediates
// go through L2, read with ld.global.cg or cp.async.cg (L2, never the
// non-coherent path, since this very launch wrote them).
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
// Work in a phase: the flat continuation's spatial 1x1 convs as OP_GEMM
// tiles on the tensor cores, the tile per op so that the phase is one round
// over the SMs (wgmma tiles of 16-80 output channels by 64 positions, x by
// 16-byte cp.async.cg and the weights by bulk copy, gemm_wg.cuh: bf16x3,
// the reference's HIGH split; six terms, the TPU's HIGHEST, at "highest";
// one in the bf16 mode);
// the other 1x1 convs (segm's, the deeplab prefix's) as output tiles of 256
// to 32 outputs, sized per op so that the phase's tiles spread over the
// SMs, with K split over the CTA's thread groups (W and X for up to 320 of
// K staged in shared memory by one burst of cp.async; f32 FFMA, as the
// reference's f32 spans: these convs are too small for the split
// tensor-core product to pay); depthwise convs as (channel, band of output rows) items with the
// band's input window, halo included, in shared memory; pooled-vector FCs
// and global pools one warp an output; elementwise, resize and copy one
// thread an element.  Every sum has a fixed order (xor-butterfly warp
// sums, fixed block trees), so two runs give the same bits.
//
// The bf16 mode (BF16 = 1, the plan's dots "bf16"): every dot of the JAX
// plan (the 1x1 convs, the pooled-vector FCs, the SE block's two FCs) at
// the reference's DEFAULT precision, as its interpret mode computes it:
// both operands rounded to the nearest bf16, products summed in f32.  The
// weights come rounded in the arena (MegaTable); the kernel rounds the
// activation operand, once where it is staged in shared memory (conv_op,
// after the SE gate's multiply; convw_op) or as it is read (the FCs), and
// the GEMM runs its one-term tile.  Depthwise, pool, elementwise, resize
// and copy ops do not change.  The mode is the kernel's template
// parameter: the f32 instantiation (BF16 = 0) is the code without it.
//
// Bound: latency.  segm's 31 MFLOP and 1.6 MB of compulsory traffic are
// well under a microsecond of the card's f32 or HBM rate, deeplab's 1.4
// GFLOP (1.3 of it in the GEMMs, three bf16 passes) a few microseconds;
// what a run costs is the chain of dependent phases (33 segm; 11 and 43
// deeplab), each an L2 round trip or two plus a grid barrier (~1.1 us).
// So every phase puts all of its loads in flight at once (cp.async bursts,
// or the GEMM's ring) rather than in dependent chains.
//
// A stream batch (backscrub_tpu/ops/megakernel.py:BodyMega.__call__ flattens
// leading axes into grid=(n,)): one launch runs the table over N inputs,
// each image its own copy of the workspace (a per-image stride), sharing
// the table, the arena and the phase barriers, so a batch pays the chain
// of phases once, not once a frame.  A work item (a conv or GEMM tile, a
// column chunk, a depthwise (channels, band) item, an FC or pool output,
// an element) reads and writes one image's operands and computes exactly
// what it computes in a one-image launch, whichever CTA takes it and
// whenever its operands come in, so each image gets the bits of its own
// launch.  Tiles, bands and splits stay those of one image (MegaTable
// picks them from the per-image shapes), so at N = 1 a CTA takes at most
// one item of an op and at N = 8 about eight.  What a batch changes is how
// a CTA walks its items, and a batch of N > 1 runs an instantiation of its
// own (BATCH): its conv, column-wise, depthwise and GEMM ops give each CTA
// a run of consecutive items (cta_run); the conv and column-wise ops
// stage them into a ring of F_BUFS buffers (the next items' loads in
// flight while one computes) and the GEMM's ring runs on from one tile to
// the next; an SE conv computes its gates once an image, the FC weights
// staged once for all of the CTA's images.  A one-image launch keeps the
// walk of one item a CTA at a time (conv_op, convw_op, dw_op,
// gemm_wg_tiles): the ring there has nothing to overlap, and its larger
// code made each of those phases ~0.3 us slower (PERF.md).  body_batch.cu
// compiles the batch instantiations (BS_BODY_BATCH).  FC and pool ops
// take (image, output) items in turn; elementwise, resize and copy ops
// take the images in turn, each spread over the grid as one image is
// (which spares a 64-bit divide an element).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "async_copy.cuh"
#include "body_act.cuh"
#include "gemm_wg.cuh"
#include "launch.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 256, NW = NT / 32;

// the op descriptor: DESC int32 fields, in the order of megakernel.py's
// MEGA_FIELDS
enum Field {
  F_CODE, F_SYNC, F_ACT, F_ACT2, F_IN, F_OUT, F_AUX, F_W, F_B,
  F_C, F_CO, F_H, F_WD, F_OH, F_OW, F_FH, F_FW, F_S, F_D, F_PH, F_PW, F_BAND,
  F_N, F_ELT, F_BVEC, F_GATE, F_RES, F_PACT, F_PINV, F_HID, F_W1, F_B1, F_ACT1,
  F_W2, F_B2, F_ACTG, F_POOL, F_POUT, F_TM, F_TN, F_CPI, F_TILE, F_BN, F_BUFS, DESC = 48
};
// op codes (megakernel.py:MEGA_CODES)
enum Code { OP_CONV = 1, OP_FC, OP_DW, OP_GPOOL, OP_ELT, OP_RESIZE, OP_COPY, OP_GEMM, OP_CONVW };
// the conv's K staged at once (up to CK) and the SE vectors' capacity
// (megakernel.py:_CONV_K, _SE_MAX_C)
constexpr int CK = 320, SE_MAX_C = 512;

struct Args {
  const float* x;     // the span input (offset -1)
  float* ws;          // the workspace
  const float* ar;    // the weight arena
  int n;              // images in the batch
  long long xs, wss;  // floats between images: the input's, the workspace's

  // image ``i``'s operands
  __device__ __forceinline__ Args at(int i) const {
    return Args{x + i * xs, ws + i * wss, ar, 1, xs, wss};
  }
  // floats between two images' copies of the operand at ``off``
  __device__ __forceinline__ long long stride(int off) const { return off < 0 ? xs : wss; }
  // the image of work item ``it`` of a batch of ``per`` items an image
  // (no divide in a one-image launch)
  __device__ __forceinline__ int img(int it, int per) const { return n == 1 ? 0 : it / per; }
};

// A CTA's share of an op's ``total`` items (item j is work unit j mod
// units, a tile, a depthwise item or a column chunk, of image j / units):
// the run [b, e) of consecutive items, floor(total / grid) of them or one
// more, so that no CTA takes more items than the strided walk gave it (an
// op of at most one round: item blockIdx.x, with no divide).  Consecutive
// items are neighbouring tiles of one image, mostly of the same weight
// rows, which stay where they were staged, and the grid works on an image
// or two at a time (a tile-major order, each CTA on one tile of every
// image, kept all S workspaces in use at once and made the conv, GEMM and
// depthwise phases slower than the parent's: PERF.md §6).
struct Run {
  int b, e;
};
__device__ __forceinline__ Run cta_run(int total) {
  const int g = gridDim.x, c = blockIdx.x;
  if (total <= g) return Run{c, c < total ? c + 1 : c};
  const int q = total / g, r = total - q * g, b = c * q + min(c, r);
  return Run{b, b + q + (c < r ? 1 : 0)};
}

// an operand offset: -1 is the span input, else a workspace float offset
__device__ __forceinline__ const float* operand(const Args& a, int off) {
  return off < 0 ? a.x : a.ws + off;
}

__device__ __forceinline__ float ld(const float* p) { return __ldcg(p); }

// the bf16 mode's dot operand: v rounded to the nearest bf16 (ties to
// even), as f32; the f32 mode's: v
template <int BF16>
__device__ __forceinline__ float dot_in(float v) {
  if constexpr (BF16 != 0)
    return __bfloat162float(__float2bfloat16_rn(v));
  else
    return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// out[o] = act(sum_k wt[k, o] * in[k] + b[o]) for o < co: wt is W
// transposed (ci, co), staged in shared memory like in and out (a thread
// an output, conflict-free).  Fewer outputs than threads: the K range is
// cut into G groups whose partial sums (``part``, NT floats) add up in
// group order.  ``in`` enters the dot as dot_in<BF16>.
template <int BF16>
__device__ void fc_shared(const float* wt, const float* b, const float* in, float* out,
                          float* part, int ci, int co, int act) {
  const int G = co >= NT ? 1 : NT / co, kc = (ci + G - 1) / G;
  for (int t = threadIdx.x; t < (G == 1 ? co : G * co); t += NT) {
    const int g = t / co, o = t % co, k1 = min(ci, (g + 1) * kc);
    float s = 0.0f;
#pragma unroll 16
    for (int k = g * kc; k < k1; ++k) s = fmaf(wt[(size_t)k * co + o], dot_in<BF16>(in[k]), s);
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
template <int BF16>
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
  fc_shared<BF16>(w1, a.ar + d[F_B1], sg, sh, part, C, hid, d[F_ACT1]);
  fc_shared<BF16>(w2, a.ar + d[F_B2], sh, sg, part, hid, C, d[F_ACTG]);
}

// the squeeze-excite gates of a conv's input channels for ``cnt`` images
// from ``img0`` on (mod n), image img0 + k's into gates + k * SE_MAX_C:
// the pooled vector (written by the depthwise op before) -> FC1 -> FC2.
// Both FCs' transposed weights (contiguous in the arena, 16-byte aligned)
// land in ``sw`` by one burst of 16-byte cp.async for all the images, so
// the CTA waits for L2 once.
template <int BF16>
__device__ __forceinline__ void se_gates(const Args& a, const int* d, float* sw, float* gates,
                                         float* sh, float* part, int img0, int cnt) {
  const int C = d[F_C], hid = d[F_HID], n4 = (C * hid + 3) / 4;
  float* w1 = sw;
  float* w2 = sw + 4 * n4;
  for (int e = threadIdx.x; e < n4; e += NT) {
    cp_async16(w1 + 4 * e, a.ar + d[F_W1] + 4 * e, true);
    cp_async16(w2 + 4 * e, a.ar + d[F_W2] + 4 * e, true);
  }
  cp_async_commit();
  for (int k = 0, img = img0; k < cnt; ++k, img = img + 1 < a.n ? img + 1 : 0) {
    const float* pooled = operand(a.at(img), d[F_POUT]);
    for (int c = threadIdx.x; c < C; c += NT) gates[k * SE_MAX_C + c] = ld(pooled + c);
  }
  cp_async_wait<0>();
  __syncthreads();
  for (int k = 0; k < cnt; ++k) {
    float* sg = gates + k * SE_MAX_C;
    fc_shared<BF16>(w1, a.ar + d[F_B1], sg, sh, part, C, hid, d[F_ACT1]);
    fc_shared<BF16>(w2, a.ar + d[F_B2], sh, sg, part, hid, C, d[F_ACTG]);
  }
}

// y = act2(act(W x' + b) + r): x' = x, or x * gate by channel (the SE
// block); r the optional residual; W (co, ci), x (ci, L), y (co, L).  A
// CTA owns a TM x TN tile of outputs (F_TM, F_TN: 16x16, 8x16, 8x8 or
// 4x8, picked per op so the phase spreads over the SMs), one output a
// thread in each of G = NT / (TM * TN) thread groups that split K; the
// groups' sums add up in group order.  W and X for up to CK of K land in
// shared memory by one burst of cp.async.  The SE gate is computed first,
// once a CTA, its weights in the same shared memory.  BF16: the staged x,
// gated, is rounded in place once, before the sums read it.  A one-image
// launch's walk (conv_batch_op a batch's).
template <int BF16>
__device__ void conv_op(const Args& a, const int* d, float* sm) {
  const int M = d[F_CO], K = d[F_C], L = d[F_N];
  const int TM = d[F_TM], TN = d[F_TN], T = TM * TN, G = NT / T;
  const int tn = (L + TN - 1) / TN, tiles = ((M + TM - 1) / TM) * tn;
  if ((int)blockIdx.x >= a.n * tiles) return;
  const int kcap = min(K, CK);
  const bool gate = d[F_GATE] != 0;
  float* sw = sm;                      // [kcap][TM + 1], W transposed
  float* sx = sw + kcap * (TM + 1);    // [kcap][TN]
  // the SE vectors after both the tile and the FC weights
  float* sg = sm + max(kcap * (TM + 1 + TN), gate ? 8 * ((K * d[F_HID] + 3) / 4) : 0);
  float* sh = sg + SE_MAX_C;           // FC1's output
  float* part = sh + SE_MAX_C;         // NT floats: FC and K-group partial sums
  const float* w = a.ar + d[F_W];
  const float* b = a.ar + d[F_B];
  const int act = d[F_ACT], act2 = d[F_ACT2];
  const int grp = threadIdx.x / T, mi = (threadIdx.x % T) / TN, ni = threadIdx.x % TN;
  int gated = -1;                      // the image whose gate sg holds
  for (int it = blockIdx.x; it < a.n * tiles; it += gridDim.x) {
    const int img = a.img(it, tiles), tile = it - img * tiles;
    const Args ai = a.at(img);
    if (gate && img != gated) {
      __syncthreads();                 // the last tile's sums no longer read sg
      se_gate<BF16>(ai, d, sm, sg, sh, part);
      gated = img;
    }
    const float* x = operand(ai, d[F_IN]);
    const float* r = d[F_RES] ? operand(ai, d[F_AUX]) : nullptr;
    float* y = ai.ws + d[F_OUT];
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
      if constexpr (BF16 != 0) {
        for (int e = threadIdx.x; e < kc * TN; e += NT)
          sx[e] = dot_in<BF16>(sx[e] * (gate ? sg[k0 + e / TN] : 1.0f));
        __syncthreads();
      }
      const int kq = (kc + G - 1) / G, ke = min(kc, (grp + 1) * kq);
#pragma unroll 4
      for (int k = grp * kq; k < ke; ++k) {
        float v;
        if constexpr (BF16 != 0)
          v = sx[k * TN + ni];
        else
          v = sx[k * TN + ni] * (gate ? sg[k0 + k] : 1.0f);
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

// conv_op in the batch kernel: a work item is one of conv_op's tiles, its
// sums in conv_op's order.  A CTA takes a run of them (cta_run); a step is
// an item's chunk of up to CK of K: its W rows and x columns land in
// shared memory by cp.async, into one of two W buffers (kept while the
// CTA's next items use the same rows: the next tiles of the row) and a
// ring of F_BUFS x slots, the next steps' loads in flight while one
// computes (with F_BUFS 1, one buffer of each, loaded after the step
// before).  The SE gates are computed first, for the images of the CTA's
// next items (up to SE_GATES), their FC weights over the tile buffers.
// BF16: the staged x, gated, is rounded in place once, before the sums
// read it.
template <int BF16>
__device__ __forceinline__ void conv_batch_op(const Args& a, const int* d, float* sm) {
  constexpr int SE_GATES = 8;          // the gates a CTA holds at once (megakernel.py:_SE_GATES)
  const int M = d[F_CO], K = d[F_C], L = d[F_N];
  const int TM = d[F_TM], TN = d[F_TN], T = TM * TN, G = NT / T;
  const int tn = (L + TN - 1) / TN, tiles = ((M + TM - 1) / TM) * tn;
  const Run seq = cta_run(a.n * tiles);
  if (seq.b >= seq.e) return;
  const int kcap = min(K, CK), nk = (K + CK - 1) / CK, WF = kcap * (TM + 1), XF = kcap * TN;
  const int nb = d[F_BUFS], nw = min(nb, 2);
  const bool gate = d[F_GATE] != 0;
  float* sw = sm;                      // [nw][kcap][TM + 1], W transposed
  float* sx = sw + nw * WF;            // [nb][kcap][TN]
  // the gates after both the buffers and the FC weights
  float* gates = sm + max(nw * WF + nb * XF, gate ? 8 * ((K * d[F_HID] + 3) / 4) : 0);
  float* sh = gates + (gate ? SE_GATES * SE_MAX_C : 0);   // FC1's output
  float* part = sh + (gate ? SE_MAX_C : 0);   // NT floats: FC and K-group partial sums
  const float* w = a.ar + d[F_W];
  const float* b = a.ar + d[F_B];
  const int act = d[F_ACT], act2 = d[F_ACT2];
  const int grp = threadIdx.x / T, mi = (threadIdx.x % T) / TN, ni = threadIdx.x % TN;
  const int steps = (seq.e - seq.b) * nk, n = a.n;
  const float* x0 = operand(a, d[F_IN]);
  const long long xst = a.stride(d[F_IN]);
  int g0 = 0, gn = 0;                  // the gates held: images g0 .. g0 + gn - 1 (mod n)
  auto slot = [&](int img) {
    const int o = img - g0 + (img < g0 ? n : 0);
    return o < gn ? o : -1;
  };
  // the step being computed and the next one to load, advanced without a
  // divide: item j (tile mt, nt of image img), its K chunk k
  struct At {
    int j, img, mt, nt, k;
  } cs;
  {
    const int img = seq.b / tiles, tile = seq.b - img * tiles;
    cs = At{seq.b, img, tile / tn, tile % tn, 0};
  }
  const int mtiles = tiles / tn;
  auto next = [&](At& c) {
    if (++c.k < nk) return;
    c.k = 0;
    ++c.j;
    if (++c.nt < tn) return;
    c.nt = 0;
    if (++c.mt < mtiles) return;
    c.mt = 0;
    ++c.img;
  };
  At ci = cs;
  // a step's W rows (chunk k0, kc of row tile m0) and x columns (of tile
  // column n0) into shared memory by cp.async
  auto load_w = [&](float* dw, int m0, int k0, int kc) {
    for (int e = threadIdx.x; e < TM * kc; e += NT) {
      int m = e / kc, k = e % kc;
      bool ok = m0 + m < M;
      cp_async4(dw + k * (TM + 1) + m, w + (ok ? (size_t)(m0 + m) * K + k0 + k : 0), ok);
    }
  };
  auto load_x = [&](float* dx, const float* x, int n0, int k0, int kc) {
    for (int e = threadIdx.x; e < kc * TN; e += NT) {
      int k = e / TN, nn = e % TN;
      bool ok = n0 + nn < L;
      cp_async4(dx + k * TN + nn, x + (ok ? (size_t)(k0 + k) * L + n0 + nn : 0), ok);
    }
  };
  float acc = 0.0f;
  int h0 = -1, h1 = -1;                // the W chunk (row tile * nk + chunk) a W buffer holds
  int wl = 0, wsw = 0;                 // the W buffer of the last step issued, and the
                                       // first step on it (the steps before: the other)
  int issued = 0;                      // the last step whose loads went out (ci: the next)
  int xi = nb > 1 ? 1 : 0, xc = 0;     // the x slots of step issued + 1 and of step s
  // step 0: the gates of the first images, its W into buffer 0, its x into
  // slot 0
  if (gate) {
    g0 = cs.img;
    gn = min(SE_GATES, (seq.e - 1) / tiles - g0 + 1);
    se_gates<BF16>(a, d, sm, gates, sh, part, g0, gn);
  }
  load_w(sw, cs.mt * TM, 0, kcap);
  load_x(sx, x0 + cs.img * xst, cs.nt * TN, 0, kcap);
  cp_async_commit();
  h0 = cs.mt * nk;
  next(ci);
  for (int s = 0; s < steps; ++s, next(cs), xc = xc + 1 < nb ? xc + 1 : 0) {
    if (gate && issued < s && slot(cs.img) < 0) {   // nothing in flight: the next images' gates
      __syncthreads();                 // the last tile's sums no longer read part
      g0 = cs.img;
      gn = min(SE_GATES, (seq.e - 1) / tiles - g0 + 1);
      se_gates<BF16>(a, d, sm, gates, sh, part, g0, gn);
      h0 = h1 = -1;
    }
    // the loads of steps s .. s + nb - 1 not yet out, each one cp.async
    // group: x into slot t mod nb; W into the last step's buffer where it
    // holds t's chunk, else into the other, where no step from s on reads
    // it (else t and the steps after it wait); a step whose gate is not
    // held waits too
    for (int t = issued + 1; t < min(steps, s + nb); ++t) {
      if (t > s && gate && slot(ci.img) < 0) break;
      const int k0 = ci.k * CK, kc = min(CK, K - k0), id = ci.mt * nk + ci.k;
      if ((wl == 0 ? h0 : h1) != id) {
        if (t > s && wsw > s) break;
        wl = nw - 1 - wl;
        wsw = t;
        if ((wl == 0 ? h0 : h1) != id) {
          load_w(sw + wl * WF, ci.mt * TM, k0, kc);
          if (wl == 0)
            h0 = id;
          else
            h1 = id;
        }
      }
      load_x(sx + xi * XF, x0 + ci.img * xst, ci.nt * TN, k0, kc);
      cp_async_commit();
      issued = t;
      next(ci);
      xi = xi + 1 < nb ? xi + 1 : 0;
    }
    if (issued == s)
      cp_async_wait<0>();
    else
      cp_async_wait_n(issued - s);
    __syncthreads();
    const int k0 = cs.k * CK, kc = min(CK, K - k0);
    const float* sg = gates + (gate ? slot(cs.img) : 0) * SE_MAX_C;
    const float* cw = sw + (s >= wsw ? wl : nw - 1 - wl) * WF;
    float* cx = sx + xc * XF;
    if constexpr (BF16 != 0) {
      for (int e = threadIdx.x; e < kc * TN; e += NT)
        cx[e] = dot_in<BF16>(cx[e] * (gate ? sg[k0 + e / TN] : 1.0f));
      __syncthreads();
    }
    const int kq = (kc + G - 1) / G, ke = min(kc, (grp + 1) * kq);
#pragma unroll 4
    for (int k = grp * kq; k < ke; ++k) {
      float v;
      if constexpr (BF16 != 0)
        v = cx[k * TN + ni];
      else
        v = cx[k * TN + ni] * (gate ? sg[k0 + k] : 1.0f);
      acc = fmaf(cw[k * (TM + 1) + mi], v, acc);
    }
    __syncthreads();
    if (cs.k != nk - 1) continue;
    if (G > 1) {
      part[threadIdx.x] = acc;
      __syncthreads();
      if ((int)threadIdx.x < T)
        for (int q = 1; q < G; ++q) acc += part[q * T + threadIdx.x];
    }
    const Args ai = a.at(cs.img);
    const float* r = d[F_RES] ? operand(ai, d[F_AUX]) : nullptr;
    float* y = ai.ws + d[F_OUT];
    const int m = cs.mt * TM + mi, nn = cs.nt * TN + ni;
    if ((int)threadIdx.x < T && m < M && nn < L) {
      float v = activate(acc + b[m], act);
      if (r != nullptr) v = activate(v + ld(r + (size_t)m * L + nn), act2);
      y[(size_t)m * L + nn] = v;
    }
    acc = 0.0f;
  }
}

// y = act2(act(W x + b) + r) over a wide span (at least a warp of columns
// a CTA: the deeplab prefix at 129x129 and 65x65, where conv_op's tiles
// would take many rounds): a CTA takes F_TN consecutive columns at a time,
// stages W (co, ci) and those columns of x in shared memory by one burst of
// cp.async, and computes all of their outputs, a thread a (column, every
// G-th row) with G = NT / columns; each output's K sum in order, f32 FFMA
// (BF16: the staged columns rounded in place first).  A one-image launch's
// walk (convw_batch_op a batch's).
template <int BF16>
__device__ void convw_op(const Args& a, const int* d, float* sm) {
  const int M = d[F_CO], K = d[F_C], L = d[F_N], cols = d[F_TN];
  const int chunks = (L + cols - 1) / cols;
  const float* w = a.ar + d[F_W];
  const float* b = a.ar + d[F_B];
  const int act = d[F_ACT], act2 = d[F_ACT2];
  float* sw = sm;                      // [M][K]
  float* sx = sw + M * K;              // [K][cols]
  for (int e = threadIdx.x; e < M * K; e += NT) cp_async4(sw + e, w + e, true);
  for (int it = blockIdx.x; it < a.n * chunks; it += gridDim.x) {
    const int img = a.img(it, chunks), n0 = (it - img * chunks) * cols;
    const Args ai = a.at(img);
    const float* x = operand(ai, d[F_IN]);
    const float* r = d[F_RES] ? operand(ai, d[F_AUX]) : nullptr;
    float* y = ai.ws + d[F_OUT];
    const int nc = min(cols, L - n0), G = max(1, NT / nc);
    for (int e = threadIdx.x; e < K * nc; e += NT) {
      int k = e / nc, n = e % nc;
      cp_async4(sx + k * cols + n, x + (size_t)k * L + n0 + n, true);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    if constexpr (BF16 != 0) {
      for (int e = threadIdx.x; e < K * nc; e += NT) {
        float* v = sx + (e / nc) * cols + e % nc;
        *v = dot_in<BF16>(*v);
      }
      __syncthreads();
    }
    if ((int)threadIdx.x < G * nc) {
      const int n = threadIdx.x % nc;
      for (int m = threadIdx.x / nc; m < M; m += G) {
        float acc = 0.0f;
#pragma unroll 4
        for (int k = 0; k < K; ++k) acc = fmaf(sw[m * K + k], sx[k * cols + n], acc);
        float v = activate(acc + b[m], act);
        if (r != nullptr) v = activate(v + ld(r + (size_t)m * L + n0 + n), act2);
        y[(size_t)m * L + n0 + n] = v;
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();
}

// convw_op in the batch kernel: a work item is F_TN consecutive columns
// of one image, computed as convw_op computes them.  A CTA takes a run of
// them (cta_run); W lands in shared memory once an op, each item's
// columns in one of F_BUFS buffers by cp.async, the next items' in flight
// while one computes
template <int BF16>
__device__ __forceinline__ void convw_batch_op(const Args& a, const int* d, float* sm) {
  const int M = d[F_CO], K = d[F_C], L = d[F_N], cols = d[F_TN];
  const int chunks = (L + cols - 1) / cols;
  const Run seq = cta_run(a.n * chunks);
  if (seq.b >= seq.e) return;
  const float* w = a.ar + d[F_W];
  const float* b = a.ar + d[F_B];
  const int act = d[F_ACT], act2 = d[F_ACT2];
  const int nb = d[F_BUFS];
  float* sw = sm;                      // [M][K]
  float* sx = sw + M * K;              // [nb][K][cols]
  for (int e = threadIdx.x; e < M * K; e += NT) cp_async4(sw + e, w + e, true);
  const float* x0 = operand(a, d[F_IN]);
  const long long xst = a.stride(d[F_IN]);
  // the item being computed and the next one to load, advanced without a
  // divide: image img, column chunk c
  struct At {
    int img, c;
  } cs{seq.b / chunks, seq.b % chunks};
  auto next = [&](At& at) {
    if (++at.c < chunks) return;
    at.c = 0;
    ++at.img;
  };
  At ci = cs;
  // item ``at``'s columns into ``dx`` ([K][cols]), as one cp.async group
  auto load = [&](const At& at, float* dx) {
    const int n0 = at.c * cols, nc = min(cols, L - n0);
    const float* x = x0 + at.img * xst;
    for (int e = threadIdx.x; e < K * nc; e += NT) {
      int k = e / nc, n = e % nc;
      cp_async4(dx + k * cols + n, x + (size_t)k * L + n0 + n, true);
    }
    cp_async_commit();
  };
  load(cs, sx);                        // the first item into slot 0, with W
  next(ci);
  int issued = seq.b;                  // the last item whose loads went out (ci: the next)
  int xi = nb > 1 ? 1 : 0, xc = 0;     // the slots of item issued + 1 and of item j
  for (int j = seq.b; j < seq.e; ++j, next(cs), xc = xc + 1 < nb ? xc + 1 : 0) {
    // items up to j + nb - 1 into slots (t - seq.b) mod nb
    for (int t = issued + 1; t < min(seq.e, j + nb);
         ++t, next(ci), xi = xi + 1 < nb ? xi + 1 : 0) {
      load(ci, sx + xi * K * cols);
      issued = t;
    }
    if (issued == j)
      cp_async_wait<0>();
    else
      cp_async_wait_n(issued - j);
    __syncthreads();
    const Args ai = a.at(cs.img);
    const int n0 = cs.c * cols;
    const float* r = d[F_RES] ? operand(ai, d[F_AUX]) : nullptr;
    float* y = ai.ws + d[F_OUT];
    float* cx = sx + xc * K * cols;
    const int nc = min(cols, L - n0), G = max(1, NT / nc);
    if constexpr (BF16 != 0) {
      for (int e = threadIdx.x; e < K * nc; e += NT) {
        float* v = cx + (e / nc) * cols + e % nc;
        *v = dot_in<BF16>(*v);
      }
      __syncthreads();
    }
    if ((int)threadIdx.x < G * nc) {
      const int n = threadIdx.x % nc;
      for (int m = threadIdx.x / nc; m < M; m += G) {
        float acc = 0.0f;
#pragma unroll 4
        for (int k = 0; k < K; ++k) acc = fmaf(sw[m * K + k], cx[k * cols + n], acc);
        float v = activate(acc + b[m], act);
        if (r != nullptr) v = activate(v + ld(r + (size_t)m * L + n0 + n), act2);
        y[(size_t)m * L + n0 + n] = v;
      }
    }
    __syncthreads();
  }
}

// the flat continuation's spatial 1x1 conv on the tensor cores: y =
// act2(act(W x + b) + r) with x (ci, L) from the workspace and r the
// optional residual, on gemm_wg.cuh's wgmma tile at TERMS 1 (the bf16
// mode), 3 (the bf16x3 split) or 6 (the six-term split of "highest"): F_W
// holds W's pieces (hi; hi, lo; hi, lo, lo2) laid out for it
// (megakernel.py:lay_wgmma), F_TILE its width (megakernel.py:_WG_TILES).
// The CTA's 256 threads run one tile at a time, the tiles of the op spread
// over the grid (a one-image launch; gemm_wg_batch a batch's).
template <int BN, int TERMS>
__device__ void gemm_wg_tiles(const Args& a, const int* d, unsigned char* sm) {
  using T = gemm_wg::Tile<BN, TERMS>;
  static_assert(gemm_wg::NT == NT, "a table GEMM tile takes the whole CTA");
  const int M = d[F_CO], K = d[F_C], N = d[F_N], nks = (K + gemm_wg::BK - 1) / gemm_wg::BK;
  const int tn = (N + gemm_wg::BM - 1) / gemm_wg::BM, tiles = ((M + BN - 1) / BN) * tn;
  const auto* w = reinterpret_cast<const __nv_bfloat16*>(a.ar + d[F_W]);
  for (int it = blockIdx.x; it < a.n * tiles; it += gridDim.x) {
    const int img = a.img(it, tiles), tile = it - img * tiles;
    const Args ai = a.at(img);
    const gemm_wg::Epilogue ep{ai.ar + d[F_B], d[F_ACT],
                               d[F_RES] ? operand(ai, d[F_AUX]) : nullptr, d[F_ACT2],
                               ai.ws + d[F_OUT], nullptr};
    T::run(sm, w, operand(ai, d[F_IN]), M, N, nks, tile / tn, (tile % tn) * gemm_wg::BM, 0,
           nks, K, ep);
    __syncthreads();   // the next tile refills the ring
  }
}

// gemm_wg_tiles in the batch kernel: the CTA's 256 threads run its run of
// tiles (cta_run) through one ring (Tile::run_seq): a tile's first slices
// load under the last products and the epilogue of the tile before.
template <int BN, int TERMS>
__device__ __forceinline__ void gemm_wg_batch(const Args& a, const int* d, unsigned char* sm) {
  using T = gemm_wg::Tile<BN, TERMS>;
  static_assert(gemm_wg::NT == NT, "a table GEMM tile takes the whole CTA");
  const int M = d[F_CO], K = d[F_C], N = d[F_N];
  const int tn = (N + gemm_wg::BM - 1) / gemm_wg::BM, tiles = ((M + BN - 1) / BN) * tn;
  const Run seq = cta_run(a.n * tiles);
  if (seq.b >= seq.e) return;
  const auto* w = reinterpret_cast<const __nv_bfloat16*>(a.ar + d[F_W]);
  // the tiles from item seq.b on, advanced without a divide: column tile
  // nt of row tile ct of image img
  struct At {
    const float *x0, *r0, *b;
    float* y0;
    long long xs, rs, ws;
    int tn, cts, act, act2, img, nt, ct;
    __device__ const float* x() const { return x0 + img * xs; }
    __device__ int n0() const { return nt * gemm_wg::BM; }
    __device__ gemm_wg::Epilogue ep() const {
      return gemm_wg::Epilogue{b, act, r0 == nullptr ? nullptr : r0 + img * rs, act2,
                               y0 + img * ws, nullptr};
    }
    __device__ void next() {
      if (++nt < tn) return;
      nt = 0;
      if (++ct < cts) return;
      ct = 0;
      ++img;
    }
  };
  const int img = seq.b / tiles, u = seq.b - img * tiles;
  const At first{operand(a, d[F_IN]), d[F_RES] ? operand(a, d[F_AUX]) : nullptr,
                 a.ar + d[F_B], a.ws + d[F_OUT], a.stride(d[F_IN]),
                 a.stride(d[F_AUX]), a.wss, tn, tiles / tn, d[F_ACT], d[F_ACT2],
                 img, u % tn, u / tn};
  T::run_seq(sm, w, M, N, K, seq.e - seq.b, first);
}

template <int BN, int TERMS, bool BATCH>
__device__ __forceinline__ void gemm_walk(const Args& a, const int* d, unsigned char* s) {
  if constexpr (BATCH)
    gemm_wg_batch<BN, TERMS>(a, d, s);
  else
    gemm_wg_tiles<BN, TERMS>(a, d, s);
}

// the GEMM op at its tile width; BATCH: the batch kernel's walk
template <int TERMS, bool BATCH>
__device__ void gemm_op(const Args& a, const int* d, float* sm) {
  unsigned char* s = reinterpret_cast<unsigned char*>(sm);
  switch (d[F_TILE]) {
    case 0: gemm_walk<16, TERMS, BATCH>(a, d, s); break;
    case 1: gemm_walk<32, TERMS, BATCH>(a, d, s); break;
    case 2: gemm_walk<48, TERMS, BATCH>(a, d, s); break;
    case 3: gemm_walk<64, TERMS, BATCH>(a, d, s); break;
    case 4: gemm_walk<80, TERMS, BATCH>(a, d, s); break;
    default: break;
  }
}

// a pooled-vector FC: y[o] = act(W x + b), one warp an output; with F_BN
// (the 1 -> N broadcast that follows it) the warp writes y[o] across N
// columns, y[o * N + l]; x enters the dot as dot_in<BF16>
template <int BF16>
__device__ void fc_op(const Args& a, const int* d) {
  const int ci = d[F_C], co = d[F_CO], bn = d[F_BN];
  const float* w = a.ar + d[F_W];
  const float* b = a.ar + d[F_B];
  const int lane = threadIdx.x & 31;
  for (int it = blockIdx.x * NW + (threadIdx.x >> 5); it < a.n * co; it += gridDim.x * NW) {
    const int img = a.img(it, co), o = it - img * co;
    const Args ai = a.at(img);
    const float* x = operand(ai, d[F_IN]);
    float* y = ai.ws + d[F_OUT];
    float s = 0.0f;
#pragma unroll 4
    for (int k = lane; k < ci; k += 32) s = fmaf(w[(size_t)o * ci + k], dot_in<BF16>(ld(x + k)), s);
    s = warp_sum(s);
    const float v = activate(s + b[o], d[F_ACT]);
    if (bn == 0) {
      if (lane == 0) y[o] = v;
    } else {
      for (int l = lane; l < bn; l += 32) y[(size_t)o * bn + l] = v;
    }
  }
}

// global average pool: y[c] = act(sum_l x[c, l] * inv), one warp a channel
__device__ void gpool_op(const Args& a, const int* d) {
  const int C = d[F_C], L = d[F_N];
  const float inv = __int_as_float(d[F_PINV]);
  const int lane = threadIdx.x & 31;
  for (int it = blockIdx.x * NW + (threadIdx.x >> 5); it < a.n * C; it += gridDim.x * NW) {
    const int img = a.img(it, C), c = it - img * C;
    const Args ai = a.at(img);
    const float* x = operand(ai, d[F_IN]);
    float* y = ai.ws + d[F_OUT];
    float s = 0.0f;
#pragma unroll 4
    for (int l = lane; l < L; l += 32) s += ld(x + (size_t)c * L + l);
    s = warp_sum(s);
    if (lane == 0) y[c] = activate(s * inv, d[F_ACT]);
  }
}

// one depthwise output before bias and activation: the taps of column
// tj, then of tj + 1, each column's taps top to bottom; ``xs`` the window
// row of the output's first tap row, ``jj0`` its first tap column
__device__ __forceinline__ float dw_taps(const float* xs, const float* wc, int W, int fh, int fw,
                                         int dd, int jj0) {
  float acc = 0.0f;
  for (int tj = 0; tj < fw; ++tj) {
    int jj = jj0 + tj * dd;
    if (jj < 0 || jj >= W) continue;
    for (int ti = 0; ti < fh; ++ti) acc = fmaf(xs[ti * dd * W + jj], wc[ti * fw + tj], acc);
  }
  return acc;
}

// the depthwise outputs of channel c at column oj down ``nrow`` rows of a
// band (window ``xs``): the FH x FW weights in registers, each output's
// taps in dw_taps' order
template <int FH, int FW>
__device__ __forceinline__ void dw_column(const float* xs, const float* wc, float bias, float* yc,
                                          int W, int OW, int s, int dd, int jj0, int nrow,
                                          int act) {
  float wr[FH * FW];
  bool ok[FW];
#pragma unroll
  for (int t = 0; t < FH * FW; ++t) wr[t] = wc[t];
#pragma unroll
  for (int tj = 0; tj < FW; ++tj) ok[tj] = jj0 + tj * dd >= 0 && jj0 + tj * dd < W;
  for (int i = 0; i < nrow; ++i) {
    const float* xr = xs + i * s * W + jj0;
    float acc = 0.0f;
#pragma unroll
    for (int tj = 0; tj < FW; ++tj) {
      if (!ok[tj]) continue;
#pragma unroll
      for (int ti = 0; ti < FH; ++ti) acc = fmaf(xr[ti * dd * W + tj * dd], wr[ti * FW + tj], acc);
    }
    yc[(size_t)i * OW] = activate(acc + bias, act);
  }
}

// A depthwise window: input rows i0 .. i0 + R - 1 of channel c.  The rows
// inside the input are one run of ``count`` floats from ``src``, at window
// position ``p0``; the window starts ``o`` floats into its shared-memory
// slot, so that the run's 16-byte-aligned start (``sh`` floats before it)
// lands 16-byte aligned.
struct DwRun {
  const float* src;
  int p0, count, sh, o;
};

__device__ __forceinline__ DwRun dw_run(const float* x, int c, int i0, int R, int H, int W) {
  const int lo = max(i0, 0), hi = min(i0 + R, H);
  DwRun r;
  r.src = x + ((size_t)c * H + lo) * W;
  r.p0 = (lo - i0) * W;
  r.count = (hi - lo) * W;
  r.sh = (int)(((uintptr_t)r.src >> 2) & 3);
  r.o = (r.sh - r.p0) & 3;
  return r;
}

// depthwise fh x fw, stride s, dilation dd, SAME zero padding: an item is
// (a group of F_CPI channels, a band of F_BAND output rows); the group's
// input windows (slots of RWP floats), halo and zero rows for the padding
// included, land in shared memory by one burst of 16-byte cp.async (the
// run's first chunk float by float where floats before it would land in
// the padding), and the item's (channel, output
// column) pairs spread over the CTA's threads, each down the band's rows
// (3x3 and 5x5 with the weights in registers).  With F_POOL the band
// is the whole channel and the channels go one at a time: the CTA also
// writes each channel's global average (the SE block's pool: act(sum *
// inv), a fixed-order block sum).  A one-image launch (BATCH 0) spreads the
// items over the grid, a batch's gives each CTA a run of them (cta_run);
// a second window buffer, the next item's loads in flight, was no faster
// (PERF.md §6).
template <bool BATCH>
__device__ void dw_op(const Args& a, const int* d, float* sm) {
  const int C = d[F_C], H = d[F_H], W = d[F_WD], OH = d[F_OH], OW = d[F_OW];
  const int fh = d[F_FH], fw = d[F_FW], s = d[F_S], dd = d[F_D];
  const int ph = d[F_PH], pw = d[F_PW], band = d[F_BAND], act = d[F_ACT], cpi = d[F_CPI];
  const int nb = (OH + band - 1) / band, R = (band - 1) * s + (fh - 1) * dd + 1;
  const int groups = (C + cpi - 1) / cpi, RW = R * W, RWP = ((RW + 3) & ~3) + 8;
  const int NCH = RW / 4 + 2;          // 16-byte chunks of a run, at most
  const bool pool = d[F_POOL] != 0;
  const float* w = a.ar + d[F_W];
  const float* b = a.ar + d[F_B];
  float* win = sm;                     // [cpi][RWP]: the item's input windows
  float* red = win + cpi * RWP;        // NT floats: the pool's block sum
  Run seq{(int)blockIdx.x, a.n * groups * nb};
  if constexpr (BATCH) seq = cta_run(a.n * groups * nb);
  for (int it = seq.b; it < seq.e; it += BATCH ? 1 : gridDim.x) {
    const int img = a.img(it, groups * nb), item = it - img * (groups * nb);
    const Args ai = a.at(img);
    const float* x = operand(ai, d[F_IN]);
    float* y = ai.ws + d[F_OUT];
    const int c0 = (item / nb) * cpi, nc = min(cpi, C - c0);
    const int oh0 = (item % nb) * band, i0 = oh0 * s - ph;
    for (int e = threadIdx.x; e < nc * NCH; e += NT) {
      const int ci = e / NCH, k = e - ci * NCH;
      const DwRun run = dw_run(x, c0 + ci, i0, R, H, W);
      float* xs = win + ci * RWP + run.o;
      const int left = run.sh + run.count - 4 * k;     // floats of the run from the chunk on
      if (left <= 0) continue;
      float* dst = xs + run.p0 - run.sh + 4 * k;
      const float* src = run.src - run.sh + 4 * k;
      if (k == 0 && run.sh > 0 && run.p0 > 0) {
        for (int f = 0; f < 4; ++f) cp_async4(dst + f, f >= run.sh ? src + f : x, f >= run.sh);
      } else {
        cp_async16n(dst, src, 4 * min(4, left));
      }
    }
    for (int ci = 0; ci < nc; ++ci) {       // the padding rows (top and bottom bands): zeros
      const DwRun run = dw_run(x, c0 + ci, i0, R, H, W);
      const int below = RW - run.p0 - run.count;
      for (int f = threadIdx.x; f < run.p0 + below; f += NT)
        win[ci * RWP + run.o + (f < run.p0 ? f : run.count + f)] = 0.0f;
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    const int nrow = min(band, OH - oh0);
    for (int e = threadIdx.x; !pool && e < nc * OW; e += NT) {
      const int ci = e / OW, oj = e % OW, c = c0 + ci, jj0 = oj * s - pw;
      const float* xs = win + ci * RWP + dw_run(x, c, i0, R, H, W).o;
      const float* wc = w + (size_t)c * fh * fw;
      float* yc = y + ((size_t)c * OH + oh0) * OW + oj;
      if (fh == 3 && fw == 3) {
        dw_column<3, 3>(xs, wc, b[c], yc, W, OW, s, dd, jj0, nrow, act);
      } else if (fh == 5 && fw == 5) {
        dw_column<5, 5>(xs, wc, b[c], yc, W, OW, s, dd, jj0, nrow, act);
      } else {
        for (int i = 0; i < nrow; ++i)
          yc[(size_t)i * OW] = activate(dw_taps(xs + i * s * W, wc, W, fh, fw, dd, jj0) + b[c],
                                        act);
      }
    }
    for (int ci = 0; pool && ci < nc; ++ci) {
      const int c = c0 + ci;
      const float* xs = win + ci * RWP + dw_run(x, c, i0, R, H, W).o;
      const float* wc = w + (size_t)c * fh * fw;
      const float bias = b[c];
      float sum = 0.0f;
      for (int e = threadIdx.x; e < band * OW; e += NT) {
        int oi = oh0 + e / OW, oj = e % OW;
        if (oi >= OH) continue;
        float acc = dw_taps(xs + (oi - oh0) * s * W, wc, W, fh, fw, dd, oj * s - pw);
        float v = activate(acc + bias, act);
        y[((size_t)c * OH + oi) * OW + oj] = v;
        sum += v;
      }
      red[threadIdx.x] = sum;
      __syncthreads();
      for (int k = NT / 2; k > 0; k >>= 1) {
        if ((int)threadIdx.x < k) red[threadIdx.x] += red[threadIdx.x + k];
        __syncthreads();
      }
      if (threadIdx.x == 0)
        ai.ws[d[F_POUT] + c] = activate(red[0] * __int_as_float(d[F_PINV]), d[F_PACT]);
      __syncthreads();
    }
    __syncthreads();
  }
}

// y = act(a op b) over (C, L): op 0 unary, 1 add, 2 mul (b a (C, 1)
// vector with bvec), 3 the broadcast of the (C, 1) vector a over L
__device__ void elt_op(const Args& a, const int* d) {
  const int C = d[F_C], L = d[F_N], op = d[F_ELT], bvec = d[F_BVEC], act = d[F_ACT];
  const long long n = (long long)C * L;
  for (int img = 0; img < a.n; ++img) {
    const Args ai = a.at(img);
    const float* x = operand(ai, d[F_IN]);
    const float* u = op == 1 || op == 2 ? operand(ai, d[F_AUX]) : nullptr;
    float* y = ai.ws + d[F_OUT];
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
}

// separable 2-tap bilinear resize, columns then rows, as the reference
// sums; the tap indices are stored in the arena as floats
__device__ void resize_op(const Args& a, const int* d) {
  const int C = d[F_C], H = d[F_H], W = d[F_WD], OH = d[F_OH], OW = d[F_OW];
  const float* ridx = a.ar + d[F_W];
  const float* rw = a.ar + d[F_B];
  const float* cidx = a.ar + d[F_W1];
  const float* cw = a.ar + d[F_W2];
  const long long n = (long long)C * OH * OW;
  for (int img = 0; img < a.n; ++img) {
    const Args ai = a.at(img);
    const float* x = operand(ai, d[F_IN]);
    float* y = ai.ws + d[F_OUT];
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
}

__device__ void copy_op(const Args& a, const int* d) {
  const long long n = d[F_N];
  for (int img = 0; img < a.n; ++img) {
    const Args ai = a.at(img);
    const float* x = operand(ai, d[F_IN]);
    float* y = ai.ws + d[F_OUT];
    for (long long i = (long long)blockIdx.x * NT + threadIdx.x; i < n;
         i += (long long)gridDim.x * NT)
      y[i] = ld(x + i);
  }
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

__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// the table is copied to shared memory once (n_ops * DESC int32 at the
// start of the dynamic shared memory, a multiple of 16 bytes); the ops'
// working memory follows it.  With ``stamps`` (a measurement run), CTA 0
// writes the device's nanosecond clock after the start barrier and after
// each phase's barrier (one more barrier ends the last phase): phases + 1
// stamps.  BF16: the table's dot mode (0 f32 dots, 1 bf16); TERMS: its
// GEMM tile's (3 the bf16x3 split, 1 the bf16 mode's one pass, 6 the
// six-term split of "highest"); BATCH: the batch kernel (n_img > 1), whose
// conv, column-wise, depthwise and GEMM ops walk a run of items a CTA
template <int BF16, int TERMS, bool BATCH>
__global__ void __launch_bounds__(NT)
body_mega_kernel(const float* x, float* ws, const float* arena, const int* table,
                 int n_ops, int n_img, long long x_stride, long long ws_stride,
                 unsigned long long* stamps) {
  extern __shared__ __align__(16) float smem[];
  int* tab = reinterpret_cast<int*>(smem);
  float* sm = smem + n_ops * DESC;
  const Args a{x, ws, arena, n_img, x_stride, ws_stride};
  for (int e = threadIdx.x; e < n_ops * DESC / 4; e += NT)
    cp_async16(tab + 4 * e, table + 4 * e, true);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  const bool stamp = stamps != nullptr && blockIdx.x == 0 && threadIdx.x == 0;
  int phase = 0;
  if (stamps != nullptr) phase_barrier<0>();
  if (stamp) stamps[phase++] = globaltimer();
  for (int i = 0; i < n_ops; ++i) {
    const int* sd = tab + i * DESC;
    switch (sd[F_CODE]) {
      case OP_CONV:
        if constexpr (BATCH)
          conv_batch_op<BF16>(a, sd, sm);
        else
          conv_op<BF16>(a, sd, sm);
        break;
      case OP_FC: fc_op<BF16>(a, sd); break;
      case OP_DW: dw_op<BATCH>(a, sd, sm); break;
      case OP_GPOOL: gpool_op(a, sd); break;
      case OP_ELT: elt_op(a, sd); break;
      case OP_RESIZE: resize_op(a, sd); break;
      case OP_COPY: copy_op(a, sd); break;
      case OP_GEMM: gemm_op<TERMS, BATCH>(a, sd, sm); break;
      case OP_CONVW:
        if constexpr (BATCH)
          convw_batch_op<BF16>(a, sd, sm);
        else
          convw_op<BF16>(a, sd, sm);
        break;
      default: break;
    }
    __syncthreads();   // the next op reuses the working memory
    if (sd[F_SYNC] || (stamps != nullptr && i == n_ops - 1)) {
      phase_barrier<0>();
      if (stamp) stamps[phase++] = globaltimer();
    }
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
  if constexpr (BARRIER == 0) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem);
    if (e != cudaSuccess) return (int)e;
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
    return launch_cluster(kern, cluster, NT, smem, stream, args...);
  }
}

}  // namespace

extern "C" {

#ifdef BS_BODY_BATCH
// bs_body_mega for a batch of n_img > 1 (body_batch.cu builds it): the
// BATCH instantiations
int bs_body_mega_batch(const void* x, void* ws, const void* arena, const void* table, int n_ops,
                       int smem, int dots, int n_img, long long x_stride, long long ws_stride,
                       void* stamps, void* stream) {
  static decltype(&body_mega_kernel<0, 3, true>) const kerns[3] = {
      &body_mega_kernel<0, 3, true>, &body_mega_kernel<1, 1, true>,
      &body_mega_kernel<0, 6, true>};
  return launch_resident<0>(kerns[dots], 0, smem, (cudaStream_t)stream, (const float*)x,
                            (float*)ws, (const float*)arena, (const int*)table, n_ops, n_img,
                            x_stride, ws_stride, (unsigned long long*)stamps);
}
#else
int bs_body_mega_batch(const void* x, void* ws, const void* arena, const void* table, int n_ops,
                       int smem, int dots, int n_img, long long x_stride, long long ws_stride,
                       void* stamps, void* stream);

// one run of the op table over ``n_img`` images: ``n_ops`` descriptors of
// DESC int32 at ``table``, image i's operands in ``ws + i * ws_stride``
// (and ``x + i * x_stride``), weights in ``arena``;
// ``smem`` dynamic shared bytes a CTA (MegaTable.smem_bytes, for n_img > 1
// MegaTable.smem_batch); ``dots`` the table's dot mode (0 f32 / bf16x3, 1
// bf16, 2 f32 / bf16x6: megakernel.py:DOT_MODES);
// ``stamps`` null, or phases + 1 uint64 for the phase clock (a
// measurement run)
int bs_body_mega(const void* x, void* ws, const void* arena, const void* table, int n_ops,
                 int smem, int dots, int n_img, long long x_stride, long long ws_stride,
                 void* stamps, void* stream) {
  if (dots < 0 || dots > 2 || n_img < 1) return (int)cudaErrorInvalidValue;
  if (n_img > 1)
    return bs_body_mega_batch(x, ws, arena, table, n_ops, smem, dots, n_img, x_stride,
                              ws_stride, stamps, stream);
  static decltype(&body_mega_kernel<0, 3, false>) const kerns[3] = {
      &body_mega_kernel<0, 3, false>, &body_mega_kernel<1, 1, false>,
      &body_mega_kernel<0, 6, false>};
  return launch_resident<0>(kerns[dots], 0, smem, (cudaStream_t)stream, (const float*)x,
                            (float*)ws, (const float*)arena, (const int*)table, n_ops, n_img,
                            x_stride, ws_stride, (unsigned long long*)stamps);
}

// ``iters`` phase barriers in one launch: barrier 0, a cooperative grid of
// one CTA an SM; 1, one cluster of ``cluster`` CTAs
int bs_barrier_bench(int iters, int barrier, int cluster, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (barrier == 0) return launch_resident<0>(barrier_bench_kernel<0>, 0, 0, s, iters);
  if (barrier == 1) return launch_resident<1>(barrier_bench_kernel<1>, cluster, 0, s, iters);
  return (int)cudaErrorInvalidValue;
}
#endif

}  // extern "C"
