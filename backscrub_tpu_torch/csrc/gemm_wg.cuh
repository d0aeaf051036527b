// The GEMM tile of the flat continuation (K2'') for Hopper (sm_90a), on
// wgmma, at all three of its term counts: the persistent kernel's OP_GEMM
// in its bf16 table (body_mega_kernel<1, 1>), its "high" table (<0, 3>,
// deeplab's and BodyPix's default) and its "highest" table (<0, 6>), and
// the standalone bs_gemm (body_flat.cu, the per-shape probe).
//
// Replaces the MXU dots of the TPU kernel backscrub_tpu/ops/megakernel.py:
// BodyMega in its flat mode (:660, body_mega_continuation_for), the 1x1
// convs' dot_general at megakernel.py:501-518: DEFAULT (TERMS = 1, the
// bf16 mode: both operands rounded to bf16, the products summed in f32),
// HIGH (TERMS = 3, the reference's split at :501-515: both operands as hi
// + lo with hi = bf16_rn(a), lo = bf16_rn(a - hi); hi.hi in a first f32
// accumulator, hi.lo + lo.hi in a second, added as first + second; lo.lo
// dropped) and HIGHEST (TERMS = 6, "highest": both operands in three bf16
// pieces, a = a0 + a1 + a2 with a1 = bf16_rn(a - a0), a2 = bf16_rn(a - a0 -
// a1), and the six products a_i.w_j with i + j <= 2 in three f32
// accumulators, a0.w0 in the first, a0.w1 + a1.w0 in the second, a0.w2 +
// a1.w1 + a2.w0 in the third, added as first + (second + third)).
//
// Bound.  The deeplab frame's 29 GEMMs (co 16-480, ci 16-512, L = 33 x 33
// = 1089) are small: at the ASPP projection (256 x 512 by 512 x 1089) six
// terms need 1.73 us of the card's bf16 rate, three 1.16 us of its bytes
// and one term 1.08 us, while the mma.sync tile this replaced took 24.2,
// 17.9 and 15.3 us, bound by its loads: every warp built its B fragments
// from the f32 x slice with scalar shared loads and split them again (each
// x value split once a warp row: four times in the 128 x 64 tile), its A
// fragments came in 32-bit shared loads (four a fragment at three terms,
// twelve at six), and every thread issued the weights' 16-byte cp.asyncs
// with its own address arithmetic.
//
// The design.  The product runs transposed, Y^T = X^T W^T, as
// wgmma.m64nBNk16 (wgmma.cuh): M = 64 positions of L a CTA tile, N = BN
// output channels (16-80, picked per op so that the phase is one round over
// the SMs: ops/megakernel.py:_wg_tile), K = 16 a step.
// - A = X^T from registers: each thread reads its fragment of the f32 x
//   slice once from shared memory and splits it there (1, 2 or 3 pieces),
//   so every x value is split once a CTA tile.  x comes in by 16-byte
//   cp.async.cg: each row of a slice aligned down to 16 bytes, XS = 68
//   floats wide, read at its shift, since an x row of 1089 floats is not
//   16-byte aligned (nor its stride, which rules out a TMA tensor map).
//   Bytes past a row's end and rows past K load as zeros.
// - B = W^T from shared memory, K-major, no swizzle: the weight pieces are
//   static, so the host lays them out once (MegaTable's arena; bs_gemm's
//   wrapper) in exactly the layout the descriptor reads, a ring stage's
//   pieces contiguous: for co tile t and K slice s of 64, the block
//   [piece][BN / 8][8][8][8] of bf16 (core matrices of 8 output channels by
//   8 of K, the K-neighbour 128 bytes on, the next 8 channels 1024), zeros
//   past co and K.  One thread moves a stage's block with one
//   cp.async.bulk completing on the stage's mbarrier.  A core matrix is
//   128 contiguous bytes, which wgmma reads without bank conflicts, so the
//   layout takes no swizzle.
// - The CTA is two warpgroups, each taking every other k16 step of a
//   64-deep slice (KG = 2); after the last slice warpgroup 1 hands its
//   accumulators to warpgroup 0 through shared memory, which adds them
//   accumulator by accumulator in a fixed order, so two runs give the same
//   bits.
// - A ring of 3 slices: at slice i the loads of slice i + 2 go out (into
//   the stage of slice i - 1, whose products both warpgroups have retired),
//   then slice i's fragments are split and its wgmmas issued, and
//   wgmma.wait_group 0 retires them before the next slice's split: ptxas
//   serializes every wgmma whose register operands later code defines while
//   it may be in flight (C7513), which cost more than the overlap it would
//   bring.  Two other pipelines were tried while the tile was designed and
//   were slower on the card: 32-deep slices with the fragments of two
//   slices in registers, and 64-deep ones with the A pieces in shared memory
//   (wgmma with both operands there, a warpgroup barrier and a proxy fence a
//   slice) whose products ran under the next slice's split.
// - The epilogue (bias, activation, residual or a split-K partial) goes
//   through a BN x 64 tile in the ring, each thread's loads of a group
//   issued before its first store.
// - A CTA that takes several tiles of one op (the table's GEMM op over a
//   stream batch: run_seq) runs them through one ring, slice after slice
//   from its first tile to its last, so that a tile's first two slices
//   load under the tile before's last products and epilogue; the K-group
//   sums and the epilogue tile then go through memory of their own past the
//   ring.  Each tile's slices, products and epilogue are run's.
//
// What bounds it now: the chain of slices, each its loads' wait, a CTA
// barrier, the split and the products in turn.  tools/gemm_ablation.py
// times the tile with its products, its split or its x loads taken away
// (PERF.md section 7 has what each saves).
//
// Shared memory a CTA (SMEM_BYTES): 3 x (W block + x slice) + 128 of
// alignment + the mbarriers; at one term 58,520 (BN 16) to 83,096 (BN 80),
// at three 64,664 to 113,816, at six 70,808 to 144,536
// (ops/megakernel.py:_wg_smem_bytes); run_seq's SEQ_SMEM_BYTES adds the
// larger of the K-group sums and the epilogue tile: at six terms and BN 80
// 205,976 (ops/megakernel.py:_wg_seq_smem_bytes, which the tests hold to the
// 232,448 a CTA may have with the table).  Registers: BN / 2 f32 an accumulator a thread (two at
// three terms, three at six: 120 at BN 80) and a slice's A fragments (8,
// 16 or 24).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "async_copy.cuh"
#include "body_act.cuh"
#include "wgmma.cuh"

namespace {
namespace gemm_wg {

constexpr int BM = 64;            // positions a CTA tile: wgmma's M
constexpr int BK = 64;            // K a ring stage: STEPS k16 steps for each warpgroup
constexpr int STEPS = BK / 32;
constexpr int STAGES = 3;         // ring depth: the slice in products and 2 loading
constexpr int XS = BM + 4;        // f32 row stride of an x slice (a row's shift is 0-3)
constexpr int XCH = BM / 4 + 1;   // its 16-byte chunks a row
constexpr int NT = 256;           // two warpgroups
constexpr int LBO = 128, SBO = BK / 8 * 128;   // the W block's core-matrix strides

// What a tile does with its sums v: with ``part``, part[m, n] = v (a
// split-K partial); else y[m, n] = act(v + b[m]), then with ``r`` y =
// act2(y + r[m, n]) (a residual, read through L2).  y, r and part are (M,
// N) row-major.
struct Epilogue {
  const float* b;
  int act;
  const float* r;
  int act2;
  float* y;
  float* part;
};

template <int BN, int TERMS>
struct Tile {
  static_assert(TERMS == 1 || TERMS == 3 || TERMS == 6,
                "one bf16 pass, the HIGH split or the six-term split");
  static_assert(BN % 16 == 0 && BN >= 16 && BN <= 80, "a wgmma N of gemm_wg's");
  static constexpr int P = TERMS == 6 ? 3 : TERMS == 3 ? 2 : 1;   // W pieces = accumulators
  static constexpr int NA = BN / 2;                     // f32 an accumulator a thread
  static constexpr int WBLK = P * BN * BK * 2;          // bytes of a stage's W block
  static constexpr int XSL = BK * XS * 4;               // bytes of a stage's x slice
  static constexpr int RING = STAGES * (WBLK + XSL);
  static constexpr int SMEM_BYTES = RING + 128 + STAGES * 8;
  // the K-group sums and the epilogue tile: in the ring after a tile's
  // last slice (run), or in this many bytes after the barriers (run_seq)
  static constexpr int EPI = P * NA * 128 * 4 > BN * XS * 4 ? P * NA * 128 * 4 : BN * XS * 4;
  static constexpr int SEQ_SMEM_BYTES = SMEM_BYTES + EPI;
  static_assert(EPI <= RING, "the K-group sums and the epilogue tile fit the ring");

  // the ring: STAGES W blocks, then STAGES x slices, 128-byte aligned; then
  // the stages' mbarriers
  struct Ring {
    unsigned char* sw;   // [STAGES][WBLK]
    float* sx;           // [STAGES][BK][XS]
    uint64_t* full;      // [STAGES]
    __device__ __forceinline__ explicit Ring(unsigned char* smem) {
      unsigned char* base = smem + ((0u - smem_u32(smem)) & 127u);
      sw = base;
      sx = reinterpret_cast<float*>(base + STAGES * WBLK);
      full = reinterpret_cast<uint64_t*>(base + RING);
    }
    // generic accesses to this memory (an earlier tile or op) before the
    // bulk copies' writes; the barriers
    __device__ __forceinline__ void init() const {
      wg::fence_proxy_async();
      if (threadIdx.x == 0) {
        for (int s = 0; s < STAGES; ++s) wg::mbar_init(full + s, 1);
        wg::mbar_init_fence();
      }
      __syncthreads();
    }
    // every copy landed and every wait passed: the barriers invalidated
    __device__ __forceinline__ void release() const {
      cp_async_wait<0>();
      __syncthreads();
      if (threadIdx.x == 0)
        for (int s = 0; s < STAGES; ++s) wg::mbar_inval(full + s);
    }
  };

  // slice k0 of x (rows k0 .. k0 + BK - 1 at positions n0 .. n0 + 63; rows
  // from kend_x on and bytes past a row's end as zeros) and the W block at
  // ``wsrc`` into stage st; the block by one bulk copy on the stage's
  // barrier, x by 16-byte cp.async (the caller commits)
  __device__ __forceinline__ static void load(const Ring& r, int st, const unsigned char* wsrc,
                                              const float* x, int N, int n0, int k0,
                                              int kend_x) {
    const int tid = threadIdx.x;
    if (tid == 0) {
      wg::mbar_expect_tx(r.full + st, WBLK);
      wg::bulk_g2s(r.sw + st * WBLK, wsrc, WBLK, r.full + st);
    }
    for (int e = tid; e < BK * XCH; e += NT) {
      const int kk = e / XCH, c = e % XCH, gk = k0 + kk;
      const float* row = x + (size_t)gk * N + n0;
      const int sh = (int)(((uintptr_t)row >> 2) & 3), left = N - n0 - (4 * c - sh);
      const int bytes = gk < kend_x && left > 0 ? 4 * min(4, left) : 0;
      cp_async16n(r.sx + (st * BK + kk) * XS + 4 * c, bytes ? row - sh + 4 * c : x, bytes);
    }
  }

  // the products of the slice in stage st (its first K row gk at
  // ``kslice``; xw, nm: the x rows' shift, as run computes them) into acc:
  // this warpgroup's k16 steps of the slice, 2 h + grp (past K: zeros in x
  // and W), split into their fragments, then their products, retired
  // before the fragments' registers are reused
  __device__ __forceinline__ static void products(const Ring& r, int st, int kslice,
                                                  unsigned xw, unsigned nm,
                                                  float (&acc)[P][NA]) {
    const int tid = threadIdx.x, grp = tid >> 7, wt = tid & 127;
    const int w = wt >> 5, g = (wt & 31) >> 2, t = wt & 3;
    uint32_t af[STEPS][P][4];
#pragma unroll
    for (int h = 0; h < STEPS; ++h) {
      const int kb = (2 * h + grp) * 16, gk0 = kslice + kb;
      const float* xs = r.sx + (st * BK + kb) * XS;
#pragma unroll
      for (int q = 0; q < 4; ++q) {   // A[m][k], A[m][k + 1] = x[k][m], x[k + 1][m]
        const int m = 16 * w + g + 8 * (q & 1), k = 2 * t + 8 * (q >> 1);
        const float* r0 = xs + k * XS + ((xw + (unsigned)(gk0 + k) * nm) & 3u);
        const float* r1 = xs + (k + 1) * XS + ((xw + (unsigned)(gk0 + k + 1) * nm) & 3u);
        if constexpr (TERMS == 6)
          wg::split3(r0[m], r1[m], af[h][0][q], af[h][1][q], af[h][2][q]);
        else if constexpr (TERMS == 3)
          wg::split2(r0[m], r1[m], af[h][0][q], af[h][1][q]);
        else
          af[h][0][q] = wg::round2(r0[m], r1[m]);
      }
    }
#pragma unroll
    for (int p = 0; p < P; ++p) wg::reg_fence(acc[p]);
    wg::fence();
#pragma unroll
    for (int h = 0; h < STEPS; ++h) {
      // a k16 step is two core matrices of K on: 256 bytes
      const unsigned char* wb = r.sw + st * WBLK + (2 * h + grp) * 256;
      // accumulator p takes the products a_i.w_j with i + j = p, i ascending
      constexpr int PB = BN * BK * 2;                     // a piece's bytes in the block
      wg::mma<BN>(acc[0], af[h][0], wg::smem_desc(wb, LBO, SBO));
      if constexpr (TERMS >= 3) {
        wg::mma<BN>(acc[1 % P], af[h][0], wg::smem_desc(wb + PB, LBO, SBO));
        wg::mma<BN>(acc[1 % P], af[h][1 % P], wg::smem_desc(wb, LBO, SBO));
      }
      if constexpr (TERMS == 6) {
        wg::mma<BN>(acc[2 % P], af[h][0], wg::smem_desc(wb + 2 * PB, LBO, SBO));
        wg::mma<BN>(acc[2 % P], af[h][1 % P], wg::smem_desc(wb + PB, LBO, SBO));
        wg::mma<BN>(acc[2 % P], af[h][2 % P], wg::smem_desc(wb, LBO, SBO));
      }
    }
    wg::commit();
    // the products done before the fragments' registers are reused (a
    // wgmma in flight over registers that later code defines is one that
    // ptxas serializes)
    wg::wait<0>();
#pragma unroll
    for (int p = 0; p < P; ++p) wg::reg_fence(acc[p]);
#pragma unroll
    for (int h = 0; h < STEPS; ++h)
#pragma unroll
      for (int p = 0; p < P; ++p) wg::reg_fence(af[h][p]);
  }

  // the tile's sums into ``ep``, through EPI bytes at ``scratch`` that no
  // copy in flight writes: warpgroup 1's sums to warpgroup 0 (value v of
  // thread l at red[v * 128 + l]: a warp's lanes on consecutive banks),
  // added accumulator by accumulator; then v = first (+ second, or +
  // (second + third)) into a BN x 64 tile, tile[o][m], and every thread
  // takes PER of its elements row by row (a warp on consecutive
  // positions), GROUP at a time with their bias and residual loads issued
  // before the group's first store (a store may alias them)
  __device__ __forceinline__ static void finish(unsigned char* scratch, float (&acc)[P][NA],
                                                int M, int N, int ct, int n0,
                                                const Epilogue& ep) {
    const int tid = threadIdx.x, grp = tid >> 7, wt = tid & 127;
    const int w = wt >> 5, g = (wt & 31) >> 2, t = wt & 3;
    float* red = reinterpret_cast<float*>(scratch) + wt;
    if (grp == 1) {
#pragma unroll
      for (int p = 0; p < P; ++p)
#pragma unroll
        for (int i = 0; i < NA; ++i) red[(p * NA + i) * 128] = acc[p][i];
    }
    __syncthreads();
    if (grp == 0) {
#pragma unroll
      for (int p = 0; p < P; ++p)
#pragma unroll
        for (int i = 0; i < NA; ++i) acc[p][i] += red[(p * NA + i) * 128];
    }
    __syncthreads();

    constexpr int TS = XS, PER = BN * BM / NT, GROUP = 4;
    static_assert(PER % GROUP == 0, "the epilogue's groups");
    float* tile = reinterpret_cast<float*>(scratch);
    if (grp == 0) {
#pragma unroll
      for (int i = 0; i < NA; ++i) {
        const int m = 16 * w + g + 8 * ((i >> 1) & 1), o = (i >> 2) * 8 + 2 * t + (i & 1);
        tile[o * TS + m] = TERMS == 6   ? acc[0][i] + (acc[1 % P][i] + acc[2 % P][i])
                           : TERMS == 3 ? acc[0][i] + acc[1 % P][i]
                                        : acc[0][i];
      }
    }
    __syncthreads();
    const int m0 = ct * BN, act = ep.act, act2 = ep.act2;
#pragma unroll 1
    for (int k0 = 0; k0 < PER; k0 += GROUP) {
      float bias[GROUP], res[GROUP];
#pragma unroll
      for (int k = 0; k < GROUP; ++k) {
        const int e = tid + (k0 + k) * NT, row = m0 + e / BM, col = n0 + e % BM;
        const bool in = row < M && col < N;
        bias[k] = ep.part == nullptr && in ? ep.b[row] : 0.0f;
        res[k] = ep.r != nullptr && in ? __ldcg(ep.r + (size_t)row * N + col) : 0.0f;
      }
#pragma unroll
      for (int k = 0; k < GROUP; ++k) {
        const int e = tid + (k0 + k) * NT, row = m0 + e / BM, col = n0 + e % BM;
        if (row >= M || col >= N) continue;
        float v = tile[(e / BM) * TS + e % BM];
        const size_t o = (size_t)row * N + col;
        if (ep.part != nullptr) {
          ep.part[o] = v;
        } else {
          v = activate(v + bias[k], act);
          if (ep.r != nullptr) v = activate(v + res[k], act2);
          ep.y[o] = v;
        }
      }
    }
  }

  // The tile of output channels [ct * BN, ct * BN + BN) and positions [n0,
  // n0 + 64) over K slices [s0, s1) of ``wblk`` (the op's laid-out W, nks
  // slices a co tile; x rows from kend_x on load as zeros), into ``ep``.
  // All NT threads call it; it leaves no copy in flight and its barriers
  // invalidated, and the ring may be reused after a __syncthreads().
  __device__ __forceinline__ static void run(unsigned char* smem, const __nv_bfloat16* wblk,
                                             const float* x, int M, int N, int nks, int ct,
                                             int n0, int s0, int s1, int kend_x,
                                             const Epilogue& ep) {
    const Ring r(smem);
    const int ns = s1 - s0;
    const unsigned xw = (unsigned)((uintptr_t)x >> 2) + (unsigned)n0, nm = (unsigned)N & 3u;
    const unsigned char* wsrc = reinterpret_cast<const unsigned char*>(wblk) +
                                ((size_t)ct * nks + s0) * WBLK;
    r.init();
    float acc[P][NA];
#pragma unroll
    for (int p = 0; p < P; ++p)
#pragma unroll
      for (int i = 0; i < NA; ++i) acc[p][i] = 0.0f;

    // a ring of STAGES: at slice i the loads of slice i + 2 go out (into the
    // stage of slice i - 1, whose products both warpgroups have retired)
#pragma unroll
    for (int i = 0; i < STAGES - 1; ++i) {
      if (i < ns) load(r, i, wsrc + (size_t)i * WBLK, x, N, n0, (s0 + i) * BK, kend_x);
      cp_async_commit();
    }
#pragma unroll 1
    for (int i = 0; i < ns; ++i) {
      const int st = i % STAGES;
      cp_async_wait<STAGES - 2>();
      wg::mbar_wait(r.full + st, (i / STAGES) & 1);
      __syncthreads();   // slice i landed; both warpgroups are done with slice i - 1
      const int nx = i + STAGES - 1;
      if (nx < ns)
        load(r, nx % STAGES, wsrc + (size_t)nx * WBLK, x, N, n0, (s0 + nx) * BK, kend_x);
      cp_async_commit();
      products(r, st, (s0 + i) * BK, xw, nm, acc);
    }
    r.release();         // the ring is free: the sums go through it
    finish(r.sw, acc, M, N, ct, n0, ep);
  }

  // A CTA's sequence of ``count`` tiles of one op (the table's OP_GEMM:
  // every slice of K, x rows from K on as zeros), from the tile of cursor
  // ``c`` on (c.x(), c.ct, c.n0(), c.ep() its x, co tile, first position
  // and epilogue; c.next() the next tile): one ring from the first slice of
  // the first tile to the last of the last, so that the first STAGES - 1
  // slices of a tile load under the tile before's last products and its
  // epilogue, which goes through the EPI bytes past the barriers
  // (SEQ_SMEM_BYTES in all).  Each tile's sums are run's for that tile: the
  // same slices, products and epilogue in the same order.  Leaves no copy
  // in flight and the barriers invalidated.
  template <class Cursor>
  __device__ __forceinline__ static void run_seq(unsigned char* smem,
                                                 const __nv_bfloat16* wblk, int M, int N,
                                                 int K, int count, Cursor c) {
    const Ring r(smem);
    unsigned char* scratch = reinterpret_cast<unsigned char*>(r.full) + STAGES * 8;
    const int nks = (K + BK - 1) / BK, total = count * nks;
    const unsigned nm = (unsigned)N & 3u;
    const auto* w8 = reinterpret_cast<const unsigned char*>(wblk);
    Cursor ic = c;       // the tile of the next slice to load: its x, first
    int ii = 0;          // position and W blocks, and the slice
    const float* ix = ic.x();
    int in0 = ic.n0();
    const unsigned char* iw = w8 + (size_t)ic.ct * nks * WBLK;
    auto issue = [&](int q) {   // slice q of the sequence into its stage
      load(r, q % STAGES, iw + (size_t)ii * WBLK, ix, N, in0, ii * BK, K);
      if (++ii == nks) {
        ii = 0;
        ic.next();
        ix = ic.x();
        in0 = ic.n0();
        iw = w8 + (size_t)ic.ct * nks * WBLK;
      }
    };
    r.init();
#pragma unroll 1
    for (int q = 0; q < STAGES - 1; ++q) {
      if (q < total) issue(q);
      cp_async_commit();
    }
#pragma unroll 1
    for (int j = 0, q = 0; j < count; ++j, c.next()) {
      const unsigned xw = (unsigned)((uintptr_t)c.x() >> 2) + (unsigned)c.n0();
      float acc[P][NA];
#pragma unroll
      for (int p = 0; p < P; ++p)
#pragma unroll
        for (int i = 0; i < NA; ++i) acc[p][i] = 0.0f;
#pragma unroll 1
      for (int i = 0; i < nks; ++i, ++q) {
        const int st = q % STAGES;
        cp_async_wait<STAGES - 2>();
        wg::mbar_wait(r.full + st, (q / STAGES) & 1);
        __syncthreads();   // slice q landed; both warpgroups are done with slice q - 1
        if (q + STAGES - 1 < total) issue(q + STAGES - 1);
        cp_async_commit();
        products(r, st, i * BK, xw, nm, acc);
      }
      finish(scratch, acc, M, N, c.ct, c.n0(), c.ep());
    }
    r.release();
  }
};

}  // namespace gemm_wg
}  // namespace
