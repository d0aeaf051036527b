// The bf16x3 tensor-core GEMM tile of the flat continuation (K2''),
// shared by the standalone bs_gemm (body_flat.cu, the per-shape probe) and
// the persistent kernel's OP_GEMM (body_mega.cu, the deeplab table at
// "high").  One term (the bf16 mode) and six ("highest") run on the wgmma
// tile of gemm_wg.cuh.
//
// It computes one BM x BN tile of y = W x for W (M, K) and x (K, N), the
// TPU kernel's HIGH-precision dots (backscrub_tpu/ops/megakernel.py:
// 501-515) on Hopper's tensor cores: a = hi + lo with hi = bf16_rn(a) and
// lo = bf16_rn(a - hi); hi.hi accumulates in one f32 register tile and
// hi.lo + lo.hi in a second (mma.sync.aligned.m16n8k16 bf16 -> f32), added
// in the epilogue; lo.lo is dropped.  W comes split on the host (W_hi and
// W_lo bf16, rows padded to Kp, a multiple of 8, with zeros); x is split
// here, from the f32 tile in shared memory, while the B fragments are
// built.
//
// Loads: a ring of STAGES K slices of BK in shared memory, filled with
// 16-byte cp.async.cg (L2 only: the persistent kernel reads an x that an
// earlier phase of the same launch wrote).  An x row of N floats is not
// 16-byte aligned in general (N = 1089 at 33x33), so each row of a slice
// lands aligned down to 16 bytes, XS = BN + 4 floats wide, and is read at
// its shift (0-3 floats, from the row's address).  Bytes past the row's end
// and rows past K load as zeros (src-size < 16); the floats before a row's
// start that the first chunk brings are never read.
//
// The warps tile BM x BN as WARPS_M x WARPS_N; with KG = 2 two groups of
// them take the two k16 steps of each slice and add their sums in a fixed
// order before the epilogue, so two runs give the same bits.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "async_copy.cuh"
#include "body_act.cuh"

namespace {
namespace gemm_tc {

constexpr int BK = 32;           // K depth of a ring stage: two k16 MMA steps
constexpr int STAGES = 3;        // cp.async ring depth (3 beat 4, 5 and 7 on the table)
constexpr int WS = BK + 8;       // bf16 row stride of a W tile: conflict-free A fragments

// d += a (16x16 bf16, row) * b (16x8 bf16, col), f32 accumulate
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 v0, __nv_bfloat16 v1) {
  return (uint32_t)__bfloat16_as_ushort(v0) | ((uint32_t)__bfloat16_as_ushort(v1) << 16);
}

// the reference's split of two f32 values (k, k+1) into packed bf16 pairs
__device__ __forceinline__ void split2(float v0, float v1, uint32_t& hi, uint32_t& lo) {
  __nv_bfloat16 h0 = __float2bfloat16_rn(v0), h1 = __float2bfloat16_rn(v1);
  __nv_bfloat16 l0 = __float2bfloat16_rn(v0 - __bfloat162float(h0));
  __nv_bfloat16 l1 = __float2bfloat16_rn(v1 - __bfloat162float(h1));
  hi = pack2(h0, h1);
  lo = pack2(l0, l1);
}

// What a tile does with its sums v (hi.hi + cross terms): with ``part``,
// part[m, n] = v (a split-K partial); else y[m, n] = act(v + b[m]), then
// with ``r`` y = act2(y + r[m, n]) (a residual, read through L2).  y, r and
// part are (M, N) row-major.
struct Epilogue {
  const float* b;
  int act;
  const float* r;
  int act2;
  float* y;
  float* part;
};

template <int BM, int BN, int WARPS_M, int WARPS_N, int KG>
struct Tile {
  // W tiles a stage (hi, lo), and as many f32 accumulator tiles
  static constexpr int WH = 2;
  static constexpr int NT = 32 * WARPS_M * WARPS_N * KG;   // threads
  static constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N;
  static constexpr int MF = WM / 16, NF = WN / 8;          // m16n8 tiles a warp
  static constexpr int XS = BN + 4;                        // f32 row stride of an x slice
  static constexpr int XCH = BN / 4 + 1;                   // its 16-byte chunks a row
  static constexpr int RING = STAGES * (WH * BM * WS * 2 + BK * XS * 4);
  static constexpr int SMEM_BYTES = RING;                  // the KG sums reuse the ring
  static_assert(MF >= 1 && NF >= 1 && WM % 16 == 0 && WN % 8 == 0, "warp tile");
  static_assert(BK % (16 * KG) == 0, "the K groups take turns at a slice's k16 steps");
  static_assert(KG == 1 || (NT / KG) * MF * NF * 4 * WH * 4 <= RING,
                "K-group sums fit the ring");

  // The tile at (m0, n0) over K range [kb, kend_w) of W (x rows past
  // kend_x load as zeros), into ``ep``.  All NT threads call it; it leaves
  // no copy in flight, and the ring may be reused after a __syncthreads().
  __device__ static void run(unsigned char* smem, const __nv_bfloat16* whi,
                             const __nv_bfloat16* wlo, const float* x, int M, int Kp, int N,
                             int m0, int n0, int kb, int kend_w, int kend_x,
                             const Epilogue& ep) {
    __nv_bfloat16* sw = reinterpret_cast<__nv_bfloat16*>(smem);          // [STAGES][WH][BM][WS]
    float* sx = reinterpret_cast<float*>(smem + STAGES * WH * BM * WS * 2);  // [STAGES][BK][XS]
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, t = lane & 3;
    const int kgrp = warp / (WARPS_M * WARPS_N), wq = warp % (WARPS_M * WARPS_N);
    const int wm = wq / WARPS_N, wn = wq % WARPS_N;
    const int nk = (kend_w - kb + BK - 1) / BK;
    const int ks0 = KG == 1 ? 0 : kgrp * 16;    // the group's first k16 step of a slice
    // an x row's shift (floats past its 16-byte-aligned start) is
    // (address / 4) mod 4: for row k0 + kk of this tile, (xk0 + kk * nm) & 3
    const unsigned xw = (unsigned)((uintptr_t)x >> 2) + (unsigned)n0, nm = (unsigned)N & 3u;

    auto load = [&](int stage, int k0) {
      constexpr int WCH = BM * (BK / 8);          // 16-byte chunks of one W tile
      for (int e = tid; e < WH * WCH; e += NT) {
        int which = e / WCH, r = e % WCH;
        int row = r / (BK / 8), ch = r % (BK / 8);
        int gm = m0 + row, gk = k0 + ch * 8;
        bool ok = gm < M && gk < kend_w;
        const __nv_bfloat16* base = which == 0 ? whi : wlo;
        cp_async16(sw + ((stage * WH + which) * BM + row) * WS + ch * 8,
                   base + (ok ? (size_t)gm * Kp + gk : 0), ok);
      }
      for (int e = tid; e < BK * XCH; e += NT) {
        int kk = e / XCH, c = e % XCH, gk = k0 + kk;
        const float* row = x + (size_t)gk * N + n0;
        int sh = (int)(((uintptr_t)row >> 2) & 3), left = N - n0 - (4 * c - sh);
        int bytes = gk < kend_x && left > 0 ? 4 * min(4, left) : 0;
        cp_async16n(sx + (stage * BK + kk) * XS + 4 * c, bytes ? row - sh + 4 * c : x, bytes);
      }
    };

    // acc: hi.hi; cor: the cross terms
    float acc[MF][NF][4], cor[MF][NF][4];
#pragma unroll
    for (int i = 0; i < MF; ++i)
#pragma unroll
      for (int j = 0; j < NF; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][j][q] = cor[i][j][q] = 0.0f;

#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < nk) load(s, kb + s * BK);
      cp_async_commit();
    }
    for (int it = 0; it < nk; ++it) {
      cp_async_wait<STAGES - 2>();
      __syncthreads();   // slice ``it`` landed; every warp is done with it - 1
      int nx = it + STAGES - 1;
      if (nx < nk) load(nx % STAGES, kb + nx * BK);
      cp_async_commit();

      const int st = it % STAGES;
      const __nv_bfloat16* ah_s = sw + (st * WH + 0) * BM * WS;
      const __nv_bfloat16* al_s = sw + (st * WH + 1) * BM * WS;
      const float* xs = sx + st * BK * XS;
      const unsigned xk0 = xw + (unsigned)(kb + it * BK) * (unsigned)N;
#pragma unroll
      for (int ks = ks0; ks < BK; ks += 16 * KG) {
        uint32_t ah[MF][4], al[MF][4], bh[NF][2], bl[NF][2];
#pragma unroll
        for (int i = 0; i < MF; ++i) {
          int r = wm * WM + i * 16 + g;
          int c = ks + 2 * t;
          ah[i][0] = *reinterpret_cast<const uint32_t*>(ah_s + r * WS + c);
          ah[i][1] = *reinterpret_cast<const uint32_t*>(ah_s + (r + 8) * WS + c);
          ah[i][2] = *reinterpret_cast<const uint32_t*>(ah_s + r * WS + c + 8);
          ah[i][3] = *reinterpret_cast<const uint32_t*>(ah_s + (r + 8) * WS + c + 8);
          al[i][0] = *reinterpret_cast<const uint32_t*>(al_s + r * WS + c);
          al[i][1] = *reinterpret_cast<const uint32_t*>(al_s + (r + 8) * WS + c);
          al[i][2] = *reinterpret_cast<const uint32_t*>(al_s + r * WS + c + 8);
          al[i][3] = *reinterpret_cast<const uint32_t*>(al_s + (r + 8) * WS + c + 8);
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int k = ks + 2 * t + 8 * h;
          const float* r0 = xs + k * XS + ((xk0 + (unsigned)k * nm) & 3u);
          const float* r1 = xs + (k + 1) * XS + ((xk0 + (unsigned)(k + 1) * nm) & 3u);
#pragma unroll
          for (int j = 0; j < NF; ++j) {
            int col = wn * WN + j * 8 + g;
            split2(r0[col], r1[col], bh[j][h], bl[j][h]);
          }
        }
#pragma unroll
        for (int i = 0; i < MF; ++i)
#pragma unroll
          for (int j = 0; j < NF; ++j) {
            mma_bf16(acc[i][j], ah[i], bh[j]);
            mma_bf16(cor[i][j], ah[i], bl[j]);
            mma_bf16(cor[i][j], al[i], bh[j]);
          }
      }
    }
    cp_async_wait<0>();

    if constexpr (KG > 1) {
      // group 1 hands its sums to group 0 through the ring (value v of
      // thread l at red[v * NT / KG + l]: a warp's lanes on consecutive
      // banks): acc0 + acc1, then cor0 + cor1
      constexpr int LANES = NT / KG;
      float* red = reinterpret_cast<float*>(smem) + wq * 32 + lane;
      __syncthreads();
      if (kgrp == 1) {
#pragma unroll
        for (int i = 0; i < MF; ++i)
#pragma unroll
          for (int j = 0; j < NF; ++j)
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const int v = ((i * NF + j) * 4 + q) * WH;
              red[v * LANES] = acc[i][j][q];
              red[(v + 1) * LANES] = cor[i][j][q];
            }
      }
      __syncthreads();
      if (kgrp == 0) {
#pragma unroll
        for (int i = 0; i < MF; ++i)
#pragma unroll
          for (int j = 0; j < NF; ++j)
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const int v = ((i * NF + j) * 4 + q) * WH;
              acc[i][j][q] += red[v * LANES];
              cor[i][j][q] += red[(v + 1) * LANES];
            }
      }
    }

    // the epilogue: the sums v = hi.hi (+ cross terms) go to a BM x BN tile in
    // the ring, then every thread takes PER of its elements row by row (a
    // warp on consecutive columns: whole sectors stored, the residual read
    // coalesced), GROUP at a time with their bias and residual loads issued
    // before the group's first store (a store may alias them, so a load
    // cannot follow it)
    constexpr int TS = BN + 4, PER = BM * BN / NT, GROUP = PER < 8 ? PER : 8;
    static_assert(BM * TS * 4 <= RING && (BM * BN) % NT == 0 && PER % GROUP == 0,
                  "the epilogue tile fits");
    float* tile = reinterpret_cast<float*>(smem);
    __syncthreads();
    if (kgrp == 0) {
#pragma unroll
      for (int i = 0; i < MF; ++i)
#pragma unroll
        for (int j = 0; j < NF; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q)
            tile[(wm * WM + i * 16 + g + (q >= 2 ? 8 : 0)) * TS + wn * WN + j * 8 + 2 * t +
                 (q & 1)] = acc[i][j][q] + cor[i][j][q];
    }
    __syncthreads();
    const float* b = ep.b;
    const float* r = ep.r;
    float* y = ep.y;
    float* part = ep.part;
    const int act = ep.act, act2 = ep.act2;
#pragma unroll 1
    for (int k0 = 0; k0 < PER; k0 += GROUP) {
      float bias[GROUP], res[GROUP];
#pragma unroll
      for (int k = 0; k < GROUP; ++k) {
        const int e = tid + (k0 + k) * NT, row = m0 + e / BN, col = n0 + e % BN;
        const bool in = row < M && col < N;
        bias[k] = part == nullptr && in ? b[row] : 0.0f;
        res[k] = r != nullptr && in ? __ldcg(r + (size_t)row * N + col) : 0.0f;
      }
#pragma unroll
      for (int k = 0; k < GROUP; ++k) {
        const int e = tid + (k0 + k) * NT, row = m0 + e / BN, col = n0 + e % BN;
        if (row >= M || col >= N) continue;
        float v = tile[(e / BN) * TS + e % BN];
        size_t o = (size_t)row * N + col;
        if (part != nullptr) {
          part[o] = v;
        } else {
          v = activate(v + bias[k], act);
          if (r != nullptr) v = activate(v + res[k], act2);
          y[o] = v;
        }
      }
    }
  }
};

}  // namespace gemm_tc
}  // namespace
