"""MJPG encode before the entropy coder, in PyTorch: BGR frames ->
quantized DCT coefficients (counterpart of
``backscrub_tpu/pipeline/jpeg_enc.py``).

The dense half of the encode runs as tensor ops on the frame's device —
fixed-point RGB->YCbCr, chroma downsampling, the islow forward DCT,
quantisation and the zigzag gather — and only the bit-serial Huffman pack
stays on the host (``native/bsjpeg.cc`` ``bsjpeg_encode_zz``, wrapped by
``io/jpeg.py:JpegHuffmanEncoder``).  It runs with ``--sink-format mjpg``
only; it has no kernel of its own yet (ROADMAP, held lead 3).

Numerics reproduce libjpeg's encoder exactly (jccolor.c rgb_ycc_convert,
jcsample.c h2v2/h2v1_downsample, jfdctint.c jpeg_fdct_islow, jcdctmgr.c
quantize), so with the standard Annex K tables of the host packer the
stream matches what cv2.imencode (libjpeg-turbo, optimize off) writes for
the same pixels.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..io.jpeg import ZIGZAG, JpegInfo

# jccolor.c build_rgb_ycc_table constants (SCALEBITS=16)
_FIX_0_29900 = 19595
_FIX_0_58700 = 38470
_FIX_0_11400 = 7471
_FIX_0_16874 = 11059
_FIX_0_33126 = 21709
_FIX_0_50000 = 32768
_FIX_0_41869 = 27439
_FIX_0_08131 = 5329
_ONE_HALF = 1 << 15
_CBCR_OFFSET = 128 << 16


def bgr_to_ycc(bgr: torch.Tensor):
    """rgb_ycc_convert (jccolor.c): (..., H, W, 3) BGR u8 -> three
    (..., H, W) int32 planes in [0, 255], bit-exact vs libjpeg."""
    p = bgr.to(torch.int32)
    b, g, r = p[..., 0], p[..., 1], p[..., 2]
    y = (_FIX_0_29900 * r + _FIX_0_58700 * g + _FIX_0_11400 * b + _ONE_HALF) >> 16
    cb = (-_FIX_0_16874 * r - _FIX_0_33126 * g + _FIX_0_50000 * b
          + _CBCR_OFFSET + _ONE_HALF - 1) >> 16
    cr = (_FIX_0_50000 * r - _FIX_0_41869 * g - _FIX_0_08131 * b
          + _CBCR_OFFSET + _ONE_HALF - 1) >> 16
    return y, cb, cr


def _expand_to(plane: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Edge-replicate (jcprepct.c expand_bottom_edge / jcsample
    expand_right_edge) up to (h, w)."""
    ph, pw = plane.shape[-2], plane.shape[-1]
    if pw < w:
        pad = plane[..., :, -1:].expand(tuple(plane.shape[:-1]) + (w - pw,))
        plane = torch.cat([plane, pad], dim=-1)
    if ph < h:
        pad = plane[..., -1:, :].expand(tuple(plane.shape[:-2]) + (h - ph, plane.shape[-1]))
        plane = torch.cat([plane, pad], dim=-2)
    return plane


def _alternating(n: int, first: int, device) -> torch.Tensor:
    """first, first + 1, first, ... (n,) int32: jcsample.c's bias."""
    return torch.arange(n, dtype=torch.int32, device=device) % 2 + first


def downsample_h2v2(plane: torch.Tensor) -> torch.Tensor:
    """h2v2_downsample (jcsample.c): 2x2 box average with the alternating
    1/2 bias; (..., 2h, 2w) -> (..., h, w)."""
    s = (plane[..., 0::2, 0::2] + plane[..., 0::2, 1::2]
         + plane[..., 1::2, 0::2] + plane[..., 1::2, 1::2])
    return (s + _alternating(s.shape[-1], 1, s.device)) >> 2


def downsample_h2v1(plane: torch.Tensor) -> torch.Tensor:
    """h2v1_downsample (jcsample.c): horizontal pair average with the
    alternating 0/1 bias; (..., h, 2w) -> (..., h, w)."""
    s = plane[..., 0::2] + plane[..., 1::2]
    return (s + _alternating(s.shape[-1], 0, s.device)) >> 1


def plane_to_blocks(plane: torch.Tensor) -> torch.Tensor:
    """(..., bh*8, bw*8) -> (..., bh, bw, 8, 8)."""
    *lead, h, w = plane.shape
    x = plane.reshape(*lead, h // 8, 8, w // 8, 8)
    n = len(lead)
    return x.permute(tuple(range(n)) + (n, n + 2, n + 1, n + 3))


def _fdct_pass(ins, pass2: bool):
    """One 8-point pass of jpeg_fdct_islow (jfdctint.c)."""
    i0, i1, i2, i3, i4, i5, i6, i7 = ins
    t0, t1, t2, t3 = i0 + i7, i1 + i6, i2 + i5, i3 + i4
    t7, t6, t5, t4 = i0 - i7, i1 - i6, i2 - i5, i3 - i4
    t10, t13 = t0 + t3, t0 - t3
    t11, t12 = t1 + t2, t1 - t2
    if pass2:
        def d02(v):                                  # DESCALE(v, PASS1_BITS)
            return (v + 2) >> 2

        def d(v):                                    # DESCALE(v, CONST_BITS+PASS1_BITS)
            return (v + (1 << 14)) >> 15
    else:
        def d02(v):                                  # << PASS1_BITS
            return v << 2

        def d(v):                                    # DESCALE(v, CONST_BITS-PASS1_BITS)
            return (v + (1 << 10)) >> 11
    o0 = d02(t10 + t11)
    o4 = d02(t10 - t11)
    z1 = (t12 + t13) * 4433                          # FIX_0_541196100
    o2 = d(z1 + t13 * 6270)                          # FIX_0_765366865
    o6 = d(z1 - t12 * 15137)                         # FIX_1_847759065
    z1 = t4 + t7
    z2 = t5 + t6
    z3 = t4 + t6
    z4 = t5 + t7
    z5 = (z3 + z4) * 9633                            # FIX_1_175875602
    t4 = t4 * 2446                                   # FIX_0_298631336
    t5 = t5 * 16819                                  # FIX_2_053119869
    t6 = t6 * 25172                                  # FIX_3_072711026
    t7 = t7 * 12299                                  # FIX_1_501321110
    z1 = z1 * -7373                                  # -FIX_0_899976223
    z2 = z2 * -20995                                 # -FIX_2_562915447
    z3 = z3 * -16069 + z5                            # -FIX_1_961570560
    z4 = z4 * -3196 + z5                             # -FIX_0_390180644
    o7 = d(t4 + z1 + z3)
    o5 = d(t5 + z2 + z4)
    o3 = d(t6 + z2 + z3)
    o1 = d(t7 + z1 + z4)
    return [o0, o1, o2, o3, o4, o5, o6, o7]


def fdct_islow(samples: torch.Tensor) -> torch.Tensor:
    """jpeg_fdct_islow (jfdctint.c): (..., 8, 8) int32 level-shifted
    samples -> (..., 8, 8) int32 coefficients scaled up by 8."""
    x = samples.to(torch.int32)
    ws = torch.stack(_fdct_pass([x[..., :, k] for k in range(8)], False), dim=-1)
    return torch.stack(_fdct_pass([ws[..., k, :] for k in range(8)], True), dim=-2)


def quantize(coef: torch.Tensor, qtab: torch.Tensor) -> torch.Tensor:
    """jcdctmgr.c quantize: divisors are the quant values scaled by 8 (the
    x8-scaled fdct output), round half away from zero.  coef (..., bh, bw,
    8, 8) int32, qtab (..., 64) -> (..., bh, bw, 64) int16 (natural order)."""
    *lead, bh, bw, _, _ = coef.shape
    c = coef.reshape(*lead, bh, bw, 64)
    q = qtab.to(torch.int32) << 3
    if q.dim() > 1:
        q = q.reshape(tuple(q.shape[:-1]) + (1, 1, 64))
    # both operands are non-negative: floor division is C's truncation
    val = torch.div(torch.abs(c) + (q >> 1), q, rounding_mode="floor")
    return torch.where(c < 0, -val, val).to(torch.int16)


def _dummy_blocks(coef: torch.Tensor, info: JpegInfo, c: int, hmax: int,
                  vmax: int) -> torch.Tensor:
    """jccoefct.c compress_data's MCU dummy-block rule: blocks beyond the
    component's real block grid are not transformed — they carry all-zero
    AC and the DC of the block before them in the MCU's (v, h) emission
    order (chained through consecutive dummies)."""
    h, v = info.sampling[c]
    comp_w = -(-info.width * h // hmax)
    comp_h = -(-info.height * v // vmax)
    real_w, real_h = -(-comp_w // 8), -(-comp_h // 8)
    bh, bw = info.blocks[c]
    if real_w == bw and real_h == bh:
        return coef
    dev = coef.device
    real = ((torch.arange(bh, device=dev)[:, None] < real_h)
            & (torch.arange(bw, device=dev)[None, :] < real_w))      # (bh, bw)
    shape = tuple(coef.shape[:-3])
    coef = coef * real[..., None].to(coef.dtype)  # zero dummy blocks entirely
    mh, mw = bh // v, bw // h
    dcg = coef[..., 0].reshape(*shape, mh, v, mw, h)   # grouped by MCU
    realg = real.reshape(mh, v, mw, h)
    prev = dcg[..., :, 0, :, 0]                        # (v0, h0) is always real
    parts = []
    for vi in range(v):
        row = []
        for hi in range(h):
            if (vi, hi) != (0, 0):
                prev = torch.where(realg[:, vi, :, hi], dcg[..., :, vi, :, hi], prev)
            row.append(prev)
        parts.append(torch.stack(row, dim=-1))         # (..., mh, mw, h)
    dcg = torch.stack(parts, dim=-2)                   # (..., mh, mw, v, h)
    n = dcg.dim()
    dc = dcg.permute(tuple(range(n - 4)) + (n - 4, n - 2, n - 3, n - 1)).reshape(*shape, bh, bw)
    coef = coef.clone()
    coef[..., 0] = dc
    return coef


def encode_jpeg_coefs(bgr: torch.Tensor, qtabs: torch.Tensor, info: JpegInfo,
                      order: str = "zigzag") -> List[torch.Tensor]:
    """(..., H, W, 3) BGR u8 -> per-component (..., bh, bw, 64) int16
    quantized coefficients matching ``info``; ``qtabs`` (..., ncomp, 64).
    ``order`` "zigzag" (default: the host packer's ``bsjpeg_encode_zz``
    layout) or "natural" (``bsjpeg_decode``'s layout)."""
    if order not in ("zigzag", "natural"):
        raise ValueError(f"order must be zigzag|natural, got {order!r}")
    hmax = max(s[0] for s in info.sampling)
    vmax = max(s[1] for s in info.sampling)
    planes = bgr_to_ycc(bgr)[:info.ncomp]
    zz = torch.from_numpy(np.asarray(ZIGZAG)).to(bgr.device)
    out = []
    for c in range(info.ncomp):
        h, v = info.sampling[c]
        bh, bw = info.blocks[c]
        # the RIGHT edge is replicated at full resolution before averaging
        # (jcsample.c expand_right_edge), the BOTTOM edge only to the
        # downsampler's row granularity (jcprepct.c), then the iMCU padding
        # duplicates the last DOWNSAMPLED row
        comp_h = -(-info.height * v // vmax)
        p = _expand_to(planes[c], comp_h * (vmax // v), bw * 8 * (hmax // h))
        if h * 2 == hmax and v * 2 == vmax:
            p = downsample_h2v2(p)
        elif h * 2 == hmax and v == vmax:
            p = downsample_h2v1(p)
        elif not (h == hmax and v == vmax):
            raise ValueError(f"unsupported encoder sampling {h}x{v} "
                             f"(supported: 4:4:4, 4:2:2, 4:2:0)")
        p = _expand_to(p, bh * 8, bw * 8)
        coef = quantize(fdct_islow(plane_to_blocks(p - 128)), qtabs[..., c, :])
        coef = _dummy_blocks(coef, info, c, hmax, vmax)
        out.append(coef.index_select(-1, zz) if order == "zigzag" else coef)
    return out


def quality_to_qtabs(quality: int) -> np.ndarray:
    """jcparam.c jpeg_set_quality/jpeg_quality_scaling: the Annex K base
    tables scaled by the libjpeg quality curve -> (2, 64) uint16 in natural
    order (luma, chroma), what cv2.imencode uses for IMWRITE_JPEG_QUALITY."""
    base_luma = np.array([
        16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
        14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
        18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
        49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99],
        np.int64)
    base_chroma = np.array([
        17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
        24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
        99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
        99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99],
        np.int64)
    quality = min(max(int(quality), 1), 100)
    scale = 5000 // quality if quality < 50 else 200 - quality * 2
    out = np.zeros((2, 64), np.uint16)
    for t, base in enumerate([base_luma, base_chroma]):
        out[t] = np.clip((base * scale + 50) // 100, 1, 255).astype(np.uint16)
    return out


def stream_qtabs(quality: int, ncomp: int = 3) -> np.ndarray:
    """(ncomp, 64) tables a component: luma, then chroma for the rest."""
    qt = quality_to_qtabs(quality)
    return np.stack([qt[0]] + [qt[1]] * (ncomp - 1))
