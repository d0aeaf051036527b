"""MJPG decode after the entropy decoder, in plain PyTorch: quantized DCT
coefficients -> BGR (counterpart of ``backscrub_tpu/pipeline/jpeg.py``).

This is the plain version of the decode kernel (``ops/jpeg_kernels.py``,
``csrc/jpeg.cu``) and what a CPU tensor runs: dequantize, 8x8 inverse DCT,
chroma upsampling and YCbCr->BGR as int32 tensor ops.

Numerics are bit-exact vs cv2.imdecode (libjpeg-turbo defaults):

- the IDCT is ``jpeg_idct_islow`` (libjpeg jidctint.c): the Loeffler
  13-bit fixed-point butterfly, two passes with DESCALE(11)/DESCALE(18);
  int32 products wrap as in C, and ``>>`` on a negative int32 tensor is an
  arithmetic shift, as DESCALE needs;
- chroma upsampling is libjpeg's *fancy* (triangle) upsampling
  (jdsample.c ``h2v1/h2v2/h1v2_fancy_upsample``), border clamping at the
  component's cropped width making the first/last special cases fall out
  of the general formula; pixel replication (``int_upsample``) for other
  ratios;
- colour conversion is ``ycc_rgb_convert`` (jdcolor.c): 16-bit fixed
  point BT.601 with ONE_HALF rounding.

No ``//`` appears: every division here is a shift of the C source.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from ..io.jpeg import JpegInfo

# libjpeg jidctint.c CONST_BITS=13 multipliers
_FIX_0_298631336 = 2446
_FIX_0_390180644 = 3196
_FIX_0_541196100 = 4433
_FIX_0_765366865 = 6270
_FIX_0_899976223 = 7373
_FIX_1_175875602 = 9633
_FIX_1_501321110 = 12299
_FIX_1_847759065 = 15137
_FIX_1_961570560 = 16069
_FIX_2_053119869 = 16819
_FIX_2_562915447 = 20995
_FIX_3_072711026 = 25172


def _butterfly8(ins: Sequence[torch.Tensor], descale: int) -> List[torch.Tensor]:
    """One 8-point islow IDCT pass (jidctint.c), branch-free: libjpeg's
    all-zero-AC shortcut is bit-identical to the general path."""
    i0, i1, i2, i3, i4, i5, i6, i7 = ins
    # even part
    z2, z3 = i2, i6
    z1 = (z2 + z3) * _FIX_0_541196100
    tmp2 = z1 - z3 * _FIX_1_847759065
    tmp3 = z1 + z2 * _FIX_0_765366865
    t0 = (i0 + i4) << 13
    t1 = (i0 - i4) << 13
    tmp10, tmp13 = t0 + tmp3, t0 - tmp3
    tmp11, tmp12 = t1 + tmp2, t1 - tmp2
    # odd part
    t0, t1, t2, t3 = i7, i5, i3, i1
    z1 = t0 + t3
    z2 = t1 + t2
    z3 = t0 + t2
    z4 = t1 + t3
    z5 = (z3 + z4) * _FIX_1_175875602
    t0 = t0 * _FIX_0_298631336
    t1 = t1 * _FIX_2_053119869
    t2 = t2 * _FIX_3_072711026
    t3 = t3 * _FIX_1_501321110
    z1 = z1 * -_FIX_0_899976223
    z2 = z2 * -_FIX_2_562915447
    z3 = z3 * -_FIX_1_961570560 + z5
    z4 = z4 * -_FIX_0_390180644 + z5
    t0 = t0 + z1 + z3
    t1 = t1 + z2 + z4
    t2 = t2 + z2 + z3
    t3 = t3 + z1 + z4

    half = 1 << (descale - 1)

    def d(v):  # DESCALE: arithmetic shift
        return (v + half) >> descale

    return [d(tmp10 + t3), d(tmp11 + t2), d(tmp12 + t1), d(tmp13 + t0),
            d(tmp13 - t0), d(tmp12 - t1), d(tmp11 - t2), d(tmp10 - t3)]


def idct_islow(dequant: torch.Tensor) -> torch.Tensor:
    """(..., 8, 8) int32 dequantized coefficients -> (..., 8, 8) int32
    samples in [0, 255] (centred +128 and clamped, jidctint.c range_limit)."""
    x = dequant.to(torch.int32)
    # pass 1: columns (frequency axis -2), DESCALE(CONST_BITS - PASS1_BITS)
    ws = torch.stack(_butterfly8([x[..., k, :] for k in range(8)], 11), dim=-2)
    # pass 2: rows (axis -1), DESCALE(CONST_BITS + PASS1_BITS + 3)
    out = torch.stack(_butterfly8([ws[..., :, k] for k in range(8)], 18), dim=-1)
    return torch.clamp(out + 128, 0, 255)


def blocks_to_plane(blocks: torch.Tensor) -> torch.Tensor:
    """(..., bh, bw, 8, 8) -> (..., bh*8, bw*8)."""
    *lead, bh, bw, _, _ = blocks.shape
    n = len(lead)
    perm = tuple(range(n)) + (n, n + 2, n + 1, n + 3)
    return blocks.permute(perm).reshape(*lead, bh * 8, bw * 8)


def dequant_idct_plane(coef: torch.Tensor, qtab: torch.Tensor) -> torch.Tensor:
    """(..., bh, bw, 64) int16 raw coefficients + (..., 64) quant ->
    (..., bh*8, bw*8) int32 plane of samples in [0, 255]."""
    *lead, bh, bw, _ = coef.shape
    q = qtab.to(torch.int32)
    if q.dim() > 1:  # per-item tables: (..., 64) -> (..., 1, 1, 64)
        q = q.reshape(tuple(q.shape[:-1]) + (1, 1, 64))
    deq = coef.to(torch.int32) * q
    return blocks_to_plane(idct_islow(deq.reshape(*lead, bh, bw, 8, 8)))


# ---- fancy (triangle) upsamplers, jdsample.c ------------------------------
# Border clamping makes libjpeg's first/last-column special cases identical
# to the general formula: e.g. out[0] = (3*s0 + s0 + 1) >> 2 == s0.

def _shift_rows(x: torch.Tensor, axis: int):
    """The neighbour before and after along ``axis``, border-clamped."""
    n = x.shape[axis]
    before = torch.cat([x.narrow(axis, 0, 1), x.narrow(axis, 0, n - 1)], dim=axis)
    after = torch.cat([x.narrow(axis, 1, n - 1), x.narrow(axis, n - 1, 1)], dim=axis)
    return before, after


def _fancy_h2(row: torch.Tensor, bias_even: int, bias_odd: int,
              shift: int) -> torch.Tensor:
    """Horizontal 2x triangle along the last axis: (..., w) -> (..., 2w)."""
    left, right = _shift_rows(row, -1)
    even = (row * 3 + left + bias_even) >> shift
    odd = (row * 3 + right + bias_odd) >> shift
    return torch.stack([even, odd], dim=-1).reshape(tuple(row.shape[:-1])
                                                    + (row.shape[-1] * 2,))


def upsample_h2v1(plane: torch.Tensor) -> torch.Tensor:
    """h2v1_fancy_upsample: (..., h, w) -> (..., h, 2w)."""
    return _fancy_h2(plane, 1, 2, 2)


def _interleave_rows(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """Zip two (..., h, w) tensors into (..., 2h, w)."""
    h, w = even.shape[-2], even.shape[-1]
    return torch.stack([even, odd], dim=-2).reshape(tuple(even.shape[:-2]) + (2 * h, w))


def upsample_h1v2(plane: torch.Tensor) -> torch.Tensor:
    """h1v2_fancy_upsample (libjpeg-turbo, 4:4:0): (..., h, w) -> (..., 2h, w)."""
    up, down = _shift_rows(plane, -2)
    return _interleave_rows((plane * 3 + up + 1) >> 2, (plane * 3 + down + 2) >> 2)


def upsample_h2v2(plane: torch.Tensor) -> torch.Tensor:
    """h2v2_fancy_upsample: (..., h, w) -> (..., 2h, 2w).  The vertical
    triangle first (colsum = 3*this + nearer-neighbour row), then the
    horizontal pass on the 12-bit sums with biases 8/7 and >>4."""
    up, down = _shift_rows(plane, -2)
    rows = _interleave_rows(plane * 3 + up, plane * 3 + down)
    return _fancy_h2(rows, 8, 7, 4)


def upsample_int(plane: torch.Tensor, h_expand: int, v_expand: int) -> torch.Tensor:
    """int_upsample: pixel replication for unusual sampling ratios."""
    return plane.repeat_interleave(v_expand, dim=-2).repeat_interleave(h_expand, dim=-1)


def upsample_method(h: int, v: int, hmax: int, vmax: int) -> str:
    """jdsample.c's per-component method (do_fancy_upsampling=TRUE, the
    cv2/libjpeg-turbo default): "full", "h2v1", "h2v2", "h1v2" or "int"."""
    if h == hmax and v == vmax:
        return "full"
    if h * 2 == hmax and v == vmax:
        return "h2v1"
    if h * 2 == hmax and v * 2 == vmax:
        return "h2v2"
    if h == hmax and v * 2 == vmax:
        return "h1v2"
    if hmax % h == 0 and vmax % v == 0:
        return "int"
    raise ValueError(f"unsupported sampling {h}x{v} vs max {hmax}x{vmax}")


def upsample_plane(plane: torch.Tensor, h: int, v: int, hmax: int,
                   vmax: int) -> torch.Tensor:
    method = upsample_method(h, v, hmax, vmax)
    if method == "full":
        return plane
    if method == "int":
        return upsample_int(plane, hmax // h, vmax // v)
    return {"h2v1": upsample_h2v1, "h2v2": upsample_h2v2,
            "h1v2": upsample_h1v2}[method](plane)


# ---- colour conversion, jdcolor.c ------------------------------------------

def ycc_to_bgr(y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor) -> torch.Tensor:
    """ycc_rgb_convert (jdcolor.c build_ycc_rgb_table): 16-bit fixed point.
    FIX(1.40200)=91881 FIX(1.77200)=116130 FIX(0.71414)=46802
    FIX(0.34414)=22554; ONE_HALF rounding on the r/b terms, floor shift on
    the combined g term."""
    cbm = cb - 128
    crm = cr - 128
    r = y + ((91881 * crm + 32768) >> 16)
    b = y + ((116130 * cbm + 32768) >> 16)
    g = y + ((-22554 * cbm + 32768 - 46802 * crm) >> 16)
    return torch.clamp(torch.stack([b, g, r], dim=-1), 0, 255).to(torch.uint8)


def component_crop(info: JpegInfo, c: int):
    """Component ``c``'s sample grid before upsampling, (height, width):
    the MCU padding is cropped BEFORE upsampling, since libjpeg's border
    math clamps at the downsampled width, not the padded block width."""
    hmax = max(s[0] for s in info.sampling)
    vmax = max(s[1] for s in info.sampling)
    h, v = info.sampling[c]
    return -(-info.height * v // vmax), -(-info.width * h // hmax)


def decode_jpeg_bgr(coefs: Sequence[torch.Tensor], qtabs: torch.Tensor,
                    info: JpegInfo) -> torch.Tensor:
    """Raw coefficients -> (..., H, W, 3) BGR u8 (replicated gray for a
    1-component JPEG), bit-exact vs cv2.imdecode.  ``coefs`` are
    (..., bh, bw, 64) int16 a component, ``qtabs`` (..., ncomp, 64)."""
    hmax = max(s[0] for s in info.sampling)
    vmax = max(s[1] for s in info.sampling)
    planes = []
    for c in range(info.ncomp):
        plane = dequant_idct_plane(coefs[c], qtabs[..., c, :])
        ch, cw = component_crop(info, c)
        h, v = info.sampling[c]
        plane = upsample_plane(plane[..., :ch, :cw], h, v, hmax, vmax)
        planes.append(plane[..., :info.height, :info.width])
    if info.ncomp == 1:
        gray = torch.clamp(planes[0], 0, 255).to(torch.uint8)
        return torch.stack([gray, gray, gray], dim=-1)
    return ycc_to_bgr(planes[0], planes[1], planes[2])
