"""Image ops of the frame pipeline (the part of
``backscrub_tpu/pipeline/image.py`` the port runs).

Tensors keep the JAX package's layouts: (..., H, W, C) images, (..., H, W)
masks, u8 in and out of the integer ops.  Reference counterparts:

- resize (cv::resize INTER_LINEAR)            lib/libbackscrub.cc:289,368
- bilateral filter d=5 sigma=100,100           lib/libbackscrub.cc:297
- 5x5 box blur (cv::blur)                      lib/libbackscrub.cc:371
- Gaussian background blur                     app/deepseg.cc:658
- alpha blend (integer, /255)                  app/deepseg.cc:108-134
- flips (cv::flip)                             app/deepseg.cc:667-673
- RGB -> YUYV pack (fixed point + interleave)  app/deepseg.cc:87-106
- BGR -> NV12 / I420 (cv2 COLOR_BGR2YUV_I420, BT.601 video range)
- YUYV / UYVY / NV12 -> RGB / BGR (camera ingest, cv2 COLOR_YUV2*)
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.misc import resize_bilinear_nhwc


def resize_bilinear(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """cv::resize INTER_LINEAR (half-pixel centres) on (..., H, W, C) float."""
    if tuple(x.shape[-3:-1]) == (out_h, out_w):
        return x
    return resize_bilinear_nhwc(x, out_h, out_w, half_pixel_centers=True)


def _bilateral_taps(d: int = 5, sigma_space: float = 100.0):
    """OpenCV tap set: square window of radius d//2, masked to r <= radius."""
    radius = d // 2
    taps = []
    for i in range(-radius, radius + 1):
        for j in range(-radius, radius + 1):
            r2 = i * i + j * j
            if math.sqrt(r2) > radius:
                continue
            taps.append((i, j, math.exp(-0.5 * r2 / (sigma_space ** 2))))
    return taps


def _reflect_pad_hw(x: torch.Tensor, r: int) -> torch.Tensor:
    """Reflect-101 pad the H and W axes of (..., H, W, C)."""
    lead = x.shape[:-3]
    xc = x.reshape((-1,) + tuple(x.shape[-3:])).permute(0, 3, 1, 2)
    xp = F.pad(xc, (r, r, r, r), mode="reflect").permute(0, 2, 3, 1)
    return xp.reshape(lead + tuple(xp.shape[1:]))


def bilateral_planes(xp: torch.Tensor, h: int, w: int, sigma_color=100.0,
                     sigma_space=100.0) -> torch.Tensor:
    """The 13-tap bilateral over an already padded (..., 3, h+4, w+4) plane
    stack -> (..., 3, h, w); same tap order and expression sequence as
    ``bilateral5`` (L1 colour distance, exp weights)."""
    inv2sc = -0.5 / (sigma_color ** 2)
    center = xp[..., 2:2 + h, 2:2 + w]
    num = torch.zeros_like(center)
    den = torch.zeros_like(center[..., :1, :, :])
    for (di, dj, sw) in _bilateral_taps(5, sigma_space):
        nb = xp[..., 2 + di:2 + di + h, 2 + dj:2 + dj + w]
        ad = torch.abs(nb - center)
        cdist = ad[..., 0:1, :, :] + ad[..., 1:2, :, :] + ad[..., 2:3, :, :]
        wgt = sw * torch.exp(inv2sc * cdist * cdist)
        num = num + wgt * nb
        den = den + wgt
    return num / den


def bilateral5(rgb_f32: torch.Tensor, sigma_color: float = 100.0,
               sigma_space: float = 100.0) -> torch.Tensor:
    """cv::bilateralFilter(d=5, sigmaColor=100, sigmaSpace=100) on
    (..., H, W, 3) float holding u8-range values, reflect-101 border; the
    plain version of K5 (``ops/image_kernels.py``)."""
    h, w = rgb_f32.shape[-3], rgb_f32.shape[-2]
    xp = _reflect_pad_hw(rgb_f32, 2).movedim(-1, -3)
    return bilateral_planes(xp, h, w, sigma_color, sigma_space).movedim(-3, -1)


def _sep_filter(x: torch.Tensor, kh: np.ndarray, kw: np.ndarray) -> torch.Tensor:
    """Separable filter with reflect-101 border on (..., H, W, C) float."""
    rh, rw = len(kh) // 2, len(kw) // 2
    xp = _reflect_pad_hw(x, max(rh, rw))
    h, w = x.shape[-3], x.shape[-2]
    acc = 0.0
    for i, kv in enumerate(kh):
        acc = acc + float(kv) * xp[..., i:i + h, :, :]
    acc2 = 0.0
    for j, kv in enumerate(kw):
        acc2 = acc2 + float(kv) * acc[..., :, j:j + w, :]
    return acc2


def box_blur(x: torch.Tensor, ksize: int = 5) -> torch.Tensor:
    """cv::blur(k x k) on float input (lib/libbackscrub.cc:371)."""
    k = np.full(ksize, 1.0 / ksize, np.float32)
    return _sep_filter(x, k, k)


def blur_matrix(size: int, ksize: int = 5) -> np.ndarray:
    """Dense (size, size) matrix of the 1-D box blur with reflect-101
    border, so blur∘resize folds into one matrix per axis."""
    r = ksize // 2
    m = np.zeros((size, size), np.float64)
    for o in range(size):
        for t in range(o - r, o + r + 1):
            i = t
            if i < 0:
                i = -i
            if i > size - 1:
                i = 2 * (size - 1) - i
            m[o, max(0, min(i, size - 1))] += 1.0 / ksize
    return m.astype(np.float32)


_SMALL_GAUSSIAN = {
    1: [1.0],
    3: [0.25, 0.5, 0.25],
    5: [0.0625, 0.25, 0.375, 0.25, 0.0625],
    7: [0.03125, 0.109375, 0.21875, 0.28125, 0.21875, 0.109375, 0.03125],
}


def gaussian_kernel(ksize: int, sigma: float = 0.0) -> np.ndarray:
    """cv::getGaussianKernel: fixed small-kernel table for ksize<=7 with
    sigma<=0, else sigma = 0.3*((k-1)*0.5 - 1) + 0.8."""
    if sigma <= 0 and ksize in _SMALL_GAUSSIAN:
        return np.asarray(_SMALL_GAUSSIAN[ksize], np.float32)
    if sigma <= 0:
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    xs = np.arange(ksize, dtype=np.float64) - (ksize - 1) * 0.5
    k = np.exp(-(xs ** 2) / (2 * sigma ** 2))
    return (k / k.sum()).astype(np.float32)


def gaussian_blur(x: torch.Tensor, ksize: int, sigma: float = 0.0) -> torch.Tensor:
    """cv::GaussianBlur(k x k, sigma) on (..., H, W, C) float
    (app/deepseg.cc:658 bgblur)."""
    k = gaussian_kernel(ksize, sigma)
    return _sep_filter(x, k, k)


def alpha_blend_u8(srca_u8: torch.Tensor, srcb_u8: torch.Tensor,
                   mask_u8: torch.Tensor) -> torch.Tensor:
    """Exact integer blend (app/deepseg.cc:108-134): mask 255 => srca
    (background), 0 => srcb (camera); (a*m + b*(255-m)) / 255 truncated."""
    a = srca_u8.to(torch.int32)
    b = srcb_u8.to(torch.int32)
    m = mask_u8.to(torch.int32)
    if m.dim() == a.dim() - 1:
        m = m[..., None]
    return torch.div(a * m + b * (255 - m), 255, rounding_mode="floor").to(torch.uint8)


def flip(x: torch.Tensor, horizontal: bool = False, vertical: bool = False) -> torch.Tensor:
    """cv::flip (app/deepseg.cc:667-673) on (..., H, W, C): W axis -2, H
    axis -3."""
    if horizontal:
        x = torch.flip(x, dims=(-2,))
    if vertical:
        x = torch.flip(x, dims=(-3,))
    return x


def bgr_to_gray_u8(bgr_u8: torch.Tensor) -> torch.Tensor:
    """cv::cvtColor(BGR2GRAY) bit-exact, (..., H, W, 3) u8 -> (..., H, W)
    u8: 15-bit fixed point (R 9798, G 19235, B 3735, round half up)."""
    p = bgr_u8.to(torch.int32)
    b, g, r = p[..., 0], p[..., 1], p[..., 2]
    return ((r * 9798 + g * 19235 + b * 3735 + (1 << 14)) >> 15).to(torch.uint8)


def desaturate_u8(bgr_u8: torch.Tensor) -> torch.Tensor:
    """Grayscale as BGR (the bgdesat background effect); a broadcast view."""
    y = bgr_to_gray_u8(bgr_u8)
    return y[..., None].expand(tuple(y.shape) + (3,))


def pixelate_u8(img_u8: torch.Tensor, block: int) -> torch.Tensor:
    """Mosaic (the bgpixelate background effect) on (..., H, W, 3) u8:
    edge-replicate to a block multiple, average each block x block tile
    (round half up), nearest-upsample back."""
    if block < 2:
        return img_u8
    h, w = img_u8.shape[-3], img_u8.shape[-2]
    hb, wb = -(-h // block), -(-w // block)
    x = img_u8.to(torch.int32)
    if hb * block != h:
        x = torch.cat([x, x[..., -1:, :, :].expand(
            tuple(x.shape[:-3]) + (hb * block - h,) + tuple(x.shape[-2:]))], dim=-3)
    if wb * block != w:
        x = torch.cat([x, x[..., :, -1:, :].expand(
            tuple(x.shape[:-2]) + (wb * block - w, 3))], dim=-2)
    lead = tuple(x.shape[:-3])
    x = x.reshape(lead + (hb, block, wb, block, 3))
    m = torch.div(x.sum(dim=(-4, -2)) + block * block // 2, block * block,
                  rounding_mode="floor")
    up = m.to(torch.uint8).repeat_interleave(block, dim=-3).repeat_interleave(block, dim=-2)
    return up[..., :h, :w, :]


# OpenCV 8-bit RGB2YUV fixed point: Y = descale(4899 R + 9617 G + 1868 B,
# 14), U = clamp(descale(8061 (B - Y) + (128<<14), 14)), V likewise 14369
_Y_R, _Y_G, _Y_B = 4899, 9617, 1868
_U_C, _V_C = 8061, 14369


def _descale(x: torch.Tensor, n: int = 14) -> torch.Tensor:
    return (x + (1 << (n - 1))) >> n


def rgb_to_yuv_u8(rgb_u8: torch.Tensor) -> torch.Tensor:
    """cv::cvtColor(RGB2YUV) bit-exact, (..., H, W, 3) u8 -> u8."""
    p = rgb_u8.to(torch.int32)
    r, g, b = p[..., 0], p[..., 1], p[..., 2]
    y = _descale(r * _Y_R + g * _Y_G + b * _Y_B)
    u = torch.clamp(_descale((b - y) * _U_C + (128 << 14)), 0, 255)
    v = torch.clamp(_descale((r - y) * _V_C + (128 << 14)), 0, 255)
    return torch.stack([y, u, v], dim=-1).to(torch.uint8)


def rgb_to_yuyv(rgb_u8: torch.Tensor, chroma_order: str = "reference") -> torch.Tensor:
    """RGB -> packed 4:2:2 (app/deepseg.cc:87-106): pair chroma averaged
    with truncating /2; "reference" byte order [Y0, V, Y1, U], "yuy2"
    [Y0, U, Y1, V].  Returns (..., H, W, 2) u8."""
    yuv = rgb_to_yuv_u8(rgb_u8).to(torch.int32)
    y, u, v = yuv[..., 0], yuv[..., 1], yuv[..., 2]
    u_avg = (u[..., 0::2] + u[..., 1::2]) // 2
    v_avg = (v[..., 0::2] + v[..., 1::2]) // 2
    c0, c1 = (v_avg, u_avg) if chroma_order == "reference" else (u_avg, v_avg)
    quad = torch.stack([y[..., 0::2], c0, y[..., 1::2], c1], dim=-1)
    return quad.reshape(tuple(quad.shape[:-2]) + (y.shape[-1], 2)).to(torch.uint8)


# 4:2:0 packs (NV12 / I420): OpenCV's ITU-R BT.601 video-range encode
# constants (color_yuv ITUR_BT_601_*, shift 20); chroma is sampled at the
# top-left pixel of each 2x2 block, as cv2.cvtColor(COLOR_BGR2YUV_I420).
# V's R coefficient is _ENC_CBU (BT.601's 0.5 for both), as in the JAX
# package.  All int32: >> on a negative int32 is an arithmetic shift.
_ENC_CRY, _ENC_CGY, _ENC_CBY = 269484, 528482, 102760
_ENC_CRU, _ENC_CGU, _ENC_CBU = -155188, -305135, 460324
_ENC_CGV, _ENC_CBV = -385875, -74448
_ENC_SHIFT = 20


def _bt601_yuv420(bgr_u8: torch.Tensor):
    """BGR u8 -> (Y (..., H, W), U (..., H/2, W/2), V (..., H/2, W/2)) u8."""
    p = bgr_u8.to(torch.int32)
    b, g, r = p[..., 0], p[..., 1], p[..., 2]
    half = 1 << (_ENC_SHIFT - 1)
    y = (r * _ENC_CRY + g * _ENC_CGY + b * _ENC_CBY
         + half + (16 << _ENC_SHIFT)) >> _ENC_SHIFT
    rs, gs, bs = (c[..., 0::2, 0::2] for c in (r, g, b))
    u = (rs * _ENC_CRU + gs * _ENC_CGU + bs * _ENC_CBU
         + half + (128 << _ENC_SHIFT)) >> _ENC_SHIFT
    v = (rs * _ENC_CBU + gs * _ENC_CGV + bs * _ENC_CBV
         + half + (128 << _ENC_SHIFT)) >> _ENC_SHIFT
    return tuple(torch.clamp(c, 0, 255).to(torch.uint8) for c in (y, u, v))


def _check_even(h: int, w: int, fmt: str) -> None:
    if h % 2 or w % 2:
        raise ValueError(f"{fmt} needs even geometry, got {w}x{h}")


def bgr_to_nv12(bgr_u8: torch.Tensor) -> torch.Tensor:
    """BGR u8 (..., H, W, 3) -> NV12 (..., 3H/2, W) u8: the Y plane, then
    interleaved [U, V] rows.  H and W must be even."""
    h, w = bgr_u8.shape[-3], bgr_u8.shape[-2]
    _check_even(h, w, "NV12")
    y, u, v = _bt601_yuv420(bgr_u8)
    uv = torch.stack([u, v], dim=-1).reshape(tuple(u.shape[:-2]) + (h // 2, w))
    return torch.cat([y, uv], dim=-2)


def bgr_to_i420(bgr_u8: torch.Tensor) -> torch.Tensor:
    """BGR u8 (..., H, W, 3) -> I420 flat bytes (..., 3HW/2): planar Y,
    then U, then V.  H and W must be even."""
    h, w = bgr_u8.shape[-3], bgr_u8.shape[-2]
    _check_even(h, w, "I420")
    lead = tuple(bgr_u8.shape[:-3])
    return torch.cat([c.reshape(lead + (-1,)) for c in _bt601_yuv420(bgr_u8)], dim=-1)


# OpenCV ITUR_BT_601 video-range decode constants (color_yuv: the
# YUV2RGB_YUY2 path), shift 20
_BT601_CY, _BT601_CUB, _BT601_CUG = 1220542, 2116026, -409993
_BT601_CVG, _BT601_CVR, _BT601_SHIFT = -852492, 1673527, 20


def _bt601_decode(y: torch.Tensor, ud: torch.Tensor, vd: torch.Tensor):
    """int32 luma and centred chroma -> (R, G, B) int32, unclamped."""
    yy = torch.clamp(y - 16, min=0) * _BT601_CY
    half = 1 << (_BT601_SHIFT - 1)
    r = (yy + _BT601_CVR * vd + half) >> _BT601_SHIFT
    g = (yy + _BT601_CUG * ud + _BT601_CVG * vd + half) >> _BT601_SHIFT
    b = (yy + _BT601_CUB * ud + half) >> _BT601_SHIFT
    return r, g, b


def yuyv_to_rgb_u8(yuyv_u8: torch.Tensor, chroma_order: str = "yuy2",
                   layout: str = "yuyv") -> torch.Tensor:
    """Packed 4:2:2 (..., H, W, 2) u8 -> RGB u8 (..., H, W, 3), the
    capture-side decode (``backscrub_tpu/pipeline/image.py:yuyv_to_rgb_u8``
    with its default BT.601 convention): ITU-R BT.601 video range,
    bit-exact with cv::COLOR_YUV2RGB_YUY2, what V4L2 cameras emit.
    layout="uyvy": the chroma-leading byte order (cv::COLOR_YUV2RGB_UYVY).
    chroma_order="reference" reads the first chroma byte as V."""
    q = yuyv_u8.to(torch.int32)
    h, w = q.shape[-3], q.shape[-2]
    lead = tuple(q.shape[:-3])
    quad = q.reshape(lead + (h, w // 2, 4))
    if layout == "uyvy":
        c0, y0, c1, y1 = quad.unbind(-1)
    else:
        y0, c0, y1, c1 = quad.unbind(-1)
    u, v = (c1, c0) if chroma_order == "reference" else (c0, c1)
    y = torch.stack([y0, y1], dim=-1).reshape(lead + (h, w))
    ud = u.repeat_interleave(2, dim=-1) - 128
    vd = v.repeat_interleave(2, dim=-1) - 128
    r, g, b = _bt601_decode(y, ud, vd)
    return torch.clamp(torch.stack([r, g, b], dim=-1), 0, 255).to(torch.uint8)


def nv12_to_bgr_u8(nv12_u8: torch.Tensor) -> torch.Tensor:
    """NV12 (..., 3H/2, W) u8 -> BGR u8 (..., H, W, 3), bit-exact with
    cv2.COLOR_YUV2BGR_NV12 (BT.601 video range, chroma replicated over
    each 2x2 block): the ingest of NV12 cameras."""
    hh, w = nv12_u8.shape[-2], nv12_u8.shape[-1]
    h = hh * 2 // 3
    q = nv12_u8.to(torch.int32)
    lead = tuple(q.shape[:-2])
    uv = q[..., h:, :].reshape(lead + (h // 2, w // 2, 2))
    ud, vd = (uv[..., i].repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1) - 128
              for i in (0, 1))
    r, g, b = _bt601_decode(q[..., :h, :], ud, vd)
    return torch.clamp(torch.stack([b, g, r], dim=-1), 0, 255).to(torch.uint8)
