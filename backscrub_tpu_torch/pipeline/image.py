"""Image ops of the frame pipeline (the part of
``backscrub_tpu/pipeline/image.py`` the port runs).

Tensors keep the JAX package's layouts: (..., H, W, C) images, (..., H, W)
masks, u8 in and out of the integer ops.  Reference counterparts:

- resize (cv::resize INTER_LINEAR)            lib/libbackscrub.cc:289,368
- bilateral filter d=5 sigma=100,100           lib/libbackscrub.cc:297
- 5x5 box blur (cv::blur)                      lib/libbackscrub.cc:371
- the same two in OpenCV's u8 fixed point (u8_exact post), bit-exact
- guided filter (the refine:guided mask option)
- erode / dilate (cv2, rect kernel; the morph: mask option), bit-exact
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


def _cv2_linear_taps(in_size: int, out_size: int):
    """OpenCV INTER_LINEAR tap positions and coefficients in fixed point
    (x2048), as imgproc/resize.cpp: fx in float32 from the double scale,
    floor/frac split, each tap rounded to the 11-bit grid with cvRound
    (ties to even).  Indices may be -1 or in_size: callers clamp them at
    the sample site, keeping the coefficients, as OpenCV clamps pointers."""
    dst = np.arange(out_size, dtype=np.float64)
    fx = ((dst + 0.5) * (in_size / out_size) - 0.5).astype(np.float32)
    sx = np.floor(fx).astype(np.int64)
    fx = fx.astype(np.float64) - sx
    c1 = np.rint(fx * 2048.0).astype(np.int32)
    return sx, 2048 - c1, c1


def _index(idx: np.ndarray, n: int, device) -> torch.Tensor:
    return torch.from_numpy(np.clip(idx, 0, n - 1).astype(np.int64)).to(device)


def resize_bilinear_u8_exact(x_u8: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """cv2.resize(..., INTER_LINEAR) on (..., H, W, C) u8, bit-exact with
    OpenCV's fixed-point path (``backscrub_tpu/pipeline/image.py:66``):
    the horizontal pass sums each output's two taps in int32 (exact), the
    vertical pass rounds tap-wise as OpenCV's vector code does,
    ``(((r0>>4)*b0)>>16) + (((r1>>4)*b1)>>16) + 2) >> 2``.  Taps are
    gathered, so the same code runs on any device (int32 has no matmul on
    the card)."""
    h, w = x_u8.shape[-3], x_u8.shape[-2]
    if (h, w) == (out_h, out_w):
        return x_u8
    dev = x_u8.device
    sx, c0x, c1x = _cv2_linear_taps(w, out_w)
    x = x_u8.to(torch.int32)
    c0 = torch.from_numpy(c0x[:, None]).to(dev)
    c1 = torch.from_numpy(c1x[:, None]).to(dev)
    acc = (x.index_select(-2, _index(sx, w, dev)) * c0
           + x.index_select(-2, _index(sx + 1, w, dev)) * c1)   # <= 255*2048
    sy, b0, b1 = _cv2_linear_taps(h, out_h)
    r0 = acc.index_select(-3, _index(sy, h, dev)) >> 4
    r1 = acc.index_select(-3, _index(sy + 1, h, dev)) >> 4
    b0 = torch.from_numpy(b0[:, None, None]).to(dev)
    b1 = torch.from_numpy(b1[:, None, None]).to(dev)
    out = (((r0 * b0) >> 16) + ((r1 * b1) >> 16) + 2) >> 2
    return torch.clamp(out, 0, 255).to(torch.uint8)


def _reflect101_index(n: int, r: int, device) -> torch.Tensor:
    """Source index of each position of a reflect-101 pad of ``r``."""
    i = np.abs(np.arange(-r, n + r))
    i = np.where(i > n - 1, 2 * (n - 1) - i, i)
    return torch.from_numpy(i.astype(np.int64)).to(device)


def box_blur_u8_exact(x_u8: torch.Tensor, ksize: int = 5) -> torch.Tensor:
    """cv2.blur on (..., H, W, C) u8, bit-exact: integer window sums with
    a reflect-101 border, scaled by 1/k^2 in f32 and rounded half to even
    (cvRound); the sum is integral, so the f32 product is never within
    rounding error of a tie."""
    r = ksize // 2
    h, w = x_u8.shape[-3], x_u8.shape[-2]
    xp = x_u8.to(torch.int32).index_select(-3, _reflect101_index(h, r, x_u8.device))
    xp = xp.index_select(-2, _reflect101_index(w, r, x_u8.device))
    acc = 0
    for i in range(ksize):
        acc = acc + xp[..., i:i + h, :, :]
    acc2 = 0
    for j in range(ksize):
        acc2 = acc2 + acc[..., :, j:j + w, :]
    scale = torch.tensor(1.0 / (ksize * ksize), dtype=torch.float32, device=x_u8.device)
    return torch.clamp(torch.round(acc2.float() * scale), 0, 255).to(torch.uint8)


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


def guided_filter(guide: torch.Tensor, src: torch.Tensor, radius: int = 8,
                  eps: float = 1e-3) -> torch.Tensor:
    """He et al.'s guided filter: refine ``src`` (..., H, W) with the edges
    of ``guide`` (..., H, W), both float in [0, 1]; the means are box blurs
    of 2r+1 with a reflect-101 border (``backscrub_tpu/pipeline/image.py:
    guided_filter``)."""
    k = 2 * radius + 1

    def mean(x):
        return box_blur(x[..., None], k)[..., 0]

    m_i = mean(guide)
    m_p = mean(src)
    corr_i = mean(guide * guide)
    corr_ip = mean(guide * src)
    var_i = corr_i - m_i * m_i
    cov_ip = corr_ip - m_i * m_p
    a = cov_ip / (var_i + eps)
    b = m_p - a * m_i
    return mean(a) * guide + mean(b)


def _morph_u8(x_u8: torch.Tensor, k: int, reduce, init: int) -> torch.Tensor:
    """k x k rect-kernel min/max of (..., H, W) u8, the border padded with
    ``init`` (a value that never wins), as two 1-D passes (exact: a rect
    window's min is the min of its rows' mins)."""
    if k < 1 or k % 2 == 0:
        raise ValueError(f"morphology kernel must be odd and >= 1, got {k}")
    r = (k - 1) // 2
    h, w = x_u8.shape[-2], x_u8.shape[-1]
    rows = torch.full(tuple(x_u8.shape[:-2]) + (r, w), init, dtype=x_u8.dtype,
                      device=x_u8.device)
    xp = torch.cat([rows, x_u8, rows], dim=-2)
    acc = xp[..., 0:h, :]
    for i in range(1, k):
        acc = reduce(acc, xp[..., i:i + h, :])
    cols = torch.full(tuple(acc.shape[:-1]) + (r,), init, dtype=acc.dtype, device=acc.device)
    xp = torch.cat([cols, acc, cols], dim=-1)
    out = xp[..., 0:w]
    for j in range(1, k):
        out = reduce(out, xp[..., j:j + w])
    return out


def erode_u8(x_u8: torch.Tensor, k: int = 3) -> torch.Tensor:
    """cv2.erode, bit-exact: k x k rect min filter, cv2's default border
    (+inf) as padding that never wins; (..., H, W) u8, odd k."""
    return _morph_u8(x_u8, k, torch.minimum, 255)


def dilate_u8(x_u8: torch.Tensor, k: int = 3) -> torch.Tensor:
    """cv2.dilate, bit-exact: k x k rect max filter, -inf border."""
    return _morph_u8(x_u8, k, torch.maximum, 0)


def apply_mask_morph(mask_u8: torch.Tensor, spec: str) -> torch.Tensor:
    """``morph:<erode|dilate|open|close>[:k]`` (k default 3) on the PERSON
    region of a (..., H, W) u8 mask.  Masks are 0 = person, so eroding the
    person is a max filter of the bytes and dilating it a min filter;
    open and close compose them (``backscrub_tpu/pipeline/image.py:
    apply_mask_morph``)."""
    parts = spec.split(":")
    k = int(parts[1]) if len(parts) > 1 and parts[1] else 3
    seq = {"erode": "D", "dilate": "E", "open": "DE", "close": "ED"}.get(parts[0])
    if seq is None:
        raise ValueError(f"morph op must be erode|dilate|open|close, got {parts[0]!r}")
    for s in seq:  # D = dilate the mask bytes (erodes the person), E = erode
        mask_u8 = dilate_u8(mask_u8, k) if s == "D" else erode_u8(mask_u8, k)
    return mask_u8


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
