"""Fused composite + pack: YUYV (K3, counterpart of
``backscrub_tpu/ops/pallas_kernels.py:blend_pack_yuyv``) and NV12/I420
(K4, counterpart of ``pallas_kernels.py:blend_pack_420``).

:func:`blend_pack_yuyv_plain` (``alpha_blend_u8`` + ``rgb_to_yuyv``) and
:func:`blend_pack_420_plain` (``alpha_blend_u8`` + ``bgr_to_nv12`` /
``bgr_to_i420``) are the plain PyTorch versions; :func:`blend_pack_yuyv`
and :func:`blend_pack_420` run them on CPU tensors and launch the CUDA
kernels of ``csrc/blend_pack.cu`` on CUDA tensors, counting launches in
their ``launches`` attribute.  Kernel and plain version are
byte-identical: the kernels are integer math throughout.  Both take a
stream batch, (S, H, W, 3) frames and backgrounds and (S, H, W) masks, in
one launch (the JAX kernels fold leading axes into rows), each frame's
bytes those of a one-frame call.
"""

from __future__ import annotations

import math

import torch

from .. import _build
from ..pipeline.image import alpha_blend_u8, bgr_to_i420, bgr_to_nv12, rgb_to_yuyv


def _lead(frame_bgr: torch.Tensor):
    """(leading axes, frames in them, H, W) of a (..., H, W, 3) frame batch."""
    lead = tuple(frame_bgr.shape[:-3])
    return lead, math.prod(lead), frame_bgr.shape[-3], frame_bgr.shape[-2]


def blend_pack_yuyv_plain(frame_bgr: torch.Tensor, bg_bgr: torch.Tensor,
                          mask: torch.Tensor, chroma_order: str = "reference",
                          correct_colors: bool = False) -> torch.Tensor:
    """(..., H, W, 3) frame/bg u8 + (..., H, W) mask u8 -> (..., H, 2W)
    YUYV bytes."""
    comp = alpha_blend_u8(bg_bgr, frame_bgr, mask)
    src = comp.flip(-1) if correct_colors else comp
    yuyv = rgb_to_yuyv(src, chroma_order=chroma_order)
    return yuyv.reshape(tuple(yuyv.shape[:-2]) + (yuyv.shape[-2] * 2,))


def blend_pack_yuyv(frame_bgr: torch.Tensor, bg_bgr: torch.Tensor,
                    mask: torch.Tensor, chroma_order: str = "reference",
                    correct_colors: bool = False) -> torch.Tensor:
    """Composite and pack a frame (H, W, 3) or a stream batch (..., H, W,
    3) in one launch, the frames as rows: the kernel on CUDA, the plain
    version on CPU; ``chroma_order`` "reference" ([Y0, V, Y1, U]) or
    "yuy2"."""
    if chroma_order not in ("reference", "yuy2"):
        raise ValueError(f"chroma_order must be 'reference' or 'yuy2', "
                         f"got {chroma_order!r}")
    if frame_bgr.device.type == "cpu":
        return blend_pack_yuyv_plain(frame_bgr, bg_bgr, mask, chroma_order,
                                     correct_colors)
    lead, n, h, w = _lead(frame_bgr)
    if w % 2:
        raise ValueError(f"width={w}: YUYV needs an even width")
    _build.check_cuda(frame_bgr, "frame", torch.uint8, lead + (h, w, 3))
    _build.check_cuda(bg_bgr, "background", torch.uint8, lead + (h, w, 3))
    _build.check_cuda(mask, "mask", torch.uint8, lead + (h, w))
    out = torch.empty(lead + (h, 2 * w), dtype=torch.uint8, device=frame_bgr.device)
    _build.launch("bs_blend_pack_yuyv", frame_bgr.data_ptr(), bg_bgr.data_ptr(),
                  mask.data_ptr(), out.data_ptr(), n * h, w,
                  int(chroma_order == "reference"), int(correct_colors))
    blend_pack_yuyv.launches += 1
    return out


blend_pack_yuyv.launches = 0


def blend_pack_420_plain(frame_bgr: torch.Tensor, bg_bgr: torch.Tensor,
                         mask: torch.Tensor, layout: str = "nv12") -> torch.Tensor:
    """(..., H, W, 3) frame/bg u8 + (..., H, W) mask u8 -> NV12 (..., 3H/2,
    W) or I420 (..., 3HW/2) bytes."""
    comp = alpha_blend_u8(bg_bgr, frame_bgr, mask)
    return bgr_to_nv12(comp) if layout == "nv12" else bgr_to_i420(comp)


def blend_pack_420(frame_bgr: torch.Tensor, bg_bgr: torch.Tensor,
                   mask: torch.Tensor, layout: str = "nv12") -> torch.Tensor:
    """Composite and pack a frame (H, W, 3) or a stream batch (..., H, W,
    3) in one launch as BT.601 4:2:0, ``layout`` "nv12" (Y rows, then
    interleaved [U, V] rows: (..., 3H/2, W)) or "i420" (flat Y, U, V
    planes: (..., 3HW/2)), each frame's own layout; H and W even.  The
    kernel on CUDA, the plain version on CPU."""
    if layout not in ("nv12", "i420"):
        raise ValueError(f"layout must be 'nv12' or 'i420', got {layout!r}")
    if frame_bgr.device.type == "cpu":
        return blend_pack_420_plain(frame_bgr, bg_bgr, mask, layout)
    lead, n, h, w = _lead(frame_bgr)
    if h % 2 or w % 2:
        raise ValueError(f"{layout.upper()} needs even geometry, got {w}x{h}")
    _build.check_cuda(frame_bgr, "frame", torch.uint8, lead + (h, w, 3))
    _build.check_cuda(bg_bgr, "background", torch.uint8, lead + (h, w, 3))
    _build.check_cuda(mask, "mask", torch.uint8, lead + (h, w))
    shape = (3 * h // 2, w) if layout == "nv12" else (3 * h * w // 2,)
    out = torch.empty(lead + shape, dtype=torch.uint8, device=frame_bgr.device)
    _build.launch("bs_blend_pack_420", frame_bgr.data_ptr(), bg_bgr.data_ptr(),
                  mask.data_ptr(), out.data_ptr(), n, h, w, int(layout == "i420"))
    blend_pack_420.launches += 1
    return out


blend_pack_420.launches = 0
