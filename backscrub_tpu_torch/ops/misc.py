"""Shape/data-movement lowerings: CONCATENATION, RESHAPE, RESIZE_BILINEAR.

RESIZE_BILINEAR is two dense interpolation-matrix contractions
(separable bilinear), as in ``backscrub_tpu/ops/misc.py``; the matrices
come from the same numpy ``resize_matrix``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .common import apply_activation, register


@register("CONCATENATION")
def concatenation(ctx, node):
    y = torch.cat([ctx.get(i) for i in node.inputs],
                  dim=node.options.get("axis", -1))
    ctx.set(node.outputs[0], apply_activation(y, node.options.get("activation")))


@register("RESHAPE")
def reshape(ctx, node):
    x = ctx.get(node.inputs[0])
    if "new_shape" in node.options:
        shape = node.options["new_shape"]
    else:
        shape = ctx.const_value(node.inputs[1]).reshape(-1).tolist()
    ctx.set(node.outputs[0], x.reshape([int(s) for s in shape]))


def resize_matrix(in_size: int, out_size: int, align_corners: bool,
                  half_pixel_centers: bool) -> np.ndarray:
    """Dense (out, in) bilinear interpolation matrix, TFLite conventions.

    - legacy (both flags false): src = dst * in/out
    - align_corners:             src = dst * (in-1)/(out-1)
    - half_pixel_centers:        src = (dst + 0.5) * in/out - 0.5
    """
    if in_size == out_size:
        return np.eye(out_size, dtype=np.float32)
    dst = np.arange(out_size, dtype=np.float64)
    if align_corners and out_size > 1:
        src = dst * (in_size - 1) / (out_size - 1)
    elif half_pixel_centers:
        src = (dst + 0.5) * (in_size / out_size) - 0.5
    else:
        src = dst * (in_size / out_size)
    src = np.clip(src, 0.0, in_size - 1)
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, in_size - 1)
    frac = (src - lo).astype(np.float64)
    mat = np.zeros((out_size, in_size), dtype=np.float64)
    mat[np.arange(out_size), lo] += 1.0 - frac
    mat[np.arange(out_size), hi] += frac
    return mat.astype(np.float32)


@functools.lru_cache(maxsize=64)
def _resize_matrix_on(in_size: int, out_size: int, align_corners: bool,
                      half_pixel_centers: bool, device: torch.device) -> torch.Tensor:
    """resize_matrix as a tensor on ``device``, uploaded once (callers only
    read it)."""
    return torch.from_numpy(resize_matrix(in_size, out_size, align_corners,
                                          half_pixel_centers)).to(device)


def resize_bilinear_nhwc(x, out_h: int, out_w: int, align_corners: bool = False,
                         half_pixel_centers: bool = False):
    """Separable bilinear resize of a (..., H, W, C) float tensor: rows,
    then columns, each an interpolation-matrix contraction in x's dtype
    (the JAX lowering's matrices are x.dtype too)."""
    ah = _resize_matrix_on(x.shape[-3], out_h, align_corners, half_pixel_centers,
                           x.device).to(x.dtype)
    aw = _resize_matrix_on(x.shape[-2], out_w, align_corners, half_pixel_centers,
                           x.device).to(x.dtype)
    y = torch.einsum("oh,...hwc->...owc", ah, x)
    return torch.einsum("pw,...owc->...opc", aw, y)


@register("RESIZE_BILINEAR")
def resize_bilinear(ctx, node):
    size = ctx.const_value(node.inputs[1]).reshape(-1)
    o = node.options
    ctx.set(node.outputs[0], resize_bilinear_nhwc(
        ctx.get(node.inputs[0]), int(size[0]), int(size[1]),
        align_corners=o.get("align_corners", False),
        half_pixel_centers=o.get("half_pixel_centers", False)))
