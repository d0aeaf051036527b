"""Shape/data-movement lowerings: CONCATENATION, RESHAPE, RESIZE_BILINEAR,
SOFTMAX, PAD, SQUEEZE, EXPAND_DIMS, ARG_MAX.

RESIZE_BILINEAR is two dense interpolation-matrix contractions
(separable bilinear), as in ``backscrub_tpu/ops/misc.py``; the matrices
come from the same numpy ``resize_matrix``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from .common import apply_activation, register, scalar_like


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


@register("SQUEEZE")
def squeeze(ctx, node):
    # the loaders parse no SqueezeOptions: every unit axis goes, as in JAX
    x = ctx.get(node.inputs[0])
    dims = node.options.get("squeeze_dims")
    ctx.set(node.outputs[0], torch.squeeze(x, tuple(dims)) if dims else torch.squeeze(x))


@register("EXPAND_DIMS")
def expand_dims(ctx, node):
    axis = int(ctx.const_value(node.inputs[1]).reshape(-1)[0])
    ctx.set(node.outputs[0], torch.unsqueeze(ctx.get(node.inputs[0]), axis))


@register("SOFTMAX")
def softmax(ctx, node):
    x = ctx.get(node.inputs[0])
    x = x * scalar_like(node.options.get("beta", 1.0), x)
    if x.dtype == torch.bfloat16:
        # jax.nn.softmax op by op: exp(x - max) rounded, its sum in f32
        # rounded, the quotient rounded
        u = torch.exp(x - x.amax(-1, keepdim=True))
        y = u / u.float().sum(-1, keepdim=True).to(x.dtype)
    else:
        y = torch.softmax(x, dim=-1)
    ctx.set(node.outputs[0], y)


def pads_arg(pads) -> tuple:
    """A TFLite (ndim, 2) paddings array as ``F.pad``'s argument (last
    dimension first)."""
    return tuple(int(v) for lo_hi in np.asarray(pads)[::-1] for v in lo_hi)


@register("PAD")
def pad(ctx, node):
    x = ctx.get(node.inputs[0])
    ctx.set(node.outputs[0], F.pad(x, pads_arg(ctx.const_value(node.inputs[1]))))


@register("ARG_MAX")
def arg_max(ctx, node):
    axis = int(ctx.const_value(node.inputs[1]).reshape(-1)[0])
    ctx.set(node.outputs[0], torch.argmax(ctx.get(node.inputs[0]), dim=axis).to(torch.int32))


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
