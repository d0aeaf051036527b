"""Convolution lowerings: CONV_2D, DEPTHWISE_CONV_2D, FULLY_CONNECTED,
the builtin TRANSPOSE_CONV and the MediaPipe custom op
``Convolution2DTransposeBias``.

Weights are kept in the JAX executor's prepared layouts (``t{i}@hwio``,
``@dw``, ``@ko``, ``@tconv``), so one parameter dict serves both packages;
each lowering turns them into PyTorch's OIHW at the call.  SAME padding is
TFLite's (leading side gets the smaller half), applied with ``F.pad``.  In
bf16 every lowering runs in bf16 and rounds where the JAX lowering does:
once, after the bias (its dots sum in f32 to ``preferred_element_type``).

The transposed conv reproduces ``lib/transpose_conv_bias.cc:80-111``
(scatter accumulate) with the SAME shape math of ``:171-181``:
``pad_total = max(0, f - (in-1) % s - 1)``, leading crop ``pad_total // 2``,
``out = s*(in-1) + f - pad_total``.  The builtin TRANSPOSE_CONV takes its
output size from its constant input 0 and crops to it the same way.

On a mesh's "model" axis (``parallel/sharding.py``), each of the five
lowerings computes in the tp mode only this rank's output channels from
its slice of the kernel and bias (``ctx.column``; depthwise also takes only
its own input channels) and gathers the result; in the spatial mode a
convolution's input may arrive as the rows its output rows read
(``ctx.conv_input``), with SAME padding left only along W.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .common import apply_activation, register, tflite_same_padding


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1).contiguous()


def _same_pad(x, fh, fw, sh, sw, dh=1, dw=1):
    """Zero-pad an NCHW tensor for a TFLite SAME conv."""
    ph = tflite_same_padding(x.shape[2], fh, sh, dh)
    pw = tflite_same_padding(x.shape[3], fw, sw, dw)
    return F.pad(x, (pw[0], pw[1], ph[0], ph[1]))


def conv2d_nhwc(x, w_hwio, bias, stride, padding, dilation=(1, 1),
                activation="NONE", groups=1, pad_h=None):
    """NHWC conv with an HWIO kernel (HW1C for depthwise, ``groups`` = C);
    ``pad_h`` (lo, hi) overrides SAME's row padding."""
    xc = _nchw(x)
    fh, fw = w_hwio.shape[:2]
    if padding == "SAME" and pad_h is None:
        xc = _same_pad(xc, fh, fw, stride[0], stride[1], *dilation)
    elif padding == "SAME":
        pw = tflite_same_padding(xc.shape[3], fw, stride[1], dilation[1])
        xc = F.pad(xc, (pw[0], pw[1]) + tuple(pad_h))
    y = F.conv2d(xc, w_hwio.permute(3, 2, 0, 1), bias, stride=stride,
                 dilation=dilation, groups=groups)
    return apply_activation(_nhwc(y), activation)


def _bias(ctx, node, local=False):
    if len(node.inputs) > 2 and node.inputs[2] >= 0:
        return ctx.get_const(node.inputs[2], local=local)
    return None


def _column_out(ctx, cols, y):
    """The op's output: this rank's channels gathered whole in tp's column
    split, else as computed."""
    return ctx.tp.gather_channels(y) if cols else y


@register("CONV_2D")
def conv2d(ctx, node):
    o = node.options
    cols = ctx.column(node.inputs[1], "hwio")
    w = ctx.get_const(node.inputs[1], lambda a: np.transpose(a, (1, 2, 3, 0)),
                      variant="hwio",                       # OHWI -> HWIO
                      inverse=lambda a: np.transpose(a, (3, 0, 1, 2)), local=cols)
    x, pad_h = ctx.conv_input(node.inputs[0])
    if cols:
        x = ctx.tp.copy_in(x)
    ctx.set(node.outputs[0], _column_out(ctx, cols, conv2d_nhwc(
        x, w, _bias(ctx, node, cols), (o["stride_h"], o["stride_w"]), o["padding"],
        (o.get("dilation_h", 1), o.get("dilation_w", 1)), o.get("activation"),
        pad_h=pad_h)))


@register("DEPTHWISE_CONV_2D")
def depthwise_conv2d(ctx, node):
    x, pad_h = ctx.conv_input(node.inputs[0])
    o = node.options
    # a column split takes its own input channels: a channel multiplier of 1
    cols = (ctx.column(node.inputs[1], "dw")
            and ctx.graph.tensor(node.inputs[1]).shape[-1] == x.shape[-1])
    # TFLite (1, fh, fw, C*M) -> (fh, fw, 1, C*M); output channel c*M+m
    # reads input channel c, as a grouped conv with groups = C
    w = ctx.get_const(node.inputs[1], lambda a: np.transpose(a, (1, 2, 0, 3)),
                      variant="dw", inverse=lambda a: np.transpose(a, (2, 0, 1, 3)), local=cols)
    if cols:
        x = ctx.tp.own_channels(ctx.tp.copy_in(x))
    ctx.set(node.outputs[0], _column_out(ctx, cols, conv2d_nhwc(
        x, w, _bias(ctx, node, cols), (o["stride_h"], o["stride_w"]), o["padding"],
        (o.get("dilation_h", 1), o.get("dilation_w", 1)), o.get("activation"),
        groups=x.shape[-1], pad_h=pad_h)))


@register("FULLY_CONNECTED")
def fully_connected(ctx, node):
    x = ctx.get(node.inputs[0])
    cols = ctx.column(node.inputs[1], "ko")
    w = ctx.get_const(node.inputs[1], lambda a: np.transpose(a, (1, 0)),
                      variant="ko",                         # (O,K) -> (K,O)
                      inverse=lambda a: np.transpose(a, (1, 0)), local=cols)
    o = node.options
    lead = tuple(x.shape[:-1])
    x2 = x.reshape(-1, x.shape[-1])
    if cols:
        x2 = ctx.tp.copy_in(x2)
    b = _bias(ctx, node, cols)
    if b is not None and x.dtype == torch.bfloat16:
        y = torch.addmm(b, x2, w)      # one rounding after the bias, as JAX's f32 sum
    else:
        y = x2 @ w
        if b is not None:
            y = y + b
    y = _column_out(ctx, cols, apply_activation(y, o.get("activation")))
    shape = lead + (y.shape[1],) if o.get("keep_num_dims", False) \
        else (y.shape[0], y.shape[1])
    ctx.set(node.outputs[0], y.reshape(shape))


def transpose_conv_crop(in_size: int, filter_size: int, stride: int, padding: str):
    """(out size, leading crop) of the MediaPipe transposed conv."""
    pad_total = (max(0, filter_size - (in_size - 1) % stride - 1)
                 if padding == "SAME" else 0)
    return stride * (in_size - 1) + filter_size - pad_total, pad_total // 2


def _transpose_conv(ctx, node, x_idx, w_idx, bias_idx, sh, sw, padding, out_hw=None):
    """The transposed conv of both kinds: ``F.conv_transpose2d``'s whole
    output (s*(in-1) + f a side) cropped to (out size, leading crop) each
    way, zeros beyond it where the output is larger, then the bias.  The
    MediaPipe op's crop follows its SAME shape math; the builtin's output
    size ``out_hw`` is given."""
    x = ctx.get(x_idx)
    cols = ctx.column(w_idx, "tconv")
    # stored as the JAX executor's flipped HWIO: Wf[h, w, i, o] =
    # W_ohwi[o, fh-1-h, fw-1-w, i]; conv_transpose2d wants (I, O, fh, fw)
    wf = ctx.get_const(w_idx,
                       lambda a: np.transpose(a[:, ::-1, ::-1, :], (1, 2, 3, 0)),
                       variant="tconv",
                       inverse=lambda a: np.transpose(a, (3, 0, 1, 2))[:, ::-1, ::-1, :],
                       local=cols)
    if cols:
        x = ctx.tp.copy_in(x)
    wt = torch.flip(wf, (0, 1)).permute(2, 3, 0, 1)
    if out_hw is None:
        (oh, lh), (ow, lw) = (transpose_conv_crop(x.shape[1], wf.shape[0], sh, padding),
                              transpose_conv_crop(x.shape[2], wf.shape[1], sw, padding))
    else:
        (oh, lh), (ow, lw) = (builtin_transpose_conv_crop(x.shape[1], wf.shape[0], sh, out_hw[0]),
                              builtin_transpose_conv_crop(x.shape[2], wf.shape[1], sw, out_hw[1]))
    full_h, full_w = sh * (x.shape[1] - 1) + wf.shape[0], sw * (x.shape[2] - 1) + wf.shape[1]
    crop = (-lw, ow + lw - full_w, -lh, oh + lh - full_h)   # F.pad crops where < 0
    b = (ctx.get_const(bias_idx, local=cols)
         if bias_idx is not None and bias_idx >= 0 else None)
    if b is not None and x.dtype == torch.bfloat16 and max(crop) <= 0:
        # one rounding after the bias, as the JAX lowering's f32 sum
        y = F.pad(F.conv_transpose2d(_nchw(x), wt, b, stride=(sh, sw)), crop)
    else:
        y = F.pad(F.conv_transpose2d(_nchw(x), wt, stride=(sh, sw)), crop)
        if b is not None:
            y = y + b[None, :, None, None]
    ctx.set(node.outputs[0], _column_out(ctx, cols, _nhwc(y)))


@register("Convolution2DTransposeBias")
def conv2d_transpose_bias(ctx, node):
    # inputs: [data, weights, bias]; the MediaPipe SAME shape math
    o = node.options
    _transpose_conv(ctx, node, node.inputs[0], node.inputs[1], node.inputs[2],
                    o["stride_h"], o["stride_w"], o.get("padding", "SAME"))


def builtin_transpose_conv_crop(in_size: int, filter_size: int, stride: int,
                                out_size: int):
    """(out size, leading crop) of the builtin TRANSPOSE_CONV, whose output
    size is given: the total scatter padding max(0, (in-1)*s + f - out)
    (TFLite transpose_conv.cc ComputePadding), its smaller half leading,
    as ``backscrub_tpu/ops/conv.py:_conv_pads_for_output`` derives it."""
    return out_size, max(0, (in_size - 1) * stride + filter_size - out_size) // 2


@register("TRANSPOSE_CONV")
def transpose_conv(ctx, node):
    # inputs: [output_shape (constant), weights (OHWI), data, (bias)]; the
    # fused activation is not read, as in the JAX loader
    o = node.options
    out = ctx.const_value(node.inputs[0]).reshape(-1)
    _transpose_conv(ctx, node, node.inputs[2], node.inputs[1],
                    node.inputs[3] if len(node.inputs) > 3 else None,
                    o["stride_h"], o["stride_w"], o.get("padding", "SAME"),
                    out_hw=(int(out[1]), int(out[2])))
