"""Pooling lowerings: AVERAGE_POOL_2D, MAX_POOL_2D, MEAN (counterpart
of ``backscrub_tpu/ops/pool.py``).

TFLite SAME-padded average pooling divides by the number of valid window
elements, not by the window size; SAME max pooling pads with -inf.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import apply_activation, register, tflite_same_padding


@register("AVERAGE_POOL_2D")
def average_pool(ctx, node):
    x = ctx.get(node.inputs[0])
    o = node.options
    fh, fw = o["filter_h"], o["filter_w"]
    if o["padding"] == "VALID" and (fh, fw) == tuple(x.shape[1:3]):
        # global pooling (squeeze-excite blocks): a plain mean
        y = x.mean(dim=(1, 2), keepdim=True)
    else:
        xc = x.permute(0, 3, 1, 2)
        pad = (0, 0, 0, 0)
        if o["padding"] == "SAME":
            ph = tflite_same_padding(x.shape[1], fh, o["stride_h"])
            pw = tflite_same_padding(x.shape[2], fw, o["stride_w"])
            pad = (pw[0], pw[1], ph[0], ph[1])
        # the mean over the padded window, rescaled by the share of it that
        # is unpadded (exactly 1 where no padding is in the window)
        k, s = (fh, fw), (o["stride_h"], o["stride_w"])
        ones = xc.new_ones((1, 1) + tuple(xc.shape[2:]))
        y = F.avg_pool2d(F.pad(xc, pad), k, s) / F.avg_pool2d(F.pad(ones, pad), k, s)
        y = y.permute(0, 2, 3, 1)
    ctx.set(node.outputs[0], apply_activation(y, o.get("activation")))


@register("MAX_POOL_2D")
def max_pool(ctx, node):
    x = ctx.get(node.inputs[0])
    o = node.options
    k, s = (o["filter_h"], o["filter_w"]), (o["stride_h"], o["stride_w"])
    xc = x.permute(0, 3, 1, 2)
    if o["padding"] == "SAME":
        ph = tflite_same_padding(x.shape[1], k[0], s[0])
        pw = tflite_same_padding(x.shape[2], k[1], s[1])
        xc = F.pad(xc, (pw[0], pw[1], ph[0], ph[1]), value=float("-inf"))
    y = F.max_pool2d(xc, k, s).permute(0, 2, 3, 1)
    ctx.set(node.outputs[0], apply_activation(y, o.get("activation")))


def reduce_axes(ctx, node, x) -> tuple:
    """A reducer's axes (input 1), made non-negative."""
    return tuple(int(a) % x.ndim for a in ctx.const_value(node.inputs[1]).reshape(-1))


def upcast_reduce(x: torch.Tensor, fn) -> torch.Tensor:
    """``fn(x)`` computed in f32 and rounded once where x is bf16: jnp.sum,
    mean and prod upcast half floats for the computation."""
    return fn(x.float()).to(x.dtype) if x.dtype == torch.bfloat16 else fn(x)


@register("MEAN")
def mean(ctx, node):
    x = ctx.get(node.inputs[0])
    axes = reduce_axes(ctx, node, x)
    keep = node.options.get("keep_dims", False)
    ctx.set(node.outputs[0], upcast_reduce(x, lambda v: torch.mean(v, dim=axes, keepdim=keep))
            if axes else x)
