"""Shape-plumbing lowerings: SHAPE, STRIDED_SLICE, PACK, UNPACK, SPLIT,
TRANSPOSE, SLICE (counterpart of ``backscrub_tpu/ops/shape_ops.py``).

The TFLite converter emits SHAPE -> STRIDED_SLICE -> PACK -> RESHAPE
chains for "flatten with dynamic batch" patterns (e.g. Keras MobileNetV3
heads).  Shapes are known before a run, so these chains fold to numpy
through ``ctx.static_vals`` (:meth:`LoweringCtx.set_static`), as they fold
at trace time under XLA; the data-path variants run PyTorch ops when an
input is a tensor of the run.
"""

from __future__ import annotations

import numpy as np
import torch

from .common import register


@register("SHAPE")
def shape_op(ctx, node):
    x = ctx.get(node.inputs[0])
    ctx.set_static(node.outputs[0], np.asarray(tuple(x.shape), np.int32))


def _strided_slice_args(ctx, node):
    begin = ctx.const_value(node.inputs[1]).reshape(-1).astype(int)
    end = ctx.const_value(node.inputs[2]).reshape(-1).astype(int)
    strides = ctx.const_value(node.inputs[3]).reshape(-1).astype(int) \
        if len(node.inputs) > 3 and node.inputs[3] >= 0 else np.ones_like(begin)
    o = node.options
    if o.get("ellipsis_mask", 0) or o.get("new_axis_mask", 0):
        raise NotImplementedError(
            "STRIDED_SLICE with ellipsis_mask/new_axis_mask is not supported")
    return begin, end, strides, o.get("begin_mask", 0), o.get("end_mask", 0), \
        o.get("shrink_axis_mask", 0)


def _build_slices(shape, begin, end, strides, bmask, emask, smask):
    """The index of a strided slice (a copy of the JAX package's): a
    slice a dimension, or an integer where the shrink mask drops it."""
    idx = []
    for d in range(len(begin)):
        b = None if (bmask >> d) & 1 else int(begin[d])
        e = None if (emask >> d) & 1 else int(end[d])
        s = int(strides[d])
        if (smask >> d) & 1:
            bb = int(begin[d]) % shape[d] if begin[d] < 0 else int(begin[d])
            idx.append(bb)  # integer index: drops the axis
        else:
            idx.append(slice(b, e, s))
    return tuple(idx)


def take_slices(x: torch.Tensor, idx) -> torch.Tensor:
    """``x[idx]`` with NumPy's meaning, negative steps included (a PyTorch
    slice takes positive steps only): an integer drops its axis."""
    d = 0
    for it in idx:
        if isinstance(it, int):
            x = x.select(d, it)
            continue
        if it.step is not None and it.step < 0:
            keep = list(range(x.shape[d]))[it]
            x = x.index_select(d, torch.tensor(keep, dtype=torch.long, device=x.device))
        else:
            x = x[(slice(None),) * d + (it,)]
        d += 1
    return x


@register("STRIDED_SLICE")
def strided_slice(ctx, node):
    begin, end, strides, bmask, emask, smask = _strided_slice_args(ctx, node)
    static = ctx.maybe_static(node.inputs[0])
    if static is not None:
        sl = _build_slices(static.shape, begin, end, strides, bmask, emask, smask)
        ctx.set_static(node.outputs[0], np.asarray(static[sl]))
        return
    x = ctx.get(node.inputs[0])
    sl = _build_slices(x.shape, begin, end, strides, bmask, emask, smask)
    ctx.set(node.outputs[0], take_slices(x, sl))


@register("PACK")
def pack(ctx, node):
    axis = node.options.get("axis", 0)
    statics = [ctx.maybe_static(i) for i in node.inputs]
    if all(s is not None for s in statics):
        # scalar elements may arrive as () or (1,) mixes; normalize
        if all(np.asarray(s).size == 1 for s in statics):
            statics = [np.asarray(s).reshape(()) for s in statics]
        ctx.set_static(node.outputs[0], np.stack(statics, axis=axis))
        return
    ctx.set(node.outputs[0], torch.stack([ctx.get(i) for i in node.inputs], dim=axis))


@register("UNPACK")
def unpack(ctx, node):
    axis = node.options.get("axis", 0)
    for out_idx, p in zip(node.outputs, torch.unbind(ctx.get(node.inputs[0]), dim=axis)):
        ctx.set(out_idx, p)


@register("SPLIT")
def split(ctx, node):
    # inputs: [axis (constant), data]; equal parts, as jnp.split
    axis = int(ctx.const_value(node.inputs[0]).reshape(-1)[0])
    x = ctx.get(node.inputs[1])
    n = len(node.outputs)
    if x.shape[axis] % n:
        raise ValueError(f"SPLIT of {x.shape[axis]} into {n} equal parts")
    for out_idx, p in zip(node.outputs, torch.split(x, x.shape[axis] // n, dim=axis)):
        ctx.set(out_idx, p)


@register("TRANSPOSE")
def transpose(ctx, node):
    perm = ctx.const_value(node.inputs[1]).reshape(-1).astype(int)
    ctx.set(node.outputs[0], ctx.get(node.inputs[0]).permute(*(int(p) for p in perm)))


@register("SLICE")
def slice_op(ctx, node):
    x = ctx.get(node.inputs[0])
    begin = ctx.const_value(node.inputs[1]).reshape(-1).astype(int)
    size = ctx.const_value(node.inputs[2]).reshape(-1).astype(int)
    idx = tuple(slice(int(b), None if s == -1 else int(b + s))
                for b, s in zip(begin, size))
    ctx.set(node.outputs[0], x[idx])
