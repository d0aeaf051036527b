"""Extended op coverage beyond the bundled model families (counterpart of
``backscrub_tpu/ops/extended.py``).

Cheap, commonly emitted TFLite ops, so that arbitrary converted
segmentation and vision nets load: casts, unary math, reducers,
nearest-neighbour resize, mirror pad, space/depth moves, gathers.  Each is
one or a few PyTorch ops, as each JAX lowering is one jnp/lax call that
XLA fuses; nothing here is a kernel of its own.

Where PyTorch's call differs from the JAX one, the lowering follows JAX:

- GATHER: an index in [-n, 0) counts from the end; one outside [-n, n)
  gives the fill value of ``jnp.take``'s default mode (NaN for floats,
  the most negative value for signed integers, the largest for unsigned,
  True for bool), where ``index_select`` would raise;
- ONE_HOT: an index outside [0, depth) gives an all-off row, where
  ``F.one_hot`` would raise;
- MIRROR_PAD: both modes by index (mode 0 REFLECT, 1 SYMMETRIC), on any
  dimension;
- SUM, MEAN and REDUCE_PROD compute a bf16 input in f32 and round once,
  as jnp upcasts half floats for them, while CUMSUM rounds after every
  addition, as XLA's bf16 reduce_window does; a Python scalar meets a bf16
  tensor rounded to bf16 (``scalar_like``);
- GELU is the tanh form (``jax.nn.gelu``'s default): the loaders parse no
  GeluOptions;
- CAST truncates toward zero, ROUND rounds half to even, ARG_MIN takes
  the output tensor's dtype (ARG_MAX is always int32, ``ops/misc.py``);
- SPACE_TO_BATCH_ND / BATCH_TO_SPACE_ND put the block axes first, as in
  TF (how TF lowers dilated convolutions: DeepLabv3+/Xception exports).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .common import register, scalar_like
from .elementwise import _unary
from .misc import pads_arg
from .pool import reduce_axes, upcast_reduce


def torch_dtype(np_dtype) -> torch.dtype:
    """The PyTorch dtype of a numpy dtype (a graph tensor's)."""
    return torch.from_numpy(np.zeros(0, np_dtype)).dtype


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s tanh form; in bf16 op by op as the JAX source
    writes it, each step rounded to bf16."""
    if x.dtype != torch.bfloat16:
        return F.gelu(x, approximate="tanh")
    c, k = scalar_like(float(np.sqrt(2 / np.pi)), x), scalar_like(0.044715, x)
    cdf = 0.5 * (1.0 + torch.tanh(c * (x + k * (x * x * x))))
    return x * cdf


for _name, _fn in {
    "ABS": torch.abs, "NEG": torch.neg, "EXP": torch.exp, "LOG": torch.log,
    "SQRT": torch.sqrt, "RSQRT": torch.rsqrt, "SQUARE": torch.square,
    "FLOOR": torch.floor, "CEIL": torch.ceil, "ROUND": torch.round,
    "SIN": torch.sin, "COS": torch.cos, "ELU": F.elu, "GELU": gelu,
}.items():
    register(_name)(lambda ctx, node, _f=_fn: _unary(ctx, node, _f))


@register("POW")
def pow_op(ctx, node):
    ctx.set(node.outputs[0], torch.pow(ctx.get(node.inputs[0]), ctx.get(node.inputs[1])))


@register("SQUARED_DIFFERENCE")
def squared_difference(ctx, node):
    d = ctx.get(node.inputs[0]) - ctx.get(node.inputs[1])
    ctx.set(node.outputs[0], d * d)


@register("CAST")
def cast(ctx, node):
    out_t = ctx.graph.tensor(node.outputs[0])
    ctx.set(node.outputs[0], ctx.get(node.inputs[0]).to(torch_dtype(out_t.dtype)))


def _reduce(ctx, node, fn, upcast=False):
    x = ctx.get(node.inputs[0])
    axes = reduce_axes(ctx, node, x)
    keep = node.options.get("keep_dims", False)
    if not axes:
        y = x                       # a reduction over no axes is the identity
    elif upcast:
        y = upcast_reduce(x, lambda v: fn(v, axes, keep))
    else:
        y = fn(x, axes, keep)
    ctx.set(node.outputs[0], y)


def _prod(x, axes, keep):
    for a in sorted(axes, reverse=True):
        x = torch.prod(x, dim=a, keepdim=keep)
    return x


@register("SUM")
def sum_op(ctx, node):
    _reduce(ctx, node, lambda x, a, k: torch.sum(x, dim=a, keepdim=k), upcast=True)


@register("REDUCE_MAX")
def reduce_max(ctx, node):
    _reduce(ctx, node, lambda x, a, k: torch.amax(x, dim=a, keepdim=k))


@register("REDUCE_MIN")
def reduce_min(ctx, node):
    _reduce(ctx, node, lambda x, a, k: torch.amin(x, dim=a, keepdim=k))


@register("REDUCE_PROD")
def reduce_prod(ctx, node):
    _reduce(ctx, node, _prod, upcast=True)


def _nn_indices(in_size: int, out_size: int, align_corners: bool,
                half_pixel_centers: bool) -> np.ndarray:
    """TFLite ResizeNearestNeighbor source-index mapping
    (resize_nearest_neighbor.cc; a copy of the JAX package's):
    - legacy: floor(dst * in/out)
    - align_corners: round(dst * (in-1)/(out-1))
    - half_pixel_centers: floor((dst + 0.5) * in/out)
    """
    dst = np.arange(out_size, dtype=np.float64)
    if align_corners and out_size > 1:
        idx = np.rint(dst * (in_size - 1) / (out_size - 1))
    elif half_pixel_centers:
        idx = np.floor((dst + 0.5) * (in_size / out_size))
    else:
        idx = np.floor(dst * (in_size / out_size))
    return np.clip(idx, 0, in_size - 1).astype(np.int32)


def _index(rows, device) -> torch.Tensor:
    return torch.from_numpy(np.asarray(rows, np.int64)).to(device)


@register("RESIZE_NEAREST_NEIGHBOR")
def resize_nearest(ctx, node):
    x = ctx.get(node.inputs[0])
    size = ctx.const_value(node.inputs[1]).reshape(-1)
    o = node.options
    ac = o.get("align_corners", False)
    hpc = o.get("half_pixel_centers", False)
    rows = _nn_indices(x.shape[1], int(size[0]), ac, hpc)
    cols = _nn_indices(x.shape[2], int(size[1]), ac, hpc)
    y = x.index_select(1, _index(rows, x.device)).index_select(2, _index(cols, x.device))
    ctx.set(node.outputs[0], y)


def _mirror_rows(n: int, lo: int, hi: int, symmetric: bool) -> np.ndarray:
    """The source rows of a mirror-padded axis of n rows: REFLECT leaves
    the edge row out of the mirror image, SYMMETRIC repeats it."""
    i = np.arange(-lo, n + hi)
    edge = 1 if symmetric else 0
    i = np.where(i < 0, -i - edge, i)
    return np.where(i >= n, 2 * n - 2 + edge - i, i)


@register("MIRROR_PAD")
def mirror_pad(ctx, node):
    x = ctx.get(node.inputs[0])
    pads = ctx.const_value(node.inputs[1])
    symmetric = node.options.get("mode", 0) != 0
    for d, (lo, hi) in enumerate(np.asarray(pads).reshape(-1, 2)):
        if lo or hi:
            rows = _mirror_rows(x.shape[d], int(lo), int(hi), symmetric)
            x = x.index_select(d, _index(rows, x.device))
    ctx.set(node.outputs[0], x)


@register("PADV2")
def padv2(ctx, node):
    x = ctx.get(node.inputs[0])
    cval = float(ctx.const_value(node.inputs[2]).reshape(-1)[0])
    ctx.set(node.outputs[0], F.pad(x, pads_arg(ctx.const_value(node.inputs[1])),
                                   value=cval))


@register("SPACE_TO_DEPTH")
def space_to_depth(ctx, node):
    x = ctx.get(node.inputs[0])
    b = node.options.get("block_size", 2)
    n, h, w, c = x.shape
    y = x.reshape(n, h // b, b, w // b, b, c).permute(0, 1, 3, 2, 4, 5)
    ctx.set(node.outputs[0], y.reshape(n, h // b, w // b, b * b * c))


@register("DEPTH_TO_SPACE")
def depth_to_space(ctx, node):
    x = ctx.get(node.inputs[0])
    b = node.options.get("block_size", 2)
    n, h, w, c = x.shape
    y = x.reshape(n, h, w, b, b, c // (b * b)).permute(0, 1, 3, 2, 4, 5)
    ctx.set(node.outputs[0], y.reshape(n, h * b, w * b, c // (b * b)))


def _fill_value(dtype: torch.dtype):
    """``jnp.take``'s fill for an index out of range."""
    if dtype == torch.bool:
        return True
    if dtype.is_floating_point:
        return float("nan")
    info = torch.iinfo(dtype)
    return info.max if info.min == 0 else info.min


@register("GATHER")
def gather(ctx, node):
    x = ctx.get(node.inputs[0])
    idx = ctx.maybe_static(node.inputs[1])
    idx = (torch.from_numpy(np.array(idx)).to(x.device) if idx is not None
           else ctx.get(node.inputs[1]))
    axis = node.options.get("axis", 0) % x.ndim
    n = x.shape[axis]
    idx = idx.long()
    idx = torch.where(idx < 0, idx + n, idx)
    ok = (idx >= 0) & (idx < n)
    y = x.index_select(axis, torch.clamp(idx, 0, max(n - 1, 0)).reshape(-1))
    y = y.reshape(tuple(x.shape[:axis]) + tuple(idx.shape) + tuple(x.shape[axis + 1:]))
    ok = ok.reshape((1,) * axis + tuple(idx.shape) + (1,) * (x.ndim - axis - 1))
    ctx.set(node.outputs[0], torch.where(ok, y, torch.full_like(y, _fill_value(y.dtype))))


@register("TILE")
def tile(ctx, node):
    reps = ctx.const_value(node.inputs[1]).reshape(-1).astype(int)
    ctx.set(node.outputs[0], torch.tile(ctx.get(node.inputs[0]), tuple(int(r) for r in reps)))


@register("L2_NORMALIZATION")
def l2_normalization(ctx, node):
    x = ctx.get(node.inputs[0])
    ss = upcast_reduce(x * x, lambda v: torch.sum(v, dim=-1, keepdim=True))
    ctx.set(node.outputs[0], x * torch.rsqrt(ss + scalar_like(1e-12, x)))


@register("FLOOR_DIV")
def floor_div(ctx, node):
    ctx.set(node.outputs[0], torch.floor_divide(ctx.get(node.inputs[0]),
                                                ctx.get(node.inputs[1])))


@register("FLOOR_MOD")
def floor_mod(ctx, node):
    # TF FloorMod: the result has the divisor's sign (Python %), jnp.mod
    ctx.set(node.outputs[0], torch.remainder(ctx.get(node.inputs[0]),
                                             ctx.get(node.inputs[1])))


@register("ARG_MIN")
def arg_min(ctx, node):
    axis = int(ctx.const_value(node.inputs[1]).reshape(-1)[0])
    out_t = ctx.graph.tensor(node.outputs[0])
    ctx.set(node.outputs[0], torch.argmin(ctx.get(node.inputs[0]), dim=axis)
            .to(torch_dtype(out_t.dtype)))


@register("LOG_SOFTMAX")
def log_softmax(ctx, node):
    ctx.set(node.outputs[0], F.log_softmax(ctx.get(node.inputs[0]), dim=-1))


@register("BATCH_MATMUL")
def batch_matmul(ctx, node):
    x, y = ctx.get(node.inputs[0]), ctx.get(node.inputs[1])
    if node.options.get("adj_x", False):
        x = x.transpose(-1, -2)
    if node.options.get("adj_y", False):
        y = y.transpose(-1, -2)
    ctx.set(node.outputs[0], torch.matmul(x, y))


@register("FILL")
def fill(ctx, node):
    dims = tuple(int(d) for d in ctx.const_value(node.inputs[0]).reshape(-1))
    val = ctx.get(node.inputs[1])
    out_t = ctx.graph.tensor(node.outputs[0])
    ctx.set(node.outputs[0],
            val.reshape(()).to(torch_dtype(out_t.dtype)).expand(dims).contiguous())


@register("ZEROS_LIKE")
def zeros_like(ctx, node):
    ctx.set(node.outputs[0], torch.zeros_like(ctx.get(node.inputs[0])))


@register("ONE_HOT")
def one_hot(ctx, node):
    idx = ctx.get(node.inputs[0])
    depth = int(ctx.const_value(node.inputs[1]).reshape(-1)[0])
    on_v, off_v = ctx.get(node.inputs[2]), ctx.get(node.inputs[3])
    axis = node.options.get("axis", -1)
    hot = (idx[..., None] == torch.arange(depth, device=idx.device)).to(torch.float32)
    if axis != -1:
        hot = hot.movedim(-1, axis)
    out_t = ctx.graph.tensor(node.outputs[0])
    ctx.set(node.outputs[0], (hot * on_v + (1.0 - hot) * off_v).to(torch_dtype(out_t.dtype)))


def _cumsum_bf16(y: torch.Tensor, axis: int) -> torch.Tensor:
    """A bf16 cumulative sum rounded after every addition, left to right:
    XLA's reduce_window in bf16, which ``jnp.cumsum`` lowers to on the CPU
    (``torch.cumsum`` keeps an f32 running sum)."""
    acc = y.narrow(axis, 0, 1)
    outs = [acc]
    for i in range(1, y.shape[axis]):
        acc = acc + y.narrow(axis, i, 1)
        outs.append(acc)
    return torch.cat(outs, dim=axis)


@register("CUMSUM")
def cumsum(ctx, node):
    y = ctx.get(node.inputs[0])
    axis = int(ctx.const_value(node.inputs[1]).reshape(-1)[0]) % y.ndim
    rev = node.options.get("reverse", False)
    if rev:
        y = torch.flip(y, (axis,))
    y = _cumsum_bf16(y, axis) if y.dtype == torch.bfloat16 else torch.cumsum(y, dim=axis)
    if node.options.get("exclusive", False):
        y = torch.cat([torch.zeros_like(y.narrow(axis, 0, 1)),
                       y.narrow(axis, 0, y.shape[axis] - 1)], dim=axis)
    if rev:
        y = torch.flip(y, (axis,))
    ctx.set(node.outputs[0], y)


@register("SPACE_TO_BATCH_ND")
def space_to_batch_nd(ctx, node):
    x = ctx.get(node.inputs[0])
    block = ctx.const_value(node.inputs[1]).reshape(-1).astype(int)
    pads = ctx.const_value(node.inputs[2]).astype(int)
    bh, bw = int(block[0]), int(block[1])
    n, h, w, c = x.shape
    x = F.pad(x, (0, 0, int(pads[1][0]), int(pads[1][1]), int(pads[0][0]), int(pads[0][1])))
    h2, w2 = h + int(pads[0].sum()), w + int(pads[1].sum())
    y = x.reshape(n, h2 // bh, bh, w2 // bw, bw, c)
    y = y.permute(2, 4, 0, 1, 3, 5)  # (bh, bw, n, h2/bh, w2/bw, c)
    ctx.set(node.outputs[0], y.reshape(bh * bw * n, h2 // bh, w2 // bw, c))


@register("BATCH_TO_SPACE_ND")
def batch_to_space_nd(ctx, node):
    x = ctx.get(node.inputs[0])
    block = ctx.const_value(node.inputs[1]).reshape(-1).astype(int)
    crops = ctx.const_value(node.inputs[2]).astype(int)
    bh, bw = int(block[0]), int(block[1])
    nb, h, w, c = x.shape
    n = nb // (bh * bw)
    y = x.reshape(bh, bw, n, h, w, c).permute(2, 3, 0, 4, 1, 5)
    y = y.reshape(n, h * bh, w * bw, c)
    (ct, cb), (cl, cr) = crops
    ctx.set(node.outputs[0], y[:, int(ct):h * bh - int(cb), int(cl):w * bw - int(cr), :])
