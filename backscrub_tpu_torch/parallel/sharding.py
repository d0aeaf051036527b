"""Tensor and spatial parallelism inside the graph executor: the hook
that the JAX package gets from XLA's SPMD partitioner.

:class:`TensorParallel` rides a run of ``CompiledModel.raw_fn`` (the
executor's ``LoweringCtx.tp``) in one of two modes.

- **tp** (``spatial=False``): every model rank computes the same rows,
  so the ranks compute copies of one loss.  CONV_2D, DEPTHWISE_CONV_2D,
  FULLY_CONNECTED and the transposed conv compute only this rank's output
  channels from its slice of the weights (depthwise also takes only its
  own input channels) and all-gather the result over "model"
  (:class:`GatherFromModel`: the backward takes this rank's slice); their
  input goes through :class:`CopyToModel` (identity forward, all-reduce
  backward, which sums the input gradients of the channel slices).  Any
  other reader of a sharded parameter gets it whole, gathered the same
  way.
- **sp** (``spatial=True``): the image rows go over "model" too, so the
  ranks hold parts of the loss.  Weights are gathered whole for each op
  (:class:`GatherParts`: the backward sums over "model" and keeps this
  rank's slice, a reduce-scatter).  A tensor is row-sharded (each rank
  its H/m rows) or replicated.  A convolution on a row-sharded input
  takes the rows its outputs need from its neighbours (:class:`HaloRows`,
  the kernel's reach times the dilation, its output rows split evenly so
  the shard edges fall on the stride) and stays row-sharded.  The ops of
  ``ROW_LOCAL`` (elementwise, activations, a channel concat) stay
  row-sharded, taking a replicated operand's own rows where it has every
  row.  Every other op, and a convolution whose rows no longer divide by
  the model size (segm_lite's 96 rows reach 3 at /32), gathers its inputs'
  rows first (:class:`GatherParts` again) and its output is replicated:
  AVERAGE_POOL_2D (the squeeze-excite global pools), RESIZE_BILINEAR,
  RESHAPE, FULLY_CONNECTED, the transposed conv and a concat along
  another axis.  ``raw_fn`` then returns this rank's rows of the output
  (:meth:`TensorParallel.own_rows`).

A parameter's spec is ``parallel.mesh.param_sharding_spec``: its last
dimension, or None.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.distributed as dist

from .mesh import Mesh, all_gather_cat
from ..ops.common import tflite_same_padding

ROW_LOCAL = frozenset(("ADD", "SUB", "MUL", "DIV", "RELU", "RELU6", "LOGISTIC",
                       "HARD_SWISH", "DEQUANTIZE"))
CONVS = frozenset(("CONV_2D", "DEPTHWISE_CONV_2D"))


def _chunk(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = x.shape[dim] // dist.get_world_size(group)
    return x.narrow(dim, dist.get_rank(group) * n, n).contiguous()


class CopyToModel(torch.autograd.Function):
    """Identity forward; the backward all-reduces the gradient over the
    group (the input of a column-split op, whose channel slices each give
    a part of its gradient)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class GatherFromModel(torch.autograd.Function):
    """All-gather along ``dim`` forward; the backward keeps this rank's
    slice (the ranks hold copies of one loss)."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather_cat(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _chunk(g, ctx.dim, ctx.group), None, None


class GatherParts(torch.autograd.Function):
    """All-gather along ``dim`` forward; the backward sums the gradient
    over the group and keeps this rank's slice, a reduce-scatter (the
    ranks hold parts of the loss)."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather_cat(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        dist.all_reduce(g, group=ctx.group)
        return _chunk(g, ctx.dim, ctx.group), None, None


def _exchange(sends, recvs, group):
    """Post every (tensor, peer) send and receive at once and wait."""
    ops = [dist.P2POp(dist.isend, t, dist.get_global_rank(group, q), group) for t, q in sends]
    ops += [dist.P2POp(dist.irecv, t, dist.get_global_rank(group, q), group) for t, q in recvs]
    if ops:
        for w in dist.batch_isend_irecv(ops):
            w.wait()


def _overlap(a, b):
    return max(a[0], b[0]), min(a[1], b[1])


class HaloRows(torch.autograd.Function):
    """Rows [a, b) of a row-sharded (N, H, W, C) tensor, ``need[r]`` for
    this rank r, with zeros where they fall outside [0, H) (the conv's
    SAME padding): its own rows, and each neighbour's rows that it needs
    (``own[q]`` are rank q's rows).  The backward sends the gradient of
    the borrowed rows back to their owners and adds what it receives."""

    @staticmethod
    def forward(ctx, x, need, own, group):
        r = dist.get_rank(group)
        ctx.need, ctx.own, ctx.group, ctx.shape = need, own, group, x.shape
        (a, b), (o0, _) = need[r], own[r]
        win = x.new_zeros((x.shape[0], b - a) + tuple(x.shape[2:]))
        lo, hi = _overlap(need[r], own[r])
        if lo < hi:
            win[:, lo - a:hi - a] = x[:, lo - o0:hi - o0]
        sends, recvs, into = [], [], []
        for q in range(len(own)):
            if q == r:
                continue
            slo, shi = _overlap(need[q], own[r])
            if slo < shi:
                sends.append((x[:, slo - o0:shi - o0].contiguous(), q))
            rlo, rhi = _overlap(need[r], own[q])
            if rlo < rhi:
                buf = x.new_empty((x.shape[0], rhi - rlo) + tuple(x.shape[2:]))
                recvs.append((buf, q))
                into.append((rlo, rhi, buf))
        _exchange(sends, recvs, group)
        for rlo, rhi, buf in into:
            win[:, rlo - a:rhi - a] = buf
        return win

    @staticmethod
    def backward(ctx, g):
        need, own, group = ctx.need, ctx.own, ctx.group
        r = dist.get_rank(group)
        (a, _), (o0, _) = need[r], own[r]
        gx = g.new_zeros(ctx.shape)
        lo, hi = _overlap(need[r], own[r])
        if lo < hi:
            gx[:, lo - o0:hi - o0] += g[:, lo - a:hi - a]
        sends, recvs, into = [], [], []
        for q in range(len(own)):
            if q == r:
                continue
            rlo, rhi = _overlap(need[r], own[q])
            if rlo < rhi:
                sends.append((g[:, rlo - a:rhi - a].contiguous(), q))
            slo, shi = _overlap(need[q], own[r])
            if slo < shi:
                buf = g.new_empty((g.shape[0], shi - slo) + tuple(g.shape[2:]))
                recvs.append((buf, q))
                into.append((slo, shi, buf))
        _exchange(sends, recvs, group)
        for slo, shi, buf in into:
            gx[:, slo - o0:shi - o0] += buf
        return gx, None, None, None


def conv_rows(H: int, f: int, s: int, d: int, padding: str, m: int):
    """How a convolution of ``f`` taps (stride s, dilation d) over H
    row-sharded rows splits over m ranks: (output rows, the input rows
    [a, b) each rank needs, each rank's own input rows), or None where the
    input or output rows do not divide by m."""
    eff = (f - 1) * d + 1
    if padding == "SAME":
        lo, ho = tflite_same_padding(H, f, s, d)[0], -(-H // s)
    else:
        lo, ho = 0, (H - eff) // s + 1
    if H % m or ho % m or ho < m:
        return None
    hs, os_ = H // m, ho // m
    need = [(q * os_ * s - lo, ((q + 1) * os_ - 1) * s - lo + eff) for q in range(m)]
    return ho, need, [(q * hs, (q + 1) * hs) for q in range(m)]


class TensorParallel:
    """One mesh's tensor (and, ``spatial``, row) parallelism for the graph
    executor; ``specs`` maps each parameter key to its sharded dimension
    or None.  A quantized model (``__scale`` companions) is refused."""

    def __init__(self, mesh: Mesh, specs: Dict[str, Optional[int]], spatial: bool = False):
        if any(k.endswith("__scale") for k in specs):
            raise ValueError("an int8 model does not run on a mesh: quantization is "
                             "single-device and inference-only")
        self.mesh, self.specs, self.spatial = mesh, specs, spatial
        self.m, self.r = mesh.shape["model"], mesh.coord("model")
        self.group = mesh.group("model")

    # -- parameters ------------------------------------------------------
    def sharded(self, key: str) -> bool:
        return self.specs.get(key) is not None

    def column(self, key: str) -> bool:
        """Whether the op reading ``key`` as its kernel computes only this
        rank's output channels (tp mode and a sharded kernel)."""
        return not self.spatial and self.sharded(key)

    def whole(self, w: torch.Tensor, key: str) -> torch.Tensor:
        """A sharded parameter gathered whole, with the mode's backward."""
        fn = GatherParts if self.spatial else GatherFromModel
        return fn.apply(w, self.specs[key], self.group)

    # -- tp: the column split -------------------------------------------
    def copy_in(self, x: torch.Tensor) -> torch.Tensor:
        return CopyToModel.apply(x, self.group)

    def own_channels(self, x: torch.Tensor) -> torch.Tensor:
        n = x.shape[-1] // self.m
        return x[..., self.r * n:(self.r + 1) * n]

    def gather_channels(self, y: torch.Tensor) -> torch.Tensor:
        return GatherFromModel.apply(y, y.ndim - 1, self.group)

    # -- sp: row-sharded activations ------------------------------------
    def own_rows(self, H: int):
        """This rank's rows [lo, hi) of H: the even split, as the trainer
        splits its targets."""
        return H * self.r // self.m, H * (self.r + 1) // self.m

    def enter(self, ctx, idx: int) -> None:
        """The graph input: row-sharded where its rows divide by m."""
        x = ctx.env[idx]
        if self.spatial and x.ndim == 4 and x.shape[1] % self.m == 0:
            lo, hi = self.own_rows(x.shape[1])
            ctx.env[idx] = x[:, lo:hi].contiguous()
            ctx.rows[idx] = x.shape[1]

    def leave(self, ctx, idx: int) -> torch.Tensor:
        """This rank's rows of the graph output (sp), or the output."""
        y = ctx.env[idx] if idx in ctx.env else ctx.get(idx)
        if not self.spatial or idx in ctx.rows or y.ndim != 4:
            return y
        lo, hi = self.own_rows(y.shape[1])
        return y[:, lo:hi]

    def run_node(self, ctx, node, lowering) -> None:
        """Run one node in sp mode, keeping each activation's row state."""
        acts = [i for i in node.inputs if i >= 0 and i in ctx.env]
        sharded = [i for i in acts if i in ctx.rows]
        if not sharded:
            lowering(ctx, node)
            return
        H = ctx.rows[sharded[0]]
        if node.kind in CONVS:
            w = ctx.graph.tensor(node.inputs[1]).shape    # OHWI or (1, fh, fw, C*M)
            o = node.options
            plan = conv_rows(H, w[1], o["stride_h"], o.get("dilation_h", 1), o["padding"],
                             self.m)
            if plan is not None:
                ho, need, own = plan
                x = node.inputs[0]
                ctx.halo[x] = HaloRows.apply(ctx.env[x], need, own, self.group)
                try:
                    lowering(ctx, node)
                finally:
                    del ctx.halo[x]
                ctx.rows[node.outputs[0]] = ho
                return
        elif node.kind in ROW_LOCAL or (node.kind == "CONCATENATION" and
                                        node.options.get("axis", -1) in (-1, 3)):
            lo, hi = self.own_rows(H)
            full = [i for i in acts if i not in ctx.rows]
            if all(ctx.env[i].ndim < 4 or ctx.env[i].shape[1] in (1, H) for i in full):
                saved = {i: ctx.env[i] for i in full}
                for i in full:
                    if ctx.env[i].ndim == 4 and ctx.env[i].shape[1] == H > 1:
                        ctx.env[i] = ctx.env[i][:, lo:hi]
                try:
                    lowering(ctx, node)
                finally:
                    ctx.env.update(saved)
                ctx.rows[node.outputs[0]] = H
                return
        # gathered for this op only: the sharded rows stay for other readers
        saved = {i: ctx.env[i] for i in sharded}
        for i in sharded:
            ctx.env[i] = GatherParts.apply(ctx.env[i], 1, self.group)
        try:
            lowering(ctx, node)
        finally:
            ctx.env.update(saved)
