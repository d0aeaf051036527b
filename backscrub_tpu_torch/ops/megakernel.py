"""A span of the CNN body as a plan of ops, run as plain PyTorch or as one
launch of the persistent CUDA kernel of ``csrc/body_mega.cu``.

Counterpart of ``backscrub_tpu/ops/megakernel.py:BodyMega`` in its three
modes: the full span between the fused edge layers (``body_plan_for``,
K2), the prefix of a front-only family's body up to the 33x33, C >= 96
regime (``body_plan_prefix_for``, K2'), and the flat continuation through
that regime (``body_plan_continuation_for``, K2'').  :class:`BodyPlan`
walks the same node span with the same guards and compiles it into a
list of ops (1x1 conv / FC, depthwise, global pool, elementwise with
broadcast, activation, concat, 2x bilinear upsample, 1 -> N broadcast).
The TPU kernel's rowpad layout, lane spacing and grid masks have no
reason to exist on Hopper: every tensor is a plain (C, H*W) f32 array.
The lane-spacing bookkeeping survives only inside the guards, so that the
port accepts exactly the spans the JAX package accepts.

``BodyPlan(x)`` takes one input (C, H*W) or a stream batch (S, C, H*W).
On a CPU tensor it runs :meth:`BodyPlan.run_plain`; on a CUDA
tensor :meth:`BodyPlan.run_cuda` launches the plan as ONE persistent kernel
for the whole batch
(``bs_body_mega``, walking the :class:`MegaTable` that ``body_plan_for``,
``body_plan_prefix_for`` and ``body_plan_continuation_for`` compile); the
flat plan's spatial 1x1 convs run in it as the tensor-core GEMM, whose
standalone probe is :func:`conv1x1_gemm`: the wgmma tile
(``csrc/gemm_wg.cuh``, its weights laid out by :func:`lay_wgmma`) at three
terms (the bf16x3 split), one (the bf16 mode) or six ("highest").
Launches are counted in ``body_launch.launches``, ``body_launch.by_kernel``
and the plan's own ``launches``; the table ops they ran, by kind, in
``body_launch.table_ops``.

A plan's ``dots`` is the arithmetic of its 1x1 convs and FCs (the dots of
the JAX plan): "f32" (HIGHEST), "bf16x3" (a flat plan's GEMMs at HIGH, the
split on the tensor cores; its other dots f32), "bf16x6" (a flat plan's
GEMMs at HIGHEST, the TPU's six bf16 passes on the tensor cores; its other
dots f32) or "bf16" (DEFAULT, the
bf16 mode: both operands of every dot rounded to bf16, products summed in
f32, as the JAX kernel's interpret mode rounds them).  Depthwise, pool,
elementwise and resize ops are f32 in every mode.  :func:`dots_for` maps a
precision to it; ``run_plain(x, gemm=plan.dots)`` is the kernel's twin.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import _build
from .common import apply_activation, tflite_same_padding
from .misc import resize_matrix

SUPPORTED = {
    "CONV_2D", "DEPTHWISE_CONV_2D", "FULLY_CONNECTED", "AVERAGE_POOL_2D",
    "ADD", "MUL", "RELU", "RELU6", "HARD_SWISH", "LOGISTIC",
    "RESIZE_BILINEAR", "CONCATENATION",
}
ACTIVATIONS = {None, "NONE", "RELU", "RELU6", "HARD_SWISH", "LOGISTIC"}
# activation codes of csrc/body_act.cuh:activate
_ACT_CODES = {"NONE": 0, "RELU": 1, "RELU6": 2, "HARD_SWISH": 3, "LOGISTIC": 4}


class Unsupported(Exception):
    pass


# the body's precisions (models/specs.py:ModelSpec.mxu_precision) and the
# plans' dot modes, each with (the kernel's instantiation it runs, its GEMM
# tile's terms, the bf16 pieces of W those terms read): csrc/body_mega.cu
# bs_body_mega's ``dots`` (0 = f32 FFMA dots and bf16x3 GEMMs, 1 = bf16, 2 =
# f32 FFMA dots and bf16x6 GEMMs), the GEMM's terms (gemm_wg.cuh's TERMS),
# and hi; hi, lo; hi, lo, lo2
PRECISIONS = ("highest", "high", "default")
DOT_MODES = {"f32": (0, 3, 2), "bf16x3": (0, 3, 2), "bf16": (1, 1, 1), "bf16x6": (2, 6, 3)}
DOTS = tuple(DOT_MODES)
GEMM_PIECES = {terms: pieces for _, terms, pieces in DOT_MODES.values()}


def dots_for(precision: str, flat: bool) -> str:
    """The dot mode of a plan at ``precision``: "default" is one bf16 pass
    ("bf16"); "highest" and "high" are f32 dots, but a flat plan's (K2'')
    GEMMs, which compute the TPU's HIGHEST as six bf16 passes ("bf16x6")
    at "highest" and the bf16x3 split at "high", as the JAX flat
    continuation does (``backscrub_tpu/ops/megakernel.py:473-517``)."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
    if precision == "default":
        return "bf16"
    if not flat:
        return "f32"
    return "bf16x6" if precision == "highest" else "bf16x3"


def bf16_round(a: torch.Tensor) -> torch.Tensor:
    """``a`` rounded to the nearest bf16 (ties to even), as f32."""
    return a.to(torch.bfloat16).float()


@dataclasses.dataclass
class _T:
    """Metadata of one live tensor: (c, rows*w) storage; ``sp`` is the
    reference rowpad lane spacing, kept for the acceptance guards only."""
    c: int
    rows: int
    w: int
    sp: int = 1
    vec: bool = False

    @property
    def size(self) -> int:
        return self.c * (1 if self.vec else self.rows * self.w)


def body_launch(name: str, *args, table_ops=None) -> None:
    """Launch one body kernel; ``body_launch.launches`` counts launches,
    ``body_launch.by_kernel`` counts them by exported kernel name and
    ``body_launch.table_ops`` the op table's ops (``table_ops``, a Counter
    by kind) that a ``bs_body_mega`` launch runs."""
    _build.launch(name, *args)
    body_launch.launches += 1
    body_launch.by_kernel[name] += 1
    if table_ops is not None:
        body_launch.table_ops.update(table_ops)


body_launch.launches = 0
body_launch.by_kernel = collections.Counter()
body_launch.table_ops = collections.Counter()

# The op table of csrc/body_mega.cu: one row of MEGA_DESC int32 an op, the
# fields in this order (the kernel's enum Field).  Operand offsets ("in",
# "out", "aux") are float offsets into the workspace, -1 the span input;
# weight offsets ("w", "b", "w1", "b1", "w2", "b2") are float offsets into
# the arena; "pinv" holds a float's bits; "pout" is the offset of the
# pooled vector a depthwise op writes ("pool") and an SE conv reads
# ("gate").
MEGA_FIELDS = ("code", "sync", "act", "act2", "in", "out", "aux", "w", "b",
               "c", "co", "h", "wd", "oh", "ow", "fh", "fw", "s", "d", "ph", "pw",
               "band", "n", "elt", "bvec", "gate", "res", "pact", "pinv", "hid",
               "w1", "b1", "act1", "w2", "b2", "actg", "pool", "pout", "tm", "tn", "cpi",
               "tile", "bn", "bufs")
MEGA_DESC = 48
MEGA_CODES = {"conv": 1, "fc": 2, "dw": 3, "gpool": 4, "elt": 5, "resize": 6, "copy": 7,
              "gemm": 8, "convw": 9}
MEGA_ELT = {"unary": 0, "ADD": 1, "MUL": 2, "bcast": 3}
# csrc/body_mega.cu's sizes: threads a CTA, the K a conv stages at once,
# the SE vectors' capacity, the SE gates a CTA holds at once (one an image
# of its next items), the depthwise band's input window (floats) and its
# deepest band.  In a batch's launch a conv or column-wise op stages a
# CTA's items into a ring of buffers (the row's ``bufs``: as many as fit
# the shared memory a CTA has, up to _MEGA_BUFS, at least one), the loads
# of the next bufs - 1 items in flight while one computes.
_MEGA_NT, _CONV_K, _SE_MAX_C, _SE_GATES, _MEGA_BUFS = 256, 320, 512, 8, 4
_DW_SMEM_FLOATS, _DW_MAX_BAND = 8192, 8
_DW_ITEM_FLOATS = 12288            # an item's windows, all its channels
# a conv's CTA tiles (rows, columns; _MEGA_NT / (rows * columns) thread
# groups split K), largest first.  A phase's items should not outnumber
# the CTAs (the H100's 132 SMs: one round of L2 round trips), nor an SE
# conv's 48 (each of its CTAs stages both FCs' weights).
_CONV_TILES = ((16, 16), (8, 16), (8, 8), (4, 8))
_MEGA_CTAS, _SE_CONV_CTAS = 132, 48
# a conv over at least a warp of columns a CTA runs column-wise (``convw``:
# csrc/body_mega.cu:convw_op, W and the CTA's columns in shared memory)
_CONVW_MIN_COLS = 32
_SE_W_FLOATS = 48 * 1024           # both SE FCs' weights, staged in shared memory

# a card's shared memory a CTA (the H100's 227 KB)
_MAX_SMEM = 232448

# the GEMM's wgmma tile (csrc/gemm_wg.cuh): 64 positions (its BM) by one of
# these widths of output channels (the table's and bs_gemm's ``tile``), a
# ring of 3 stages of 64 of K (BK), each a W block of the pieces laid out
# by lay_wgmma and an x slice of 64 rows of 68 floats
_WG_TILES = (16, 32, 48, 64, 80)
_WG_BM, _WG_BK, _WG_STAGES = 64, 64, 3


def _wg_smem_bytes(bn: int, terms: int) -> int:
    """The dynamic shared memory of a wgmma tile of width ``bn`` at
    ``terms`` (gemm_wg.cuh's SMEM_BYTES): the ring, 128 bytes of
    alignment, the stages' mbarriers."""
    block = GEMM_PIECES[terms] * bn * _WG_BK * 2
    return _WG_STAGES * (block + _WG_BK * (_WG_BM + 4) * 4) + 128 + 8 * _WG_STAGES


def _wg_seq_smem_bytes(bn: int, terms: int) -> int:
    """The dynamic shared memory of a table GEMM op's tile of width ``bn``
    at ``terms`` (gemm_wg.cuh's SEQ_SMEM_BYTES): the ring of
    :func:`_wg_smem_bytes`, then the K-group sums and the epilogue tile
    beside it, so that the next tile's slices load under the epilogue."""
    pieces = GEMM_PIECES[terms]
    return _wg_smem_bytes(bn, terms) + max(pieces * bn * 256, bn * (_WG_BM + 4) * 4)


def _wg_tile(co: int, L: int, ctas: int = _MEGA_CTAS) -> int:
    """The wgmma tile's width (an index of _WG_TILES) for a (co, L)
    output: the narrowest whose tiles fit one round over ``ctas`` (the most
    SMs at work, none twice), else the widest."""
    for i, bn in enumerate(_WG_TILES):
        if -(-co // bn) * -(-L // _WG_BM) <= ctas:
            return i
    return len(_WG_TILES) - 1


def lay_wgmma(pieces, bn: int) -> torch.Tensor:
    """W's bf16 ``pieces`` (1, 2 or 3 of (co, ci or more) from
    :func:`split_bf16`) as the wgmma tile of width ``bn`` reads them, 1-D
    bf16: for each tile of ``bn`` output channels and each K slice of
    _WG_BK, the slice's block [piece][bn / 8][_WG_BK / 8][8][8] (core
    matrices of 8 channels by 8 of K, row-major; zeros past co and K), the
    blocks in (tile, slice) order.  One bulk copy moves a block into a ring stage, whose
    wgmma descriptors read it as it is."""
    co = pieces[0].shape[0]
    cp, kq = co + (-co % bn), -(-pieces[0].shape[1] // _WG_BK) * _WG_BK
    w = torch.stack([F.pad(t, (0, kq - t.shape[1], 0, cp - co)) for t in pieces])
    w = w.reshape(len(pieces), cp // bn, bn // 8, 8, kq // _WG_BK, _WG_BK // 8, 8)
    return w.permute(1, 4, 0, 2, 5, 3, 6).contiguous().reshape(-1)


def unlay_wgmma(block: torch.Tensor, n: int, co: int, ci: int, bn: int):
    """The ``n`` pieces (co, ci) bf16 that :func:`lay_wgmma` laid out in
    ``block`` at width ``bn``."""
    cp, kq = co + (-co % bn), -(-ci // _WG_BK) * _WG_BK
    w = block[:n * cp * kq].reshape(cp // bn, kq // _WG_BK, n, bn // 8, _WG_BK // 8, 8, 8)
    w = w.permute(2, 0, 3, 5, 1, 4, 6).reshape(n, cp, kq)
    return [t[:co, :ci] for t in w]


class BodyPlan:
    """nodes[start:end] of a model's folded graph as a list of plan ops.

    ``__call__(x)`` takes (C_in, rows*w) f32 and returns (C_out,
    rows_out*w_out) f32 on the same device.

    ``allow_spaced_output``: the output may sit at a coarser reference
    lane spacing (a prefix span, whose stride-2 stages the reference
    bridges out with a lane slice; here the output is dense anyway).
    ``flat``: the reference's dense-layout mode (the continuation): no
    stride-2 depthwise, no geometry-changing resize, every spatial tensor
    keeps the input's shape, and 1x1 convs on spatial tensors run as the
    tensor-core GEMM (the table's ``gemm`` op).
    ``dots``: the 1x1 convs' and FCs' arithmetic (module docstring): "f32"
    or "bf16" on a plan that is not flat (None: "f32"), "bf16x3", "bf16x6"
    or "bf16" on a flat one (None: "bf16x3").  A quantized model has no plan
    (Unsupported), as in the reference.

    :meth:`compile_mega` (``body_plan_for``, ``body_plan_prefix_for`` and
    ``body_plan_continuation_for`` call it) compiles the plan into a
    :class:`MegaTable`; a CUDA run is one launch of ``bs_body_mega``, and
    a plan not compiled does not run on CUDA.
    """

    def __init__(self, model, start: int, end: int, in_tid: int, out_tid: int,
                 *, allow_spaced_output: bool = False, flat: bool = False,
                 dots: Optional[str] = None):
        allowed = ("bf16x3", "bf16", "bf16x6") if flat else ("f32", "bf16")
        dots = dots or allowed[0]
        if dots not in allowed:
            raise ValueError(f"a {'flat' if flat else 'non-flat'} plan's dots are one of "
                             f"{allowed}, got {dots!r}")
        if getattr(model, "quantize_mode", None):
            # host_params hold int8 kernels whose scales the plan would skip
            raise Unsupported(f"quantized model ({model.quantize_mode})")
        g = model.graph
        hp = model.host_params
        self.in_tid, self.out_tid = in_tid, out_tid
        self.flat, self.dots = flat, dots
        s = tuple(g.tensor(in_tid).shape)
        if len(s) != 4 or s[0] != 1:
            raise Unsupported(f"tensor {in_tid} shape {s}")
        in_meta = _T(c=int(s[3]), rows=int(s[1]), w=int(s[2]),
                     vec=(s[1] == 1 and s[2] == 1))
        if flat:
            rs = in_meta.w
        else:
            # the reference's row stride: the widest row plus the depthwise
            # reach (5x5 at sp <= 4, 3x3 at sp <= 8) must fit 128 or 256 lanes
            rs = 128 if in_meta.w + 8 <= 128 else 256
            if in_meta.w + 8 > 256:
                raise Unsupported(f"row width {in_meta.w} too large")
        self.meta: Dict[int, _T] = {in_tid: in_meta}
        self.plan: List[tuple] = []
        self.weights: List[np.ndarray] = []

        def wref(arr) -> int:
            self.weights.append(np.ascontiguousarray(arr))
            return len(self.weights) - 1

        def hparam(tid, variant):
            key = f"t{tid}@{variant}"
            if key not in hp:
                raise Unsupported(f"missing host param {key}")
            return np.asarray(hp[key], np.float32)

        def bias_of(node, n):
            if len(node.inputs) > 2 and node.inputs[2] >= 0:
                b = hp.get(f"t{node.inputs[2]}")
                if b is None:
                    raise Unsupported("missing bias")
                return np.asarray(b, np.float32).reshape(n)
            return np.zeros(n, np.float32)

        def inmeta(tid) -> _T:
            if tid not in self.meta:
                raise Unsupported(f"operand t{tid} not produced in-span")
            return self.meta[tid]

        def act_of(o) -> str:
            a = o.get("activation", "NONE")
            if a not in ACTIVATIONS:
                raise Unsupported(f"fused activation {a}")
            return a or "NONE"

        for node in g.nodes[start:end]:
            k = node.kind
            if k not in SUPPORTED:
                raise Unsupported(k)
            o = node.options
            out = node.outputs[0]
            if k == "CONV_2D":
                m = inmeta(node.inputs[0])
                w = hparam(node.inputs[1], "hwio")        # (fh, fw, ci, co)
                if w.shape[:2] != (1, 1) or o.get("stride_h", 1) != 1 \
                        or o.get("stride_w", 1) != 1:
                    raise Unsupported("non-1x1 body conv")
                co = w.shape[3]
                self.plan.append(("conv1x1", node.inputs[0], out,
                                  wref(w[0, 0].T), wref(bias_of(node, co)),
                                  act_of(o)))
                self.meta[out] = (_T(co, 1, 1, 1, vec=True) if m.vec
                                  else _T(co, m.rows, m.w, m.sp))
            elif k == "DEPTHWISE_CONV_2D":
                m = inmeta(node.inputs[0])
                if o.get("depth_multiplier", 1) != 1 or m.vec \
                        or o.get("padding") != "SAME":
                    raise Unsupported("dw variant")
                dil = o.get("dilation_h", 1)
                if o.get("dilation_w", 1) != dil:
                    raise Unsupported("anisotropic dw dilation")
                w = hparam(node.inputs[1], "dw")          # (fh, fw, 1, C)
                fh, fw = w.shape[0], w.shape[1]
                st = o.get("stride_h", 1)
                if o.get("stride_w", 1) != st or st not in (1, 2):
                    raise Unsupported("dw stride")
                if dil != 1 and st != 1:
                    raise Unsupported("dilated strided dw")
                if flat and st != 1:
                    raise Unsupported("flat dw stride")
                if not flat and m.w * m.sp + (fw - 1) * m.sp * dil > rs:
                    raise Unsupported("dw column reach exceeds row stride")
                om = (_T(m.c, m.rows, m.w, m.sp) if st == 1 else
                      _T(m.c, -(-m.rows // 2), -(-m.w // 2), m.sp * 2))
                self.plan.append((
                    "dw", node.inputs[0], out,
                    wref(w[:, :, 0, :].reshape(fh * fw, m.c).T),
                    wref(bias_of(node, m.c)), fh, fw, st, dil,
                    tflite_same_padding(m.rows, fh, st, dil)[0],
                    tflite_same_padding(m.w, fw, st, dil)[0], act_of(o)))
                self.meta[out] = om
            elif k == "FULLY_CONNECTED":
                m = inmeta(node.inputs[0])
                if not m.vec:
                    raise Unsupported("FC on spatial tensor")
                w = hparam(node.inputs[1], "ko")          # (K, O)
                co = w.shape[1]
                self.plan.append(("conv1x1", node.inputs[0], out, wref(w.T),
                                  wref(bias_of(node, co)), act_of(o)))
                self.meta[out] = _T(co, 1, 1, 1, vec=True)
            elif k == "AVERAGE_POOL_2D":
                m = inmeta(node.inputs[0])
                if m.vec or o.get("padding") != "VALID" \
                        or (o.get("filter_h"), o.get("filter_w")) != (m.rows, m.w):
                    raise Unsupported("non-global pool")
                self.plan.append(("gpool", node.inputs[0], out,
                                  1.0 / (m.rows * m.w), act_of(o)))
                self.meta[out] = _T(m.c, 1, 1, 1, vec=True)
            elif k in ("ADD", "MUL"):
                a, bb = node.inputs[0], node.inputs[1]
                ma, mb = inmeta(a), inmeta(bb)
                if ma.vec and not mb.vec:
                    a, bb, ma, mb = bb, a, mb, ma
                if mb.vec and not ma.vec:
                    if mb.c != ma.c:
                        raise Unsupported("broadcast channel mismatch")
                    self.plan.append(("bingate", k, a, bb, out, act_of(o)))
                elif (ma.c, ma.rows, ma.w, ma.sp, ma.vec) == \
                        (mb.c, mb.rows, mb.w, mb.sp, mb.vec):
                    self.plan.append(("binop", k, a, bb, out, act_of(o)))
                else:
                    raise Unsupported("binary shape mismatch")
                self.meta[out] = ma
            elif k in ("RELU", "RELU6", "HARD_SWISH", "LOGISTIC"):
                m = inmeta(node.inputs[0])
                if k == "LOGISTIC" and not m.vec:
                    raise Unsupported("spatial logistic (breaks pad zeros)")
                self.plan.append(("act", k, node.inputs[0], out))
                self.meta[out] = m
            elif k == "CONCATENATION":
                if o.get("axis", -1) not in (-1, 3) or act_of(o) != "NONE":
                    raise Unsupported("concat axis")
                ms = [inmeta(i) for i in node.inputs]
                if any(m.vec for m in ms) or len({(m.rows, m.w, m.sp)
                                                  for m in ms}) != 1:
                    raise Unsupported("concat operands")
                if any(m.c % 8 for m in ms[:-1]):
                    raise Unsupported("concat channel alignment")
                self.plan.append(("concat", tuple(node.inputs), out))
                self.meta[out] = _T(sum(m.c for m in ms), ms[0].rows,
                                    ms[0].w, ms[0].sp)
            elif k == "RESIZE_BILINEAR":
                m = inmeta(node.inputs[0])
                size = g.tensor(node.inputs[1]).data
                if size is None:
                    raise Unsupported("dynamic resize size")
                oh, ow = (int(v) for v in size.reshape(-1)[:2])
                ac = o.get("align_corners", False)
                hpc = o.get("half_pixel_centers", False)
                if m.vec:
                    # 1x1 -> oh x ow is a constant broadcast (the ASPP
                    # pooling branch); the reference spacing follows the
                    # spatial tensors of that size (a concat needs it equal)
                    sps = {mm.sp for mm in self.meta.values()
                           if not mm.vec and (mm.rows, mm.w) == (oh, ow)}
                    self.plan.append(("bcast", node.inputs[0], out))
                    self.meta[out] = _T(m.c, oh, ow, sps.pop() if len(sps) == 1 else 1)
                    continue
                if (oh, ow) == (m.rows, m.w):
                    # same size: an identity iff both interpolation
                    # matrices are exact identities (align_corners 33->33)
                    if not (np.array_equal(resize_matrix(m.rows, oh, ac, hpc),
                                           np.eye(oh, dtype=np.float32))
                            and np.array_equal(resize_matrix(m.w, ow, ac, hpc),
                                               np.eye(ow, dtype=np.float32))):
                        raise Unsupported("same-size non-identity resize")
                    self.plan.append(("act", "NONE", node.inputs[0], out))
                    self.meta[out] = m
                    continue
                if flat:
                    raise Unsupported("flat geometry-changing resize")
                if (oh, ow) != (2 * m.rows, 2 * m.w) or m.sp % 2:
                    raise Unsupported("non-2x resize")
                ri, rw = _taps(resize_matrix(m.rows, oh, ac, hpc))
                ci, cw = _taps(resize_matrix(m.w, ow, ac, hpc))
                self.plan.append(("resize2x", node.inputs[0], out, wref(ri),
                                  wref(rw), wref(ci), wref(cw)))
                self.meta[out] = _T(m.c, oh, ow, m.sp // 2)
            else:  # pragma: no cover
                raise Unsupported(k)

        if flat and any(not mm.vec and (mm.rows, mm.w, mm.sp) != (in_meta.rows, rs, 1)
                        for mm in self.meta.values()):
            raise Unsupported("flat span geometry change")
        if out_tid not in self.meta:
            raise Unsupported("output tensor not produced by span")
        self.in_meta, self.out_meta = in_meta, self.meta[out_tid]
        if self.out_meta.vec:
            raise Unsupported("span output is a pooled vector")
        if self.out_meta.sp != 1 and not allow_spaced_output:
            raise Unsupported("unbalanced strides: output spacing != 1")
        self.launches = 0
        self.mega: Optional[MegaTable] = None
        self.kernels_per_run: collections.Counter = collections.Counter()
        self.launches_per_run = 0
        self._layout()
        self._dev: Dict[torch.device, List[torch.Tensor]] = {}

    def compile_mega(self) -> "MegaTable":
        """Compile the plan into the op table and weight arena of the
        persistent kernel; CUDA runs become one ``bs_body_mega`` launch.
        Raises Unsupported where the table does not fit the kernel."""
        self.mega = MegaTable(self)
        self.kernels_per_run = collections.Counter({"bs_body_mega": 1})
        self.launches_per_run = 1
        return self.mega

    # -- memory plan (CUDA) -------------------------------------------------

    def _layout(self):
        """Where concat operands live in the f32 workspace (whose offsets
        :class:`MegaTable` plans): an operand produced in-span by a
        non-concat op is placed inside the concat's own block at its
        channel offset (``_home``: tid -> (concat tid, float offset)), so
        the concat costs nothing; the others (the span input, another
        concat's output, a tensor a second concat also takes) are copied
        there (``_copies``), one table op each."""
        producer = {_out_tid(p): p[0] for p in self.plan}
        home: Dict[int, Tuple[int, int]] = {}   # tid -> (concat tid, float offset)
        self._copies: Dict[int, List[Tuple[int, int]]] = {}
        for p in self.plan:
            if p[0] != "concat":
                continue
            tins, tout = p[1], p[2]
            off, copies = 0, []
            for t in tins:
                if producer.get(t) not in (None, "concat") and t not in home:
                    home[t] = (tout, off)
                else:
                    copies.append((t, off))
                off += self.meta[t].size
            self._copies[tout] = copies
        self._home = home

    def work(self) -> Tuple[int, int]:
        """(bytes, flops) of one run at the least: the input, the weights
        and the output moved once (intermediates could stay on chip), and
        2 flops a multiply-add, 1 per elementwise, pooled or activation
        value, 8 per 2x-upsampled value; concats and broadcasts move data
        only."""
        flops = 0
        for p in self.plan:
            op = p[0]
            if op == "conv1x1":
                w = self.weights[p[3]]
                m = self.meta[p[1]]
                flops += 2 * w.shape[0] * w.shape[1] * (1 if m.vec else m.rows * m.w)
            elif op == "dw":
                om = self.meta[p[2]]
                flops += 2 * p[5] * p[6] * om.c * om.rows * om.w
            elif op in ("gpool", "act"):
                flops += self.meta[p[2] if op == "act" else p[1]].size
            elif op in ("binop", "bingate"):
                flops += self.meta[p[4]].size
            elif op == "resize2x":
                flops += 8 * self.meta[p[2]].size
        nbytes = 4 * (self.in_meta.size + self.out_meta.size
                      + sum(w.size for w in self.weights))
        return nbytes, flops

    def _weights_on(self, device) -> List[torch.Tensor]:
        if device not in self._dev:
            self._dev[device] = [torch.from_numpy(w).to(device) for w in self.weights]
        return self._dev[device]

    # -- execution -----------------------------------------------------------

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """The span on (C, H*W) or a stream batch (S, C, H*W)."""
        if x.device.type == "cpu":     # a bf16 plan's dots one bf16 pass, else f32
            return self.run_plain(x, "bf16" if self.dots == "bf16" else "f32")
        if x.device.type == "cuda":
            return self.run_cuda(x)
        raise ValueError(f"BodyPlan runs on cpu or cuda, not {x.device}")

    def _shape(self, tid):
        m = self.meta[tid]
        return (m.c, 1) if m.vec else (m.c, m.rows * m.w)

    def run_plain(self, x: torch.Tensor, gemm: str = "f32") -> torch.Tensor:
        """The plan in plain PyTorch on (C, H*W) tensors (any device).
        ``gemm="bf16x3"`` runs a flat plan's spatial 1x1 convs, the ops its
        table runs as ``gemm`` ops, as :func:`conv1x1_bf16x3_plain`
        (``"bf16x6"``: :func:`conv1x1_bf16x6_plain`);
        ``gemm="bf16"`` runs every 1x1 conv and FC, spatial or on a pooled
        vector, as :func:`conv1x1_bf16_plain`: each the kernel's own
        arithmetic in that mode (``gemm=self.dots``).  Every other op, and
        every op of the default ``"f32"``, is f32.  A stream batch (S, C,
        H*W) runs image by image, each image's bits those of its own call."""
        if gemm not in DOTS:
            raise ValueError(f"gemm must be one of {DOTS}, got {gemm!r}")
        if x.dim() == 3:
            return torch.stack([self.run_plain(xi, gemm) for xi in x])
        tensor_core = {"bf16x3": conv1x1_bf16x3_plain,
                       "bf16x6": conv1x1_bf16x6_plain}.get(gemm) if self.flat else None
        ws = self._weights_on(x.device)
        env = {self.in_tid: x.float().reshape(self._shape(self.in_tid))}
        for p in self.plan:
            op = p[0]
            if op == "conv1x1":
                _, tin, tout, wi, bi, act = p
                conv = (conv1x1_bf16_plain if gemm == "bf16"
                        else tensor_core if tensor_core and not self.meta[tin].vec
                        else conv1x1_plain)
                env[tout] = conv(ws[wi], ws[bi], env[tin], act)
            elif op == "dw":
                _, tin, tout, wi, bi, fh, fw, st, dil, plo_h, plo_w, act = p
                m, om = self.meta[tin], self.meta[tout]
                xi = env[tin].reshape(1, m.c, m.rows, m.w)
                ph = tflite_same_padding(m.rows, fh, st, dil)
                pw = tflite_same_padding(m.w, fw, st, dil)
                xi = F.pad(xi, (pw[0], pw[1], ph[0], ph[1]))
                y = F.conv2d(xi, ws[wi].reshape(m.c, 1, fh, fw), ws[bi],
                             stride=st, dilation=dil, groups=m.c)
                env[tout] = apply_activation(y.reshape(om.c, -1), act)
            elif op == "gpool":
                _, tin, tout, inv, act = p
                y = env[tin].sum(dim=1, keepdim=True) * inv
                env[tout] = apply_activation(y, act)
            elif op in ("binop", "bingate"):
                _, k, a, b, tout, act = p
                f = torch.add if k == "ADD" else torch.mul
                env[tout] = apply_activation(f(env[a], env[b]), act)
            elif op == "act":
                _, k, tin, tout = p
                env[tout] = apply_activation(env[tin], k)
            elif op == "concat":
                _, tins, tout = p
                env[tout] = torch.cat([env[t] for t in tins], dim=0)
            elif op == "bcast":
                _, tin, tout = p
                env[tout] = env[tin].expand(self._shape(tout))
            elif op == "resize2x":
                _, tin, tout, ri, rw, ci, cw = p
                m, om = self.meta[tin], self.meta[tout]
                ah = _dense(ws[ri], ws[rw], m.rows)
                aw = _dense(ws[ci], ws[cw], m.w)
                xi = env[tin].reshape(m.c, m.rows, m.w)
                y = torch.einsum("chw,pw->chp", xi, aw)
                y = torch.einsum("oh,chp->cop", ah, y)
                env[tout] = y.reshape(om.c, -1)
            else:  # pragma: no cover
                raise AssertionError(op)
        return env[self.out_tid]

    def run_cuda(self, x: torch.Tensor) -> torch.Tensor:
        """The plan on the card as one ``bs_body_mega`` launch on the
        current stream over the input or the whole stream batch, into one
        workspace (one image after another at ``ws_stride`` floats); the
        result is a view of the workspace, for a batch (S, C, H*W) with its
        images ``ws_stride`` floats apart."""
        buf, args = self._mega_args(x)
        body_launch("bs_body_mega", *args, None, table_ops=self.mega.kinds)
        self.launches += 1
        o, shape = self._offsets[self.out_tid], self._shape(self.out_tid)
        if x.dim() == 2:
            return buf[o:o + self.out_meta.size].view(shape)
        return buf.view(x.shape[0], -1)[:, o:o + self.out_meta.size].unflatten(1, shape)

    @property
    def ws_stride(self) -> int:
        """Floats between two images' workspaces: the plan's, rounded up
        to 256 bytes."""
        return -(-self._total // 64) * 64

    def phase_ns(self, x: torch.Tensor) -> List[int]:
        """A measurement run on the card: one ``bs_body_mega`` launch (not
        counted in ``body_launch``) that stamps the device clock after each
        phase's barrier; returns each phase's nanoseconds, barrier
        included.  Synchronizes."""
        _, args = self._mega_args(x)
        stamps = torch.zeros(self.mega.phases + 1, dtype=torch.int64, device=x.device)
        _build.launch("bs_body_mega", *args, stamps.data_ptr())
        return torch.diff(stamps).tolist()

    def phase_kinds(self, x: torch.Tensor, runs: int = 20) -> Dict[str, Tuple[int, float]]:
        """The phase clock by op kind: {label: (phases, ns)}, the median of
        ``runs`` :meth:`phase_ns` runs on ``x`` (one input or a stream
        batch) summed over the phases whose table ops carry that label:
        each op's kind with its fused extras ("conv+se" a conv that computes
        an SE gate, "dw+pool" a depthwise op that pools, "+res" an
        epilogue's residual), a phase's ops joined by " & ".
        Synchronizes."""
        ns = np.median(np.array([self.phase_ns(x) for _ in range(runs)]), axis=0)
        kinds: Dict[int, set] = collections.defaultdict(set)
        for m in self.mega.ops:
            kinds[m["level"]].add(m["kind"] + "".join(
                f"+{k}" for k in ("se", "pool", "res") if m.get(k) is not None))
        out: Dict[str, Tuple[int, float]] = {}
        for level, t in enumerate(ns, 1):
            label = " & ".join(sorted(kinds[level]))
            n, s = out.get(label, (0, 0.0))
            out[label] = (n + 1, s + float(t))
        return out

    def rows_on_card(self, x: torch.Tensor):
        """A check of the kernel op by op on the card: for each phase, the
        table's rows up to its end as one ``bs_body_mega`` launch (not
        counted in ``body_launch``) into a NaN workspace, and the phase's
        rows by :func:`walk_phase` from the previous launch's workspace, the
        kernel's own inputs.  Yields (phase, kind, kernel values, plain
        values, control) for each range a row wrote; the control is the
        plain row with the dots' activations unrounded (a bf16 table's bar
        must tell them apart).  Synchronizes."""
        snap = torch.full((self._total,), float("nan"), device=x.device)
        for k, (_, end) in enumerate(self.mega.phase_rows()):
            buf, args = self._mega_args(x, end)
            buf.fill_(float("nan"))
            _build.launch("bs_body_mega", *args, None)
            want, wrote = walk_phase(self, x, snap, k)
            ctl = walk_phase(self, x, snap, k, round_dots=False)[0]
            torch.cuda.synchronize(x.device)
            for kind, a, b in wrote:
                yield k, kind, buf[a:b], want[a:b], ctl[a:b]
            snap = buf

    def _mega_args(self, x: torch.Tensor, n_ops: Optional[int] = None):
        """(workspace, the launch's arguments up to the stamps) for x (C,
        H*W) or a batch (S, C, H*W) whose images are each contiguous, at
        any stride; ``n_ops`` runs the table's first rows alone (a check
        run)."""
        if self.mega is None:
            raise RuntimeError("BodyPlan.run_cuda: the plan has no op table "
                               "(compile_mega first)")
        shape = (self.in_meta.c, self.in_meta.rows * self.in_meta.w)
        if x.dim() == 3 and x.shape[0] < 1:
            raise ValueError("body input: an empty stream batch")
        img = x if x.dim() == 2 else x[0]
        _build.check_cuda(img, "body input", torch.float32, shape)
        n, x_stride = (1, img.numel()) if x.dim() == 2 else (x.shape[0], x.stride(0))
        buf = torch.empty(n * self.ws_stride, dtype=torch.float32, device=x.device)
        arena, table = self.mega.on(x.device)
        return buf, (x.data_ptr(), buf.data_ptr(), arena.data_ptr(), table.data_ptr(),
                     len(self.mega.ops) if n_ops is None else n_ops,
                     self.mega.smem_bytes if n == 1 else self.mega.smem_batch,
                     DOT_MODES[self.dots][0], n, x_stride, self.ws_stride)


def conv1x1_plain(w: torch.Tensor, b: torch.Tensor, x: torch.Tensor,
                  act: str = "NONE") -> torch.Tensor:
    """act(w @ x + b) in plain PyTorch (any device)."""
    return apply_activation(w @ x + b[:, None], act)


def conv1x1_bf16_plain(w: torch.Tensor, b: torch.Tensor, x: torch.Tensor,
                       act: str = "NONE") -> torch.Tensor:
    """The bf16 mode's dot in plain PyTorch (any device): act(bf16(w) @
    bf16(x) + b), both operands rounded to bf16 and multiplied and summed
    in f32 (the products are exact), the reference's DEFAULT precision as
    its interpret mode computes it (``backscrub_tpu/ops/megakernel.py:
    487-518``); the GEMM's one-term arithmetic.  ``w`` may carry columns
    past x's rows (padding)."""
    return apply_activation(bf16_round(w[:, :x.shape[0]]) @ bf16_round(x) + b[:, None], act)


def _bf16_split(a: torch.Tensor, pieces: int = 2) -> Tuple[torch.Tensor, ...]:
    """a = hi + lo (+ lo2): hi = bf16_rn(a), lo = bf16_rn(a - hi) and, with
    ``pieces=3``, lo2 = bf16_rn(a - hi - lo), all bf16 (each difference is
    exact in f32)."""
    out, rest = [], a
    for _ in range(pieces):
        out.append(rest.to(torch.bfloat16))
        rest = rest - out[-1].float()
    return tuple(out)


def conv1x1_bf16x3_plain(w: torch.Tensor, b: torch.Tensor, x: torch.Tensor,
                         act: str = "NONE", split=None) -> torch.Tensor:
    """The GEMM's arithmetic in plain PyTorch (any device): the reference's
    HIGH split (``backscrub_tpu/ops/megakernel.py:501-515``), w_hi @ x_hi +
    w_hi @ x_lo + w_lo @ x_hi as three f32 matmuls of bf16-rounded
    operands (lo @ lo dropped), then the bias and the activation.
    ``split``: w's (hi, lo) as :func:`split_bf16` makes them, given instead
    of ``w`` (None); columns past x's rows are padding."""
    if split is None:
        split = _bf16_split(w)
    wh, wl = (t[:, :x.shape[0]].float() for t in split)
    xh, xl = (t.float() for t in _bf16_split(x))
    return apply_activation(wh @ xh + wh @ xl + wl @ xh + b[:, None], act)


def conv1x1_bf16x6_plain(w: torch.Tensor, b: torch.Tensor, x: torch.Tensor,
                         act: str = "NONE", split=None) -> torch.Tensor:
    """The six-term GEMM's arithmetic in plain PyTorch (any device): the
    TPU's HIGHEST, which the JAX flat continuation asks of dot_general at
    "highest" (``backscrub_tpu/ops/megakernel.py:516-518``,
    ``backscrub_tpu/models/specs.py:26-28``): w and x each in three bf16
    pieces (:func:`_bf16_split`), the six products w_i @ x_j with i + j <= 2
    as f32 matmuls, summed as the kernel adds its three accumulators,
    w0 x0 + ((w0 x1 + w1 x0) + (w0 x2 + w1 x1 + w2 x0)), then the bias and
    the activation.  ``split``: w's (hi, lo, lo2) as ``split_bf16(w, 3)``
    makes them, given instead of ``w`` (None); columns past x's rows are
    padding."""
    if split is None:
        split = _bf16_split(w, 3)
    w0, w1, w2 = (t[:, :x.shape[0]].float() for t in split)
    x0, x1, x2 = (t.float() for t in _bf16_split(x, 3))
    cross = (w0 @ x1 + w1 @ x0) + (w0 @ x2 + w1 @ x1 + w2 @ x0)
    return apply_activation(w0 @ x0 + cross + b[:, None], act)


def split_bf16(w: torch.Tensor, pieces: int = 2) -> Tuple[torch.Tensor, ...]:
    """The GEMM's weight operand: (hi, lo) bf16 of w (co, ci), with
    ``pieces=3`` (hi, lo, lo2) (:func:`_bf16_split`), each (co, ci rounded
    up to 8) with zero columns, contiguous."""
    pad = -w.shape[1] % 8
    return tuple(F.pad(t, (0, pad)).contiguous() for t in _bf16_split(w, pieces))


def gemm_config(co: int, ci: int, L: int, sms: int, terms: int = 3) -> Tuple[int, int, int]:
    """(tile, split, kchunk) of ``bs_gemm`` at ``terms`` for a (co, ci) by
    (ci, L) GEMM on a card with ``sms`` SMs, on the wgmma tile: a shallow K
    (ci < 256) at the table's width (:func:`_wg_tile`, one CTA an SM for
    one round), not split.  A deep K at three terms: the width and split
    (into 1, 2, 4 or 8 ranges of whole K slices of _WG_BK) whose CTAs fill
    the most of one round, ties to the fewest slices a CTA, then the
    narrower width; at one and six terms the table's width, split into the
    fewest ranges that fill the most of the SMs left.  Fitted to
    tools/sweep_gemm_tiles.py on the H100 at each term count."""
    if terms not in GEMM_PIECES:
        raise ValueError(f"terms must be 1, 3 or 6, got {terms}")
    deep, slices = ci + (-ci % 8) >= 256, -(-ci // _WG_BK)
    if deep and terms == 3:
        best = None
        for i, bn in enumerate(_WG_TILES):
            grid = -(-co // bn) * -(-L // _WG_BM)
            for want in (1, 2, 4, 8):
                per = -(-slices // want)
                split = -(-slices // per)
                key = (grid * split, -per, -i)
                if grid * split <= sms and (best is None or key > best[0]):
                    best = key, (i, split, _WG_BK * per)
        if best is not None:
            return best[1]
    tile = _wg_tile(co, L, sms)
    grid = -(-co // _WG_TILES[tile]) * -(-L // _WG_BM)
    split = min(max(1, sms // grid), slices) if deep else 1
    per = -(-slices // split)
    return tile, -(-slices // per), _WG_BK * per


def wgmma_weights(w: torch.Tensor, terms: int, L: int, split=None) -> torch.Tensor:
    """W (co, ci) as ``bs_gemm`` takes it at ``terms`` (1, 3 or 6) for an
    L-wide input on ``w``'s card: :func:`lay_wgmma` of its 1, 2 or 3 bf16
    pieces (``split``, as :func:`split_bf16` makes them, given or made
    here) at the width that :func:`gemm_config` picks."""
    n = GEMM_PIECES[terms]
    pieces = tuple(split_bf16(w, n) if split is None else split)[:n]
    if len(pieces) != n or any(t is None for t in pieces):
        raise ValueError(f"gemm weights: {terms} terms need {n} bf16 pieces")
    co, ci = w.shape
    for t, name in zip(pieces, ("hi", "lo", "lo2")):
        _build.check_cuda(t, f"gemm weights {name}", torch.bfloat16, (co, ci + (-ci % 8)))
    tile = gemm_config(co, ci, L, _build.sm_count(w.device), terms)[0]
    return lay_wgmma(pieces, _WG_TILES[tile])


def conv1x1_gemm(w: torch.Tensor, b: torch.Tensor, x: torch.Tensor,
                 act: str = "NONE", split=None, terms: int = 3) -> torch.Tensor:
    """The K2'' 1x1 conv alone: act(w @ x + b) for w (co, ci), b (co,) and
    x (ci, L) f32.  On CUDA tensors ``bs_gemm`` (``csrc/body_flat.cu``,
    counted in ``body_launch``), the table's wgmma tile
    (``csrc/gemm_wg.cuh``) as a standalone kernel, the per-shape probe of
    that code, at ``terms`` 3 (the bf16x3 split), 1 (the bf16 mode's one
    pass) or 6 (the six-term split of "highest"); ``split`` is W's pieces
    (``split_bf16(w, 2 | 1 | 3)``; (hi, None) will do for one term) or their
    layout for this L, :func:`wgmma_weights`, given or made here.  On CPU
    tensors :func:`conv1x1_plain` (three or six terms) or
    :func:`conv1x1_bf16_plain` (one)."""
    if terms not in GEMM_PIECES:
        raise ValueError(f"terms must be 1, 3 or 6, got {terms}")
    if x.device.type == "cpu":
        return (conv1x1_bf16_plain if terms == 1 else conv1x1_plain)(w, b, x, act)
    co, ci = w.shape
    _build.check_cuda(w, "gemm weights", torch.float32)
    _build.check_cuda(b, "gemm bias", torch.float32, (co,))
    _build.check_cuda(x, "gemm input", torch.float32)
    if x.ndim != 2 or x.shape[0] != ci:
        raise ValueError(f"gemm input: expected ({ci}, L), got {tuple(x.shape)}")
    L = x.shape[1]
    if not isinstance(split, torch.Tensor):
        split = wgmma_weights(w, terms, L, split)
    tile, nsplit, kchunk = gemm_config(co, ci, L, _build.sm_count(x.device), terms)
    bn = _WG_TILES[tile]
    n = GEMM_PIECES[terms] * (co + (-co % bn)) * -(-ci // _WG_BK) * _WG_BK
    _build.check_cuda(split, "gemm weights, laid out", torch.bfloat16, (n,))
    y = torch.empty((co, L), dtype=torch.float32, device=x.device)
    # the split-K partials, when the shape's config splits K
    part = (torch.empty(nsplit * co * L, dtype=torch.float32, device=x.device)
            if nsplit > 1 else None)
    body_launch("bs_gemm", split.data_ptr(), b.data_ptr(), x.data_ptr(), y.data_ptr(),
                None if part is None else part.data_ptr(), co, ci, L, _ACT_CODES[act], tile,
                nsplit, kchunk, terms)
    return y


def _out_tid(p: tuple) -> int:
    """The tensor a plan op writes: p[2] for conv1x1, dw, gpool, concat,
    resize2x and bcast."""
    if p[0] in ("binop", "bingate"):
        return p[4]
    return p[3] if p[0] == "act" else p[2]


def _taps(a: np.ndarray):
    """Two (index, weight) taps per row of an interpolation matrix, from
    its nonzeros; a row with one nonzero gets a zero-weight second tap."""
    n = a.shape[0]
    idx = np.zeros((n, 2), np.int32)
    wt = np.zeros((n, 2), np.float32)
    for r in range(n):
        nz = np.nonzero(a[r])[0]
        if len(nz) > 2:
            raise Unsupported("resize row taps")
        idx[r, :len(nz)] = nz
        idx[r, len(nz):] = nz[0]
        wt[r, :len(nz)] = a[r, nz]
    return idx, wt


def _dense(idx: torch.Tensor, wt: torch.Tensor, n_in: int) -> torch.Tensor:
    """The (n_out, n_in) interpolation matrix back from its taps."""
    m = torch.zeros((idx.shape[0], n_in), dtype=torch.float32, device=idx.device)
    return m.scatter_add_(1, idx.long(), wt)


class MegaTable:
    """A :class:`BodyPlan` compiled for ``csrc/body_mega.cu``.

    ``ops``: the table's ops in run order, each a dict (``kind``, operand
    tensor ids, fused extras, ``idx``: the plan ops it covers, ``level``:
    its phase, 1-based); ``table``: (len(ops), MEGA_DESC) int32 rows of
    MEGA_FIELDS; ``arena``: every weight, bias and resize tap the table
    reads, f32 (tap indices as exact floats; a ``gemm`` op's weight split
    into its 1, 2 or 3 bf16 pieces laid out for the wgmma tile by
    :func:`lay_wgmma`, two bf16 to a float);
    ``phases``: the number of
    phases, each but the last ending in a barrier (``sync``);
    ``smem_bytes``: the dynamic shared memory a CTA needs in a one-image
    launch; ``smem_batch``: in a batch's (a conv or column-wise row stages
    its items in a ring of ``bufs`` buffers, as many as fit up to
    _MEGA_BUFS; a GEMM row's ring has its epilogue space beside it);
    ``kinds``: the ops by kind; ``dots``: the plan's.  Raises Unsupported
    where an op does not fit the kernel's shared memory.  With
    ``dots="bf16"`` the arena holds every dot weight (1x1 convs, FCs, the
    SE FCs) rounded to bf16, and a ``gemm`` op's hi piece alone; the kernel
    rounds the activations.

    Each plan op becomes one table op (a flat plan's spatial 1x1 conv the
    ``gemm`` op, the tensor-core GEMM; another spatial 1x1 conv over
    at least _CONVW_MIN_COLS columns a CTA the column-wise ``convw``, else
    the tiled ``conv``), then these fusions, which keep the JAX plan's
    arithmetic but its summation order, merge ops:
    - a standalone activation runs in its producer's epilogue;
    - a residual ADD runs in the epilogue of the spatial 1x1 conv (or
      GEMM) that produces one operand;
    - the 1 -> N broadcast of a pooled-vector FC's output (the ASPP
      pooling branch) runs in the FC, which writes each output across the
      N columns;
    - a squeeze-excite block (global pool -> FC -> FC -> MUL gate): the
      pool runs in the depthwise op that produces the pooled tensor (one
      CTA a whole channel), the FCs and the gate in the prologue of the
      spatial 1x1 conv that consumes the gated tensor.
    Each fusion needs the fused-away tensor read once, by the fusing op,
    and not the span's output.  Ops are then levelled by their reads
    (level = 1 + the deepest op writing anything they read) and run level
    by level."""

    def __init__(self, plan: BodyPlan):
        self._plan, self.dots = plan, plan.dots
        ops = self._ops()
        while self._fuse_act(ops) or self._fuse_residual(ops) or self._fuse_se(ops) \
                or self._fuse_bcast(ops):
            pass
        level = {}
        for m in ops:
            deps = [d for t in self._reads(m) for d in self._writers(ops, t)]
            level[id(m)] = 1 + max((level[id(d)] for d in deps), default=0)
            m["level"] = level[id(m)]
        self.ops = sorted(ops, key=lambda m: m["level"])    # stable
        self.phases = max(m["level"] for m in self.ops)
        self.kinds = collections.Counter(m["kind"] for m in self.ops)
        self.covered = sorted({i for m in self.ops for i in m["idx"]}
                              | {i for i, p in enumerate(plan.plan) if p[0] == "concat"})
        self._memory()
        self._build_rows()
        self._dev: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor]] = {}

    def on(self, device) -> Tuple[torch.Tensor, torch.Tensor]:
        """(arena, table) on ``device``, copied once."""
        if device not in self._dev:
            self._dev[device] = (torch.from_numpy(self.arena).to(device),
                                 torch.from_numpy(self.table).to(device))
        return self._dev[device]

    # -- the ops and the fusions ---------------------------------------------

    def _ops(self) -> List[dict]:
        plan, ops = self._plan, []
        for i, p in enumerate(plan.plan):
            op = p[0]
            m = dict(idx=[i], act="NONE", act2="NONE", res=None, se=None, aux=None)
            if op == "conv1x1":
                _, tin, tout, wi, bi, act = p
                mi = plan.meta[tin]
                kind = ("fc" if mi.vec else "gemm" if plan.flat
                        else "convw" if mi.rows * mi.w >= _CONVW_MIN_COLS * _MEGA_CTAS
                        else "conv")
                m.update(kind=kind, src=tin, out=tout, w=wi, b=bi, act=act)
            elif op == "dw":
                _, tin, tout, wi, bi, fh, fw, st, dil, ph, pw, act = p
                m.update(kind="dw", src=tin, out=tout, w=wi, b=bi, fh=fh, fw=fw, s=st,
                         d=dil, ph=ph, pw=pw, act=act)
            elif op == "gpool":
                m.update(kind="gpool", src=p[1], out=p[2], inv=p[3], act=p[4])
            elif op in ("binop", "bingate"):
                _, k, a, b, tout, act = p
                m.update(kind="elt", elt=k, src=a, aux=b, bvec=op == "bingate", out=tout,
                         act=act)
            elif op == "act":
                m.update(kind="elt", elt="unary", src=p[2], out=p[3], act=p[1], bvec=False)
            elif op == "bcast":
                m.update(kind="elt", elt="bcast", src=p[1], out=p[2], bvec=False)
            elif op == "resize2x":
                m.update(kind="resize", src=p[1], out=p[2], taps=p[3:7])
            if op != "concat":
                ops.append(m)
                continue
            for t, off in plan._copies[p[2]]:
                ops.append(dict(m, kind="copy", src=t, out=p[2], off=off))
        return ops

    @staticmethod
    def _reads(m) -> List[int]:
        r = [m["src"]]
        if m["kind"] == "elt" and m["elt"] in ("ADD", "MUL"):
            r.append(m["aux"])
        if m["res"] is not None:
            r.append(m["res"])
        if m["se"] is not None:
            r.append(m["se"]["pout"])
        return r

    def _uses(self, ops, t) -> int:
        """How often tensor ``t`` is read: by ops, concats, the span output."""
        plan = self._plan
        return (sum(self._reads(m).count(t) for m in ops)
                + sum(p[1].count(t) for p in plan.plan if p[0] == "concat")
                + (t == plan.out_tid))

    @staticmethod
    def _producer(ops, t) -> Optional[dict]:
        return next((m for m in ops if m["kind"] != "copy" and (
            m["out"] == t or m.get("pool") is not None and m["pool"]["out"] == t)), None)

    def _band(self, m) -> int:
        """A depthwise op's output rows a CTA item: up to _DW_MAX_BAND, or
        the whole channel when it pools, within _DW_SMEM_FLOATS of input."""
        om = self._plan.meta[m["out"]]
        band = om.rows if m.get("pool") is not None else min(om.rows, _DW_MAX_BAND)
        while band > 1 and self._dw_window(m, band) > _DW_SMEM_FLOATS:
            band -= 1
        return band

    def _dw_window(self, m, band) -> int:
        """Floats of input a depthwise item of ``band`` output rows stages,
        a channel."""
        return ((band - 1) * m["s"] + (m["fh"] - 1) * m["d"] + 1) * self._plan.meta[m["src"]].w

    def _writers(self, ops, t) -> List[dict]:
        """The ops that write (part of) tensor ``t``: its producer, or for a
        concat output the writers of its operands and its copies."""
        concat = next((p for p in self._plan.plan if p[0] == "concat" and p[2] == t), None)
        if concat is None:
            m = self._producer(ops, t)
            return [] if m is None else [m]
        return ([d for u in concat[1] for d in self._writers(ops, u)]
                + [m for m in ops if m["kind"] == "copy" and m["out"] == t])

    @staticmethod
    def _absorb(ops, host, gone) -> None:
        """``host`` takes over ``gone``'s place in the run order (after all
        it reads) and its plan ops; ``gone`` leaves the list."""
        host["idx"] = host["idx"] + gone["idx"]
        i = next(k for k, m in enumerate(ops) if m is gone)
        j = next(k for k, m in enumerate(ops) if m is host)
        ops[i] = host
        del ops[j]

    def _fuse_act(self, ops) -> bool:
        for a in ops:
            if a["kind"] != "elt" or a["elt"] != "unary":
                continue
            p = self._producer(ops, a["src"])
            if p is None or p["kind"] not in ("conv", "convw", "gemm", "fc", "dw", "gpool",
                                              "elt") \
                    or self._uses(ops, a["src"]) != 1:
                continue
            slot = "act" if p["res"] is None else "act2"
            if p[slot] != "NONE":
                continue
            p[slot], p["out"] = a["act"], a["out"]
            self._absorb(ops, p, a)
            return True
        return False

    def _fuse_residual(self, ops) -> bool:
        for e in ops:
            if e["kind"] != "elt" or e["elt"] != "ADD" or e["bvec"]:
                continue
            cands = []
            for t, other in ((e["src"], e["aux"]), (e["aux"], e["src"])):
                p = self._producer(ops, t)
                if p is not None and p["kind"] in ("conv", "convw", "gemm") and p["res"] is None \
                        and self._uses(ops, t) == 1:
                    cands.append((next(k for k, m in enumerate(ops) if m is p), p, other))
            if not cands:
                continue
            _, p, other = max(cands, key=lambda c: c[0])
            p["res"], p["act2"], p["out"] = other, e["act"], e["out"]
            self._absorb(ops, p, e)
            return True
        return False

    def _fuse_bcast(self, ops) -> bool:
        for e in ops:
            if e["kind"] != "elt" or e["elt"] != "bcast":
                continue
            p = self._producer(ops, e["src"])
            if p is None or p["kind"] != "fc" or p.get("bn") or self._uses(ops, e["src"]) != 1:
                continue
            om = self._plan.meta[e["out"]]
            p["bn"], p["out"] = om.rows * om.w, e["out"]
            self._absorb(ops, p, e)
            return True
        return False

    def _fuse_se(self, ops) -> bool:
        meta, weights = self._plan.meta, self._plan.weights
        for g in ops:
            if not (g["kind"] == "elt" and g["elt"] == "MUL" and g["bvec"]
                    and g["act"] == "NONE"):
                continue
            conv = next((m for m in ops if m["kind"] == "conv" and m["src"] == g["out"]), None)
            f2 = self._producer(ops, g["aux"])
            f1 = f2 and self._producer(ops, f2["src"])
            pool = f1 and self._producer(ops, f1["src"])
            dw = pool and self._producer(ops, pool["src"])
            if conv is None or conv["se"] is not None or dw is None \
                    or (f1["kind"], f2["kind"], pool["kind"], dw["kind"]) \
                    != ("fc", "fc", "gpool", "dw") \
                    or pool["src"] != g["src"] or dw.get("pool") is not None \
                    or any(self._uses(ops, t) != 1
                           for t in (g["out"], g["aux"], f2["src"], f1["src"])):
                continue
            hid = weights[f1["w"]].shape[0]
            whole = self._dw_window(dw, meta[dw["out"]].rows) <= _DW_SMEM_FLOATS
            if meta[g["src"]].c > _SE_MAX_C or hid > _SE_MAX_C or not whole \
                    or _se_floats(meta[g["src"]].c, hid) > _SE_W_FLOATS:
                continue
            dw["pool"] = dict(out=pool["out"], inv=pool["inv"], act=pool["act"])
            conv["se"] = dict(pout=pool["out"], w1=f1["w"], b1=f1["b"], act1=f1["act"],
                              hid=hid, w2=f2["w"], b2=f2["b"], actg=f2["act"])
            conv["src"] = g["src"]
            dw["idx"] = dw["idx"] + pool["idx"]
            conv["idx"] = conv["idx"] + f1["idx"] + f2["idx"] + g["idx"]
            for m in (pool, f1, f2, g):
                ops.remove(m)
            return True
        return False

    # -- the workspace ---------------------------------------------------------

    def _memory(self) -> None:
        """The workspace plan (the plan's ``_offsets`` and ``_total``): each
        tensor a table op writes gets a block, 16-byte aligned (a concat's
        homed operands inside their concat's), live from the phase of its
        first writer to that of its last reader, the span output to the
        end (``live``: tid -> (first, last) phase).  Phases are ordered by
        the grid barrier, so a later tensor may take a block from the phase
        after its last read on: the lowest offset free over the tensor's
        first phase.  A dead tensor's block is reused, and the continuation's
        workspace stays in L2.  A stream batch holds one such workspace an
        image (:attr:`BodyPlan.ws_stride` floats apart), so S of them share
        the 50 MB L2: at S = 8 deeplab's prefix and continuation take 38.3
        and 39.0 MB (``chip_smoke.py``'s multi-stream phase prints them)."""
        plan, home = self._plan, self._plan._home
        root = {t: home[t][0] if t in home else t for t in plan.meta}
        span: Dict[int, List[int]] = {}
        for m in self.ops:
            lvl = m["level"]
            wrote = [m["out"]] + ([m["pool"]["out"]] if m.get("pool") is not None else [])
            for t in wrote + [t for t in self._reads(m) if t != plan.in_tid]:
                a = span.setdefault(root[t], [lvl, lvl])
                a[0], a[1] = min(a[0], lvl), max(a[1], lvl)
        span[root[plan.out_tid]][1] = self.phases + 1
        blocks, at = [], {}          # (offset, floats, last phase); root -> offset
        for r in sorted(span, key=lambda r: (span[r][0], r)):
            first, last = span[r]
            size = plan.meta[r].size + (-plan.meta[r].size % 4)
            off = 0
            for b0, b1 in sorted((o, o + n) for o, n, end in blocks if end >= first):
                if off + size <= b0:
                    break
                off = max(off, b1)
            at[r] = off
            blocks.append((off, size, last))
        plan._offsets = {t: at[r] + (home[t][1] if t in home else 0)
                         for t, r in root.items() if r in at}
        plan._total = max(o + n for o, n, _ in blocks)
        self.live = {t: tuple(span[r]) for t, r in root.items() if r in at}

    # -- the rows --------------------------------------------------------------

    def _build_rows(self) -> None:
        plan = self._plan
        chunks, where, pos = [], {}, 0

        bf16 = self.dots == "bf16"
        pieces = DOT_MODES[self.dots][2]    # a flat table's W pieces

        def arena(wi, form="", dot=False, bn=0):
            """Weight ``wi``'s float offset: as it is, transposed ("T"), or
            its ``pieces`` bf16 pieces (:func:`split_bf16`) laid out for the
            wgmma tile of width ``bn``, two bf16 to a float ("wg":
            :func:`lay_wgmma`); a ``dot`` operand rounded to bf16 in the
            bf16 mode; each chunk 16-byte aligned."""
            nonlocal pos
            key = (wi, form, dot and bf16, bn)
            if key not in where:
                a = np.asarray(plan.weights[wi], np.float32)
                if dot and bf16:
                    a = bf16_round(torch.from_numpy(a)).numpy()
                if form == "T":
                    a = a.T
                elif form == "wg":
                    block = lay_wgmma(split_bf16(torch.from_numpy(a), pieces), bn)
                    a = block.view(torch.int16).numpy().view(np.float32)
                a = a.ravel()
                where[key] = pos
                chunks.append(np.pad(a, (0, -a.size % 4)))
                pos += chunks[-1].size
            return where[key]

        def off(t):
            return -1 if t == plan.in_tid else plan._offsets[t]

        rows, one, smem = [], 0, 0     # a one-image launch's memory, a batch's
        room = _MAX_SMEM - len(self.ops) * MEGA_DESC * 4    # what the table leaves a CTA

        def buffered(need):
            """(buffers, bytes) of an op whose working memory is need(bufs)
            bytes: the most buffers, up to _MEGA_BUFS, that fit, at least
            one."""
            bufs = max([1] + [nb for nb in range(2, _MEGA_BUFS + 1) if need(nb) <= room])
            return bufs, need(bufs)

        for i, m in enumerate(self.ops):
            r = dict.fromkeys(MEGA_FIELDS, 0)
            sm = plan.meta[m["src"]]
            r.update(code=MEGA_CODES[m["kind"]], act=_ACT_CODES[m["act"]],
                     act2=_ACT_CODES[m["act2"]], **{"in": off(m["src"])},
                     out=off(m["out"]), c=sm.c,
                     n=1 if sm.vec else sm.rows * sm.w,
                     sync=int(i + 1 < len(self.ops)
                              and self.ops[i + 1]["level"] != m["level"]))
            k = m["kind"]
            if k in ("conv", "convw", "fc"):
                r.update(w=arena(m["w"], dot=True), b=arena(m["b"]),
                         co=plan.weights[m["w"]].shape[0], bn=m.get("bn") or 0)
                if m["res"] is not None:
                    r.update(res=1, aux=off(m["res"]))
                if m["se"] is not None:      # the FC weights transposed, (ci, co)
                    se = m["se"]
                    r.update(gate=1, pout=off(se["pout"]), hid=se["hid"],
                             w1=arena(se["w1"], "T", dot=True), b1=arena(se["b1"]),
                             act1=_ACT_CODES[se["act1"]], w2=arena(se["w2"], "T", dot=True),
                             b2=arena(se["b2"]), actg=_ACT_CODES[se["actg"]])
                if k == "conv":           # two tiles or the SE weights, then the SE vectors
                    co, L = r["co"], r["n"]
                    cap = _MEGA_CTAS if m["se"] is None else _SE_CONV_CTAS
                    fits = [t for t in _CONV_TILES if -(-co // t[0]) * -(-L // t[1]) <= cap]
                    tm, tn = fits[-1] if fits else _CONV_TILES[0]
                    r.update(tm=tm, tn=tn)
                    kc = min(sm.c, _CONV_K)
                    se_w = 0 if m["se"] is None else _se_floats(sm.c, m["se"]["hid"])
                    one = max(one, 4 * (max(kc * (tm + 1 + tn), se_w) + 2 * _SE_MAX_C + _MEGA_NT))
                    gates = 0 if m["se"] is None else (_SE_GATES + 1) * _SE_MAX_C
                    bufs, need = buffered(lambda nb: 4 * (
                        max(min(nb, 2) * kc * (tm + 1) + nb * kc * tn, se_w) + gates + _MEGA_NT))
                    r.update(bufs=bufs)
                    smem = max(smem, need)
                elif k == "convw":         # columns a CTA; W and the items' columns staged
                    cols = -(-r["n"] // _MEGA_CTAS)
                    one = max(one, 4 * (r["co"] * sm.c + sm.c * cols))
                    bufs, need = buffered(lambda nb: 4 * (r["co"] * sm.c + nb * sm.c * cols))
                    r.update(tn=cols, bufs=bufs)
                    smem = max(smem, need)
            elif k == "gemm":            # W's bf16 pieces laid out for the tile a round fills
                co = plan.weights[m["w"]].shape[0]
                tile = _wg_tile(co, r["n"])
                r.update(b=arena(m["b"]), co=co, tile=tile,
                         w=arena(m["w"], "wg", bn=_WG_TILES[tile]))
                terms = DOT_MODES[self.dots][1]
                one = max(one, _wg_smem_bytes(_WG_TILES[tile], terms))
                smem = max(smem, _wg_seq_smem_bytes(_WG_TILES[tile], terms))
                if m["res"] is not None:
                    r.update(res=1, aux=off(m["res"]))
            elif k in ("dw", "resize"):
                om = plan.meta[m["out"]]
                r.update(h=sm.rows, wd=sm.w, oh=om.rows, ow=om.w, c=om.c)
                if k == "resize":
                    ri, rw, ci, cw = (arena(w) for w in m["taps"])
                    r.update(w=ri, b=rw, w1=ci, w2=cw)
                else:       # channels an item: the fewest that keep items <= CTAs
                    band = self._band(m)
                    win, bands = self._dw_window(m, band), -(-om.rows // band)
                    if win > _DW_SMEM_FLOATS:
                        raise Unsupported(f"depthwise window of {win} floats")
                    groups = max(1, _MEGA_CTAS // bands)
                    cpi = max(1, min(-(-om.c // groups), _DW_ITEM_FLOATS // win))
                    slot = win + (-win % 4) + 8      # a window's slot: 16-byte chunks, slack
                    one = max(one, 4 * (cpi * slot + _MEGA_NT))
                    r.update(w=arena(m["w"]), b=arena(m["b"]), fh=m["fh"], fw=m["fw"],
                             s=m["s"], d=m["d"], ph=m["ph"], pw=m["pw"], band=band,
                             cpi=cpi)
                    if m.get("pool") is not None:
                        pl = m["pool"]
                        r.update(pool=1, pout=off(pl["out"]), pinv=_f32_bits(pl["inv"]),
                                 pact=_ACT_CODES[pl["act"]])
            elif k == "gpool":
                r.update(pinv=_f32_bits(m["inv"]))
            elif k == "elt":
                r.update(elt=MEGA_ELT[m["elt"]], bvec=int(m["bvec"]))
                if m["elt"] in ("ADD", "MUL"):
                    r.update(aux=off(m["aux"]))
                if m["elt"] == "bcast":
                    om = plan.meta[m["out"]]
                    r.update(n=om.rows * om.w)
            elif k == "copy":
                r.update(out=off(m["out"]) + m["off"], n=sm.size)
            rows.append([r[f] for f in MEGA_FIELDS] + [0] * (MEGA_DESC - len(MEGA_FIELDS)))
        self.table = np.asarray(rows, np.int32).reshape(len(rows), MEGA_DESC)
        self.arena = np.concatenate(chunks) if chunks else np.zeros(4, np.float32)
        # the table, then the ops' memory
        self.smem_bytes = self.table.nbytes + one
        self.smem_batch = self.table.nbytes + max(one, smem)
        if max(self.smem_bytes, self.smem_batch) > _MAX_SMEM:
            raise Unsupported(f"table needs {max(self.smem_bytes, self.smem_batch)} B of "
                              "shared memory a CTA")

    def phase_rows(self) -> List[Tuple[int, int]]:
        """Each phase's rows of ``table`` as [start, end) indices."""
        ends = [i + 1 for i in np.flatnonzero(self.table[:, MEGA_FIELDS.index("sync")])]
        return list(zip([0] + ends, ends + [len(self.table)]))


_FIELD = {f: i for i, f in enumerate(MEGA_FIELDS)}
_CODE_KINDS = {v: k for k, v in MEGA_CODES.items()}
_ELT_KINDS = {v: k for k, v in MEGA_ELT.items()}
_ACT_NAMES = {v: k for k, v in _ACT_CODES.items()}


def walk_phase(plan: BodyPlan, x: torch.Tensor, snap: torch.Tensor, phase: int,
               round_dots: bool = True) -> Tuple[torch.Tensor, List[Tuple[str, int, int]]]:
    """Phase ``phase`` (0-based) of ``plan.mega``'s table in plain PyTorch,
    row by row as ``csrc/body_mega.cu`` runs it, on ``x``'s device: every
    row reads the span input ``x`` and ``snap``, the workspace as the phase
    began, never a row of its own phase.  Returns (the workspace after the
    phase, each row's (kind, start, end) float ranges written).  A bf16
    table's dots take its arena's rounded weights and the activation
    operand rounded to bf16 (left as it is with ``round_dots=False``, a
    control), its ``gemm`` rows one bf16 pass on the arena's hi half; a
    bf16x3 table's ``gemm`` rows are :func:`conv1x1_bf16x3_plain` on both
    halves, a bf16x6 table's :func:`conv1x1_bf16x6_plain` on its three
    pieces."""
    mt, dev = plan.mega, x.device
    bf16 = mt.dots == "bf16"
    rnd = bf16_round if bf16 and round_dots else (lambda t: t)
    ar = mt.on(dev)[0] if dev.type == "cuda" else torch.from_numpy(mt.arena)
    ws, xf, wrote = snap.clone(), x.reshape(-1), []

    def rd(off, n):
        return (xf if off < 0 else snap[off:])[:n]

    def arr(off, *shape):
        return ar[off:off + int(np.prod(shape))].reshape(shape)

    start, end = mt.phase_rows()[phase]
    for row in mt.table[start:end]:
        d = {f: int(row[i]) for f, i in _FIELD.items()}
        kind, act, act2 = _CODE_KINDS[d["code"]], _ACT_NAMES[d["act"]], _ACT_NAMES[d["act2"]]
        c, n = d["c"], d["n"]
        inv = float(np.int32(d["pinv"]).view(np.float32))
        if kind == "gemm":      # W's bf16 pieces laid out for the wgmma tile
            co = d["co"]
            split = unlay_wgmma(ar[d["w"]:].view(torch.bfloat16), DOT_MODES[mt.dots][2], co, c,
                                _WG_TILES[d["tile"]])
            xi = rd(d["in"], c * n).reshape(c, n)
            if bf16:            # hi alone: the one-term GEMM
                y = apply_activation(split[0][:, :c].float() @ rnd(xi)
                                     + arr(d["b"], co)[:, None], act)
            else:
                y = (conv1x1_bf16x6_plain if len(split) == 3 else conv1x1_bf16x3_plain)(
                    None, arr(d["b"], co), xi, act, split=split)
            if d["res"]:
                y = apply_activation(y + rd(d["aux"], co * n).reshape(co, n), act2)
        elif kind in ("conv", "convw", "fc"):
            co = d["co"]
            xi = rd(d["in"], c * n).reshape(c, n)
            if d["gate"]:       # the FC weights are stored transposed
                hid = d["hid"]
                pool = rd(d["pout"], c)[:, None]
                h = apply_activation(arr(d["w1"], c, hid).T @ rnd(pool)
                                     + arr(d["b1"], hid)[:, None], _ACT_NAMES[d["act1"]])
                gate = apply_activation(arr(d["w2"], hid, c).T @ rnd(h)
                                        + arr(d["b2"], c)[:, None], _ACT_NAMES[d["actg"]])
                xi = xi * gate
            y = apply_activation(arr(d["w"], co, c) @ rnd(xi) + arr(d["b"], co)[:, None], act)
            if d["bn"]:         # the broadcast that followed the pooled FC
                y = y.expand(co, d["bn"])
            if d["res"]:
                y = apply_activation(y + rd(d["aux"], co * n).reshape(co, n), act2)
        elif kind == "dw":
            H, W, OH, OW = d["h"], d["wd"], d["oh"], d["ow"]
            fh, fw, s, dil = d["fh"], d["fw"], d["s"], d["d"]
            rh = max(0, (OH - 1) * s + (fh - 1) * dil + 1 - H - d["ph"])
            rw = max(0, (OW - 1) * s + (fw - 1) * dil + 1 - W - d["pw"])
            xi = F.pad(rd(d["in"], c * H * W).reshape(1, c, H, W), (d["pw"], rw, d["ph"], rh))
            y = F.conv2d(xi, arr(d["w"], c, 1, fh, fw), arr(d["b"], c), stride=s,
                         dilation=dil, groups=c)[0, :, :OH, :OW]
            y = apply_activation(y, act)
            if d["pool"]:       # one CTA holds the whole channel
                pooled = apply_activation(y.reshape(c, -1).sum(dim=1) * inv,
                                          _ACT_NAMES[d["pact"]])
                ws[d["pout"]:d["pout"] + c] = pooled
                wrote.append(("pool", d["pout"], d["pout"] + c))
        elif kind == "gpool":
            y = apply_activation(rd(d["in"], c * n).reshape(c, n).sum(dim=1) * inv, act)
        elif kind == "elt":
            op = _ELT_KINDS[d["elt"]]
            if op == "bcast":
                v = rd(d["in"], c)[:, None].expand(c, n)
            else:
                v = rd(d["in"], c * n).reshape(c, n)
            if op in ("ADD", "MUL"):
                u = rd(d["aux"], c if d["bvec"] else c * n).reshape(c, 1 if d["bvec"] else n)
                v = v + u if op == "ADD" else v * u
            y = apply_activation(v, act)
        elif kind == "resize":
            H, W, OH, OW = d["h"], d["wd"], d["oh"], d["ow"]
            ah = torch.zeros(OH, H, device=dev).scatter_add_(1, arr(d["w"], OH, 2).long(),
                                                             arr(d["b"], OH, 2))
            aw = torch.zeros(OW, W, device=dev).scatter_add_(1, arr(d["w1"], OW, 2).long(),
                                                             arr(d["w2"], OW, 2))
            y = torch.einsum("chw,pw->chp", rd(d["in"], c * H * W).reshape(c, H, W), aw)
            y = torch.einsum("oh,chp->cop", ah, y)
        else:
            y = rd(d["in"], n)
        y = y.reshape(-1)
        ws[d["out"]:d["out"] + y.numel()] = y
        wrote.append((kind, d["out"], d["out"] + y.numel()))
    return ws, wrote


def walk_table(plan: BodyPlan, x: torch.Tensor) -> torch.Tensor:
    """``plan.mega``'s whole table by :func:`walk_phase` from a NaN
    workspace (a row that read what no earlier phase wrote gives NaN);
    returns the span's output (C, H*W), or for a stream batch (S, C, H*W)
    each image's, image by image, as the kernel runs each image's rows on
    that image's workspace alone."""
    if x.dim() == 3:
        return torch.stack([walk_table(plan, xi) for xi in x])
    ws = torch.full((plan._total,), float("nan"), device=x.device)
    for k in range(plan.mega.phases):
        ws = walk_phase(plan, x, ws, k)[0]
    o = plan._offsets[plan.out_tid]
    return ws[o:o + plan.out_meta.size].reshape(plan.out_meta.c, -1)


def _se_floats(c: int, hid: int) -> int:
    """Shared floats of an SE block's two FC weights, each rounded up to 4."""
    return 8 * -(-c * hid // 4)


def _f32_bits(v: float) -> int:
    return int(np.float32(v).view(np.int32))


def body_plan_for(model, info, precision: str = "highest") -> Optional[BodyPlan]:
    """A BodyPlan for the edge span if the graph qualifies, else None
    (``body_mega_for``): both fused edge layers must be present, the model
    unquantized, and the output the tail's (K, oh/2, ow/2) input; its dots
    :func:`dots_for` ``precision``.  The plan comes compiled for the
    persistent kernel (:meth:`BodyPlan.compile_mega`); a table that does
    not compile is no plan."""
    if not (info.front_ok and info.tail_ok):
        return None
    try:
        plan = BodyPlan(model, info.body_start, info.body_end,
                        info.body_in_tensor, info.body_out_tensor,
                        dots=dots_for(precision, False))
    except Unsupported:
        return None
    oh, ow = model.output_shape[1:3]
    if (plan.out_meta.rows, plan.out_meta.w) != (oh // 2, ow // 2):
        return None
    return plan if _compiles(plan) else None


def _compiles(plan: BodyPlan) -> bool:
    """Compile ``plan`` for the persistent kernel; False where its table
    does not compile: then the span has no fused path and the model runs
    the classic stages (no per-op kernels take its place)."""
    try:
        plan.compile_mega()
    except Unsupported:
        return False
    return True


def _cuts(model, info, start: int, end: int, in_tid: int, min_nodes: int,
          body_output_crosses: bool = False):
    """The ends of nodes[start:end], longest first while at least
    ``min_nodes`` remain, where exactly one tensor it produces (``in_tid``
    included) is read after it; with ``body_output_crosses``, the body
    output counts as read when the span reaches the body's end.  Yields
    (end, that tensor's id)."""
    nodes = model.graph.nodes
    produced = {in_tid}
    for n in nodes[start:end]:
        produced.update(n.outputs)
    while end - start >= min_nodes:
        crossing = {t for n in nodes[end:info.body_end] for t in n.inputs if t in produced}
        if body_output_crosses and end == info.body_end and info.body_out_tensor in produced:
            crossing.add(info.body_out_tensor)
        if len(crossing) == 1:
            yield end, crossing.pop()
        end -= 1
        produced.difference_update(nodes[end].outputs)


def _first_plan(cuts, build):
    """(plan, end, tid) at the first of ``cuts`` where ``build(end, tid)``
    does not raise Unsupported, or None."""
    for end, tid in cuts:
        try:
            return build(end, tid), end, tid
        except Unsupported:
            pass
    return None


def _prefix_span(model, info):
    """From the body start up to the first node whose output has c >= 96 at
    rows <= 33 (the regime the continuation takes): (start, end)."""
    g = model.graph
    start = end = info.body_start
    for i in range(start, info.body_end):
        node = g.nodes[i]
        s = g.tensor(node.outputs[0]).shape
        if node.kind not in SUPPORTED or s is None or len(s) != 4 \
                or (s[3] >= 96 and s[1] <= 33):
            break
        end = i + 1
    return start, end


# body_plan_prefix_for's answer where no cut of the prefix span has one
# tensor crossing it: the reference then runs the whole body after the
# front through its lowerings (the segm family with a post option, whose
# decoder reads the span input and an early skip past every cut)
NO_CUT = "no cut"


def body_plan_prefix_for(model, info, *, min_nodes: int = 4, precision: str = "highest"):
    """K2': a BodyPlan over the longest qualifying prefix of a front-only
    family's body span (``body_mega_prefix_for``), None where the plan at
    every cut fails (a quantized model's always), or :data:`NO_CUT`.

    The span is :func:`_prefix_span`'s, cut back until exactly one tensor
    produced before the cut (the span input included) is read after it;
    its dots :func:`dots_for` ``precision``.  Returns (plan compiled, cut
    node index, cut tensor id)."""
    if not info.front_ok:
        return None
    start, end = _prefix_span(model, info)
    cuts = list(_cuts(model, info, start, end, info.body_in_tensor, min_nodes))
    if not cuts:
        return NO_CUT
    dots = dots_for(precision, False)
    found = _first_plan(cuts, lambda e, tid: BodyPlan(model, start, e, info.body_in_tensor,
                                                      tid, allow_spaced_output=True,
                                                      dots=dots))
    return found if found is not None and _compiles(found[0]) else None


def body_plan_continuation_for(model, info, start: int, in_tid: int, *,
                               min_nodes: int = 4, precision: str = "highest"):
    """K2'': one flat BodyPlan over the body after the prefix cut
    (``body_mega_continuation_for``), its dots :func:`dots_for`
    ``precision``, or None.

    The same search as the reference's first link: the longest run of
    supported 4-D nodes from ``start``, cut back until one tensor crosses
    the cut and the flat plan builds.  The reference splits that span
    into several kernels to fit a 40 MiB VMEM budget; here every tensor
    lives in one device workspace, so the span is one plan, and it ends
    where the reference's chain ends.  Returns (plan compiled, end node
    index, output tensor id)."""
    g = model.graph
    end = start
    for i in range(start, info.body_end):
        node = g.nodes[i]
        s = g.tensor(node.outputs[0]).shape
        if node.kind not in SUPPORTED or s is None or len(s) != 4:
            break
        end = i + 1
    dots = dots_for(precision, True)
    found = _first_plan(_cuts(model, info, start, end, in_tid, min_nodes,
                              body_output_crosses=True),
                        lambda e, tid: BodyPlan(model, start, e, in_tid, tid, flat=True,
                                                dots=dots))
    return found if found is not None and _compiles(found[0]) else None
