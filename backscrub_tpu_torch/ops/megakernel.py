"""A span of the CNN body as a plan of ops, run as plain PyTorch or as the
CUDA kernels of ``csrc/body.cu`` and ``csrc/body_flat.cu``.

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

``BodyPlan(x)`` on a CPU tensor runs :meth:`BodyPlan.run_plain`; on a CUDA
tensor it launches one kernel per op (:meth:`BodyPlan.run_cuda`), counted
in ``body_launch.launches``, ``body_launch.by_kernel`` and the plan's own
``launches``.
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
# activation codes of csrc/body.cu:activate
_ACT_CODES = {"NONE": 0, "RELU": 1, "RELU6": 2, "HARD_SWISH": 3, "LOGISTIC": 4}


class Unsupported(Exception):
    pass


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


def body_launch(name: str, *args) -> None:
    """Launch one body kernel; ``body_launch.launches`` counts launches and
    ``body_launch.by_kernel`` counts them by exported kernel name."""
    _build.launch(name, *args)
    body_launch.launches += 1
    body_launch.by_kernel[name] += 1


body_launch.launches = 0
body_launch.by_kernel = collections.Counter()

# kernel of each plan op kind on CUDA (conv1x1 and concat: see _kernels)
_OP_KERNELS = {"dw": "bs_dw", "gpool": "bs_gpool", "binop": "bs_eltwise",
               "bingate": "bs_eltwise", "act": "bs_eltwise",
               "resize2x": "bs_resize", "bcast": "bs_bcast"}


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
    tiled GEMM kernel of ``csrc/body_flat.cu``.
    """

    def __init__(self, model, start: int, end: int, in_tid: int, out_tid: int,
                 *, allow_spaced_output: bool = False, flat: bool = False):
        g = model.graph
        hp = model.host_params
        self.in_tid, self.out_tid = in_tid, out_tid
        self.flat = flat
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
        self._layout()
        self._dev: Dict[torch.device, List[torch.Tensor]] = {}

    # -- memory plan (CUDA) -------------------------------------------------

    def _layout(self):
        """Offsets of every in-span tensor in one f32 workspace.  A concat's
        operands produced in-span by a non-concat op are placed inside the
        concat's own block at their channel offsets, so the concat costs
        nothing; the others (the span input, another concat's output, a
        tensor a second concat also takes) are copied there, one kernel
        each."""
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
        self._offsets: Dict[int, int] = {}
        total = 0
        for tid, m in self.meta.items():
            if tid != self.in_tid and tid not in home:
                self._offsets[tid] = total
                total += m.size
        for tid, (root, off) in home.items():
            self._offsets[tid] = self._offsets[root] + off
        self._total = total
        self.kernels_per_run = collections.Counter(
            k for p in self.plan for k in self._kernels(p))
        self.launches_per_run = sum(self.kernels_per_run.values())

    def _kernels(self, p: tuple) -> List[str]:
        """The kernels plan op ``p`` launches on CUDA, in order."""
        if p[0] == "concat":
            return ["bs_copy"] * len(self._copies[p[2]])
        if p[0] == "conv1x1":
            spatial = not self.meta[p[1]].vec
            return ["bs_gemm" if self.flat and spatial else "bs_conv1x1"]
        return [_OP_KERNELS[p[0]]]

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
        if x.device.type == "cpu":
            return self.run_plain(x)
        if x.device.type == "cuda":
            return self.run_cuda(x)
        raise ValueError(f"BodyPlan runs on cpu or cuda, not {x.device}")

    def _shape(self, tid):
        m = self.meta[tid]
        return (m.c, 1) if m.vec else (m.c, m.rows * m.w)

    def run_plain(self, x: torch.Tensor) -> torch.Tensor:
        """The plan in plain PyTorch on (C, H*W) tensors (any device)."""
        ws = self._weights_on(x.device)
        env = {self.in_tid: x.float().reshape(self._shape(self.in_tid))}
        for p in self.plan:
            op = p[0]
            if op == "conv1x1":
                _, tin, tout, wi, bi, act = p
                env[tout] = conv1x1_plain(ws[wi], ws[bi], env[tin], act)
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
        """The plan as ``csrc/body.cu`` / ``csrc/body_flat.cu`` kernels, one
        launch per op (concat: one per copied operand), into one workspace
        on the current stream.  The result is a view of that workspace."""
        _build.check_cuda(x, "body input", torch.float32,
                          (self.in_meta.c, self.in_meta.rows * self.in_meta.w))
        ws = self._weights_on(x.device)
        buf = torch.empty(self._total, dtype=torch.float32, device=x.device)
        base, fs = buf.data_ptr(), 4

        def ptr(tid):
            return x.data_ptr() if tid == self.in_tid else base + fs * self._offsets[tid]

        def launch(name, *args):
            body_launch(name, *args)
            self.launches += 1

        for p in self.plan:
            op = p[0]
            if op == "conv1x1":
                _, tin, tout, wi, bi, act = p
                w = ws[wi]
                L = 1 if self.meta[tin].vec else self.meta[tin].rows * self.meta[tin].w
                launch(self._kernels(p)[0], w.data_ptr(), ws[bi].data_ptr(), ptr(tin),
                       ptr(tout), w.shape[0], w.shape[1], L, _ACT_CODES[act])
            elif op == "dw":
                _, tin, tout, wi, bi, fh, fw, st, dil, plo_h, plo_w, act = p
                m, om = self.meta[tin], self.meta[tout]
                launch("bs_dw", ptr(tin), ws[wi].data_ptr(), ws[bi].data_ptr(),
                       ptr(tout), m.c, m.rows, m.w, om.rows, om.w, fh, fw,
                       st, dil, plo_h, plo_w, _ACT_CODES[act])
            elif op == "gpool":
                _, tin, tout, inv, act = p
                m = self.meta[tin]
                launch("bs_gpool", ptr(tin), ptr(tout), m.c, m.rows * m.w,
                       inv, _ACT_CODES[act])
            elif op in ("binop", "bingate"):
                _, k, a, b, tout, act = p
                m = self.meta[a]
                launch("bs_eltwise", ptr(a), ptr(b), ptr(tout), m.c,
                       self._shape(a)[1], 1 if k == "ADD" else 2,
                       int(op == "bingate"), _ACT_CODES[act])
            elif op == "act":
                _, k, tin, tout = p
                c, L = self._shape(tin)
                launch("bs_eltwise", ptr(tin), None, ptr(tout), c, L, 0, 0,
                       _ACT_CODES[k])
            elif op == "concat":
                _, tins, tout = p
                for t, off in self._copies[tout]:
                    launch("bs_copy", ptr(t), ptr(tout) + fs * off, self.meta[t].size)
            elif op == "resize2x":
                _, tin, tout, ri, rw, ci, cw = p
                m, om = self.meta[tin], self.meta[tout]
                launch("bs_resize", ptr(tin), ws[ri].data_ptr(),
                       ws[rw].data_ptr(), ws[ci].data_ptr(), ws[cw].data_ptr(),
                       ptr(tout), m.c, m.rows, m.w, om.rows, om.w)
            elif op == "bcast":
                _, tin, tout = p
                launch("bs_bcast", ptr(tin), ptr(tout), *self._shape(tout))
        o = self._offsets[self.out_tid]
        return buf[o:o + self.out_meta.size].view(self._shape(self.out_tid))


def conv1x1_plain(w: torch.Tensor, b: torch.Tensor, x: torch.Tensor,
                  act: str = "NONE") -> torch.Tensor:
    """act(w @ x + b) in plain PyTorch (any device)."""
    return apply_activation(w @ x + b[:, None], act)


def conv1x1_gemm(w: torch.Tensor, b: torch.Tensor, x: torch.Tensor,
                 act: str = "NONE") -> torch.Tensor:
    """The K2'' 1x1 conv alone: act(w @ x + b) for w (co, ci), b (co,) and
    x (ci, L) f32.  The tiled GEMM of ``csrc/body_flat.cu`` on CUDA tensors
    (counted in ``body_launch``), :func:`conv1x1_plain` on CPU tensors."""
    if x.device.type == "cpu":
        return conv1x1_plain(w, b, x, act)
    co, ci = w.shape
    _build.check_cuda(w, "gemm weights", torch.float32)
    _build.check_cuda(b, "gemm bias", torch.float32, (co,))
    _build.check_cuda(x, "gemm input", torch.float32)
    if x.ndim != 2 or x.shape[0] != ci:
        raise ValueError(f"gemm input: expected ({ci}, L), got {tuple(x.shape)}")
    y = torch.empty((co, x.shape[1]), dtype=torch.float32, device=x.device)
    body_launch("bs_gemm", w.data_ptr(), b.data_ptr(), x.data_ptr(), y.data_ptr(),
                co, ci, x.shape[1], _ACT_CODES[act])
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


def body_plan_for(model, info) -> Optional[BodyPlan]:
    """A BodyPlan for the edge span if the graph qualifies, else None
    (``body_mega_for``): both fused edge layers must be present, and the
    output must be the tail's (K, oh/2, ow/2) input."""
    if not (info.front_ok and info.tail_ok):
        return None
    try:
        plan = BodyPlan(model, info.body_start, info.body_end,
                        info.body_in_tensor, info.body_out_tensor)
    except Unsupported:
        return None
    oh, ow = model.output_shape[1:3]
    if (plan.out_meta.rows, plan.out_meta.w) != (oh // 2, ow // 2):
        return None
    return plan


def _cut_back(model, info, start: int, end: int, in_tid: int, build, min_nodes: int,
              body_output_crosses: bool = False):
    """Cut nodes[start:end] back, one node at a time while at least
    ``min_nodes`` remain, until exactly one tensor it produces (``in_tid``
    included) is read after it and ``build(end, tid)`` does not raise
    Unsupported; with ``body_output_crosses``, the body output counts as
    read when the span reaches the body's end.  Returns (plan, end, tid)
    or None."""
    nodes = model.graph.nodes
    produced = {in_tid}
    for n in nodes[start:end]:
        produced.update(n.outputs)
    while end - start >= min_nodes:
        crossing = {t for n in nodes[end:info.body_end] for t in n.inputs if t in produced}
        if body_output_crosses and end == info.body_end and info.body_out_tensor in produced:
            crossing.add(info.body_out_tensor)
        if len(crossing) == 1:
            tid = crossing.pop()
            try:
                return build(end, tid), end, tid
            except Unsupported:
                pass
        end -= 1
        produced.difference_update(nodes[end].outputs)
    return None


def body_plan_prefix_for(model, info, *, min_nodes: int = 4):
    """K2': a BodyPlan over the longest qualifying prefix of a front-only
    family's body span (``body_mega_prefix_for``), or None.

    The span runs from the body start up to the first node whose output
    has c >= 96 at rows <= 33 (the regime the continuation takes), cut
    back until exactly one tensor produced before the cut (the span input
    included) is read after it.  Returns (plan, cut node index, cut
    tensor id)."""
    if not info.front_ok:
        return None
    g = model.graph
    start = end = info.body_start
    for i in range(start, info.body_end):
        node = g.nodes[i]
        s = g.tensor(node.outputs[0]).shape
        if node.kind not in SUPPORTED or s is None or len(s) != 4 \
                or (s[3] >= 96 and s[1] <= 33):
            break
        end = i + 1
    return _cut_back(model, info, start, end, info.body_in_tensor,
                     lambda e, tid: BodyPlan(model, start, e, info.body_in_tensor, tid,
                                             allow_spaced_output=True), min_nodes)


def body_plan_continuation_for(model, info, start: int, in_tid: int, *,
                               min_nodes: int = 4):
    """K2'': one flat BodyPlan over the body after the prefix cut
    (``body_mega_continuation_for``), or None.

    The same search as the reference's first link: the longest run of
    supported 4-D nodes from ``start``, cut back until one tensor crosses
    the cut and the flat plan builds.  The reference splits that span
    into several kernels to fit a 40 MiB VMEM budget; here every tensor
    lives in one device workspace, so the span is one plan, and it ends
    where the reference's chain ends.  Returns (plan, end node index,
    output tensor id)."""
    g = model.graph
    end = start
    for i in range(start, info.body_end):
        node = g.nodes[i]
        s = g.tensor(node.outputs[0]).shape
        if node.kind not in SUPPORTED or s is None or len(s) != 4:
            break
        end = i + 1
    return _cut_back(model, info, start, end, in_tid,
                     lambda e, tid: BodyPlan(model, start, e, in_tid, tid, flat=True),
                     min_nodes, body_output_crosses=True)
