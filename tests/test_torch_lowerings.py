"""The port's op lowerings against the JAX package's, kind by kind, and
TF-built graphs through both loaders and executors.

- One case (or more, one for each option branch) for each of the 74 kinds
  that the port's first slices did not lower: a one-node graph built by
  hand in both packages' IR, run by each package's ``build_model`` on the
  same seeded numpy inputs.  f32 outputs within 1e-6 (relative and
  absolute), integer and bool outputs exactly (an int64 output of the
  port's beside JAX's int32: JAX without x64 truncates the dtype, not the
  values here).  WHILE and IF get their
  subgraphs, with weights of their own.
- bf16 cases where the JAX lowering computes in the compute dtype, at
  ``tests/test_torch_precision.py``'s bar for the bf16 executor: equal to
  the JAX bf16 output, or closer to it on average than half the JAX bf16
  output's mean distance from the JAX f32 one.
- The TF-built graphs of ``tests/test_tools.py`` (shape plumbing, WHILE/IF,
  builtin TRANSPOSE_CONV at odd sizes, the extended ops, space-to-batch,
  math at batch two, FILL, a U-Net) rebuilt once for the module: the
  port's loader gives the JAX loader's subgraphs, tensors and options node
  by node, and the port's executor the JAX executor's output, at those
  tests' tolerances; TFLite's own output beside it where they agree.
- An activation fed to a weight slot (FULLY_CONNECTED, CONV_2D), read on
  every run as the JAX executor reads it.
- The fixture generators reproduce the committed U-Net and coverage graph.
"""

from __future__ import annotations

import re
import sys
import zlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from backscrub_tpu.graph.executor import build_model as jax_build
from backscrub_tpu.ops.registry import LOWERINGS as JAX_LOWERINGS
from backscrub_tpu.tflite import ir as jir
from backscrub_tpu.tflite.loader import load_tflite_bytes as jax_load_bytes
from backscrub_tpu_torch.graph.executor import build_model
from backscrub_tpu_torch.ops.common import _LOWERINGS, get_lowering
from backscrub_tpu_torch.tflite import ir as tir
from backscrub_tpu_torch.tflite.loader import load_tflite_bytes

# the kinds that the bundled families use, lowered by the earlier slices
FAMILY_KINDS = {
    "ADD", "SUB", "MUL", "DIV", "RELU", "RELU6", "LOGISTIC", "HARD_SWISH", "DEQUANTIZE",
    "CONV_2D", "DEPTHWISE_CONV_2D", "FULLY_CONNECTED", "Convolution2DTransposeBias",
    "CONCATENATION", "RESHAPE", "RESIZE_BILINEAR", "AVERAGE_POOL_2D",
}
F32 = np.float32


def X(a):
    """An activation input (a graph input)."""
    return ("x", np.asarray(a))


def C(a):
    """A constant input (a tensor with a payload)."""
    return ("c", np.asarray(a))


def _rng(tag):
    return np.random.default_rng(zlib.crc32(tag.encode()))


def normal(tag, shape):
    return _rng(tag).standard_normal(shape).astype(F32)


def positive(tag, shape):
    return (_rng(tag).random(shape) + 0.1).astype(F32)


def ints(tag, shape, lo, hi):
    return _rng(tag).integers(lo, hi, shape).astype(np.int32)


def bools(tag, shape):
    return _rng(tag).random(shape) < 0.5


def _graph(ir, ins, n_out, out_dtypes, opts, kind):
    """A one-node GraphIR of ``ir``'s classes: each input a tensor (a
    graph input, or a constant), then the outputs."""
    tensors, node_in, graph_in = [], [], []
    for i, (how, a) in enumerate(ins):
        tensors.append(ir.TensorIR(index=len(tensors), name=f"in{i}", shape=tuple(a.shape),
                                   dtype=a.dtype.type, data=a.copy() if how == "c" else None))
        node_in.append(tensors[-1].index)
        if how == "x":
            graph_in.append(tensors[-1].index)
    outs = []
    for j in range(n_out):
        tensors.append(ir.TensorIR(index=len(tensors), name=f"out{j}", shape=(),
                                   dtype=out_dtypes[min(j, len(out_dtypes) - 1)]))
        outs.append(tensors[-1].index)
    custom = kind if kind[0].islower() or kind.startswith("Convolution") else None
    node = ir.NodeIR(op="CUSTOM" if custom else kind, inputs=node_in, outputs=outs,
                     options=dict(opts), custom_code=custom)
    return ir.GraphIR(name="op", tensors=tensors, nodes=[node], inputs=graph_in, outputs=outs)


class Case:
    """A lowering case: ``kind`` on ``ins`` with ``opts``; ``out`` the
    output tensors' numpy dtypes; ``subs`` a function building the
    subgraph list (control flow) in a given IR module."""

    def __init__(self, kind, ins, opts=None, out=(F32,), n_out=1, subs=None, tag=""):
        self.kind, self.ins, self.opts, self.out = kind, ins, opts or {}, out
        self.n_out, self.subs = n_out, subs
        self.id = kind + (f"-{tag}" if tag else "")

    def graph(self, ir):
        g = _graph(ir, self.ins, self.n_out, self.out, self.opts, self.kind)
        if self.subs is not None:
            g.subgraphs = [g] + self.subs(ir)
        return g

    def inputs(self):
        return [a for how, a in self.ins if how == "x"]


def _while_subgraphs(ir):
    """cond: i < 3; body: (i + 1, v * w + b) with w and b weights of the
    body subgraph."""
    T = ir.TensorIR
    w, b = normal("while-w", (1, 4)), normal("while-b", (4,))
    cond = ir.GraphIR(
        name="cond", inputs=[0, 1], outputs=[3],
        tensors=[T(0, "i", (1,), np.int32), T(1, "v", (1, 4), F32),
                 T(2, "three", (1,), np.int32, np.asarray([3], np.int32)),
                 T(3, "p", (1,), np.bool_)],
        nodes=[ir.NodeIR("LESS", [0, 2], [3], {})])
    body = ir.GraphIR(
        name="body", inputs=[0, 1], outputs=[3, 6],
        tensors=[T(0, "i", (1,), np.int32), T(1, "v", (1, 4), F32),
                 T(2, "one", (1,), np.int32, np.asarray([1], np.int32)),
                 T(3, "i1", (1,), np.int32),
                 T(4, "w", (1, 4), F32, w), T(5, "vw", (1, 4), F32), T(6, "v1", (1, 4), F32),
                 T(7, "b", (4,), F32, b)],
        nodes=[ir.NodeIR("ADD", [0, 2], [3], {"activation": "NONE"}),
               ir.NodeIR("MUL", [1, 4], [5], {"activation": "NONE"}),
               ir.NodeIR("ADD", [5, 7], [6], {"activation": "TANH"})])
    return [cond, body]


def _if_subgraphs(ir):
    """then: v * w (a weight of its own); else: v - 1."""
    T = ir.TensorIR
    then = ir.GraphIR(
        name="then", inputs=[0], outputs=[2],
        tensors=[T(0, "v", (2, 3), F32), T(1, "w", (2, 3), F32, normal("if-w", (2, 3))),
                 T(2, "o", (2, 3), F32)],
        nodes=[ir.NodeIR("MUL", [0, 1], [2], {"activation": "NONE"})])
    other = ir.GraphIR(
        name="else", inputs=[0], outputs=[2],
        tensors=[T(0, "v", (2, 3), F32), T(1, "one", (), F32, np.asarray(1, F32)),
                 T(2, "o", (2, 3), F32)],
        nodes=[ir.NodeIR("SUB", [0, 1], [2], {"activation": "NONE"})])
    return [then, other]


A4 = (2, 5, 6, 4)


def _cases():
    cs = []
    add = cs.append
    # --- control flow
    for k in ("GREATER", "GREATER_EQUAL", "LESS", "LESS_EQUAL", "EQUAL", "NOT_EQUAL"):
        a = ints(k, (3, 4), -2, 3).astype(F32)
        add(Case(k, [X(a), X(ints(k + "b", (3, 4), -2, 3).astype(F32))], out=(np.bool_,)))
    add(Case("LESS", [X(ints("li", (5,), -3, 3)), C(np.asarray(0, np.int32))],
             out=(np.bool_,), tag="int-const"))
    for k in ("LOGICAL_AND", "LOGICAL_OR"):
        add(Case(k, [X(bools(k, (4, 3))), X(bools(k + "b", (4, 3)))], out=(np.bool_,)))
    add(Case("LOGICAL_NOT", [X(bools("ln", (4, 3)))], out=(np.bool_,)))
    for k in ("SELECT", "SELECT_V2"):
        add(Case(k, [X(bools(k, (3, 4))), X(normal(k, (3, 4))), X(normal(k + "b", (3, 4)))]))
    add(Case("SELECT_V2", [X(bools("sv", (3, 1))), X(normal("sv", (3, 4))),
                           C(np.asarray(0.5, F32))], tag="broadcast"))
    add(Case("WHILE", [X(np.asarray([0], np.int32)), X(normal("wv", (1, 4)))],
             {"cond_subgraph": 1, "body_subgraph": 2}, out=(np.int32, F32), n_out=2,
             subs=_while_subgraphs))
    for tag, pred in (("then", True), ("else", False)):
        add(Case("IF", [X(np.asarray([pred])), X(normal("iv", (2, 3)))],
                 {"then_subgraph": 1, "else_subgraph": 2}, subs=_if_subgraphs, tag=tag))
    # --- shape ops
    add(Case("SHAPE", [X(normal("sh", A4))], out=(np.int32,)))
    ss = [C(np.asarray([0, 1, -1, 0], np.int32)), C(np.asarray([2, 5, 0, 3], np.int32)),
          C(np.asarray([1, 2, -2, 1], np.int32))]
    add(Case("STRIDED_SLICE", [X(normal("ss", A4))] + ss, tag="negative-stride"))
    add(Case("STRIDED_SLICE", [X(normal("ss", A4))] + ss,
             {"begin_mask": 0b0100, "end_mask": 0b0010, "shrink_axis_mask": 0b1000},
             tag="masks"))
    add(Case("STRIDED_SLICE", [X(normal("ss3", (4, 6))), C(np.asarray([1, 0], np.int32)),
                               C(np.asarray([3, 6], np.int32))], tag="no-strides"))
    add(Case("PACK", [X(normal("p1", (3, 4))), X(normal("p2", (3, 4))), X(normal("p3", (3, 4)))],
             {"axis": 1, "values_count": 3}))
    add(Case("UNPACK", [X(normal("up", (3, 2, 4)))], {"axis": 1, "num": 2}, n_out=2))
    add(Case("SPLIT", [C(np.asarray(2, np.int32)), X(normal("sp", (2, 3, 6)))], n_out=3))
    add(Case("TRANSPOSE", [X(normal("tr", A4)), C(np.asarray([0, 3, 1, 2], np.int32))]))
    add(Case("SLICE", [X(normal("sl", A4)), C(np.asarray([1, 1, 0, 2], np.int32)),
                       C(np.asarray([1, -1, 4, 2], np.int32))]))
    # --- extended: unary
    edge = np.asarray([-2.5, -1.5, -0.5, 0.5, 1.5, 2.5, 0.0, 3.7], F32)
    for k, make in (("ABS", normal), ("NEG", normal), ("EXP", normal), ("LOG", positive),
                    ("SQRT", positive), ("RSQRT", positive), ("SQUARE", normal),
                    ("FLOOR", normal), ("CEIL", normal), ("SIN", normal), ("COS", normal),
                    ("ELU", normal), ("GELU", normal)):
        add(Case(k, [X(make(k, A4) * 2)]))
    add(Case("ROUND", [X(np.concatenate([edge, normal("rd", (8,)) * 3]))], tag="ties-to-even"))
    add(Case("POW", [X(positive("pw", A4)), X(normal("pw2", A4))]))
    add(Case("SQUARED_DIFFERENCE", [X(normal("sd", A4)), X(normal("sd2", (4,)))]))
    add(Case("CAST", [X(normal("ca", A4) * 4)], out=(np.int32,), tag="f32-int32"))
    add(Case("CAST", [X(np.asarray([0.0, -0.0, 1.5, -2.0], F32))], out=(np.bool_,),
             tag="f32-bool"))
    add(Case("CAST", [X(ints("ci", (3, 4), -5, 5))], out=(F32,), tag="int32-f32"))
    for k in ("SUM", "REDUCE_MAX", "REDUCE_MIN", "REDUCE_PROD"):
        a = positive(k, A4) + 0.5 if k == "REDUCE_PROD" else normal(k, A4)
        add(Case(k, [X(a), C(np.asarray([1, 2], np.int32))], {"keep_dims": True}))
        add(Case(k, [X(a), C(np.asarray([-1], np.int32))], {"keep_dims": False},
                 tag="drop-dims"))
    for tag, o in (("legacy", {}), ("align_corners", {"align_corners": True}),
                   ("half_pixel", {"half_pixel_centers": True})):
        for size in ((11, 9), (3, 4)):
            add(Case("RESIZE_NEAREST_NEIGHBOR",
                     [X(normal("rn", A4)), C(np.asarray(size, np.int32))], o,
                     tag=f"{tag}-{size[0]}x{size[1]}"))
    pads = C(np.asarray([[0, 0], [2, 1], [0, 3], [0, 0]], np.int32))
    add(Case("MIRROR_PAD", [X(normal("mp", A4)), pads], {"mode": 0}, tag="reflect"))
    add(Case("MIRROR_PAD", [X(normal("mp", A4)), pads], {"mode": 1}, tag="symmetric"))
    add(Case("PADV2", [X(normal("p2", A4)), pads, C(np.asarray([-1.5], F32))]))
    add(Case("SPACE_TO_DEPTH", [X(normal("s2d", (2, 4, 6, 3)))], {"block_size": 2}))
    add(Case("DEPTH_TO_SPACE", [X(normal("d2s", (2, 2, 3, 8)))], {"block_size": 2}))
    add(Case("GATHER", [X(normal("ga", A4)), C(np.asarray([[3, 0], [5, 1]], np.int32))],
             {"axis": 2}))
    add(Case("GATHER", [X(normal("ga", (5, 3))), X(np.asarray([-1, 5, -6, 2], np.int32))],
             {"axis": 0}, tag="out-of-range"))
    add(Case("GATHER", [X(ints("gi", (5, 3), -9, 9)), C(np.asarray([-1, 7, 2], np.int32))],
             {"axis": 0}, out=(np.int32,), tag="int-fill"))
    add(Case("TILE", [X(normal("ti", (2, 3))), C(np.asarray([2, 3], np.int32))]))
    add(Case("L2_NORMALIZATION", [X(normal("l2", A4))]))
    fd_b = np.where(np.abs(normal("fd2", A4)) < 0.2, 0.7, normal("fd2", A4)).astype(F32)
    add(Case("FLOOR_DIV", [X(normal("fd", A4) * 5), X(fd_b)]))
    add(Case("FLOOR_DIV", [X(ints("fdi", (3, 5), -9, 9)),
                           C(np.asarray([2, -3, 4, -2, 5], np.int32))],
             out=(np.int32,), tag="int"))
    add(Case("FLOOR_MOD", [X(normal("fm", A4) * 5), C(np.asarray(-2.0, F32))]))
    add(Case("FLOOR_MOD", [X(ints("fmi", (3, 5), -9, 9)),
                           C(np.asarray([2, -3, 4, -2, 5], np.int32))],
             out=(np.int32,), tag="int"))
    add(Case("ARG_MIN", [X(normal("am", A4)), C(np.asarray([3], np.int32))], out=(np.int32,)))
    add(Case("ARG_MIN", [X(normal("am", A4)), C(np.asarray([1], np.int32))], out=(np.int64,),
             tag="int64"))
    add(Case("LOG_SOFTMAX", [X(normal("ls", A4) * 3)]))
    for tag, o in (("plain", {}), ("adj_x", {"adj_x": True}), ("adj_y", {"adj_y": True}),
                   ("adj_xy", {"adj_x": True, "adj_y": True})):
        xa = normal("bm" + tag, (2, 5, 4) if o.get("adj_x") else (2, 4, 5))
        ya = normal("bm2" + tag, (2, 3, 5) if o.get("adj_y") else (2, 5, 3))
        add(Case("BATCH_MATMUL", [X(xa), X(ya)], o, tag=tag))
    add(Case("FILL", [C(np.asarray([1, 3, 4], np.int32)), X(normal("fi", ()))]))
    add(Case("ZEROS_LIKE", [X(normal("zl", A4))]))
    for axis in (-1, 1):
        add(Case("ONE_HOT", [X(np.asarray([[0, 3, -1], [7, 2, 1]], np.int32)),
                             C(np.asarray(4, np.int32)), C(np.asarray(2.0, F32)),
                             C(np.asarray(-1.0, F32))], {"axis": axis}, tag=f"axis{axis}"))
    for tag, o in (("plain", {}), ("exclusive", {"exclusive": True}),
                   ("reverse", {"reverse": True}),
                   ("exclusive-reverse", {"exclusive": True, "reverse": True})):
        add(Case("CUMSUM", [X(normal("cs", A4)), C(np.asarray(2, np.int32))], o, tag=tag))
    add(Case("SPACE_TO_BATCH_ND", [X(normal("stb", (1, 8, 10, 4))),
                                   C(np.asarray([2, 2], np.int32)),
                                   C(np.asarray([[1, 1], [2, 0]], np.int32))]))
    add(Case("BATCH_TO_SPACE_ND", [X(normal("bts", (4, 5, 6, 4))),
                                   C(np.asarray([2, 2], np.int32)),
                                   C(np.asarray([[1, 1], [2, 0]], np.int32))]))
    # --- the kinds of the older files
    for tag, (hw, f, pad, out) in (("same-odd", ((5, 5), 3, "SAME", (10, 10))),
                                   ("valid", ((4, 3), 3, "VALID", (9, 7))),
                                   ("same-even", ((4, 6), 2, "SAME", (8, 12)))):
        w = normal("tc-w" + tag, (6, f, f, 3))
        b = normal("tc-b" + tag, (6,))
        add(Case("TRANSPOSE_CONV",
                 [C(np.asarray((2,) + out + (6,), np.int32)), C(w), X(normal("tc" + tag,
                                                                          (2,) + hw + (3,))),
                  C(b)], {"padding": pad, "stride_h": 2, "stride_w": 2}, tag=tag))
    add(Case("TRANSPOSE_CONV",
             [C(np.asarray((1, 7, 7, 2), np.int32)), C(normal("tcn", (2, 3, 3, 3))),
              X(normal("tcnx", (1, 3, 3, 3)))], {"padding": "VALID", "stride_h": 2,
                                                 "stride_w": 2}, tag="no-bias"))
    for k in ("MINIMUM", "MAXIMUM"):
        add(Case(k, [X(normal(k, A4)), X(normal(k + "b", (4,)))]))
    add(Case("RELU_N1_TO_1", [X(normal("rn1", A4) * 2)]))
    add(Case("TANH", [X(normal("tanh", A4) * 2)]))
    add(Case("LEAKY_RELU", [X(normal("lr", A4))], {"alpha": 0.2}))
    add(Case("PRELU", [X(normal("pr", A4)), C(normal("pra", (1, 1, 4)))]))
    add(Case("SQUEEZE", [X(normal("sq", (2, 1, 3, 1)))]))
    add(Case("EXPAND_DIMS", [X(normal("ed", (2, 3))), C(np.asarray(-1, np.int32))]))
    add(Case("EXPAND_DIMS", [X(normal("ed", (2, 3))), C(np.asarray([1], np.int32))],
             tag="axis1"))
    add(Case("SOFTMAX", [X(normal("sm", A4) * 3)], {"beta": 0.7}))
    add(Case("PAD", [X(normal("pad", A4)), pads]))
    add(Case("ARG_MAX", [X(normal("amx", A4)), C(np.asarray([2], np.int32))], out=(np.int64,)))
    for tag, o in (("same", {"padding": "SAME", "filter_h": 3, "filter_w": 3, "stride_h": 2,
                             "stride_w": 2, "activation": "RELU6"}),
                   ("valid", {"padding": "VALID", "filter_h": 2, "filter_w": 2, "stride_h": 2,
                              "stride_w": 1, "activation": "NONE"})):
        add(Case("MAX_POOL_2D", [X(normal("mx", (2, 7, 6, 3)) * 4)], o, tag=tag))
    add(Case("MEAN", [X(normal("mean", A4)), C(np.asarray([1, 2], np.int32))],
             {"keep_dims": True}))
    add(Case("MEAN", [X(normal("mean", A4)), C(np.asarray([3], np.int32))],
             {"keep_dims": False}, tag="drop-dims"))
    return cs


CASES = _cases()
# kinds whose JAX lowering computes in the compute dtype: run again in bf16
BF16_KINDS = ("EXP", "LOG", "SQRT", "RSQRT", "SIN", "COS", "ELU", "GELU", "TANH", "POW",
              "SQUARED_DIFFERENCE", "SUM", "REDUCE_PROD", "MEAN", "L2_NORMALIZATION",
              "LOG_SOFTMAX", "SOFTMAX", "CUMSUM", "BATCH_MATMUL", "LEAKY_RELU", "PRELU",
              "TRANSPOSE_CONV", "MAX_POOL_2D", "FLOOR_DIV", "FLOOR_MOD", "SQUARE")
BF16_CASES = [c for c in CASES if c.kind in BF16_KINDS]


def _run(case, compute="f32"):
    """(the JAX outputs, the port's outputs) as lists of numpy arrays."""
    jd = jnp.bfloat16 if compute == "bf16" else jnp.float32
    td = torch.bfloat16 if compute == "bf16" else torch.float32
    jm = jax_build(case.graph(jir), compute_dtype=jd, jit=False)
    tm = build_model(case.graph(tir), compute_dtype=td)
    xs = case.inputs()
    xj = [jnp.asarray(a) for a in xs]      # as under jit: no numpy arithmetic
    jy = jm(tuple(xj) if len(xj) != 1 else xj[0])
    with torch.no_grad():
        ty = tm(tuple(torch.from_numpy(np.array(a)) for a in xs) if len(xs) != 1
                else torch.from_numpy(np.array(xs[0])))
    jy = list(jy) if isinstance(jy, tuple) else [jy]
    ty = list(ty) if isinstance(ty, tuple) else [ty]
    jy = [np.asarray(jnp.asarray(v, jnp.float32) if v.dtype == jnp.bfloat16 else v)
          for v in jy]
    ty = [(v.float() if v.dtype == torch.bfloat16 else v).numpy() for v in ty]
    return jy, ty


def test_every_jax_lowering_has_one_here():
    assert set(_LOWERINGS) == set(JAX_LOWERINGS)
    assert len(_LOWERINGS) == 91
    assert {c.kind for c in CASES} == set(JAX_LOWERINGS) - FAMILY_KINDS
    assert len(set(JAX_LOWERINGS) - FAMILY_KINDS) == 74
    with pytest.raises(NotImplementedError, match="supported: .*WHILE"):
        get_lowering("NON_MAX_SUPPRESSION_V4")


@pytest.mark.parametrize("case", CASES, ids=[c.id for c in CASES])
def test_lowering_matches_jax(case):
    jy, ty = _run(case)
    assert len(jy) == len(ty) == case.n_out
    for j, t in zip(jy, ty):
        assert j.shape == t.shape, (j.shape, t.shape)
        if np.issubdtype(j.dtype, np.floating):
            assert t.dtype == j.dtype
            np.testing.assert_allclose(t, j, rtol=1e-6, atol=1e-6)
        else:
            # JAX without x64 holds an int64 output as int32
            assert t.dtype == j.dtype or (t.dtype, j.dtype) == (np.int64, np.int32)
            np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("case", BF16_CASES, ids=[c.id for c in BF16_CASES])
def test_lowering_bf16_matches_jax(case):
    jb, tb = _run(case, "bf16")
    jf, _ = _run(case)
    for j, t, f in zip(jb, tb, jf):
        assert j.shape == t.shape
        if not np.issubdtype(j.dtype, np.floating) or np.array_equal(t, j, equal_nan=True):
            np.testing.assert_array_equal(t, j)
            continue
        gap = float(np.nanmean(np.abs(j - f)))
        got = float(np.nanmean(np.abs(t - j)))
        assert got <= 0.5 * gap, (got, gap)


# an activation fed to a weight slot: both executors read the run's value
# (unprepared: JAX's ``get_const`` falls back to ``get`` on every call)
WEIGHT_SLOT_CASES = [
    Case("FULLY_CONNECTED", [X(normal("fcx", (2, 6))), X(normal("fcw", (6, 3))),
                             C(normal("fcb", (3,)))], {"activation": "RELU"}, tag="weights"),
    Case("FULLY_CONNECTED", [X(normal("fcx", (2, 6))), C(normal("fcw2", (3, 6))),
                             X(normal("fcb", (3,)))], {"activation": "NONE"}, tag="bias"),
    Case("CONV_2D", [X(normal("cvx", (1, 5, 5, 2))), X(normal("cvw", (3, 3, 2, 4))),
                     C(normal("cvb", (4,)))],
         {"padding": "SAME", "stride_h": 1, "stride_w": 1, "activation": "NONE"},
         tag="filter"),
]


@pytest.mark.parametrize("case", WEIGHT_SLOT_CASES, ids=[c.id for c in WEIGHT_SLOT_CASES])
def test_activation_in_a_weight_slot_matches_jax(case):
    """A converted graph whose weight slot holds an activation builds and
    runs frame after frame (the value is read each run, not prepared at
    build time), as the JAX executor does."""
    jm = jax_build(case.graph(jir), jit=False)
    tm = build_model(case.graph(tir))
    for k in range(2):
        xs = [a * (1 + k) for a in case.inputs()]
        jy = np.asarray(jm(tuple(jnp.asarray(a) for a in xs)))
        with torch.no_grad():
            ty = tm(tuple(torch.from_numpy(a) for a in xs)).numpy()
        assert ty.shape == jy.shape
        np.testing.assert_allclose(ty, jy, rtol=1e-6, atol=1e-6)
    assert not tm.params.keys() & {f"t{i}" for i in case.graph(tir).inputs}


# --- TF-built graphs (tests/test_tools.py's), built once for the module


def _keras_blob(tf, build):
    inp, out = build(tf)
    return tf.lite.TFLiteConverter.from_keras_model(tf.keras.Model(inp, out)).convert()


def _fn_blob(tf, spec, fn):
    m = tf.Module()
    m.f = tf.function(fn, input_signature=[spec])
    return tf.lite.TFLiteConverter.from_concrete_functions(
        [m.f.get_concrete_function()], m).convert()


def _shape_plumbing(tf):
    inp = tf.keras.Input((16, 16, 3))
    x = tf.keras.layers.Conv2D(4, 3, padding="same", activation="relu")(inp)
    x = tf.keras.layers.GlobalAveragePooling2D()(x)
    x = tf.keras.layers.Flatten()(x)
    return inp, tf.keras.layers.Dense(10, activation="softmax")(x)


def _tconv_odd(tf):
    inp = tf.keras.Input((5, 5, 3))
    y = tf.keras.layers.Conv2DTranspose(4, 2, strides=2, padding="same")(inp)
    return inp, tf.keras.layers.Conv2DTranspose(2, 3, strides=2, padding="same")(y)


def _extended(tf):
    L = tf.keras.layers.Lambda
    inp = tf.keras.Input((16, 16, 4))
    y = L(lambda x: tf.nn.space_to_depth(x, 2))(inp)
    y = L(lambda x: tf.nn.depth_to_space(x, 2))(y)
    y = L(lambda x: tf.image.resize(x, (32, 32), method="nearest"))(y)
    y = L(lambda x: tf.pad(x, [[0, 0], [1, 1], [1, 1], [0, 0]], mode="REFLECT"))(y)
    y = L(lambda x: tf.abs(x) + tf.sqrt(tf.abs(x) + 1.0) - tf.exp(-x))(y)
    y = L(lambda x: tf.reduce_sum(x, axis=-1, keepdims=True))(y)
    return inp, L(lambda x: tf.nn.l2_normalize(x, axis=-1))(y)


def _unet(tf):
    C, T = tf.keras.layers.Conv2D, tf.keras.layers.Conv2DTranspose
    inp = tf.keras.Input((32, 32, 3))
    e1 = C(8, 3, padding="same", activation="relu")(inp)
    e2 = C(16, 3, strides=2, padding="same", activation="relu")(e1)
    e3 = C(32, 3, strides=2, padding="same", activation="relu")(e2)
    d2 = T(16, 3, strides=2, padding="same", activation="relu")(e3)
    d2 = tf.keras.layers.Concatenate()([d2, e2])
    d1 = T(8, 3, strides=2, padding="same", activation="relu")(d2)
    d1 = tf.keras.layers.Concatenate()([d1, e1])
    return inp, C(1, 1, activation="sigmoid")(d1)


def _while_if(tf):
    def f(x):
        i = tf.constant(0)
        _, y = tf.while_loop(lambda i, v: i < 3, lambda i, v: (i + 1, v * 1.5 + 0.1), [i, x])
        return tf.cond(tf.reduce_sum(y) > 10.0, lambda: y * 2.0, lambda: y - 1.0)
    return tf.TensorSpec((1, 8), tf.float32), f


def _space_to_batch(tf):
    def f(x):
        y = tf.space_to_batch_nd(x, [2, 2], [[1, 1], [2, 0]])
        y = tf.nn.relu(y) * 0.5
        return tf.batch_to_space(y, [2, 2], [[1, 1], [2, 0]])
    return tf.TensorSpec((1, 8, 10, 4), tf.float32), f


def _math_batch_two(tf):
    def f(x):
        bm = tf.matmul(x, x, transpose_b=True) @ x
        fd = tf.math.floordiv(x * 5.0, 2.0)
        fm = tf.math.floormod(x * 5.0, -2.0)
        oh = tf.one_hot(tf.argmin(x, axis=-1, output_type=tf.int32), 8,
                        on_value=2.0, off_value=-1.0)
        rm = tf.reduce_min(x, axis=-1, keepdims=True)
        rp = tf.reduce_prod(x * 0.9 + 0.1, axis=1, keepdims=True)
        cs = tf.cumsum(x, axis=-1, exclusive=True, reverse=True)
        ls = tf.nn.log_softmax(x, axis=-1)
        return bm + fd + fm + oh + rm + rp + cs + ls
    return tf.TensorSpec((2, 6, 8), tf.float32), f


def _dynamic_batch(tf):
    def f(x):
        y = tf.reshape(x, tf.stack([tf.shape(x)[0], -1]))
        return tf.nn.softmax(y * 2.0)
    return tf.TensorSpec((None, 4, 4, 3), tf.float32), f


def _fill(tf):
    return tf.TensorSpec((1, 4), tf.float32), lambda x: tf.fill([1, 3, 4], tf.reduce_max(x))


# name: (how to build, input maker, tolerance of tests/test_tools.py, kinds it must hold)
TF_GRAPHS = {
    # TF 2.21 folds the Flatten's shape math at a fixed batch
    "shape_plumbing": ("keras", _shape_plumbing, lambda r: r.random((1, 16, 16, 3)), 1e-5,
                       {"MEAN", "FULLY_CONNECTED", "SOFTMAX"}),
    "dynamic_batch": ("fn", _dynamic_batch, lambda r: r.random((1, 4, 4, 3)), 1e-5,
                      {"SHAPE", "STRIDED_SLICE", "PACK", "RESHAPE"}),
    "while_if": ("fn", _while_if, lambda r: r.random((1, 8)), 1e-6, {"WHILE", "IF"}),
    "tconv_odd": ("keras", _tconv_odd, lambda r: r.random((1, 5, 5, 3)), 1e-5,
                  {"TRANSPOSE_CONV"}),
    "extended": ("keras", _extended, lambda r: r.random((1, 16, 16, 4)), 1e-5,
                 {"SPACE_TO_DEPTH", "DEPTH_TO_SPACE", "RESIZE_NEAREST_NEIGHBOR",
                  "MIRROR_PAD", "L2_NORMALIZATION"}),
    "space_to_batch": ("fn", _space_to_batch, lambda r: r.random((1, 8, 10, 4)), 1e-6,
                       {"SPACE_TO_BATCH_ND", "BATCH_TO_SPACE_ND"}),
    "math_batch_two": ("fn", _math_batch_two, lambda r: r.random((2, 6, 8)) + 0.25, 1e-4,
                       {"BATCH_MATMUL", "FLOOR_DIV", "FLOOR_MOD", "ONE_HOT", "REDUCE_MIN",
                        "REDUCE_PROD", "CUMSUM", "LOG_SOFTMAX"}),
    "fill": ("fn", _fill, lambda r: r.random((1, 4)), 1e-6, {"FILL"}),
    "unet": ("keras", _unet, lambda r: r.random((1, 32, 32, 3)), 1e-5,
             {"TRANSPOSE_CONV", "CONCATENATION"}),
}


@pytest.fixture(scope="module")
def tf_graphs():
    """name -> the flatbuffer bytes, each graph converted once."""
    tf = pytest.importorskip("tensorflow")
    tf.keras.utils.set_random_seed(0)
    out = {}
    for name, (how, build, *_rest) in TF_GRAPHS.items():
        out[name] = (_keras_blob(tf, build) if how == "keras" else _fn_blob(tf, *build(tf)))
    return out


def _same_graph(t, j):
    """The port's GraphIR against the JAX loader's: tensors (name, shape,
    dtype, payload) and nodes (kind, inputs, outputs, options)."""
    assert (t.name, t.inputs, t.outputs, t.description) == (j.name, j.inputs, j.outputs,
                                                          j.description)
    assert len(t.tensors) == len(j.tensors)
    for a, b in zip(t.tensors, j.tensors):
        assert (a.name, tuple(a.shape), np.dtype(a.dtype)) == (b.name, tuple(b.shape),
                                                               np.dtype(b.dtype))
        assert (a.data is None) == (b.data is None)
        if a.data is not None:
            np.testing.assert_array_equal(a.data, b.data)
    assert [(n.kind, n.inputs, n.outputs, n.options) for n in t.nodes] == \
        [(n.kind, n.inputs, n.outputs, n.options) for n in j.nodes]


@pytest.mark.parametrize("name", list(TF_GRAPHS))
def test_tf_graph_loads_and_runs_as_jax(tf_graphs, name):
    import tensorflow as tf
    blob = tf_graphs[name]
    _, _, make, tol, kinds = TF_GRAPHS[name]
    tg, jg = load_tflite_bytes(blob), jax_load_bytes(blob)
    assert kinds <= set(tg.op_histogram()), tg.op_histogram()
    assert (tg.subgraphs is None) == (jg.subgraphs is None)
    for t, j in zip(tg.subgraphs or [tg], jg.subgraphs or [jg]):
        _same_graph(t, j)
    x = make(np.random.default_rng(0)).astype(F32)
    ref = np.asarray(jax_build(jg)(jnp.asarray(x)))
    with torch.no_grad():
        got = build_model(tg)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=tol, atol=tol)
    it = tf.lite.Interpreter(model_content=blob)
    it.allocate_tensors()
    it.set_tensor(it.get_input_details()[0]["index"], x)
    it.invoke()
    np.testing.assert_allclose(got, it.get_tensor(it.get_output_details()[0]["index"]),
                               rtol=tol, atol=tol)


def _tool(name):
    import importlib
    from pathlib import Path
    tools = str(Path(__file__).resolve().parent.parent / "tools")
    if tools not in sys.path:
        sys.path.insert(0, tools)
    return importlib.import_module(name)


def _counter_masked(g):
    """``g`` with the IF branches' names (subgraphs and their argument
    tensors) rid of the number TF takes from a counter of its process."""
    for sub in g.subgraphs or [g]:
        sub.name = re.sub(r"cond_(true|false)_\d+", r"cond_\1_N", sub.name)
        for t in sub.tensors:
            t.name = re.sub(r"cond_(true|false)_\d+", r"cond_\1_N", t.name)
    return g


def test_generators_reproduce_the_committed_fixtures(tmp_path, tf_graphs):
    """``tools/make_synth_unet.py`` (its head bias calibrated through the
    port on the CPU) writes the committed bytes; ``tools/make_synth_coverage.py``
    writes the committed graph (every tensor, payload, node and option;
    the IF branches' names carry the number of TF's process-wide counter,
    which the graphs above have moved, and are compared without it), which
    holds every kind TF's converter emits of the 74, all but none, in five
    subgraphs."""
    from pathlib import Path
    data = Path(__file__).resolve().parent / "data"
    unet = _tool("make_synth_unet").write_model(str(tmp_path / "unet_synth_256x256.tflite"))
    assert Path(unet).read_bytes() == (data / "unet_synth_256x256.tflite").read_bytes()
    blob = _tool("make_synth_coverage").build_model()
    g = _counter_masked(load_tflite_bytes(blob))
    ref = _counter_masked(load_tflite_bytes((data / "ops_synth_coverage.tflite").read_bytes()))
    assert len(g.subgraphs) == len(ref.subgraphs) == 5
    for a, b in zip(g.subgraphs, ref.subgraphs):
        _same_graph(a, b)
    kinds = {n.kind for s in g.subgraphs for n in s.nodes}
    assert (set(JAX_LOWERINGS) - FAMILY_KINDS) - kinds == set()
