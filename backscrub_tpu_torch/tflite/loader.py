"""Parse a ``.tflite`` flatbuffer into :class:`~backscrub_tpu_torch.tflite.ir.GraphIR`.

Counterpart of ``backscrub_tpu/tflite/loader.py`` without TensorFlow or the
``flatbuffers`` package: a flatbuffer is read here with ``struct`` and
numpy only.  It reads every subgraph (WHILE/IF bodies), the Model /
SubGraph / Tensor / Buffer / Operator / OperatorCode /
QuantizationParameters tables, the builtin-options tables that the JAX
loader parses (their union type numbers and field slots taken from
TFLite's schema and written down here), and custom ops
(``Convolution2DTransposeBias``).  Other builtin ops load with empty
options, as in the JAX loader.

Every read is bounds-checked, so a truncated or corrupted file raises
``ValueError`` instead of reading past the buffer.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, List, Optional

import numpy as np

from .ir import GraphIR, NodeIR, TensorIR, TENSOR_TYPE_TO_NP

# BuiltinOperator enum, as TFLite's schema defines it (schema_py_generated
# of TensorFlow 2.21; values are stable across schema versions)
BUILTIN_OPS = {
    0: "ADD", 1: "AVERAGE_POOL_2D", 2: "CONCATENATION", 3: "CONV_2D",
    4: "DEPTHWISE_CONV_2D", 5: "DEPTH_TO_SPACE", 6: "DEQUANTIZE",
    7: "EMBEDDING_LOOKUP", 8: "FLOOR", 9: "FULLY_CONNECTED",
    10: "HASHTABLE_LOOKUP", 11: "L2_NORMALIZATION", 12: "L2_POOL_2D",
    13: "LOCAL_RESPONSE_NORMALIZATION", 14: "LOGISTIC", 15: "LSH_PROJECTION",
    16: "LSTM", 17: "MAX_POOL_2D", 18: "MUL", 19: "RELU", 20: "RELU_N1_TO_1",
    21: "RELU6", 22: "RESHAPE", 23: "RESIZE_BILINEAR", 24: "RNN",
    25: "SOFTMAX", 26: "SPACE_TO_DEPTH", 27: "SVDF", 28: "TANH",
    29: "CONCAT_EMBEDDINGS", 30: "SKIP_GRAM", 31: "CALL", 32: "CUSTOM",
    33: "EMBEDDING_LOOKUP_SPARSE", 34: "PAD", 35: "UNIDIRECTIONAL_SEQUENCE_RNN",
    36: "GATHER", 37: "BATCH_TO_SPACE_ND", 38: "SPACE_TO_BATCH_ND",
    39: "TRANSPOSE", 40: "MEAN", 41: "SUB", 42: "DIV", 43: "SQUEEZE",
    44: "UNIDIRECTIONAL_SEQUENCE_LSTM", 45: "STRIDED_SLICE",
    46: "BIDIRECTIONAL_SEQUENCE_RNN", 47: "EXP", 48: "TOPK_V2", 49: "SPLIT",
    50: "LOG_SOFTMAX", 51: "DELEGATE", 52: "BIDIRECTIONAL_SEQUENCE_LSTM",
    53: "CAST", 54: "PRELU", 55: "MAXIMUM", 56: "ARG_MAX", 57: "MINIMUM",
    58: "LESS", 59: "NEG", 60: "PADV2", 61: "GREATER", 62: "GREATER_EQUAL",
    63: "LESS_EQUAL", 64: "SELECT", 65: "SLICE", 66: "SIN",
    67: "TRANSPOSE_CONV", 68: "SPARSE_TO_DENSE", 69: "TILE", 70: "EXPAND_DIMS",
    71: "EQUAL", 72: "NOT_EQUAL", 73: "LOG", 74: "SUM", 75: "SQRT",
    76: "RSQRT", 77: "SHAPE", 78: "POW", 79: "ARG_MIN", 80: "FAKE_QUANT",
    81: "REDUCE_PROD", 82: "REDUCE_MAX", 83: "PACK", 84: "LOGICAL_OR",
    85: "ONE_HOT", 86: "LOGICAL_AND", 87: "LOGICAL_NOT", 88: "UNPACK",
    89: "REDUCE_MIN", 90: "FLOOR_DIV", 91: "REDUCE_ANY", 92: "SQUARE",
    93: "ZEROS_LIKE", 94: "FILL", 95: "FLOOR_MOD", 96: "RANGE",
    97: "RESIZE_NEAREST_NEIGHBOR", 98: "LEAKY_RELU", 99: "SQUARED_DIFFERENCE",
    100: "MIRROR_PAD", 101: "ABS", 102: "SPLIT_V", 103: "UNIQUE", 104: "CEIL",
    105: "REVERSE_V2", 106: "ADD_N", 107: "GATHER_ND", 108: "COS",
    109: "WHERE", 110: "RANK", 111: "ELU", 112: "REVERSE_SEQUENCE",
    113: "MATRIX_DIAG", 114: "QUANTIZE", 115: "MATRIX_SET_DIAG", 116: "ROUND",
    117: "HARD_SWISH", 118: "IF", 119: "WHILE", 120: "NON_MAX_SUPPRESSION_V4",
    121: "NON_MAX_SUPPRESSION_V5", 122: "SCATTER_ND", 123: "SELECT_V2",
    124: "DENSIFY", 125: "SEGMENT_SUM", 126: "BATCH_MATMUL",
    127: "PLACEHOLDER_FOR_GREATER_OP_CODES", 128: "CUMSUM", 129: "CALL_ONCE",
    130: "BROADCAST_TO", 131: "RFFT2D", 132: "CONV_3D", 133: "IMAG",
    134: "REAL", 135: "COMPLEX_ABS", 136: "HASHTABLE", 137: "HASHTABLE_FIND",
    138: "HASHTABLE_IMPORT", 139: "HASHTABLE_SIZE", 140: "REDUCE_ALL",
    141: "CONV_3D_TRANSPOSE", 142: "VAR_HANDLE", 143: "READ_VARIABLE",
    144: "ASSIGN_VARIABLE", 145: "BROADCAST_ARGS",
    146: "RANDOM_STANDARD_NORMAL", 147: "BUCKETIZE", 148: "RANDOM_UNIFORM",
    149: "MULTINOMIAL", 150: "GELU", 151: "DYNAMIC_UPDATE_SLICE",
    152: "RELU_0_TO_1", 153: "UNSORTED_SEGMENT_PROD",
    154: "UNSORTED_SEGMENT_MAX", 155: "UNSORTED_SEGMENT_SUM", 156: "ATAN2",
    157: "UNSORTED_SEGMENT_MIN", 158: "SIGN", 159: "BITCAST",
    160: "BITWISE_XOR", 161: "RIGHT_SHIFT",
}

PADDING_NAMES = {0: "SAME", 1: "VALID"}
ACTIVATION_NAMES = {0: "NONE", 1: "RELU", 2: "RELU_N1_TO_1", 3: "RELU6",
                    4: "TANH", 5: "SIGN_BIT"}


class _Table:
    """A flatbuffer table at ``pos``: field ``slot`` lives at vtable entry
    4 + 2*slot (schema field order)."""

    __slots__ = ("buf", "pos", "vt", "vlen")

    def __init__(self, buf: bytes, pos: int):
        self.buf, self.pos = buf, pos
        self.vt = pos - _read(buf, "<i", pos)
        self.vlen = _read(buf, "<H", self.vt)

    def _field(self, slot: int) -> int:
        o = 4 + 2 * slot
        return _read(self.buf, "<H", self.vt + o) if o + 2 <= self.vlen else 0

    def scalar(self, slot: int, fmt: str, default=0):
        o = self._field(slot)
        return _read(self.buf, fmt, self.pos + o) if o else default

    def _indirect(self, slot: int) -> Optional[int]:
        o = self._field(slot)
        if not o:
            return None
        p = self.pos + o
        return p + _read(self.buf, "<I", p)

    def table(self, slot: int) -> Optional["_Table"]:
        p = self._indirect(slot)
        return None if p is None else _Table(self.buf, p)

    def span(self, slot: int, itemsize: int = 1) -> Optional[tuple]:
        """(byte offset, element count) of the vector in field ``slot``."""
        p = self._indirect(slot)
        if p is None:
            return None
        n = _read(self.buf, "<I", p)
        _check(self.buf, p + 4, n * itemsize)
        return p + 4, n

    def vector(self, slot: int, dtype) -> Optional[np.ndarray]:
        dt = np.dtype(dtype).newbyteorder("<")
        span = self.span(slot, dt.itemsize)
        return None if span is None else np.frombuffer(self.buf, dt, span[1], span[0])

    def tables(self, slot: int) -> List["_Table"]:
        offs = self.vector(slot, np.uint32)
        if offs is None:
            return []
        p0 = self._indirect(slot) + 4
        return [_Table(self.buf, p0 + 4 * i + int(o)) for i, o in enumerate(offs)]

    def string(self, slot: int) -> Optional[str]:
        raw = self.vector(slot, np.uint8)
        return None if raw is None else raw.tobytes().decode("utf-8", "replace")


def _check(buf: bytes, pos: int, size: int) -> None:
    if pos < 0 or pos + size > len(buf):
        raise ValueError(f"flatbuffer offset {pos}+{size} outside the "
                         f"{len(buf)}-byte buffer")


def _read(buf: bytes, fmt: str, pos: int):
    _check(buf, pos, struct.calcsize(fmt))
    return struct.unpack_from(fmt, buf, pos)[0]


# builtin-options tables: op name -> (union type id, parser(table))
def _act(t: _Table, slot: int) -> str:
    return ACTIVATION_NAMES.get(t.scalar(slot, "<b"), "NONE")


def _conv_opts(t):
    return dict(padding=PADDING_NAMES[t.scalar(0, "<b")],
                stride_h=t.scalar(2, "<i"), stride_w=t.scalar(1, "<i"),
                dilation_h=t.scalar(5, "<i", 1), dilation_w=t.scalar(4, "<i", 1),
                activation=_act(t, 3))


def _dw_opts(t):
    return dict(padding=PADDING_NAMES[t.scalar(0, "<b")],
                stride_h=t.scalar(2, "<i"), stride_w=t.scalar(1, "<i"),
                dilation_h=t.scalar(6, "<i", 1), dilation_w=t.scalar(5, "<i", 1),
                depth_multiplier=t.scalar(3, "<i"), activation=_act(t, 4))


def _pool_opts(t):
    return dict(padding=PADDING_NAMES[t.scalar(0, "<b")],
                stride_h=t.scalar(2, "<i"), stride_w=t.scalar(1, "<i"),
                filter_h=t.scalar(4, "<i"), filter_w=t.scalar(3, "<i"),
                activation=_act(t, 5))


def _reshape_opts(t):
    shape = t.vector(0, np.int32)
    return dict(new_shape=[int(s) for s in shape]) if shape is not None \
        and len(shape) else {}


def _flags(**slots):
    """A parser of bool fields: option name -> slot."""
    return lambda t: {k: bool(t.scalar(s, "<B")) for k, s in slots.items()}


def _ints(**slots):
    """A parser of int32 fields: option name -> slot."""
    return lambda t: {k: t.scalar(s, "<i") for k, s in slots.items()}


_REDUCER = (27, _flags(keep_dims=0))


_OPTIONS = {
    "CONV_2D": (1, _conv_opts),
    "DEPTHWISE_CONV_2D": (2, _dw_opts),
    "AVERAGE_POOL_2D": (5, _pool_opts),
    "MAX_POOL_2D": (5, _pool_opts),
    "FULLY_CONNECTED": (8, lambda t: dict(
        activation=_act(t, 0), keep_num_dims=bool(t.scalar(2, "<B")))),
    "SOFTMAX": (9, lambda t: dict(beta=t.scalar(0, "<f", 0.0))),
    "CONCATENATION": (10, lambda t: dict(axis=t.scalar(0, "<i"),
                                         activation=_act(t, 1))),
    "RESIZE_BILINEAR": (15, lambda t: dict(
        align_corners=bool(t.scalar(2, "<B")),
        half_pixel_centers=bool(t.scalar(3, "<B")))),
    "RESHAPE": (17, _reshape_opts),
    # the tables the JAX loader reads besides (backscrub_tpu/tflite/loader.py);
    # like it, no SqueezeOptions and no GeluOptions
    "MEAN": _REDUCER, "SUM": _REDUCER, "REDUCE_MAX": _REDUCER,
    "REDUCE_MIN": _REDUCER, "REDUCE_PROD": _REDUCER,
    "SPACE_TO_DEPTH": (19, _ints(block_size=0)),
    "DEPTH_TO_SPACE": (94, _ints(block_size=0)),
    "MIRROR_PAD": (77, lambda t: dict(mode=t.scalar(0, "<b"))),
    "GATHER": (23, _ints(axis=0)),
    "RESIZE_NEAREST_NEIGHBOR": (74, _flags(align_corners=0, half_pixel_centers=1)),
    "LEAKY_RELU": (75, lambda t: dict(alpha=t.scalar(0, "<f", 0.0))),
    "STRIDED_SLICE": (32, _ints(begin_mask=0, end_mask=1, ellipsis_mask=2,
                                new_axis_mask=3, shrink_axis_mask=4)),
    "PACK": (59, _ints(axis=1, values_count=0)),
    "UNPACK": (64, _ints(axis=1, num=0)),
    "WHILE": (93, _ints(cond_subgraph=0, body_subgraph=1)),
    "IF": (92, _ints(then_subgraph=0, else_subgraph=1)),
    "BATCH_MATMUL": (101, _flags(adj_x=0, adj_y=1)),
    "CUMSUM": (102, _flags(exclusive=0, reverse=1)),
    "ONE_HOT": (61, _ints(axis=0)),
    "TRANSPOSE_CONV": (49, lambda t: dict(padding=PADDING_NAMES[t.scalar(0, "<b")],
                                          stride_h=t.scalar(2, "<i"),
                                          stride_w=t.scalar(1, "<i"))),
}
# ADD/SUB/MUL/DIV: the fused activation is field 0 of each options table;
# a missing table still means "no activation"
_ARITH = {"ADD": 11, "MUL": 21, "SUB": 28, "DIV": 29}


def _parse_builtin_options(op: _Table, op_name: str) -> Dict[str, Any]:
    tab = op.table(4)
    if op_name in _ARITH:
        return dict(activation=_act(tab, 0) if tab is not None else "NONE")
    if op_name not in _OPTIONS or tab is None:
        return {}
    want, parse = _OPTIONS[op_name]
    got = op.scalar(3, "<B")
    if got != want:
        raise ValueError(f"{op_name} carries options type {got}, "
                         f"expected {want}")
    return parse(tab)


def _parse_custom_options(custom_code: str, data: Optional[bytes]) -> Dict[str, Any]:
    """``Convolution2DTransposeBias`` (MediaPipe) stores the raw C struct
    ``TfLiteTransposeConvParams``: three little-endian int32s
    ``{TfLitePadding padding; int stride_width; int stride_height;}``,
    TfLitePadding 0 = unknown, 1 = SAME, 2 = VALID."""
    if custom_code == "Convolution2DTransposeBias" and data and len(data) >= 12:
        padding, stride_w, stride_h = struct.unpack_from("<iii", data, 0)
        return dict(
            padding={0: "UNKNOWN", 1: "SAME", 2: "VALID"}.get(padding, "UNKNOWN"),
            stride_w=stride_w,
            stride_h=stride_h,
        )
    return dict(raw=bytes(data) if data else b"")


def load_tflite(path: str, subgraph: int = 0) -> GraphIR:
    """Load a ``.tflite`` file into a :class:`GraphIR`: subgraph
    ``subgraph``; the main graph (0) of a file with several carries them
    all in ``.subgraphs`` (WHILE/IF bodies reference them by index)."""
    with open(path, "rb") as f:
        buf = f.read()
    return load_tflite_bytes(buf, name=path, subgraph=subgraph)


def subgraph_count(buf: bytes) -> int:
    """The number of subgraphs in a ``.tflite`` file's bytes."""
    buf = bytes(buf)
    return len(_Table(buf, _read(buf, "<I", 0)).tables(2))


def load_tflite_bytes(buf: bytes, name: str = "<bytes>", subgraph: int = 0) -> GraphIR:
    """Parse the flatbuffer once; loading the main graph of a file with
    several subgraphs builds them all from the same parse, index 0 the
    main graph itself, the others named ``<name>#<i>`` where they have no
    name of their own."""
    buf = bytes(buf)
    model = _Table(buf, _read(buf, "<I", 0))
    codes: List[Dict[str, Any]] = []
    for oc in model.tables(1):
        # BuiltinCode (field 3) supersedes DeprecatedBuiltinCode (field 0),
        # which older files use for codes < 127
        code = max(oc.scalar(3, "<i"), oc.scalar(0, "<b"))
        codes.append({"name": BUILTIN_OPS.get(code, f"UNKNOWN_{code}"),
                      "custom": oc.string(1)})
    subs = model.tables(2)
    if not 0 <= subgraph < len(subs):
        raise ValueError(f"{name}: no subgraph {subgraph} (the model has {len(subs)})")
    buffers, desc = model.tables(4), model.string(3) or ""
    gir = _load_subgraph(subs[subgraph], buffers, codes, name, desc)
    if subgraph == 0 and len(subs) > 1:
        gir.subgraphs = [gir] + [_load_subgraph(subs[i], buffers, codes, f"{name}#{i}", desc)
                                 for i in range(1, len(subs))]
    return gir


def _dequantize(t: _Table, data: np.ndarray) -> np.ndarray:
    """Dynamic-range quantized constants (integer payload with scales) load
    as float, TFLite's own float fallback for such models."""
    q = t.table(4)
    scales = None if q is None else q.vector(2, np.float32)
    if scales is None or not len(scales) or not np.issubdtype(data.dtype, np.integer):
        return data
    zps = q.vector(3, np.int64)
    zps = np.zeros(1, np.int64) if zps is None or not len(zps) else zps
    bshape = [1] * data.ndim
    if scales.size > 1:
        bshape[q.scalar(6, "<i")] = scales.size
    return ((data.astype(np.float32)
             - zps.reshape(bshape if zps.size > 1 else [1] * data.ndim))
            * scales.reshape(bshape)).astype(np.float32)


def _load_subgraph(g: _Table, buffers: List[_Table], codes, name: str,
                   description: str) -> GraphIR:
    tensors: List[TensorIR] = []
    for ti, t in enumerate(g.tables(0)):
        shape_v = t.vector(0, np.int32)
        shape = tuple(int(s) for s in shape_v) if shape_v is not None else ()
        dtype = TENSOR_TYPE_TO_NP.get(t.scalar(1, "<b"), np.float32)
        data, span = None, None
        bidx = t.scalar(2, "<I")
        if bidx > 0:
            if bidx >= len(buffers):
                raise ValueError(f"tensor {ti} names buffer {bidx} of "
                                 f"{len(buffers)}")
            span = buffers[bidx].span(0)
            if span is not None and span[1]:
                data = np.frombuffer(buffers[bidx].vector(0, np.uint8).tobytes(), dtype=dtype)
                if shape:
                    data = data.reshape(shape)
                data = _dequantize(t, data)
                dtype = data.dtype.type
        tensors.append(TensorIR(index=ti, name=t.string(3) or f"t{ti}",
                                shape=shape, dtype=dtype, data=data,
                                buffer_offset=span[0] if span and span[1] else None,
                                buffer_size=span[1] if span else 0))

    nodes: List[NodeIR] = []
    for op in g.tables(3):
        code = codes[op.scalar(0, "<I")]
        inputs = [int(i) for i in op.vector(1, np.int32)]
        outputs = [int(i) for i in op.vector(2, np.int32)]
        if code["custom"] is not None:
            raw = op.vector(5, np.uint8)
            options = _parse_custom_options(
                code["custom"], raw.tobytes() if raw is not None else None)
            nodes.append(NodeIR(op="CUSTOM", inputs=inputs, outputs=outputs,
                                options=options, custom_code=code["custom"]))
        else:
            nodes.append(NodeIR(op=code["name"], inputs=inputs, outputs=outputs,
                                options=_parse_builtin_options(op, code["name"])))
    ins, outs = g.vector(1, np.int32), g.vector(2, np.int32)
    return GraphIR(
        name=g.string(4) or name,
        tensors=tensors,
        nodes=nodes,
        inputs=[int(i) for i in (ins if ins is not None else [])],
        outputs=[int(i) for i in (outs if outs is not None else [])],
        description=description,
    )
