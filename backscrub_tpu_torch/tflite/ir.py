"""Typed intermediate representation for TFLite graphs.

A copy of ``backscrub_tpu/tflite/ir.py`` (numpy dataclasses only): the
port cannot import the JAX package, whose ``__init__`` loads JAX.  The
loader (``tflite/loader.py``) fills it, with each tensor's payload span in
the file, which ``tflite/export.py`` patches; the graph executor
(``graph/executor.py``) runs it op by op in PyTorch.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

# TFLite TensorType enum -> numpy dtype.
TENSOR_TYPE_TO_NP = {
    0: np.float32,
    1: np.float16,
    2: np.int32,
    3: np.uint8,
    4: np.int64,
    5: np.bytes_,   # STRING
    6: np.bool_,
    7: np.int16,
    9: np.int8,
    10: np.float64,
}


@dataclasses.dataclass
class TensorIR:
    """One tensor in the graph: activation, weight, or constant."""

    index: int
    name: str
    shape: Tuple[int, ...]
    dtype: np.dtype
    data: Optional[np.ndarray] = None  # None for activations
    # where the payload lies in the file (tflite/loader.py), for export to
    # patch a copy in place: byte offset and length, None / 0 without one
    buffer_offset: Optional[int] = None
    buffer_size: int = 0

    @property
    def is_constant(self) -> bool:
        return self.data is not None

    def __repr__(self) -> str:  # compact debugging
        kind = "const" if self.is_constant else "act"
        return f"TensorIR(#{self.index} {self.name!r} {self.shape} {np.dtype(self.dtype).name} {kind})"


@dataclasses.dataclass
class NodeIR:
    """One operator invocation."""

    op: str                      # canonical op name, e.g. "CONV_2D"
    inputs: List[int]            # tensor indices (-1 == absent optional input)
    outputs: List[int]
    options: Dict[str, Any]      # parsed builtin/custom options
    custom_code: Optional[str] = None  # for op == "CUSTOM"

    @property
    def kind(self) -> str:
        return self.custom_code if self.op == "CUSTOM" and self.custom_code else self.op


@dataclasses.dataclass
class GraphIR:
    """A single TFLite subgraph."""

    name: str
    tensors: List[TensorIR]
    nodes: List[NodeIR]
    inputs: List[int]
    outputs: List[int]
    description: str = ""
    # constant-fold aliases: folded tensor index -> tensor index owning the
    # actual flatbuffer storage (e.g. DEQUANTIZE output -> f16 input)
    aliases: Dict[int, int] = dataclasses.field(default_factory=dict)
    # main graph only: all model subgraphs (index 0 = self), for WHILE/IF
    subgraphs: Optional[List["GraphIR"]] = None

    def tensor(self, idx: int) -> TensorIR:
        return self.tensors[idx]

    def op_histogram(self) -> Dict[str, int]:
        hist: Dict[str, int] = {}
        for n in self.nodes:
            hist[n.kind] = hist.get(n.kind, 0) + 1
        return hist

    def summary(self) -> str:
        lines = [f"graph {self.name!r}: {len(self.tensors)} tensors, {len(self.nodes)} nodes"]
        for i in self.inputs:
            lines.append(f"  input  {self.tensors[i]!r}")
        for i in self.outputs:
            lines.append(f"  output {self.tensors[i]!r}")
        for op, count in sorted(self.op_histogram().items(), key=lambda kv: -kv[1]):
            lines.append(f"  {op:40s} x{count}")
        return "\n".join(lines)
