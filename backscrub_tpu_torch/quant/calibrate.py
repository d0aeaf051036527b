"""Activation-range calibration (counterpart of
``backscrub_tpu/quant/calibrate.py``).

Runs sample inputs through the graph executor and records per-tensor
min/max/absmax ranges: the groundwork for static (w8a8) quantization, and
a numerics diagnostic (layers whose dynamic range explodes are where bf16
or int8 fidelity is lost).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np
import torch

from ..graph.executor import LoweringCtx, fold_constants
from ..ops.common import get_lowering
from ..tflite.ir import GraphIR


@dataclasses.dataclass
class TensorRange:
    index: int
    name: str
    shape: tuple
    lo: float
    hi: float

    @property
    def absmax(self) -> float:
        return max(abs(self.lo), abs(self.hi))


class _RecordingCtx(LoweringCtx):
    """LoweringCtx that folds every float activation it defines into
    ``ranges``."""

    def __init__(self, *args, ranges: Dict[int, TensorRange], **kwargs):
        super().__init__(*args, **kwargs)
        self.ranges = ranges

    def set(self, idx: int, val: torch.Tensor):
        super().set(idx, val)
        if not val.is_floating_point():
            return
        lo, hi = float(val.min()), float(val.max())
        prev = self.ranges.get(idx)
        if prev is None:
            t = self.graph.tensor(idx)
            self.ranges[idx] = TensorRange(idx, t.name, tuple(val.shape), lo, hi)
        else:
            prev.lo, prev.hi = min(prev.lo, lo), max(prev.hi, hi)


@torch.no_grad()
def calibrate(graph: GraphIR, params: Dict[str, torch.Tensor], samples: List[np.ndarray],
              compute_dtype: torch.dtype = torch.float32) -> Dict[int, TensorRange]:
    """Record activation ranges over ``samples`` (each a model-input array)
    with the weights ``params`` (a ``CompiledModel``'s, under its keys; the
    samples go to their device).  Returns {tensor_index: TensorRange}
    aggregated over all samples."""
    graph = fold_constants(graph)
    dev = next(iter(params.values())).device
    ranges: Dict[int, TensorRange] = {}
    for x in samples:
        ctx = _RecordingCtx(graph, params, compute_dtype=compute_dtype, ranges=ranges)
        xs = x if isinstance(x, (tuple, list)) else (x,)
        for idx, xv in zip(graph.inputs, xs):
            xv = torch.as_tensor(xv).to(dev)
            ctx.set(idx, xv.to(compute_dtype) if xv.is_floating_point() else xv)
        for node in graph.nodes:
            get_lowering(node.kind)(ctx, node)
    return ranges


def report(ranges: Dict[int, TensorRange], top: int = 10) -> str:
    """Human-readable summary: widest dynamic ranges first."""
    rs = sorted(ranges.values(), key=lambda r: -r.absmax)
    lines = [f"{len(rs)} activations calibrated; widest ranges:"]
    for r in rs[:top]:
        lines.append(f"  #{r.index:4d} {r.name[:48]:48s} "
                     f"[{r.lo:10.3f}, {r.hi:10.3f}]")
    return "\n".join(lines)
