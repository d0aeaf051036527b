"""Run a :class:`GraphIR` op by op in PyTorch (counterpart of
``backscrub_tpu/graph/executor.py``).

The JAX executor traces the graph into one XLA program; here the graph is
walked eagerly, each node through its lowering in ``ops/``.  Weights live
in a flat dict under the JAX executor's prepared keys (``t{i}`` for plain
constants, ``t{i}@hwio`` / ``@dw`` / ``@ko`` / ``@tconv`` for the layout
variants), so :func:`params_from_jax` maps the JAX model's parameters onto
this one key for key.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
from torch import nn

from ..tflite.ir import GraphIR
from ..ops.common import get_lowering
# imported for their lowering registrations
from ..ops import conv as _conv, elementwise as _ew, misc as _misc, pool as _pool  # noqa: F401


class LoweringCtx:
    """Per-run state handed to op lowerings: ``env`` maps tensor ids to
    values; ``get_const`` serves weights from ``params`` under their
    (variant) key, preparing the numpy layout on first sight."""

    def __init__(self, graph: GraphIR, params: Dict[str, torch.Tensor],
                 prepared: Optional[Dict[str, np.ndarray]] = None):
        self.graph = graph
        self.params = params
        self.prepared = prepared    # build-time store, None once built
        self.env: Dict[int, torch.Tensor] = {}

    def get(self, idx: int) -> torch.Tensor:
        if idx in self.env:
            return self.env[idx]
        if self.graph.tensor(idx).is_constant:
            return self.get_const(idx)
        raise KeyError(f"tensor {self.graph.tensor(idx)!r} referenced before definition")

    def get_const(self, idx: int, prepare: Optional[Callable] = None,
                  variant: str = "") -> torch.Tensor:
        key = f"t{idx}" + (f"@{variant}" if variant else "")
        if key not in self.params:
            if self.prepared is None:
                raise KeyError(f"parameter {key} was not prepared at build time")
            arr = self.graph.tensor(idx).data
            if prepare is not None:
                arr = prepare(arr)
            if np.issubdtype(arr.dtype, np.floating):
                arr = arr.astype(np.float32)   # f16 payloads widen exactly
            arr = np.ascontiguousarray(arr)
            self.prepared[key] = arr
            self.params[key] = torch.from_numpy(arr)
        return self.params[key]

    def const_value(self, idx: int) -> np.ndarray:
        t = self.graph.tensor(idx)
        if not t.is_constant:
            raise ValueError(f"tensor {t!r} must be a build-time constant")
        return t.data

    def set(self, idx: int, val: torch.Tensor):
        self.env[idx] = val


def fold_constants(graph: GraphIR) -> GraphIR:
    """Propagate constants through DEQUANTIZE/RESHAPE nodes (the f16 Meet
    and MLKit files wrap every weight in a DEQUANTIZE node); the f16 payload
    widens to f32 exactly when the parameter is prepared."""
    nodes: List = []
    for node in graph.nodes:
        if node.kind in ("DEQUANTIZE", "RESHAPE") and graph.tensor(node.inputs[0]).is_constant:
            t_in, t_out = graph.tensor(node.inputs[0]), graph.tensor(node.outputs[0])
            if node.kind == "DEQUANTIZE":
                t_out.data = t_in.data
            else:
                shape = (node.options.get("new_shape")
                         or graph.tensor(node.inputs[1]).data.reshape(-1))
                t_out.data = t_in.data.reshape([int(s) for s in shape])
            continue
        nodes.append(node)
    return dataclasses.replace(graph, nodes=nodes)


def run_nodes(graph: GraphIR, params, nodes, inputs: Dict[int, torch.Tensor],
              prepared=None) -> LoweringCtx:
    ctx = LoweringCtx(graph, params, prepared)
    for idx, x in inputs.items():
        ctx.set(idx, x)
    for node in nodes:
        get_lowering(node.kind)(ctx, node)
    return ctx


class CompiledModel(nn.Module):
    """A TFLite graph run eagerly on NHWC float tensors.

    ``forward(x)`` maps (N, H, W, C) float input to the model output, as the
    JAX ``CompiledModel`` does.  ``params`` holds the prepared weights (on
    the module's device); ``host_params`` their numpy copy.
    """

    def __init__(self, graph: GraphIR, params: Dict[str, torch.Tensor],
                 host_params: Dict[str, np.ndarray]):
        super().__init__()
        self.graph = graph
        self.params = params
        self.host_params = host_params
        self.input_shape = tuple(graph.tensor(graph.inputs[0]).shape)
        self.output_shape = tuple(graph.tensor(graph.outputs[0]).shape)

    def _apply(self, fn, recurse=True):
        # the parameter dict follows .to(device) like registered buffers
        self.params = {k: fn(v) for k, v in self.params.items()}
        return super()._apply(fn, recurse)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        g = self.graph
        ctx = run_nodes(g, self.params, g.nodes, {g.inputs[0]: x.float()})
        return ctx.get(g.outputs[0])


def span_fn(model: CompiledModel, start: int, end: int, in_tensor: int,
            out_tensor: int) -> Callable[[torch.Tensor], torch.Tensor]:
    """fn(x) running nodes[start:end] of the folded graph on ``in_tensor``
    and returning ``out_tensor`` (``pipeline/edge.py:_make_span_fn``)."""
    nodes = model.graph.nodes[start:end]

    def run(x: torch.Tensor) -> torch.Tensor:
        ctx = run_nodes(model.graph, model.params, nodes, {in_tensor: x.float()})
        return ctx.get(out_tensor)

    return run


def build_model(graph: GraphIR) -> CompiledModel:
    """Fold constants and prepare every weight with one run on zeros (the
    counterpart of the JAX executor's ``eval_shape`` pass)."""
    graph = fold_constants(graph)
    params: Dict[str, torch.Tensor] = {}
    prepared: Dict[str, np.ndarray] = {}
    x = torch.zeros(graph.tensor(graph.inputs[0]).shape, dtype=torch.float32)
    with torch.no_grad():
        run_nodes(graph, params, graph.nodes, {graph.inputs[0]: x}, prepared)
    return CompiledModel(graph, params, prepared)


def load_model(path: str, device="cuda") -> CompiledModel:
    """Path -> CompiledModel on ``device`` (the card unless the caller asks
    for the CPU; raises where CUDA is asked for and absent)."""
    from .._build import resolve_device
    from ..tflite.loader import load_tflite
    dev = resolve_device(device)
    return build_model(load_tflite(path)).to(dev)


def params_from_jax(params: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """The JAX ``CompiledModel.params`` / ``host_params`` as the port's
    parameter dict: same keys and layouts, widened to f32."""
    return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in params.items()}
