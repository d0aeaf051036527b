"""Run a :class:`GraphIR` op by op in PyTorch (counterpart of
``backscrub_tpu/graph/executor.py``).

The JAX executor traces the graph into one XLA program; here the graph is
walked eagerly, each node through its lowering in ``ops/``.  Weights live
in a flat dict under the JAX executor's prepared keys (``t{i}`` for plain
constants, ``t{i}@hwio`` / ``@dw`` / ``@ko`` / ``@tconv`` for the layout
variants), so :func:`params_from_jax` maps the JAX model's parameters onto
this one key for key.

The precision modes follow the JAX executor: ``compute_dtype`` (f32 or
bf16) is the dtype of every stored float weight and of the values between
ops; ``quantize="int8"`` stores the large conv kernels as per-channel int8
with an f32 ``__scale`` companion (``quant/ptq.py``), dequantized into the
compute dtype at use.  The ``host_params`` copy stays f32 numpy: in bf16
mode it holds the bf16-rounded values, as the JAX package's bf16 store
reads in f32, so the fused path's kernels take the same weights.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
from torch import nn

from ..tflite.ir import GraphIR
from ..ops.common import get_lowering
from ..quant.ptq import boundary_keys, dequantize, quantize_params
# imported for their lowering registrations
from ..ops import (conv as _conv, elementwise as _ew, misc as _misc, pool as _pool,  # noqa: F401
                   shape_ops as _shape, extended as _ext, control_flow as _cf)


class LoweringCtx:
    """Per-run state handed to op lowerings: ``env`` maps tensor ids to
    values; ``get_const`` serves weights from ``params`` under their
    (variant) key, preparing the numpy layout on first sight, in
    ``compute_dtype``; an int8 kernel dequantized once into ``dequantized``
    (the model's, kept across runs: key -> (int8 tensor, its dequantized
    value)).  ``weight_meta`` gets, for each key prepared here, how to map
    the parameter back into the file (``tflite/export.py``): its tensor
    index, its subgraph, the payload dtype (f16 for a folded DEQUANTIZE
    output) and the inverse of the layout transform, in the order the keys
    are prepared (the JAX executor's ``weight_meta``).

    Subgraphs (WHILE/IF bodies, ``all_graphs[k]``) run through
    :meth:`subgraph_fn` with the same parameters; their tensors' keys are
    ``s<k>t<i>`` (:meth:`key`).  ``static_vals`` holds the values known
    before the run (constants and folded shape math: SHAPE ->
    STRIDED_SLICE -> PACK -> RESHAPE chains), which fold to numpy as they
    do under XLA (:meth:`maybe_static`, :meth:`set_static`,
    :meth:`const_value`); ``device`` is where such values are placed.
    In the build pass (``prepared`` given) WHILE runs its cond and body
    once each and IF both branches, so that every subgraph weight is
    prepared whatever the data.

    On a mesh, ``tp`` is the run's ``parallel.sharding.TensorParallel``
    and ``params`` hold this rank's slices: ``get_const`` gathers a
    sharded parameter whole unless the lowering asks for its ``local``
    slice (tp's column split); in the spatial mode ``rows`` maps each
    row-sharded activation to its whole row count and ``halo`` holds the
    rows a convolution's input takes from its neighbours
    (:meth:`conv_input`)."""

    def __init__(self, graph: GraphIR, params: Dict[str, torch.Tensor],
                 prepared: Optional[Dict[str, np.ndarray]] = None,
                 compute_dtype: torch.dtype = torch.float32,
                 dequantized: Optional[Dict[str, tuple]] = None,
                 weight_meta: Optional[Dict[str, dict]] = None, tp=None,
                 all_graphs: Optional[List[GraphIR]] = None, sub_index: int = 0,
                 device=None):
        self.graph = graph
        self.params = params
        self.prepared = prepared    # build-time store, None once built
        self.compute_dtype = compute_dtype
        self.dequantized = {} if dequantized is None else dequantized
        self.weight_meta = {} if weight_meta is None else weight_meta
        self.tp = tp
        self.all_graphs = graph.subgraphs if all_graphs is None else all_graphs
        self.sub_index = sub_index
        self.device = device
        self.env: Dict[int, torch.Tensor] = {}
        self.static_vals: Dict[int, np.ndarray] = {}
        self.rows: Dict[int, int] = {}
        self.halo: Dict[int, torch.Tensor] = {}

    def get(self, idx: int) -> torch.Tensor:
        if idx in self.env:
            return self.env[idx]
        if self.graph.tensor(idx).is_constant:
            return self.get_const(idx)
        raise KeyError(f"tensor {self.graph.tensor(idx)!r} referenced before definition")

    def key(self, idx: int, variant: str = "") -> str:
        """A parameter's key: ``t<i>`` in the main graph, ``s<k>t<i>`` in
        subgraph k, ``@<variant>`` for a layout variant."""
        base = f"t{idx}" if self.sub_index == 0 else f"s{self.sub_index}t{idx}"
        return base + (f"@{variant}" if variant else "")

    def subgraph_fn(self, sub_idx: int) -> Callable:
        """fn(values) -> tuple of outputs running subgraph ``sub_idx`` on
        a tuple of values (dtypes kept: integer loop counters stay
        integers), with this run's parameters, stores and mesh."""
        if self.all_graphs is None:
            raise ValueError("model has no subgraphs (WHILE/IF need them)")
        sub = self.all_graphs[sub_idx]

        def run(vals):
            ctx = LoweringCtx(sub, self.params, self.prepared, self.compute_dtype,
                              self.dequantized, self.weight_meta, self.tp,
                              all_graphs=self.all_graphs, sub_index=sub_idx,
                              device=self.device)
            vals = vals if isinstance(vals, (tuple, list)) else (vals,)
            for idx, v in zip(sub.inputs, vals):
                ctx.env[idx] = v
            for node in sub.nodes:
                get_lowering(node.kind)(ctx, node)
            return tuple(ctx.get(i) for i in sub.outputs)

        return run

    def column(self, idx: int, variant: str = "") -> bool:
        """Whether the op whose kernel is ``idx`` (in ``variant``'s layout)
        computes only this rank's output channels (tp's column split)."""
        return self.tp is not None and self.tp.column(self.key(idx, variant))

    def conv_input(self, idx: int):
        """A convolution's input and the rows of SAME padding it still
        needs: (the tensor, None), or in the spatial mode (the rows its
        output rows read, zeros for the padding, (0, 0))."""
        if idx in self.halo:
            return self.halo[idx], (0, 0)
        return self.get(idx), None

    def get_const(self, idx: int, prepare: Optional[Callable] = None,
                  variant: str = "", inverse: Optional[Callable] = None,
                  local: bool = False) -> torch.Tensor:
        key = self.key(idx, variant)
        if key not in self.params:
            t = self.graph.tensor(idx)
            if not t.is_constant:
                # an activation fed to a weight slot (rare): this run's value
                return self.get(idx)
            if self.prepared is None:
                raise KeyError(f"parameter {key} was not prepared at build time")
            arr = t.data
            self.weight_meta[key] = dict(tensor_index=idx, inverse=inverse, dtype=arr.dtype,
                                         subgraph=self.sub_index)
            if prepare is not None:
                arr = prepare(arr)
            if np.issubdtype(arr.dtype, np.floating):
                arr = arr.astype(np.float32)   # f16 payloads widen exactly
            arr = np.ascontiguousarray(arr)
            if not arr.flags.writeable:
                arr = arr.copy()             # a payload read in place from the file
            t = torch.from_numpy(arr)
            if t.is_floating_point() and self.compute_dtype != torch.float32:
                t = t.to(self.compute_dtype)   # bf16 rounds each float once
                arr = t.float().numpy()
            self.prepared[key] = arr
            self.params[key] = t.to(self.device) if self.device is not None else t
        val = self.params[key]
        scale = self.params.get(key + "__scale")
        if scale is not None and not val.is_floating_point():
            hit = self.dequantized.get(key)
            if hit is None or hit[0] is not val:    # new, or the parameters were replaced
                hit = self.dequantized[key] = (val, dequantize(val, scale, self.compute_dtype))
            return hit[1]
        if self.tp is not None and not local and self.tp.sharded(key):
            return self.tp.whole(val, key)
        return val

    def const_value(self, idx: int) -> np.ndarray:
        """A value needed before the run (shapes, axes, paddings): a
        constant's payload or folded shape math."""
        if idx in self.static_vals:
            return self.static_vals[idx]
        t = self.graph.tensor(idx)
        if not t.is_constant:
            raise ValueError(f"tensor {t!r} must be a build-time constant")
        return t.data

    def maybe_static(self, idx: int) -> Optional[np.ndarray]:
        """The value known before the run, if any (a constant or folded
        shape math)."""
        if idx in self.static_vals:
            return self.static_vals[idx]
        t = self.graph.tensor(idx)
        return t.data if t.is_constant else None

    def set_static(self, idx: int, value) -> None:
        self.static_vals[idx] = np.array(value)
        self.env[idx] = torch.from_numpy(self.static_vals[idx].copy()).to(self.device)

    def set(self, idx: int, val: torch.Tensor):
        self.env[idx] = val


def fold_constants(graph: GraphIR) -> GraphIR:
    """Propagate constants through DEQUANTIZE/RESHAPE nodes (the f16 Meet
    and MLKit files wrap every weight in a DEQUANTIZE node); the f16 payload
    widens to f32 exactly when the parameter is prepared.  ``aliases`` maps
    each folded output to the tensor holding its payload, as in the JAX
    executor (``quant.ptq.boundary_keys`` reads it)."""
    nodes: List = []
    aliases = dict(graph.aliases)
    for node in graph.nodes:
        if node.kind in ("DEQUANTIZE", "RESHAPE") and graph.tensor(node.inputs[0]).is_constant:
            t_in, t_out = graph.tensor(node.inputs[0]), graph.tensor(node.outputs[0])
            if node.kind == "DEQUANTIZE":
                t_out.data = t_in.data
            else:
                shape = (node.options.get("new_shape")
                         or graph.tensor(node.inputs[1]).data.reshape(-1))
                t_out.data = t_in.data.reshape([int(s) for s in shape])
            aliases[t_out.index] = aliases.get(t_in.index, t_in.index)
            continue
        nodes.append(node)
    return dataclasses.replace(graph, nodes=nodes, aliases=aliases)


def run_nodes(graph: GraphIR, params, nodes, inputs: Dict[int, torch.Tensor],
              prepared=None, compute_dtype: torch.dtype = torch.float32,
              dequantized=None, weight_meta=None, tp=None) -> LoweringCtx:
    dev = next(iter(inputs.values())).device if inputs else None
    ctx = LoweringCtx(graph, params, prepared, compute_dtype, dequantized, weight_meta, tp,
                      device=dev)
    for idx, x in inputs.items():
        ctx.set(idx, x)
        if tp is not None:
            tp.enter(ctx, idx)
    spatial = tp is not None and tp.spatial
    for node in nodes:
        if spatial:
            tp.run_node(ctx, node, get_lowering(node.kind))
        else:
            get_lowering(node.kind)(ctx, node)
    return ctx


def _inputs(graph: GraphIR, x, compute_dtype) -> Dict[int, torch.Tensor]:
    """The graph inputs from ``x`` (one tensor, or a tuple with one per
    input): floats in ``compute_dtype``, other dtypes as given."""
    xs = tuple(x) if isinstance(x, (tuple, list)) else (x,)
    if len(graph.inputs) != len(xs):
        raise ValueError(f"graph has {len(graph.inputs)} inputs, got {len(xs)}")
    return {i: v.to(compute_dtype) if v.is_floating_point() else v
            for i, v in zip(graph.inputs, xs)}


class CompiledModel(nn.Module):
    """A TFLite graph run eagerly on NHWC float tensors.

    ``forward(x)`` maps (N, H, W, C) float input to the model output in
    ``compute_dtype``, as the JAX ``CompiledModel`` does (a graph with
    several inputs takes a tuple, one with several outputs returns one,
    integer inputs keep their dtype); ``raw_fn(params,
    x)`` runs it on a caller's parameter dict (every key of ``params``),
    the functional form that training differentiates; with ``tp`` (a
    ``parallel.sharding.TensorParallel``) ``params`` are this rank's
    slices and the run is tensor-parallel over the mesh's "model" axis,
    returning in its spatial mode this rank's rows of the output.
    ``params`` holds
    the prepared weights (on the module's device); ``host_params`` their
    numpy copy; ``weight_meta`` each key's way back into the file
    (:class:`LoweringCtx`); ``quantize_mode`` is None or "int8";
    ``dequantized`` the int8 kernels in ``compute_dtype``, each made at its
    first use and kept.
    """

    def __init__(self, graph: GraphIR, params: Dict[str, torch.Tensor],
                 host_params: Dict[str, np.ndarray],
                 compute_dtype: torch.dtype = torch.float32,
                 quantize_mode: Optional[str] = None,
                 weight_meta: Optional[Dict[str, dict]] = None):
        super().__init__()
        self.graph = graph
        self.params = params
        self.host_params = host_params
        self.compute_dtype = compute_dtype
        self.quantize_mode = quantize_mode
        self.weight_meta = {} if weight_meta is None else weight_meta
        self.dequantized: Dict[str, tuple] = {}
        self.input_shape = tuple(graph.tensor(graph.inputs[0]).shape)
        self.output_shape = tuple(graph.tensor(graph.outputs[0]).shape)

    def _apply(self, fn, recurse=True):
        # the parameter dict follows .to(device) like registered buffers
        self.params = {k: fn(v) for k, v in self.params.items()}
        self.dequantized = {}
        return super()._apply(fn, recurse)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.raw_fn(self.params, x, self.dequantized)

    def raw_fn(self, params: Dict[str, torch.Tensor], x,
               dequantized: Optional[Dict[str, tuple]] = None, tp=None):
        g = self.graph
        ctx = run_nodes(g, params, g.nodes, _inputs(g, x, self.compute_dtype),
                        compute_dtype=self.compute_dtype, dequantized=dequantized, tp=tp)
        outs = [tp.leave(ctx, i) if tp is not None else ctx.get(i) for i in g.outputs]
        return outs[0] if len(outs) == 1 else tuple(outs)


def span_fn(model: CompiledModel, start: int, end: int, in_tensor: int,
            out_tensor: int) -> Callable[[torch.Tensor], torch.Tensor]:
    """fn(x) running nodes[start:end] of the folded graph on ``in_tensor``
    and returning ``out_tensor`` (``pipeline/edge.py:_make_span_fn``), both
    in the model's compute dtype."""
    nodes, cd = model.graph.nodes[start:end], model.compute_dtype

    def run(x: torch.Tensor) -> torch.Tensor:
        ctx = run_nodes(model.graph, model.params, nodes, {in_tensor: x.to(cd)},
                        compute_dtype=cd, dequantized=model.dequantized)
        return ctx.get(out_tensor)

    return run


COMPUTE_DTYPES = (torch.float32, torch.bfloat16)


def build_model(graph: GraphIR, compute_dtype: torch.dtype = torch.float32,
                quantize: Optional[str] = None) -> CompiledModel:
    """Fold constants (in every subgraph) and prepare every weight with one
    run on zeros (the counterpart of the JAX executor's ``eval_shape``
    pass; control flow runs each subgraph once in it), in
    ``compute_dtype`` (torch.float32 or torch.bfloat16); ``quantize="int8"``
    then quantizes the prepared kernels (``quant.ptq.quantize_params``, the
    first and last two nodes' inputs excluded)."""
    if compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype must be one of {COMPUTE_DTYPES}, got {compute_dtype}")
    if quantize not in (None, "int8"):
        raise ValueError(f"quantize must be None or 'int8', got {quantize!r}")
    if graph.subgraphs is not None:
        # fold every subgraph; index 0 stays the main graph
        all_graphs = [fold_constants(g) for g in graph.subgraphs]
        graph = all_graphs[0]
        graph.subgraphs = all_graphs
    else:
        graph = fold_constants(graph)
    params: Dict[str, torch.Tensor] = {}
    prepared: Dict[str, np.ndarray] = {}
    weight_meta: Dict[str, dict] = {}
    zeros = {}
    for i in graph.inputs:
        t = graph.tensor(i)
        dt = (compute_dtype if np.issubdtype(t.dtype, np.floating)
              else torch.from_numpy(np.zeros(0, t.dtype)).dtype)
        zeros[i] = torch.zeros(t.shape, dtype=dt)
    with torch.no_grad():
        run_nodes(graph, params, graph.nodes, zeros, prepared, compute_dtype,
                  weight_meta=weight_meta)
    if quantize == "int8":
        qparams, scales = quantize_params(prepared, exclude=boundary_keys(graph))
        for k, s in scales.items():
            prepared[k], prepared[k + "__scale"] = qparams[k], s
            params[k], params[k + "__scale"] = torch.from_numpy(qparams[k]), torch.from_numpy(s)
    return CompiledModel(graph, params, prepared, compute_dtype, quantize, weight_meta)


def load_model(path: str, device="cuda", *, compute_dtype: torch.dtype = torch.float32,
               quantize: Optional[str] = None) -> CompiledModel:
    """Path -> CompiledModel on ``device`` (the card unless the caller asks
    for the CPU; raises where CUDA is asked for and absent), in
    ``compute_dtype``, its kernels int8 with ``quantize="int8"``."""
    from .._build import resolve_device
    from ..tflite.loader import load_tflite
    dev = resolve_device(device)
    return build_model(load_tflite(path), compute_dtype, quantize).to(dev)


def params_from_jax(params: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """The JAX ``CompiledModel.params`` / ``host_params`` as the port's
    parameter dict: same keys and layouts (``s<k>t<i>`` for a subgraph's);
    floats widened to f32 (a bf16 store exactly); int8 kernels beside
    their f32 ``__scale``, and integer and bool constants, keep their
    dtype."""
    out = {}
    for k, v in params.items():
        a = np.asarray(v)
        floating = np.issubdtype(a.dtype, np.floating) or a.dtype.name == "bfloat16"
        out[k] = torch.from_numpy(np.array(a, np.float32 if floating else a.dtype))
    return out
