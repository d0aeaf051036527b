"""Post-training quantization: per-channel int8 weights (counterpart of
``backscrub_tpu/quant/ptq.py``, whose numpy it copies: the port imports
nothing of the JAX package).

``load_model(path, quantize="int8")`` stores conv / depthwise / transposed
conv kernels as symmetric per-output-channel int8 with an f32 scale each;
the graph executor dequantizes them into the compute dtype at use
(:func:`dequantize`).  Activations stay in the compute dtype.  The fused
edge path refuses a quantized model, so int8 runs the classic stages.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch


def quantize_per_channel(w: np.ndarray, channel_axis: int) -> Tuple[np.ndarray, np.ndarray]:
    """Symmetric int8 quantization along ``channel_axis``: (w_q int8,
    scales f32) with w ~= w_q * scales broadcast along the channel axis."""
    w = np.asarray(w, np.float32)
    red = tuple(a for a in range(w.ndim) if a != channel_axis)
    absmax = np.maximum(np.abs(w).max(axis=red, keepdims=True), 1e-12)
    scales = (absmax / 127.0).astype(np.float32)
    w_q = np.clip(np.round(w / scales), -127, 127).astype(np.int8)
    return w_q, scales


def dequantize(w_q: torch.Tensor, scales: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """w_q * scales, both cast to ``dtype`` first (the JAX package's order)."""
    return w_q.to(dtype) * scales.to(dtype)


def boundary_keys(graph, n_edge: int = 2) -> set:
    """Param keys fed to the first and last ``n_edge`` nodes of the folded
    graph, with the source tensor of a folded DEQUANTIZE: these stay full
    precision (the input-adjacent and logit-producing layers are the most
    quantization-sensitive)."""
    keys = set()
    aliases = getattr(graph, "aliases", None) or {}
    for node in list(graph.nodes)[:n_edge] + list(graph.nodes)[-n_edge:]:
        for i in node.inputs:
            keys.add(f"t{i}")
            if i in aliases:
                keys.add(f"t{aliases[i]}")
    return keys


def quantize_params(prepared: Dict[str, np.ndarray], exclude: set = frozenset()
                    ) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    """Quantize every floating kernel of at least 3 dimensions and 512
    elements in a prepared-params dict whose base key (before ``@``) is not
    in ``exclude``; kernels are HWIO / (fh, fw, 1, C) after the layout
    transforms, so the output channel is the last axis.  Biases, the 2-D FC
    kernels (the SE blocks', tiny and quantization-sensitive) and small
    tensors keep their dtype.  Returns (new params, scales by key)."""
    out: Dict[str, np.ndarray] = {}
    scales: Dict[str, np.ndarray] = {}
    for k, v in prepared.items():
        if (k.split("@")[0] not in exclude
                and np.issubdtype(v.dtype, np.floating)
                and v.ndim >= 3 and v.size >= 512):
            out[k], scales[k] = quantize_per_channel(v, channel_axis=v.ndim - 1)
        else:
            out[k] = v
    return out, scales
