"""Shared helpers for op lowerings, and the lowering registry.

Activations between layers are NHWC float tensors, as in the JAX
executor, so that axis numbers, reshapes and FULLY_CONNECTED's
``keep_num_dims`` mean the same thing in both; the convolution lowerings
move to PyTorch's NCHW only around ``torch.nn.functional`` calls.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

_LOWERINGS: Dict[str, Callable] = {}


def register(kind: str):
    def deco(fn):
        _LOWERINGS[kind] = fn
        return fn
    return deco


def get_lowering(kind: str) -> Callable:
    try:
        return _LOWERINGS[kind]
    except KeyError:
        raise NotImplementedError(f"TFLite op {kind!r} has no lowering; "
                                  f"supported: {sorted(_LOWERINGS)}") from None


def scalar_like(v: float, x: torch.Tensor) -> float:
    """A Python number as a JAX weak-typed scalar meets ``x``: rounded to
    bf16 where x is bf16 (PyTorch would compute with the unrounded value),
    else the number itself."""
    if x.dtype == torch.bfloat16:
        return float(torch.tensor(v, dtype=torch.bfloat16))
    return v


# 1/6 rounded to bf16: a JAX scalar takes its array's dtype, so in bf16
# the reference multiplies by this value, not by f32(1/6)
_SIXTH_BF16 = 0.1669921875


def hard_swish(x: torch.Tensor) -> torch.Tensor:
    """TFLite HARD_SWISH: x * relu6(x + 3) / 6, each op rounded to x's
    dtype as in the JAX lowering."""
    sixth = _SIXTH_BF16 if x.dtype == torch.bfloat16 else 1.0 / 6.0
    return x * torch.clamp(x + 3.0, 0.0, 6.0) * sixth


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """LOGISTIC.  In bf16 as the JAX package computes ``jax.nn.sigmoid``
    there, 1 / (1 + exp(-x)) with every op rounded to bf16; else
    ``torch.sigmoid``."""
    if x.dtype == torch.bfloat16:
        return 1.0 / (1.0 + torch.exp(-x))
    return torch.sigmoid(x)


def apply_activation(x: torch.Tensor, activation) -> torch.Tensor:
    """TFLite fused activations, plus the standalone kinds the body uses."""
    if activation in (None, "NONE"):
        return x
    if activation == "RELU":
        return torch.relu(x)
    if activation == "RELU6":
        return torch.clamp(x, 0.0, 6.0)
    if activation == "RELU_N1_TO_1":
        return torch.clamp(x, -1.0, 1.0)
    if activation == "TANH":
        return torch.tanh(x)
    if activation == "HARD_SWISH":
        return hard_swish(x)
    if activation == "LOGISTIC":
        return sigmoid(x)
    raise NotImplementedError(f"fused activation {activation!r}")


def tflite_same_padding(in_size: int, filter_size: int, stride: int, dilation: int = 1):
    """TFLite/XLA SAME padding (identical conventions): returns (lo, hi)."""
    eff = (filter_size - 1) * dilation + 1
    out = -(-in_size // stride)
    total = max((out - 1) * stride + eff - in_size, 0)
    lo = total // 2
    return lo, total - lo
