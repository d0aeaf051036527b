"""Elementwise lowerings: ADD, SUB, MUL, DIV, MINIMUM, MAXIMUM, RELU,
RELU6, RELU_N1_TO_1, TANH, LEAKY_RELU, PRELU, HARD_SWISH, LOGISTIC,
DEQUANTIZE (counterpart of ``backscrub_tpu/ops/elementwise.py``)."""

from __future__ import annotations

import torch

from .common import apply_activation, hard_swish, register, scalar_like, sigmoid


def _binary(ctx, node, fn):
    y = fn(ctx.get(node.inputs[0]), ctx.get(node.inputs[1]))
    ctx.set(node.outputs[0], apply_activation(y, node.options.get("activation")))


@register("ADD")
def add(ctx, node):
    _binary(ctx, node, torch.add)


@register("SUB")
def sub(ctx, node):
    _binary(ctx, node, torch.sub)


@register("MUL")
def mul(ctx, node):
    _binary(ctx, node, torch.mul)


@register("DIV")
def div(ctx, node):
    _binary(ctx, node, torch.div)


@register("MINIMUM")
def minimum(ctx, node):
    _binary(ctx, node, torch.minimum)


@register("MAXIMUM")
def maximum(ctx, node):
    _binary(ctx, node, torch.maximum)


def _unary(ctx, node, fn):
    ctx.set(node.outputs[0], fn(ctx.get(node.inputs[0])))


@register("RELU")
def relu(ctx, node):
    _unary(ctx, node, torch.relu)


@register("RELU6")
def relu6(ctx, node):
    _unary(ctx, node, lambda x: torch.clamp(x, 0.0, 6.0))


@register("RELU_N1_TO_1")
def relu_n1_to_1(ctx, node):
    _unary(ctx, node, lambda x: torch.clamp(x, -1.0, 1.0))


@register("TANH")
def tanh(ctx, node):
    _unary(ctx, node, torch.tanh)


@register("LEAKY_RELU")
def leaky_relu(ctx, node):
    alpha = node.options.get("alpha", 0.01)
    _unary(ctx, node, lambda x: torch.where(x >= 0, x, scalar_like(alpha, x) * x))


@register("PRELU")
def prelu(ctx, node):
    x, alpha = ctx.get(node.inputs[0]), ctx.get(node.inputs[1])
    ctx.set(node.outputs[0], torch.where(x >= 0, x, alpha * x))


@register("LOGISTIC")
def logistic(ctx, node):
    _unary(ctx, node, sigmoid)


@register("HARD_SWISH")
def hard_swish_op(ctx, node):
    _unary(ctx, node, hard_swish)


@register("DEQUANTIZE")
def dequantize(ctx, node):
    """f16 -> the compute dtype.  Constant inputs are folded at load
    (graph/executor.py fold_constants); this handles activations."""
    _unary(ctx, node, lambda x: x.to(ctx.compute_dtype))
