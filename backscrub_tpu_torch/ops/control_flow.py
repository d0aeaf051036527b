"""Control-flow lowerings: WHILE, IF, and the comparison, logical and
select ops that feed them (counterpart of
``backscrub_tpu/ops/control_flow.py``).

TFLite expresses control flow as operators that name other subgraphs by
index.  The JAX package traces them into ``lax.while_loop`` and
``lax.cond``; here they run eagerly through
:meth:`LoweringCtx.subgraph_fn`, whose weights sit in the same parameter
dict under ``s<k>t<i>`` keys.  WHILE reads its condition back to the host
once an iteration.  Loop-carried shapes and dtypes are invariant (true of
converter output): the body's outputs are cast to the initial values'
dtypes, as in the JAX lowering.

In the build pass (``ctx.prepared`` set: one run on zeros that prepares
the weights) WHILE runs its cond and body once each and returns the
initial values, and IF runs both branches and returns the then-branch's
result, so that every subgraph's weights are prepared whatever the data,
as the JAX executor's abstract trace of both does.

Training: ``jax.grad`` cannot differentiate ``lax.while_loop`` in reverse
mode.  Where a WHILE's carried values lie on the gradient path (an
initial value or a body weight needs a gradient), the lowering raises
ValueError naming the node, rather than differentiating a Python loop
that the JAX package refuses.
"""

from __future__ import annotations

import torch

from .common import register
from .elementwise import _binary

for _name, _fn in {
    "GREATER": torch.gt, "GREATER_EQUAL": torch.ge,
    "LESS": torch.lt, "LESS_EQUAL": torch.le,
    "EQUAL": torch.eq, "NOT_EQUAL": torch.ne,
    "LOGICAL_AND": torch.logical_and, "LOGICAL_OR": torch.logical_or,
}.items():
    register(_name)(lambda ctx, node, _f=_fn: _binary(ctx, node, _f))


@register("LOGICAL_NOT")
def logical_not(ctx, node):
    ctx.set(node.outputs[0], torch.logical_not(ctx.get(node.inputs[0])))


@register("SELECT")
def select(ctx, node):
    cond = ctx.get(node.inputs[0])
    ctx.set(node.outputs[0], torch.where(cond.bool(), ctx.get(node.inputs[1]),
                                         ctx.get(node.inputs[2])))


register("SELECT_V2")(select)


def _as_pred(x: torch.Tensor) -> bool:
    """A () or (1,)-shaped tensor as the host's bool (one read back)."""
    return bool(x.reshape(()).bool())


def _on_grad_path(ctx, init, body_index: int) -> bool:
    """Whether a WHILE's carried values would need gradients: autograd on,
    and an initial value or a weight of the body subgraph requires one."""
    if not torch.is_grad_enabled():
        return False
    prefix = f"s{body_index}t"
    return (any(v.requires_grad for v in init)
            or any(p.requires_grad for k, p in ctx.params.items() if k.startswith(prefix)))


@register("WHILE")
def while_op(ctx, node):
    o = node.options
    cond = ctx.subgraph_fn(o["cond_subgraph"])
    body = ctx.subgraph_fn(o["body_subgraph"])
    init = tuple(ctx.get(i) for i in node.inputs)
    if _on_grad_path(ctx, init, o["body_subgraph"]):
        raise ValueError(
            f"WHILE node (outputs {node.outputs}, body subgraph {o['body_subgraph']}) "
            "carries values on the gradient path: reverse-mode differentiation of a "
            "while loop is refused, as jax.grad refuses lax.while_loop")
    if ctx.prepared is not None:
        cond(init)
        body(init)
        vals = init
    else:
        vals = init
        while _as_pred(cond(vals)[0]):
            vals = tuple(v.to(i.dtype) for v, i in zip(body(vals), init))
            while_op.iterations += 1
    for out_idx, val in zip(node.outputs, vals):
        ctx.set(out_idx, val)


# body runs of every WHILE since the count was last set to 0
while_op.iterations = 0


@register("IF")
def if_op(ctx, node):
    o = node.options
    then_fn = ctx.subgraph_fn(o["then_subgraph"])
    else_fn = ctx.subgraph_fn(o["else_subgraph"])
    pred = ctx.get(node.inputs[0])
    operands = tuple(ctx.get(i) for i in node.inputs[1:])
    if ctx.prepared is not None:
        res = then_fn(operands)
        else_fn(operands)
    else:
        res = then_fn(operands) if _as_pred(pred) else else_fn(operands)
    for out_idx, val in zip(node.outputs, res):
        ctx.set(out_idx, val)
