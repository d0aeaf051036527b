"""The seven probe kernels (P1-P7) of ``tools/probe_mosaic.py`` on Hopper.

Each wrapper runs its plain PyTorch twin on CPU tensors and launches its
kernel of ``csrc/probes.cu`` on CUDA tensors, counting launches in its
``launches`` attribute; ``*_plain`` is the twin.  The one PyTorch call that
computes the same function, where there is one: ``*_library`` for the
stencils (a sparse depthwise ``F.conv1d``), ``torch.matmul`` for P3, none
for P4, and for P5-P7 the twin itself (``torch.cat``, the strided slice,
the clone).  ``tools/probe_hopper.py`` runs them on the original's inputs.

- P1 :func:`dw_flat`: the 9-tap stencil of ``k_dw_flat`` on the flat
  (C, H*W) layout, from a (C, H*W + 4W) input zero-padded by 2W a side.
- P2 :func:`dw_rowpad`: the same taps on the rowpad layout of ``k_dwp``
  (rows at a 128-float stride): (C, n) -> (C, n - 256).  Both launch
  ``bs_probe_dw9``: a register window of 4 outputs a thread (16-byte
  loads, the edge taps by warp shuffles) where the row's offsets, widths
  and pointers allow 16-byte vectors, else one output a thread.
- P3 :func:`dot`: ``mk_dot``'s weight-stationary (16, 16) @ (16, N) at
  "default" (one bf16 pass), "high" (bf16x3, K2''s GEMM) or "highest" (f32);
  the first two on ``wgmma``, one 64-column tile a warpgroup.
- P4 :func:`se`: ``k_se``, x * sigmoid(w @ mean(x, 1)), as one
  thread-block cluster whose CTAs share their row sums through distributed
  shared memory; a card that refuses the cluster raises.
- P5 :func:`concat`: ``k_cat`` as a two-source copy: one launch whose
  grid is split between ``a`` and ``b``, each half the strided copy's
  vector body (below) where both counts are whole 16-byte vectors and the
  pointers aligned, else one float a thread; past 2**31 - 1 floats in all
  the launcher refuses and the wrapper raises.
- P6 :func:`lane_stride2`, P7 :func:`reshape_flat`: ``k_ls`` and ``k_rs``
  as one strided copy, out[r, j] = x[r, S j] with S = 2 and 1 (P7 on the
  flat (C, H*W) view): on 16-byte vectors where the copy is flat and
  the output whole vectors, every load issued before the first store,
  else one output a thread.

Kernel and twin agree bit for bit for P1, P2 and P5-P7 (the stencils
multiply and add without contraction, in the twin's order), within 1e-5 for
P3 and P4 (only the summation order differs).  TF32 stays off
(``pipeline/maskgen.py:set_precision_policy``) for the f32 twins.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .. import _build
from .megakernel import conv1x1_bf16x3_plain

ROWPAD = 128                        # P2's row stride (floats)
PRECISIONS = ("default", "high", "highest")


def _tap(di: int, dj: int) -> float:
    """The stencil weight 0.1 + di + 2 dj as the f32 the kernels use."""
    return float(np.float32(0.1 + di + 2 * dj))


def _check(x: torch.Tensor, name: str, ndim: int) -> None:
    """A contiguous f32 CUDA tensor of ``ndim`` dims, before its pointer goes
    to a kernel."""
    _build.check_cuda(x, name, torch.float32)
    if x.ndim != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got {tuple(x.shape)}")


def _out(x: torch.Tensor, *shape) -> torch.Tensor:
    return torch.empty(shape, dtype=torch.float32, device=x.device)


# -- P1, P2: the 9-tap stencils ------------------------------------------------

def dw_flat_plain(xp: torch.Tensor, width: int) -> torch.Tensor:
    """out[c, p] = sum_{di, dj} xp[c, p + 2W + di W + dj] (0.1 + di + 2 dj)."""
    hw = xp.shape[1] - 4 * width
    acc = torch.zeros((xp.shape[0], hw), dtype=torch.float32, device=xp.device)
    for di in (-1, 0, 1):
        for dj in (-1, 0, 1):
            s = 2 * width + di * width + dj
            acc = acc + xp[:, s:s + hw] * _tap(di, dj)
    return acc


def dw_rowpad_plain(xp: torch.Tensor) -> torch.Tensor:
    """The rowpad taps: rows di = 0, 1, 2 at a ROWPAD stride, dj = -1/+1
    from the row shifted a float right/left with a zero at the end of the
    flat row only (the neighbouring padded row is read)."""
    n = xp.shape[1]
    hp = n - 2 * ROWPAD
    xm = F.pad(xp[:, 1:], (0, 1))
    xpl = F.pad(xp[:, :n - 1], (1, 0))
    acc = torch.zeros((xp.shape[0], hp), dtype=torch.float32, device=xp.device)
    for di in (0, 1, 2):
        base = di * ROWPAD
        for dj, src in ((-1, xpl), (0, xp), (1, xm)):
            acc = acc + src[:, base:base + hp] * _tap(di, dj)
    return acc


def dw_taps(c: int, stride: int, di0: int, device) -> torch.Tensor:
    """The stencil as a depthwise conv1d kernel (c, 1, 2 stride + 3): tap
    (di0 + a, dj) at a * stride + dj + 1, zeros between."""
    k = torch.zeros((c, 1, 2 * stride + 3), dtype=torch.float32)
    for a in range(3):
        for dj in (-1, 0, 1):
            k[:, 0, a * stride + dj + 1] = _tap(di0 + a, dj)
    return k.to(device)


def dw_flat_library(xp: torch.Tensor, width: int, taps: torch.Tensor) -> torch.Tensor:
    """P1 as one F.conv1d (taps = dw_taps(C, width, -1)) over xp[:, W-1:]."""
    hw = xp.shape[1] - 4 * width
    return F.conv1d(xp[None, :, width - 1:], taps, groups=xp.shape[0])[0, :, :hw]


def dw_rowpad_library(xp: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """P2 as one F.conv1d (taps = dw_taps(C, ROWPAD, 0)), zero-padded by one
    float a side."""
    return F.conv1d(xp[None], taps, padding=1, groups=xp.shape[0])[0]


def dw_flat(xp: torch.Tensor, width: int) -> torch.Tensor:
    """P1 on (C, H*W + 4W) f32 with row width ``width`` -> (C, H*W)."""
    if xp.device.type == "cpu":
        return dw_flat_plain(xp, width)
    _check(xp, "dw_flat input", 2)
    c, n = xp.shape
    if n - 4 * width < 1:
        raise ValueError(f"dw_flat: {n} columns hold no output at width {width}")
    out = _out(xp, c, n - 4 * width)
    _build.launch("bs_probe_dw9", xp.data_ptr(), out.data_ptr(), c, n, n - 4 * width,
                  width, width, -1)
    dw_flat.launches += 1
    return out


def dw_rowpad(xp: torch.Tensor) -> torch.Tensor:
    """P2 on (C, n) f32 rows at a ROWPAD stride -> (C, n - 2 ROWPAD)."""
    if xp.device.type == "cpu":
        return dw_rowpad_plain(xp)
    _check(xp, "dw_rowpad input", 2)
    c, n = xp.shape
    if n - 2 * ROWPAD < 1:
        raise ValueError(f"dw_rowpad: {n} columns hold no output")
    out = _out(xp, c, n - 2 * ROWPAD)
    _build.launch("bs_probe_dw9", xp.data_ptr(), out.data_ptr(), c, n, n - 2 * ROWPAD,
                  ROWPAD, 0, 0)
    dw_rowpad.launches += 1
    return out


dw_flat.launches = dw_rowpad.launches = 0


# -- P3: the weight-stationary dot ---------------------------------------------

def dot_plain(w: torch.Tensor, x: torch.Tensor, precision: str = "default") -> torch.Tensor:
    """w @ x: "default" on bf16-rounded operands, "high" the bf16x3 split
    (conv1x1_bf16x3_plain, zero bias), "highest" in f32."""
    if precision == "default":
        return w.to(torch.bfloat16).float() @ x.to(torch.bfloat16).float()
    if precision == "high":
        return conv1x1_bf16x3_plain(w, w.new_zeros(w.shape[0]), x)
    return w @ x


def dot(w: torch.Tensor, x: torch.Tensor, precision: str = "default") -> torch.Tensor:
    """P3: (16, 16) @ (16, N) f32 at ``precision`` (PRECISIONS)."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
    if x.device.type == "cpu":
        return dot_plain(w, x, precision)
    _check(x, "dot input", 2)
    _build.check_cuda(w, "dot weights", torch.float32)
    if tuple(w.shape) != (16, 16) or x.shape[0] != 16:
        raise ValueError(f"dot: expected (16, 16) @ (16, N), got {tuple(w.shape)} @ "
                         f"{tuple(x.shape)}")
    y = _out(x, 16, x.shape[1])
    _build.launch("bs_probe_dot", w.data_ptr(), x.data_ptr(), y.data_ptr(), x.shape[1],
                  PRECISIONS.index(precision))
    dot.launches += 1
    return y


dot.launches = 0


# -- P4: squeeze-excite --------------------------------------------------------

def se_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(w @ mean(x, 1)), the mean as sum then divide."""
    m = x.sum(dim=1, keepdim=True) / x.shape[1]
    return x * (1 / (1 + torch.exp(-(w @ m))))


def se(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """P4: (C, N) f32 and (C, C) weights, C <= 32 -> (C, N)."""
    if x.device.type == "cpu":
        return se_plain(x, w)
    _check(x, "se input", 2)
    c, n = x.shape
    if not 1 <= c <= 32:
        raise ValueError(f"se: at most 32 channels, got {c}")
    _build.check_cuda(w, "se weights", torch.float32, (c, c))
    out = _out(x, c, n)
    _build.launch("bs_probe_se", x.data_ptr(), w.data_ptr(), out.data_ptr(), c, n)
    se.launches += 1
    return out


se.launches = 0


# -- P5-P7: the copies ------------------------------------------------------

def concat_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.cat([a, b], dim=0)


def lane_stride2_plain(x: torch.Tensor) -> torch.Tensor:
    return x[:, 0::2].contiguous()


def reshape_flat_plain(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape[0], -1).clone()


def concat(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """P5: (Ca, N) and (Cb, N) f32 -> (Ca + Cb, N); raises past 2**31 - 1
    floats in all (the launcher's 32-bit counts)."""
    if a.device.type == "cpu":
        return concat_plain(a, b)
    _check(a, "concat a", 2)
    _check(b, "concat b", 2)
    if b.shape[1] != a.shape[1]:
        raise ValueError(f"concat: {tuple(a.shape)} and {tuple(b.shape)} differ in width")
    out = _out(a, a.shape[0] + b.shape[0], a.shape[1])
    _build.launch("bs_probe_cat", a.data_ptr(), b.data_ptr(), out.data_ptr(), a.numel(),
                  b.numel())
    concat.launches += 1
    return out


def lane_stride2(x: torch.Tensor) -> torch.Tensor:
    """P6: x[:, 0::2] of (C, N) f32 as a fresh (C, (N + 1) // 2) tensor."""
    if x.device.type == "cpu":
        return lane_stride2_plain(x)
    _check(x, "lane_stride2 input", 2)
    out = _out(x, x.shape[0], (x.shape[1] + 1) // 2)
    _build.launch("bs_probe_stride2", x.data_ptr(), out.data_ptr(), x.shape[0], x.shape[1])
    lane_stride2.launches += 1
    return out


def reshape_flat(x: torch.Tensor) -> torch.Tensor:
    """P7: (C, H, W) f32 -> a fresh (C, H*W) tensor."""
    if x.device.type == "cpu":
        return reshape_flat_plain(x)
    _check(x, "reshape_flat input", 3)
    out = _out(x, x.shape[0], x.shape[1] * x.shape[2])
    _build.launch("bs_probe_copy", x.data_ptr(), out.data_ptr(), x.shape[0],
                  x.shape[1] * x.shape[2])
    reshape_flat.launches += 1
    return out


concat.launches = lane_stride2.launches = reshape_flat.launches = 0

# every wrapper, P1-P7, for their launch counts
KERNELS = (dw_flat, dw_rowpad, dot, se, concat, lane_stride2, reshape_flat)
