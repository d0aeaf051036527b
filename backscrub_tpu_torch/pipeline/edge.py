"""The fused edge path: first conv in front, transpose-conv tail behind,
the body between (counterpart of ``backscrub_tpu/pipeline/edge.py``).

- **front**: the ROI is resized into the letterboxed model canvas, with a
  reflect-101 halo of 2 for the bilateral, by two interpolation-matrix
  contractions (``torch.matmul``, f32), rounded; then one kernel
  (``csrc/front.cu``, K1) runs bilateral + normalize + 3x3/s2 conv +
  activation and emits the body input as (C, oh, ow).
- **body**: :class:`~backscrub_tpu_torch.ops.megakernel.BodyPlan` spans.
  With both edge layers (the segm family) one plan covers the body (K2);
  a span that BodyPlan rejects gets no fused path, and :class:`MaskGen`
  runs such models through the classic stages.  Front only (deeplab,
  bodypix, or a crop too coarse for the tail): the prefix plan (K2'),
  then with ``cont`` the flat continuation plan (K2''), then the graph
  executor over the nodes left; a model whose prefix or continuation
  plan does not build, or whose op table does not compile, gets no
  fused path either.  Each plan runs on the card as one launch of the
  persistent kernel (``csrc/body_mega.cu``).
- **tail**: because the 2x2/s2 transpose conv has kernel == stride, each
  output phase p = 2a+b is a 1x1 contraction of the body output, and the
  two-channel decode only needs sign(out1 - out0): one (4, K) dot, then
  decode and the EMA bit trick, in plain PyTorch.  Front only: the
  model's decode rule and the EMA.  The EMA is carried in the standard
  (oh, ow) layout, not the TPU's phase-major quadrants.
- **postprocess**: crop + bilinear upscale + 5x5 box blur as one matrix
  per axis (fold-blur), matrices built in float64; a crop under 64 px
  runs the two stages with a round between them.

Every stage takes a stream batch too, as the JAX stages do with their
leading axes: frames (S, H, W, 3) and EMAs (S, oh, ow) make S canvases in
one K1 launch, one launch of each body plan over the S inputs, the
executor remainder at batch S and the tail over (S, ...); the fold-blur
post takes its products image by image, so that each stream's mask is
its solo step's (:func:`fold_blur_post`).

Precision: the plans' dots follow ``precision`` (``megakernel.dots_for``;
"default", the bf16 mode, rounds their operands to bf16); the executor
remainder runs in the model's compute dtype and the decode reads it as
f32.  K1, the canvas resize, the tail and the post stay f32 in every mode
(the JAX package asks DEFAULT of the last three in bf16 mode, which its
CPU runs in f32).  A quantized model has no fused path.

The TPU-only layouts (quadrant planes, rowpad, chw store, the VMEM
limits) have no counterpart.  Reference behaviour: the preprocess chain
``lib/libbackscrub.cc:279-298``, decode ``:317-361``, upscale+blur
``:366-371``.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import _build
from ..graph.executor import span_fn
from ..ops.common import apply_activation
from ..ops.megakernel import (body_plan_continuation_for, body_plan_for,
                              body_plan_prefix_for, NO_CUT)
from ..ops.misc import resize_matrix
from .decode import decode_val, ema_update
from .geometry import RoiGeometry
from .image import (_bilateral_taps, apply_mask_morph, bilateral_planes, blur_matrix,
                    box_blur, box_blur_u8_exact, guided_filter, resize_bilinear,
                    resize_bilinear_u8_exact)


@dataclasses.dataclass
class EdgeInfo:
    """What the fused edge path replaces, detected from the folded IR."""
    front_ok: bool
    body_start: int = 0
    body_in_tensor: int = -1
    front_w_key: str = ""
    front_b_key: str = ""
    front_activation: str = "NONE"   # NONE | RELU6 | HARD_SWISH
    pad_lo_h: int = 0
    pad_lo_w: int = 0
    conv_oh: int = 0
    conv_ow: int = 0
    tail_ok: bool = False
    body_end: int = 0
    body_out_tensor: int = -1
    tail_w_key: str = ""
    tail_b_key: str = ""
    tail_kind: str = ""              # "two_channel" | "threshold"
    tail_threshold: float = 0.0


def _same_pad_lo(in_size: int, k: int, stride: int) -> int:
    out = -(-in_size // stride)
    return max((out - 1) * stride + k - in_size, 0) // 2


def detect_edge(model, spec) -> Optional[EdgeInfo]:
    """The fusable edge pattern in a CompiledModel's folded IR.

    Front: node 0 is a 3x3 stride-2 SAME CONV_2D from 3 channels, its
    activation inline or one following HARD_SWISH/RELU6 node.  Tail: the
    last node is a 2x2 stride-2 Convolution2DTransposeBias (optionally
    followed by LOGISTIC) feeding a sign/threshold decode.
    """
    g = model.graph
    nodes = g.nodes
    if len(nodes) < 4 or getattr(model, "host_params", None) is None:
        return None
    n0 = nodes[0]
    info = EdgeInfo(front_ok=False)
    if (n0.kind == "CONV_2D" and n0.options.get("stride_h") == 2
            and n0.options.get("stride_w") == 2
            and n0.options.get("padding") == "SAME"
            and n0.options.get("dilation_h", 1) == 1
            and n0.options.get("dilation_w", 1) == 1
            and n0.inputs[0] == g.inputs[0]):
        w_key, b_key = f"t{n0.inputs[1]}@hwio", f"t{n0.inputs[2]}"
        wt = model.host_params.get(w_key)
        act = n0.options.get("activation", "NONE")
        start, out_t = 1, n0.outputs[0]
        if act == "NONE" and nodes[1].kind in ("HARD_SWISH", "RELU6") \
                and nodes[1].inputs[0] == out_t:
            act = nodes[1].kind
            start, out_t = 2, nodes[1].outputs[0]
        consumers = [n for n in nodes[start:] for i in n.inputs if i == out_t]
        if (wt is not None and wt.shape[:3] == (3, 3, 3)
                and b_key in model.host_params
                and act in ("NONE", "RELU6", "HARD_SWISH")
                and len(consumers) >= 1):
            ih, iw = model.input_shape[1:3]
            info = EdgeInfo(
                front_ok=True, body_start=start, body_in_tensor=out_t,
                front_w_key=w_key, front_b_key=b_key, front_activation=act,
                pad_lo_h=_same_pad_lo(ih, 3, 2), pad_lo_w=_same_pad_lo(iw, 3, 2),
                conv_oh=-(-ih // 2), conv_ow=-(-iw // 2))
    last = len(nodes) - 1
    tnode = None
    if nodes[last].kind == "Convolution2DTransposeBias" and spec.decode == "two_channel":
        tnode, end, kind = nodes[last], last, "two_channel"
    elif (nodes[last].kind == "LOGISTIC" and last >= 1
          and nodes[last - 1].kind == "Convolution2DTransposeBias"
          and nodes[last].inputs[0] == nodes[last - 1].outputs[0]
          and spec.decode == "threshold"):
        tnode, end, kind = nodes[last - 1], last - 1, "threshold"
    if tnode is not None and tnode.options.get("stride_h") == 2 \
            and tnode.options.get("stride_w") == 2:
        w_key, b_key = f"t{tnode.inputs[1]}@tconv", f"t{tnode.inputs[2]}"
        wt = model.host_params.get(w_key)   # flipped HWIO (2, 2, K, O)
        want_o = 2 if kind == "two_channel" else 1
        oh, ow = model.output_shape[1:3]
        xh, xw = g.tensor(tnode.inputs[0]).shape[1:3]
        if (wt is not None and wt.shape[:2] == (2, 2) and wt.shape[3] == want_o
                and b_key in model.host_params
                and (oh, ow) == (2 * xh, 2 * xw)
                and nodes[last].outputs[0] == g.outputs[0]):
            thr = 0.0
            if kind == "threshold":
                t = float(spec.threshold)
                thr = math.log(t / (1.0 - t))  # sigmoid(y) > t <=> y > logit(t)
            info.tail_ok = True
            info.body_end = end
            info.body_out_tensor = tnode.inputs[0]
            info.tail_w_key, info.tail_b_key = w_key, b_key
            info.tail_kind, info.tail_threshold = kind, thr
    if not info.front_ok and not info.tail_ok:
        return None
    if not info.tail_ok:
        info.body_end = len(nodes)
        info.body_out_tensor = g.outputs[0]
    if not info.front_ok:
        info.body_start = 0
        info.body_in_tensor = g.inputs[0]
    return info


def edge_applicable(model, spec, geo: Optional[RoiGeometry] = None, *,
                    refine: str = "box", u8_exact: bool = False,
                    morph: str = "", quantize: Optional[str] = None) -> Optional[EdgeInfo]:
    """Gate of the fused path (``backscrub_tpu/pipeline/edge.py:
    edge_applicable``): None for a quantized model (``quantize`` set), whose
    int8 kernels the fused path would not dequantize; else the front
    applies whenever the pattern matches; the tail also needs the default
    post (box refine, float post, no morph) and an output crop fine enough
    for fold-blur (min crop dim >= 64).  With the tail off the body span
    runs to the graph's end and the model's own decode rule follows it."""
    if quantize:
        return None
    info = detect_edge(model, spec)
    if info is None:
        return None
    if info.tail_ok and (refine != "box" or u8_exact or morph or (
            geo is not None and min(geo.out_roi.h, geo.out_roi.w) < 64)):
        info.tail_ok = False
        info.body_end = len(model.graph.nodes)
        info.body_out_tensor = model.graph.outputs[0]
    if not info.front_ok and not info.tail_ok:
        return None
    return info


def _reflect101(r: int, n: int) -> int:
    if r < 0:
        return -r
    if r >= n:
        return 2 * n - 2 - r
    return r


def front_axis_matrix(src: int, dst_roi: int, canvas: int, lo: int) -> np.ndarray:
    """One axis of the front's resize: ((canvas + 4), src) f32.  Row r+2
    holds the interpolation row of canvas coordinate r in -2..canvas+1,
    reflect-101'd into the canvas; rows in the letterbox margins are zero.
    ``edge.py:front_axis_matrix`` of the JAX package without the quadrant
    split."""
    a_res = resize_matrix(src, dst_roi, False, True).astype(np.float64)
    a = np.zeros((canvas + 4, src), np.float64)
    for rp in range(canvas + 4):
        t = _reflect101(rp - 2, canvas) - lo
        if 0 <= t < dst_roi:
            a[rp] = a_res[t]
    return a.astype(np.float32)


_FRONT_ACT = {"NONE": 0, "RELU6": 1, "HARD_SWISH": 2}
# cv::bilateralFilter(d=5, sigmaColor=100, sigmaSpace=100), libbackscrub.cc:297
_SIGMA = 100.0


def front_params(w_hwio: np.ndarray, bias: np.ndarray) -> np.ndarray:
    """K1's parameter block: the 3x3x3xCout kernel with its input channels
    reversed (the BGR->RGB swap folded in, so it reads BGR planes),
    flattened to rows (di*3+dj)*3+c, then the bias row, then the 13
    bilateral space weights."""
    w = np.ascontiguousarray(np.asarray(w_hwio, np.float32)[:, :, ::-1, :])
    cout = w.shape[3]
    sw = np.array([t[2] for t in _bilateral_taps(5, _SIGMA)], np.float32)
    return np.concatenate([w.reshape(27 * cout),
                           np.asarray(bias, np.float32).reshape(cout), sw])


def front_plain(canvas: torch.Tensor, params: torch.Tensor, *, H: int, W: int,
                oh: int, ow: int, pad_lo_h: int, pad_lo_w: int,
                use_bilateral: bool, scale: float, offset: float,
                activation: str) -> torch.Tensor:
    """Plain PyTorch version of K1: canvas (3, H+4, W+4) -> (Cout, oh, ow),
    or a stream batch (..., 3, H+4, W+4) -> (..., Cout, oh, ow) canvas by
    canvas (each canvas's bits those of its own call)."""
    if canvas.dim() > 3:
        kw = dict(H=H, W=W, oh=oh, ow=ow, pad_lo_h=pad_lo_h, pad_lo_w=pad_lo_w,
                  use_bilateral=use_bilateral, scale=scale, offset=offset,
                  activation=activation)
        flat = canvas.reshape((-1,) + tuple(canvas.shape[-3:]))
        y = torch.stack([front_plain(c, params, **kw) for c in flat])
        return y.reshape(tuple(canvas.shape[:-3]) + tuple(y.shape[1:]))
    cout = (params.numel() - 13) // 28
    if use_bilateral:
        v = torch.round(bilateral_planes(canvas, H, W))
    else:
        v = canvas[:, 2:2 + H, 2:2 + W]
    z = v * scale + offset
    hi_h = (oh - 1) * 2 + 3 - H - pad_lo_h
    hi_w = (ow - 1) * 2 + 3 - W - pad_lo_w
    z = F.pad(z, (pad_lo_w, hi_w, pad_lo_h, hi_h))
    w = params[:27 * cout].reshape(3, 3, 3, cout).permute(3, 2, 0, 1)
    y = F.conv2d(z[None], w, params[27 * cout:28 * cout], stride=2)[0]
    return apply_activation(y, activation)


# K1's tiles, the instantiations of csrc/front.cu's bs_front: (conv output
# rows, output columns, channel groups) a CTA, one thread an (output,
# group) and at least one a normalized pixel
FRONT_TILES = ((4, 8, 8), (4, 16, 4))


def front_tile(oh: int, ow: int, sms: int) -> Tuple[int, int, int]:
    """K1's tile for an (oh, ow) output on a card with ``sms`` SMs: 4x8
    outputs in 8 channel groups while that grid stays within one CTA an
    SM (segm's 48x80: 120 CTAs), else 4x16 outputs in 4 groups (deeplab's
    129x129: 297 CTAs).  Both keep the normalized tile (9x17 or 9x33
    pixels) near one pixel a thread.  Fitted on the 132-SM H100 SXM at
    those two shapes (``tools/sweep_front_tiles.py``, PERF.md §6); on a
    card with fewer SMs the same rule switches to 4x16x4 at a smaller
    output, which is not measured."""
    return FRONT_TILES[0] if -(-oh // 4) * -(-ow // 8) <= sms else FRONT_TILES[1]


def front_fused(canvas: torch.Tensor, params: torch.Tensor, *, H: int, W: int,
                oh: int, ow: int, pad_lo_h: int, pad_lo_w: int,
                use_bilateral: bool, scale: float, offset: float,
                activation: str) -> torch.Tensor:
    """K1 on CUDA tensors (``front_fused.launches`` counts launches), the
    plain version on CPU tensors; the tile is :func:`front_tile`'s for one
    canvas.  A stream batch of canvases (..., 3, H+4, W+4) is one launch,
    -> (..., Cout, oh, ow)."""
    kw = dict(H=H, W=W, oh=oh, ow=ow, pad_lo_h=pad_lo_h, pad_lo_w=pad_lo_w,
              use_bilateral=use_bilateral, scale=scale, offset=offset,
              activation=activation)
    if canvas.device.type == "cpu":
        return front_plain(canvas, params, **kw)
    cout = (params.numel() - 13) // 28
    if cout > 64:
        raise ValueError(f"the front kernel takes at most 64 output channels, got {cout}")
    lead = tuple(canvas.shape[:-3])
    _build.check_cuda(canvas, "canvas", torch.float32, lead + (3, H + 4, W + 4))
    _build.check_cuda(params, "front params", torch.float32, (28 * cout + 13,))
    out = torch.empty(lead + (cout, oh, ow), dtype=torch.float32, device=canvas.device)
    _build.launch("bs_front", canvas.data_ptr(), params.data_ptr(), out.data_ptr(),
                  math.prod(lead), H, W, oh, ow, cout, pad_lo_h, pad_lo_w, int(use_bilateral),
                  -0.5 / _SIGMA ** 2, scale, offset, _FRONT_ACT[activation],
                  *front_tile(oh, ow, _build.sm_count(canvas.device)))
    front_fused.launches += 1
    return out


front_fused.launches = 0


@functools.lru_cache(maxsize=32)
def fold_blur_matrices(sh: int, sw: int, out_h: int, out_w: int):
    """(blur5 ∘ bilinear upscale) as one dense f32 matrix per axis, the
    product taken in float64 (``maskgen.py:_fold_blur_matrices``).  Cached:
    callers only read the arrays."""
    ah = (blur_matrix(out_h, 5).astype(np.float64)
          @ resize_matrix(sh, out_h, False, True).astype(np.float64))
    aw = (blur_matrix(out_w, 5).astype(np.float64)
          @ resize_matrix(sw, out_w, False, True).astype(np.float64))
    return ah.astype(np.float32), aw.astype(np.float32)


def pad_to_frame(m: torch.Tensor, geo: RoiGeometry) -> torch.Tensor:
    """ROI mask -> full-frame mask; outside the ROI is background (255)."""
    r = geo.roi
    return F.pad(m, (r.x, geo.frame_w - r.x - r.w, r.y, geo.frame_h - r.y - r.h),
                 value=255)


def fold_blur_post(small: torch.Tensor, geo: RoiGeometry, ah: torch.Tensor,
                   aw: torch.Tensor) -> torch.Tensor:
    """The cropped EMA (o.h, o.w) u8 -> full-frame mask: ``ah @ crop @
    aw.T`` (upscale + 5x5 box blur), round, embed.  A stream batch (...,
    o.h, o.w) takes its products image by image, each the one-frame call:
    the library GEMM picks its kernel, and with it the summation order, by
    the rows it is given, so a product over S images (S·o.w rows) rounds
    otherwise than one image's (on an H100, mask bytes 1 apart in mlkit's
    4-stream batch: ``chip_smoke.py`` ``_stage_trace``), and a stream's
    mask would depend on the batch it rides in."""
    imgs = small.reshape((-1,) + tuple(small.shape[-2:])).float()
    y = torch.stack([torch.matmul(torch.matmul(ah, m), aw.T) for m in imgs])
    y = y.reshape(tuple(small.shape[:-2]) + tuple(y.shape[-2:]))
    return pad_to_frame(torch.clamp(torch.round(y), 0, 255).to(torch.uint8), geo)


def fold_blur_tensors(geo: RoiGeometry, device):
    """The fold-blur matrices of ``geo`` on ``device``, or None where the
    output crop is under 64 px (the two-stage post)."""
    o = geo.out_roi
    if min(o.h, o.w) < 64:
        return None
    ah, aw = fold_blur_matrices(o.h, o.w, geo.roi.h, geo.roi.w)
    return torch.from_numpy(ah).to(device), torch.from_numpy(aw).to(device)


def post_footprint(ema_pixels: torch.Tensor, geo: RoiGeometry, mats) -> torch.Tensor:
    """The frame pixels (H, W) bool that the EMA pixels ``ema_pixels``
    (oh, ow) bool reach through the post: where two EMAs differ only at
    those pixels, their masks differ only inside it.  ``mats`` from
    :func:`fold_blur_tensors`: the fold-blur matrices, both non-negative
    and zero outside each tap's support; or None, the two-stage post of a
    crop under 64 px, whose footprint is taken stage by stage: the ROI
    pixels whose bilinear taps include a marked pixel (the round after the
    upscale changes no pixel outside them), then the box blur's reach of
    2 px around those, reflected at the ROI's border."""
    o, r = geo.out_roi, geo.roi
    ind = ema_pixels[o.y:o.y + o.h, o.x:o.x + o.w].float()
    if mats is None:
        rh, rw = (sum(upscale_taps(n, m, ind.device)) for n, m in ((o.h, r.h), (o.w, r.w)))
        bh, bw = (torch.from_numpy(blur_matrix(n, 5)).to(ind.device) for n in (r.h, r.w))
        up = (torch.matmul(torch.matmul(rh, ind), rw.T) > 0).float()
        reach = torch.matmul(torch.matmul(bh, up), bw.T) > 0
    else:
        ah, aw = mats
        reach = torch.matmul(torch.matmul(ah, ind), aw.T) > 0
    foot = torch.zeros((geo.frame_h, geo.frame_w), dtype=torch.bool, device=ema_pixels.device)
    foot[r.y:r.y + r.h, r.x:r.x + r.w] = reach
    return foot


# the guided refinement's radius at frame resolution (the JAX package's
# default: IoU against the box-blur path ~0.96 on real frames)
GUIDED_RADIUS = 4


def postprocess_mask(ema_u8: torch.Tensor, geo: RoiGeometry, mats=None, *,
                     u8_exact: bool = False, refine: str = "box", frame_bgr=None,
                     morph: str = "") -> torch.Tensor:
    """EMA (..., oh, ow) u8 -> full-frame mask (..., H, W) u8
    (``backscrub_tpu/pipeline/maskgen.py:postprocess_mask``): crop the
    model-output ROI, then ``morph`` (``apply_mask_morph``) at model
    resolution, then one of:

    - ``refine="guided"`` (``frame_bgr`` the guide): bilinear upscale to
      the frame ROI, then the guided filter over the frame's BT.601 luma,
      radius GUIDED_RADIUS;
    - ``u8_exact``: upscale and 5x5 box blur in OpenCV's u8 fixed point,
      byte for byte the reference binary's post;
    - the default: a crop of at least 64 px both ways runs blur∘upscale as
      one matrix per axis (fold-blur; ``mats`` from
      :func:`fold_blur_tensors`, built here when not given); a coarser one
      runs the two stages with a round between them, as the reference's u8
      path quantizes.

    Outside the ROI the mask is 255.  Guided refinement and u8_exact
    contradict each other (ValueError), as in the JAX package.
    """
    o, r = geo.out_roi, geo.roi
    small = ema_u8[..., o.y:o.y + o.h, o.x:o.x + o.w]
    if morph:
        small = apply_mask_morph(small, morph)
    if refine == "guided":
        if u8_exact:
            raise ValueError("refine='guided' and u8_exact byte parity are contradictory: "
                             "guided refinement intentionally deviates from the reference "
                             "binary's box-blur path — request one or the other")
        if frame_bgr is None:
            raise ValueError("refine='guided' needs the camera frame as guide")
        up = resize_bilinear(small.float()[..., None], r.h, r.w)[..., 0] / 255.0
        roi = frame_bgr[..., r.y:r.y + r.h, r.x:r.x + r.w, :].float()
        luma = (roi[..., 2] * 0.299 + roi[..., 1] * 0.587 + roi[..., 0] * 0.114) / 255.0
        q = guided_filter(luma, up, radius=GUIDED_RADIUS, eps=1e-3)
        return pad_to_frame(torch.clamp(torch.round(q * 255.0), 0, 255).to(torch.uint8), geo)
    if u8_exact:
        up8 = resize_bilinear_u8_exact(small[..., None], r.h, r.w)
        return pad_to_frame(box_blur_u8_exact(up8, 5)[..., 0], geo)
    if min(o.h, o.w) >= 64:
        return fold_blur_post(small, geo, *(mats or fold_blur_tensors(geo, ema_u8.device)))
    small = small.float()
    rh0, rh1 = upscale_taps(o.h, r.h, small.device)
    rw0, rw1 = upscale_taps(o.w, r.w, small.device)
    y = rh0 @ small + rh1 @ small
    up = torch.round(y @ rw0.T + y @ rw1.T)
    m = torch.clamp(torch.round(box_blur(up[..., None], 5)[..., 0]), 0, 255).to(torch.uint8)
    return pad_to_frame(m, geo)


@functools.lru_cache(maxsize=32)
def upscale_taps(n_in: int, n_out: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """A bilinear resize (half-pixel centres; the two-stage post's upscale,
    the classic preprocess), (n_out, n_in) f32 on ``device``, split into
    two matrices: each row's first
    nonzero tap and its second.  ``a0 @ x + a1 @ x`` rounds each output as
    the f32 sum of its two rounded products, whatever the matmul's
    summation order or fused multiply-adds; that is the reference's
    contraction, bit for bit, so an upscaled value at an x.5 tie (EMA
    values meet such ties) rounds as it does there.  Cached: callers only
    read the tensors."""
    a = resize_matrix(n_in, n_out, False, True)
    taps = np.zeros((2,) + a.shape, np.float32)
    for r in range(n_out):
        nz = np.nonzero(a[r])[0]
        taps[np.arange(len(nz)), r, nz] = a[r, nz]
    return tuple(torch.from_numpy(t).to(device) for t in taps)


def body_plans(model, info: EdgeInfo, mega: Optional[bool] = None, cont: bool = False,
               precision: str = "highest"):
    """The BodyPlans of the body span and where the graph executor takes
    over: (plans, start node, start tensor), or None where a plan the
    switches call for does not build (always for a quantized model).  The
    plans' dots are ``megakernel.dots_for(precision, flat)``.
    ``mega=False``: no plan.  With both
    edge layers: the full-span plan (K2).  Front only: the prefix plan
    (K2') and, with ``cont``, the continuation plan (K2''); ``mega=True``
    demands the full span, as in the reference.  A span left to the
    executor runs plain PyTorch, so a missing plan is no fused path at all
    rather than the executor in its place, with one exception that is the
    reference's own route: a front-only span with no cut that one tensor
    crosses (``NO_CUT``; the segm family with a post option) has no
    prefix plan there either, and the executor runs the whole body after
    K1."""
    start, tid = info.body_start, info.body_in_tensor
    if getattr(model, "quantize_mode", None):
        return None
    if mega is False:
        return [], start, tid
    if info.tail_ok:
        plan = body_plan_for(model, info, precision)
        return None if plan is None else ([plan], info.body_end, info.body_out_tensor)
    if mega:
        return None
    r = body_plan_prefix_for(model, info, precision=precision)
    if r is NO_CUT:
        return [], start, tid
    if r is None:
        return None
    plans, start, tid = [r[0]], r[1], r[2]
    if cont:
        rc = body_plan_continuation_for(model, info, start, tid, precision=precision)
        if rc is None:
            return None
        plans.append(rc[0])
        start, tid = rc[1], rc[2]
    return plans, start, tid


class EdgeFused:
    """The fused edge path for one (model, geometry), on ``device``
    (``backscrub_tpu/pipeline/edge.py:EdgeFused``).

    ``step_mask(frame, ema)`` maps a (H, W, 3) BGR u8 frame and the (oh, ow)
    u8 EMA to (mask (H, W) u8, new EMA); ``device`` is the card unless the
    caller asks for the CPU.  Edge weights are taken from the
    model at construction.  The fused front is required (ValueError
    otherwise).  The body runs the plans of :func:`body_plans` (given as
    ``plans``, or found here) and the graph executor over the nodes they
    leave; a plan the switches call for that does not build raises
    ValueError.  ``post_options`` are :func:`postprocess_mask`'s
    ``refine``, ``morph`` and ``u8_exact`` (the caller's dict, e.g.
    ``MaskGen.post_options``); ``info`` then comes from
    :func:`edge_applicable` given the same options.  ``precision`` ("highest",
    "high" or "default"; None: ``spec.mxu_precision``) sets the plans' dots.
    """

    def __init__(self, model, geo: RoiGeometry, spec, info: EdgeInfo, *,
                 use_bilateral: bool = True, device="cuda",
                 mega: Optional[bool] = None, cont: bool = False, plans=None,
                 post_options: Optional[dict] = None, precision: Optional[str] = None):
        if not info.front_ok:
            raise ValueError("the PyTorch edge path needs the fused front")
        self.precision = spec.mxu_precision if precision is None else precision
        if plans is None:
            plans = body_plans(model, info, mega, cont, self.precision)
        if plans is None:
            raise ValueError(f"the body span does not fit the BodyPlans that mega={mega}, "
                             f"cont={cont} call for (K2 needs both fused edge layers; "
                             "front only, K2' the prefix and K2'' the continuation); "
                             "the classic path serves this model")
        self.model, self.geo, self.spec, self.info = model, geo, spec, info
        self.use_bilateral = use_bilateral
        self.post_options = post_options or {}
        dev = _build.resolve_device(device)
        hp = model.host_params
        ih, iw = model.input_shape[1:3]
        self.front_ah = torch.from_numpy(front_axis_matrix(
            geo.roi.h, geo.in_roi.h, ih, geo.in_roi.y)).to(dev)
        self.front_aw = torch.from_numpy(front_axis_matrix(
            geo.roi.w, geo.in_roi.w, iw, geo.in_roi.x)).to(dev)
        self.front_params = torch.from_numpy(front_params(
            hp[info.front_w_key], hp[info.front_b_key])).to(dev)
        self.post_mats = fold_blur_tensors(geo, dev)

        if info.tail_ok:
            self._init_tail(dev)
        self.plans, start, tid = plans
        self.body_plan = self.plans[0] if info.tail_ok and self.plans else None
        self.prefix_plan = self.plans[0] if not info.tail_ok and self.plans else None
        self.cont_plan = self.plans[1] if len(self.plans) == 2 else None
        # the graph executor over the nodes no plan covers
        self.rest = (None if (start, tid) == (info.body_end, info.body_out_tensor)
                     else span_fn(model, start, info.body_end, tid, info.body_out_tensor))

    def _init_tail(self, dev):
        # flipped HWIO (2, 2, K, O), Wf[h, w, k, o] = W_ohwi[o, 1-h, 1-w, k];
        # phase p = 2a+b reads Wf[1-a, 1-b]; two_channel keeps out1 - out0
        info, hp = self.info, self.model.host_params
        wt = np.asarray(hp[info.tail_w_key], np.float32)
        bt = np.asarray(hp[info.tail_b_key], np.float32)
        wd = np.zeros((4, wt.shape[2]), np.float32)
        bd = np.zeros((4,), np.float32)
        for a in (0, 1):
            for b in (0, 1):
                p = 2 * a + b
                if info.tail_kind == "two_channel":
                    wd[p] = (wt[1 - a, 1 - b, :, 1].astype(np.float64)
                             - wt[1 - a, 1 - b, :, 0]).astype(np.float32)
                    bd[p] = np.float32(np.float64(bt[1]) - np.float64(bt[0]))
                else:
                    wd[p] = wt[1 - a, 1 - b, :, 0]
                    bd[p] = bt[0]
        self.tail_wd = torch.from_numpy(wd).to(dev)
        self.tail_bd = torch.from_numpy(bd).to(dev)
        oh2, ow2 = self.model.output_shape[1:3]
        self.xh, self.xw = oh2 // 2, ow2 // 2

    def canvas(self, frame_bgr_u8: torch.Tensor) -> torch.Tensor:
        """(..., H, W, 3) u8 -> the rounded, padded model canvas (..., 3,
        ih+4, iw+4) f32, planes in BGR order."""
        r = self.geo.roi
        roi = frame_bgr_u8[..., r.y:r.y + r.h, r.x:r.x + r.w, :].float().movedim(-1, -3)
        z = torch.matmul(torch.matmul(self.front_ah, roi), self.front_aw.T)
        return torch.round(z).contiguous()

    def front_kwargs(self):
        """The shape and option arguments of front_fused / front_plain."""
        ih, iw = self.model.input_shape[1:3]
        info = self.info
        return dict(H=ih, W=iw, oh=info.conv_oh, ow=info.conv_ow,
                    pad_lo_h=info.pad_lo_h, pad_lo_w=info.pad_lo_w,
                    use_bilateral=self.use_bilateral,
                    scale=float(self.spec.scale), offset=float(self.spec.offset),
                    activation=info.front_activation)

    def front(self, frame_bgr_u8: torch.Tensor, plain: bool = False) -> torch.Tensor:
        """(..., H, W, 3) u8 -> body input (..., Cout, oh, ow) f32; ``plain``
        runs K1's plain version on any device."""
        fn = front_plain if plain else front_fused
        return fn(self.canvas(frame_bgr_u8), self.front_params, **self.front_kwargs())

    def body(self, h: torch.Tensor, plain: bool = False, gemm: str = "f32") -> torch.Tensor:
        """(..., C, oh, ow) -> the body output (..., C_out, H_out, W_out):
        the tail's input, or front only the model output in channel-major
        order.  ``plain`` runs the plans' plain versions on any device,
        their dots in ``gemm`` arithmetic (``BodyPlan.run_plain``: "bf16x3"
        the flat GEMMs' split, "bf16" every dot one bf16 pass).  A stream
        batch runs each plan as one launch and the executor remainder at
        batch S."""
        lead = tuple(h.shape[:-3])
        for plan in self.plans:
            m = plan.out_meta
            x = h.reshape(lead + (h.shape[-3], -1))
            h = (plan.run_plain(x, gemm) if plain else plan(x)).reshape(lead + (m.c, m.rows, m.w))
        if self.rest is not None:
            hb = h.reshape((-1,) + tuple(h.shape[-3:])).permute(0, 2, 3, 1)
            y = self.rest(hb).permute(0, 3, 1, 2)
            h = y.reshape(lead + tuple(y.shape[1:]))
        return h

    def tail_logits(self, body_out: torch.Tensor) -> torch.Tensor:
        """Body output (..., K, xh*xw) -> the value the decode compares with
        ``info.tail_threshold``, (..., 2xh, 2xw): one phase dot
        (two_channel: out1 - out0; threshold: the logit before the model's
        LOGISTIC)."""
        lead = tuple(body_out.shape[:-2])
        dq = self.tail_wd @ body_out + self.tail_bd[:, None]
        # phase (a, b) at (i, j) is mask pixel (2i+a, 2j+b)
        dq = dq.reshape(lead + (2, 2, self.xh, self.xw))
        dq = dq.permute(*range(len(lead)), -2, -4, -1, -3)
        return dq.reshape(lead + (2 * self.xh, 2 * self.xw))

    def tail(self, body_out: torch.Tensor, ema: torch.Tensor) -> torch.Tensor:
        """Body output (..., K, xh*xw) + EMA (..., 2xh, 2xw) u8 -> new EMA:
        the phase dot, decode and the bit trick of
        lib/libbackscrub.cc:330,342-357."""
        val = torch.where(self.tail_logits(body_out) > self.info.tail_threshold, 0, 255)
        return (val.to(torch.uint8) & 0xE0) | (ema >> 3)

    def postprocess(self, ema: torch.Tensor, frame: Optional[torch.Tensor] = None) -> torch.Tensor:
        """EMA (..., oh, ow) u8 -> full-frame mask (..., H, W) u8 with the
        post options; ``frame`` is the guide of ``refine="guided"``."""
        return postprocess_mask(ema, self.geo, self.post_mats, frame_bgr=frame,
                                **self.post_options)

    def step_mask(self, frame: torch.Tensor, ema: torch.Tensor, plain: bool = False,
                  gemm: str = "f32"):
        """A frame (H, W, 3) u8 and its EMA, or a stream batch (S, H, W, 3)
        and the EMAs (S, oh, ow) -> (mask(s), new EMA(s)).  ``plain`` runs
        every kernel's plain version (on any device), the plans' dots in
        ``gemm`` arithmetic (:meth:`body`)."""
        out = self.body(self.front(frame, plain), plain, gemm)
        if self.info.tail_ok:
            new_ema = self.tail(out.flatten(-2), ema)
        else:
            new_ema = ema_update(ema, decode_val(out.movedim(-3, -1).float(), self.spec))
        return self.postprocess(new_ema, frame), new_ema
