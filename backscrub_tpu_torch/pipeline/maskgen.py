"""Mask generation (counterpart of ``backscrub_tpu/pipeline/maskgen.py``).

The reference chain (``lib/libbackscrub.cc:279-372``): ROI crop -> resize
-> BGR2RGB -> bilateral filter -> normalize -> CNN -> decode with the
temporal EMA -> upscale -> 5x5 box blur.  :class:`MaskGen` runs it either
through the fused edge path (``pipeline/edge.py``: kernels K1 and K2, or
K1, K2' and K2'', on CUDA) or through the classic stages below (the
bilateral as K5 on CUDA) and the graph executor, in one step or staged
with hooks between the stages.

Masks are u8, 0 = person (keep the camera pixel), 255 = background; the
area outside the aspect-ratio ROI is always 255.
"""

from __future__ import annotations

import os
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .._build import resolve_device
from ..graph.executor import CompiledModel, load_model
from ..models.specs import ModelSpec, resolve_model_path, spec_for_model
from ..ops.megakernel import PRECISIONS
from ..ops.image_kernels import bilateral5
from .decode import decode_val, ema_update
from .edge import (EdgeFused, body_plans, edge_applicable, fold_blur_tensors, postprocess_mask,
                   upscale_taps)
from .geometry import RoiGeometry, compute_roi


def set_precision_policy() -> None:
    """Full f32 for every plain matmul and convolution: cuDNN convs would
    otherwise run in TF32 on the card and the plain references that the
    kernels are held against would be wrong."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


# The preprocess resize's passes, (axis, rows in, rows out), that XLA:CPU
# sums as a chain of fused multiply-adds over the contraction index in
# blocks of 512 (the second tap fused onto the first's rounded product);
# it sums every other pass it was measured on as the two rounded products
# added (deeplab's 480 -> 257 and 720 -> 257 both ways).  Measured, not
# read from XLA's code: ROADMAP queue 3.
FMA_PASSES = frozenset({("rows", 480, 144), ("cols", 640, 192)})
FMA_BLOCK = 512


def resize_two_tap(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """cv::resize INTER_LINEAR (half-pixel centres) on (..., H, W, C) f32,
    rows then columns, each output the sum of its two taps rounded as the
    JAX package's contraction rounds it on the CPU: the two rounded
    products added, or, on a pass of ``FMA_PASSES`` whose taps lie in one
    block of ``FMA_BLOCK``, the second product fused onto the first's
    rounded one (exact in f64, then rounded once).  A matrix of one tap a
    row gives each product rounded once, whatever the matmul's order."""
    for axis, eq, n_out in (("rows", "oh,...hwc->...owc", out_h),
                            ("cols", "pw,...owc->...opc", out_w)):
        n_in = x.shape[-3] if axis == "rows" else x.shape[-2]
        if n_in == n_out:
            continue
        a0, a1 = upscale_taps(n_in, n_out, x.device)
        p0 = torch.einsum(eq, a0, x)
        two = p0 + torch.einsum(eq, a1, x)
        if (axis, n_in, n_out) in FMA_PASSES:
            fma = (torch.einsum(eq, a1.double(), x.double()) + p0.double()).float()
            i0, i1 = ((a != 0).float().argmax(1) for a in (a0, a1))
            one_block = i0 // FMA_BLOCK == i1 // FMA_BLOCK
            shape = (n_out, 1, 1) if axis == "rows" else (n_out, 1)
            two = torch.where(one_block.reshape(shape), fma, two)
        x = two
    return x


def preprocess(frame_bgr_u8: torch.Tensor, geo: RoiGeometry, spec: ModelSpec,
               use_bilateral: bool = True) -> torch.Tensor:
    """Frame (..., H, W, 3) BGR u8 -> model input (..., in_h, in_w, 3) f32.

    The bilateral is K5 (``ops/image_kernels.py``) on a CUDA frame and its
    plain version on a CPU frame, as the JAX package takes its Pallas
    kernel on the TPU (``maskgen.py:91-93``); then :func:`normalize`.  The
    resize is :func:`resize_two_tap`."""
    r = geo.roi
    roi = frame_bgr_u8[..., r.y:r.y + r.h, r.x:r.x + r.w, :].float()
    small = torch.round(resize_two_tap(roi, geo.in_roi.h, geo.in_roi.w))
    ix, iy = geo.in_roi.x, geo.in_roi.y
    canvas = F.pad(small, (0, 0, ix, geo.model_in_w - ix - geo.in_roi.w,
                           iy, geo.model_in_h - iy - geo.in_roi.h))
    rgb = canvas.flip(-1)  # BGR -> RGB (libbackscrub.cc:290)
    if use_bilateral:
        rgb = torch.round(bilateral5(rgb.contiguous()))
    return normalize(rgb, spec)


def normalize(rgb: torch.Tensor, spec: ModelSpec) -> torch.Tensor:
    """u8-valued f32 pixels -> model input, ``x * scale + offset`` as one
    fused multiply-add, as the JAX program rounds it on the CPU: exact in
    f64 (an 8-bit value times a 24-bit scale, plus the offset), then
    rounded once to f32."""
    scale, offset = float(np.float32(spec.scale)), float(np.float32(spec.offset))
    return (rgb.double() * scale + offset).float()


class MaskGen:
    """bs_maskgen_new equivalent on ``device`` (the card unless the caller
    asks for the CPU; raises where CUDA is asked for and absent).

    ``fused=False`` is the staged mode of the libbackscrub API: it turns
    the fused edge path off, as in the JAX package, so every frame runs
    the classic stages ``_pre`` (preprocess, K5 on the card), ``_infer``
    (the graph executor) and ``_decode_post`` (decode, EMA, upscale +
    blur).  The stage hooks fire in the reference order
    (``lib/libbackscrub.cc:303,311,363``): ``onprep()`` and ``oninfer()``
    after their classic stage, ``onmask()`` after every frame (the fused
    edge path has no stage boundaries).  ``ondebug(msg)`` receives debug
    text.

    The post options follow the JAX constructor: ``u8_exact_post`` (None:
    the ``BACKSCRUB_U8_EXACT`` environment default, "1"/"true"/"on", so
    fixed-signature callers can opt in), ``refine`` ("box" or "guided")
    and ``morph`` ("<erode|dilate|open|close>[:k]"), validated here.  Any
    of them turns the fused tail off (``edge_applicable``): the body span
    then runs to the graph's end (on the segm family K1 and the graph
    executor, the JAX route) and the model's decode rule, the EMA and
    ``postprocess_mask`` with the options follow it.

    ``edge_fused``: None picks the fused edge path when the model's front
    matches its pattern and every BodyPlan the switches call for builds
    (the main paths: K1 + K2, or K1 + K2' + K2'' on CUDA), and the classic
    stages otherwise; True requires it and raises otherwise; False runs
    the classic stages.  ``edge_mega`` and ``edge_cont`` pass to
    :class:`EdgeFused` as ``mega`` and ``cont`` (``edge_cont=None`` takes
    the spec's ``edge_cont``); ``edge_mega=True`` raises where the
    full-span plan does not build.

    The precision modes follow the JAX constructor: ``compute_dtype``
    (torch.float32 or torch.bfloat16) is the graph executor's
    (``load_model``); ``precision`` ("highest", "high" or "default"; None
    takes ``spec.mxu_precision`` and :attr:`precision` holds the result)
    sets the body plans' dots, "default" one bf16 pass (the bf16 mode:
    ``compute_dtype=torch.bfloat16, precision="default"``);
    ``quantize="int8"`` loads per-channel int8 kernels, which the fused
    path refuses: such a model runs the classic stages, and
    ``edge_fused=True`` raises.
    """

    def __init__(self, model: str, width: int, height: int, *,
                 device="cuda", compute_dtype: torch.dtype = torch.float32,
                 precision: Optional[str] = None, quantize: Optional[str] = None,
                 use_bilateral: bool = True,
                 fused: bool = True,
                 u8_exact_post: Optional[bool] = None,
                 refine: str = "box",
                 morph: str = "",
                 edge_fused: Optional[bool] = None,
                 edge_mega: Optional[bool] = None,
                 edge_cont: Optional[bool] = None,
                 onprep: Optional[Callable[[], None]] = None,
                 oninfer: Optional[Callable[[], None]] = None,
                 onmask: Optional[Callable[[], None]] = None,
                 ondebug: Optional[Callable[[str], None]] = None):
        self.device = resolve_device(device)
        set_precision_policy()
        self.onprep, self.oninfer, self.onmask, self.ondebug = onprep, oninfer, onmask, ondebug
        self.model_path = resolve_model_path(model)
        self.spec = spec_for_model(self.model_path)
        self.precision = self.spec.mxu_precision if precision is None else precision
        if self.precision not in PRECISIONS:
            raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
        self.model: CompiledModel = load_model(self.model_path, self.device,
                                               compute_dtype=compute_dtype, quantize=quantize)
        ih, iw = self.model.input_shape[1:3]
        oh, ow = self.model.output_shape[1:3]
        want = self.spec.expected_channels()
        got = self.model.output_shape[-1]
        if want is not None and got != want:
            raise ValueError(
                f"model output has {got} channels but decode rule "
                f"{self.spec.decode!r} expects {want}")
        self.geo = compute_roi(width, height, iw, ih, ow, oh)
        self.use_bilateral = use_bilateral
        if u8_exact_post is None:
            u8_exact_post = os.environ.get("BACKSCRUB_U8_EXACT", "").lower() in ("1", "true", "on")
        if refine not in ("box", "guided"):
            raise ValueError(f"refine must be 'box' or 'guided', got {refine!r}")
        if morph and morph.split(":")[0] not in ("erode", "dilate", "open", "close"):
            raise ValueError(f"morph op must be erode|dilate|open|close, got "
                             f"{morph.split(':')[0]!r}")
        self.u8_exact_post = u8_exact_post
        self.post_options = dict(u8_exact=u8_exact_post, refine=refine, morph=morph)
        self.edge = None
        if fused and edge_fused is not False:
            info = edge_applicable(self.model, self.spec, self.geo, refine=refine,
                                   u8_exact=u8_exact_post, morph=morph, quantize=quantize)
            cont = self.spec.edge_cont if edge_cont is None else edge_cont
            plans = (body_plans(self.model, info, edge_mega, cont, self.precision)
                     if info is not None and info.front_ok else None)
            if plans is not None:
                self.edge = EdgeFused(
                    self.model, self.geo, self.spec, info,
                    use_bilateral=use_bilateral, device=self.device, mega=edge_mega,
                    cont=cont, plans=plans, post_options=self.post_options,
                    precision=self.precision)
            elif edge_fused or edge_mega:
                raise ValueError(f"edge_fused={edge_fused}, edge_mega={edge_mega}: the "
                                 "model/geometry does not match the fusable edge "
                                 "pattern, its body does not fit the BodyPlans "
                                 "these switches call for, or the model is quantized")
        self.post_mats = (self.edge.post_mats if self.edge is not None
                          else fold_blur_tensors(self.geo, self.device))
        self.ema_shape = (oh, ow)
        self.reset()
        self._dbg(f"loaded {self.model_path} ({self.spec.kind}, "
                  f"decode={self.spec.decode}) on {self.device}")
        self._dbg(f"model input {iw}x{ih}, output {ow}x{oh}; frame "
                  f"{width}x{height}; roi={self.geo.roi} in_roi={self.geo.in_roi}")

    def _dbg(self, msg: str) -> None:
        """Injected debug output (the ondebug seam, lib/libbackscrub.h:22-23)."""
        if self.ondebug:
            self.ondebug(msg)

    def reset(self):
        self.ema = torch.full(self.ema_shape, 255, dtype=torch.uint8,
                              device=self.device)

    def _pre(self, frame: torch.Tensor) -> torch.Tensor:
        """Stage 1: (..., H, W, 3) u8 frame(s) -> model input (..., ih, iw,
        3) f32."""
        return preprocess(frame, self.geo, self.spec, self.use_bilateral)

    def _infer(self, x: torch.Tensor) -> torch.Tensor:
        """Stage 2: model input -> model output (oh, ow, C); a stream batch
        (S, ih, iw, 3) runs the graph at batch S -> (S, oh, ow, C).  A graph
        pinned to batch 1 (a RESHAPE to a fixed shape) fails there, as the
        JAX package's batched classic path does."""
        return self.model(x[None])[0] if x.dim() == 3 else self.model(x)

    def _decode_post(self, out: torch.Tensor, ema: torch.Tensor,
                     frame: Optional[torch.Tensor] = None):
        """Stage 3: model output + EMA -> (mask (H, W) u8, new EMA), or over
        a stream batch's leading axis; ``frame`` guides
        ``refine="guided"``."""
        new_ema = ema_update(ema, decode_val(out.float(), self.spec))
        return postprocess_mask(new_ema, self.geo, self.post_mats, frame_bgr=frame,
                                **self.post_options), new_ema

    def step(self, frame: torch.Tensor):
        """(H, W, 3) u8 frame on the device -> mask; advances the EMA.  A
        hook fires once its stage has been enqueued on the device."""
        if self.edge is not None:
            mask, self.ema = self.edge.step_mask(frame, self.ema)
            return mask
        x = self._pre(frame)
        if self.onprep:
            self.onprep()
        out = self._infer(x)
        if self.oninfer:
            self.oninfer()
        mask, self.ema = self._decode_post(out, self.ema, frame)
        return mask

    def masks(self, frames: torch.Tensor, ema: torch.Tensor):
        """A stream batch of frames (S, H, W, 3) u8 on the device and their
        EMAs (S, oh, ow) -> (masks (S, H, W) u8, new EMAs), the EMAs left
        to the caller and no hook fired: the fused edge path over the batch
        (one launch of each kernel), or the classic stages over it, as the
        JAX package composes them (``backscrub_tpu/pipeline/frame.py:
        258-266``)."""
        if self.edge is not None:
            return self.edge.step_mask(frames, ema)
        return self._decode_post(self._infer(self._pre(frames)), ema, frames)

    @torch.no_grad()
    def process(self, frame_bgr_u8) -> torch.Tensor:
        """bs_maskgen_process: (H, W, 3) BGR u8 (numpy or tensor) -> mask
        (H, W) u8 on the device."""
        frame = torch.as_tensor(frame_bgr_u8).to(self.device)
        expected = (self.geo.frame_h, self.geo.frame_w, 3)
        if tuple(frame.shape) != expected:
            raise ValueError(f"frame shape {tuple(frame.shape)} != expected {expected} "
                             f"(geometry fixed at bs_maskgen_new time, like the reference)")
        mask = self.step(frame)
        if self.onmask:
            self.onmask()
        return mask

    def process_bytes(self, frame_bytes: bytes, height: int, width: int) -> bytes:
        """Raw-buffer entry point: BGR u8 bytes in, mask u8 bytes out."""
        frame = np.frombuffer(frame_bytes, np.uint8).reshape(height, width, 3).copy()
        return self.process(frame).cpu().numpy().tobytes()


def parse_capi_options(options: str) -> dict:
    """The ``bs_maskgen_new_ex`` options string as MaskGen kwargs
    (``backscrub_tpu/pipeline/maskgen.py:parse_capi_options``):
    comma-separated tokens of the CLI's ``-p`` namespace —
    ``refine:guided``, ``morph:<erode|dilate|open|close>[:k]``, ``u8exact``
    (byte-exact OpenCV u8 post stages) and ``no-bilateral``.  Unknown tokens
    raise ValueError."""
    kw = {}
    for tok in filter(None, (t.strip() for t in (options or "").split(","))):
        if tok == "u8exact":
            kw["u8_exact_post"] = True
        elif tok == "no-bilateral":
            kw["use_bilateral"] = False
        elif tok.startswith("refine:"):
            kw["refine"] = tok.split(":", 1)[1]
        elif tok.startswith("morph:"):
            kw["morph"] = tok.split(":", 1)[1]
        else:
            raise ValueError(f"unknown maskgen option {tok!r}; supported: refine:guided, "
                             "morph:<erode|dilate|open|close>[:k], u8exact, no-bilateral")
    return kw


def _c_stage_callback(addr: int, ctx_addr: int) -> Callable[[], None]:
    """A raw C function pointer ``void (*)(void *)`` as a Python callable
    bound to the caller's opaque context pointer: the stage-hook shape of
    ``lib/libbackscrub.h:24-30``."""
    import ctypes
    fn = ctypes.CFUNCTYPE(None, ctypes.c_void_p)(addr)
    ctx = ctypes.c_void_p(ctx_addr)
    return lambda: fn(ctx)


def _c_debug_callback(addr: int, ctx_addr: int) -> Callable[[str], None]:
    """``void (*)(void *, const char *)`` (the ondebug seam,
    ``lib/libbackscrub.h:22-23``) as a Python callable."""
    import ctypes
    fn = ctypes.CFUNCTYPE(None, ctypes.c_void_p, ctypes.c_char_p)(addr)
    ctx = ctypes.c_void_p(ctx_addr)
    return lambda msg: fn(ctx, str(msg).encode("utf-8", "replace"))


DEVICE_ENV = "BACKSCRUB_TORCH_DEVICE"


def capi_device() -> str:
    """The C ABI's device: ``BACKSCRUB_TORCH_DEVICE``, ``cuda`` (the
    default) or ``cpu``.  Anything else raises, as does ``cuda`` where CUDA
    is absent (``resolve_device``): a C host never gets a silent CPU run."""
    dev = os.environ.get(DEVICE_ENV, "") or "cuda"
    if dev not in ("cuda", "cpu"):
        raise ValueError(f"{DEVICE_ENV}={dev!r}: expected cuda or cpu")
    return dev


def maskgen_for_capi(model: str, width: int, height: int, options: str = "",
                     ondebug_addr: int = 0, onprep_addr: int = 0,
                     oninfer_addr: int = 0, onmask_addr: int = 0,
                     caller_ctx_addr: int = 0) -> MaskGen:
    """The factory of the C ABI (``backscrub_tpu_torch/native/bs_capi.cc``;
    ``backscrub_tpu/pipeline/maskgen.py:maskgen_for_capi``).

    Takes the consumer's raw callback pointers (0 = NULL).  A non-null
    ``onprep`` or ``oninfer`` selects the staged mode (``fused=False``), so
    all three hooks fire a frame in the reference order
    (``lib/libbackscrub.cc:303,311,363``); with only ``onmask`` and
    ``ondebug`` set the fused edge path is kept.  ``options`` goes through
    :func:`parse_capi_options`; the device comes from :func:`capi_device`.
    """
    kw = parse_capi_options(options)
    for key, addr in (("onprep", onprep_addr), ("oninfer", oninfer_addr),
                      ("onmask", onmask_addr)):
        if addr:
            kw[key] = _c_stage_callback(addr, caller_ctx_addr)
    if ondebug_addr:
        kw["ondebug"] = _c_debug_callback(ondebug_addr, caller_ctx_addr)
    return MaskGen(model, width, height, device=capi_device(),
                   fused=not (onprep_addr or oninfer_addr), **kw)


# C-style aliases of the reference API (lib/libbackscrub.h:13-39)
def bs_maskgen_new(model: str, width: int, height: int, **kwargs) -> MaskGen:
    return MaskGen(model, width, height, **kwargs)


def bs_maskgen_process(ctx: MaskGen, frame, out_mask: Optional[np.ndarray] = None):
    """The mask as a tensor on the context's device; with ``out_mask`` (a
    (H, W) u8 numpy array) the mask is copied there and True is returned."""
    mask = ctx.process(frame)
    if out_mask is None:
        return mask
    out_mask[...] = mask.cpu().numpy()
    return True


def bs_maskgen_delete(ctx: MaskGen) -> None:
    ctx.reset()


def bs_tensorflow_version() -> str:
    """API-parity shim for bs_tensorflow_version (lib/libbackscrub.cc:150)."""
    return f"torch-{torch.__version__}"
