"""Mask generation (counterpart of ``backscrub_tpu/pipeline/maskgen.py``).

The reference chain (``lib/libbackscrub.cc:279-372``): ROI crop -> resize
-> BGR2RGB -> bilateral filter -> normalize -> CNN -> decode with the
temporal EMA -> upscale -> 5x5 box blur.  :class:`MaskGen` runs it either
through the fused edge path (``pipeline/edge.py``: kernels K1 and K2, or
K1, K2' and K2'', on CUDA) or through the classic stages below and the
graph executor.

Masks are u8, 0 = person (keep the camera pixel), 255 = background; the
area outside the aspect-ratio ROI is always 255.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..graph.executor import CompiledModel, load_model
from ..models.specs import ModelSpec, resolve_model_path, spec_for_model
from .decode import decode_val, ema_update
from .edge import EdgeFused, body_plans, edge_applicable, postprocess_mask
from .geometry import RoiGeometry, compute_roi
from .image import bilateral5, resize_bilinear


def set_precision_policy() -> None:
    """Full f32 for every plain matmul and convolution: cuDNN convs would
    otherwise run in TF32 on the card and the plain references that the
    kernels are held against would be wrong."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device must exist (no silent
    fallback to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device={device!r} requested but CUDA is not "
                           f"available")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"device must be cpu or cuda, got {device!r}")
    return dev


def preprocess(frame_bgr_u8: torch.Tensor, geo: RoiGeometry, spec: ModelSpec,
               use_bilateral: bool = True) -> torch.Tensor:
    """Frame (H, W, 3) BGR u8 -> model input (in_h, in_w, 3) f32."""
    r = geo.roi
    roi = frame_bgr_u8[r.y:r.y + r.h, r.x:r.x + r.w, :].float()
    small = torch.round(resize_bilinear(roi, geo.in_roi.h, geo.in_roi.w))
    ix, iy = geo.in_roi.x, geo.in_roi.y
    canvas = F.pad(small, (0, 0, ix, geo.model_in_w - ix - geo.in_roi.w,
                           iy, geo.model_in_h - iy - geo.in_roi.h))
    rgb = canvas.flip(-1)  # BGR -> RGB (libbackscrub.cc:290)
    if use_bilateral:
        rgb = torch.round(bilateral5(rgb))
    return rgb * spec.scale + spec.offset


class MaskGen:
    """bs_maskgen_new equivalent on ``device``.

    ``edge_fused``: None picks the fused edge path when the model's front
    matches its pattern and every BodyPlan the switches call for builds
    (the main paths: K1 + K2, or K1 + K2' + K2'' on CUDA), and the classic
    stages otherwise; True requires it and raises otherwise; False runs
    the classic stages.  ``edge_mega`` and ``edge_cont`` pass to
    :class:`EdgeFused` as ``mega`` and ``cont`` (``edge_cont=None`` takes
    the spec's ``edge_cont``); ``edge_mega=True`` raises where the
    full-span plan does not build.
    """

    def __init__(self, model: str, width: int, height: int, *,
                 device="cpu", use_bilateral: bool = True,
                 edge_fused: Optional[bool] = None,
                 edge_mega: Optional[bool] = None,
                 edge_cont: Optional[bool] = None):
        self.device = resolve_device(device)
        set_precision_policy()
        self.model_path = resolve_model_path(model)
        self.spec = spec_for_model(self.model_path)
        self.model: CompiledModel = load_model(self.model_path, self.device)
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
        self.edge = None
        if edge_fused is not False:
            info = edge_applicable(self.model, self.spec, self.geo)
            cont = self.spec.edge_cont if edge_cont is None else edge_cont
            plans = (body_plans(self.model, info, edge_mega, cont)
                     if info is not None and info.front_ok else None)
            if plans is not None:
                self.edge = EdgeFused(
                    self.model, self.geo, self.spec, info,
                    use_bilateral=use_bilateral, device=self.device, mega=edge_mega,
                    cont=cont, plans=plans)
            elif edge_fused or edge_mega:
                raise ValueError(f"edge_fused={edge_fused}, edge_mega={edge_mega}: the "
                                 "model/geometry does not match the fusable edge "
                                 "pattern, or its body does not fit the BodyPlans "
                                 "these switches call for")
        self.ema_shape = (oh, ow)
        self.reset()

    def reset(self):
        self.ema = torch.full(self.ema_shape, 255, dtype=torch.uint8,
                              device=self.device)

    def step(self, frame: torch.Tensor):
        """(H, W, 3) u8 frame on the device -> mask; advances the EMA."""
        if self.edge is not None:
            mask, self.ema = self.edge.step_mask(frame, self.ema)
            return mask
        x = preprocess(frame, self.geo, self.spec, self.use_bilateral)
        out = self.model(x[None])[0]
        self.ema = ema_update(self.ema, decode_val(out, self.spec))
        return postprocess_mask(self.ema, self.geo)

    @torch.no_grad()
    def process(self, frame_bgr_u8) -> torch.Tensor:
        """bs_maskgen_process: (H, W, 3) BGR u8 (numpy or tensor) -> mask."""
        frame = torch.as_tensor(frame_bgr_u8).to(self.device)
        expected = (self.geo.frame_h, self.geo.frame_w, 3)
        if tuple(frame.shape) != expected:
            raise ValueError(f"frame shape {tuple(frame.shape)} != expected {expected}")
        return self.step(frame)
