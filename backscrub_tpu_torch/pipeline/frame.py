"""Whole-frame pipeline: camera frame in, composited frame out
(counterpart of ``backscrub_tpu/pipeline/frame.py``).

Replaces the reference's main-loop hot path (``app/deepseg.cc:627-690``):
mask -> background (explicit, green, or the camera frame with effects) ->
alpha blend -> flip -> resize -> pack.  On CUDA one step runs the mask
(the fused edge path: K1 and K2 for the segm family, K1, K2' and K2'' for
deeplab, K1 and the executor for the segm family with a post option; or
the classic stages with K5) and, where the JAX package takes its fused
pack kernels, the blend + pack kernel (K3 for YUYV, K4 for NV12/I420),
with the EMA mask carried on the device.  Frames arrive as BGR, as a
camera's raw YUYV, UYVY or NV12 bytes, or as an MJPG camera's JPEG
coefficients (``bs_jpeg_decode``), decoded on the device before the mask;
with ``output_format="mjpg"`` the step returns the quantized coefficients
of the composite (``pipeline/jpeg_enc.py``) for the host's Huffman pack.
:meth:`FramePipeline.step_batch` runs the same step over a stream batch,
each kernel launched once for the batch, the EMAs carried by the caller
(``parallel/streams.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..io.jpeg import make_info
from ..ops.jpeg_kernels import decode_jpeg_bgr
from ..ops.pack_kernels import blend_pack_420, blend_pack_yuyv
from .image import (alpha_blend_u8, bgr_to_i420, bgr_to_nv12, desaturate_u8, flip,
                    gaussian_blur, nv12_to_bgr_u8, pixelate_u8, resize_bilinear,
                    rgb_to_yuyv, yuyv_to_rgb_u8)
from .jpeg_enc import encode_jpeg_coefs, stream_qtabs
from .maskgen import MaskGen

_INPUT_FORMATS = ("bgr", "yuyv", "uyvy", "nv12", "mjpg")
_OUTPUT_FORMATS = ("yuyv", "nv12", "i420", "bgr", "mjpg")
_JPEG_SAMPLING = {"420": ((2, 2), (1, 1), (1, 1)), "422": ((2, 1), (1, 1), (1, 1)),
                  "444": ((1, 1), (1, 1), (1, 1))}


@dataclasses.dataclass
class PipelineConfig:
    width: int = 640           # capture geometry (app/deepseg.cc:363-364 defaults)
    height: int = 480
    out_width: Optional[int] = None    # virtual camera geometry; None = same
    out_height: Optional[int] = None
    blur_strength: int = 0     # Gaussian background blur kernel; 0 = off
    bg_desaturate: bool = False
    bg_pixelate: int = 0       # mosaic tile size; 0 = off
    flip_horizontal: bool = False
    flip_vertical: bool = False
    use_bilateral: bool = True
    mask_refine: str = "box"           # "box" | "guided" (-p refine:guided)
    mask_morph: str = ""               # -p morph:<erode|dilate|open|close>[:k]
    edge_fused: Optional[bool] = None  # None: fused edge path when the model
                                       # matches; False: classic stages
    edge_mega: Optional[bool] = None   # body plans (K2 / K2'); False: the
                                       # graph executor behind the front
    edge_cont: Optional[bool] = None   # flat continuation (K2''); None:
                                       # ModelSpec.edge_cont
    chroma_order: str = "reference"    # or "yuy2" for spec-correct output
    correct_colors: bool = False       # True: proper BGR->RGB before the pack
    output_format: str = "yuyv"        # "yuyv" (H, 2W) | "nv12" (3H/2, W) |
                                       # "i420" (3HW/2,) | "bgr" (H, W, 3) |
                                       # "mjpg": JPEG coefficients, a tuple of
                                       # (bh, bw, 64) int16 in zigzag order
    out_jpeg_quality: int = 85         # output_format="mjpg": libjpeg quality
    out_jpeg_sampling: str = "420"     # and chroma sampling (420|422|444)
    input_format: str = "bgr"          # "bgr" (H, W, 3) | "yuyv" / "uyvy" (H, 2W)
                                       # | "nv12" (3H/2, W): raw camera bytes |
                                       # "mjpg": (coefs, qtabs) from the host
                                       # entropy decoder (io/jpeg.py)
    jpeg_info: Optional[object] = None  # io.jpeg.JpegInfo, required for
                                        # input_format="mjpg" (fixed a stream)


class FramePipeline:
    """End-to-end per-frame step with carried EMA state on ``device`` (the
    card unless the caller asks for the CPU; raises where CUDA is asked
    for and absent).  ``compute_dtype``, ``precision`` and ``quantize`` go
    to :class:`MaskGen` (the bf16 and int8 modes).

    ``step(frame_bgr_u8, background_bgr_u8=None)`` -> (packed output,
    mask (H, W) u8) as tensors on the device.  No background means green,
    or, with any background effect on, the camera frame itself (the
    reference's bgblur mode).

    The output side follows the JAX package exactly.  Where its gate
    holds (output yuyv/nv12/i420, no flips, output geometry equal to the
    capture geometry) one kernel blends and packs (K3 or K4; on CPU tensors
    their plain versions).  Otherwise the frame is blended,
    flipped, resized to the output geometry (bilinear, rounded, clipped)
    and converted in plain PyTorch: these are the JAX package's own
    semantics for those options, not a fallback.
    """

    def __init__(self, model: str, config: PipelineConfig, *, device="cuda",
                 compute_dtype: torch.dtype = torch.float32, precision: Optional[str] = None,
                 quantize: Optional[str] = None):
        if config.input_format not in _INPUT_FORMATS:
            raise ValueError(f"input_format must be one of {_INPUT_FORMATS}, "
                             f"got {config.input_format!r}")
        if config.input_format in ("yuyv", "uyvy") and config.width % 2:
            raise ValueError(f"width={config.width}: 4:2:2 ingest needs an even width")
        if config.input_format == "nv12" and (config.width % 2 or config.height % 2):
            raise ValueError(f"capture geometry {config.width}x{config.height}: 4:2:0 "
                             "(nv12) ingest needs even width and height")
        if config.input_format == "mjpg":
            info = config.jpeg_info
            if info is None:
                raise ValueError("input_format='mjpg' needs jpeg_info "
                                 "(io.jpeg.parse_header of the first frame)")
            if (info.width, info.height) != (config.width, config.height):
                raise ValueError(f"MJPG stream is {info.width}x{info.height} but capture "
                                 f"geometry is {config.width}x{config.height}")
        fmt = config.output_format
        if fmt not in _OUTPUT_FORMATS:
            raise ValueError(f"output_format must be one of {_OUTPUT_FORMATS}, got {fmt!r}")
        ow = config.out_width or config.width
        oh = config.out_height or config.height
        if fmt == "yuyv":
            for label, w in (("width", config.width), ("out_width", ow)):
                if w % 2:
                    raise ValueError(f"{label}={w}: YUYV output needs an even width "
                                     "(chroma is shared per pixel pair)")
        elif fmt in ("nv12", "i420"):
            for label, a, b in (("capture", config.width, config.height),
                                ("output", ow, oh)):
                if a % 2 or b % 2:
                    raise ValueError(f"{label} geometry {a}x{b}: 4:2:0 output ({fmt}) "
                                     "needs even width and height")
        self.out_jpeg_info = self.out_jpeg_qtabs = None
        if fmt == "mjpg":
            if config.out_jpeg_sampling not in _JPEG_SAMPLING:
                raise ValueError(f"out_jpeg_sampling must be one of {tuple(_JPEG_SAMPLING)}, "
                                 f"got {config.out_jpeg_sampling!r}")
            self.out_jpeg_info = make_info(ow, oh, _JPEG_SAMPLING[config.out_jpeg_sampling])
            self.out_jpeg_qtabs = stream_qtabs(config.out_jpeg_quality)
        self.cfg = config
        self.out_geo = (oh, ow)
        self.maskgen = MaskGen(model, config.width, config.height,
                               device=device, compute_dtype=compute_dtype,
                               precision=precision, quantize=quantize,
                               use_bilateral=config.use_bilateral,
                               refine=config.mask_refine, morph=config.mask_morph,
                               edge_fused=config.edge_fused,
                               edge_mega=config.edge_mega,
                               edge_cont=config.edge_cont)
        self.device = self.maskgen.device
        self.precision = self.maskgen.precision   # the spec's default resolved
        self._out_qtabs = (None if self.out_jpeg_qtabs is None else
                           torch.from_numpy(self.out_jpeg_qtabs.astype(np.int32)).to(self.device))
        self.geo = self.maskgen.geo
        green = np.zeros((config.height, config.width, 3), np.uint8)
        green[..., 1] = 255
        self.green = torch.from_numpy(green).to(self.device)

    def _upload(self, img, name: str, fmt: str = "bgr", n: Optional[int] = None):
        """A host array or a tensor already on the device (a staged
        upload: not copied again) as a contiguous u8 tensor on the device,
        checked against the shape that ``fmt`` gives the capture geometry,
        with a leading axis of ``n`` frames where ``n`` is given; an MJPG
        frame ``(coefs, qtabs)`` as (int16 tensors a component, int32
        tables)."""
        if fmt == "mjpg":
            return self._upload_jpeg(img, n)
        t = torch.as_tensor(img).to(self.device)
        h, w = self.cfg.height, self.cfg.width
        want = {"bgr": (h, w, 3), "yuyv": (h, 2 * w), "uyvy": (h, 2 * w),
                "nv12": (h * 3 // 2, w)}[fmt]
        want = want if n is None else (n,) + want
        if tuple(t.shape) != want or t.dtype != torch.uint8:
            raise ValueError(f"{name}: expected {want} uint8, got "
                             f"{tuple(t.shape)} {t.dtype}")
        return t.contiguous()

    def _upload_jpeg(self, frame, n: Optional[int] = None):
        info = self.cfg.jpeg_info
        lead = () if n is None else (n,)
        coefs, qtabs = frame
        coefs = [torch.as_tensor(c).to(self.device) for c in coefs[:info.ncomp]]
        for c, t in enumerate(coefs):
            if tuple(t.shape) != lead + info.blocks[c] + (64,) or t.dtype != torch.int16:
                raise ValueError(f"MJPG component {c}: expected "
                                 f"{lead + info.blocks[c] + (64,)} int16, got "
                                 f"{tuple(t.shape)} {t.dtype}")
        if not isinstance(qtabs, torch.Tensor):  # the decoder's u16 tables
            qtabs = torch.from_numpy(np.asarray(qtabs, np.int32))
        q = qtabs.to(self.device, torch.int32)
        if tuple(q.shape) != lead + (info.ncomp, 64):
            raise ValueError(f"MJPG quant tables: expected {lead + (info.ncomp, 64)}, "
                             f"got {tuple(q.shape)}")
        return [t.contiguous() for t in coefs], q.contiguous()

    def decode(self, frame) -> torch.Tensor:
        """The uploaded frame as BGR (H, W, 3) u8, or a stream batch as
        (S, H, W, 3): raw camera bytes decoded on the device
        (``backscrub_tpu/pipeline/frame.py:229-244``: BT.601 video range,
        YUY2 chroma order; MJPG coefficients through ``bs_jpeg_decode``,
        bit-exact vs cv2.imdecode, one call a stream), BGR as it is."""
        fmt = self.cfg.input_format
        if fmt == "mjpg":
            coefs, q = frame
            if q.dim() == 2:
                return decode_jpeg_bgr(coefs, q, self.cfg.jpeg_info)
            return torch.stack([decode_jpeg_bgr([c[s] for c in coefs], q[s],
                                                self.cfg.jpeg_info) for s in range(q.shape[0])])
        if fmt in ("yuyv", "uyvy"):
            pairs = tuple(frame.shape[:-1]) + (frame.shape[-1] // 2, 2)
            return yuyv_to_rgb_u8(frame.reshape(pairs), layout=fmt).flip(-1)
        if fmt == "nv12":
            return nv12_to_bgr_u8(frame)
        return frame

    def fused_pack_applies(self, flip_h: bool, flip_v: bool) -> bool:
        """The JAX package's gate of the fused pack kernels
        (``frame.py:280-283``); its ``fused_pack`` switch, which picks jnp
        over Pallas off the TPU, has no counterpart here: the tensor's
        device picks the kernel or its plain version."""
        cfg = self.cfg
        return (cfg.output_format in ("yuyv", "nv12", "i420")
                and not flip_h and not flip_v
                and self.out_geo == (cfg.height, cfg.width))

    def background(self, frame: torch.Tensor, bg: Optional[torch.Tensor]) -> torch.Tensor:
        """The background to blend (``frame.py:268-277``): ``bg``, or the
        camera frame when none is given and an effect is on, then
        desaturate -> pixelate -> Gaussian blur; green when neither."""
        cfg = self.cfg
        effects = cfg.blur_strength or cfg.bg_pixelate or cfg.bg_desaturate
        if bg is None:
            bg = frame if effects else self.green
        if cfg.bg_desaturate:
            bg = desaturate_u8(bg)
        if cfg.bg_pixelate:
            bg = pixelate_u8(bg, cfg.bg_pixelate)
        if cfg.blur_strength:
            bg = torch.clamp(torch.round(gaussian_blur(bg.float(), cfg.blur_strength)),
                             0, 255).to(torch.uint8)
        return bg.contiguous()

    def finish(self, comp: torch.Tensor, flip_h: bool, flip_v: bool):
        """Composite (H, W, 3) BGR u8 -> output bytes (``frame.py:201-227``):
        flip, resize to the output geometry, convert; for "mjpg" the tuple
        of quantized coefficients a component (zigzag order)."""
        cfg = self.cfg
        comp = flip(comp, flip_h, flip_v)
        oh, ow = self.out_geo
        if (oh, ow) != (cfg.height, cfg.width):
            comp = torch.clamp(torch.round(resize_bilinear(comp.float(), oh, ow)),
                               0, 255).to(torch.uint8)
        fmt = cfg.output_format
        if fmt == "bgr":
            return comp
        if fmt == "mjpg":
            return tuple(encode_jpeg_coefs(comp, self._out_qtabs, self.out_jpeg_info))
        if fmt == "nv12":
            return bgr_to_nv12(comp)
        if fmt == "i420":
            return bgr_to_i420(comp)
        src = comp.flip(-1) if cfg.correct_colors else comp
        yuyv = rgb_to_yuyv(src, chroma_order=cfg.chroma_order)
        return yuyv.reshape(tuple(yuyv.shape[:-2]) + (yuyv.shape[-2] * 2,))

    @torch.no_grad()
    def step(self, frame_bgr_u8, background_bgr_u8=None, *, flip_horizontal=None,
             flip_vertical=None, filter_active: bool = True):
        """Process one frame (for input_format="mjpg" the ``(coefs, qtabs)``
        of the host entropy decoder).  ``flip_horizontal`` /
        ``flip_vertical`` override the config for this step;
        ``filter_active=False`` passes the frame through (mask all 255, the
        EMA untouched), as the reference's 's' key does."""
        cfg = self.cfg
        fh = cfg.flip_horizontal if flip_horizontal is None else flip_horizontal
        fv = cfg.flip_vertical if flip_vertical is None else flip_vertical
        frame = self.decode(self._upload(frame_bgr_u8, "frame", cfg.input_format))
        if not filter_active:
            mask = torch.full(tuple(frame.shape[:-1]), 255, dtype=torch.uint8,
                              device=self.device)
            return self.finish(frame, fh, fv), mask
        mask = self.maskgen.step(frame).contiguous()
        bg = self.background(frame, None if background_bgr_u8 is None
                             else self._upload(background_bgr_u8, "background"))
        return self._output(frame, bg, mask, fh, fv), mask

    def _output(self, frame, bg, mask, fh: bool, fv: bool):
        """Frame(s), background(s) and mask(s) -> the output bytes: K3 or
        K4 where the JAX package's gate holds, else blend and ``finish``."""
        cfg = self.cfg
        if self.fused_pack_applies(fh, fv):
            if cfg.output_format == "yuyv":
                return blend_pack_yuyv(frame, bg, mask, chroma_order=cfg.chroma_order,
                                       correct_colors=cfg.correct_colors)
            return blend_pack_420(frame, bg, mask, layout=cfg.output_format)
        return self.finish(alpha_blend_u8(bg, frame, mask), fh, fv)

    @torch.no_grad()
    def step_batch(self, frames, backgrounds, ema: torch.Tensor):
        """One step of a stream batch, the JAX package's batched compose
        (``backscrub_tpu/pipeline/frame.py:194-330`` with ``active=True``):
        ``frames`` (S, H, W, 3) BGR, (S, H, 2W) YUYV/UYVY, (S, 3H/2, W) NV12
        or, for "mjpg", (coefficient arrays (S, bh, bw, 64) a component,
        tables (S, ncomp, 64)); ``backgrounds`` (S, H, W, 3) BGR or None
        (green, or the frames with a background effect on); ``ema`` the
        streams' EMAs (S, oh, ow) u8 on the device.  Returns (outputs,
        masks (S, H, W), new EMAs): outputs (S, ...) in the output format,
        for "mjpg" a tuple of (S, bh, bw, 64) coefficients a component.
        Each kernel of the step runs once for the batch (K1, each body plan
        and K3 or K4; K5 on the classic stages); the MJPG decode once a
        stream.  The config's flips apply."""
        cfg = self.cfg
        n = ema.shape[0]
        frame = self.decode(self._upload(frames, "frames", cfg.input_format, n))
        masks, new_ema = self.maskgen.masks(frame, ema)
        masks = masks.contiguous()
        bg = self.background(frame, None if backgrounds is None
                             else self._upload(backgrounds, "backgrounds", "bgr", n))
        if bg.dim() < frame.dim():
            bg = bg.expand(frame.shape).contiguous()
        out = self._output(frame, bg, masks, cfg.flip_horizontal, cfg.flip_vertical)
        return out, masks, new_ema

    def reset(self):
        self.maskgen.reset()
