"""Whole-frame pipeline: camera frame in, composited YUYV out
(counterpart of ``backscrub_tpu/pipeline/frame.py``).

Replaces the reference's main-loop hot path (``app/deepseg.cc:627-690``):
mask -> alpha blend -> RGB2YUYV.  On CUDA one step runs the fused edge
path (K1 and K2 for the segm family; K1, K2' and K2'' for deeplab) and
the blend + pack kernel (K3), with the EMA mask carried on the device.
The slices serve BGR in, YUYV out, an explicit or green background, the
same geometry and no flips; other options raise NotImplementedError
naming the ROADMAP item that brings them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..ops.pack_kernels import blend_pack_yuyv
from .maskgen import MaskGen

# option -> (value the slice serves, the ROADMAP item that brings the rest)
_NOT_YET = {
    "out_width": (None, "queue 1 item 10 (out-geometry resize)"),
    "out_height": (None, "queue 1 item 10 (out-geometry resize)"),
    "flip_horizontal": (False, "queue 1 item 10 (flips)"),
    "flip_vertical": (False, "queue 1 item 10 (flips)"),
    "blur_strength": (0, "queue 1 item 10 (background blur)"),
    "bg_desaturate": (False, "queue 1 item 10 (background effects)"),
    "bg_pixelate": (0, "queue 1 item 10 (background effects)"),
    "mask_refine": ("box", "queue 1 item 10 (refine=guided)"),
    "mask_morph": ("", "queue 1 item 10 (morph)"),
    "output_format": ("yuyv", "queue 1 item 10 (NV12/I420 out, queue 2 item 4)"),
    "input_format": ("bgr", "queue 1 item 10 (yuyv/nv12/mjpg ingest)"),
}


@dataclasses.dataclass
class PipelineConfig:
    width: int = 640           # capture geometry (app/deepseg.cc:363-364 defaults)
    height: int = 480
    out_width: Optional[int] = None
    out_height: Optional[int] = None
    blur_strength: int = 0
    bg_desaturate: bool = False
    bg_pixelate: int = 0
    flip_horizontal: bool = False
    flip_vertical: bool = False
    use_bilateral: bool = True
    mask_refine: str = "box"
    mask_morph: str = ""
    edge_fused: Optional[bool] = None  # None: fused edge path when the model
                                       # matches; False: classic stages
    edge_mega: Optional[bool] = None   # body plans (K2 / K2'); False: the
                                       # graph executor behind the front
    edge_cont: Optional[bool] = None   # flat continuation (K2''); None:
                                       # ModelSpec.edge_cont
    chroma_order: str = "reference"    # or "yuy2" for spec-correct output
    correct_colors: bool = False       # True: proper BGR->RGB before the pack
    output_format: str = "yuyv"
    input_format: str = "bgr"


class FramePipeline:
    """End-to-end per-frame step with carried EMA state on ``device``.

    ``step(frame_bgr_u8, background_bgr_u8=None)`` -> (yuyv (H, 2W) u8,
    mask (H, W) u8) as tensors on the device; no background means green.
    """

    def __init__(self, model: str, config: PipelineConfig, *, device="cpu"):
        same_geometry = {"out_width": config.width, "out_height": config.height}
        for name, (served, item) in _NOT_YET.items():
            value = getattr(config, name)
            if value not in (served, same_geometry.get(name, served)):
                raise NotImplementedError(
                    f"{name}={value!r} is not in the PyTorch port yet: "
                    f"ROADMAP {item}")
        if config.width % 2:
            raise ValueError(f"width={config.width}: YUYV output needs an "
                             "even width (chroma is shared per pixel pair)")
        self.cfg = config
        self.maskgen = MaskGen(model, config.width, config.height,
                               device=device, use_bilateral=config.use_bilateral,
                               edge_fused=config.edge_fused,
                               edge_mega=config.edge_mega,
                               edge_cont=config.edge_cont)
        self.device = self.maskgen.device
        self.geo = self.maskgen.geo
        green = np.zeros((config.height, config.width, 3), np.uint8)
        green[..., 1] = 255
        self.green = torch.from_numpy(green).to(self.device)

    def _upload(self, img, name: str) -> torch.Tensor:
        t = torch.as_tensor(img).to(self.device)
        want = (self.cfg.height, self.cfg.width, 3)
        if tuple(t.shape) != want or t.dtype != torch.uint8:
            raise ValueError(f"{name}: expected {want} uint8, got "
                             f"{tuple(t.shape)} {t.dtype}")
        return t.contiguous()

    @torch.no_grad()
    def step(self, frame_bgr_u8, background_bgr_u8=None):
        frame = self._upload(frame_bgr_u8, "frame")
        bg = (self.green if background_bgr_u8 is None
              else self._upload(background_bgr_u8, "background"))
        mask = self.maskgen.step(frame)
        yuyv = blend_pack_yuyv(frame, bg, mask.contiguous(),
                               chroma_order=self.cfg.chroma_order,
                               correct_colors=self.cfg.correct_colors)
        return yuyv, mask

    def reset(self):
        self.maskgen.reset()
