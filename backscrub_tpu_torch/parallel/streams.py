"""Multi-stream frame pipeline: S camera streams, one card, one step
(counterpart of ``backscrub_tpu/parallel/streams.py``).

The scaling unit of the JAX package is a stream batch: frames from S
streams stack into (S, H, W, 3) and the whole frame program runs once
over them.  Here the batch runs through :meth:`FramePipeline.step_batch`:
every kernel of the step launches once for the S frames (K1, each body
plan, K3 or K4; K5 on the classic stages), and each stream's temporal EMA
is one row of an (S, oh, ow) u8 tensor on the card, so streams never mix.
The JAX mesh and its parameter sharding have no counterpart: the port
serves one card (ROADMAP queue 1 item 8 is multi-device serving).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..pipeline.frame import FramePipeline, PipelineConfig


class MultiStreamPipeline:
    """Run the whole-frame step over a stream batch on ``device`` (the
    card unless the caller asks for the CPU; raises where CUDA is asked for
    and absent).  ``compute_dtype`` and ``precision`` go to
    :class:`FramePipeline` (the bf16 mode).

    ``step(frames, backgrounds=None)`` -> (outputs (S, ...), masks (S, H,
    W) u8) as tensors on the device; frames as ``input_format`` gives them
    with a leading stream axis (for "mjpg" the tuple of (S, bh, bw, 64)
    coefficient arrays and the (S, ncomp, 64) tables); backgrounds (S, H,
    W, 3) BGR u8, host or device, or None for green (cached on the
    device; the background effects then apply to it, as in the JAX
    package's batched step, whose background is always explicit).
    """

    def __init__(self, model: str, config: PipelineConfig, n_streams: int, *,
                 device="cuda", compute_dtype: torch.dtype = torch.float32,
                 precision: Optional[str] = None):
        if n_streams < 1:
            raise ValueError(f"n_streams must be at least 1, got {n_streams}")
        self.n_streams = n_streams
        self.pipe = FramePipeline(model, config, device=device, compute_dtype=compute_dtype,
                                  precision=precision)
        self.device = self.pipe.device
        self._green_batch = None
        self.reset()

    def step(self, frames, backgrounds=None):
        if backgrounds is None:
            if self._green_batch is None:
                g = self.pipe.green
                self._green_batch = g.expand((self.n_streams,) + tuple(g.shape)).contiguous()
            backgrounds = self._green_batch
        out, masks, self.ema = self.pipe.step_batch(frames, backgrounds, self.ema)
        return out, masks

    def reset(self):
        """Every stream's EMA to the all-background init."""
        self.ema = torch.full((self.n_streams,) + self.pipe.maskgen.ema_shape, 255,
                              dtype=torch.uint8, device=self.device)

    def reset_stream(self, s: int):
        """Reset ONE stream's EMA to the all-background init
        (libbackscrub.cc:248) without touching the others: a batch slot
        re-occupied by a new live stream (``MultiStreamServer.attach``)."""
        self.ema[s] = 255
