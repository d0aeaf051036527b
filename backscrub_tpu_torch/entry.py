"""The flagship entry of the port (counterpart of ``__graft_entry__.entry()``).

``entry()`` returns the flagship single-card frame step and its example
arguments: the fused ``FramePipeline`` on the Google Meet lite model at
640x480, BGR in, packed YUYV out, the same geometry, no flips, the EMA
carried as state.  On the card one call is K1, K2 and K3, one launch each.
"""

from __future__ import annotations

import numpy as np
import torch

from .models.specs import resolve_model_path
from .pipeline.frame import FramePipeline, PipelineConfig

FLAGSHIP = "segm_lite_v681.tflite"
WIDTH, HEIGHT = 640, 480


def frame_step(pipe: FramePipeline):
    """``pipe``'s step as a function of its state: ``fn(frame, background,
    ema) -> (output, mask, new_ema)``, the shape of the JAX package's
    ``FramePipeline._make_step("explicit", False, False, True)`` without
    the parameters (the port's weights live in the pipeline).  It is
    ``pipe.step_batch`` on a batch of one, so it decodes the input format,
    applies the background effects and the config's flips as every step
    does; ``pipe``'s own EMA is neither read nor written."""

    def fn(frame, background, ema: torch.Tensor):
        if pipe.cfg.input_format == "mjpg":     # (coefs a component, qtabs)
            frame = ([c[None] for c in frame[0]], frame[1][None])
        else:
            frame = frame[None]
        bg = None if background is None else background[None]
        out, masks, new_ema = pipe.step_batch(frame, bg, ema[None])
        if isinstance(out, tuple):      # MJPG out: coefficients a component
            return tuple(c[0] for c in out), masks[0], new_ema[0]
        return out[0], masks[0], new_ema[0]

    return fn


def entry(model: str = FLAGSHIP, device="cuda"):
    """(fn, example_args): :func:`frame_step` of the flagship pipeline and
    a seeded u8 frame and background (seed 0, as the JAX entry) and a fresh
    EMA, all on ``device`` (the card unless the caller asks for the CPU;
    raises where CUDA is asked for and absent).  ``model`` resolves
    through ``resolve_model_path``; a missing model raises."""
    pipe = FramePipeline(resolve_model_path(model), PipelineConfig(width=WIDTH, height=HEIGHT),
                         device=device)
    rng = np.random.default_rng(0)
    frame = torch.from_numpy(rng.integers(0, 256, (HEIGHT, WIDTH, 3), np.uint8)).to(pipe.device)
    bg = torch.from_numpy(rng.integers(0, 256, (HEIGHT, WIDTH, 3), np.uint8)).to(pipe.device)
    return frame_step(pipe), (frame, bg, pipe.maskgen.ema.clone())
