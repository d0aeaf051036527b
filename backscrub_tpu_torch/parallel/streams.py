"""Multi-stream frame pipeline: S camera streams, one step, on one card or
over a mesh's "data" axis (counterpart of
``backscrub_tpu/parallel/streams.py``).

The scaling unit of the JAX package is a stream batch: frames from S
streams stack into (S, H, W, 3) and the whole frame program runs once
over them.  Here the batch runs through :meth:`FramePipeline.step_batch`:
every kernel of the step launches once for the streams of this device
(K1, each body plan, K3 or K4; K5 on the classic stages), and each
stream's temporal EMA is one row of an (S, oh, ow) u8 tensor on the
device that serves it, so streams never mix.

On a mesh (``parallel/mesh.py``) the batch goes over "data": data rank r
serves slots r, r + d, ... (``stream_slice``).  The frame path's kernels
take whole weights (K1, K2, K2', K2'' and K3/K4 are persistent kernels
over the whole body), so its weights stay replicated where the JAX
package shards them over "model" (its body is one Pallas call there):
the model ranks of one data slice compute the same rows.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..pipeline.frame import FramePipeline, PipelineConfig
from .mesh import gather_streams, stream_slice


def take_rows(batch, sl: slice):
    """Rows ``sl`` of a stream batch: an array or tensor, or the MJPG
    ``(coefficient arrays, qtabs)`` pair, each contiguous."""
    if isinstance(batch, tuple):
        coefs, qtabs = batch
        return tuple(take_rows(c, sl) for c in coefs), take_rows(qtabs, sl)
    if torch.is_tensor(batch):
        return batch[sl].contiguous()
    return np.ascontiguousarray(batch[sl])


class MultiStreamPipeline:
    """Run the whole-frame step over a stream batch on ``device`` (the
    card unless the caller asks for the CPU; raises where CUDA is asked for
    and absent), or over ``mesh``'s "data" axis on this rank's device (S
    must divide by it).  ``compute_dtype`` and ``precision`` go to
    :class:`FramePipeline` (the bf16 mode).

    ``step(frames, backgrounds=None)`` -> (outputs (S, ...), masks (S, H,
    W) u8) as tensors on the device, the whole batch (gathered over "data"
    on a mesh, every rank calling it with the same batch); frames as
    ``input_format`` gives them with a leading stream axis (for "mjpg" the
    tuple of (S, bh, bw, 64) coefficient arrays and the (S, ncomp, 64)
    tables); backgrounds (S, H, W, 3) BGR u8, host or device, or None for
    green (cached on the device; the background effects then apply to it,
    as in the JAX package's batched step, whose background is always
    explicit).  :meth:`step_local` takes and returns only this rank's rows
    (``slots``), with no collective: the servers' form.
    """

    def __init__(self, model: str, config: PipelineConfig, n_streams: int, mesh=None, *,
                 device="cuda", compute_dtype: torch.dtype = torch.float32,
                 precision: Optional[str] = None):
        if n_streams < 1:
            raise ValueError(f"n_streams must be at least 1, got {n_streams}")
        if mesh is not None:
            if n_streams % mesh.shape["data"] != 0:
                raise ValueError(f"n_streams={n_streams} not divisible by data axis "
                                 f"{mesh.shape['data']}")
            device = mesh.device
        self.mesh = mesh
        self.n_streams = n_streams
        self.rows = stream_slice(mesh, n_streams)
        self.slots = list(range(n_streams))[self.rows]
        self.pipe = FramePipeline(model, config, device=device, compute_dtype=compute_dtype,
                                  precision=precision)
        self.device = self.pipe.device
        self._green_batch = None
        self.reset()

    def step_local(self, frames, backgrounds=None):
        """One step of this rank's streams: frames and backgrounds of its
        slots only; returns their outputs and masks."""
        if backgrounds is None:
            if self._green_batch is None:
                g = self.pipe.green
                self._green_batch = g.expand((len(self.slots),) + tuple(g.shape)).contiguous()
            backgrounds = self._green_batch
        out, masks, self.ema = self.pipe.step_batch(frames, backgrounds, self.ema)
        return out, masks

    def step(self, frames, backgrounds=None):
        if self.mesh is None:
            return self.step_local(frames, backgrounds)
        out, masks = self.step_local(
            take_rows(frames, self.rows),
            None if backgrounds is None else take_rows(backgrounds, self.rows))
        if isinstance(out, tuple):      # MJPG out: coefficients a component
            out = tuple(gather_streams(c, self.mesh) for c in out)
        else:
            out = gather_streams(out, self.mesh)
        return out, gather_streams(masks, self.mesh)

    def reset(self):
        """Every stream's EMA to the all-background init."""
        self.ema = torch.full((len(self.slots),) + self.pipe.maskgen.ema_shape, 255,
                              dtype=torch.uint8, device=self.device)

    def reset_stream(self, s: int):
        """Reset ONE stream's EMA to the all-background init
        (libbackscrub.cc:248) without touching the others: a batch slot
        re-occupied by a new live stream (``MultiStreamServer.attach``).
        A slot that another rank serves is left to it."""
        if s in self.slots:
            self.ema[self.slots.index(s)] = 255
