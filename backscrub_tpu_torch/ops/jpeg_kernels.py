"""The MJPG decode on the card: ``bs_jpeg_decode`` (``csrc/jpeg.cu``).

No ``pallas_call`` stands behind it: in the JAX package the decode
(``backscrub_tpu/pipeline/jpeg.py:decode_jpeg_bgr``) is jnp code that XLA
fuses into the frame program.  :func:`decode_jpeg_bgr` runs the plain
version (``pipeline/jpeg.py:decode_jpeg_bgr``, here
``decode_jpeg_bgr_plain``) on CPU tensors and on CUDA tensors launches the
kernel once (``jpeg_decode_kernel``: a CTA a tile of MCUs, dequantize +
IDCT of its blocks and its chroma halo into shared memory, then upsample +
colour from there), counting launches in ``decode_jpeg_bgr.launches``.
Kernel and plain version are byte-identical: integer math throughout.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from .. import _build
from ..io.jpeg import JpegInfo
from ..pipeline.jpeg import decode_jpeg_bgr as decode_jpeg_bgr_plain
from ..pipeline.jpeg import upsample_method


def decode_jpeg_bgr(coefs: Sequence[torch.Tensor], qtabs: torch.Tensor,
                    info: JpegInfo) -> torch.Tensor:
    """(bh, bw, 64) int16 coefficients a component (natural order) and the
    (ncomp, 64) int32 quant tables -> (H, W, 3) BGR u8: the kernel on CUDA
    tensors, the plain version on CPU tensors."""
    if coefs[0].device.type == "cpu":
        return decode_jpeg_bgr_plain(coefs, qtabs, info)
    if info.ncomp not in (1, 3) or len(coefs) < info.ncomp:
        raise ValueError(f"decode: {info.ncomp} components, {len(coefs)} coefficient arrays")
    hmax = max(s[0] for s in info.sampling)
    vmax = max(s[1] for s in info.sampling)
    for c in range(info.ncomp):
        upsample_method(*info.sampling[c], hmax, vmax)  # raises on a ratio it lacks
        _build.check_cuda(coefs[c], f"coefficients {c}", torch.int16, info.blocks[c] + (64,))
    _build.check_cuda(qtabs, "quant tables", torch.int32, (info.ncomp, 64))
    out = torch.empty((info.height, info.width, 3), dtype=torch.uint8, device=coefs[0].device)
    geom = [info.height, info.width, info.ncomp]
    for c in range(3):
        geom += ([*info.sampling[c], *info.blocks[c]] if c < info.ncomp else [0, 0, 0, 0])
    geom = (ctypes.c_int32 * 15)(*geom)
    ptrs = [coefs[c].data_ptr() if c < info.ncomp else None for c in range(3)]
    _build.launch("bs_jpeg_decode", *ptrs, qtabs.data_ptr(), out.data_ptr(),
                  ctypes.addressof(geom))
    decode_jpeg_bgr.launches += 1
    return out


decode_jpeg_bgr.launches = 0
