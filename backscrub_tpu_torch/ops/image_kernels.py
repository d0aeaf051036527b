"""The standalone d=5 bilateral filter, K5 (counterpart of
``backscrub_tpu/ops/pallas_kernels.py:bilateral5_pallas``).

:func:`bilateral5` takes (..., H, W, 3) f32 holding u8-range values and
returns the unrounded filtered image of the same shape; leading dims
flatten to frames, each with its own reflect-101 border, as in the TPU
wrapper.  On CPU tensors it runs the plain version
(``pipeline/image.py:bilateral5``); on CUDA tensors it launches
``csrc/bilateral.cu``, counting launches in ``bilateral5.launches``.
The kernel runs the same device code as K1's bilateral
(``csrc/bilateral.cuh``); it agrees with the plain version within
allclose(atol=2e-3, rtol=1e-3) (expf and the plain version's exp may
differ in the last bit).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import _build
from ..pipeline.image import _bilateral_taps
from ..pipeline.image import bilateral5 as bilateral5_plain


@functools.lru_cache(maxsize=8)
def _space_weights(sigma_space: float, device: torch.device) -> torch.Tensor:
    """The 13 space weights in tap order, f32 on ``device`` (callers only
    read them)."""
    sw = np.array([t[2] for t in _bilateral_taps(5, sigma_space)], np.float32)
    return torch.from_numpy(sw).to(device)


def bilateral5(rgb_f32: torch.Tensor, sigma_color: float = 100.0,
               sigma_space: float = 100.0) -> torch.Tensor:
    """cv::bilateralFilter(d=5) on (..., H, W, 3) f32: the kernel on CUDA
    tensors, the plain version on CPU tensors."""
    if rgb_f32.device.type == "cpu":
        return bilateral5_plain(rgb_f32, sigma_color, sigma_space)
    if rgb_f32.ndim < 3 or rgb_f32.shape[-1] != 3:
        raise ValueError(f"bilateral5: expected (..., H, W, 3), got {tuple(rgb_f32.shape)}")
    h, w = rgb_f32.shape[-3], rgb_f32.shape[-2]
    if h < 3 or w < 3:
        raise ValueError(f"bilateral5: reflect-101 of a 2-px halo needs H, W >= 3, "
                         f"got {h}x{w}")
    x = rgb_f32.reshape((-1, h, w, 3))
    _build.check_cuda(x, "bilateral input", torch.float32)
    out = torch.empty_like(x)
    _build.launch("bs_bilateral", x.data_ptr(),
                  _space_weights(float(sigma_space), x.device).data_ptr(),
                  out.data_ptr(), x.shape[0], h, w, -0.5 / sigma_color ** 2)
    bilateral5.launches += 1
    return out.reshape(rgb_f32.shape)


bilateral5.launches = 0
