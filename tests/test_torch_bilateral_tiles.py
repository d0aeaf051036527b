"""K5's tiling (``csrc/bilateral.cu``) walked on the CPU.

:func:`walk` mirrors the kernel's decomposition in PyTorch: the grid of
TH x TW pixel tiles of each frame (the kernel's 4x32, read from its
source), each tile's staged (TH+4) x (TW+4) window gathered with the
kernel's reflect-101 row and column indices (clamped into the frame, as
the kernel clamps the window past the 2-px halo that no pixel reads),
and the bilateral of the window's TH x TW centre computed from that
window alone.  Every tile at the segm canvas (96x160), the
deeplab canvas (257x257), a batch of 4 deeplab canvases, a ragged 5x7
pair of frames and the smallest frame, 3x3, must reproduce
``pipeline/image.py:bilateral5`` and write every pixel exactly once.  So
a change of the tiling is checked here before the card; the card holds
the kernel to the plain version in tests/test_torch_cuda.py.

Bar: ``torch.equal``.  The walk computes each pixel with the same
operations in the same order as the plain version (``bilateral_planes``
on a window instead of the padded frame), so the bits agree.  The plain
version itself is held to the JAX package's Pallas kernel in interpret
mode at the shapes ``tests/test_torch_classic.py`` does not cover.
"""

import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from backscrub_tpu.ops.pallas_kernels import bilateral5_pallas
from backscrub_tpu_torch.pipeline.image import bilateral5, bilateral_planes

# name -> (N, H, W)
CASES = {
    "segm_96x160": (1, 96, 160),
    "deeplab_257x257": (1, 257, 257),
    "deeplab_4x257x257": (4, 257, 257),
    "ragged_2x5x7": (2, 5, 7),
    "smallest_3x3": (1, 3, 3),
}
SOURCE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "backscrub_tpu_torch", "csrc", "bilateral.cu")


def kernel_tile():
    """(TH, TW) as ``csrc/bilateral.cu`` declares them."""
    m = re.search(r"constexpr int TH = (\d+), TW = (\d+);", open(SOURCE).read())
    assert m, "csrc/bilateral.cu declares no TH, TW"
    return int(m.group(1)), int(m.group(2))


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread while a test runs: with several, a process's
    first ``torch.exp`` can differ from its later calls in the last bit
    on some threads' chunks (seen on an 8-core CPU, in about one process
    in five), so the plain version would disagree with itself."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _image(n, h, w, seed=0):
    """Seeded u8-valued frames with a flat band (a denominator near 13)."""
    x = np.random.default_rng(seed + h * w).integers(0, 256, (n, h, w, 3)).astype(np.float32)
    x[:, : h // 3] = 128.0
    return torch.from_numpy(x)


def reflect101(x, n):
    """The kernel's index map: reflect-101 into [0, n), then clamped."""
    x = torch.where(x < 0, -x, x)
    x = torch.where(x >= n, 2 * n - 2 - x, x)
    return x.clamp(0, n - 1)


def walk(x, tile):
    """K5 on (N, H, W, 3) computed tile by tile from each tile's staged
    window alone; returns (output, NaN where never written; write counts)."""
    th, tw = tile
    n, h, w, _ = x.shape
    out = torch.full_like(x, float("nan"))
    writes = torch.zeros((n, h, w), dtype=torch.int32)
    i0 = torch.arange(0, h, th)
    j0 = torch.arange(0, w, tw)
    # window rows and columns of every tile: (tiles, TH+4) and (tiles, TW+4)
    rows = reflect101(i0[:, None] - 2 + torch.arange(th + 4), h)
    cols = reflect101(j0[:, None] - 2 + torch.arange(tw + 4), w)
    ty, tx = torch.arange(th), torch.arange(tw)
    di = (i0[:, None] + ty)                          # (tiles_y, TH) output rows
    dj = (j0[:, None] + tx)                          # (tiles_x, TW) output columns
    for f in range(n):
        # (tiles_y, TH+4, tiles_x, TW+4, 3) -> (tiles_y, tiles_x, 3, TH+4, TW+4)
        win = x[f][rows][:, :, cols].permute(0, 2, 4, 1, 3)
        got = bilateral_planes(win, th, tw)          # (tiles_y, tiles_x, 3, TH, TW)
        r = di[:, None, :, None].expand(-1, len(j0), th, tw)
        c = dj[None, :, None, :].expand(len(i0), -1, th, tw)
        ok = (r < h) & (c < w)
        vals = got.permute(0, 1, 3, 4, 2)[ok]
        out[f].index_put_((r[ok], c[ok]), vals)
        writes[f].index_put_((r[ok], c[ok]), torch.ones(int(ok.sum()), dtype=torch.int32),
                             accumulate=True)
    return out, writes


@pytest.mark.parametrize("case", list(CASES))
def test_bilateral_tile_walk_matches_plain(case):
    """The kernel's tile, walked at every shape."""
    x = _image(*CASES[case])
    got, writes = walk(x, kernel_tile())
    assert torch.equal(writes, torch.ones_like(writes)), \
        f"{int((writes != 1).sum())} pixels not written exactly once"
    assert torch.equal(got, bilateral5(x))


def test_bilateral_kernel_tile():
    """4x32, one pixel a thread in whole warps: 120 CTAs at segm's 96x160
    and 585 at deeplab's 257x257, each grid one wave on the H100's 132
    SMs at 16 CTAs of 128 threads an SM."""
    th, tw = kernel_tile()
    assert (th, tw) == (4, 32) and th * tw % 32 == 0
    assert -(-96 // th) * -(-160 // tw) == 120
    assert -(-257 // th) * -(-257 // tw) == 585 <= 16 * 132


@pytest.mark.parametrize("case", ["deeplab_4x257x257", "smallest_3x3"])
def test_bilateral_plain_matches_jax_pallas(case):
    """The plain version against the TPU kernel in interpret mode: within
    allclose(atol=2e-3, rtol=1e-3), rounded bytes off by at most 1 (the two
    exp implementations may differ in the last bit)."""
    x = _image(*CASES[case])
    got = bilateral5(x).numpy()
    ref = np.asarray(bilateral5_pallas(jnp.asarray(x.numpy()), interpret=True))
    np.testing.assert_allclose(got, ref, atol=2e-3, rtol=1e-3)
    assert np.abs(np.round(got) - np.round(ref)).max() <= 1
