"""K1's tiling (``csrc/front.cu``) walked on the CPU.

:func:`walk` mirrors the kernel's decomposition in PyTorch: the grid of
TH x TW output tiles, each tile's staged canvas window (padded rows
m0 .. m0 + 2TH + 4 and columns n0 .. n0 + 2TW + 4 with m0 = 2 i0 -
pad_lo_h, zero outside the padded canvas), the bilateral, round and
normalization of the window's (2TH+1) x (2TW+1) centre, zeroed outside
the model input, the tile's convolution read from that window alone, and
the channel groups' slices of Cout.  Every tile of ``FRONT_TILES`` at the
segm front, the deeplab front and a ragged shape whose oh, ow and Cout
divide no tile, one whose groups of Cout = 40 are no multiple of the
kernel's accumulator chunk, and Cout = 64 (the kernel's most) must
reproduce ``front_plain`` and write every (channel, row, column) exactly
once.  So a change of the tiling is checked here before the card; the
card holds the kernel to ``front_plain`` in tests/test_torch_cuda.py.

Bar: allclose(atol=1e-5, rtol=1e-5) — a tile's convolution sums in
another order than the whole plane's."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from backscrub_tpu_torch.ops.common import apply_activation
from backscrub_tpu_torch.pipeline import edge as tedge
from backscrub_tpu_torch.pipeline.image import bilateral_planes

# name -> (H, W, Cout, bilateral, activation)
CASES = {
    "segm_96x160": (96, 160, 16, True, "HARD_SWISH"),
    "deeplab_257x257": (257, 257, 16, True, "NONE"),
    "ragged_37x54": (37, 54, 13, True, "RELU6"),
    "ragged_37x54_no_bilateral": (37, 54, 13, False, "RELU6"),
    "ragged_61x29_cout40": (61, 29, 40, True, "HARD_SWISH"),
    "cout64_33x70": (33, 70, 64, True, "NONE"),
}


def _inputs(H, W, cout, use_bilateral, activation, seed=0):
    """A seeded u8-valued image, reflect-101 padded into the (3, H+4, W+4)
    canvas; seeded weights as K1's parameter block; front_plain's kwargs."""
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (3, H, W)).astype(np.float32)
    canvas = torch.from_numpy(np.pad(img, ((0, 0), (2, 2), (2, 2)), mode="reflect"))
    w = (rng.standard_normal((3, 3, 3, cout)) * 0.2).astype(np.float32)
    b = (rng.standard_normal(cout) * 0.1).astype(np.float32)
    params = torch.from_numpy(tedge.front_params(w, b))
    kw = dict(H=H, W=W, oh=-(-H // 2), ow=-(-W // 2),
              pad_lo_h=tedge._same_pad_lo(H, 3, 2), pad_lo_w=tedge._same_pad_lo(W, 3, 2),
              use_bilateral=use_bilateral, scale=1 / 127.5, offset=-1.0,
              activation=activation)
    return canvas, params, kw


def walk(canvas, params, kw, tile):
    """K1's output computed tile by tile from each tile's staged window
    alone; returns (output, NaN where never written; write counts)."""
    th, tw, groups = tile
    H, W, oh, ow = kw["H"], kw["W"], kw["oh"], kw["ow"]
    cout = (params.numel() - 13) // 28
    nh, nw = 2 * th + 1, 2 * tw + 1          # normalized pixels a tile
    ph, pw = nh + 4, nw + 4                  # staged canvas pixels a tile
    HP, WP = H + 4, W + 4
    wts = params[:27 * cout].reshape(3, 3, 3, cout).permute(3, 2, 0, 1)
    bias = params[27 * cout:28 * cout]
    per = -(-cout // groups)
    out = torch.full((cout, oh, ow), float("nan"))
    writes = torch.zeros((cout, oh, ow), dtype=torch.int32)
    for i0 in range(0, oh, th):
        for j0 in range(0, ow, tw):
            m0, n0 = 2 * i0 - kw["pad_lo_h"], 2 * j0 - kw["pad_lo_w"]
            win = torch.zeros((3, ph, pw))
            r0, r1 = max(m0, 0), min(m0 + ph, HP)
            c0, c1 = max(n0, 0), min(n0 + pw, WP)
            if r0 < r1 and c0 < c1:
                win[:, r0 - m0:r1 - m0, c0 - n0:c1 - n0] = canvas[:, r0:r1, c0:c1]
            if kw["use_bilateral"]:
                v = torch.round(bilateral_planes(win, nh, nw))
            else:
                v = win[:, 2:2 + nh, 2:2 + nw]
            z = v * kw["scale"] + kw["offset"]
            rows, cols = torch.arange(m0, m0 + nh), torch.arange(n0, n0 + nw)
            inside = ((rows >= 0) & (rows < H))[:, None] & ((cols >= 0) & (cols < W))[None, :]
            z = torch.where(inside, z, torch.zeros(()))
            y = apply_activation(F.conv2d(z[None], wts, bias, stride=2)[0], kw["activation"])
            rh, rw = min(th, oh - i0), min(tw, ow - j0)
            for g in range(groups):
                lo, hi = g * per, min(g * per + per, cout)
                if lo >= hi:
                    continue
                out[lo:hi, i0:i0 + rh, j0:j0 + rw] = y[lo:hi, :rh, :rw]
                writes[lo:hi, i0:i0 + rh, j0:j0 + rw] += 1
    return out, writes


@pytest.mark.parametrize("tile", tedge.FRONT_TILES)
@pytest.mark.parametrize("case", list(CASES))
def test_front_tiles_cover_and_match_plain(case, tile):
    canvas, params, kw = _inputs(*CASES[case])
    got, writes = walk(canvas, params, kw, tile)
    assert torch.equal(writes, torch.ones_like(writes)), \
        f"{int((writes != 1).sum())} outputs not written exactly once"
    torch.testing.assert_close(got, tedge.front_plain(canvas, params, **kw),
                               atol=1e-5, rtol=1e-5)


def test_front_tile_choice():
    """On the H100's 132 SMs segm's 48x80 output takes 4x8 tiles in 8
    channel groups (120 CTAs), deeplab's 129x129 4x16 tiles in 4 groups
    (297 CTAs); with 114 SMs the 48x80 output's 120 CTAs pass one an SM and
    it takes 4x16x4.  A warp never straddles two channel groups."""
    assert tedge.front_tile(48, 80, 132) == (4, 8, 8)
    assert tedge.front_tile(129, 129, 132) == (4, 16, 4)
    assert tedge.front_tile(48, 80, 114) == (4, 16, 4)
    assert tedge.front_tile(19, 27, 132) in tedge.FRONT_TILES
    assert all(th * tw % 32 == 0 for th, tw, _ in tedge.FRONT_TILES)
