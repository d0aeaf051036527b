"""K4's decomposition (``csrc/blend_pack.cu``, ``blend_pack_420_kernel``)
walked on the CPU.

:func:`walk` mirrors the kernel's threads in numpy: with W % 4 == 0 and
the four pointers on 4-byte boundaries, the vector threads, each ``COLS``
pixels of one row in row-major order, reading three frame, three
background and one mask word and writing one Y word, and on an even row
also the chroma of the two 2x2 blocks whose top-left pixels it holds, as
one [U, V, U, V] word (NV12) or one 2-byte U and one 2-byte V store
(I420); every other call, W % 4 == 2 or a frame off a word boundary
(``aligned=False``), the per-block threads, one 2x2 block each in single
bytes.  Every layout at (480, 640), (720, 1280),
(42, 58) (W % 4 == 2), (2, 2) and (6, 12), and the per-block path alone
where a view off a word boundary sends a word-aligned width, must be
byte-identical to ``blend_pack_420_plain`` and write every output byte
exactly once.  The card holds the kernel to the plain version in
tests/test_torch_cuda.py.  The plain version itself is held to the JAX
package's Pallas kernel in interpret mode at the shapes
``tests/test_torch_formats.py`` does not cover.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from backscrub_tpu.ops.pallas_kernels import blend_pack_420 as jax_pack_420
from backscrub_tpu_torch.ops.pack_kernels import blend_pack_420_plain

COLS = 4   # pixels a vector thread, of one row
SHAPES = [(480, 640), (720, 1280), (42, 58), (2, 2), (6, 12)]
# BT.601 video-range encode at 20-bit fixed point, as in the kernel
CRY, CGY, CBY = 269484, 528482, 102760
CRU, CGU, CBU = -155188, -305135, 460324
CGV, CBV = -385875, -74448
SHIFT, HALF = 20, 1 << 19


def _inputs(h, w, seed):
    """Seeded frame, background and mask (a quarter of rows 255, a quarter
    0, the rest random), as the card test makes them."""
    rng = np.random.default_rng(seed)
    fr, bg = (rng.integers(0, 256, (h, w, 3), np.uint8) for _ in range(2))
    m = rng.integers(0, 256, (h, w), np.uint8)
    m[: h // 4], m[h // 4: h // 2] = 255, 0
    return fr, bg, m


def blend(b, f, m):
    n = b * m + f * (255 - m)
    return (n + 1 + (n >> 8)) >> 8


def luma(r, g, b):
    return np.clip((r * CRY + g * CGY + b * CBY + HALF + (16 << SHIFT)) >> SHIFT, 0, 255)


def chroma(r, g, b):
    u = np.clip((r * CRU + g * CGU + b * CBU + HALF + (128 << SHIFT)) >> SHIFT, 0, 255)
    v = np.clip((r * CBU + g * CGV + b * CBV + HALF + (128 << SHIFT)) >> SHIFT, 0, 255)
    return u, v


def _byte(words, k):
    return (words >> (8 * k)) & 0xFF


def walk(fr, bg, m, layout, aligned=True):
    """K4's output bytes computed thread by thread; returns (bytes, write
    counts), both flat 3HW/2."""
    h, w = m.shape
    hw, nbytes = w // 2, 3 * h * w // 2
    out = np.zeros(nbytes, np.int64)
    writes = np.zeros(nbytes, np.int64)
    i420 = layout == "i420"
    q = (h // 2) * hw                                # I420's U plane size

    def store(at, values, width):
        """``width``-byte little-endian stores of ``values`` at byte ``at``."""
        for k in range(width):
            out[at + k] = _byte(values, k)
            np.add.at(writes, at + k, 1)

    vec = aligned and w % COLS == 0
    nvec = h * (w // COLS) if vec else 0
    nblk = 0 if vec else (h // 2) * hw
    if nvec:
        t = np.arange(nvec)
        row, col = t // (w // COLS), t % (w // COLS) * COLS
        px = row * w + col
        fw, gw, mw = (a.reshape(-1).view("<u4").astype(np.int64) for a in (fr, bg, m))
        f, g = (np.stack([a[3 * px // 4 + k] for k in range(3)], -1) for a in (fw, gw))
        mm = mw[px // 4][:, None]

        def byte(words, j):
            return _byte(words[:, j // 4], j % 4)

        y = u = v = np.zeros(nvec, np.int64)
        for k in range(COLS):
            b, gg, r = (blend(byte(g, 3 * k + c), byte(f, 3 * k + c), byte(mm, k))
                        for c in range(3))
            y = y | luma(r, gg, b) << (8 * k)
            if k % 2 == 0:
                cu, cv = chroma(r, gg, b)
                u, v = u | cu << (4 * k), v | cv << (4 * k)
        store(px, y, 4)
        even = row % 2 == 0          # these threads also write their blocks' chroma
        bi, col, u, v = row[even] // 2, col[even], u[even], v[even]
        if i420:
            at = h * w + bi * hw + col // 2
            store(at, u, 2)
            store(at + q, v, 2)
        else:
            store(h * w + bi * w + col,
                  (u & 0xFF) | (v & 0xFF) << 8 | (u >> 8) << 16 | (v >> 8) << 24, 4)
    # the per-block threads: one 2x2 block each, in single bytes
    blk = np.arange(nblk)
    bi, bj = blk // hw, blk % hw
    frv, bgv, mv = (a.reshape(-1).astype(np.int64) for a in (fr, bg, m))
    for di in range(2):
        for dj in range(2):
            px = (2 * bi + di) * w + 2 * bj + dj
            b, g, r = (blend(bgv[3 * px + c], frv[3 * px + c], mv[px]) for c in range(3))
            store(px, luma(r, g, b), 1)
            if di == 0 and dj == 0:
                u, v = chroma(r, g, b)
    if nblk:
        if i420:
            store(h * w + bi * hw + bj, u, 1)
            store(h * w + q + bi * hw + bj, v, 1)
        else:
            store(h * w + bi * w + 2 * bj, u, 1)
            store(h * w + bi * w + 2 * bj + 1, v, 1)
    return out, writes


def _check(h, w, layout, aligned):
    fr, bg, m = _inputs(h, w, seed=h + w)
    got, writes = walk(fr, bg, m, layout, aligned)
    assert (writes == 1).all(), f"{int((writes != 1).sum())} bytes not written exactly once"
    want = blend_pack_420_plain(*(torch.from_numpy(a) for a in (fr, bg, m)), layout)
    assert np.array_equal(got.astype(np.uint8), want.reshape(-1).numpy())


@pytest.mark.parametrize("layout", ["nv12", "i420"])
@pytest.mark.parametrize("h,w", SHAPES)
def test_pack420_walk_matches_plain(h, w, layout):
    _check(h, w, layout, aligned=True)


@pytest.mark.parametrize("layout", ["nv12", "i420"])
@pytest.mark.parametrize("h,w", [(6, 12), (480, 640)])
def test_pack420_walk_off_a_word_boundary(h, w, layout):
    """A frame that is a view off a 4-byte boundary: every block on the
    per-block path, whatever the width."""
    _check(h, w, layout, aligned=False)


@pytest.mark.parametrize("layout", ["nv12", "i420"])
@pytest.mark.parametrize("h,w", [(720, 1280), (2, 2), (6, 12)])
def test_pack420_plain_matches_jax(h, w, layout):
    """The plain version against the TPU kernel in interpret mode:
    byte-identical (integer math)."""
    fr, bg, m = _inputs(h, w, seed=h * w)
    got = blend_pack_420_plain(*(torch.from_numpy(a) for a in (fr, bg, m)), layout).numpy()
    y, uv = (np.asarray(a) for a in jax_pack_420(jnp.asarray(fr), jnp.asarray(bg),
                                                  jnp.asarray(m), interpret=True))
    if layout == "nv12":
        want = np.concatenate([y, uv], axis=0)
    else:
        want = np.concatenate([y.reshape(-1), uv[:, 0::2].reshape(-1),
                               uv[:, 1::2].reshape(-1)])
    assert got.shape == want.shape and np.array_equal(got, want)
