"""The decompositions of P4 (``se_kernel``) and P3 (``dot_kernel``) of
``backscrub_tpu_torch/csrc/probes.cu`` walked on the CPU.

P4 runs as one thread-block cluster of ``SE_R`` CTAs: :func:`walk_se`
partitions the columns as the launcher does (S = ceil(n / SE_R) rounded
up to 4 columns a CTA), loads each CTA's slice into registers chunk by
chunk (``SE_CHUNK`` 16-byte vectors of a row where n % 4 == 0, else
floats) and sums it, pushes every CTA's partials into every CTA's
``part[rank][row]``, adds them in rank order, gates and multiplies.  Every
column must be loaded exactly once for the sums (and once more, for the
multiply, only past a slice's first chunk), every output written once, every partial
pushed once into every CTA, and the result within 1e-5 of ``se_plain`` at
(16, 3840), (5, 333), (1, 1), (32, 7) and the chunked (32, 100000), and of
the JAX ``k_se`` in interpret mode on the original's inputs.

P3's DEFAULT and HIGH run ``wgmma.m64n16k16`` on one 64-column tile a
warpgroup: :func:`walk_dot` mirrors the staging of x into ``xs``, each
thread's A fragment (the ``m64nNk16`` register map: warp w rows 16w..,
``mma.sync m16n8k16``'s map inside a warp), B = W's bf16 split at the
kernel's ``b_offset`` read back through the matrix descriptor as the
hardware addresses a no-swizzle K-major operand, the D fragment through
``ys`` and the row stores.  At n = 3840, 64, 65, 37 and 1 every A and B
element must be read from the address the kernel writes it to, every
(channel, column) of y written once, the reads and writes of a warp free
of bank conflicts, and the product within 1e-5 of ``dot_plain`` at
"default" and "high" (HIGHEST's FFMA threads too), and of the JAX
``mk_dot`` kernels in interpret mode at their bars.  Constants are read
from the source; the card holds the kernels to the plain twins in
tests/test_torch_cuda.py.
"""

import pathlib
import re

import numpy as np
import pytest
import torch

from backscrub_tpu_torch.ops import probe_kernels as pk
from test_torch_probes import jax_probe_runs

SOURCE = (pathlib.Path(__file__).resolve().parent.parent / "backscrub_tpu_torch" / "csrc"
          / "probes.cu").read_text()


def _consts(*names):
    """The source's ``constexpr int`` values of ``names``, each a number or
    a sum of an earlier name and a number."""
    got = {}
    for name in names:
        expr = re.search(rf"constexpr int (?:\w+ = [^;,]+, )*{name} = ([^;,]+)[;,]",
                         SOURCE).group(1)
        got[name] = int(eval(expr, {}, dict(got)))     # "64", "DOT_TILE + 4"
    return [got[name] for name in names]


SE_R, SE_NT, SE_H = _consts("SE_R", "SE_NT", "SE_H")
SE_CHUNK = 32 * SE_H
DOT_NT, DOT_TILE, XS, B_LBO, B_SBO = _consts("DOT_NT", "DOT_TILE", "XS", "B_LBO", "B_SBO")
SMS = 132                        # an H100 SXM's SMs: the dot grid's cap
F32 = np.float32


def _rand(shape, seed, shift=0.0):
    return np.random.default_rng(seed).random(shape, F32) - F32(shift)


def _sigmoid(z):
    return F32(1) / (F32(1) + np.exp(-z, dtype=F32))


# -- P4 ---------------------------------------------------------------------

def se_partition(n):
    """(S, elements a chunk in columns): columns a CTA (a multiple of 4,
    so 16-byte vectors stay aligned) as bs_probe_se computes them, and a
    chunk's columns (SE_CHUNK vectors where n % 4 == 0, else floats)."""
    s = -(-(-(-n // SE_R)) // 4) * 4
    return s, SE_CHUNK * (4 if n % 4 == 0 else 1)


def walk_se(x, w):
    """P4 CTA by CTA; returns (out, loaded, reread, writes, pushes): the
    output and the count of each element's load for the sums, second load
    for the multiply (past a slice's first chunk, which stays in registers)
    and write, and of each (destination CTA, source CTA, row) push."""
    c, n = x.shape
    s, chunk = se_partition(n)
    loaded, reread, writes = (np.zeros((c, n), np.int64) for _ in range(3))
    part = np.zeros((SE_R, SE_R, c), F32)          # part[d][j][r] in CTA d's memory
    pushes = np.zeros((SE_R, SE_R, c), np.int64)
    slices = []
    for rank in range(SE_R):
        col0 = rank * s
        cols = max(0, min(s, n - col0))
        nch = -(-cols // chunk)
        mine = np.zeros(c, F32)
        for ch in range(nch):
            c0 = col0 + ch * chunk
            m = min(chunk, col0 + cols - c0)
            assert n % 4 or m % 4 == 0                 # whole 16-byte vectors
            loaded[:, c0:c0 + m] += 1
            mine += x[:, c0:c0 + m].sum(1, dtype=F32)
        slices.append((col0, cols, nch))
        for d in range(SE_R):                      # every lane's push, every row
            part[d, rank] = mine
            pushes[d, rank] += 1
    out = np.full((c, n), np.nan, F32)
    for rank, (col0, cols, nch) in enumerate(slices):
        total = np.zeros(c, F32)
        for j in range(SE_R):                      # rank order, in this CTA's memory
            total += part[rank, j]
        mean = total / F32(n)
        z = np.zeros(c, F32)
        for k in range(c):
            z = z + w[:, k] * mean[k]
        gate = _sigmoid(z)
        for ch in range(nch):
            c0 = col0 + ch * chunk
            m = min(chunk, col0 + cols - c0)
            if ch > 0:                             # the first chunk stays in registers
                reread[:, c0:c0 + m] += 1
            out[:, c0:c0 + m] = x[:, c0:c0 + m] * gate[:, None]
            writes[:, c0:c0 + m] += 1
    return out, loaded, reread, writes, pushes


SE_SHAPES = [(16, 3840), (5, 333), (1, 1), (32, 7), (32, 100000)]


@pytest.mark.parametrize("shape", SE_SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_se_cluster_walk(shape):
    c, n = shape
    x, w = _rand(shape, c + n), _rand((c, c), c, 0.5)
    out, loaded, reread, writes, pushes = walk_se(x, w)
    s, chunk = se_partition(n)
    assert (loaded == 1).all() and (writes == 1).all() and (pushes == 1).all()
    first = (np.arange(n) % s) < chunk             # each slice's first chunk
    assert (reread == np.where(first, 0, 1)[None, :]).all()
    assert (s > chunk) == (shape == (32, 100000))
    want = pk.se_plain(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    assert np.abs(out - want).max() <= 1e-5


def test_se_constants():
    """R is a cluster size the card takes (8 or 16) and divides a warp (a
    push round sends 32 / R rows); the warps of a CTA, at most 4 rows each,
    hold c <= 32; the probe's slice (240 columns) is one chunk, so x is read
    once."""
    assert SE_R in (8, 16) and 32 % SE_R == 0
    assert 4 * SE_NT // 32 >= 32
    assert se_partition(3840)[0] <= se_partition(3840)[1]


# -- P3 ---------------------------------------------------------------------

def b_offset(o, k):
    """The kernel's byte offset of W[o][k] (bf16) in shared memory."""
    return (o >> 3) * B_SBO + (k >> 3) * B_LBO + (o & 7) * 16 + (k & 7) * 2


def smem_desc(addr):
    """The kernel's matrix descriptor of a no-swizzle tile at ``addr``."""
    return ((addr & 0x3FFFF) >> 4) | ((B_LBO >> 4) << 16) | ((B_SBO >> 4) << 32)


def desc_address(desc, row, k):
    """Where wgmma reads element (row, k) of a K-major bf16 operand with
    no swizzle: 8x8 core matrices of 8 rows at 16 bytes, the K-neighbour
    core matrix at the leading byte offset, the next 8 rows at the stride
    byte offset (PTX's canonical layout ((8, m), (8, 2)) : ((16 B, SBO),
    (2 B, LBO)))."""
    assert desc >> 62 == 0 and (desc >> 49) & 7 == 0      # no swizzle, base offset 0
    start, lbo, sbo = ((desc & 0x3FFF) << 4, ((desc >> 16) & 0x3FFF) << 4,
                       ((desc >> 32) & 0x3FFF) << 4)
    return start + (row // 8) * sbo + (k // 8) * lbo + (row % 8) * 16 + (k % 8) * 2


def _bf16_split(v):
    t = torch.from_numpy(np.array(v, F32))
    hi = t.to(torch.bfloat16).float()
    return hi.numpy(), (t - hi).to(torch.bfloat16).float().numpy()


def _banks_free(addrs):
    """32 word addresses of one warp's access hit 32 different banks, or
    the same word (a broadcast)."""
    a = np.asarray(addrs)
    return all(len({int(b) for b in a[a % 32 == bank]}) <= 1 for bank in range(32))


def walk_dot(w, x, mode, sms=SMS):
    """P3 CTA by CTA, tile by tile; returns (y, writes)."""
    n = x.shape[1]
    tiles = -(-n // DOT_TILE)
    grid = min(tiles, sms)
    y = np.full((16, n), np.nan, F32)
    writes = np.zeros((16, n), np.int64)
    tid = np.arange(DOT_NT)
    warp, lane = tid >> 5, tid & 31
    g, t = lane >> 2, lane & 3
    # B: each thread splits W[o][k], W[o][k + 1] into the bf16 buffers
    o_w, k_w = tid >> 3, (tid & 7) * 2
    bw = {0: np.full(256, np.nan, F32), 1: np.full(256, np.nan, F32)}
    whi, wlo = _bf16_split(w)
    for kk in (0, 1):
        at = b_offset(o_w, k_w + kk) // 2
        bw[0][at], bw[1][at] = whi[o_w, k_w + kk], wlo[o_w, k_w + kk]
    assert not np.isnan(bw[0]).any()
    base = 0x1000                                  # any 128-byte aligned address
    b_read = np.array([[desc_address(smem_desc(base), o, k) - base for o in range(16)]
                       for k in range(16)]) // 2    # [k][o]: B = W^T
    bhi, blo = bw[0][b_read], bw[1][b_read]
    assert np.array_equal(bhi, whi.T) and np.array_equal(blo, wlo.T)
    seen = set()
    for cta in range(grid):
        for tile in range(cta, tiles, grid):
            seen.add(tile)
            c0 = tile * DOT_TILE
            xs = np.full(16 * XS, np.nan, F32)
            for r in range(16):                    # staged, zero past n
                cols = c0 + np.arange(DOT_TILE)
                xs[r * XS: r * XS + DOT_TILE] = np.where(
                    cols < n, x[r, np.minimum(cols, n - 1)], 0)
            ys = np.full(16 * XS, np.nan, F32)
            if mode == 2:
                q, r0 = (tid & 15) * 4, (tid >> 4) * 2
                for rr in range(2):
                    acc = np.zeros((DOT_NT, 4), F32)
                    for k in range(16):
                        xv = np.stack([xs[k * XS + q + v] for v in range(4)], 1)
                        acc = acc + w[r0 + rr, k][:, None] * xv
                    for v in range(4):
                        ys[(r0 + rr) * XS + q + v] = acc[:, v]
            else:
                m0 = warp * 16 + g
                a_read = np.zeros((64, 16), np.int64)
                a = np.full((64, 16), np.nan, F32)
                for qq in range(4):                # A fragment registers
                    m, k = m0 + (qq & 1) * 8, 2 * t + (qq >> 1) * 8
                    for kk in (0, 1):
                        at = (k + kk) * XS + m
                        for wq in range(4):
                            assert _banks_free(at[warp == wq])
                        a[m, k + kk] = xs[at]
                        np.add.at(a_read, (m, k + kk), 1)
                assert (a_read == 1).all()
                ahi, alo = _bf16_split(a)
                d = (ahi.astype(np.float64) @ bhi.astype(np.float64)).astype(F32)
                if mode == 1:
                    d = d + ((alo.astype(np.float64) @ bhi + ahi.astype(np.float64) @ blo)
                             .astype(F32))
                d_written = np.zeros((64, 16), np.int64)
                for i in range(8):                 # D fragment registers
                    m = m0 + ((i >> 1) & 1) * 8
                    o = (i >> 2) * 8 + 2 * t + (i & 1)
                    at = o * XS + m
                    for wq in range(4):
                        assert _banks_free(at[warp == wq])
                    ys[at] = d[m, o]
                    np.add.at(d_written, (m, o), 1)
                assert (d_written == 1).all()
            for r in range(16):                    # the row stores
                cols = c0 + np.arange(DOT_TILE)
                keep = cols < n
                y[r, cols[keep]] = ys[r * XS: r * XS + DOT_TILE][keep]
                writes[r, cols[keep]] += 1
    assert seen == set(range(tiles))
    return y, writes


@pytest.mark.parametrize("n", [3840, 64, 65, 37, 1])
@pytest.mark.parametrize("prec", pk.PRECISIONS)
def test_dot_wgmma_walk(n, prec):
    w, x = _rand((16, 16), 7), _rand((16, n), n)
    y, writes = walk_dot(w, x, pk.PRECISIONS.index(prec))
    assert (writes == 1).all()
    want = pk.dot_plain(torch.from_numpy(w), torch.from_numpy(x), prec).numpy()
    assert np.abs(y - want).max() <= 1e-5


def test_dot_walk_with_fewer_sms():
    """Several tiles a CTA (a grid capped below the tile count)."""
    w, x = _rand((16, 16), 8), _rand((16, 4 * 3840 + 5), 9)
    y, writes = walk_dot(w, x, 1, sms=7)
    assert (writes == 1).all()
    want = pk.dot_plain(torch.from_numpy(w), torch.from_numpy(x), "high").numpy()
    assert np.abs(y - want).max() <= 1e-5


def test_b_layout_is_the_descriptor_layout():
    """The kernel's B writes fill its 512 bytes a buffer exactly once, on
    4-byte words (a pair (k, k + 1) a thread), and the descriptor reads
    each element back from where it was written."""
    offs = sorted(b_offset(o, k) for o in range(16) for k in range(16))
    assert offs == list(range(0, 512, 2))
    assert all(b_offset(o, k) % 4 == 0 for o in range(16) for k in range(0, 16, 2))
    for base in (0, 0x80, 0xC400):
        for o in range(16):
            for k in range(16):
                assert desc_address(smem_desc(base), o, k) == base + b_offset(o, k)


# -- against the JAX kernels on the original's inputs ----------------------

@pytest.fixture(scope="module")
def jax_se_dot():
    return jax_probe_runs({"se_pool_fc_gate", "dot_default", "dot_highest"})


def test_walks_match_jax_kernels(jax_se_dot):
    """The walks on the original's inputs against the JAX k_se and mk_dot
    in interpret mode: k_se and HIGHEST within 1e-5, DEFAULT within the
    original's 5e-2 (JAX runs it in f32 on the CPU)."""
    got, (x, w), ref, atol = jax_se_dot["se_pool_fc_gate"]
    out = walk_se(x, w)[0]
    assert np.abs(out - got).max() <= 1e-5
    np.testing.assert_allclose(out, ref, atol=atol, rtol=1e-4)
    for name, mode, tol in (("dot_default", 0, 5e-2), ("dot_highest", 2, 1e-5)):
        got, (x, w), ref, atol = jax_se_dot[name]
        y = walk_dot(w, x, mode)[0]
        assert np.abs(y - got).max() <= tol, name
        np.testing.assert_allclose(y, ref, atol=atol, rtol=1e-4)
