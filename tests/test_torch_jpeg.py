"""The port's MJPG path on the CPU: the host entropy codec it builds
(``io/jpeg.py``, ``native/bsjpeg.cc`` built into ``_build/``), the plain
decode that is ``bs_jpeg_decode``'s twin (``pipeline/jpeg.py``), the
encoder (``pipeline/jpeg_enc.py``), the kernel's decomposition walked in
numpy, the MJPG sources and sink, and the committed MJPG fixtures.

Bars: byte-identical to the JAX package (``backscrub_tpu/pipeline/
jpeg.py``, ``jpeg_enc.py``) and to OpenCV (``cv2.imdecode``,
``cv2.imencode`` with optimize off) — the decode and encode are integer
math throughout (``tests/test_jpeg.py``, ``tests/test_jpeg_enc.py``).
The JAX package's entropy codec loads the library the port builds
(``BSJPEG_LIB``), so no CMake build is needed here.
"""

import hashlib
import json
import os
import pathlib
import re
import sys

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")
jnp = pytest.importorskip("jax.numpy")

from backscrub_tpu_torch import _build
from backscrub_tpu_torch.io import jpeg as tjpeg
from backscrub_tpu_torch.io import streams
from backscrub_tpu_torch.io.jpeg import (JpegEntropyDecoder, JpegHuffmanEncoder,
                                         JpegUnsupported, make_info, parse_header)
from backscrub_tpu_torch.ops import jpeg_kernels
from backscrub_tpu_torch.pipeline import jpeg as tdec
from backscrub_tpu_torch.pipeline import jpeg_enc as tenc

ROOT = pathlib.Path(__file__).resolve().parent.parent
DATA = ROOT / "tests" / "data"
SAMPLINGS = {"420": ((2, 2), (1, 1), (1, 1)), "422": ((2, 1), (1, 1), (1, 1)),
             "444": ((1, 1), (1, 1), (1, 1)), "440": ((1, 2), (1, 1), (1, 1)),
             "411": ((4, 1), (1, 1), (1, 1))}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_jpeg():
    """The JAX package's jpeg modules, their entropy codec the port's build."""
    os.environ.setdefault("BSJPEG_LIB", _build.host_library("bsjpeg"))
    from backscrub_tpu.io import jpeg as jio
    from backscrub_tpu.pipeline import jpeg as jdec
    from backscrub_tpu.pipeline import jpeg_enc as jenc
    jio.load_bsjpeg()
    return jio, jdec, jenc


def _smooth(h, w, seed=0):
    img = np.random.default_rng(seed).integers(0, 256, (h, w, 3), np.uint8)
    return cv2.GaussianBlur(img, (7, 7), 0)


def _cv2_jpeg(img, quality, sampling=None, **extra):
    params = [cv2.IMWRITE_JPEG_QUALITY, quality]
    if sampling is not None:
        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                   getattr(cv2, f"IMWRITE_JPEG_SAMPLING_FACTOR_{sampling}")]
    for k, v in extra.items():
        params += [getattr(cv2, k), v]
    ok, enc = cv2.imencode(".jpg", img, params)
    assert ok
    return enc.tobytes()


def _decode_both(jpg, jax_jpeg):
    """The port's plain decode and the JAX decode of one JPEG, and cv2's."""
    _, jdec, _ = jax_jpeg
    dec = JpegEntropyDecoder()
    coefs, qtabs = dec.decode(jpg)
    port = jpeg_kernels.decode_jpeg_bgr([torch.from_numpy(c) for c in coefs],
                                        torch.from_numpy(qtabs.astype(np.int32)), dec.info)
    ref = np.asarray(jdec.decode_jpeg_bgr([jnp.asarray(c) for c in coefs],
                                          jnp.asarray(qtabs), dec.info))
    return port.numpy(), ref, cv2.imdecode(np.frombuffer(jpg, np.uint8), cv2.IMREAD_COLOR)


# ---------------------------------------------------------------------------
# the host codec


def test_host_library_builds_into_the_package():
    path = _build.host_library("bsjpeg")
    assert pathlib.Path(path).parent == pathlib.Path(_build.BUILD_DIR)
    assert re.fullmatch(r"libbsjpeg_[0-9a-f]{16}\.so", os.path.basename(path))
    assert _build.host_library("bsjpeg") == path   # cached by its hash
    assert tjpeg.load_bsjpeg().bsjpeg_version()


def test_host_library_name_follows_the_target(monkeypatch, tmp_path):
    """A library built with -march=native for one CPU never goes by the
    name another CPU would look up: its target macros are in the hash."""
    flags, target = _build._host_flags(_build._cxx())
    assert "#define __x86_64__ 1" in target or "#define __aarch64__ 1" in target
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "_host_flags", lambda cxx: (flags, target))
    here = _build.host_library("bsjpeg")
    monkeypatch.setattr(_build, "_host_flags",
                        lambda cxx: (flags, target + "#define __AVX512FP16__ 1\n"))
    other = _build.host_library("bsjpeg")
    assert here != other and os.path.dirname(other) == str(tmp_path)


def test_host_build_failure_raises(monkeypatch):
    monkeypatch.setattr(_build, "NATIVE_DIR", str(ROOT / "no-such-dir"))
    with pytest.raises(_build.KernelBuildError):
        _build.host_library("bsjpeg")


def test_entropy_decoder_matches_jax(jax_jpeg):
    jio, _, _ = jax_jpeg
    jpg = _cv2_jpeg(_smooth(97, 131, 3), 90, "420", IMWRITE_JPEG_RST_INTERVAL=2)
    ours, theirs = JpegEntropyDecoder(), jio.JpegEntropyDecoder()
    (c1, q1), (c2, q2) = ours.decode(jpg), theirs.decode(jpg)
    assert ours.info == parse_header(jpg) and ours.info.__dict__ == theirs.info.__dict__
    assert all(np.array_equal(a, b) for a, b in zip(c1, c2)) and np.array_equal(q1, q2)
    c3, _ = ours.decode(jpg)
    assert c3[0] is c1[0]   # the buffers are reused


def test_unsupported_and_corrupt_streams_raise():
    with pytest.raises(JpegUnsupported, match="unsupported"):
        parse_header(_cv2_jpeg(_smooth(32, 32), 80, IMWRITE_JPEG_PROGRESSIVE=1))
    jpg = _cv2_jpeg(_smooth(32, 32), 80)
    for bad in (jpg[:20], b"\x00" * 64, b""):
        with pytest.raises(ValueError) as e:
            parse_header(bad)
        assert not isinstance(e.value, JpegUnsupported)
    dec = JpegEntropyDecoder()
    dec.decode(jpg)
    with pytest.raises(ValueError, match="changed geometry"):
        dec.decode(_cv2_jpeg(_smooth(64, 64), 80))


# ---------------------------------------------------------------------------
# the plain decode (bs_jpeg_decode's twin)


@pytest.mark.parametrize("sampling", list(SAMPLINGS))
@pytest.mark.parametrize("quality", [30, 95])
def test_decode_matches_jax_and_opencv(jax_jpeg, sampling, quality):
    img = _smooth(120, 164, quality) if quality < 50 else \
        np.random.default_rng(1).integers(0, 256, (97, 131, 3), np.uint8)
    port, ref, cv = _decode_both(_cv2_jpeg(img, quality, sampling), jax_jpeg)
    assert np.array_equal(port, ref) and np.array_equal(port, cv)


@pytest.mark.parametrize("case", ["gray", "restart", "tiny1", "tiny17x9", "odd"])
def test_decode_special_streams(jax_jpeg, case):
    jpg = {"gray": lambda: _cv2_jpeg(cv2.cvtColor(_smooth(64, 80), cv2.COLOR_BGR2GRAY), 85),
           "restart": lambda: _cv2_jpeg(_smooth(96, 144, 7), 85,
                                        IMWRITE_JPEG_RST_INTERVAL=3),
           "tiny1": lambda: _cv2_jpeg(np.full((1, 1, 3), 77, np.uint8), 60),
           "tiny17x9": lambda: _cv2_jpeg(
               np.random.default_rng(17).integers(0, 256, (17, 9, 3), np.uint8), 60, "422"),
           "odd": lambda: _cv2_jpeg(
               np.random.default_rng(3).integers(0, 256, (47, 63, 3), np.uint8), 90, "440"),
           }[case]()
    port, ref, cv = _decode_both(jpg, jax_jpeg)
    assert np.array_equal(port, ref) and np.array_equal(port, cv)


def test_decode_wraps_int32_like_jax(jax_jpeg):
    """Coefficients no valid stream holds overflow the IDCT's int32: the
    port wraps as the JAX package does (C's behaviour)."""
    _, jdec, _ = jax_jpeg
    info = make_info(16, 16, SAMPLINGS["444"])
    rng = np.random.default_rng(0)
    coefs = [rng.integers(-32768, 32768, (bh, bw, 64)).astype(np.int16) for bh, bw in info.blocks]
    q = rng.integers(1, 65536, (3, 64)).astype(np.int32)
    port = tdec.decode_jpeg_bgr([torch.from_numpy(c) for c in coefs], torch.from_numpy(q), info)
    ref = jdec.decode_jpeg_bgr([jnp.asarray(c) for c in coefs], jnp.asarray(q), info)
    assert np.array_equal(port.numpy(), np.asarray(ref))


def _kernel_constants():
    src = (ROOT / "backscrub_tpu_torch" / "csrc" / "jpeg.cu").read_text()
    k = {n: int(re.search(rf"constexpr int {n} = (\d+);", src).group(1))
         for n in ("NT", "TILE_H", "TILE_W", "SEG")}
    rows = max(k["TILE_H"] // 8, k["TILE_H"] // 16 + 2)
    cols = max(k["TILE_W"] // 8, k["TILE_W"] // 16 + 2, 6)
    return dict(k, WROWS=rows, WCOLS=cols, MAXB=3 * rows * cols)


def _walk(coefs, q, info, out_offset=0, decode=True):
    """``csrc/jpeg.cu``'s decomposition in numpy: a CTA a tile of TILE_H x
    TILE_W pixels at most (TILE_H / 8 / vmax MCUs down, TILE_W / 8 / hmax
    across); each CTA decodes the blocks of each component's window (its
    own blocks and, where the fancy upsampling reads across an edge, the
    block beyond it, clipped to the grid: a halo block recomputed in every
    CTA that reads it, from the same coefficients) into a window of its own
    (unset samples -1), then writes its pixels SEG a thread, reading
    samples from its windows alone, with the kernel's per-method neighbour
    rule (a pixel past the width computed at the last column, its parity
    its index's, and not written); the threads of a 16-pixel chunk store
    it as three 16-byte words where the chunk lies inside the image and
    starts on 16 bytes of an output at ``out_offset`` bytes past a 256-byte
    boundary, else pixel by pixel.
    Every output byte is written once; returns the image and the counts of
    the CTAs, the blocks decoded, the vector and the per-pixel segments
    (with ``decode`` False the counts alone, the image None)."""
    k = _kernel_constants()
    hmax = max(s[0] for s in info.sampling)
    vmax = max(s[1] for s in info.sampling)
    my, mx = k["TILE_H"] // 8 // vmax, max(1, k["TILE_W"] // 8 // hmax)
    mx += mx * hmax % 2
    th, tw = my * vmax * 8, mx * hmax * 8
    assert th <= k["TILE_H"] and tw % 16 == 0
    ch = [-(-info.height * v // vmax) for _, v in info.sampling]
    cw = [-(-info.width * h // hmax) for h, _ in info.sampling]
    methods = [tdec.upsample_method(h, v, hmax, vmax) for h, v in info.sampling]
    out = np.full((info.height, info.width, 3), -1, np.int64)
    counts = dict(ctas=0, blocks=0, vector=0, pixel=0)
    seg = k["SEG"]
    for ty in range(-(-info.height // th)):
        for tx in range(-(-info.width // tw)):
            counts["ctas"] += 1
            wins, nb = [], 0
            for c in range(info.ncomp):
                h, v = info.sampling[c]
                bh, bw = info.blocks[c]
                hy = int(methods[c] in ("h2v2", "h1v2"))
                hx = int(methods[c] in ("h2v2", "h2v1"))
                by, bx = ty * my * v, tx * mx * h
                r0, c0 = max(by - hy, 0), max(bx - hx, 0)
                r1, c1 = min(by + my * v + hy, bh), min(bx + mx * h + hx, bw)
                win = np.full(((r1 - r0) * 8, (c1 - c0) * 8), -1, np.int64)
                assert r1 - r0 <= k["WROWS"] and c1 - c0 <= k["WCOLS"]
                nb += (r1 - r0) * (c1 - c0)
                for yb in range(r0 if decode else r1, r1):
                    for xb in range(c0, c1):
                        blk = tdec.idct_islow(torch.from_numpy(
                            coefs[c][yb, xb].astype(np.int32) * q[c]).reshape(8, 8)).numpy()
                        win[(yb - r0) * 8:(yb - r0) * 8 + 8, (xb - c0) * 8:(xb - c0) * 8 + 8] = blk
                wins.append((win, r0 * 8, c0 * 8))
            assert nb <= k["MAXB"]
            counts["blocks"] += nb

            def at(c, i, j):
                win, oy, ox = wins[c]
                assert 0 <= i - oy < win.shape[0] and 0 <= j - ox < win.shape[1]
                val = int(win[i - oy, j - ox])
                assert val >= 0
                return val

            def sample(c, y, x, odd):
                h, v = info.sampling[c]
                method = methods[c]
                if method == "full":
                    return at(c, y, x)
                if method == "h2v1":
                    j = x >> 1
                    return ((3 * at(c, y, j) + at(c, y, min(j + 1, cw[c] - 1)) + 2) >> 2 if odd
                            else (3 * at(c, y, j) + at(c, y, max(j - 1, 0)) + 1) >> 2)
                i = y >> 1
                io = min(i + 1, ch[c] - 1) if y & 1 else max(i - 1, 0)
                if method == "h2v2":
                    j = x >> 1
                    jn = min(j + 1, cw[c] - 1) if odd else max(j - 1, 0)
                    c0_, cn = 3 * at(c, i, j) + at(c, io, j), 3 * at(c, i, jn) + at(c, io, jn)
                    return (3 * c0_ + cn + (7 if odd else 8)) >> 4
                if method == "h1v2":
                    return (3 * at(c, i, x) + at(c, io, x) + (2 if y & 1 else 1)) >> 2
                return at(c, y // (vmax // v), x // (hmax // h))

            y0, x0 = ty * th, tx * tw
            rows = min(th, info.height - y0)
            segs = 16 // seg * -(-min(tw, info.width - x0) // 16)
            assert rows * segs <= k["NT"]
            for sidx in range(rows * segs):
                y, xs = y0 + sidx // segs, x0 + (sidx % segs) * seg
                x16 = xs - xs % 16
                vector = (x16 + 16 <= info.width
                          and (out_offset + (y * info.width + x16) * 3) % 16 == 0)
                counts["vector" if vector else "pixel"] += 1
                if not decode:
                    continue
                px = []
                for kk in range(seg):
                    x = min(xs + kk, info.width - 1)
                    yy = sample(0, y, x, kk & 1)
                    if info.ncomp == 1:
                        px.append((yy, yy, yy))
                        continue
                    cbm, crm = sample(1, y, x, kk & 1) - 128, sample(2, y, x, kk & 1) - 128
                    px.append(tuple(np.clip([yy + ((116130 * cbm + 32768) >> 16),
                                             yy + ((-22554 * cbm + 32768 - 46802 * crm) >> 16),
                                             yy + ((91881 * crm + 32768) >> 16)], 0, 255)))
                for kk in range(seg):
                    if xs + kk < info.width:
                        assert (out[y, xs + kk] == -1).all()
                        out[y, xs + kk] = px[kk]
    if not decode:
        return None, counts
    assert (out >= 0).all()
    return out.astype(np.uint8), counts


_WALK_CASES = {"420": (SAMPLINGS["420"], 37, 21), "422": (SAMPLINGS["422"], 37, 21),
               "444": (SAMPLINGS["444"], 37, 21), "440": (SAMPLINGS["440"], 37, 21),
               "411": (SAMPLINGS["411"], 37, 21), "gray": (((1, 1),), 37, 21),
               "420 odd": (SAMPLINGS["420"], 131, 67), "420 two tiles": (SAMPLINGS["420"], 96, 48),
               "422 odd": (SAMPLINGS["422"], 67, 41), "444 odd": (SAMPLINGS["444"], 81, 35),
               "gray odd": (((1, 1),), 75, 33), "mixed": (((2, 1), (1, 2), (1, 1)), 45, 29),
               "141": (((1, 4), (1, 1), (1, 1)), 37, 45),
               "311": (((3, 1), (1, 1), (1, 1)), 101, 19)}


@pytest.mark.parametrize("case", list(_WALK_CASES))
def test_kernel_walk_matches_plain(case):
    """The kernel's decomposition, walked at ragged sizes (partial MCUs,
    tiles and segments, one tile and several down and across), byte for
    byte the plain decode at every sampling, gray and a replicated ratio;
    each byte written once, and a halo block decoded by each tile that
    reads it."""
    sf, w, h = _WALK_CASES[case]
    info = make_info(w, h, sf, ncomp=len(sf))
    rng = np.random.default_rng(w * h)
    coefs = [rng.integers(-40, 41, (bh, bw, 64)).astype(np.int16) for bh, bw in info.blocks]
    q = rng.integers(1, 50, (info.ncomp, 64)).astype(np.int32)
    want = tdec.decode_jpeg_bgr([torch.from_numpy(c) for c in coefs], torch.from_numpy(q), info)
    got, counts = _walk(coefs, q, info)
    assert np.array_equal(got, want.numpy())
    own = sum(bh * bw for bh, bw in info.blocks)
    fancy = any(tdec.upsample_method(*s, max(t[0] for t in sf), max(t[1] for t in sf))
                not in ("full", "int") for s in sf)
    assert counts["blocks"] >= own if fancy else counts["blocks"] == own
    assert counts["pixel"] > 0 if w % 16 else counts["pixel"] == 0


def test_kernel_walk_at_the_main_path_sizes():
    """At 640x480 and 1280x720 4:2:0 (the MJPG camera's frames) the walk
    takes a CTA a TILE_H x TILE_W tile, each of at most its luma blocks and
    each chroma's with its halo, more than the frame's own blocks; every
    segment by 16-byte stores; an output 8 bytes off 16 takes them all
    pixel by pixel, and an odd size both paths, each byte once and the
    plain decode's."""
    k = _kernel_constants()
    th, tw, seg = k["TILE_H"], k["TILE_W"], k["SEG"]
    most = th * tw // 64 + 2 * (th // 16 + 2) * (tw // 16 + 2)
    for w, h in ((640, 480), (1280, 720)):
        info = make_info(w, h)
        _, counts = _walk(None, None, info, decode=False)
        ctas = -(-w // tw) * -(-h // th)
        assert counts["ctas"] == ctas and counts["pixel"] == 0
        assert counts["vector"] == h * w // seg
        assert sum(bh * bw for bh, bw in info.blocks) < counts["blocks"] <= ctas * most
        assert _walk(None, None, info, out_offset=8, decode=False)[1]["pixel"] == h * w // seg
    info = make_info(77, 35)
    rng = np.random.default_rng(77)
    coefs = [rng.integers(-40, 41, (bh, bw, 64)).astype(np.int16) for bh, bw in info.blocks]
    q = rng.integers(1, 50, (3, 64)).astype(np.int32)
    want = tdec.decode_jpeg_bgr([torch.from_numpy(c) for c in coefs], torch.from_numpy(q), info)
    got, counts = _walk(coefs, q, info, out_offset=4)
    assert np.array_equal(got, want.numpy()) and counts["vector"] and counts["pixel"]


@pytest.mark.parametrize("variant", [(32, 128, ""), (64, 256, ""), (32, 128, "no loads"),
                                     (32, 128, "no idct"), (32, 128, "no colour"),
                                     (32, 128, "nothing")])
def test_sweep_variants_apply_to_the_source(variant):
    """tools/sweep_jpeg_tiles.py's variants find the constants and the
    ablations' anchors they replace in jpeg.cu, once each, and change
    nothing else."""
    sys.path.insert(0, str(ROOT / "tools"))
    import sweep_jpeg_tiles
    src = (ROOT / "backscrub_tpu_torch" / "csrc" / "jpeg.cu").read_text()
    tile_w, nt, ablation = variant
    text = sweep_jpeg_tiles.variant_source(src, tile_w, nt, ablation)
    assert f"constexpr int TILE_W = {tile_w};" in text and f"constexpr int NT = {nt};" in text
    edits = sweep_jpeg_tiles.ABLATIONS.get(ablation, [])
    assert all(new in text for _, new in edits)
    assert len(text.splitlines()) == len(src.splitlines()) + sum(
        new.count("\n") for _, new in edits)


def test_kernel_wrapper_counts_no_cpu_launch():
    info = make_info(16, 16)
    coefs = [torch.zeros(b + (64,), dtype=torch.int16) for b in info.blocks]
    before = jpeg_kernels.decode_jpeg_bgr.launches
    out = jpeg_kernels.decode_jpeg_bgr(coefs, torch.ones((3, 64), dtype=torch.int32), info)
    assert out.shape == (16, 16, 3) and jpeg_kernels.decode_jpeg_bgr.launches == before


# ---------------------------------------------------------------------------
# the encoder


def _encode_port(img, sampling, quality):
    h, w = img.shape[:2]
    info = make_info(w, h, SAMPLINGS[sampling])
    qt = tenc.stream_qtabs(quality)
    coefs = tenc.encode_jpeg_coefs(torch.from_numpy(img), torch.from_numpy(qt.astype(np.int32)),
                                   info)
    return coefs, JpegHuffmanEncoder(info, qt).encode([c.numpy() for c in coefs]), info, qt


@pytest.mark.parametrize("sampling", ["420", "422", "444"])
@pytest.mark.parametrize("quality", [50, 85, 95])
def test_encode_matches_jax_and_opencv(jax_jpeg, sampling, quality):
    _, _, jenc = jax_jpeg
    img = _smooth(96, 128, quality)
    coefs, jpg, info, qt = _encode_port(img, sampling, quality)
    ref = jenc.encode_jpeg_coefs(jnp.asarray(img), jnp.asarray(qt), info)
    assert all(np.array_equal(a.numpy(), np.asarray(b)) for a, b in zip(coefs, ref))
    assert jpg == _cv2_jpeg(img, quality, sampling)


@pytest.mark.parametrize("dims", [(97, 131), (17, 9), (8, 8), (1, 1)])
def test_encode_odd_sizes(jax_jpeg, dims):
    """Partial blocks and MCU dummy blocks (zero AC, chained DC)."""
    _, _, jenc = jax_jpeg
    img = np.random.default_rng(dims[0]).integers(0, 256, dims + (3,), np.uint8)
    for sampling in ("420", "422"):
        coefs, jpg, info, qt = _encode_port(img, sampling, 85)
        ref = jenc.encode_jpeg_coefs(jnp.asarray(img), jnp.asarray(qt), info, order="natural")
        nat = tenc.encode_jpeg_coefs(torch.from_numpy(img),
                                     torch.from_numpy(qt.astype(np.int32)), info, "natural")
        assert all(np.array_equal(a.numpy(), np.asarray(b)) for a, b in zip(nat, ref))
        assert all(np.array_equal(tjpeg._zz_to_natural(z.numpy()), n.numpy())
                   for z, n in zip(coefs, nat))
        assert jpg == _cv2_jpeg(img, 85, sampling)


def test_quality_tables_match_jax(jax_jpeg):
    _, _, jenc = jax_jpeg
    for q in (1, 10, 49, 50, 51, 85, 100, 0, 120):
        assert np.array_equal(tenc.quality_to_qtabs(q), jenc.quality_to_qtabs(q))
    with pytest.raises(ValueError, match="order"):
        tenc.encode_jpeg_coefs(torch.zeros((8, 8, 3), dtype=torch.uint8),
                               torch.ones((3, 64), dtype=torch.int32), make_info(8, 8), "rows")


# ---------------------------------------------------------------------------
# the committed fixtures (what the card checks without OpenCV)


def test_fixtures_match_opencv_and_regenerate(tmp_path):
    """``tools/make_synth_mjpg.py`` rewrites the committed files byte for
    byte, and every hash in the JSON is OpenCV's for the committed bytes
    and seeded inputs, and the port's."""
    sys.path.insert(0, str(ROOT / "tools"))
    import make_synth_mjpg
    assert make_synth_mjpg.main(str(tmp_path)) == 0
    for name in (make_synth_mjpg.STREAM, make_synth_mjpg.SAMPLINGS, make_synth_mjpg.JSON):
        assert (tmp_path / name).read_bytes() == (DATA / name).read_bytes(), name
    meta = json.loads((DATA / make_synth_mjpg.JSON).read_text())
    for name, frames in meta["frames"].items():
        for jpg, f in zip(make_synth_mjpg.split((DATA / name).read_bytes(), frames), frames):
            dec = JpegEntropyDecoder()
            coefs, q = dec.decode(jpg)
            out = tdec.decode_jpeg_bgr([torch.from_numpy(c) for c in coefs],
                                       torch.from_numpy(q.astype(np.int32)), dec.info)
            assert hashlib.sha256(out.numpy().tobytes()).hexdigest() == f["decoded_sha256"]
    for e in meta["encodes"]:
        img = make_synth_mjpg.encode_input(e["width"], e["height"], e["seed"])
        _, jpg, _, _ = _encode_port(img, e["sampling"], e["quality"])
        assert hashlib.sha256(jpg).hexdigest() == e["sha256"] and len(jpg) == e["length"]


# ---------------------------------------------------------------------------
# sources and sinks


def test_synthetic_mjpg_camera_is_the_jax_one():
    """The ``mjpg:`` camera's JPEGs are the bytes OpenCV writes for the JAX
    package's ``mjpg:`` camera (the test pattern at quality 90)."""
    from backscrub_tpu.io.streams import SyntheticSource as JaxSyntheticSource
    cam, ref = streams.SyntheticJpegCamera(80, 48), JaxSyntheticSource(80, 48)
    for _ in range(3):
        assert cam() == _cv2_jpeg(ref.read(), 90)


def test_jpeg_source_reads_and_copies():
    jpgs = [_cv2_jpeg(_smooth(48, 64, i), 80) for i in range(4)]
    it = iter(jpgs)
    src = streams.JpegSource(lambda: next(it, None), prefetch=False)
    assert (src.width, src.height) == (64, 48) and src.jpeg_info.is_420
    got = [src.read() for _ in range(5)]
    assert got[-1] is None
    for jpg, (coefs, q) in zip(jpgs, got):
        want, wq = JpegEntropyDecoder().decode(jpg)
        assert q.dtype == np.int32 and np.array_equal(q, wq)
        assert all(np.array_equal(a, b) for a, b in zip(coefs, want))
    assert got[0][0][0] is not got[1][0][0]   # each frame its own copy
    src.close()
    with pytest.raises(OSError):
        streams.JpegSource(lambda: None)


def test_jpeg_source_prefetch_thread_and_eof():
    jpgs = iter([_cv2_jpeg(_smooth(48, 64, i), 80) for i in range(5)])
    src = streams.JpegSource(lambda: next(jpgs, None))
    got = 0
    while src.read() is not None:
        got += 1
    assert 1 <= got <= 5    # the newest frame wins: may skip, never repeats
    src.close()


def test_mjpg_sink_writes_the_stream(tmp_path):
    info = make_info(64, 48)
    qt = tenc.stream_qtabs(85)
    img = _smooth(48, 64, 2)
    coefs = tenc.encode_jpeg_coefs(torch.from_numpy(img), torch.from_numpy(qt.astype(np.int32)),
                                   info)
    sink = streams.open_sink(f"file:{tmp_path / 'o.mjpg'}", 64, 48, out_format="mjpg",
                             jpeg_info=info, jpeg_qtabs=qt)
    for _ in range(2):
        sink.write_yuyv(tuple(c.numpy() for c in coefs))
    sink.close()
    assert (tmp_path / "o.mjpg").read_bytes() == _cv2_jpeg(img, 85) * 2
    with pytest.raises(ValueError, match="jpeg_info"):
        streams.open_sink(f"file:{tmp_path / 'x.mjpg'}", 64, 48, out_format="mjpg")


class _FakeCapture:
    """A V4L2 capture that granted MJPG and delivers ``jpg`` every grab."""

    def __init__(self, jpg):
        self.width, self.height, self.pixelformat = 64, 48, "MJPG"
        self.jpg, self.closed = jpg, False

    def grab_raw(self):
        return np.frombuffer(self.jpg, np.uint8)

    def grab_bgr(self):
        return cv2.imdecode(self.grab_raw(), cv2.IMREAD_COLOR)

    def close(self):
        self.closed = True


@pytest.mark.parametrize("flavour", ["baseline", "progressive", "corrupt"])
def test_mjpg_camera_decodes_on_the_card_or_says_why_not(monkeypatch, capsys, flavour):
    """A baseline MJPG camera yields coefficient frames; a progressive one
    is decoded on the host with a note on stderr; a corrupt stream raises
    (and closes the device) rather than falling back."""
    from backscrub_tpu_torch.io import v4l2
    img = _smooth(48, 64, 5)
    jpg = {"baseline": _cv2_jpeg(img, 80),
           "progressive": _cv2_jpeg(img, 80, IMWRITE_JPEG_PROGRESSIVE=1),
           "corrupt": _cv2_jpeg(img, 80)[:300]}[flavour]
    cap = _FakeCapture(jpg)
    monkeypatch.setattr(v4l2, "V4L2Capture", lambda *a, **k: cap)
    if flavour == "corrupt":
        with pytest.raises(ValueError):
            streams.CameraSource("/dev/video0", 64, 48)
        assert cap.closed
        return
    src = streams.CameraSource("/dev/video0", 64, 48)
    frame = src.read()
    src.close()
    if flavour == "baseline":
        assert src.jpeg_info.is_420 and src.raw_format is None
        assert isinstance(frame, tuple) and frame[0][0].shape == (6, 8, 64)
        assert "not baseline" not in capsys.readouterr().err
    else:
        assert src.jpeg_info is None and frame.shape == (48, 64, 3)
        assert "not baseline JPEG" in capsys.readouterr().err
