"""The mask options of the port on the CPU — morphology, the u8-exact post,
guided refinement — and the MJPG frame formats through ``FramePipeline``,
against the JAX package.

Bars: the morphology, the u8-exact resize and box blur and the MJPG
decode/encode are integer math, byte-identical to the JAX ops; the guided
filter and whole pipelines meet the repo's tolerance invariant (no byte
off by more than 1, at most 2% of a frame's bytes differ, at most 0.2%
over a sequence).  Fused references run the JAX package's Pallas kernels
in interpret mode (``edge_interpret=True, pack_interpret=True``); with a
post option the JAX package turns its fused tail off and runs its front
kernel, then its lowerings over the whole body, and so does the port (K1,
then the graph executor).
"""

import os
import pathlib
import sys

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")
jnp = pytest.importorskip("jax.numpy")

from backscrub_tpu.pipeline import image as jimage
from backscrub_tpu.pipeline import maskgen as jmaskgen
from backscrub_tpu.pipeline.frame import FramePipeline as JaxPipeline
from backscrub_tpu.pipeline.frame import PipelineConfig as JaxConfig

from backscrub_tpu_torch import _build, cli
from backscrub_tpu_torch.io.jpeg import JpegEntropyDecoder
from backscrub_tpu_torch.pipeline import edge as tedge
from backscrub_tpu_torch.pipeline import image as timage
from backscrub_tpu_torch.pipeline import maskgen as tmaskgen
from backscrub_tpu_torch.pipeline.frame import FramePipeline, PipelineConfig
from backscrub_tpu_torch.pipeline.geometry import compute_roi

ROOT = pathlib.Path(__file__).resolve().parent.parent
FULL = str(ROOT / "tests" / "data" / "segm_synth_lite_96x160.tflite")
SELFIE = str(ROOT / "tests" / "data" / "selfie_synth_mlkit_256x256.tflite")
FRAME_TOL, MEAN_TOL = 0.02, 0.002
W, H = 160, 120


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def _bsjpeg():
    """The JAX package's entropy codec loads the library the port builds."""
    os.environ.setdefault("BSJPEG_LIB", _build.host_library("bsjpeg"))


def _frames(w, h, n, seed=0):
    tools = str(ROOT / "tools")
    if tools not in sys.path:
        sys.path.insert(0, tools)
    import make_synth_segm
    return make_synth_segm.moving_frames(w, h, n, seed)


class _Invariant:
    def __init__(self):
        self.fracs = []

    def add(self, a, b):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype == np.uint8
        assert int(np.abs(a.astype(np.int16) - b).max(initial=0)) <= 1
        frac = float((a != b).mean())
        assert frac <= FRAME_TOL, f"{100 * frac:.3f}% of a frame's bytes differ"
        self.fracs.append(frac)

    def check(self):
        assert float(np.mean(self.fracs)) <= MEAN_TOL


# ---------------------------------------------------------------------------
# the ops


@pytest.mark.parametrize("spec", ["erode", "dilate:5", "open", "open:3", "close:3", "close:7",
                                  "erode:1"])
def test_morph_matches_jax(spec):
    rng = np.random.default_rng(len(spec))
    for shape in ((37, 53), (2, 24, 40)):
        m = ((rng.random(shape) > 0.5) * 255).astype(np.uint8)
        got = timage.apply_mask_morph(torch.from_numpy(m), spec).numpy()
        assert np.array_equal(got, np.asarray(jimage.apply_mask_morph(jnp.asarray(m), spec)))
    with pytest.raises(ValueError, match="odd"):
        timage.erode_u8(torch.zeros((4, 4), dtype=torch.uint8), 2)
    with pytest.raises(ValueError, match="morph op"):
        timage.apply_mask_morph(torch.zeros((4, 4), dtype=torch.uint8), "smear")


@pytest.mark.parametrize("src,dst", [((37, 53), (120, 164)), ((64, 64), (480, 640)),
                                     ((33, 33), (257, 300)), ((20, 30), (10, 11))])
def test_u8_exact_resize_and_blur_match_jax_and_opencv(src, dst):
    rng = np.random.default_rng(src[0])
    x = rng.integers(0, 256, src + (1,), np.uint8)
    got = timage.resize_bilinear_u8_exact(torch.from_numpy(x), *dst).numpy()
    assert np.array_equal(got, np.asarray(jimage.resize_bilinear_u8_exact(jnp.asarray(x), *dst)))
    assert np.array_equal(got[..., 0], cv2.resize(x[..., 0], dst[::-1],
                                                  interpolation=cv2.INTER_LINEAR))
    y = rng.integers(0, 256, dst + (1,), np.uint8)
    blur = timage.box_blur_u8_exact(torch.from_numpy(y), 5).numpy()
    assert np.array_equal(blur, np.asarray(jimage.box_blur_u8_exact(jnp.asarray(y), 5)))
    assert np.array_equal(blur[..., 0], cv2.blur(y[..., 0], (5, 5)))


def test_guided_filter_matches_jax():
    rng = np.random.default_rng(4)
    g, s = rng.random((60, 80), np.float32), rng.random((60, 80), np.float32)
    got = timage.guided_filter(torch.from_numpy(g), torch.from_numpy(s), 4).numpy()
    np.testing.assert_allclose(got, np.asarray(jimage.guided_filter(jnp.asarray(g),
                                                                    jnp.asarray(s), 4)),
                               atol=1e-5)


@pytest.mark.parametrize("w,h,opts", [
    (640, 480, dict(morph="open:3")), (640, 480, dict(u8_exact=True)),
    (640, 480, dict(u8_exact=True, morph="close")), (100, 640, dict(u8_exact=True)),
    (640, 480, dict(refine="guided")), (320, 240, dict(refine="guided", morph="erode:5"))])
def test_postprocess_options_match_jax(w, h, opts):
    """``postprocess_mask`` with the options on seeded EMAs: morph and
    u8_exact byte-identical, guided under the tolerance invariant."""
    geo = compute_roi(w, h, 160, 96, 160, 96)
    frame = _frames(w, h, 1)[0]
    inv = _Invariant()
    for seed in range(2):
        ema = np.random.default_rng(seed).integers(0, 256, (96, 160), np.uint8)
        ema[20:70, 40:110] = 3   # a person-shaped region for the morphology
        got = tedge.postprocess_mask(torch.from_numpy(ema), geo,
                                     frame_bgr=torch.from_numpy(frame), **opts).numpy()
        ref = np.asarray(jmaskgen.postprocess_mask(
            jnp.asarray(ema), geo, u8_exact=opts.get("u8_exact", False),
            refine=opts.get("refine", "box"), frame_bgr=jnp.asarray(frame),
            morph=opts.get("morph", "")))
        if opts.get("refine") == "guided":
            inv.add(got, ref)
        else:
            assert np.array_equal(got, ref)
    if inv.fracs:
        inv.check()


def test_postprocess_option_errors_match_jax():
    geo = compute_roi(W, H, 160, 96, 160, 96)
    ema = torch.zeros((96, 160), dtype=torch.uint8)
    with pytest.raises(ValueError, match="contradictory"):
        tedge.postprocess_mask(ema, geo, refine="guided", u8_exact=True,
                               frame_bgr=torch.zeros((H, W, 3), dtype=torch.uint8))
    with pytest.raises(ValueError, match="guide"):
        tedge.postprocess_mask(ema, geo, refine="guided")


# ---------------------------------------------------------------------------
# MaskGen and the C ABI options


def test_maskgen_validates_and_reads_the_environment(monkeypatch):
    with pytest.raises(ValueError, match="refine"):
        tmaskgen.MaskGen(FULL, W, H, refine="sharp", device="cpu")
    with pytest.raises(ValueError, match="morph op"):
        tmaskgen.MaskGen(FULL, W, H, morph="smear:3", device="cpu")
    for value, want in (("1", True), ("on", True), ("TRUE", True), ("0", False), ("", False)):
        monkeypatch.setenv("BACKSCRUB_U8_EXACT", value)
        assert tmaskgen.MaskGen(FULL, W, H, device="cpu").u8_exact_post is want
        assert jmaskgen.MaskGen(FULL, W, H).u8_exact_post is want
    monkeypatch.setenv("BACKSCRUB_U8_EXACT", "1")
    assert tmaskgen.MaskGen(FULL, W, H, u8_exact_post=False, device="cpu").u8_exact_post is False


@pytest.mark.parametrize("options", ["u8exact", "refine:guided", "morph:open:3",
                                     "no-bilateral,morph:close", "refine:box, u8exact"])
def test_capi_option_tokens_match_jax(options):
    assert tmaskgen.parse_capi_options(options) == jmaskgen.parse_capi_options(options)
    with pytest.raises(ValueError, match="unknown maskgen option"):
        tmaskgen.parse_capi_options(options + ",sharpen")


@pytest.mark.parametrize("path", [FULL, SELFIE])
@pytest.mark.parametrize("opts", [dict(refine="guided"), dict(morph="open:3"),
                                  dict(u8_exact_post=True)])
def test_option_route_is_the_jax_route(path, opts):
    """A post option turns the fused tail off in both packages; with no cut
    of the body that one tensor crosses, the JAX package runs its front
    kernel and then its lowerings over the body, and the port K1 and then
    the graph executor — no body plan."""
    port = tmaskgen.MaskGen(path, 640, 480, device="cpu", **opts).edge
    ref = jmaskgen.MaskGen(path, 640, 480, edge_interpret=True, **opts).edge
    assert not ref.info.tail_ok and ref.mega is None and ref.mega_prefix is None
    assert not port.info.tail_ok and port.plans == [] and port.rest is not None
    assert (port.info.body_start, port.info.body_end) == (ref.info.body_start, ref.info.body_end)


@pytest.mark.parametrize("opts", [dict(refine="guided"), dict(morph="open:3"),
                                  dict(u8_exact_post=True)])
def test_maskgen_options_match_jax(opts):
    """Three frames of the fused route (K1's plain version, the executor,
    the decode, the EMA, the post with the option) against the JAX fused
    route in interpret mode, and the classic stages against JAX classic."""
    for fused in (True, False):
        port = tmaskgen.MaskGen(FULL, W, H, device="cpu", edge_fused=fused, **opts)
        ref = jmaskgen.MaskGen(FULL, W, H, edge_fused=fused, edge_interpret=fused, **opts)
        assert (port.edge is not None) == (ref.edge is not None) == fused
        inv = _Invariant()
        for f in _frames(W, H, 3):
            inv.add(port.process(f).numpy(), np.asarray(ref.process(f)))
            inv.add(port.ema.numpy(), np.asarray(ref.ema))
        inv.check()


# ---------------------------------------------------------------------------
# FramePipeline: the options and MJPG in and out


def _jpegs(frames, quality=90):
    return [cv2.imencode(".jpg", f, [cv2.IMWRITE_JPEG_QUALITY, quality])[1].tobytes()
            for f in frames]


def _mjpg_frames(jpgs):
    dec = JpegEntropyDecoder()
    out = []
    for jpg in jpgs:
        coefs, q = dec.decode(jpg)
        out.append((tuple(c.copy() for c in coefs), q))
    return out, dec.info


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("case", ["mjpg-in", "mjpg-out", "guided", "morph", "mjpg-both-422"])
def test_pipeline_options_match_jax(fused, case):
    """Each configuration against the JAX pipeline (fused: interpret mode;
    classic: its classic stages and jnp packs): packed outputs and masks
    under the tolerance invariant, MJPG coefficients equal in at least 98%
    of their blocks.  With the default post (the MJPG cases) the fold-blur
    puts EMA values on x.5 ties at small frames, which round by summation
    order (``tests/test_torch_pipeline.py``): those cases run at 640x480,
    two frames."""
    w, h, n = (640, 480, 2) if case.startswith("mjpg") else (W, H, 3)
    frames = _frames(w, h, n)
    bg = np.random.default_rng(5).integers(0, 256, (h, w, 3), np.uint8)
    mj, info = _mjpg_frames(_jpegs(frames))
    opts = {"mjpg-in": dict(input_format="mjpg", jpeg_info=info),
            "mjpg-out": dict(output_format="mjpg", out_jpeg_quality=75),
            "guided": dict(mask_refine="guided"),
            "morph": dict(mask_morph="close:5"),
            "mjpg-both-422": dict(input_format="mjpg", jpeg_info=info,
                                  output_format="mjpg", out_jpeg_sampling="422")}[case]
    port = FramePipeline(FULL, PipelineConfig(width=w, height=h, edge_fused=fused, **opts),
                         device="cpu")
    ref = JaxPipeline(FULL, JaxConfig(width=w, height=h, edge_fused=fused, edge_interpret=fused,
                                      pack_interpret=fused, fused_pack=fused, **opts))
    inputs = mj if "jpeg_info" in opts else frames
    inv = _Invariant()
    for x in inputs:
        out, mask = port.step(x, bg)
        jout, jmask = ref.step(x, bg)
        if isinstance(out, tuple):
            assert len(out) == len(jout) == 3
            for a, b in zip(out, jout):
                a, b = a.numpy(), np.asarray(b)
                assert a.shape == b.shape and a.dtype == np.int16
                assert (a != b).any(axis=-1).mean() <= 0.02
        else:
            inv.add(out.numpy(), np.asarray(jout))
        inv.add(mask.numpy(), np.asarray(jmask))
    inv.check()


def test_mjpg_input_is_the_decoded_bgr_frame():
    """MJPG in is the BGR pipeline on cv2.imdecode's frames, byte for byte,
    and MJPG out is the encode of the BGR output, byte for byte."""
    frames = _frames(W, H, 2)
    jpgs = _jpegs(frames)
    mj, info = _mjpg_frames(jpgs)
    m = FramePipeline(FULL, PipelineConfig(width=W, height=H, input_format="mjpg",
                                           jpeg_info=info, output_format="mjpg"), device="cpu")
    b = FramePipeline(FULL, PipelineConfig(width=W, height=H, output_format="bgr"), device="cpu")
    from backscrub_tpu_torch.io.jpeg import JpegHuffmanEncoder
    enc = JpegHuffmanEncoder(m.out_jpeg_info, m.out_jpeg_qtabs)
    for jpg, x in zip(jpgs, mj):
        out, mask = m.step(x)
        bout, bmask = b.step(cv2.imdecode(np.frombuffer(jpg, np.uint8), cv2.IMREAD_COLOR))
        assert torch.equal(mask, bmask)
        ok, want = cv2.imencode(".jpg", bout.numpy(), [cv2.IMWRITE_JPEG_QUALITY, 85])
        assert enc.encode([c.numpy() for c in out]) == want.tobytes()


def test_mjpg_config_validation():
    info = _mjpg_frames(_jpegs(_frames(W, H, 1)))[1]
    with pytest.raises(ValueError, match="jpeg_info"):
        FramePipeline(FULL, PipelineConfig(width=W, height=H, input_format="mjpg"), device="cpu")
    with pytest.raises(ValueError, match="capture geometry"):
        FramePipeline(FULL, PipelineConfig(width=2 * W, height=2 * H, input_format="mjpg",
                                           jpeg_info=info), device="cpu")
    with pytest.raises(ValueError, match="out_jpeg_sampling"):
        FramePipeline(FULL, PipelineConfig(width=W, height=H, output_format="mjpg",
                                           out_jpeg_sampling="411"), device="cpu")
    pipe = FramePipeline(FULL, PipelineConfig(width=W, height=H, input_format="mjpg",
                                              jpeg_info=info), device="cpu")
    coefs, q = _mjpg_frames(_jpegs(_frames(W, H, 1)))[0][0]
    with pytest.raises(ValueError, match="component 1"):
        pipe.step(((coefs[0], coefs[1][:1], coefs[2]), q))


def test_cli_u8exact_environment_matches_jax_fused(tmp_path, monkeypatch):
    """``BACKSCRUB_U8_EXACT=1 backscrub-torch`` writes the frames of the JAX
    fused route (interpret mode) with the u8-exact post, byte for byte
    (the JAX classic FramePipeline does not apply the option)."""
    monkeypatch.setenv("BACKSCRUB_U8_EXACT", "1")
    n = 4
    out = tmp_path / "o.yuv"
    assert cli.main(["-c", "test:", "--cg", f"{W}x{H}", "-m", FULL, "--frames", str(n),
                     "-v", f"file:{out}"], device="cpu") == 0
    from backscrub_tpu.io.streams import SyntheticSource as JaxSyntheticSource
    src = JaxSyntheticSource(W, H)
    ref = JaxPipeline(FULL, JaxConfig(width=W, height=H, edge_interpret=True,
                                      pack_interpret=True))
    assert ref.maskgen.u8_exact_post and not ref.maskgen.edge.info.tail_ok
    want = b"".join(np.asarray(ref.step(src.read())[0]).tobytes() for _ in range(n))
    got = out.read_bytes()
    assert len(got) == len(want) == n * W * H * 2
    inv = _Invariant()
    for i in range(n):
        sl = slice(i * W * H * 2, (i + 1) * W * H * 2)
        inv.add(np.frombuffer(got[sl], np.uint8), np.frombuffer(want[sl], np.uint8))
    inv.check()
