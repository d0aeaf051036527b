"""The port's output side against the JAX package: blend + 4:2:0 pack
(K4's plain version), the NV12/I420 conversions, flips, the background
effects, and ``FramePipeline``'s output formats, flips, out-geometry,
background modes and passthrough on the narrow synthetic segm model.

Bars: the integer ops (K4's plain version, the conversions, flips, gray,
pixelate) byte-identical; the Gaussian blur allclose(atol=1e-4) (the same
f32 taps summed in the same order); the pipelines under the repo's
tolerance invariant (no byte off by more than 1, at most 2% of a frame's
bytes differ, at most 0.2% over the sequence), and byte-identical where
no out-geometry resize runs (the mask path matches the JAX classic path
byte for byte at 640x480, and the packs are integer math).  The CUDA kernel K4 is held against its plain version on
the card in tests/test_torch_cuda.py.
"""

import pathlib
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from backscrub_tpu.ops.pallas_kernels import blend_pack_420 as jax_pack_420
from backscrub_tpu.pipeline import image as jimg
from backscrub_tpu.pipeline.frame import FramePipeline as JaxPipeline
from backscrub_tpu.pipeline.frame import PipelineConfig as JaxConfig
from backscrub_tpu_torch.ops.pack_kernels import blend_pack_420
from backscrub_tpu_torch.pipeline import image as timg
from backscrub_tpu_torch.pipeline.frame import FramePipeline, PipelineConfig

ROOT = pathlib.Path(__file__).resolve().parent.parent
FRAME_TOL, MEAN_TOL = 0.02, 0.002


def _tools():
    tools = str(ROOT / "tools")
    if tools not in sys.path:
        sys.path.insert(0, tools)
    import make_synth_segm
    return make_synth_segm


@pytest.fixture(scope="module")
def narrow(tmp_path_factory):
    path = tmp_path_factory.mktemp("synth") / "segm_synth_narrow_96x160.tflite"
    _tools().write_model(str(path), width=0.5, depth=4)
    return str(path)


def _inputs(h, w, seed, lead=()):
    rng = np.random.default_rng(seed)
    fr = rng.integers(0, 256, lead + (h, w, 3), np.uint8)
    bg = rng.integers(0, 256, lead + (h, w, 3), np.uint8)
    m = rng.integers(0, 256, lead + (h, w), np.uint8)
    m[..., : h // 4, :] = 255
    m[..., h // 4: h // 2, :] = 0
    fr[..., -2:, :, :] = 255
    bg[..., -1:, :, :] = 0
    return fr, bg, m


@pytest.mark.parametrize("h,w", [(42, 58), (48, 80), (480, 640)])
@pytest.mark.parametrize("layout", ["nv12", "i420"])
def test_blend_pack_420_matches_jax(h, w, layout):
    """K4's plain version against the Pallas kernel in interpret mode
    (H = 42 has no 8-multiple row tile) and against alpha_blend_u8 +
    bgr_to_nv12 / bgr_to_i420: byte-identical."""
    fr, bg, m = _inputs(h, w, seed=h + w)
    before = blend_pack_420.launches
    got = blend_pack_420(torch.from_numpy(fr), torch.from_numpy(bg),
                         torch.from_numpy(m), layout)
    assert blend_pack_420.launches == before      # CPU: the plain version
    y, uv = (np.asarray(a) for a in jax_pack_420(jnp.asarray(fr), jnp.asarray(bg),
                                                  jnp.asarray(m), interpret=True))
    if layout == "nv12":
        want = np.concatenate([y, uv], axis=0)
        conv = jimg.bgr_to_nv12
    else:
        want = np.concatenate([y.reshape(-1), uv[:, 0::2].reshape(-1),
                               uv[:, 1::2].reshape(-1)])
        conv = jimg.bgr_to_i420
    assert got.dtype == torch.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), np.asarray(conv(jimg.alpha_blend_u8(bg, fr, m))))


def test_420_conversions_and_flips_match_jax():
    """bgr_to_nv12 / bgr_to_i420 over every 4th RGB triple and with leading
    dims, flip in all four combinations: byte-identical."""
    v = np.arange(0, 256, 4, dtype=np.uint8)
    bgr = np.stack(np.meshgrid(v, v, v, indexing="ij"), -1).reshape(-1, 256, 3)
    fr, _, _ = _inputs(42, 58, seed=3, lead=(2,))
    for x in (bgr, fr):
        t = torch.from_numpy(x)
        np.testing.assert_array_equal(timg.bgr_to_nv12(t).numpy(),
                                      np.asarray(jimg.bgr_to_nv12(x)))
        np.testing.assert_array_equal(timg.bgr_to_i420(t).numpy(),
                                      np.asarray(jimg.bgr_to_i420(x)))
    for hz in (False, True):
        for vt in (False, True):
            np.testing.assert_array_equal(timg.flip(torch.from_numpy(fr), hz, vt).numpy(),
                                          np.asarray(jimg.flip(fr, hz, vt)))
    with pytest.raises(ValueError, match="even"):
        timg.bgr_to_nv12(torch.zeros((41, 58, 3), dtype=torch.uint8))


@pytest.mark.parametrize("ksize", [5, 9, 15])
def test_gaussian_blur_matches_jax(ksize):
    x = np.random.default_rng(ksize).uniform(0, 255, (2, 42, 58, 3)).astype(np.float32)
    np.testing.assert_array_equal(timg.gaussian_kernel(ksize), jimg.gaussian_kernel(ksize))
    np.testing.assert_allclose(timg.gaussian_blur(torch.from_numpy(x), ksize).numpy(),
                               np.asarray(jimg.gaussian_blur(x, ksize)), atol=1e-4, rtol=0)


@pytest.mark.parametrize("block", [1, 7, 16])
def test_gray_desaturate_pixelate_match_jax(block):
    fr, _, _ = _inputs(42, 58, seed=block)
    t = torch.from_numpy(fr)
    np.testing.assert_array_equal(timg.bgr_to_gray_u8(t).numpy(),
                                  np.asarray(jimg.bgr_to_gray_u8(fr)))
    np.testing.assert_array_equal(timg.desaturate_u8(t).numpy(),
                                  np.asarray(jimg.desaturate_u8(fr)))
    np.testing.assert_array_equal(timg.pixelate_u8(t, block).numpy(),
                                  np.asarray(jimg.pixelate_u8(fr, block)))


def _invariant(pairs):
    fracs = []
    for a, b in pairs:
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype == np.uint8
        fracs.append(float((a != b).mean()))
        assert int(np.abs(a.astype(np.int16) - b).max()) <= 1
        assert fracs[-1] <= FRAME_TOL, f"{100 * fracs[-1]:.3f}% of a frame's bytes differ"
    assert float(np.mean(fracs)) <= MEAN_TOL
    return fracs


# port options, JAX options (the fused pack in interpret mode where the
# port takes K4's plain version, else the jnp path), background
CASES = {
    "nv12": (dict(output_format="nv12"), dict(pack_interpret=True), "explicit"),
    "i420_classic": (dict(output_format="i420", edge_fused=False),
                     dict(pack_interpret=True), "explicit"),
    "bgr_flip_h": (dict(output_format="bgr", flip_horizontal=True),
                   dict(fused_pack=False), "explicit"),
    "yuyv_flip_v_out_geometry": (dict(flip_vertical=True, out_width=320, out_height=180),
                                 dict(fused_pack=False), "explicit"),
    "nv12_out_geometry": (dict(output_format="nv12", out_width=480, out_height=360),
                          dict(fused_pack=False), "explicit"),
    "yuyv_blur_mode": (dict(blur_strength=7), dict(pack_interpret=True), None),
    "i420_desat_pixelate": (dict(output_format="i420", bg_desaturate=True, bg_pixelate=8),
                            dict(pack_interpret=True), "explicit"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_pipeline_outputs_match_jax(narrow, case):
    """Three frames at 640x480 of the port's FramePipeline (plain versions
    on the CPU) against the JAX FramePipeline on the classic path
    (edge_fused=False), with the same output options."""
    port_opts, jax_opts, bg_mode = CASES[case]
    w, h = 640, 480
    port = FramePipeline(narrow, PipelineConfig(width=w, height=h, **port_opts),
                         device="cpu")
    jax_cfg = {k: v for k, v in port_opts.items() if k != "edge_fused"}
    ref = JaxPipeline(narrow, JaxConfig(width=w, height=h, edge_fused=False,
                                        **jax_cfg, **jax_opts))
    assert port.fused_pack_applies(port.cfg.flip_horizontal, port.cfg.flip_vertical) \
        == ("out_geometry" not in case and "flip" not in case and "bgr" not in case)
    bg = (None if bg_mode is None else
          np.random.default_rng(5).integers(0, 256, (h, w, 3), np.uint8))
    pairs = []
    for f in _tools().moving_frames(w, h, 3):
        out, mask = port.step(f, bg)
        jout, jmask = ref.step(f, bg)
        pairs += [(out.numpy(), np.asarray(jout)), (mask.numpy(), np.asarray(jmask)),
                  (port.maskgen.ema.numpy(), np.asarray(ref.maskgen.ema))]
    fracs = _invariant(pairs)
    if "out_geometry" not in case:
        assert max(fracs) == 0.0
    # the out-geometry resize puts some bytes on x.5 exactly; which way they
    # round depends on the f32 summation order of the two contractions


def test_passthrough_and_per_step_flips_match_jax(narrow):
    """filter_active=False passes the frame through (mask all 255, the EMA
    untouched); per-step flip overrides turn the fused pack off, as in the
    JAX package."""
    w, h = 320, 240
    port = FramePipeline(narrow, PipelineConfig(width=w, height=h, output_format="nv12"),
                         device="cpu")
    ref = JaxPipeline(narrow, JaxConfig(width=w, height=h, output_format="nv12",
                                        edge_fused=False, pack_interpret=True))
    f0, f1 = _tools().moving_frames(w, h, 2)
    bg = np.random.default_rng(6).integers(0, 256, (h, w, 3), np.uint8)
    port.step(f0, bg)
    ref.step(f0, bg)
    ema = port.maskgen.ema.clone()
    out, mask = port.step(f1, bg, filter_active=False)
    jout, jmask = ref.step(f1, bg, filter_active=False)
    assert torch.equal(port.maskgen.ema, ema) and bool((mask == 255).all())
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    np.testing.assert_array_equal(out.numpy(), timg.bgr_to_nv12(torch.from_numpy(f1)).numpy())
    assert not port.fused_pack_applies(True, False)
    out, mask = port.step(f1, bg, flip_horizontal=True, flip_vertical=True)
    jout, jmask = ref.step(f1, bg, flip_horizontal=True, flip_vertical=True)
    _invariant([(out.numpy(), jout), (mask.numpy(), jmask)])


@pytest.mark.parametrize("config,error", [
    (dict(output_format="nv12", width=641), ValueError),
    (dict(output_format="i420", out_width=320, out_height=181), ValueError),
    (dict(out_width=321, out_height=240), ValueError),
    (dict(output_format="rgb565"), ValueError)])
def test_output_geometry_checks(narrow, config, error):
    cfg = dict(width=640, height=480)
    cfg.update(config)
    with pytest.raises(error):
        FramePipeline(narrow, PipelineConfig(**cfg), device="cpu")
