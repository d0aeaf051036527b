"""The port's classic preprocess, the standalone bilateral (K5's plain
version), the staged ``MaskGen`` API and the classic NV12 pipeline
against the JAX package, on the committed full-width synthetic segm
model.

Bars: K5's plain version against the Pallas kernel in interpret mode
allclose(atol=2e-3, rtol=1e-3), the kernels' bar (the same f32 taps in
the same order; only exp may differ in the last bit), and after rounding
no byte off by more than 1; the preprocess on its u8 grid (before the
normalization), masks, EMA and packed bytes under the repo's tolerance
invariant (no byte off by more than 1, at most 2% of a frame's bytes
differ, at most 0.2% over the sequence).  The CUDA kernel K5 is held
against its plain version on the card in tests/test_torch_cuda.py.
"""

import pathlib
import re
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from backscrub_tpu.models.specs import spec_for_model as jax_spec
from backscrub_tpu.ops.pallas_kernels import bilateral5_pallas
from backscrub_tpu.pipeline import maskgen as jmaskgen
from backscrub_tpu.pipeline.frame import FramePipeline as JaxPipeline
from backscrub_tpu.pipeline.frame import PipelineConfig as JaxConfig
from backscrub_tpu.pipeline.geometry import compute_roi
from backscrub_tpu_torch.models.specs import spec_for_model
from backscrub_tpu_torch.ops.image_kernels import bilateral5
from backscrub_tpu_torch.ops.pack_kernels import blend_pack_420
from backscrub_tpu_torch.pipeline import maskgen as tmaskgen
from backscrub_tpu_torch.pipeline.frame import FramePipeline, PipelineConfig

ROOT = pathlib.Path(__file__).resolve().parent.parent
FULL = str(ROOT / "tests" / "data" / "segm_synth_lite_96x160.tflite")
DEEPLAB = str(ROOT / "tests" / "data" / "deeplab_synth_257.tflite")
FRAME_TOL, MEAN_TOL = 0.02, 0.002


def _frames(w, h, n):
    tools = str(ROOT / "tools")
    if tools not in sys.path:
        sys.path.insert(0, tools)
    from make_synth_segm import moving_frames
    return moving_frames(w, h, n)


def _invariant(pairs):
    fracs = []
    for a, b in pairs:
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype == np.uint8
        assert int(np.abs(a.astype(np.int16) - b).max()) <= 1
        fracs.append(float((a != b).mean()))
        assert fracs[-1] <= FRAME_TOL, f"{100 * fracs[-1]:.3f}% of a frame's bytes differ"
    assert float(np.mean(fracs)) <= MEAN_TOL
    return fracs


@pytest.mark.parametrize("lead,h,w", [((), 96, 160), ((3,), 37, 45), ((2, 2), 5, 7)])
def test_bilateral5_matches_jax_pallas(lead, h, w):
    """Leading dims flatten to frames, each with its own reflect-101
    border, as in the TPU wrapper."""
    rng = np.random.default_rng(h * w)
    x = rng.integers(0, 256, lead + (h, w, 3)).astype(np.float32)
    x[..., : h // 3, :, :] = 128.0                     # flat areas: den near 13
    before = bilateral5.launches
    got = bilateral5(torch.from_numpy(x))
    assert bilateral5.launches == before               # CPU: the plain version
    ref = np.asarray(bilateral5_pallas(jnp.asarray(x), interpret=True))
    assert got.shape == x.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-3, rtol=1e-3)
    assert np.abs(np.round(got.numpy()) - np.round(ref)).max() <= 1


@pytest.mark.parametrize("model,w,h", [(FULL, 640, 480), (FULL, 100, 640),
                                       (DEEPLAB, 640, 480)])
def test_preprocess_matches_jax(model, w, h):
    """The classic preprocess (crop, resize, round, letterbox, BGR->RGB,
    bilateral, round, normalize) on one frame and on a batch of two."""
    spec, jspec = spec_for_model(model), jax_spec(model)
    ih, iw = (96, 160) if model == FULL else (257, 257)
    geo = compute_roi(w, h, iw, ih, iw, ih)
    frames = np.stack(_frames(w, h, 2))
    for x in (frames[0], frames):
        got = tmaskgen.preprocess(torch.from_numpy(x), geo, spec).numpy()
        ref = np.asarray(jmaskgen.preprocess(jnp.asarray(x), geo, jspec))
        assert got.shape == ref.shape
        # back on the u8 grid: the tolerance invariant (a resize tie may
        # round the other way in the other summation order)
        u8 = [np.round((a - spec.offset) / spec.scale).astype(np.uint8) for a in (got, ref)]
        _invariant([tuple(u8)])


def test_staged_maskgen_matches_jax():
    """MaskGen(fused=False) fires onprep, oninfer, onmask per frame in the
    reference order and ondebug at construction, and its masks and EMA
    match the JAX staged MaskGen and the port's own fused step."""
    w, h = 640, 480
    calls = []
    hooks = dict(onprep=lambda: calls.append("prep"), oninfer=lambda: calls.append("infer"),
                 onmask=lambda: calls.append("mask"), ondebug=lambda m: calls.append("dbg"))
    staged = tmaskgen.MaskGen(FULL, w, h, fused=False, device="cpu", **hooks)
    assert staged.edge is None and calls.count("dbg") >= 1
    fused = tmaskgen.MaskGen(FULL, w, h, device="cpu")
    ref = jmaskgen.MaskGen(FULL, w, h, fused=False)
    del calls[:]
    pairs = []
    for f in _frames(w, h, 3):
        m = staged.process(f)
        pairs += [(m.numpy(), np.asarray(ref.process(f))),
                  (staged.ema.numpy(), np.asarray(ref.ema)),
                  (m.numpy(), fused.process(f).numpy())]
    assert calls == ["prep", "infer", "mask"] * 3
    _invariant(pairs)


def test_stage_hooks_fire_on_every_classic_step():
    """The stage hooks fire wherever the classic stages run: in the default
    mode with the edge path off too, in the reference order, and the masks
    equal the staged mode's."""
    w, h = 320, 240
    calls = []
    mg = tmaskgen.MaskGen(FULL, w, h, edge_fused=False, device="cpu",
                          onprep=lambda: calls.append("prep"),
                          oninfer=lambda: calls.append("infer"),
                          onmask=lambda: calls.append("mask"))
    staged = tmaskgen.MaskGen(FULL, w, h, fused=False, device="cpu")
    assert mg.edge is None
    for f in _frames(w, h, 2):
        assert torch.equal(mg.process(f), staged.process(f))
    assert calls == ["prep", "infer", "mask"] * 2


def test_capi_surface():
    """bs_maskgen_* with and without out_mask, process_bytes,
    parse_capi_options and bs_tensorflow_version."""
    w, h = 320, 240
    f0, f1 = _frames(w, h, 2)
    ctx = tmaskgen.bs_maskgen_new(FULL, w, h, device="cpu",
                                  **tmaskgen.parse_capi_options("no-bilateral"))
    assert not ctx.use_bilateral
    other = tmaskgen.MaskGen(FULL, w, h, use_bilateral=False, device="cpu")
    out = np.zeros((h, w), np.uint8)
    assert tmaskgen.bs_maskgen_process(ctx, f0, out) is True
    np.testing.assert_array_equal(out, other.process(f0).numpy())
    assert torch.equal(tmaskgen.bs_maskgen_process(ctx, f1), other.process(f1))
    tmaskgen.bs_maskgen_delete(ctx)
    other.reset()
    assert bool((ctx.ema == 255).all())
    assert ctx.process_bytes(f0.tobytes(), h, w) == other.process(f0).numpy().tobytes()
    assert tmaskgen.bs_tensorflow_version() == f"torch-{torch.__version__}"
    assert tmaskgen.parse_capi_options(" , ") == {}
    for tok in ("u8exact", "refine:guided", "morph:open:3"):
        got = tmaskgen.parse_capi_options(f"no-bilateral,{tok}")
        assert got == jmaskgen.parse_capi_options(f"no-bilateral,{tok}")
        opt = tmaskgen.bs_maskgen_new(FULL, w, h, device="cpu", edge_fused=False, **got)
        ref = jmaskgen.MaskGen(FULL, w, h, edge_fused=False, **got)
        _invariant([(opt.process(f).numpy(), np.asarray(ref.process(f))) for f in (f0, f1)])
    with pytest.raises(ValueError, match="unknown maskgen option"):
        tmaskgen.parse_capi_options("bogus")


def test_not_yet_messages_name_a_roadmap_item(tmp_path):
    """No flag of the JAX CLI is refused any more: ``parse_args`` takes
    ``--bf16`` and ``--int8`` with the frame options as the JAX one does,
    the CLI has no refusal left (``refused`` and its ROADMAP constants are
    gone), the program serves both modes (two frames with each), and
    ROADMAP.md's queue 1 no longer lists the bf16 mode as to port."""
    import backscrub_tpu.cli as jcli
    from backscrub_tpu_torch import cli
    argv = ["--bf16", "--int8", "-p", "refine:guided", "--sink-format", "mjpg", "-c", "mjpg:",
            "-p", "morph:open"]
    assert cli.parse_args(argv) == jcli.parse_args(argv)
    assert not hasattr(cli, "refused") and not [n for n in vars(cli) if n.startswith("ROADMAP")]
    for flag in ("--bf16", "--int8"):
        out = tmp_path / f"{flag[2:]}.yuv"
        assert cli.main(["-c", "test:", "--cg", "64x48", "-m", FULL, "--frames", "2",
                         "-v", f"file:{out}", flag], device="cpu") == 0
        assert out.stat().st_size == 2 * 64 * 48 * 2
    roadmap = (ROOT / "ROADMAP.md").read_text()
    queue = roadmap.split("### Queue 1 ")[1].split("\n### ")[0]
    titles = re.findall(r"^\d+\. \*\*(.+?)\.\*\*", queue, re.M)
    assert titles and "bf16 mode" not in titles


def test_classic_nv12_pipeline_matches_jax():
    """The classic path with NV12 out (preprocess with K5's plain version,
    the graph executor, K4's plain version) against the JAX classic path
    with its fused 4:2:0 pack in interpret mode, 3 frames at 640x480, then
    an I420 step of the same pipeline's frames."""
    w, h = 640, 480
    port = FramePipeline(FULL, PipelineConfig(width=w, height=h, edge_fused=False,
                                              output_format="nv12"), device="cpu")
    assert port.maskgen.edge is None and port.fused_pack_applies(False, False)
    ref = JaxPipeline(FULL, JaxConfig(width=w, height=h, edge_fused=False,
                                      output_format="nv12", pack_interpret=True))
    bg = np.random.default_rng(5).integers(0, 256, (h, w, 3), np.uint8)
    frames = _frames(w, h, 3)
    pairs = []
    before = blend_pack_420.launches
    for f in frames:
        out, mask = port.step(f, bg)
        assert out.shape == (3 * h // 2, w)
        jout, jmask = ref.step(f, bg)
        pairs += [(out.numpy(), np.asarray(jout)), (mask.numpy(), np.asarray(jmask)),
                  (port.maskgen.ema.numpy(), np.asarray(ref.maskgen.ema))]
    assert blend_pack_420.launches == before
    _invariant(pairs)
    i420 = FramePipeline(FULL, PipelineConfig(width=w, height=h, edge_fused=False,
                                              output_format="i420"), device="cpu")
    out, mask = i420.step(frames[0], bg)
    want = blend_pack_420(torch.from_numpy(frames[0]), torch.from_numpy(bg), mask, "i420")
    assert out.shape == (3 * h * w // 2,) and torch.equal(out, want)
