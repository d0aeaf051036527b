"""The PyTorch port's BodyPix family against the JAX package, on the
committed synthetic BodyPix-shaped model (``tools/make_synth_bodypix.py``:
MobileNetV1 at multiplier 0.50, output stride 8, 257x257 in, a 33x33 logit
out) and a narrow variant built here.

BodyPix takes the fused path that no other family takes: K1 (the 257x257
canvas -> 16x129x129, RELU6), then the prefix plan K2' alone (the spec's
``edge_cont=False``), the graph executor over the 33x33 remainder (the
dilated depthwise convs), the threshold decode on the logit (no fused
tail), the two-stage post (upscale, round, 5x5 box blur, round: the output
crop is under 64 px) and K3.  Checked here on the CPU (the kernels' plain
versions; the card holds the kernels to them in tests/test_torch_cuda.py
and chip_smoke.py):

- detection: ``EdgeInfo`` equal to the JAX package's, the front fused and
  no tail; the prefix cut where the JAX ``body_mega_prefix_for`` cuts (the
  same node index and tensor id), no continuation, the rest left to the
  executor;
- the loaders' host parameters, equal (f32 weights, no DEQUANTIZE);
- the prefix: its op table walked phase by phase against ``run_plain``
  and the JAX ``BodyMega`` in interpret mode;
- the two-stage post: bit for bit the JAX package's at the upscale's x.5
  ties, and ``edge.post_footprint`` bounding what an EMA flip moves;
- the slice at 640x480 against the JAX fused path (interpret mode) and
  the JAX classic path (narrow model), the full-width model against the
  classic path only, and the staged ``MaskGen`` against the JAX classic
  ``MaskGen``.

Bars: the decode flip rule on the logit (a decode may differ only at
|logit - 0.65| <= 1e-3, the EMAs equal wherever none flipped); masks and
YUYV no byte off by more than 1 outside the flips' post footprint, at most
2% of a frame's bytes and 0.2% of a sequence's differing (the tolerance
invariant), and none differing outside a flip's footprint.
"""

import collections
import dataclasses
import pathlib
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from backscrub_tpu.graph.executor import load_model as jax_load_model
from backscrub_tpu.models.specs import spec_for_model as jax_spec
from backscrub_tpu.ops.megakernel import body_mega_prefix_for
from backscrub_tpu.pipeline import edge as jedge
from backscrub_tpu.pipeline.frame import FramePipeline as JaxPipeline
from backscrub_tpu.pipeline.frame import PipelineConfig as JaxConfig
from backscrub_tpu.pipeline.geometry import compute_roi
from backscrub_tpu.pipeline.image import resize_bilinear as jax_resize
from backscrub_tpu.pipeline.maskgen import MaskGen as JaxMaskGen
from backscrub_tpu.pipeline.maskgen import postprocess_mask as jax_post
from backscrub_tpu.pipeline.maskgen import preprocess as jax_preprocess
from backscrub_tpu_torch.graph.executor import load_model
from backscrub_tpu_torch.models.specs import spec_for_model
from backscrub_tpu_torch.ops.megakernel import _MAX_SMEM, body_plan_prefix_for
from backscrub_tpu_torch.pipeline import edge as tedge
from backscrub_tpu_torch.pipeline.frame import FramePipeline, PipelineConfig
from backscrub_tpu_torch.pipeline.image import resize_bilinear
from backscrub_tpu_torch.pipeline.maskgen import MaskGen

from test_torch_body_mega import _jax_mega, walk
from test_torch_selfie import _Bars, _yuyv

ROOT = pathlib.Path(__file__).resolve().parent.parent
FULL = str(ROOT / "tests" / "data" / "body-pix_synth_050_8_257.tflite")
W, H = 640, 480
THRESHOLD = 0.65


def _tools():
    tools = str(ROOT / "tools")
    if tools not in sys.path:
        sys.path.insert(0, tools)
    import make_synth_bodypix
    return make_synth_bodypix


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """The 257x257 plain ops run faster on 2 intra-op threads than on one
    per core when several test workers share the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    narrow = tmp_path_factory.mktemp("synth") / "body-pix_synth_narrow_257.tflite"
    _tools().write_model(str(narrow), width=0.5, depth=9)
    return {"full": FULL, "narrow": str(narrow)}


def _pair(path, w=W, h=H):
    """(JAX model, port model, geometry, JAX info, port info) at w x h."""
    jm, tm = jax_load_model(path), load_model(path, "cpu")
    geo = compute_roi(w, h, 257, 257, 33, 33)
    return (jm, tm, geo, jedge.edge_applicable(jm, jax_spec(path), geo),
            tedge.edge_applicable(tm, spec_for_model(path), geo))


def test_generator_structure():
    """The committed model: BodyPix's shapes and spec, CONV_2D x15 and
    DEPTHWISE_CONV_2D x13 with f32 weights (no DEQUANTIZE), RELU6 fused
    everywhere but the head, and the strides and rates of the generator's
    table (output stride 8: 257 -> 129 -> 65 -> 33, then dilation)."""
    m = load_model(FULL, "cpu")
    assert m.input_shape == (1, 257, 257, 3) and m.output_shape == (1, 33, 33, 1)
    spec = spec_for_model(FULL)
    assert (spec.kind, spec.decode, spec.threshold, spec.scale, spec.edge_cont) == \
        ("bodypix", "threshold", 0.65, 1 / 255.0, False)
    assert jax_spec(FULL).kind == "bodypix"
    g = m.graph
    assert collections.Counter(n.kind for n in g.nodes) == {"CONV_2D": 15,
                                                             "DEPTHWISE_CONV_2D": 13}
    assert all(g.tensor(n.inputs[1]).data.dtype == np.float32 for n in g.nodes)
    dws = [n.options for n in g.nodes if n.kind == "DEPTHWISE_CONV_2D"]
    assert [o["stride_h"] for o in dws] == [1, 2, 1, 2] + [1] * 9
    assert [o["dilation_h"] for o in dws] == [1] * 6 + [2] * 6 + [4]
    assert [n.options.get("activation") for n in g.nodes] == ["RELU6"] * 27 + ["NONE"]
    assert [tuple(g.tensor(n.outputs[0]).shape)[1:] for n in g.nodes[:9:2]] == [
        (129, 129, 16), (129, 129, 32), (65, 65, 64), (65, 65, 64), (33, 33, 128)]


@pytest.mark.parametrize("w,h", [(640, 480), (1280, 720)])
def test_edge_info_and_prefix_cut_match_jax(models, w, h):
    """Both packages detect the fused front (RELU6) and no tail; both cut
    the prefix at the same node and tensor; the port's fused path is the
    prefix plan alone (no continuation: ``edge_cont`` off, as the JAX
    path's) with the executor over the rest, and the two-stage post."""
    for which, path in models.items():
        jm, tm, geo, jinfo, tinfo = _pair(path, w, h)
        assert (geo.out_roi.w, geo.out_roi.h, geo.roi.h) == (33, 33, h)
        assert dataclasses.asdict(tinfo) == dataclasses.asdict(jinfo)
        assert tinfo.front_ok and not tinfo.tail_ok and tinfo.front_activation == "RELU6"
        assert (tinfo.conv_oh, tinfo.conv_ow) == (129, 129)
        mega, cut, cut_tid = body_mega_prefix_for(jm, jinfo, interpret=True)
        plan, tcut, tcut_tid = body_plan_prefix_for(tm, tinfo)
        assert (tcut, tcut_tid) == (cut, cut_tid)
        assert [p[0] for p in plan.plan] == [p[0] for p in mega.plan]
        if which == "full":
            assert cut == 8 and cut_tid == tm.graph.nodes[7].outputs[0]
            assert [p[0] for p in plan.plan] == ["dw", "conv1x1"] * 3 + ["dw"]
        e = MaskGen(path, w, h, device="cpu").edge
        assert e.prefix_plan is not None and e.cont_plan is None and e.body_plan is None
        assert e.rest is not None and e.post_mats is None
        je = JaxPipeline(path, JaxConfig(width=w, height=h, edge_fused=True,
                                         edge_interpret=True)).maskgen.edge
        assert je.mega_prefix is not None and je.mega_cont is None and je.mega is None


def test_host_params_equal_jax():
    """The port's loader reads the same .tflite: every host parameter (f32
    weights, the edge layer's layout) equals the JAX loader's."""
    jm, tm = jax_load_model(FULL), load_model(FULL, "cpu")
    assert set(tm.host_params) == set(jm.host_params)
    for k, v in jm.host_params.items():
        np.testing.assert_array_equal(np.asarray(tm.host_params[k]), np.asarray(v), err_msg=k)


def test_prefix_table_structure():
    """The full-width prefix: one bs_body_mega launch a run over a 7-phase
    table (four depthwise ops, two of them stride 2 on odd sizes, 129 -> 65
    -> 33, and three column-wise pointwise convs) that fits the kernel's
    shared memory; 16x129x129 in, 64x33x33 out."""
    tm, tinfo = _pair(FULL)[1::3]
    plan = body_plan_prefix_for(tm, tinfo)[0]
    mt = plan.mega
    assert plan.launches_per_run == 1 and dict(plan.kernels_per_run) == {"bs_body_mega": 1}
    assert mt.covered == list(range(len(plan.plan))) and mt.phases == 7
    assert dict(mt.kinds) == {"dw": 4, "convw": 3} and mt.smem_bytes <= _MAX_SMEM
    assert (plan.in_meta.c, plan.in_meta.rows, plan.in_meta.w) == (16, 129, 129)
    assert (plan.out_meta.c, plan.out_meta.rows, plan.out_meta.w) == (64, 33, 33)


@pytest.mark.parametrize("which", ["narrow", "full"])
def test_prefix_walker_matches_plain_and_jax(models, which):
    """The prefix's op table walked phase by phase equals run_plain (atol
    1e-5), and both equal the JAX prefix BodyMega in interpret mode
    (allclose(2e-3, 1e-3), the body bar)."""
    jm, tm, _, jinfo, tinfo = _pair(models[which])
    plan = body_plan_prefix_for(tm, tinfo)[0]
    im = plan.in_meta
    x = np.random.default_rng(11).uniform(0, 6, (im.c, im.rows, im.w)).astype(np.float32)
    xt = torch.from_numpy(x.reshape(im.c, -1))
    with torch.no_grad():
        got, phases = walk(plan, xt)
        plain = plan.run_plain(xt)
    assert phases == plan.mega.phases and bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, plain, atol=1e-5, rtol=0)
    ref = _jax_mega(body_mega_prefix_for(jm, jinfo, interpret=True)[0], x)
    np.testing.assert_allclose(plain.numpy(), ref, atol=2e-3, rtol=1e-3)


def _ema_values(rng, shape):
    """EMA bytes as the decode's bit trick makes them: each pixel's last
    eight decodes, person (0) or background (0xE0), shifted in."""
    ema = np.full(shape, 255, np.uint8)
    for _ in range(8):
        ema = np.where(rng.random(shape) < 0.5, 0, 0xE0).astype(np.uint8) | (ema >> 3)
    return ema


@pytest.mark.parametrize("w,h", [(640, 480), (1280, 720)])
def test_two_stage_post_matches_jax_at_upscale_ties(w, h):
    """The two-stage post (33x33 -> the 480 or 720 px ROI) equals the JAX
    package's bit for bit on EMAs whose upscale meets x.5 ties: each
    upscaled value is the f32 sum of its two rounded products, as the
    reference's contraction makes it.  A plain f32 matmul (the port's
    ``resize_bilinear``) rounds some of those ties the other way."""
    geo = compute_roi(w, h, 257, 257, 33, 33)
    rng = np.random.default_rng(3)
    other = 0
    for _ in range(4):
        ema = _ema_values(rng, (33, 33))
        got = tedge.postprocess_mask(torch.from_numpy(ema), geo).numpy()
        np.testing.assert_array_equal(got, np.asarray(jax_post(jnp.asarray(ema), geo)))
        x = ema.astype(np.float32)[..., None]
        up_ref = np.round(np.asarray(jax_resize(jnp.asarray(x), geo.roi.h, geo.roi.w)))
        up_mm = torch.round(resize_bilinear(torch.from_numpy(x), geo.roi.h, geo.roi.w))
        other += int((up_mm.numpy() != up_ref).sum())
    assert other > 0


def test_post_footprint_bounds_a_two_stage_flip():
    """Flipping a few EMA pixels' decode bits changes the two-stage post's
    mask only inside their footprint (``edge.post_footprint`` with no
    fold-blur matrices: the upscale's taps, then the blur's 2 px, reflected
    at the ROI's border), which stays near one upscaled pixel each; an
    empty set of flips has an empty footprint."""
    e = MaskGen(FULL, W, H, device="cpu")
    geo = e.geo
    assert e.post_mats is None and min(geo.out_roi.h, geo.out_roi.w) < 64
    rng = np.random.default_rng(7)
    for picks in (((0, 0), (16, 20)), ((32, 32), (5, 31), (20, 3))):
        ema = torch.from_numpy(_ema_values(rng, (33, 33)))
        moved, picked = ema.clone(), torch.zeros((33, 33), dtype=torch.bool)
        for i, j in picks:
            moved[i, j] ^= 0xE0
            picked[i, j] = True
        foot = tedge.post_footprint(picked, geo, None)
        changed = tedge.postprocess_mask(ema, geo) != tedge.postprocess_mask(moved, geo)
        assert bool(changed.any()) and not bool((changed & ~foot).any())
        assert not bool(foot[:, :geo.roi.x].any() or foot[:, geo.roi.x + geo.roi.w:].any())
        scale = geo.roi.h / geo.out_roi.h                   # ~14.5 px a model pixel
        assert int(foot.sum()) <= len(picks) * (2 * scale + 6) ** 2
    assert not bool(tedge.post_footprint(torch.zeros_like(picked), geo, None).any())


def _margin_jax(mg, frame):
    """The JAX classic path's decode margin a pixel: the logit less 0.65."""
    out = np.asarray(mg.model(jax_preprocess(frame, mg.geo, mg.spec)[None]), np.float64)[0]
    return out[..., 0] - THRESHOLD


def _footprint(pixels, geo):
    return tedge.post_footprint(torch.from_numpy(pixels), geo, None).numpy()


def _run(path, n, refs):
    frames = _tools().moving_frames(W, H, n)
    bg = np.random.default_rng(5).integers(0, 256, (H, W, 3), np.uint8)
    port = FramePipeline(path, PipelineConfig(width=W, height=H), device="cpu")
    e = port.maskgen.edge
    assert e is not None and e.prefix_plan is not None and e.cont_plan is None
    jax_pipes = {}
    if "fused" in refs:
        jax_pipes["fused"] = JaxPipeline(path, JaxConfig(
            width=W, height=H, edge_fused=True, edge_interpret=True, pack_interpret=True))
        assert jax_pipes["fused"].maskgen.edge.mega_prefix is not None
    if "classic" in refs:
        jax_pipes["classic"] = JaxPipeline(path, JaxConfig(
            width=W, height=H, edge_fused=False, fused_pack=False))
    bars = {k: _Bars((33, 33)) for k in jax_pipes}
    none = np.zeros((H, W), bool)
    person = []
    for f in frames:
        yuyv, mask = port.step(f, bg)
        r = port.geo.roi
        person.append(float((mask[r.y:r.y + r.h, r.x:r.x + r.w] < 128).float().mean()))
        ema = port.maskgen.ema.numpy()
        with torch.no_grad():
            margin = (e.body(e.front(torch.from_numpy(f)))[0] - THRESHOLD).double().numpy()
        for name, jp in jax_pipes.items():
            jy, jm = jp.step(f, bg)
            jema = np.asarray(jp.maskgen.ema)
            m = margin if name == "fused" else np.maximum(
                np.abs(margin), np.abs(_margin_jax(jp.maskgen, f)))
            bars[name].ema(ema, jema, m)
            foot = _footprint(ema != jema, port.geo)
            bars[name].bytes([((mask.numpy(), jm), none), ((yuyv.numpy(), jy), _yuyv(none))],
                             [foot, _yuyv(foot)])
    for b in bars.values():
        b.check()
        assert max(b.elsewhere) == 0
    # a mask that is all one value would make the comparison vacuous
    assert 0.1 <= person[0] <= 0.9, person
    return bars


def test_slice_matches_both_jax_paths(models):
    """Five frames at 640x480 of the narrow model through the port's
    FramePipeline (K1, K2' plain versions, the executor, the threshold
    decode, the two-stage post, K3's plain version) against the JAX fused
    path (interpret mode) and the JAX classic path, under the module's
    bars."""
    _run(models["narrow"], 5, ("fused", "classic"))


def test_full_width_matches_jax_classic():
    """Four frames of the committed full-width model against the JAX
    classic path (the JAX fused path in interpret mode is left to the
    narrow model), under the module's bars."""
    _run(FULL, 4, ("classic",))


def test_staged_maskgen_matches_jax_classic():
    """The staged MaskGen (fused=False, hooks in order) on the full-width
    model against the JAX classic MaskGen: EMAs under the flip rule, masks
    under the module's bars."""
    calls = []
    port = MaskGen(FULL, W, H, fused=False, device="cpu",
                   onprep=lambda: calls.append("prep"), oninfer=lambda: calls.append("infer"))
    ref = JaxMaskGen(FULL, W, H, fused=False)
    assert port.edge is None
    bars = _Bars((33, 33))
    for f in _tools().moving_frames(W, H, 3):
        mask = port.process(f)
        jm = np.asarray(ref.process(f))
        ema, jema = port.ema.numpy(), np.asarray(ref.ema)
        with torch.no_grad():
            out = port._infer(port._pre(torch.from_numpy(f)))[..., 0].double().numpy()
        bars.ema(ema, jema, out - THRESHOLD)
        bars.bytes([((mask.numpy(), jm), np.zeros((H, W), bool))], [_footprint(ema != jema,
                                                                             port.geo)])
    bars.check()
    assert max(bars.elsewhere) == 0 and calls == ["prep", "infer"] * 3


def test_generator_reproduces_the_committed_file(tmp_path):
    """``write_model`` (the draw and the head bias calibrated through the
    JAX reference) writes the committed bytes, and the calibration puts
    frame 0's median logit over the ROI at 0.65."""
    mk = _tools()
    out = mk.write_model(str(tmp_path / "body-pix_synth_050_8_257.tflite"))
    with open(out, "rb") as got, open(FULL, "rb") as want:
        assert got.read() == want.read()
    med = mk.calibrate_head_bias(FULL, mk.moving_frames(320, 240, 1)[0])
    assert abs(med - THRESHOLD) < 1e-5
