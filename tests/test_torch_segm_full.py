"""The PyTorch port's segm_full family (Google Meet full, 144x256) against
the JAX package, on the committed synthetic segm_full-shaped model
(``tools/make_synth_segm.py --size 144x256``) and a narrow variant built
here.

The family runs segm_lite's kernels at shapes none of them ran at before:
K1 at the 144x256 canvas (a 16x72x128 output), K2 on a segm body (FC
squeeze-excite, CONCATENATION decoder) whose first stage is 128 wide (the
reference's 256-lane row stride), the fused two-channel tail at 144x256,
and K3.  Checked here on the CPU (the kernels' plain versions; the card
holds the kernels to them in tests/test_torch_cuda.py and chip_smoke.py):

- detection: the port and the JAX package agree on ``EdgeInfo`` and on
  taking the full-span body kernel, at 640x480 (a letterboxed canvas) and
  1280x720 (none);
- the loaders' host parameters, equal;
- the body: the op table walked phase by phase against ``run_plain`` and
  the JAX ``BodyMega`` in interpret mode (narrow model), the walk against
  ``run_plain`` at full width;
- the slice at 640x480 against the JAX fused path (interpret mode) and
  the JAX classic path (narrow model), the full-width model against the
  classic path only, and the staged ``MaskGen`` against the JAX classic
  ``MaskGen``;
- the generator: it rebuilds both committed segm fixtures byte for byte.

Bars: those of tests/test_torch_selfie.py (the decode flip rule, here on
the two-channel margin out1 - out0; masks and YUYV no byte off by more
than 1, at most 2% of a frame's bytes, off the post's x.5 ties at most
0.2% of a sequence's; the flips' post footprint exempt from the per-byte
clause), with ``test_references_differ_by_near_tie_flips`` showing that
the JAX package's own two paths differ that way.
"""

import collections
import dataclasses
import pathlib
import sys

import numpy as np
import pytest
import torch

from backscrub_tpu.graph.executor import load_model as jax_load_model
from backscrub_tpu.models.specs import spec_for_model as jax_spec
from backscrub_tpu.ops.megakernel import body_mega_for
from backscrub_tpu.pipeline import edge as jedge
from backscrub_tpu.pipeline.frame import FramePipeline as JaxPipeline
from backscrub_tpu.pipeline.frame import PipelineConfig as JaxConfig
from backscrub_tpu.pipeline.geometry import compute_roi
from backscrub_tpu.pipeline.maskgen import MaskGen as JaxMaskGen
from backscrub_tpu.pipeline.maskgen import preprocess as jax_preprocess
from backscrub_tpu_torch.graph.executor import load_model
from backscrub_tpu_torch.models.specs import spec_for_model
from backscrub_tpu_torch.ops.megakernel import _MAX_SMEM, body_plan_for
from backscrub_tpu_torch.pipeline import edge as tedge
from backscrub_tpu_torch.pipeline.frame import FramePipeline, PipelineConfig
from backscrub_tpu_torch.pipeline.maskgen import MaskGen

from test_torch_body_mega import _jax_mega, walk
from test_torch_selfie import TIE, _Bars, _quadrant_to_std, _yuyv, post_ties

ROOT = pathlib.Path(__file__).resolve().parent.parent
DATA = ROOT / "tests" / "data"
FULL = str(DATA / "segm_synth_full_144x256.tflite")
LITE = str(DATA / "segm_synth_lite_96x160.tflite")
W, H = 640, 480
IN_H, IN_W = 144, 256


def _tools():
    tools = str(ROOT / "tools")
    if tools not in sys.path:
        sys.path.insert(0, tools)
    import make_synth_segm
    return make_synth_segm


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """The plain ops run faster on 2 intra-op threads than on one per core
    when several test workers share the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    narrow = tmp_path_factory.mktemp("synth") / "segm_synth_full_narrow_144x256.tflite"
    _tools().write_model(str(narrow), width=0.5, depth=4, size=(IN_H, IN_W))
    return {"full": FULL, "narrow": str(narrow)}


def _pair(path, w=W, h=H):
    """(JAX model, port model, geometry, JAX info, port info) at w x h."""
    jm, tm = jax_load_model(path), load_model(path, "cpu")
    geo = compute_roi(w, h, IN_W, IN_H, IN_W, IN_H)
    return (jm, tm, geo, jedge.edge_applicable(jm, jax_spec(path), geo),
            tedge.edge_applicable(tm, spec_for_model(path), geo))


def test_generator_structure():
    """The committed model: segm_full's shapes and spec, segm_lite's op mix
    (the tool's blocks at another size), the stem at 72x128 and the tail's
    input at 72x128."""
    m, lite = load_model(FULL, "cpu"), load_model(LITE, "cpu")
    assert m.input_shape == (1, 144, 256, 3) and m.output_shape == (1, 144, 256, 2)
    spec = spec_for_model(FULL)
    assert (spec.kind, spec.decode, spec.scale) == ("meet", "two_channel", 1 / 255.0)
    assert jax_spec(FULL).kind == "meet"
    counts = collections.Counter(n.kind for n in m.graph.nodes)
    assert counts == collections.Counter(n.kind for n in lite.graph.nodes)
    assert counts["CONCATENATION"] == 3 and counts["FULLY_CONNECTED"] == 14
    g = m.graph
    assert tuple(g.tensor(g.nodes[0].outputs[0]).shape) == (1, 72, 128, 16)
    assert g.nodes[-1].kind == "Convolution2DTransposeBias"
    assert tuple(g.tensor(g.nodes[-1].inputs[0]).shape) == (1, 72, 128, 16)


@pytest.mark.parametrize("w,h", [(640, 480), (1280, 720)])
def test_edge_info_and_megakernel_match_jax(models, w, h):
    """Both packages detect the fused front and the two-channel tail alike
    and both take the full-span body kernel (JAX ``body_mega_for``, the
    port's one-launch plan), at both widths; 640x480 letterboxes the
    192x144 input ROI into the 256-wide canvas, 1280x720 fills it."""
    for path in models.values():
        jm, tm, geo, jinfo, tinfo = _pair(path, w, h)
        assert (geo.in_roi.w, geo.out_roi.w) == ((192, 192) if w == 640 else (256, 256))
        assert dataclasses.asdict(tinfo) == dataclasses.asdict(jinfo)
        assert tinfo.front_ok and tinfo.tail_ok and tinfo.tail_kind == "two_channel"
        assert (tinfo.conv_oh, tinfo.conv_ow) == (72, 128)
        mega = body_mega_for(jm, jinfo, interpret=True)
        plan = body_plan_for(tm, tinfo)
        assert mega is not None and plan is not None
        assert [p[0] for p in plan.plan] == [p[0] for p in mega.plan]
        assert mega.rs == 256          # the 128-wide first stage's row stride
        port = MaskGen(path, w, h, device="cpu")
        assert port.edge is not None and port.edge.body_plan is not None
        assert port.edge.post_mats is not None     # the fold-blur post


def test_host_params_equal_jax():
    """The port's loader reads the same .tflite: every host parameter (the
    f16 weights dequantized, the edge layers' layouts) equals the JAX
    loader's."""
    jm, tm = jax_load_model(FULL), load_model(FULL, "cpu")
    assert set(tm.host_params) == set(jm.host_params)
    for k, v in jm.host_params.items():
        np.testing.assert_array_equal(np.asarray(tm.host_params[k]), np.asarray(v), err_msg=k)


def test_table_structure():
    """The full-width body: one bs_body_mega launch a run over a 37-phase
    table that fits the kernel's shared memory.  Block 0's squeeze-excite
    stays four ops (its 36x64 depthwise needs a 9344-float window for its
    pool, over _DW_SMEM_FLOATS); every other gate fuses; the decoder's
    three resizes and the concat copy of the stem output are in the
    table."""
    tm, tinfo = _pair(FULL)[1::3]
    plan = body_plan_for(tm, tinfo)
    mt = plan.mega
    assert plan.launches_per_run == 1 and dict(plan.kernels_per_run) == {"bs_body_mega": 1}
    assert mt.covered == list(range(len(plan.plan)))
    assert mt.smem_bytes <= _MAX_SMEM and mt.phases == 37
    kinds = collections.Counter(m["kind"] for m in mt.ops)
    assert kinds["dw"] == 9 and kinds["resize"] == 3 and kinds["gpool"] == 1
    assert kinds["fc"] == 2 and kinds["copy"] == 1
    assert (plan.in_meta.c, plan.in_meta.rows, plan.in_meta.w) == (16, 72, 128)
    assert (plan.out_meta.c, plan.out_meta.rows, plan.out_meta.w) == (16, 72, 128)


@pytest.mark.parametrize("which", ["narrow", "full"])
def test_body_table_walker_matches_plain_and_jax(models, which):
    """The op table walked phase by phase equals run_plain (atol 1e-5); on
    the narrow model both equal the JAX BodyMega in interpret mode
    (allclose(2e-3, 1e-3), the body bar)."""
    jm, tm, _, jinfo, tinfo = _pair(models[which])
    plan = body_plan_for(tm, tinfo)
    im = plan.in_meta
    x = (np.random.default_rng(11).standard_normal((im.c, im.rows, im.w)) * 2
         ).astype(np.float32)
    xt = torch.from_numpy(x.reshape(im.c, -1))
    with torch.no_grad():
        got, phases = walk(plan, xt)
        plain = plan.run_plain(xt)
    assert phases == plan.mega.phases and bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, plain, atol=1e-5, rtol=0)
    if which == "narrow":
        ref = _jax_mega(body_mega_for(jm, jinfo, interpret=True), x)
        np.testing.assert_allclose(plain.numpy(), ref, atol=2e-3, rtol=1e-3)


def _jax_margin(jp, frame):
    """The JAX classic path's decode margin a pixel: out1 - out0, float64."""
    mg = jp.maskgen
    out = np.asarray(mg.model(jax_preprocess(frame, mg.geo, mg.spec)[None]), np.float64)[0]
    return out[..., 1] - out[..., 0]


def _footprint(pixels, mg):
    """The frame bytes (H, W) bool that the EMA ``pixels`` reach through
    the post (``edge.post_footprint``)."""
    return tedge.post_footprint(torch.from_numpy(pixels), mg.geo, mg.post_mats).numpy()


def _run(path, n, refs):
    frames = _tools().moving_frames(W, H, n)
    bg = np.random.default_rng(5).integers(0, 256, (H, W, 3), np.uint8)
    port = FramePipeline(path, PipelineConfig(width=W, height=H), device="cpu")
    e = port.maskgen.edge
    assert e is not None and e.body_plan is not None and e.info.tail_kind == "two_channel"
    jax_pipes = {}
    if "fused" in refs:
        jax_pipes["fused"] = JaxPipeline(path, JaxConfig(
            width=W, height=H, edge_fused=True, edge_interpret=True, pack_interpret=True))
        assert jax_pipes["fused"].maskgen.edge.mega is not None
    if "classic" in refs:
        jax_pipes["classic"] = JaxPipeline(path, JaxConfig(
            width=W, height=H, edge_fused=False, fused_pack=False))
    bars = {k: _Bars((IN_H, IN_W)) for k in jax_pipes}
    person = []
    for f in frames:
        yuyv, mask = port.step(f, bg)
        r = port.geo.roi
        person.append(float((mask[r.y:r.y + r.h, r.x:r.x + r.w] < 128).float().mean()))
        ema = port.maskgen.ema.numpy()
        with torch.no_grad():
            body = e.body(e.front(torch.from_numpy(f)))
            margin = e.tail_logits(body.reshape(body.shape[0], -1)).numpy()
        for name, jp in jax_pipes.items():
            jy, jm = jp.step(f, bg)
            jema = jp.maskgen.ema
            if name == "fused":
                jema, m = _quadrant_to_std(jema), margin
            else:       # a flip must be a near-tie on both sides
                m = np.maximum(np.abs(margin), np.abs(_jax_margin(jp, f)))
            bars[name].ema(ema, jema, m)
            ties = post_ties(np.asarray(jema), port.geo)
            foot = _footprint(ema != np.asarray(jema), port.maskgen)
            bars[name].bytes([((mask.numpy(), jm), ties), ((yuyv.numpy(), jy), _yuyv(ties))],
                             [foot, _yuyv(foot)])
    for b in bars.values():
        b.check()
    # a mask that is all one value would make the comparison vacuous
    assert 0.1 <= person[0] <= 0.9, person
    return bars


def test_slice_matches_both_jax_paths(models):
    """Six frames at 640x480 of the narrow model through the port's
    FramePipeline (K1, K2 plain versions, the two-channel tail, K3's plain
    version) against the JAX fused path (interpret mode) and the JAX
    classic path, under the module's bars."""
    bars = _run(models["narrow"], 6, ("fused", "classic"))
    for b in bars.values():
        assert max(b.elsewhere) == 0


def test_full_width_matches_jax_classic():
    """Four frames of the committed full-width model against the JAX
    classic path (the JAX fused path in interpret mode is left to the
    narrow model), under the module's bars."""
    bars = _run(FULL, 4, ("classic",))
    assert max(bars["classic"].elsewhere) == 0


def test_references_differ_by_near_tie_flips(models):
    """What the module's bars rest on: the JAX package's own fused and
    classic paths differ the way the port may.  This model's two-channel
    margin is narrow (over 0.5% of the output's pixels lie within 1e-3 of
    the decision), so the two paths' f32 summation orders flip a few
    decodes a frame: every flip at a near-tie of the classic margin, the
    EMAs equal wherever none flipped, and the masks differing only inside
    the flips' post footprint or at the post's x.5 ties (by 1)."""
    path = models["narrow"]
    frames = _tools().moving_frames(W, H, 4)
    bg = np.random.default_rng(5).integers(0, 256, (H, W, 3), np.uint8)
    fused = JaxPipeline(path, JaxConfig(width=W, height=H, edge_fused=True,
                                        edge_interpret=True, pack_interpret=True))
    classic = JaxPipeline(path, JaxConfig(width=W, height=H, edge_fused=False,
                                          fused_pack=False))
    port = MaskGen(path, W, H, device="cpu")
    bars = _Bars((IN_H, IN_W))
    for f in frames:
        _, mf = fused.step(f, bg)
        _, mc = classic.step(f, bg)
        ef, ec = _quadrant_to_std(fused.maskgen.ema), np.asarray(classic.maskgen.ema)
        margin = _jax_margin(classic, f)
        assert float((np.abs(margin) <= TIE).mean()) > 0.005
        bars.ema(ef, ec, margin)
        bars.bytes([((mf, mc), post_ties(ec, port.geo))], [_footprint(ef != ec, port)])
    bars.check()
    assert bars.flips > 0 and max(bars.elsewhere) == 0


def test_staged_maskgen_matches_jax_classic():
    """The staged MaskGen (fused=False, hooks in order) on the full-width
    model against the JAX classic MaskGen: EMAs under the flip rule, masks
    under the module's bars."""
    calls = []
    port = MaskGen(FULL, W, H, fused=False, device="cpu",
                   onprep=lambda: calls.append("prep"), oninfer=lambda: calls.append("infer"))
    ref = JaxMaskGen(FULL, W, H, fused=False)
    assert port.edge is None
    bars = _Bars((IN_H, IN_W))
    for f in _tools().moving_frames(W, H, 3):
        mask = port.process(f)
        jm = np.asarray(ref.process(f))
        with torch.no_grad():
            out = port._infer(port._pre(torch.from_numpy(f))).double().numpy()
        ema, jema = port.ema.numpy(), np.asarray(ref.ema)
        bars.ema(ema, jema, out[..., 1] - out[..., 0])
        bars.bytes([((mask.numpy(), jm), post_ties(jema, port.geo))],
                   [_footprint(ema != jema, port)])
    bars.check()
    assert calls == ["prep", "infer"] * 3


@pytest.mark.parametrize("name,size", [("segm_synth_lite_96x160.tflite", (96, 160)),
                                       ("segm_synth_full_144x256.tflite", (144, 256))])
def test_generator_reproduces_the_committed_files(tmp_path, name, size):
    """``write_model`` (the draw and the tail bias calibrated through the
    JAX reference) writes each committed segm fixture's bytes: the lite one
    at the default size, so the size parameter changed nothing there."""
    mk = _tools()
    kw = {} if size == (mk.IN_H, mk.IN_W) else dict(size=size)
    out = mk.write_model(str(tmp_path / name), **kw)
    with open(out, "rb") as got, open(DATA / name, "rb") as want:
        assert got.read() == want.read()
