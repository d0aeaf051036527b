"""The PyTorch port's mlkit selfie family (the reference's default model)
against the JAX package, on the committed synthetic MLKit-selfie-shaped
model (``tools/make_synth_selfie.py``) and a narrow variant built here.

The family runs the same frame kernels as segm at new shapes: K1 at the
256x256 canvas (a 16x128x128 output), K2 on a body whose first stage is
128 wide (the reference's 256-lane row stride), the tail's one-channel
``threshold`` branch, and K3.  Checked here on the CPU (the kernels' plain
versions; the card holds the kernels to them in tests/test_torch_cuda.py):

- detection: the port and the JAX package agree on ``EdgeInfo`` and on
  taking the full-span body kernel (the JAX ``body_mega_for``, the port's
  ``body_plan_for``);
- the loaders' host parameters, equal;
- the body: ``BodyPlan.run_plain`` and its op table walked phase by phase
  against the JAX ``BodyMega`` in interpret mode (narrow model), and the
  walk against ``run_plain`` at full width; the threshold tail and EMA
  against the JAX tail;
- the slice at 640x480 against the JAX fused path (interpret mode) and
  the JAX classic path (narrow model), the full-width model against the
  classic path only, and the staged ``MaskGen`` against the JAX classic
  ``MaskGen``.

Bars.  EMAs: equal, or a decode flip at a near-tie of the threshold
(|logit - logit(0.65)| <= 1e-3) with the EMAs equal wherever no decode
flipped.  Masks and YUYV: no byte off by more than 1, at most 2% of a
frame's bytes differ, and off the post's exact ties at most 0.2% of a
sequence's.  The last clause is the tolerance invariant's sequence clause
narrowed to what the references themselves keep: at this geometry (a
256x256 output upscaled 1.875x into a 480x480 ROI, then the 5-tap blur)
up to 15% of the ROI's post values sit within 5e-6 of x.5 (``post_ties``),
and which way f32 rounds them depends on the matmul's summation order, so
the JAX package's own fused and classic paths differ on 0.69% of the
narrow model's mask bytes, all at such ties
(``test_references_differ_only_at_post_ties``).  A byte at a tie may round
either way.
"""

import collections
import dataclasses
import pathlib
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from backscrub_tpu.graph.executor import load_model as jax_load_model
from backscrub_tpu.models.specs import spec_for_model as jax_spec
from backscrub_tpu.ops.megakernel import body_mega_for
from backscrub_tpu.pipeline import edge as jedge
from backscrub_tpu.pipeline.frame import FramePipeline as JaxPipeline
from backscrub_tpu.pipeline.frame import PipelineConfig as JaxConfig
from backscrub_tpu.pipeline.geometry import compute_roi
from backscrub_tpu.pipeline.maskgen import MaskGen as JaxMaskGen
from backscrub_tpu_torch.graph.executor import load_model
from backscrub_tpu_torch.models.specs import spec_for_model
from backscrub_tpu_torch.ops.megakernel import _MAX_SMEM, body_plan_for
from backscrub_tpu_torch.pipeline import edge as tedge
from backscrub_tpu_torch.pipeline.frame import FramePipeline, PipelineConfig
from backscrub_tpu_torch.pipeline.maskgen import MaskGen

from test_torch_body_mega import _jax_mega, walk

ROOT = pathlib.Path(__file__).resolve().parent.parent
FULL = str(ROOT / "tests" / "data" / "selfie_synth_mlkit_256x256.tflite")
FRAME_TOL, MEAN_TOL, TIE = 0.02, 0.002, 1e-3
W, H = 640, 480


def _tools():
    tools = str(ROOT / "tools")
    if tools not in sys.path:
        sys.path.insert(0, tools)
    import make_synth_selfie
    return make_synth_selfie


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """The 256x256 plain ops run faster on 2 intra-op threads than on one
    per core when several test workers share the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    narrow = tmp_path_factory.mktemp("synth") / "selfie_synth_narrow_256x256.tflite"
    _tools().write_model(str(narrow), width=0.5, depth=4)
    return {"full": FULL, "narrow": str(narrow)}


def _pair(path):
    """(JAX model, port model, geometry, JAX info, port info) at 640x480."""
    jm, tm = jax_load_model(path), load_model(path, "cpu")
    geo = compute_roi(W, H, 256, 256, 256, 256)
    return (jm, tm, geo, jedge.edge_applicable(jm, jax_spec(path), geo),
            tedge.edge_applicable(tm, spec_for_model(path), geo))


def test_generator_structure():
    """The committed model: mlkit's shapes, spec and the op counts of
    make_synth_selfie's docstring (43 CONV_2D and 11 depthwise convs as in
    the MLKit file; no FULLY_CONNECTED, no CONCATENATION)."""
    m = load_model(FULL, "cpu")
    assert m.input_shape == (1, 256, 256, 3) and m.output_shape == (1, 256, 256, 1)
    spec = spec_for_model(FULL)
    assert (spec.kind, spec.decode, spec.threshold, spec.scale) == \
        ("selfie", "threshold", 0.65, 1 / 255.0)
    assert collections.Counter(n.kind for n in m.graph.nodes) == {
        "CONV_2D": 43, "DEPTHWISE_CONV_2D": 11, "AVERAGE_POOL_2D": 9, "LOGISTIC": 10,
        "MUL": 9, "ADD": 9, "HARD_SWISH": 17, "RELU": 9, "RESIZE_BILINEAR": 3,
        "Convolution2DTransposeBias": 1}
    g = m.graph
    assert [n.kind for n in g.nodes[-2:]] == ["Convolution2DTransposeBias", "LOGISTIC"]
    assert tuple(g.tensor(g.nodes[0].outputs[0]).shape) == (1, 128, 128, 16)
    assert tuple(g.tensor(g.nodes[-2].inputs[0]).shape) == (1, 128, 128, 16)


def test_edge_info_and_megakernel_match_jax(models):
    """Both packages detect the fused front and the threshold tail alike,
    and both take the full-span body kernel (JAX ``body_mega_for``, the
    port's one-launch plan), at both widths."""
    for path in models.values():
        jm, tm, geo, jinfo, tinfo = _pair(path)
        assert dataclasses.asdict(tinfo) == dataclasses.asdict(jinfo)
        assert tinfo.front_ok and tinfo.tail_ok and tinfo.tail_kind == "threshold"
        assert tinfo.tail_threshold == pytest.approx(np.log(0.65 / 0.35))
        assert (tinfo.conv_oh, tinfo.conv_ow) == (128, 128)
        mega = body_mega_for(jm, jinfo, interpret=True)
        plan = body_plan_for(tm, tinfo)
        assert mega is not None and plan is not None
        assert [p[0] for p in plan.plan] == [p[0] for p in mega.plan]
        assert mega.rs == 256          # the 128-wide first stage's row stride
        port = MaskGen(path, W, H, device="cpu")
        assert port.edge is not None and port.edge.body_plan is not None


def test_host_params_equal_jax():
    """The port's loader reads the same .tflite: every host parameter (the
    f16 weights dequantized, the edge layers' layouts) equals the JAX
    loader's."""
    jm, tm = jax_load_model(FULL), load_model(FULL, "cpu")
    assert set(tm.host_params) == set(jm.host_params)
    for k, v in jm.host_params.items():
        np.testing.assert_array_equal(np.asarray(tm.host_params[k]), np.asarray(v), err_msg=k)


def test_table_structure():
    """The full-width body: one bs_body_mega launch a run over a table
    that fits the kernel's shared memory; every squeeze-excite gate fused
    into the conv that reads it or kept as its pooled FC ops, the three
    decoder ADDs and resizes in the table."""
    tm, tinfo = _pair(FULL)[1::3]
    plan = body_plan_for(tm, tinfo)
    mt = plan.mega
    assert plan.launches_per_run == 1 and dict(plan.kernels_per_run) == {"bs_body_mega": 1}
    assert mt.covered == list(range(len(plan.plan)))
    assert mt.smem_bytes <= _MAX_SMEM
    kinds = collections.Counter(m["kind"] for m in mt.ops)
    assert kinds["dw"] == 11 and kinds["resize"] == 3
    assert (plan.in_meta.c, plan.in_meta.rows, plan.in_meta.w) == (16, 128, 128)
    assert (plan.out_meta.c, plan.out_meta.rows, plan.out_meta.w) == (16, 128, 128)


@pytest.mark.parametrize("which", ["narrow", "full"])
def test_body_table_walker_matches_plain_and_jax(models, which):
    """The op table walked phase by phase equals run_plain (atol 1e-5);
    on the narrow model both equal the JAX BodyMega in interpret mode
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


def test_threshold_tail_matches_jax(models):
    """The one-channel tail: phase dot, threshold decode and the EMA bit
    trick equal to the JAX tail (the EMA converted from its quadrant
    layout, ema_q[a, b, i, j] = ema[2i+a, 2j+b]); tail_logits is the value
    the decode compares."""
    path = models["narrow"]
    jm, tm, geo, jinfo, tinfo = _pair(path)
    je = jedge.EdgeFused(jm, geo, jax_spec(path), jinfo, mega=False, interpret=True)
    te = tedge.EdgeFused(tm, geo, spec_for_model(path), tinfo, device="cpu")
    rng = np.random.default_rng(4)
    k = jm.graph.tensor(jinfo.body_out_tensor).shape[3]
    ema_q = np.full((2, 2, 128, 128), 255, np.uint8)
    ema = torch.full((256, 256), 255, dtype=torch.uint8)
    for _ in range(3):
        body = rng.standard_normal((128, 128, k)).astype(np.float32)
        ema_q = np.asarray(je.tail(jnp.asarray(body), jnp.asarray(ema_q)))
        bt = torch.from_numpy(body.reshape(-1, k).T.copy())
        person = te.tail_logits(bt) > tinfo.tail_threshold
        ema = te.tail(bt, ema)
        np.testing.assert_array_equal(ema.numpy(), ema_q.transpose(2, 0, 3, 1).reshape(256, 256))
        assert torch.equal((ema >> 5) == 0, person)
        assert 0.05 < float(person.float().mean()) < 0.95


def post_ties(ema, geo):
    """The frame pixels (H, W) bool whose post value is a near x.5 tie: the
    crop of the EMA through the post's two f32 fold-blur matrices (those
    of both packages), computed in float64, within 1e-5 of x.5.  f32
    summation moves such a value across x.5 one way or the other; on these
    sequences the values lie within 5e-6 of x.5 or further than 1e-4."""
    o, r = geo.out_roi, geo.roi
    ah, aw = (a.astype(np.float64) for a in tedge.fold_blur_matrices(o.h, o.w, r.h, r.w))
    y = ah @ np.asarray(ema, np.float64)[o.y:o.y + o.h, o.x:o.x + o.w] @ aw.T
    ties = np.zeros((geo.frame_h, geo.frame_w), bool)
    ties[r.y:r.y + r.h, r.x:r.x + r.w] = np.abs(y - np.floor(y) - 0.5) < 1e-5
    return ties


class _Bars:
    """The bars of the module docstring, frame by frame: the decode flip
    rule on the EMAs, then masks and YUYV byte by byte."""

    def __init__(self, shape):
        self.ever = np.zeros(shape, bool)
        # differing bytes a frame: the share off the post's ties, and how
        # many lie neither at a tie nor in a flip's footprint
        self.fracs, self.off_ties, self.elsewhere, self.flips = [], [], [], 0

    def ema(self, got, ref, margin):
        got, ref = np.asarray(got), np.asarray(ref)
        flipped = (got >> 5) != (ref >> 5)
        assert (np.abs(margin[flipped]) <= TIE).all()
        self.ever |= flipped
        self.flips += int(flipped.sum())
        assert np.array_equal(got[~self.ever], ref[~self.ever])

    def bytes(self, pairs, feet=None):
        """((port, reference), ties) of one frame: u8 pairs, each with its
        bytes at the post's ties (bool, the pair's shape).  ``feet``, where
        given, a bool array a pair: the bytes that the frame's decode flips
        reach through the post, where a byte may be off by more than 1."""
        for ((a, b), t), f in zip(pairs, feet or [None] * len(pairs)):
            a, b = np.asarray(a), np.asarray(b)
            assert a.shape == b.shape == t.shape and a.dtype == b.dtype == np.uint8
            d = np.abs(a.astype(int) - b.astype(int))
            assert int((d if f is None else np.where(f, 0, d)).max()) <= 1
        d = np.concatenate([(np.asarray(a) != np.asarray(b)).ravel() for (a, b), _ in pairs])
        t = np.concatenate([t.ravel() for _, t in pairs])
        f = np.concatenate([g.ravel() for g in feet]) if feet else np.zeros_like(d)
        assert d.mean() <= FRAME_TOL
        self.fracs.append(float(d.mean()))
        self.off_ties.append(float((d & ~t).mean()))
        self.elsewhere.append(int((d & ~t & ~f).sum()))

    def check(self):
        assert float(np.mean(self.off_ties)) <= MEAN_TOL


def _yuyv(pixels):
    """A frame's pixels (H, W) as its YUYV bytes (H, 2W): a pixel pair's four
    bytes wherever either pixel is marked."""
    h, w = pixels.shape
    return np.repeat(pixels.reshape(h, w // 2, 2).any(-1), 4, axis=1)


def _quadrant_to_std(ema_q):
    q = np.asarray(ema_q)
    return q.transpose(2, 0, 3, 1).reshape(2 * q.shape[2], 2 * q.shape[3])


def _jax_logit_margin(jp, frame):
    """The JAX classic path's decode margin a pixel: the logit of the
    model's probability less logit(0.65), float64."""
    mg = jp.maskgen
    from backscrub_tpu.pipeline.maskgen import preprocess
    p = np.asarray(mg.model(preprocess(frame, mg.geo, mg.spec)[None]), np.float64)[0, ..., 0]
    return np.log(p / (1 - p)) - np.log(0.65 / 0.35)


def _run(path, n, refs):
    frames = _tools().moving_frames(W, H, n)
    bg = np.random.default_rng(5).integers(0, 256, (H, W, 3), np.uint8)
    port = FramePipeline(path, PipelineConfig(width=W, height=H), device="cpu")
    e = port.maskgen.edge
    assert e is not None and e.body_plan is not None and e.info.tail_kind == "threshold"
    jax_pipes = {}
    if "fused" in refs:
        jax_pipes["fused"] = JaxPipeline(path, JaxConfig(
            width=W, height=H, edge_fused=True, edge_interpret=True, pack_interpret=True))
        assert jax_pipes["fused"].maskgen.edge.mega is not None
    if "classic" in refs:
        jax_pipes["classic"] = JaxPipeline(path, JaxConfig(
            width=W, height=H, edge_fused=False, fused_pack=False))
    bars = {k: _Bars((256, 256)) for k in jax_pipes}
    person = []
    for f in frames:
        yuyv, mask = port.step(f, bg)
        r = port.geo.roi
        person.append(float((mask[r.y:r.y + r.h, r.x:r.x + r.w] < 128).float().mean()))
        ema = port.maskgen.ema.numpy()
        with torch.no_grad():
            body = e.body(e.front(torch.from_numpy(f)))
            margin = (e.tail_logits(body.reshape(body.shape[0], -1))
                      - e.info.tail_threshold).numpy()
        for name, jp in jax_pipes.items():
            jy, jm = jp.step(f, bg)
            jema = jp.maskgen.ema
            if name == "fused":
                jema, m = _quadrant_to_std(jema), margin
            else:       # a flip must be a near-tie on both sides
                m = np.maximum(np.abs(margin), np.abs(_jax_logit_margin(jp, f)))
            bars[name].ema(ema, jema, m)
            ties = post_ties(np.asarray(jema), port.geo)
            bars[name].bytes([((mask.numpy(), jm), ties), ((yuyv.numpy(), jy), _yuyv(ties))])
    for b in bars.values():
        b.check()
    # a mask that is all one value would make the comparison vacuous
    assert 0.1 <= person[0] <= 0.9, person
    return bars


def test_slice_matches_both_jax_paths(models):
    """Eight frames at 640x480 of the narrow model through the port's
    FramePipeline (K1, K2 plain versions, the threshold tail, K3's plain
    version) against the JAX fused path (interpret mode) and the JAX
    classic path, under the module's bars."""
    bars = _run(models["narrow"], 8, ("fused", "classic"))
    for b in bars.values():
        assert max(b.off_ties) == 0.0


def test_full_width_matches_jax_classic():
    """Four frames of the committed full-width model against the JAX
    classic path (the JAX fused path in interpret mode is left to the
    narrow model), under the module's bars."""
    bars = _run(FULL, 4, ("classic",))
    assert max(bars["classic"].off_ties) == 0.0


def test_references_differ_only_at_post_ties(models):
    """What the module's sequence clause rests on: the JAX package's fused
    and classic paths agree on the EMA and differ on mask bytes only at the
    post's exact x.5 ties, by 1."""
    path = models["narrow"]
    frames = _tools().moving_frames(W, H, 4)
    bg = np.random.default_rng(5).integers(0, 256, (H, W, 3), np.uint8)
    fused = JaxPipeline(path, JaxConfig(width=W, height=H, edge_fused=True,
                                        edge_interpret=True, pack_interpret=True))
    classic = JaxPipeline(path, JaxConfig(width=W, height=H, edge_fused=False,
                                          fused_pack=False))
    differ = 0
    for f in frames:
        _, mf = fused.step(f, bg)
        _, mc = classic.step(f, bg)
        ema = np.asarray(classic.maskgen.ema)
        assert np.array_equal(_quadrant_to_std(fused.maskgen.ema), ema)
        d = mf != mc
        assert int(np.abs(mf.astype(int) - mc.astype(int)).max()) <= 1
        assert not (d & ~post_ties(ema, fused.maskgen.geo)).any()
        differ += int(d.sum())
    assert differ > 0


def test_staged_maskgen_matches_jax_classic():
    """The staged MaskGen (fused=False, hooks in order) on the full-width
    model against the JAX classic MaskGen: EMAs under the flip rule, masks
    under the module's bars."""
    calls = []
    port = MaskGen(FULL, W, H, fused=False, device="cpu",
                   onprep=lambda: calls.append("prep"), oninfer=lambda: calls.append("infer"))
    ref = JaxMaskGen(FULL, W, H, fused=False)
    assert port.edge is None
    bars = _Bars((256, 256))
    for f in _tools().moving_frames(W, H, 3):
        mask = port.process(f)
        jm = np.asarray(ref.process(f))
        ema = port.ema.numpy()
        with torch.no_grad():
            p = port._infer(port._pre(torch.from_numpy(f)))[..., 0].double().numpy()
        bars.ema(ema, np.asarray(ref.ema), np.log(p / (1 - p)) - np.log(0.65 / 0.35))
        bars.bytes([((mask.numpy(), jm), post_ties(np.asarray(ref.ema), port.geo))])
    bars.check()
    assert calls == ["prep", "infer"] * 3


def test_generator_reproduces_the_committed_file(tmp_path):
    """``write_model`` (the draw and the tail bias calibrated through the
    JAX reference) writes the committed bytes, and the calibration puts
    frame 0's median logit over the ROI at logit(0.65) within the f16
    bias's rounding."""
    mk = _tools()
    out = mk.write_model(str(tmp_path / "selfie_synth_mlkit_256x256.tflite"))
    with open(out, "rb") as got, open(FULL, "rb") as want:
        assert got.read() == want.read()
    med = mk.calibrate_tail_bias(FULL, mk.moving_frames(320, 240, 1)[0])
    assert abs(med - np.log(0.65 / 0.35)) < 1e-2
