"""The PyTorch port's deeplab path (K1 front, K2' prefix, K2'' flat
continuation, graph executor for the 33->257 resize) against the JAX
package, on the committed synthetic deeplabv3_257-shaped model.

References: the JAX prefix megakernel (``body_mega_prefix_for``) and the
flat continuation chain (``body_mega_continuation_for``) in interpret
mode, the JAX span lowerings (XLA f32 on the CPU), and the JAX
``FramePipeline`` on the fused path (``edge_cont=True``, Pallas in
interpret mode) and on the classic path.

Bars: the prefix allclose(atol=2e-3, rtol=1e-3), the bar of the body
megakernel tests; the continuation the same bar against the JAX span
lowerings (both f32) and allclose(atol=2e-2, rtol=1e-2) against the JAX
chain, whose dots emulate XLA's HIGH precision as three bf16 passes
(products carry ~2^-16 relative error, summed over up to 512 terms);
masks, EMA and YUYV under the repo's tolerance invariant (at most 2% of a
frame's bytes differ, at most 0.2% over the sequence).

Both plans run on the card as one launch of the persistent kernel each;
their op tables are walked here on the CPU (``walk`` of
tests/test_torch_body_mega.py) against ``run_plain`` and the JAX kernels.
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
from backscrub_tpu.models import specs as jspecs
from backscrub_tpu.ops import megakernel as jmega
from backscrub_tpu.pipeline import edge as jedge
from backscrub_tpu.pipeline.frame import FramePipeline as JaxPipeline
from backscrub_tpu.pipeline.frame import PipelineConfig as JaxConfig
from backscrub_tpu.pipeline.geometry import compute_roi
from backscrub_tpu.pipeline.maskgen import MaskGen as JaxMaskGen
from backscrub_tpu_torch.graph.executor import load_model, params_from_jax
from backscrub_tpu_torch.models import specs
from backscrub_tpu_torch.ops import megakernel as tmega
from backscrub_tpu_torch.ops.megakernel import (_MAX_SMEM, _WG_TILES, MEGA_CODES,
                                                MEGA_FIELDS, BodyPlan, Unsupported,
                                                body_plan_continuation_for,
                                                body_plan_prefix_for)
from backscrub_tpu_torch.pipeline import edge as tedge
from backscrub_tpu_torch.pipeline.frame import FramePipeline, PipelineConfig
from backscrub_tpu_torch.pipeline.maskgen import MaskGen

from test_torch_body_mega import walk

ROOT = pathlib.Path(__file__).resolve().parent.parent
DEEPLAB = str(ROOT / "tests" / "data" / "deeplab_synth_257.tflite")
FRAME_TOL, MEAN_TOL = 0.02, 0.002
_F = {f: i for i, f in enumerate(MEGA_FIELDS)}


def _tools():
    tools = str(ROOT / "tools")
    if tools not in sys.path:
        sys.path.insert(0, tools)
    import make_synth_deeplab
    return make_synth_deeplab


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """The 257x257 plain ops run much faster on 2 intra-op threads than on
    one per core when several test workers share the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    """(JAX model at the deeplab spec's HIGH precision, port model, JAX
    edge info, port edge info) at 640x480."""
    jm = jax_load_model(DEEPLAB, precision=jax.lax.Precision.HIGH)
    tm = load_model(DEEPLAB, "cpu")
    geo = compute_roi(640, 480, 257, 257, 257, 257)
    jinfo = jedge.edge_applicable(jm, jspecs.spec_for_model(DEEPLAB), geo)
    tinfo = tedge.edge_applicable(tm, specs.spec_for_model(DEEPLAB), geo)
    return jm, tm, jinfo, tinfo


@pytest.fixture(scope="module")
def cuts(pair):
    """The JAX prefix megakernel and continuation chain (interpret mode)
    and the port's prefix and continuation plans, both at deeplab's
    precision, HIGH (the continuation's GEMMs bf16x3)."""
    jm, tm, jinfo, tinfo = pair
    jpre = jmega.body_mega_prefix_for(jm, jinfo, interpret=True)
    jcont = jmega.body_mega_continuation_for(jm, jinfo, jpre[1], jpre[2], interpret=True)
    tpre = body_plan_prefix_for(tm, tinfo, precision="high")
    tcont = body_plan_continuation_for(tm, tinfo, tpre[1], tpre[2], precision="high")
    return jpre, jcont, tpre, tcont


def test_generator_structure():
    """The folded graph is what the JAX package's deeplab tests and
    SURVEY.md 2.2 assume of deeplabv3_257_mv_gpu.tflite."""
    g = load_model(DEEPLAB, "cpu").graph
    assert len(g.nodes) == 70
    assert collections.Counter(n.kind for n in g.nodes) == {
        "CONV_2D": 38, "DEPTHWISE_CONV_2D": 17, "ADD": 10, "AVERAGE_POOL_2D": 1,
        "CONCATENATION": 1, "RESIZE_BILINEAR": 3}
    assert specs.spec_for_model(DEEPLAB).kind == "deeplab"
    shape = {i: tuple(g.tensor(n.outputs[0]).shape) for i, n in enumerate(g.nodes)}
    assert shape[0] == (1, 129, 129, 16) and shape[69] == (1, 257, 257, 21)
    n25 = g.nodes[25]
    assert n25.kind == "DEPTHWISE_CONV_2D" and n25.options["dilation_h"] == 2
    dil4 = [i for i, n in enumerate(g.nodes) if n.kind == "DEPTHWISE_CONV_2D"
            and n.options["dilation_h"] == 4]
    assert dil4 == [51, 55, 59] and all(shape[i][3] == 480 for i in dil4)
    assert g.nodes[61].kind == "AVERAGE_POOL_2D" and shape[61] == (1, 1, 1, 160)
    assert g.nodes[63].kind == "RESIZE_BILINEAR" and shape[63] == (1, 33, 33, 256)
    assert g.nodes[65].kind == "CONCATENATION" and shape[65] == (1, 33, 33, 512)
    assert g.nodes[68].kind == "RESIZE_BILINEAR" and shape[68] == (1, 33, 33, 21)
    assert g.nodes[68].options["align_corners"]
    assert shape[12] == (1, 33, 33, 16) and shape[13] == (1, 33, 33, 96)


def test_generator_reproduces_the_committed_file(tmp_path):
    """``write_model`` (the draw, the ridge fit of the person logit and its
    bias) writes the committed bytes, and the fitted logit decodes frame 0
    to a person share of the ROI inside 0.2-0.8 that follows the figure."""
    mk = _tools()
    out = mk.write_model(str(tmp_path / "deeplab_synth_257.tflite"))
    with open(out, "rb") as got, open(DEEPLAB, "rb") as want:
        assert got.read() == want.read()
    frame = mk.moving_frames(320, 240, 1)[0]
    person = mk.person_margin(DEEPLAB, frame) > 0
    assert 0.2 <= float(person.mean()) <= 0.8
    target = mk.person_target(frame, 0, 257)
    assert float((person == target).mean()) > 0.9


def test_params_from_jax(pair):
    jm, tm = pair[0], load_model(DEEPLAB, "cpu")
    p = params_from_jax(jm.params)
    assert set(p) == set(tm.params)
    tm.params = p
    x = np.random.default_rng(1).uniform(-1, 1, (1, 257, 257, 3)).astype(np.float32)
    jf = jax_load_model(DEEPLAB)      # HIGHEST: the f32 reference
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jf(x)), atol=1e-4, rtol=1e-4)


def test_edge_info_matches_jax(pair):
    _, _, jinfo, tinfo = pair
    assert dataclasses.asdict(tinfo) == dataclasses.asdict(jinfo)
    assert tinfo.front_ok and not tinfo.tail_ok
    assert (tinfo.conv_oh, tinfo.conv_ow, tinfo.front_activation) == (129, 129, "RELU6")


def test_cut_points_match_jax(cuts):
    (jp, jcut, jtid), (jlinks, jend, jout), (tp, tcut, ttid), (tc, tend, tout) = cuts
    assert (tcut, ttid) == (jcut, jtid) and tcut == 13
    assert (tend, tout) == (jend, jout) and tend == 69
    assert sum(len(mk.plan) for mk in jlinks) == len(tc.plan) == 56
    assert [p[0] for p in tp.plan] == [p[0] for p in jp.plan]
    assert [p[0] for p in tc.plan] == [p[0] for mk in jlinks for p in mk.plan]
    assert tp.out_meta.sp == jp.out_meta.sp == 4 and (tp.out_meta.rows, tp.out_meta.w) == (33, 33)
    # each plan is one launch of the persistent kernel; K2'''s table has
    # GEMM ops for the spatial 1x1 convs, the broadcast, and depthwise
    # convs at dilation 1, 2 and 4
    assert dict(tc.kernels_per_run) == dict(tp.kernels_per_run) == {"bs_body_mega": 1}
    assert tc.mega.kinds["gemm"] == 29 and tp.mega.kinds["gemm"] == 0
    assert [m.get("bn") for m in tc.mega.ops if m["kind"] == "fc"] == [33 * 33]
    assert {p[8] for p in tc.plan if p[0] == "dw"} == {1, 2, 4}


def test_continuation_concat_is_homed(cuts):
    """The ASPP concat's operands (the broadcast and a 1x1 conv) are
    written in place inside the concat's block: no copies, and the
    broadcast sits in the first 256 channels."""
    tc = cuts[3][0]
    (concat,) = [p for p in tc.plan if p[0] == "concat"]
    (bcast,) = [p for p in tc.plan if p[0] == "bcast"]
    tins, tout = concat[1], concat[2]
    assert tins[0] == bcast[2] and tc._copies[tout] == []
    assert tc._offsets[tins[0]] == tc._offsets[tout]
    assert tc._offsets[tins[1]] == tc._offsets[tout] + 256 * 33 * 33
    assert tc.launches_per_run == 1 and tc.mega.kinds["copy"] == 0


def _rowpad(x, rs):
    c, h, w = x.shape
    xr = np.zeros((c, h * rs), np.float32)
    for i in range(h):
        xr[:, i * rs:i * rs + w] = x[:, i]
    return xr


def _unrowpad(y, meta, rs):
    return np.stack([y[:, i * rs + np.arange(meta.w) * meta.sp]
                     for i in range(meta.rows)], axis=1)


@pytest.fixture(scope="module")
def prefix_ref(cuts):
    """A seeded prefix input (16, 129, 129) and the JAX prefix megakernel's
    output on it (interpret mode), (16, 33, 33)."""
    jp = cuts[0][0]
    x = np.random.default_rng(3).uniform(0, 6, (16, 129, 129)).astype(np.float32)
    ref = _unrowpad(np.asarray(jax.jit(jp)(jnp.asarray(_rowpad(x, jp.rs)))),
                    jp.out_meta, jp.rs)
    return x, ref


@pytest.fixture(scope="module")
def cont_ref(pair, cuts):
    """A seeded continuation input (16, 33, 33) and on it the JAX span
    lowerings (f32 on the CPU: the edge_cont=False remainder) and the JAX
    chain (edge_cont=True, bf16x3 dots, interpret mode), each (21, 33, 33)."""
    jm = pair[0]
    jlinks, jend, jout = cuts[1]
    _, cut, cut_tid = cuts[2]
    x = (np.random.default_rng(4).standard_normal((16, 33, 33)) * 0.5).astype(np.float32)
    span = jedge._make_span_fn(jm, cut, jend, cut_tid, jout)
    f32 = np.asarray(jax.jit(span)(jm.params, jnp.asarray(x.transpose(1, 2, 0)[None])))
    h = jnp.asarray(x.reshape(16, -1))
    for mk in jlinks:
        h = jax.jit(mk)(h)
    return x, f32[0].transpose(2, 0, 1), np.asarray(h).reshape(21, 33, 33)


def test_prefix_matches_jax_interpret(cuts, prefix_ref):
    tp = cuts[2][0]
    x, ref = prefix_ref
    with torch.no_grad():
        got = tp(torch.from_numpy(x.reshape(16, -1))).reshape(16, 33, 33).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-3, rtol=1e-3)


def test_continuation_matches_jax(cuts, cont_ref):
    tc = cuts[3][0]
    x, f32, chain = cont_ref
    with torch.no_grad():
        got = tc(torch.from_numpy(x.reshape(16, -1))).reshape(21, 33, 33).numpy()
    np.testing.assert_allclose(got, f32, atol=2e-3, rtol=1e-3)
    np.testing.assert_allclose(got, chain, atol=2e-3, rtol=1e-3)


def _walked(plan, x, gemm="f32"):
    """``plan``'s op table walked on the CPU on ``x``, and run_plain on it
    with its flat GEMMs in ``gemm`` precision."""
    xt = torch.from_numpy(x.reshape(plan.in_meta.c, -1))
    with torch.no_grad():
        got, phases = walk(plan, xt)
        plain = plan.run_plain(xt, gemm)
    assert phases == plan.mega.phases
    assert bool(torch.isfinite(got).all())
    return got, plain


def test_prefix_table_walker_matches_plain_and_jax(cuts, prefix_ref):
    """The prefix's op table (f32 convs at 129x129 and 65x65) walked phase
    by phase: atol 1e-5 of run_plain (the same f32 operations, fused), the
    body bar of the JAX prefix kernel."""
    tp = cuts[2][0]
    x, ref = prefix_ref
    got, plain = _walked(tp, x)
    torch.testing.assert_close(got, plain, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got.reshape(16, 33, 33).numpy(), ref, atol=2e-3, rtol=1e-3)


def test_continuation_table_walker_matches_plain_and_jax(cuts, cont_ref):
    """The continuation's op table, its 29 GEMM ops in the bf16x3 split,
    walked phase by phase: atol 1e-5 of run_plain(gemm="bf16x3") (the same
    operations, fused: the prefix walker's bar), the body bar against
    run_plain's f32 GEMMs and the JAX chain (the same split)."""
    tc = cuts[3][0]
    x, _, chain = cont_ref
    got, matched = _walked(tc, x, "bf16x3")
    torch.testing.assert_close(got, matched, atol=1e-5, rtol=0)
    f32 = tc.run_plain(torch.from_numpy(x.reshape(16, -1)))
    torch.testing.assert_close(got, f32, atol=2e-3, rtol=1e-3)
    np.testing.assert_allclose(got.reshape(21, 33, 33).numpy(), chain, atol=2e-3, rtol=1e-3)


def test_continuation_bf16x3_noise_floor(cuts, cont_ref, monkeypatch):
    """Why the card holds K2'' to run_plain(gemm="bf16x3") at max-abs 2e-3
    and mean-abs 1e-4 (chip_smoke.py MATCHED_*), not tighter: the split
    rounds each GEMM input's low half to bf16, so a one-ulp nudge of the
    continuation's input (what another summation order upstream gives)
    moves the bf16x3 plan more than 5x as far as the f32 one, to at most
    half the max bar and half the mean bar.  A GEMM that drops a cross
    term moves the mean by more than 10x the mean bar."""
    tc = cuts[3][0]
    x = torch.from_numpy(cont_ref[0].reshape(16, -1))
    sign = np.random.default_rng(0).choice([-1.0, 1.0], tuple(x.shape)).astype(np.float32)
    nudged = torch.nextafter(x, x + torch.from_numpy(sign) * 1e30)
    with torch.no_grad():
        matched, f32 = tc.run_plain(x, "bf16x3"), tc.run_plain(x)
        moved = (tc.run_plain(nudged, "bf16x3") - matched).abs()
        moved_f32 = (tc.run_plain(nudged) - f32).abs()
    assert float(moved.max()) > 5 * float(moved_f32.max())
    assert float(moved.max()) <= 1e-3 and float(moved.mean()) <= 5e-5

    split, calls = tmega.conv1x1_bf16x3_plain, []

    def drop_lo_hi(w, b, x, act="NONE", split_w=None):
        calls.append(1)
        if len(calls) != 15:
            return split(w, b, x, act, split_w)
        wh = w.to(torch.bfloat16).float()
        xh = x.to(torch.bfloat16).float()
        return tmega.apply_activation(wh @ xh + wh @ (x - xh).to(torch.bfloat16).float()
                                      + b[:, None], act)
    monkeypatch.setattr(tmega, "conv1x1_bf16x3_plain", drop_lo_hi)
    with torch.no_grad():
        buggy = tc.run_plain(x, "bf16x3")
    assert len(calls) == 29 and float((buggy - matched).abs().mean()) > 1e-3


@pytest.mark.parametrize("which", ["prefix", "cont"])
def test_deeplab_tables_structure(cuts, which):
    """Each deeplab plan is one bs_body_mega launch over a table that covers
    every plan op, with no copy op (the ASPP concat is homed).  The prefix
    keeps f32 convs, column-wise (``convw``) at 129x129 and 65x65 and tiled
    at 33x33, its residual ADD in a conv's epilogue; the
    continuation has its 29 spatial 1x1 convs as ``gemm`` ops, each tile
    grid at most one round of 132 CTAs, depthwise convs at dilations 1, 2
    and 4, each a round of items, the ASPP pool -> 1x1 -> broadcast as
    gpool and an fc that writes its broadcast, and its 9 residual ADDs in
    GEMM epilogues (the model's 10th is the prefix's)."""
    plan = cuts[2][0] if which == "prefix" else cuts[3][0]
    mt = plan.mega
    assert dict(plan.kernels_per_run) == {"bs_body_mega": 1} and plan.launches_per_run == 1
    assert mt.covered == list(range(len(plan.plan)))
    assert int(mt.table[:, _F["sync"]].sum()) + 1 == mt.phases
    assert mt.table[-1, _F["sync"]] == 0 and mt.smem_bytes <= _MAX_SMEM
    dils = {int(r[_F["d"]]) for r in mt.table if r[_F["code"]] == MEGA_CODES["dw"]}
    fused = sum(m["res"] is not None for m in mt.ops)
    if which == "prefix":
        assert dict(mt.kinds) == {"convw": 6, "conv": 1, "dw": 4} and dils == {1}
        assert fused == 1
        assert mt.phases == 11
        return
    assert dict(mt.kinds) == {"gemm": 29, "dw": 13, "gpool": 1, "fc": 1}
    assert dils == {1, 2, 4} and fused == 9 and mt.phases == 43
    for r in mt.table[mt.table[:, _F["code"]] == MEGA_CODES["dw"]]:
        bands = -(-r[_F["oh"]] // r[_F["band"]])
        assert bands * -(-r[_F["c"]] // r[_F["cpi"]]) <= 132
    assert all(m["kind"] == "gemm" for m in mt.ops if m["res"] is not None)
    rings = []
    for r in mt.table[mt.table[:, _F["code"]] == MEGA_CODES["gemm"]]:
        bn = _WG_TILES[r[_F["tile"]]]
        assert -(-r[_F["co"]] // bn) * -(-r[_F["n"]] // 64) <= 132
        rings.append(tmega._wg_smem_bytes(bn, tmega.DOT_MODES[plan.dots][1]))
    assert mt.table.nbytes + max(rings) <= mt.smem_bytes <= _MAX_SMEM


def test_plan_guards(pair):
    """The reference's guards (tests/test_edge.py's prefix rejects): an
    anisotropic-dilation DW raises while the isotropic original builds;
    flat spans reject stride-2 DWs and geometry-changing resizes; a prefix
    span's coarser reference spacing needs allow_spaced_output.  (The
    reference's quantized-model reject has no counterpart: the port loads
    float models only.)"""
    tm, tinfo = pair[1], pair[3]
    g = tm.graph
    node = g.nodes[25]
    orig = dict(node.options)
    try:
        node.options["dilation_w"] = 1
        with pytest.raises(Unsupported, match="anisotropic"):
            BodyPlan(tm, 24, 27, g.nodes[24].inputs[0], g.nodes[26].outputs[0])
    finally:
        node.options.clear()
        node.options.update(orig)
    BodyPlan(tm, 24, 27, g.nodes[24].inputs[0], g.nodes[26].outputs[0], flat=True)
    with pytest.raises(Unsupported, match="flat dw stride"):
        BodyPlan(tm, 1, 13, tinfo.body_in_tensor, g.nodes[12].outputs[0], flat=True)
    with pytest.raises(Unsupported, match="flat geometry-changing resize"):
        BodyPlan(tm, 13, 70, g.nodes[13].inputs[0], g.outputs[0], flat=True)
    with pytest.raises(Unsupported, match="spacing"):
        BodyPlan(tm, 1, 13, tinfo.body_in_tensor, g.nodes[12].outputs[0])


def test_spec_edge_cont_matches_jax():
    for kind, spec in specs._SPECS.items():
        assert spec.edge_cont == jspecs._SPECS[kind].edge_cont, kind
    assert specs.spec_for_model(DEEPLAB).edge_cont
    for field in ("edge_fused", "edge_mega", "edge_cont"):
        assert getattr(PipelineConfig(), field) == getattr(JaxConfig(), field) is None


@pytest.mark.parametrize("mega,cont,plans", [
    (None, None, ("prefix", "cont")), (None, True, ("prefix", "cont")),
    (None, False, ("prefix",)), (False, None, ())])
def test_switches_match_jax(mega, cont, plans):
    """edge_mega / edge_cont pick the same stages as in the JAX package;
    the graph executor runs whatever no plan covers."""
    port = MaskGen(DEEPLAB, 640, 480, edge_mega=mega, edge_cont=cont,
                   device="cpu").edge
    ref = JaxMaskGen(DEEPLAB, 640, 480, edge_fused=True, edge_interpret=True,
                     edge_mega=mega, edge_cont=cont).edge
    assert (port.prefix_plan is not None) == (ref.mega_prefix is not None) == ("prefix" in plans)
    assert (port.cont_plan is not None) == (ref.mega_cont is not None) == ("cont" in plans)
    assert port.body_plan is None and ref.mega is None
    assert port.rest is not None     # the 33->257 resize, at least


def test_mega_true_needs_the_full_span():
    """As in the JAX package, edge_mega=True demands the full-span body
    plan, which a front-only family does not have."""
    with pytest.raises(ValueError, match="mega=True"):
        MaskGen(DEEPLAB, 640, 480, edge_mega=True, device="cpu")


def test_continuation_that_fails_a_flat_guard_takes_the_classic_path(monkeypatch):
    """A deeplab model whose continuation fails a flat-plan guard at every
    cut (a stride-2 DW right after the prefix cut) gets no fused path with
    cont: EdgeFused and edge_fused=True raise, and auto mode runs the
    classic stages instead of handing the continuation to the executor.
    Without cont the prefix plan still fuses."""
    from backscrub_tpu_torch.pipeline import maskgen as tmaskgen

    def planted(path, device="cpu", **mode):
        m = load_model(path, device, **mode)
        node = m.graph.nodes[14]
        assert node.kind == "DEPTHWISE_CONV_2D" and node.options["stride_h"] == 1
        node.options.update(stride_h=2, stride_w=2)
        return m

    tm = planted(DEEPLAB)
    geo = compute_roi(640, 480, 257, 257, 257, 257)
    spec = specs.spec_for_model(DEEPLAB)
    info = tedge.edge_applicable(tm, spec, geo)
    _, cut, cut_tid = body_plan_prefix_for(tm, info)
    with pytest.raises(Unsupported, match="flat dw stride"):
        BodyPlan(tm, cut, 69, cut_tid, tm.graph.nodes[68].outputs[0], flat=True)
    assert body_plan_continuation_for(tm, info, cut, cut_tid) is None
    assert tedge.body_plans(tm, info, None, True) is None
    with pytest.raises(ValueError, match="BodyPlans"):
        tedge.EdgeFused(tm, geo, spec, info, cont=True, device="cpu")
    prefix_only = tedge.EdgeFused(tm, geo, spec, info, cont=False, device="cpu")
    assert prefix_only.prefix_plan is not None and prefix_only.cont_plan is None
    monkeypatch.setattr(tmaskgen, "load_model", planted)
    with pytest.raises(ValueError, match="edge_fused=True"):
        MaskGen(DEEPLAB, 640, 480, edge_fused=True, device="cpu")
    assert MaskGen(DEEPLAB, 640, 480, device="cpu").edge is None
    assert MaskGen(DEEPLAB, 640, 480, edge_cont=False,
                   device="cpu").edge.prefix_plan is not None


def test_table_that_does_not_compile_takes_the_classic_path(monkeypatch):
    """A plan whose op table does not fit the persistent kernel gets no
    fused path, never per-op kernels: with the continuation's table over
    the shared memory a CTA has, auto mode runs the classic stages and
    edge_fused=True raises, while without cont the prefix still fuses; with
    the prefix's depthwise windows over their capacity, not even that."""
    tm = load_model(DEEPLAB, "cpu")
    geo = compute_roi(640, 480, 257, 257, 257, 257)
    info = tedge.edge_applicable(tm, specs.spec_for_model(DEEPLAB), geo)
    _, cut, cut_tid = body_plan_prefix_for(tm, info)
    monkeypatch.setattr(tmega, "_MAX_SMEM", 64 * 1024)    # the continuation needs ~94 KB
    with pytest.raises(Unsupported, match="shared memory"):
        BodyPlan(tm, cut, 69, cut_tid, tm.graph.nodes[68].outputs[0], flat=True).compile_mega()
    assert body_plan_continuation_for(tm, info, cut, cut_tid) is None
    assert tedge.body_plans(tm, info, None, True) is None
    with pytest.raises(ValueError, match="edge_fused=True"):
        MaskGen(DEEPLAB, 640, 480, edge_fused=True, device="cpu")
    assert MaskGen(DEEPLAB, 640, 480, device="cpu").edge is None
    assert MaskGen(DEEPLAB, 640, 480, edge_cont=False, device="cpu").edge.prefix_plan is not None
    monkeypatch.setattr(tmega, "_DW_SMEM_FLOATS", 256)    # under a 129-wide window's 387
    assert body_plan_prefix_for(tm, info) is None
    assert MaskGen(DEEPLAB, 640, 480, edge_cont=False, device="cpu").edge is None


def test_post_footprint_bounds_what_an_ema_flip_moves():
    """Flipping a few EMA pixels' decode bits changes the mask only inside
    their post footprint, which stays a few dozen pixels each (the bar
    the on-card checks use for decode flips at near-ties)."""
    e = MaskGen(DEEPLAB, 640, 480, device="cpu").edge
    ema = torch.from_numpy(np.random.default_rng(7).integers(0, 256, (257, 257), np.uint8))
    moved, picked = ema.clone(), torch.zeros((257, 257), dtype=torch.bool)
    for i, j in ((0, 0), (100, 120), (128, 40), (256, 256)):
        moved[i, j] ^= 0xE0
        picked[i, j] = True
    foot = tedge.post_footprint(picked, e.geo, e.post_mats)
    changed = e.postprocess(ema) != e.postprocess(moved)
    assert bool(changed.any()) and not bool((changed & ~foot).any())
    assert int(foot.sum()) <= 4 * 100
    assert not bool(tedge.post_footprint(torch.zeros_like(picked), e.geo, e.post_mats).any())


class _Invariant:
    def __init__(self):
        self.fracs = []

    def add(self, a, b):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype == np.uint8
        frac = float((a != b).mean())
        assert frac <= FRAME_TOL, f"{100 * frac:.3f}% of a frame's bytes differ"
        self.fracs.append(frac)

    def check(self):
        assert float(np.mean(self.fracs)) <= MEAN_TOL


def test_slice_matches_both_jax_paths():
    """Five frames at 640x480 through the port's FramePipeline (K1, K2',
    K2'' plain versions on the CPU) against the JAX fused path
    (edge_cont=True, interpret mode) and the JAX classic path."""
    w, h = 640, 480
    frames = _tools().moving_frames(w, h, 5)
    bg = np.random.default_rng(5).integers(0, 256, (h, w, 3), np.uint8)
    port = FramePipeline(DEEPLAB, PipelineConfig(width=w, height=h), device="cpu")
    e = port.maskgen.edge
    assert e.prefix_plan is not None and e.cont_plan is not None and e.body_plan is None
    refs = {
        "fused": JaxPipeline(DEEPLAB, JaxConfig(width=w, height=h, edge_fused=True,
                                                edge_interpret=True, edge_cont=True,
                                                pack_interpret=True)),
        "classic": JaxPipeline(DEEPLAB, JaxConfig(width=w, height=h, edge_fused=False,
                                                  fused_pack=False))}
    assert refs["fused"].maskgen.edge.mega_cont is not None
    inv = {k: _Invariant() for k in refs}
    person = []
    for f in frames:
        yuyv, mask = port.step(f, bg)
        assert yuyv.shape == (h, 2 * w) and mask.shape == (h, w)
        r = port.geo.roi
        person.append(float((mask[r.y:r.y + r.h, r.x:r.x + r.w] < 128).float().mean()))
        for name, jp in refs.items():
            jy, jmask = jp.step(f, bg)
            inv[name].add(port.maskgen.ema.numpy(), jp.maskgen.ema)
            inv[name].add(mask.numpy(), jmask)
            inv[name].add(yuyv.numpy(), jy)
    for v in inv.values():
        v.check()
    assert all(0.1 <= p <= 0.9 for p in person), person
