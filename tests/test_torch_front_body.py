"""The port's fused front (K1's plain version) and body plan (K2's plain
version) against the JAX package's Pallas kernels in interpret mode and
its classic span lowerings, on the synthetic segm models.

Bars: front allclose(1e-4, 1e-4); body allclose(atol=2e-3, rtol=1e-3),
the bar of tests/test_edge.py's megakernel span test (summation order
differs between the lowerings).  The CUDA kernels are held against the
same plain versions on the card in tests/test_torch_cuda.py."""

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
from backscrub_tpu.pipeline.geometry import compute_roi
from backscrub_tpu.pipeline.maskgen import MaskGen as JaxMaskGen
from backscrub_tpu_torch.graph.executor import build_model, load_model
from backscrub_tpu_torch.models.specs import spec_for_model
from backscrub_tpu_torch.ops.megakernel import BodyPlan, Unsupported, body_plan_for
from backscrub_tpu_torch.pipeline import edge as tedge
from backscrub_tpu_torch.pipeline.maskgen import MaskGen

ROOT = pathlib.Path(__file__).resolve().parent.parent
FULL = ROOT / "tests" / "data" / "segm_synth_lite_96x160.tflite"


def _tools():
    tools = str(ROOT / "tools")
    if tools not in sys.path:
        sys.path.insert(0, tools)
    import make_synth_segm
    return make_synth_segm


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    narrow = tmp_path_factory.mktemp("synth") / "segm_synth_narrow_96x160.tflite"
    _tools().write_model(str(narrow), width=0.5, depth=4)
    return {"full": str(FULL), "narrow": str(narrow)}


def _pair(path, w, h):
    """(JAX model, port model, geometry, JAX info, port info)."""
    jm, tm = jax_load_model(path), load_model(path, "cpu")
    geo = compute_roi(w, h, 160, 96, 160, 96)
    jinfo = jedge.edge_applicable(jm, jax_spec(path), geo)
    tinfo = tedge.edge_applicable(tm, spec_for_model(path), geo)
    return jm, tm, geo, jinfo, tinfo


def test_jax_reference_runs_the_pallas_path(models):
    """The fixture must take the JAX fused edge path with the full-span
    body megakernel, so the references below run interpret-mode Pallas."""
    for path in models.values():
        mg = JaxMaskGen(path, 320, 240, edge_fused=True, edge_interpret=True)
        assert mg.edge.interpret
        assert mg.edge.info.front_ok and mg.edge.info.tail_ok
        assert mg.edge.mega is not None
        port = MaskGen(path, 320, 240, device="cpu")
        assert port.edge is not None and port.edge.body_plan is not None
        assert [p[0] for p in port.edge.body_plan.plan] == \
            [p[0] for p in mg.edge.mega.plan]


@pytest.mark.parametrize("which", ["full", "narrow"])
def test_detect_edge_matches_jax(models, which):
    for w, h in ((320, 240), (640, 480), (100, 640)):
        _, _, _, jinfo, tinfo = _pair(models[which], w, h)
        assert dataclasses.asdict(tinfo) == dataclasses.asdict(jinfo)
    # a 15-px-wide output crop keeps the fused tail off: where the JAX
    # package builds a prefix megakernel (narrow), auto mode runs the
    # front-only fused path with the prefix plan; where no cut of the body
    # has one tensor crossing it (full), the JAX package runs the front
    # kernel and its lowerings over the whole body, and so does the port:
    # K1, then the graph executor
    assert not tinfo.tail_ok
    port = MaskGen(models[which], 100, 640, device="cpu").edge
    ref = JaxMaskGen(models[which], 100, 640, edge_fused=True, edge_interpret=True).edge
    assert ref.mega is None and ref.mega_cont is None
    assert (ref.mega_prefix is None) == (which == "full")
    if which == "full":
        assert port.plans == [] and port.rest is not None
        assert MaskGen(models[which], 100, 640, edge_fused=True, device="cpu").edge is not None
    else:
        assert not port.info.tail_ok and port.body_plan is None
        assert port.prefix_plan is not None and port.cont_plan is None


def test_body_that_fails_a_plan_guard_takes_the_classic_path(models, monkeypatch):
    """A model whose edge layers fuse but whose body fails a BodyPlan guard
    (a standalone HARD_SWISH turned into a spatial LOGISTIC) gets no fused
    path: EdgeFused and edge_fused=True raise, and auto mode runs the
    classic stages, which match the port's plain graph run."""
    from backscrub_tpu_torch.pipeline import maskgen as tmaskgen

    def planted(path, device="cpu", **mode):
        m = load_model(path, device, **mode)
        next(n for n in m.graph.nodes[2:] if n.kind == "HARD_SWISH").op = "LOGISTIC"
        return m

    path = models["narrow"]
    tm = planted(path)
    geo = compute_roi(320, 240, 160, 96, 160, 96)
    info = tedge.edge_applicable(tm, spec_for_model(path), geo)
    assert info.front_ok and info.tail_ok
    with pytest.raises(Unsupported, match="spatial logistic"):
        BodyPlan(tm, info.body_start, info.body_end, info.body_in_tensor,
                 info.body_out_tensor)
    with pytest.raises(ValueError, match="BodyPlan"):
        tedge.EdgeFused(tm, geo, spec_for_model(path), info, device="cpu")
    monkeypatch.setattr(tmaskgen, "load_model", planted)
    with pytest.raises(ValueError, match="edge_fused=True"):
        MaskGen(path, 320, 240, edge_fused=True, device="cpu")
    auto = MaskGen(path, 320, 240, device="cpu")
    classic = MaskGen(path, 320, 240, edge_fused=False, device="cpu")
    assert auto.edge is None
    for f in _tools().moving_frames(320, 240, 2):
        assert torch.equal(auto.process(f), classic.process(f))


@pytest.mark.parametrize("which,w,h", [("narrow", 320, 240), ("narrow", 640, 480),
                                       ("full", 320, 240)])
def test_front_matches_jax_interpret(models, which, w, h):
    path = models[which]
    jm, tm, geo, jinfo, tinfo = _pair(path, w, h)
    je = jedge.EdgeFused(jm, geo, jax_spec(path), jinfo, mega=False, interpret=True)
    assert je.front_layout == "chw" and je.interpret
    te = tedge.EdgeFused(tm, geo, spec_for_model(path), tinfo, device="cpu")
    frames = _tools().moving_frames(w, h, 2)
    frames.append(np.random.default_rng(7).integers(0, 256, (h, w, 3), np.uint8))
    for f in frames:
        ref = np.asarray(jax.jit(je.front)(jnp.asarray(f)))     # (oh, ow, C)
        with torch.no_grad():
            got = te.front(torch.from_numpy(f))                  # (C, oh, ow)
        np.testing.assert_allclose(got.permute(1, 2, 0).numpy(), ref,
                                   atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("which", ["full", "narrow"])
def test_body_plan_matches_jax_mega_and_span(models, which):
    path = models[which]
    jm, tm, geo, jinfo, tinfo = _pair(path, 640, 480)
    mega = body_mega_for(jm, jinfo, interpret=True)
    plan = body_plan_for(tm, tinfo)
    assert mega is not None and plan is not None
    rs, im, om = mega.rs, mega.in_meta, mega.out_meta
    x = (np.random.default_rng(11).standard_normal((1, im.rows, im.w, im.c)) * 2
         ).astype(np.float32)
    span = jedge._make_span_fn(jm, jinfo.body_start, jinfo.body_end,
                               jinfo.body_in_tensor, jinfo.body_out_tensor)
    ref = np.asarray(jax.jit(span)(jm.params, jnp.asarray(x)))[0]  # (xh, xw, K)
    xr = np.zeros((im.c, im.rows * rs), np.float32)
    for i in range(im.rows):
        xr[:, i * rs:i * rs + im.w] = x[0, i].T
    out = np.asarray(jax.jit(mega)(jnp.asarray(xr)))
    ref_mega = np.stack([out[:, i * rs + np.arange(om.w) * om.sp].T
                         for i in range(om.rows)])
    with torch.no_grad():
        got = plan(torch.from_numpy(x[0].transpose(2, 0, 1).reshape(im.c, -1)))
    got = got.reshape(om.c, om.rows, om.w).permute(1, 2, 0).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-3, rtol=1e-3)
    np.testing.assert_allclose(got, ref_mega, atol=2e-3, rtol=1e-3)


@pytest.mark.parametrize("which", ["full", "narrow"])
def test_tail_and_postprocess_match_jax(models, which):
    """Tail dot + decode + EMA and the fold-blur post, EMA converted from
    JAX's quadrant layout with ema_q[a, b, i, j] = ema[2i+a, 2j+b]."""
    path = models[which]
    jm, tm, geo, jinfo, tinfo = _pair(path, 640, 480)
    je = jedge.EdgeFused(jm, geo, jax_spec(path), jinfo, mega=False, interpret=True)
    te = tedge.EdgeFused(tm, geo, spec_for_model(path), tinfo, device="cpu")
    rng = np.random.default_rng(4)
    k = jm.graph.tensor(jinfo.body_out_tensor).shape[3]
    ema_q = np.full((2, 2, 48, 80), 255, np.uint8)
    ema = torch.full((96, 160), 255, dtype=torch.uint8)
    for _ in range(3):
        body = rng.standard_normal((48, 80, k)).astype(np.float32)
        ema_q = np.asarray(je.tail(jnp.asarray(body), jnp.asarray(ema_q)))
        mask_ref = np.asarray(je.postprocess(jnp.asarray(ema_q)))
        ema = te.tail(torch.from_numpy(body.reshape(-1, k).T.copy()), ema)
        np.testing.assert_array_equal(
            ema.numpy(), ema_q.transpose(2, 0, 3, 1).reshape(96, 160))
        np.testing.assert_array_equal(te.postprocess(ema).numpy(), mask_ref)


def _no_overlap(plan):
    """Workspace regions overlap only where a concat holds its operands, or
    where the two tensors are never live in one phase (the table reuses a
    dead tensor's block); the span output stays live to the end."""
    iv = {t: (plan._offsets[t], plan._offsets[t] + plan.meta[t].size)
          for t in plan._offsets}
    live = plan.mega.live
    concat_of = {t: p[2] for p in plan.plan if p[0] == "concat" for t in p[1]}
    for a, (a0, a1) in iv.items():
        for b, (b0, b1) in iv.items():
            if a < b and a0 < b1 and b0 < a1:
                assert (concat_of.get(a) == b or concat_of.get(b) == a
                        or live[a][1] < live[b][0] or live[b][1] < live[a][0]), (a, b)
    assert live[plan.out_tid][1] > plan.mega.phases


@pytest.mark.parametrize("which", ["full", "narrow"])
def test_body_plan_memory_plan(models, which):
    plan = body_plan_for(load_model(models[which], "cpu"),
                         _pair(models[which], 640, 480)[4])
    _no_overlap(plan)
    n_concat = sum(p[0] == "concat" for p in plan.plan)
    copies = sum(len(c) for c in plan._copies.values())
    assert copies == 1     # only the body input (the stem output) is copied
    # one launch of the persistent kernel; its table copies the operands
    # no concat block holds and runs every other non-concat op
    assert plan.launches_per_run == 1
    ops = plan.mega.ops
    assert sum(m["kind"] == "copy" for m in ops) == copies
    assert sorted(i for m in ops for i in m["idx"] if m["kind"] != "copy") == \
        [i for i, p in enumerate(plan.plan) if p[0] != "concat"]
    assert len(plan.plan) - n_concat + copies > len(ops)


def test_synthetic_span_matches_jax_mega_and_span():
    """Ops the segm models do not reach (dilated depthwise, pool with a
    fused activation, broadcast ADD gate, spatial MUL) through the plain
    BodyPlan, the JAX megakernel in interpret mode and the JAX span."""
    from backscrub_tpu.graph.executor import build_model as jax_build
    from backscrub_tpu.ops.megakernel import BodyMega
    from backscrub_tpu_torch.tflite import ir
    from test_torch_cuda import span_graph
    g, out = span_graph(ir)
    jm = jax_build(g, jit=False)
    g2, _ = span_graph(ir)
    plan = BodyPlan(build_model(g2), 0, len(g2.nodes), 0, out)
    mega = BodyMega(jm, 0, len(g.nodes), 0, out, interpret=True)
    x = np.random.default_rng(2).standard_normal((1, 12, 12, 8)).astype(np.float32)
    span = jedge._make_span_fn(jm, 0, len(g.nodes), 0, out)
    ref = np.asarray(jax.jit(span)(jm.params, jnp.asarray(x)))[0]
    rs = mega.rs
    xr = np.zeros((8, 12 * rs), np.float32)
    for i in range(12):
        xr[:, i * rs:i * rs + 12] = x[0, i].T
    mo = np.asarray(jax.jit(mega)(jnp.asarray(xr)))
    ref_mega = np.stack([mo[:, i * rs:i * rs + 12].T for i in range(12)])
    with torch.no_grad():
        got = plan(torch.from_numpy(x[0].transpose(2, 0, 1).reshape(8, -1).copy()))
    got = got.reshape(16, 12, 12).permute(1, 2, 0).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-3, rtol=1e-3)
    np.testing.assert_allclose(got, ref_mega, atol=2e-3, rtol=1e-3)


_REJECT_CASES = [
    ("SUB", "SUB"), ("non-1x1 body conv", "non-1x1"),
    ("fused activation", "activation"), ("dw variant", "dw variant"),
    ("dw stride", "dw stride"), ("FC on spatial tensor", "FC on spatial"),
    ("non-global pool", "non-global pool"),
    ("operand not produced in-span", "not produced in-span"),
    ("binary shape mismatch", "shape mismatch"),
    ("spatial logistic", "spatial logistic"), ("concat axis", "concat axis"),
    ("concat channel alignment", "channel alignment"),
    ("non-2x resize", "non-2x resize"), ("output spacing != 1", "spacing"),
    ("row width too large", "row width"),
]


@pytest.mark.parametrize("case,msg", _REJECT_CASES)
def test_body_plan_rejects_what_the_megakernel_rejects(case, msg):
    """The same guard classes as BodyMega (tests/test_edge.py's cases)."""
    from backscrub_tpu.tflite.ir import GraphIR
    from test_edge import _mega_reject_case
    tensors, nodes, out = _mega_reject_case(case)
    model = build_model(GraphIR("synth", tensors, nodes, [0], [out]))
    with pytest.raises(Unsupported, match=msg):
        BodyPlan(model, 0, len(nodes), 0, out)


def test_edge_mega_false_runs_the_executor_behind_the_front(models):
    """edge_mega=False keeps K1 and the fused tail and runs the body through
    the graph executor (the JAX package's mega=False), with the same masks
    as the body plan."""
    path = models["narrow"]
    plan = MaskGen(path, 640, 480, device="cpu")
    graph = MaskGen(path, 640, 480, edge_mega=False, device="cpu")
    assert graph.edge.body_plan is None and graph.edge.rest is not None
    assert plan.edge.rest is None and graph.edge.info.tail_ok
    for f in _tools().moving_frames(640, 480, 2):
        a, b = plan.process(f), graph.process(f)
        assert float((a != b).float().mean()) <= 0.02
        assert torch.equal(plan.ema, graph.ema)
