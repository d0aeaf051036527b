"""The persistent body kernel's op table and the GEMM's bf16x3 arithmetic,
on the CPU, against the port's plain versions and the JAX package.

- The op table: the walker (``megakernel.walk_phase``, which the card's
  checks share) executes ``MegaTable``'s rows and weight arena with
  PyTorch ops, phase by phase (an op reads the workspace as it
  stood when its phase began, NaN where nothing was written), so a row
  that read a tensor of its own phase would go wrong.  It must equal
  ``BodyPlan.run_plain`` (atol 1e-5: the same operations, fused) and the
  JAX ``BodyMega`` in interpret mode (allclose(2e-3, 1e-3), the body bar).
  It runs the deeplab tables too (tests/test_torch_deeplab.py), their
  ``gemm`` ops as ``conv1x1_bf16x3_plain`` on the arena's bf16 halves, and
  the bf16 tables (``dots="bf16"``, tests/test_torch_precision.py): every
  dot's activation operand rounded to bf16 (the arena holds the weights
  rounded), the ``gemm`` ops one bf16 pass on the arena's hi half.
- The split: ``conv1x1_bf16x3_plain`` against the reference's HIGH split
  (``backscrub_tpu/ops/megakernel.py:501-515``) through
  ``jax.lax.dot_general`` on the CPU, relative error <= 1e-5.
- ``gemm_config``: the tile and split-K choice at every 1x1 shape of the
  deeplab frame on the H100's 132 SMs.
The kernels themselves run against these in tests/test_torch_cuda.py."""

import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from backscrub_tpu.graph.executor import build_model as jax_build
from backscrub_tpu.graph.executor import load_model as jax_load_model
from backscrub_tpu.models.specs import spec_for_model as jax_spec
from backscrub_tpu.ops.megakernel import BodyMega, body_mega_for
from backscrub_tpu.pipeline import edge as jedge
from backscrub_tpu.pipeline.geometry import compute_roi
from backscrub_tpu_torch.graph.executor import build_model, load_model
from backscrub_tpu_torch.models.specs import spec_for_model
from backscrub_tpu_torch.ops.megakernel import (_WG_TILES, MEGA_FIELDS, BodyPlan, _wg_tile,
                                                body_plan_for, conv1x1_bf16x3_plain,
                                                conv1x1_plain, gemm_config, split_bf16,
                                                walk_table)
from backscrub_tpu_torch.pipeline import edge as tedge
from backscrub_tpu_torch.tflite import ir

from test_torch_cuda import flat_graph, span_graph

ROOT = pathlib.Path(__file__).resolve().parent.parent
FULL = ROOT / "tests" / "data" / "segm_synth_lite_96x160.tflite"
# the deeplab frame's 1x1 conv shapes (co, ci) at L = 33 * 33
DEEPLAB_GEMMS = [(16, 96), (21, 256), (32, 96), (32, 192), (48, 192), (48, 288),
                 (80, 288), (80, 480), (96, 16), (160, 480), (192, 32), (256, 160),
                 (256, 512), (288, 48), (480, 80)]

_F = {f: i for i, f in enumerate(MEGA_FIELDS)}


def walk(plan, x):
    """Run ``plan.mega``'s table on the CPU (``megakernel.walk_table``, phase
    by phase from a NaN workspace); returns (output, phases)."""
    return walk_table(plan, x), len(plan.mega.phase_rows())


@pytest.fixture(scope="module")
def segm():
    """(port plan, JAX full-span BodyMega in interpret mode) of the committed
    synthetic segm model at 640x480."""
    path = str(FULL)
    geo = compute_roi(640, 480, 160, 96, 160, 96)
    jm, tm = jax_load_model(path), load_model(path, "cpu")
    jinfo = jedge.edge_applicable(jm, jax_spec(path), geo)
    tinfo = tedge.edge_applicable(tm, spec_for_model(path), geo)
    return body_plan_for(tm, tinfo), body_mega_for(jm, jinfo, interpret=True)


@pytest.fixture(scope="module")
def span():
    g, out = span_graph(ir)
    plan = BodyPlan(build_model(g), 0, len(g.nodes), 0, out)
    plan.compile_mega()
    jg, _ = span_graph(ir)
    return plan, BodyMega(jax_build(jg, jit=False), 0, len(jg.nodes), 0, out, interpret=True)


def _jax_mega(mega, x):
    """The JAX kernel on (C, H, W) ``x``: rowpad in, dense (C, H*W) out."""
    rs, im, om = mega.rs, mega.in_meta, mega.out_meta
    xr = np.zeros((im.c, im.rows * rs), np.float32)
    for i in range(im.rows):
        xr[:, i * rs:i * rs + im.w] = x[:, i]
    y = np.asarray(jax.jit(mega)(jnp.asarray(xr)))
    return np.stack([y[:, i * rs + np.arange(om.w) * om.sp] for i in range(om.rows)],
                    axis=1).reshape(om.c, -1)


@pytest.mark.parametrize("which", ["segm", "span"])
def test_op_table_walker_matches_plain_and_jax(request, which):
    plan, mega = request.getfixturevalue(which)
    im = plan.in_meta
    x = (np.random.default_rng(11).standard_normal((im.c, im.rows, im.w)) * 2
         ).astype(np.float32)
    xt = torch.from_numpy(x.reshape(im.c, -1))
    with torch.no_grad():
        got, phases = walk(plan, xt)
        plain = plan.run_plain(xt)
    assert phases == plan.mega.phases
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, plain, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got.numpy(), _jax_mega(mega, x), atol=2e-3, rtol=1e-3)


@pytest.mark.parametrize("which", ["segm", "span"])
def test_op_table_covers_the_plan(request, which):
    """Every plan op is in the table (a concat by its operands' placement and
    copies), the phase count is what the kernel runs (one barrier after the
    last op of each phase but the final one), and a run is one launch."""
    plan = request.getfixturevalue(which)[0]
    mt = plan.mega
    assert mt.covered == list(range(len(plan.plan)))
    assert int(mt.table[:, _F["sync"]].sum()) + 1 == mt.phases
    assert mt.table[-1, _F["sync"]] == 0
    levels = [m["level"] for m in mt.ops]
    assert levels == sorted(levels) and levels[-1] == mt.phases
    assert plan.launches_per_run == 1 and dict(plan.kernels_per_run) == {"bs_body_mega": 1}
    assert mt.table.dtype == np.int32 and mt.arena.dtype == np.float32


def test_segm_table_fuses_to_few_phases(segm):
    """The segm body: 94 plan ops, 34 table ops in 33 phases; every
    standalone activation, squeeze-excite block (its pool in the depthwise
    op before it) and residual ADD fused."""
    plan, mt = segm[0], segm[0].mega
    kinds = [m["kind"] for m in mt.ops]
    assert len(plan.plan) == 94 and (len(mt.ops), mt.phases) == (34, 33)
    assert "elt" not in kinds and "gpool" not in kinds and "fc" not in kinds
    assert sum(m["se"] is not None for m in mt.ops) == 7
    assert sum(m.get("pool") is not None for m in mt.ops) == 7
    assert sum(m["res"] is not None for m in mt.ops) == 4
    assert kinds.count("copy") == 1 and mt.ops[1]["level"] == 1


def test_flat_span_table_walker_matches_plain():
    """A small flat plan (flat_graph: GEMM ops, the ASPP pooling branch's
    FC writing its broadcast into a homed concat, a residual in a GEMM's
    epilogue) walked
    on the CPU: atol 1e-5 of run_plain(gemm="bf16x3"), the table's own
    arithmetic, and the body bar of run_plain's f32 GEMMs."""
    g, out = flat_graph(ir)
    plan = BodyPlan(build_model(g), 0, len(g.nodes), 0, out, flat=True)
    mt = plan.compile_mega()
    assert dict(mt.kinds) == {"gemm": 2, "gpool": 1, "fc": 1}
    assert [m.get("bn") for m in mt.ops if m["kind"] == "fc"] == [1089]
    assert sum(m["res"] is not None for m in mt.ops) == 1
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((16, 1089)).astype(
        np.float32))
    with torch.no_grad():
        got, phases = walk(plan, x)
        plain = plan.run_plain(x)
        matched = plan.run_plain(x, gemm="bf16x3")
    assert phases == mt.phases and bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, matched, atol=1e-5, rtol=0)
    torch.testing.assert_close(got, plain, atol=2e-3, rtol=1e-3)


def test_run_plain_gemm_precision(span):
    """gemm="bf16x3" changes a flat plan's spatial 1x1 convs only: a
    non-flat plan (span_graph, its FC included) gives the f32 bits; "bf16"
    changes every plan's dots, FC included (one bf16 pass: within the
    operands' rounding of f32); an unknown precision raises."""
    plan = span[0]
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((8, 144)).astype(
        np.float32))
    assert torch.equal(plan.run_plain(x, gemm="bf16x3"), plan.run_plain(x))
    one = plan.run_plain(x, gemm="bf16")
    assert not torch.equal(one, plan.run_plain(x))
    torch.testing.assert_close(one, plan.run_plain(x), atol=0.05, rtol=0.02)
    with pytest.raises(ValueError, match="gemm"):
        plan.run_plain(x, gemm="fp8")
    g, out = flat_graph(ir)
    flat = BodyPlan(build_model(g), 0, len(g.nodes), 0, out, flat=True)
    xf = torch.from_numpy(np.random.default_rng(3).standard_normal((16, 1089)).astype(
        np.float32))
    assert not torch.equal(flat.run_plain(xf, gemm="bf16x3"), flat.run_plain(xf))


def test_span_table_keeps_unfusable_ops(span):
    """span_graph's ADD gate (not a MUL SE) and its pooled activation stay
    generic ops; its spatial MUL and concat too."""
    mt = span[0].mega
    kinds = [(m["kind"], m.get("elt")) for m in mt.ops]
    assert ("gpool", None) in kinds and ("fc", None) in kinds
    assert ("elt", "ADD") in kinds and ("elt", "MUL") in kinds


def _jax_split_dot(w, b, x):
    """backscrub_tpu/ops/megakernel.py:501-515 on the CPU, plus the bias."""
    dims = (((1,), (0,)), ((), ()))

    def split(a):
        hi = a.astype(jnp.bfloat16)
        return hi, (a - hi.astype(jnp.float32)).astype(jnp.bfloat16)

    def d(u, v):
        return jax.lax.dot_general(u, v, dims, precision=jax.lax.Precision.DEFAULT,
                                   preferred_element_type=jnp.float32)
    ah, al = split(jnp.asarray(w))
    bh, bl = split(jnp.asarray(x))
    return np.asarray(d(ah, bh) + d(ah, bl) + d(al, bh) + jnp.asarray(b)[:, None])


@pytest.mark.parametrize("co,ci", [(16, 96), (256, 512), (480, 80)])
def test_bf16x3_plain_matches_jax_split(co, ci):
    rng = np.random.default_rng(co + ci)
    w = (rng.standard_normal((co, ci)) / np.sqrt(ci)).astype(np.float32)
    x = rng.uniform(0, 2, (ci, 1089)).astype(np.float32)
    b = rng.standard_normal(co).astype(np.float32)
    ref = _jax_split_dot(w, b, x)
    got = conv1x1_bf16x3_plain(*(torch.from_numpy(a) for a in (w, b, x))).numpy()
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()
    # the split is not the f32 product: it drops lo.lo and rounds the terms
    f32 = conv1x1_plain(*(torch.from_numpy(a) for a in (w, b, x))).numpy()
    assert 0 < np.abs(got - f32).max() <= 1e-3 * np.abs(f32).max()


def test_split_bf16_pads_and_reconstructs():
    w = torch.from_numpy(np.random.default_rng(5).standard_normal((7, 13)).astype(np.float32))
    hi, lo = split_bf16(w)
    assert hi.dtype == lo.dtype == torch.bfloat16 and hi.shape == lo.shape == (7, 16)
    assert hi.is_contiguous() and not hi[:, 13:].any() and not lo[:, 13:].any()
    assert torch.equal(hi[:, :13], w.to(torch.bfloat16))
    err = (hi[:, :13].float() + lo[:, :13].float() - w).abs()
    assert float((err / w.abs()).max()) <= 2.0 ** -16


@pytest.mark.parametrize("co,ci", DEEPLAB_GEMMS)
def test_gemm_config_grid(co, ci):
    """At 132 SMs the three-term GEMM (the default) takes the wgmma tile.
    A shallow K (ci < 256) runs at the table's width, the narrowest whose
    grid is one round over the SMs, and is not split.  A deep K takes the
    width and split into 1, 2, 4 or 8 ranges of whole 64-deep slices whose
    CTAs fill the most of one round, ties to the fewest slices a CTA (the
    fit to tools/sweep_gemm_tiles.py --terms 3 on the H100): at the
    frame's deep shapes 32x4, 32x3, 48x3, 32x2, 64x2 and 48x1 (width x
    split)."""
    tile, split, kchunk = gemm_config(co, ci, 1089, 132)
    assert (tile, split, kchunk) == gemm_config(co, ci, 1089, 132, 3)
    bn = _WG_TILES[tile]
    grid = -(-co // bn) * -(-1089 // 64)
    assert kchunk % 64 == 0 and (split - 1) * kchunk < ci <= split * kchunk
    assert grid * split <= 132
    if ci < 256:
        assert tile == _wg_tile(co, 1089) and split == 1
        assert tile == 0 or -(-co // _WG_TILES[tile - 1]) * -(-1089 // 64) > 132
        return
    slices = -(-ci // 64)
    for other in _WG_TILES:
        for want in (1, 2, 4, 8):
            per = -(-slices // want)
            ctas = -(-co // other) * -(-1089 // 64) * -(-slices // per)
            assert ctas > 132 or ctas < grid * split or (
                ctas == grid * split and per >= kchunk // 64)
    assert (bn, split) == {(21, 256): (32, 4), (48, 288): (32, 3), (80, 288): (48, 3),
                           (80, 480): (32, 2), (160, 480): (64, 2),
                           (256, 512): (48, 1)}[(co, ci)]
