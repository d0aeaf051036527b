"""The deeplab path at "highest" against the JAX package at HIGHEST.

At "highest" the JAX flat continuation does not split its dots: it asks
dot_general for HIGHEST (``backscrub_tpu/ops/megakernel.py:473-517``),
f32 on the CPU and the TPU's six bf16 passes on the chip
(``backscrub_tpu/models/specs.py:26-28``).  The port's K2'' GEMM computes
that six-term split at "highest" (``dots_for("highest", True) ==
"bf16x6"``, the tile's TERMS = 6 in ``csrc/gemm_wg.cuh``); its plain twin
is ``conv1x1_bf16x6_plain`` (``BodyPlan.run_plain(x, gemm="bf16x6")``).

References, on the committed synthetic deeplabv3_257-shaped model: the
JAX prefix megakernel and continuation chain at HIGHEST in interpret mode
(f32 dots), and the JAX span lowerings from the front's output to the
body's end (XLA f32 on the CPU) for the path.

Bars: the six-term twin within allclose(atol=1e-4, rtol=1e-4) of the JAX
HIGHEST run (the f32 summation order of ~500-term dots, ~1e-6 mean), and
at least 10x closer than the three-term twin (the fault this slice
repairs: the bf16x3 split's products carry ~2^-16 relative error against
the six terms' ~2^-24), in max and in mean absolute deviation; the
highest table walked phase by phase within 1e-5 of its twin (the same
operations, fused).
"""

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
from backscrub_tpu.pipeline.geometry import compute_roi
from backscrub_tpu_torch.ops import megakernel as tmega
from backscrub_tpu_torch.ops.megakernel import MEGA_FIELDS, split_bf16, walk_table
from backscrub_tpu_torch.pipeline.frame import FramePipeline, PipelineConfig

ROOT = pathlib.Path(__file__).resolve().parent.parent
DEEPLAB = str(ROOT / "tests" / "data" / "deeplab_synth_257.tflite")
ATOL = RTOL = 1e-4
RATIO = 10
_F = {f: i for i, f in enumerate(MEGA_FIELDS)}


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def paths():
    """(JAX model at HIGHEST, its edge info, the JAX prefix kernel and
    continuation chain in interpret mode, the port's EdgeFused at
    "highest" and at "high"), deeplab at 640x480."""
    jm = jax_load_model(DEEPLAB, precision=jax.lax.Precision.HIGHEST)
    geo = compute_roi(640, 480, 257, 257, 257, 257)
    jinfo = jedge.edge_applicable(jm, jspecs.spec_for_model(DEEPLAB), geo)
    jpre = jmega.body_mega_prefix_for(jm, jinfo, interpret=True)
    jcont = jmega.body_mega_continuation_for(jm, jinfo, jpre[1], jpre[2], interpret=True)
    cfg = PipelineConfig(width=640, height=480)
    highest = FramePipeline(DEEPLAB, cfg, device="cpu", precision="highest").maskgen.edge
    high = FramePipeline(DEEPLAB, cfg, device="cpu", precision="high").maskgen.edge
    return jm, jinfo, jpre[0], jcont[0], highest, high


def _dev(a, ref):
    d = np.abs(np.asarray(a, np.float64) - ref)
    return float(d.max()), float(d.mean())


def _held(six, three, ref):
    """The six-term result within the bar of ``ref`` and at least RATIO
    times closer than the three-term one, in max and in mean."""
    np.testing.assert_allclose(six, ref, atol=ATOL, rtol=RTOL)
    (m6, a6), (m3, a3) = _dev(six, ref), _dev(three, ref)
    assert RATIO * m6 <= m3 and RATIO * a6 <= a3, (m6, m3, a6, a3)
    return m6, m3


def test_highest_flat_plan_is_six_terms(paths):
    """At "highest" the continuation's dots are "bf16x6" (the prefix's f32),
    its table the kernel's third instantiation (dots 2) with each GEMM row's
    three weight pieces in one block at ``w``, laid out for the wgmma tile
    of the row's width, and that tile's ring; "high" keeps "bf16x3", its
    two pieces (hi, lo) in one block at ``w`` for the same tile and that
    tile's ring at three terms."""
    *_, highest, high = paths
    assert [p.dots for p in highest.plans] == ["f32", "bf16x6"]
    assert [p.dots for p in high.plans] == ["f32", "bf16x3"]
    assert tmega.DOT_MODES["bf16x6"][0] == 2 and tmega.DOT_MODES["bf16x3"][0] == 0
    for edge, third in ((highest, True), (high, False)):
        plan = edge.cont_plan
        mt = plan.mega
        gemm = mt.table[mt.table[:, _F["code"]] == tmega.MEGA_CODES["gemm"]]
        assert len(gemm) == 29 and not gemm[:, _F["w1"]].any() and not gemm[:, _F["w2"]].any()
        assert len(set(gemm[:, _F["w"]])) == 29
        n = 3 if third else 2
        rings = [tmega._wg_smem_bytes(tmega._WG_TILES[t], 6 if third else 3)
                 for t in gemm[:, _F["tile"]]]
        ar = torch.from_numpy(mt.arena)
        m = next(m for m in mt.ops if m["kind"] == "gemm")
        r = gemm[0]
        w = torch.from_numpy(np.asarray(plan.weights[m["w"]], np.float32))
        got = tmega.unlay_wgmma(ar[r[_F["w"]]:].view(torch.bfloat16), n, *w.shape,
                                tmega._WG_TILES[r[_F["tile"]]])
        assert all(torch.equal(a, b[:, :w.shape[1]]) for a, b in zip(got, split_bf16(w, n)))
        assert mt.table.nbytes + max(rings) <= mt.smem_bytes <= tmega._MAX_SMEM
    assert highest.cont_plan.mega.smem_bytes > high.cont_plan.mega.smem_bytes


def test_six_term_split_is_exact_and_its_twin_is_the_pieces():
    """w = hi + lo + lo2 exactly for f32 weights (24 bits in three bf16
    pieces), padded to 8 columns with zeros; the twin on given pieces is the
    twin on w, held to the exact product as to the JAX run; a GEMM of 6
    terms runs its plain version on CPU tensors."""
    rng = np.random.default_rng(1)
    w = torch.from_numpy((rng.standard_normal((40, 21)) * 3).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((21, 50)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(40).astype(np.float32))
    pieces = split_bf16(w, 3)
    assert [t.shape for t in pieces] == [(40, 24)] * 3
    assert all(t.dtype == torch.bfloat16 and t.is_contiguous() for t in pieces)
    total = sum(t.double() for t in pieces)
    assert torch.equal(total[:, :21], w.double()) and not total[:, 21:].any()
    assert torch.equal(split_bf16(w)[0], pieces[0]) and torch.equal(split_bf16(w)[1], pieces[1])
    six = tmega.conv1x1_bf16x6_plain(w, b, x, "RELU")
    assert torch.equal(tmega.conv1x1_bf16x6_plain(None, b, x, "RELU", split=pieces), six)
    exact = (torch.relu(w.double() @ x.double() + b.double()[:, None])).numpy()
    _held(six.numpy(), tmega.conv1x1_bf16x3_plain(w, b, x, "RELU").numpy(), exact)
    assert torch.equal(tmega.conv1x1_gemm(w, b, x, "RELU", terms=6),
                       tmega.conv1x1_plain(w, b, x, "RELU"))
    with pytest.raises(ValueError, match="terms"):
        tmega.conv1x1_gemm(w, b, x, terms=2)


def test_highest_plans_match_jax_plan_by_plan(paths):
    """The prefix (f32 dots) and the continuation's six-term twin against
    the JAX prefix kernel and continuation chain at HIGHEST; the
    three-term twin on the same input at least 10x farther."""
    jm, jinfo, jpre, jchain, highest, _ = paths
    from test_torch_deeplab import _rowpad, _unrowpad
    xp = np.random.default_rng(3).uniform(0, 6, (16, 129, 129)).astype(np.float32)
    ref = _unrowpad(np.asarray(jax.jit(jpre)(jnp.asarray(_rowpad(xp, jpre.rs)))),
                    jpre.out_meta, jpre.rs)
    with torch.no_grad():
        got = highest.prefix_plan.run_plain(torch.from_numpy(xp.reshape(16, -1)), "f32")
    np.testing.assert_allclose(got.reshape(16, 33, 33).numpy(), ref, atol=ATOL, rtol=RTOL)

    x = (np.random.default_rng(4).standard_normal((16, 33, 33)) * 0.5).astype(np.float32)
    h = jnp.asarray(x.reshape(16, -1))
    for mk in jchain:
        h = jax.jit(mk)(h)
    chain = np.asarray(h)
    cont, xt = highest.cont_plan, torch.from_numpy(x.reshape(16, -1))
    with torch.no_grad():
        six, three = cont.run_plain(xt, "bf16x6").numpy(), cont.run_plain(xt, "bf16x3").numpy()
    _held(six, three, chain)


def test_highest_path_matches_jax(paths):
    """The deeplab body from K1's output to the model output (the prefix,
    the continuation, the executor's 33 -> 257 resize) with the six-term
    twin against the JAX span lowerings at HIGHEST (XLA f32 on the CPU),
    on a held-out frame; the three-term twin at least 10x farther."""
    jm, jinfo, *_, highest, _ = paths
    tools = str(ROOT / "tools")
    if tools not in sys.path:
        sys.path.insert(0, tools)
    from make_synth_segm import moving_frames
    frame = torch.from_numpy(moving_frames(640, 480, 31, seed=1)[30])
    with torch.no_grad():
        front = highest.front(frame, plain=True)
        six = highest.body(front, plain=True, gemm="bf16x6").numpy()
        three = highest.body(front, plain=True, gemm="bf16x3").numpy()
    span = jedge._make_span_fn(jm, jinfo.body_start, jinfo.body_end, jinfo.body_in_tensor,
                               jinfo.body_out_tensor)
    ref = np.asarray(jax.jit(span)(jm.params, jnp.asarray(front.numpy().transpose(1, 2, 0)[None])))
    assert six.shape == (21, 257, 257)
    _held(six, three, ref[0].transpose(2, 0, 1))


def test_highest_table_walker_matches_its_twin(paths):
    """The highest continuation's table (29 six-term GEMM rows on their
    three arena pieces) walked phase by phase: within 1e-5 of
    ``run_plain(gemm="bf16x6")``, and off the three-term twin."""
    cont = paths[4].cont_plan
    x = torch.from_numpy((np.random.default_rng(4).standard_normal((16, 33 * 33)) * 0.5)
                         .astype(np.float32))
    with torch.no_grad():
        got, six, three = walk_table(cont, x), cont.run_plain(x, "bf16x6"), \
            cont.run_plain(x, "bf16x3")
    torch.testing.assert_close(got, six, atol=1e-5, rtol=0)
    assert float((got - three).abs().max()) > 1e-4
