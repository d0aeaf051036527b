"""The persistent body kernel's stream batch on the CPU: the tables it walks
and what a batch of their rows computes, against the JAX package.

``csrc/body_mega.cu`` runs a stream batch as one launch: each CTA takes a
run of consecutive items of an op, the next items' loads in flight while
one computes, and an SE conv's gates once an image.  Each item computes what
it computes in a one-image launch, so the rows of a batch are each
image's rows; the table's walker (``megakernel.walk_table``) walks a batch
image by image.  Here:

- the walker on a batch of 3 equals each image's own walk bit for bit and
  the plan's plain version at atol 1e-5 (mlkit's SE table; deeplab's flat
  table at "high" and in bf16);
- a batch of 3 through the walker stays within the K2 bar, allclose(2e-3,
  1e-3), of the JAX ``BodyMega`` over the same batch in interpret mode
  (segm_lite's SE table; the flat span's GEMM table);
- every family's table fits the shared memory a CTA has, in a one-image
  launch (one item a CTA at a time) and in a batch's, with a ring of at
  least two buffers for each conv and column-wise row and the GEMM ring's
  own epilogue space; on a card with less, a row keeps one buffer, which
  changes no value.
The kernel against these on the card: tests/test_torch_cuda.py."""

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
from backscrub_tpu_torch.ops import megakernel as tmega
from backscrub_tpu_torch.ops.megakernel import (MEGA_FIELDS, BodyPlan, body_plan_for,
                                                walk_table)
from backscrub_tpu_torch.pipeline import edge as tedge
from backscrub_tpu_torch.pipeline.maskgen import MaskGen
from backscrub_tpu_torch.tflite import ir

from test_torch_cuda import flat_graph

DATA = pathlib.Path(__file__).resolve().parent / "data"
FAMILIES = {"segm_lite": DATA / "segm_synth_lite_96x160.tflite",
            "mlkit": DATA / "selfie_synth_mlkit_256x256.tflite",
            "segm_full": DATA / "segm_synth_full_144x256.tflite",
            "bodypix": DATA / "body-pix_synth_050_8_257.tflite",
            "deeplab": DATA / "deeplab_synth_257.tflite"}
S = 3
_F = {f: i for i, f in enumerate(MEGA_FIELDS)}
_BUFFERED = {tmega.MEGA_CODES[k] for k in ("conv", "convw")}


def _plans(family, precision, **kw):
    """The fused path's body plans of ``family`` at 640x480 on the CPU."""
    return MaskGen(str(FAMILIES[family]), 640, 480, device="cpu", precision=precision,
                   **kw).edge.plans


def _batch(plan, seed):
    """S seeded inputs (S, C, H*W) of ``plan``."""
    im = plan.in_meta
    return torch.from_numpy((np.random.default_rng(seed).standard_normal(
        (S, im.c, im.rows * im.w)) * 2).astype(np.float32))


@pytest.mark.parametrize("family,precision,which", [
    ("mlkit", "highest", 0), ("deeplab", "high", 1), ("deeplab", "default", 1)])
def test_batch_walk_is_each_image_walk(family, precision, which):
    """The walker on a batch of 3 is each image's own walk, bit for bit,
    and the plan's plain version in the table's arithmetic at atol 1e-5:
    mlkit's K2 (three SE blocks, convs at K > 320), deeplab's K2'' (the
    GEMM rows) at "high" (bf16x3) and in the bf16 mode."""
    plan = _plans(family, precision)[which]
    assert plan.mega.kinds["gemm" if plan.flat else "conv"] > 0
    x = _batch(plan, 5)
    with torch.no_grad():
        got = walk_table(plan, x)
        for i in range(S):
            assert torch.equal(got[i], walk_table(plan, x[i]))
        plain = plan.run_plain(x, plan.dots)
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, plain, atol=1e-5, rtol=0)


def _jax_batch(mega, x):
    """The JAX kernel on a batch (S, C, H, W) ``x``: rowpad in, dense (S,
    C, H*W) out (its leading axis the stream batch it flattens)."""
    rs, im, om = mega.rs, mega.in_meta, mega.out_meta
    xr = np.zeros((x.shape[0], im.c, im.rows * rs), np.float32)
    for i in range(im.rows):
        xr[:, :, i * rs:i * rs + im.w] = x[:, :, i]
    y = np.asarray(jax.jit(mega)(jnp.asarray(xr)))
    return np.stack([y[:, :, i * rs + np.arange(om.w) * om.sp] for i in range(om.rows)],
                    axis=2).reshape(x.shape[0], om.c, -1)


@pytest.fixture(scope="module")
def segm():
    """(port plan, JAX full-span BodyMega in interpret mode) of segm_lite at
    640x480: seven SE blocks."""
    path = str(FAMILIES["segm_lite"])
    geo = compute_roi(640, 480, 160, 96, 160, 96)
    jm, tm = jax_load_model(path), load_model(path, "cpu")
    jinfo = jedge.edge_applicable(jm, jax_spec(path), geo)
    tinfo = tedge.edge_applicable(tm, spec_for_model(path), geo)
    return body_plan_for(tm, tinfo), body_mega_for(jm, jinfo, interpret=True)


@pytest.fixture(scope="module")
def flat():
    """(port plan, JAX flat BodyMega in interpret mode) of the flat span:
    two GEMM rows, the ASPP pooling branch, a residual in a GEMM epilogue."""
    g, out = flat_graph(ir)
    plan = BodyPlan(build_model(g), 0, len(g.nodes), 0, out, flat=True)
    plan.compile_mega()
    jg, _ = flat_graph(ir)
    return plan, BodyMega(jax_build(jg, jit=False), 0, len(jg.nodes), 0, out, flat=True,
                          interpret=True)


@pytest.mark.parametrize("which", ["segm", "flat"])
def test_batch_walk_within_the_k2_bar_of_jax(request, which):
    """A batch of 3 through the walker against the JAX BodyMega over the
    same batch (its grid=(n,) mode, vmapped in interpret mode):
    allclose(2e-3, 1e-3), the body bar."""
    plan, mega = request.getfixturevalue(which)
    assert plan.mega.kinds["conv" if which == "segm" else "gemm"] > 0
    im = plan.in_meta
    x = (np.random.default_rng(12).standard_normal((S, im.c, im.rows, im.w)) * 2
         ).astype(np.float32)
    with torch.no_grad():
        got = walk_table(plan, torch.from_numpy(x.reshape(S, im.c, -1)))
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), _jax_batch(mega, x), atol=2e-3, rtol=1e-3)


@pytest.mark.parametrize("family,precision", [
    ("segm_lite", "highest"), ("mlkit", "highest"), ("segm_full", "highest"),
    ("bodypix", "highest"), ("deeplab", "high"), ("deeplab", "highest"),
    ("deeplab", "default")])
def test_every_family_table_fits_with_two_buffers(family, precision):
    """Each body table of each family fits the card's shared memory a CTA
    (the table, then the largest op's working memory): a one-image launch
    with one buffer an op and a GEMM row's ring, a batch's with a ring of
    two to _MEGA_BUFS buffers in every conv and column-wise row, an SE
    conv's SE_GATES gates, and a GEMM row's ring with its epilogue space
    beside it; a depthwise row has one window buffer in both."""
    for plan in _plans(family, precision):
        mt = plan.mega
        t = mt.table
        assert t.nbytes < mt.smem_bytes <= mt.smem_batch <= tmega._MAX_SMEM
        buffered = np.isin(t[:, _F["code"]], list(_BUFFERED))
        assert (t[buffered, _F["bufs"]] >= 2).all()
        assert (t[buffered, _F["bufs"]] <= tmega._MEGA_BUFS).all()
        assert (t[~buffered, _F["bufs"]] == 0).all()
        terms = tmega.DOT_MODES[mt.dots][1]
        gemm = t[t[:, _F["code"]] == tmega.MEGA_CODES["gemm"]]
        for r in gemm:
            bn = tmega._WG_TILES[r[_F["tile"]]]
            assert mt.smem_bytes >= t.nbytes + tmega._wg_smem_bytes(bn, terms)
            assert mt.smem_batch >= t.nbytes + tmega._wg_seq_smem_bytes(bn, terms)
        for r in t[(t[:, _F["code"]] == tmega.MEGA_CODES["conv"]) & (t[:, _F["gate"]] == 1)]:
            se = tmega._se_floats(r[_F["c"]], r[_F["hid"]])
            gates = (tmega._SE_GATES + 1) * tmega._SE_MAX_C
            assert mt.smem_batch >= t.nbytes + 4 * (se + gates + tmega._MEGA_NT)


def test_a_smaller_card_keeps_one_buffer(monkeypatch):
    """With a CTA's shared memory just what a one-image launch needs,
    BodyPix's prefix table keeps one buffer in a column-wise row and still
    fits a batch; the buffer count changes no value the table computes."""
    plan = _plans("bodypix", "highest")[0]
    x = _batch(plan, 8)[0]
    want = walk_table(plan, x)
    monkeypatch.setattr(tmega, "_MAX_SMEM", plan.mega.smem_bytes)
    small = _plans("bodypix", "highest")[0]
    t = small.mega.table
    ring = np.isin(t[:, _F["code"]], list(_BUFFERED))
    assert small.mega.smem_batch <= plan.mega.smem_bytes < plan.mega.smem_batch
    assert (t[ring, _F["bufs"]] == 1).any()
    assert torch.equal(walk_table(small, x), want)
