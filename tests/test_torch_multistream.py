"""The port's multi-stream serving on the CPU: the stream batch through
the kernels' plain versions, the batched step against the JAX package's
``MultiStreamPipeline`` and against solo steps, and the servers
(counterparts of ``tests/test_multistream.py``, case for case, on the
committed synthetic models and one device).

Bars:
- Each kernel's plain version over a stream batch is byte-equal to S
  calls on its frames (K1 ``front_plain``, ``BodyPlan.run_plain`` in every
  dot mode, ``walk_table``, K3 and K4), as each kernel is on the card.
- The port's batched step against the JAX batched step (one-device mesh,
  Pallas kernels in interpret mode as the single-frame tests run them):
  the decode flip rule (a decode may differ only at a near-tie, |margin|
  <= 1e-3, the EMAs equal wherever none flipped) and the tolerance
  invariant on the masks (no byte off by more than 1 outside the flips'
  post footprint, at most 2% of a frame's bytes, and, off the post's exact
  x.5 ties, 0.2% of the sequence's), per stream, as
  ``tests/test_torch_selfie.py``'s ``_Bars``; the outputs equal byte for
  byte outside the output bytes of pixels whose masks differ.
- The batched step against solo ``FramePipeline`` steps of each stream:
  byte-equal (on CPU tensors every stage is the same plain arithmetic).
- The servers' deliveries: byte-equal to solo steps where the JAX tests
  hold bit identity, else the tolerance invariant, as there.
- The classic preprocess: the model inputs equal the JAX package's bit
  for bit, the resize's x.5 ties included (ROADMAP queue 3).
"""

import pathlib
import sys
import threading
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from backscrub_tpu.io.jpeg import JpegInfo as JaxJpegInfo
from backscrub_tpu.io.streams import SyntheticSource
from backscrub_tpu.parallel.mesh import make_mesh
from backscrub_tpu.parallel.streams import MultiStreamPipeline as JaxMultiStream
from backscrub_tpu.pipeline.frame import PipelineConfig as JaxConfig
from backscrub_tpu.pipeline.maskgen import MaskGen as JaxMaskGen
from backscrub_tpu_torch.io.jpeg import JpegEntropyDecoder, JpegHuffmanEncoder, make_info
from backscrub_tpu_torch.ops import megakernel as tmega
from backscrub_tpu_torch.ops.pack_kernels import (blend_pack_420, blend_pack_420_plain,
                                                  blend_pack_yuyv, blend_pack_yuyv_plain)
from backscrub_tpu_torch.parallel.streams import MultiStreamPipeline
from backscrub_tpu_torch.pipeline import edge as tedge
from backscrub_tpu_torch.pipeline.frame import FramePipeline, PipelineConfig
from backscrub_tpu_torch.pipeline.geometry import compute_roi
from backscrub_tpu_torch.pipeline.jpeg_enc import encode_jpeg_coefs, stream_qtabs
from backscrub_tpu_torch.pipeline.maskgen import MaskGen
from backscrub_tpu_torch.runtime.multistream import MultiGeometryServer, MultiStreamServer

from test_torch_selfie import FRAME_TOL, MEAN_TOL, _Bars, _yuyv, post_ties

ROOT = pathlib.Path(__file__).resolve().parent.parent
DATA = ROOT / "tests" / "data"
LITE = str(DATA / "segm_synth_lite_96x160.tflite")
FULL = str(DATA / "segm_synth_full_144x256.tflite")
MLKIT = str(DATA / "selfie_synth_mlkit_256x256.tflite")
DEEPLAB = str(DATA / "deeplab_synth_257.tflite")
W, H = 64, 48                      # the server tests' frames
SMALL = PipelineConfig(width=W, height=H, use_bilateral=False)


def _moving(w, h, n, seed):
    tools = str(ROOT / "tools")
    if tools not in sys.path:
        sys.path.insert(0, tools)
    from make_synth_segm import moving_frames
    return moving_frames(w, h, n, seed=seed)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: the suite's parallel workers then do not
    oversubscribe the cores (each worker's default is every core)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


def _src(seq):
    it = iter(seq)
    return lambda: next(it, None)


def _close(a, b):
    """The tolerance invariant for one frame: (max |a - b|, share differing)."""
    a, b = np.asarray(a).astype(np.int16), np.asarray(b).astype(np.int16)
    assert np.abs(a - b).max() <= 1
    frac = float((a != b).mean())
    assert frac <= 0.02
    return frac


# ---------------------------------------------------------------------------
# the plain kernels over a stream batch


def test_front_plain_batch_is_single_calls():
    rng = np.random.default_rng(0)
    Hc, Wc, cout, S = 37, 54, 13, 3
    canvas = torch.from_numpy(rng.integers(0, 256, (S, 3, Hc + 4, Wc + 4)).astype(np.float32))
    params = torch.from_numpy(tedge.front_params(
        (rng.standard_normal((3, 3, 3, cout)) * 0.2).astype(np.float32),
        (rng.standard_normal(cout) * 0.1).astype(np.float32)))
    kw = dict(H=Hc, W=Wc, oh=-(-Hc // 2), ow=-(-Wc // 2), pad_lo_h=tedge._same_pad_lo(Hc, 3, 2),
              pad_lo_w=tedge._same_pad_lo(Wc, 3, 2), use_bilateral=True, scale=1 / 127.5,
              offset=-1.0, activation="HARD_SWISH")
    got = tedge.front_fused(canvas, params, **kw)
    assert tuple(got.shape) == (S, cout, kw["oh"], kw["ow"])
    for s in range(S):
        assert torch.equal(got[s], tedge.front_plain(canvas[s], params, **kw))


def _plan(path, which, precision=None):
    mg = MaskGen(path, 640, 480, device="cpu", precision=precision)
    e = mg.edge
    return {"body": e.body_plan, "prefix": e.prefix_plan, "cont": e.cont_plan}[which]


@pytest.mark.parametrize("path,which,gemm,precision", [
    (LITE, "body", "f32", None), (DEEPLAB, "prefix", "f32", None),
    (DEEPLAB, "cont", "bf16x3", None), (LITE, "body", "bf16", "default")],
    ids=["K2-f32", "K2'-f32", "K2''-bf16x3", "K2-bf16"])
def test_run_plain_batch_is_single_calls(path, which, gemm, precision):
    plan = _plan(path, which, precision)
    assert plan is not None and plan.dots in ("f32", "bf16x3", "bf16")
    rng = np.random.default_rng(3)
    m = plan.in_meta
    x = torch.from_numpy(rng.uniform(-1, 1, (2, m.c, m.rows * m.w)).astype(np.float32))
    got = plan.run_plain(x, gemm)
    for s in range(2):
        assert torch.equal(got[s], plan.run_plain(x[s], gemm))
    # the plan's own call over the batch (a bf16 plan's dots one bf16 pass)
    call = plan(x)
    assert tuple(call.shape) == (2, plan.out_meta.c, plan.out_meta.rows * plan.out_meta.w)


def test_walk_table_batch_is_single_calls():
    plan = _plan(LITE, "body")
    rng = np.random.default_rng(4)
    m = plan.in_meta
    x = torch.from_numpy(rng.uniform(-1, 1, (2, m.c, m.rows * m.w)).astype(np.float32))
    got = tmega.walk_table(plan, x)
    for s in range(2):
        one = tmega.walk_table(plan, x[s])
        assert torch.equal(got[s], one) and bool(torch.isfinite(one).all())
        torch.testing.assert_close(one, plan.run_plain(x[s]), atol=2e-3, rtol=1e-3)


@pytest.mark.parametrize("layout", ["yuyv", "nv12", "i420"])
def test_blend_pack_batch_is_single_calls(layout):
    rng = np.random.default_rng(5)
    S, h, w = 3, 24, 36
    fr, bg = (torch.from_numpy(rng.integers(0, 256, (S, h, w, 3), np.uint8)) for _ in range(2))
    mask = torch.from_numpy(rng.integers(0, 256, (S, h, w), np.uint8))
    if layout == "yuyv":
        got, plain = blend_pack_yuyv(fr, bg, mask), blend_pack_yuyv_plain
        one = [plain(fr[s], bg[s], mask[s]) for s in range(S)]
    else:
        got, plain = blend_pack_420(fr, bg, mask, layout), blend_pack_420_plain
        one = [plain(fr[s], bg[s], mask[s], layout) for s in range(S)]
    assert got.shape[0] == S
    for s in range(S):
        assert torch.equal(got[s], one[s])


# ---------------------------------------------------------------------------
# the batched step against the JAX batched step and against solo steps


def _margins(mg, frames):
    """The port's decode margin a stream (S, oh, ow), f64: it changes sign
    where the decision flips."""
    f = torch.from_numpy(frames)
    with torch.no_grad():
        e = mg.edge
        if e is not None:
            out = e.body(e.front(f))
            if e.info.tail_ok:
                return (e.tail_logits(out.flatten(-2)) - e.info.tail_threshold).double().numpy()
            out = out.movedim(-3, -1)
        else:
            out = mg._infer(mg._pre(f))
    o, spec = out.double(), mg.spec
    if spec.decode == "two_channel":
        return (o[..., 1] - o[..., 0]).numpy()
    if spec.decode == "threshold":
        return (o[..., 0] - spec.threshold).numpy()
    rest = torch.cat([o[..., :spec.person_class], o[..., spec.person_class + 1:]], -1)
    return (o[..., spec.person_class] - rest.max(-1).values).numpy()


def _nv12(pixels):
    """A frame's pixels (H, W) as its NV12 bytes (3H/2, W): each Y byte,
    and both chroma bytes of every 2x2 block with a marked pixel."""
    h, w = pixels.shape
    blk = pixels.reshape(h // 2, 2, w // 2, 2).any((1, 3))
    return np.concatenate([pixels, np.repeat(blk, 2, axis=1)])


def _std_ema(jema):
    """The JAX fused path's quadrant-layout EMAs (S, 2, 2, h, w) as (S,
    2h, 2w); the classic path's as they are."""
    q = np.asarray(jema)
    if q.ndim == 5:
        return q.transpose(0, 3, 1, 4, 2).reshape(q.shape[0], 2 * q.shape[3], 2 * q.shape[4])
    return q


def _to_format(fmt, bgr):
    """(S, H, W, 3) BGR frames as a camera's raw bytes (cv2's packing)."""
    import cv2
    if fmt == "yuyv":
        return np.stack([cv2.cvtColor(f, cv2.COLOR_BGR2YUV_YUY2).reshape(f.shape[0], -1)
                         for f in bgr])
    h, w = bgr.shape[1:3]
    out = []
    for f in bgr:
        i420 = cv2.cvtColor(f, cv2.COLOR_BGR2YUV_I420)
        u = i420[h:h + h // 4].reshape(h // 2, w // 2)
        v = i420[h + h // 4:].reshape(h // 2, w // 2)
        out.append(np.concatenate([i420[:h], np.stack([u, v], -1).reshape(h // 2, w)]))
    return np.stack(out)


def _mjpg_frames(w, h, S, n, seed):
    """n ticks of S streams' MJPG frames ((coefs, qtabs) each, stacked a
    tick), each stream at its own quality, and the stream's JpegInfo."""
    info = make_info(w, h)
    dec = JpegEntropyDecoder()
    ticks = []
    for k in range(n):
        coefs, qts = [], []
        for s in range(S):
            qt = stream_qtabs(70 + 7 * s)
            img = _moving(w, h, k + 1, seed + s)[k]
            with torch.no_grad():
                c = encode_jpeg_coefs(torch.from_numpy(img), torch.from_numpy(qt.astype(np.int32)),
                                      info)
            cs, q = dec.decode(JpegHuffmanEncoder(info, qt).encode([a.numpy() for a in c]))
            coefs.append([a.copy() for a in cs])
            qts.append(q)
        ticks.append((tuple(np.stack([c[i] for c in coefs]) for i in range(info.ncomp)),
                      np.stack(qts)))
    return info, ticks


# family -> (model, port config, JAX config extras, input format, frame
# size).  segm_lite and segm_full take frames the size of their model
# output: at 160x120 a quarter of segm_lite's post values are exact x.5
# ties, which the JAX package's own batched and one-frame posts round
# apart (493 of 19200 mask bytes); the upscaling post is held at 640x480
# by the families' own tests.
JAX_CASES = {
    "segm_lite_bgr": (LITE, dict(), dict(edge_interpret=True), "bgr", (160, 96)),
    "mlkit_yuyv": (MLKIT, dict(), dict(edge_interpret=True), "yuyv", (160, 120)),
    "deeplab_nv12": (DEEPLAB, dict(), dict(edge_interpret=True), "nv12", (160, 120)),
    "classic_nv12_out": (FULL, dict(edge_fused=False, output_format="nv12"), dict(), "bgr",
                         (256, 144)),
    "segm_lite_mjpg": (LITE, dict(), dict(edge_interpret=True), "mjpg", (160, 96)),
}


@pytest.mark.parametrize("case", list(JAX_CASES))
def test_batched_step_matches_jax_and_solo(case):
    path, kw, jkw, fmt, (w, h) = JAX_CASES[case]
    S, n = 2, 3
    bg = np.random.default_rng(7).integers(0, 256, (S, h, w, 3), np.uint8)
    if fmt == "mjpg":
        info, ticks = _mjpg_frames(w, h, S, n, seed=11)
        kw = dict(kw, input_format="mjpg", jpeg_info=info)
        jkw = dict(jkw, input_format="mjpg", jpeg_info=JaxJpegInfo(
            info.width, info.height, info.ncomp, info.sampling, info.blocks))
    else:
        bgr = [np.stack([_moving(w, h, k + 1, seed=s)[k] for s in range(S)]) for k in range(n)]
        ticks = [b if fmt == "bgr" else _to_format(fmt, b) for b in bgr]
        kw, jkw = dict(kw, input_format=fmt), dict(jkw, input_format=fmt)
    port = MultiStreamPipeline(path, PipelineConfig(width=w, height=h, **kw), S, device="cpu")
    ref = JaxMultiStream(path, JaxConfig(width=w, height=h, pack_interpret=True,
                                         **{**kw, **jkw}), S, make_mesh(1))
    solos = [FramePipeline(path, PipelineConfig(width=w, height=h, **kw), device="cpu")
             for _ in range(S)]
    mg, geo = port.pipe.maskgen, port.pipe.geo
    assert (mg.edge is not None) == (kw.get("edge_fused") is not False)
    bars, deeplab = [_Bars(mg.ema_shape) for _ in range(S)], []
    for frames in ticks:
        out, masks = port.step(frames, bg)
        jout, jmasks = (np.asarray(a) for a in ref.step(frames, bg))
        ema, jema = port.ema.numpy(), _std_ema(ref.ema)
        with torch.no_grad():
            rgb = port.pipe.decode(port.pipe._upload(frames, "frames", port.pipe.cfg.input_format, S))
        margin = _margins(mg, rgb.numpy())
        for s in range(S):
            one = solos[s].step(frames[s] if fmt != "mjpg"
                                else (tuple(c[s] for c in frames[0]), frames[1][s]), bg[s])
            assert torch.equal(out[s], one[0]) and torch.equal(masks[s], one[1])
            assert torch.equal(port.ema[s], solos[s].maskgen.ema)
            if path == DEEPLAB:
                # deeplab's K2'' dots are f32 here and HIGH (bf16x3) in the
                # JAX chain, so its decode flips reach past the near-tie:
                # tests/test_torch_deeplab.py's bar, the tolerance invariant
                # on every byte of EMA, mask and output
                deeplab.extend(_share(a, b) for a, b in (
                    (ema[s], jema[s]), (masks[s].numpy(), jmasks[s]), (out[s].numpy(), jout[s])))
                continue
            bars[s].ema(ema[s], jema[s], margin[s])
            foot = tedge.post_footprint(torch.from_numpy(ema[s] != jema[s]), geo,
                                        mg.post_mats).numpy()
            fold = min(geo.out_roi.h, geo.out_roi.w) >= 64
            ties = post_ties(jema[s], geo) if fold else np.zeros_like(foot)
            bars[s].bytes([((masks[s].numpy(), jmasks[s]), ties)], [foot])
            # the blend and pack are exact: outputs differ only in the bytes
            # of pixels whose masks differ (a mask off by 1 may move V by 2)
            pack = _yuyv if port.pipe.cfg.output_format == "yuyv" else _nv12
            apart = pack(masks[s].numpy() != jmasks[s])
            np.testing.assert_array_equal(np.where(apart, 0, out[s].numpy()),
                                          np.where(apart, 0, jout[s]))
    for b in bars if not deeplab else ():
        b.check()
    assert np.mean(deeplab or [0.0]) <= MEAN_TOL


def _share(a, b):
    """The share of a frame's bytes that differ, at most FRAME_TOL."""
    frac = float((np.asarray(a) != np.asarray(b)).mean())
    assert frac <= FRAME_TOL
    return frac


def test_preprocess_matches_jax_off_the_resize_ties():
    """The classic preprocess of the first four ``SyntheticSource`` frames
    at 640x480 gives deeplab's model inputs (scale 1/127.5, offset -1) bit
    for bit as the JAX package's: ``x * scale + offset`` rounded once as
    XLA's fused multiply-add rounds it (before, 1 ulp off at about 127k
    inputs a frame), and the resize's exact x.5 ties rounded as XLA:CPU
    sums deeplab's 2-tap rows, two rounded products added
    (``maskgen.resize_two_tap``; before, the second frame's 12 inputs were
    one u8 step apart, ROADMAP queue 3)."""
    port = MaskGen(DEEPLAB, 640, 480, device="cpu", edge_fused=False)
    ref = JaxMaskGen(DEEPLAB, 640, 480, edge_fused=False)
    src = SyntheticSource(640, 480)
    apart = []
    for _ in range(4):
        f = src.read()
        with torch.no_grad():
            x = port._pre(torch.from_numpy(f)).numpy()
        jx = np.asarray(ref._pre(jnp.asarray(f)))
        apart.append(int((x != jx).sum()))
    assert apart == [0, 0, 0, 0], apart


@pytest.mark.parametrize("path,w,h", [(FULL, 640, 480), (FULL, 1280, 720),
                                      (DEEPLAB, 1280, 720), (MLKIT, 640, 480),
                                      (MLKIT, 160, 96), (LITE, 160, 120)],
                         ids=["segm_full-640x480", "segm_full-1280x720",
                              "deeplab-1280x720", "mlkit-640x480", "mlkit-160x96",
                              "segm_lite-160x120"])
def test_preprocess_resize_ties_match_jax(path, w, h):
    """The classic preprocess on six ``SyntheticSource`` frames, bit for bit
    the JAX package's, over a stream batch of two as well: segm_full at
    640x480 runs both passes of ``maskgen.FMA_PASSES`` (its 640 -> 192
    columns with one row's taps across the block of 512), the others the
    two rounded products."""
    port = MaskGen(path, w, h, device="cpu", edge_fused=False)
    ref = JaxMaskGen(path, w, h, edge_fused=False)
    src = SyntheticSource(w, h)
    frames = np.stack([src.read() for _ in range(6)])
    for f in list(frames) + [frames[1:3]]:
        with torch.no_grad():
            x = port._pre(torch.from_numpy(f)).numpy()
        np.testing.assert_array_equal(x, np.asarray(ref._pre(jnp.asarray(f))))


def test_stream_batch_post_takes_one_frame_products(monkeypatch):
    """mlkit's stream batch against solo steps (ROADMAP queue 3): on an
    H100 the fold-blur post over a batch of 4 EMAs, one GEMM of 4·o.w rows,
    rounded mask bytes otherwise than each stream's own product (the
    library picks its GEMM kernel by the rows it is given; every earlier
    stage was bit-identical: ``chip_smoke.py`` ``_stage_trace``).  The post
    now takes a batch's products image by image: every matmul of the batch
    has the operand shapes of the one-frame call, and the masks are the
    solo masks bit for bit."""
    geo = compute_roi(640, 480, 256, 256, 256, 256)        # mlkit at 640x480
    mats = tedge.fold_blur_tensors(geo, "cpu")
    ema = torch.from_numpy(np.random.default_rng(9).integers(0, 256, (4, 256, 256), np.uint8))
    shapes, matmul = [], torch.matmul
    monkeypatch.setattr(torch, "matmul",
                        lambda a, b: shapes.append((tuple(a.shape), tuple(b.shape))) or matmul(a, b))
    solo = torch.stack([tedge.postprocess_mask(e, geo, mats) for e in ema])
    solo_shapes, _ = set(shapes), shapes.clear()
    batch = tedge.postprocess_mask(ema, geo, mats)
    assert len(shapes) == 8 and set(shapes) == solo_shapes == {((480, 256), (256, 256)),
                                                               ((480, 256), (256, 480))}
    assert torch.equal(batch, solo)


# ---------------------------------------------------------------------------
# the servers (tests/test_multistream.py, case for case)


def test_multistream_matches_single(rng):
    S = 4
    ms = MultiStreamPipeline(LITE, SMALL, S, device="cpu")
    frames = rng.integers(0, 256, (S, H, W, 3), np.uint8)
    bgs = rng.integers(0, 256, (S, H, W, 3), np.uint8)
    out_b, masks_b = ms.step(frames, bgs)
    assert tuple(out_b.shape) == (S, H, 2 * W) and tuple(masks_b.shape) == (S, H, W)
    out_s, mask_s = FramePipeline(LITE, SMALL, device="cpu").step(frames[3], bgs[3])
    assert torch.equal(masks_b[3], mask_s) and torch.equal(out_b[3], out_s)


def test_multistream_ema_isolation(rng):
    """Person-like frames on one stream do not leak into the others."""
    S = 4
    ms = MultiStreamPipeline(LITE, SMALL, S, device="cpu")
    frames = np.zeros((S, H, W, 3), np.uint8)
    frames[0] = rng.integers(0, 256, (H, W, 3), np.uint8)
    for _ in range(3):
        _, masks = ms.step(frames)
    for s in range(2, S):
        assert torch.equal(masks[1], masks[s])


def test_multistream_yuyv_ingest(rng):
    S = 2
    ms = MultiStreamPipeline(LITE, PipelineConfig(width=W, height=H, use_bilateral=False,
                                                  input_format="yuyv"), S, device="cpu")
    out, masks = ms.step(_to_format("yuyv", rng.integers(0, 256, (S, H, W, 3), np.uint8)))
    assert tuple(out.shape) == (S, H, 2 * W) and tuple(masks.shape) == (S, H, W)


def test_multigeometry_server_bit_identical_to_solo(rng):
    N, geos = 3, [(64, 48), (128, 96)]
    frames = {g: [rng.integers(0, 256, (g[1], g[0], 3), np.uint8) for _ in range(N)]
              for g in geos}
    bgs = {g: rng.integers(0, 256, (g[1], g[0], 3), np.uint8) for g in geos}
    outs = {g: [] for g in geos}
    server = MultiGeometryServer(LITE, PipelineConfig(width=0, height=0, use_bilateral=False),
                                 [(_src(frames[g]), outs[g].append, g[0], g[1], bgs[g])
                                  for g in geos], device="cpu")
    assert server.n_groups == 2 and server.run() == N
    for (w, h) in geos:
        solo = FramePipeline(LITE, PipelineConfig(width=w, height=h, use_bilateral=False),
                             device="cpu")
        assert len(outs[(w, h)]) == N
        for i in range(N):
            np.testing.assert_array_equal(outs[(w, h)][i],
                                          solo.step(frames[(w, h)][i], bgs[(w, h)])[0].numpy())


def test_multistream_padding_slots_never_deliver(rng):
    ms = MultiStreamPipeline(LITE, SMALL, 4, device="cpu")
    seq = [rng.integers(0, 256, (H, W, 3), np.uint8) for _ in range(2)]
    got = []
    MultiStreamServer(ms, [_src(seq)], [got.append]).run()
    assert len(got) == 2
    solo = FramePipeline(LITE, SMALL, device="cpu")
    for i in range(2):
        np.testing.assert_array_equal(got[i], solo.step(seq[i], None)[0].numpy())


def test_multistream_requires_a_stream():
    """One card, no mesh: any batch of at least one stream (the JAX test
    asked for a multiple of the mesh's data axis)."""
    with pytest.raises(ValueError, match="at least 1"):
        MultiStreamPipeline(LITE, SMALL, 0, device="cpu")
    assert MultiStreamPipeline(LITE, SMALL, 3, device="cpu").ema.shape[0] == 3


def test_multistream_server_pull_identity(rng):
    """Pull mode: each stream's deliveries equal its solo steps, streams
    that end early included (an EOF neither repeats nor shifts later
    deliveries), and the direct batched steps of the same batches."""
    S, lengths = 4, [2, 5, 3, 5]
    streams = [[rng.integers(0, 256, (H, W, 3), np.uint8) for _ in range(n)] for n in lengths]
    bgs = rng.integers(0, 256, (S, H, W, 3), np.uint8)
    got = [[] for _ in range(S)]
    server = MultiStreamServer(MultiStreamPipeline(LITE, SMALL, S, device="cpu"),
                               [_src(f) for f in streams], [g.append for g in got],
                               backgrounds=bgs)
    assert server.run() == max(lengths)
    for s in range(S):
        assert len(got[s]) == lengths[s]
        single = FramePipeline(LITE, SMALL, device="cpu")
        fracs = [_close(got[s][i], single.step(f, bgs[s])[0].numpy())
                 for i, f in enumerate(streams[s])]
        assert np.mean(fracs) <= 0.002


def test_multistream_server_threaded_liveness():
    S = 3

    def make_source(n):
        state = {"left": n}

        def src():
            if state["left"] == 0:
                return None
            state["left"] -= 1
            time.sleep(0.002)
            return np.full((H, W, 3), state["left"] * 13 % 251, np.uint8)
        return src

    counts = [0] * S
    server = MultiStreamServer(MultiStreamPipeline(LITE, SMALL, S, device="cpu"),
                               [make_source(6) for _ in range(S)],
                               [lambda _o, s=s: counts.__setitem__(s, counts[s] + 1)
                                for s in range(S)], threaded=True)
    assert server.run(frames=200) >= 1
    assert all(c >= 1 for c in counts)


def test_multistream_server_validates_counts():
    ms = MultiStreamPipeline(LITE, SMALL, 3, device="cpu")
    with pytest.raises(ValueError):
        MultiStreamServer(ms, [lambda: None] * 2, [print] * 3)
    with pytest.raises(ValueError):
        MultiStreamServer(ms, [lambda: None] * 4, [print] * 4)
    with pytest.raises(ValueError, match="depth"):
        MultiStreamServer(ms, [], [], depth=0)


def test_multistream_server_yuyv_ingest(rng):
    S = 2
    ms = MultiStreamPipeline(LITE, PipelineConfig(width=W, height=H, use_bilateral=False,
                                                  input_format="yuyv"), S, device="cpu")
    yuyv = _to_format("yuyv", rng.integers(0, 256, (S, H, W, 3), np.uint8))
    got = [[] for _ in range(S)]
    server = MultiStreamServer(ms, [_src([yuyv[s]] * 3) for s in range(S)],
                               [g.append for g in got])
    assert server.run() == 3
    assert all(len(g) == 3 for g in got) and got[0][0].shape == (H, 2 * W)
    with pytest.raises(ValueError, match="frame shape"):
        server._store(0, np.zeros((H, W, 3), np.uint8))


def test_multistream_server_no_delivery_before_first_frame(rng):
    S = 3
    left = [4]

    def fast_source():
        if left[0] == 0:
            return None
        left[0] -= 1
        time.sleep(0.002)
        return rng.integers(0, 256, (H, W, 3), np.uint8)

    def never_source():
        time.sleep(0.01)
        return None           # EOF without ever producing

    counts = [0] * S
    server = MultiStreamServer(MultiStreamPipeline(LITE, SMALL, S, device="cpu"),
                               [fast_source] + [never_source] * (S - 1),
                               [lambda _o, s=s: counts.__setitem__(s, counts[s] + 1)
                                for s in range(S)], threaded=True, stall_timeout=5.0)
    server.run(frames=50)
    assert counts[0] >= 1 and all(c == 0 for c in counts[1:])


def test_multistream_server_stall_timeout():
    S = 2
    stop = threading.Event()

    def forever():            # stalled: no frame, no EOF
        stop.wait(30)
        return None

    server = MultiStreamServer(MultiStreamPipeline(LITE, SMALL, S, device="cpu"),
                               [forever] * S, [lambda _o: None] * S, threaded=True,
                               stall_timeout=0.5)
    t0 = time.monotonic()
    assert server.run() == 0
    stop.set()
    assert time.monotonic() - t0 < 10


def test_multistream_server_nv12_ingest(rng):
    S = 2
    ms = MultiStreamPipeline(LITE, PipelineConfig(width=W, height=H, use_bilateral=False,
                                                  input_format="nv12"), S, device="cpu")
    nv12 = _to_format("nv12", rng.integers(0, 256, (S, H, W, 3), np.uint8))
    got = [[] for _ in range(S)]
    server = MultiStreamServer(ms, [_src([nv12[s]] * 2) for s in range(S)],
                               [g.append for g in got])
    assert server.run() == 2
    assert all(len(g) == 2 and g[0].shape == (H, 2 * W) for g in got)


def test_multistream_server_mjpg_ingest():
    """Per-stream MJPG frames (each stream its own quality, so its own
    quant tables) batch into one step, the decode once a stream; each
    stream's output equals its solo step."""
    S = 3
    info, ticks = _mjpg_frames(W, H, S, 1, seed=2)
    cfg = PipelineConfig(width=W, height=H, use_bilateral=False, input_format="mjpg",
                         jpeg_info=info)
    coefs, qtabs = ticks[0]
    per_stream = [(tuple(c[s] for c in coefs), qtabs[s]) for s in range(S)]
    got = [[] for _ in range(S)]
    server = MultiStreamServer(MultiStreamPipeline(LITE, cfg, S, device="cpu"),
                               [_src([f] * 2) for f in per_stream], [g.append for g in got])
    assert server.run() == 2
    assert all(len(g) == 2 and g[0].shape == (H, 2 * W) for g in got)
    out_s, _ = FramePipeline(LITE, cfg, device="cpu").step(per_stream[2])
    np.testing.assert_array_equal(got[2][0], out_s.numpy())


def test_multigeometry_server_mixed_bgr_and_mjpg(rng):
    N = 2
    bgr = [rng.integers(0, 256, (H, W, 3), np.uint8) for _ in range(N)]
    info, ticks = _mjpg_frames(80, 64, 1, N, seed=4)
    mjpg = [(tuple(c[0] for c in t[0]), t[1][0]) for t in ticks]
    out_bgr, out_mjpg = [], []
    server = MultiGeometryServer(
        LITE, PipelineConfig(width=0, height=0, use_bilateral=False),
        [(_src(bgr), out_bgr.append, W, H, None),
         (_src(mjpg), out_mjpg.append, 80, 64, None, info)], device="cpu")
    assert server.n_groups == 2 and server.run() == N
    solo_bgr = FramePipeline(LITE, SMALL, device="cpu")
    solo_mjpg = FramePipeline(LITE, PipelineConfig(width=80, height=64, use_bilateral=False,
                                                   input_format="mjpg", jpeg_info=info),
                              device="cpu")
    for i in range(N):
        np.testing.assert_array_equal(out_bgr[i], solo_bgr.step(bgr[i])[0].numpy())
        np.testing.assert_array_equal(out_mjpg[i], solo_mjpg.step(mjpg[i])[0].numpy())


def test_multistream_server_elastic_attach_detach(rng):
    ms = MultiStreamPipeline(LITE, SMALL, 3, device="cpu")
    frames_a = [rng.integers(0, 256, (H, W, 3), np.uint8) for _ in range(6)]
    frames_b = [rng.integers(0, 256, (H, W, 3), np.uint8) for _ in range(3)]
    bg_b = rng.integers(0, 256, (H, W, 3), np.uint8)
    out_a, out_b = [], []
    server = MultiStreamServer(ms, [_src(frames_a)], [out_a.append], depth=1)
    server.start()
    assert server.tick() and server.tick()
    slot_b = server.attach(_src(frames_b), out_b.append, background=bg_b)
    assert slot_b != 0
    for _ in range(3):
        server.tick()
    server.detach(0)          # results of A may still be in flight
    while server.tick():
        pass
    server.finish()
    assert len(out_a) <= 6 and len(out_b) == 3
    solo = FramePipeline(LITE, SMALL, device="cpu")   # B from ITS first frame
    for i in range(3):
        np.testing.assert_array_equal(out_b[i], solo.step(frames_b[i], bg_b)[0].numpy())
    out_c, frames_c = [], [rng.integers(0, 256, (H, W, 3), np.uint8)]
    assert server.attach(_src(frames_c), out_c.append) == 0
    while server.tick():
        pass
    server.finish()
    assert len(out_c) == 1
    np.testing.assert_array_equal(out_c[0], FramePipeline(LITE, SMALL, device="cpu")
                                  .step(frames_c[0])[0].numpy())


def test_multistream_server_keep_alive_and_threaded_attach(rng):
    ms = MultiStreamPipeline(LITE, SMALL, 2, device="cpu")
    out_a, out_b = [], []
    server = MultiStreamServer(ms, [_src([rng.integers(0, 256, (H, W, 3), np.uint8)])],
                               [out_a.append], threaded=True, depth=1, keep_alive=True)
    server.start()
    deadline = time.monotonic() + 30
    while not out_a and time.monotonic() < deadline:
        server.tick()
        server._drain(force=True)
        time.sleep(0.005)
    assert out_a, "stream A never delivered"
    for _ in range(20):       # A is exhausted: with keep_alive the server idles
        if server.tick() is False:
            break
        time.sleep(0.01)
    assert server.tick() is not None
    frame_b = rng.integers(0, 256, (H, W, 3), np.uint8)
    produced = threading.Event()

    def src_b():
        if produced.is_set():
            time.sleep(0.01)
        produced.set()
        return np.array(frame_b)

    server.attach(src_b, out_b.append)
    deadline = time.monotonic() + 30
    while not out_b and time.monotonic() < deadline:
        server.tick()
        server._drain(force=True)
        time.sleep(0.005)
    server.finish()
    assert out_b, "attached stream B never delivered"
    np.testing.assert_array_equal(out_b[0], FramePipeline(LITE, SMALL, device="cpu")
                                  .step(frame_b)[0].numpy())


def test_multistream_server_attach_full_raises():
    S = 2
    server = MultiStreamServer(MultiStreamPipeline(LITE, SMALL, S, device="cpu"),
                               [lambda: None] * S, [lambda _: None] * S)
    with pytest.raises(RuntimeError, match="occupied"):
        server.attach(lambda: None, lambda _: None)
    with pytest.raises(ValueError, match="not attached"):
        server.detach(S + 3)


def test_multigeometry_server_per_stream_models(rng):
    """The same geometry under two models: two buckets, each stream equal
    to its solo run (N reference processes each pick their -m)."""
    N = 2
    frames = {m: [rng.integers(0, 256, (H, W, 3), np.uint8) for _ in range(N)]
              for m in (LITE, MLKIT)}
    outs = {m: [] for m in (LITE, MLKIT)}
    server = MultiGeometryServer(
        LITE, PipelineConfig(width=0, height=0, use_bilateral=False),
        [(_src(frames[LITE]), outs[LITE].append, W, H, None, None),
         (_src(frames[MLKIT]), outs[MLKIT].append, W, H, None, None, MLKIT)], device="cpu")
    assert server.n_groups == 2 and server.run() == N
    for m in (LITE, MLKIT):
        solo = FramePipeline(m, SMALL, device="cpu")
        for i in range(N):
            np.testing.assert_array_equal(outs[m][i], solo.step(frames[m][i])[0].numpy())


def test_multistream_server_mjpg_output(rng):
    """MJPG out: the batched step's coefficients a stream pack to the
    bytes of a solo step's."""
    from backscrub_tpu_torch.io.streams import JpegPackingSink
    S = 3
    cfg = PipelineConfig(width=W, height=H, use_bilateral=False, output_format="mjpg",
                         out_jpeg_quality=90)
    ms = MultiStreamPipeline(LITE, cfg, S, device="cpu")
    frames = [rng.integers(0, 256, (H, W, 3), np.uint8) for _ in range(S)]
    jpgs = [[] for _ in range(S)]
    sinks = [JpegPackingSink(ms.pipe.out_jpeg_info, ms.pipe.out_jpeg_qtabs,
                             jpgs[s].append).write_yuyv for s in range(S)]
    server = MultiStreamServer(ms, [_src([f] * 2) for f in frames], sinks)
    assert server.run() == 2 and all(len(j) == 2 for j in jpgs)
    solo = FramePipeline(LITE, cfg, device="cpu")
    solo_sink = []
    out, _ = solo.step(frames[2])
    JpegPackingSink(solo.out_jpeg_info, solo.out_jpeg_qtabs,
                    solo_sink.append).write_yuyv([c.numpy() for c in out])
    assert jpgs[2][0] == solo_sink[0]
    assert jpgs[2][0][:2] == b"\xff\xd8" and jpgs[2][0][-2:] == b"\xff\xd9"


def _solo_bars(path, geo, seq, outs):
    solo = FramePipeline(path, PipelineConfig(width=geo[0], height=geo[1],
                                              use_bilateral=False), device="cpu")
    fracs = [_close(outs[i], solo.step(f, None)[0].numpy()) for i, f in enumerate(seq)]
    assert np.mean(fracs) <= 0.002


def test_multigeometry_server_elastic_novel_geometry(rng):
    ga, gb = (64, 48), (128, 96)
    frames_a = [rng.integers(0, 256, (48, 64, 3), np.uint8) for _ in range(5)]
    frames_b = [rng.integers(0, 256, (96, 128, 3), np.uint8) for _ in range(3)]
    frames_c = [rng.integers(0, 256, (48, 64, 3), np.uint8) for _ in range(2)]
    out_a, out_b, out_c = [], [], []
    server = MultiGeometryServer(LITE, PipelineConfig(width=0, height=0, use_bilateral=False),
                                 [(_src(frames_a), out_a.append, *ga)], device="cpu")
    assert server.n_groups == 1 and server.run(frames=2) == 2 and len(out_a) == 2
    server.attach(_src(frames_b), out_b.append, *gb)       # a new bucket
    assert server.n_groups == 2
    server.attach(_src(frames_c), out_c.append, *ga)       # A's bucket, grown
    assert server.n_groups == 2
    server.run()
    assert (len(out_a), len(out_b), len(out_c)) == (5, 3, 2)
    for geo, seq, outs in ((ga, frames_a, out_a), (gb, frames_b, out_b),
                           (ga, frames_c, out_c)):
        _solo_bars(LITE, geo, seq, outs)


def test_multigeometry_server_detach_retires_bucket(rng):
    out_a, out_d = [], []
    frames_a = [rng.integers(0, 256, (48, 64, 3), np.uint8) for _ in range(2)]
    server = MultiGeometryServer(LITE, PipelineConfig(width=0, height=0, use_bilateral=False),
                                 [(_src(frames_a), out_a.append, 64, 48)], device="cpu")
    hd = server.attach(lambda: rng.integers(0, 256, (24, 32, 3), np.uint8),
                       out_d.append, 32, 24)
    assert server.n_groups == 2
    server.detach(hd)
    assert server.n_groups == 1
    with pytest.raises(ValueError):
        server.detach(hd)
    server.run()
    assert len(out_a) == 2


def test_multigeometry_server_threaded_midrun_attach(rng):
    frame_a = rng.integers(0, 256, (48, 64, 3), np.uint8)
    frame_b = rng.integers(0, 256, (96, 128, 3), np.uint8)
    stop = threading.Event()
    out_a, out_b = [], []

    def source(frame):
        def src():
            if stop.is_set():
                return None
            time.sleep(0.002)
            return np.array(frame)
        return src

    server = MultiGeometryServer(LITE, PipelineConfig(width=0, height=0, use_bilateral=False),
                                 [(source(frame_a), out_a.append, 64, 48)], device="cpu",
                                 threaded=True, keep_alive=True, stall_timeout=5.0)
    t = threading.Thread(target=server.run, daemon=True)
    t.start()
    deadline = time.monotonic() + 60
    while len(out_a) < 2 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert len(out_a) >= 2, "stream A never warmed up"
    n_before = len(out_a)
    server.attach(source(frame_b), out_b.append, 128, 96)
    assert server.n_groups == 2
    deadline = time.monotonic() + 60
    while not out_b and time.monotonic() < deadline:
        time.sleep(0.01)
    assert out_b, "attached novel-geometry stream never delivered"
    assert len(out_a) > n_before, "existing stream stalled during attach"
    stop.set()
    t.join(timeout=60)
    assert not t.is_alive()
    _close(out_b[0], FramePipeline(LITE, PipelineConfig(width=128, height=96,
                                                        use_bilateral=False),
                                   device="cpu").step(frame_b, None)[0].numpy())


def test_multigeometry_server_bucket_capacity_grows(rng):
    """One stream more than a full bucket's slots grows the bucket: a
    larger sibling is built and warmed off the tick path and every
    occupied slot migrates, EMA rows included, so the streams' outputs go
    on equal to their solo runs across the splice; handles taken before
    the growth detach the right stream after it."""
    D, n_frames = 2, 4
    seqs = [[rng.integers(0, 256, (H, W, 3), np.uint8) for _ in range(n_frames)]
            for _ in range(D + 1)]
    outs = [[] for _ in range(D + 1)]
    server = MultiGeometryServer(LITE, PipelineConfig(width=0, height=0, use_bilateral=False),
                                 [(_src(seqs[s]), outs[s].append, W, H) for s in range(D - 1)],
                                 device="cpu")
    assert server.servers[0].ms.n_streams == D - 1
    h_pre = server.attach(_src(seqs[D - 1]), outs[D - 1].append, W, H)     # grows to D
    srv0 = server.servers[0]
    assert srv0.ms.n_streams == D and sum(s is not None for s in srv0.sources) == D
    assert server.run(frames=2) == 2        # every EMA mid-decay at the growth
    server.attach(_src(seqs[D]), outs[D].append, W, H)
    assert server.n_groups == 1
    grown = server.servers[0]
    assert grown is not srv0 and grown.ms.n_streams == D + 1 and h_pre.srv is grown
    server.run()
    assert all(len(o) == n_frames for o in outs)
    for s in range(D + 1):
        solo = FramePipeline(LITE, SMALL, device="cpu")
        for i, f in enumerate(seqs[s]):
            np.testing.assert_array_equal(outs[s][i], solo.step(f, None)[0].numpy())
    server.detach(h_pre)
    assert sum(s is not None for s in grown.sources) == D
