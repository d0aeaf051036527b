"""The port's CUDA kernels against their plain PyTorch versions on the
card.  Every test needs an NVIDIA GPU and nvcc and skips elsewhere.

This file imports neither JAX nor the JAX package, so it runs on a
machine that has only PyTorch; tests/conftest.py imports JAX, so there
run it as::

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import dataclasses
import pathlib
import sys

import numpy as np
import pytest
import torch

from backscrub_tpu_torch import _build
from backscrub_tpu_torch.graph.executor import build_model
from backscrub_tpu_torch.ops.megakernel import (BodyPlan, body_launch, conv1x1_bf16_plain,
                                                conv1x1_bf16x3_plain, conv1x1_bf16x6_plain,
                                                conv1x1_gemm, conv1x1_plain, split_bf16,
                                                wgmma_weights)
from backscrub_tpu_torch.ops.image_kernels import bilateral5
from backscrub_tpu_torch.ops.pack_kernels import (blend_pack_420, blend_pack_420_plain,
                                                  blend_pack_yuyv, blend_pack_yuyv_plain)
from backscrub_tpu_torch.pipeline import edge as tedge
from backscrub_tpu_torch.pipeline.frame import FramePipeline, PipelineConfig
from backscrub_tpu_torch.pipeline.image import bilateral5 as bilateral5_plain
from backscrub_tpu_torch.pipeline.maskgen import MaskGen, normalize, preprocess

ROOT = pathlib.Path(__file__).resolve().parent.parent
FULL = ROOT / "tests" / "data" / "segm_synth_lite_96x160.tflite"
DEEPLAB = ROOT / "tests" / "data" / "deeplab_synth_257.tflite"
SELFIE = ROOT / "tests" / "data" / "selfie_synth_mlkit_256x256.tflite"
SEGM_FULL = ROOT / "tests" / "data" / "segm_synth_full_144x256.tflite"
BODYPIX = ROOT / "tests" / "data" / "body-pix_synth_050_8_257.tflite"

pytestmark = pytest.mark.cuda


def plain_input(mg, frame):
    """The classic preprocess with the plain bilateral: the canvas before
    the bilateral (``preprocess`` with no bilateral and no normalization),
    then the plain version, rounding and the spec's normalization."""
    canvas = preprocess(frame, mg.geo, dataclasses.replace(mg.spec, scale=1.0, offset=0.0),
                        use_bilateral=False)
    return normalize(torch.round(bilateral5_plain(canvas.contiguous())), mg.spec)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels build only there)")
    return torch.device("cuda")


def span_graph(ir):
    """A 12x12x8 body span built from ``ir``'s GraphIR/NodeIR/TensorIR (the
    JAX package's or the port's) with what the segm models do not reach:
    a dilated depthwise, a global pool with a fused activation, a broadcast
    ADD gate, a 5x5 stride-2 depthwise, a spatial MUL.  Returns (graph, output
    tensor id)."""
    rng = np.random.default_rng(8)
    C, H = 8, 12
    ts = []

    def t(shape, data=None, dtype=np.float32):
        ts.append(ir.TensorIR(len(ts), f"t{len(ts)}", tuple(shape), dtype,
                              None if data is None else np.asarray(data, dtype)))
        return len(ts) - 1

    def w(*shape):
        return t(shape, rng.standard_normal(shape) * 0.5)

    x = t((1, H, H, C))
    nodes = []

    def node(kind, inputs, shape, **opts):
        out = t(shape)
        nodes.append(ir.NodeIR(kind, inputs, [out], opts))
        return out

    dw = dict(padding="SAME", stride_h=1, stride_w=1, depth_multiplier=1)
    a = node("CONV_2D", [x, w(C, 1, 1, C), w(C)], (1, H, H, C), padding="SAME",
             stride_h=1, stride_w=1, activation="RELU6")
    b = node("DEPTHWISE_CONV_2D", [a, w(1, 3, 3, C), w(C)], (1, H, H, C),
             dilation_h=2, dilation_w=2, activation="RELU", **dw)
    p = node("AVERAGE_POOL_2D", [b], (1, 1, 1, C), padding="VALID", stride_h=H,
             stride_w=H, filter_h=H, filter_w=H, activation="RELU")
    f = node("FULLY_CONNECTED", [p, w(C, C), w(C)], (1, 1, 1, C),
             activation="NONE", keep_num_dims=True)
    g = node("LOGISTIC", [f], (1, 1, 1, C))
    c = node("ADD", [g, b], (1, H, H, C), activation="NONE")
    d = node("DEPTHWISE_CONV_2D", [c, w(1, 5, 5, C), w(C)], (1, H // 2, H // 2, C),
             activation="NONE", **dict(dw, stride_h=2, stride_w=2))
    size = t((2,), [H, H], np.int32)
    u = node("RESIZE_BILINEAR", [d, size], (1, H, H, C), align_corners=False,
             half_pixel_centers=True)
    k = node("CONCATENATION", [u, a], (1, H, H, 2 * C), axis=3, activation="NONE")
    out = node("MUL", [k, k], (1, H, H, 2 * C), activation="NONE")
    return ir.GraphIR("span", ts, nodes, [x], [out]), out


def flat_graph(ir):
    """A 33x33x16 flat span (the deeplab continuation's regime) built from
    ``ir``: a spatial 1x1 conv, the ASPP pooling branch (global pool, 1x1 on
    the pooled vector, 1x1 -> 33x33 broadcast), a concat of the broadcast
    and the conv, a projection 1x1 conv and a residual ADD of the input.
    Returns (graph, output tensor id)."""
    rng = np.random.default_rng(9)
    C, H = 16, 33
    ts = []

    def t(shape, data=None, dtype=np.float32):
        ts.append(ir.TensorIR(len(ts), f"t{len(ts)}", tuple(shape), dtype,
                              None if data is None else np.asarray(data, dtype)))
        return len(ts) - 1

    def w(*shape):
        return t(shape, rng.standard_normal(shape) / np.sqrt(shape[-1]))

    x = t((1, H, H, C))
    nodes = []

    def node(kind, inputs, shape, **opts):
        out = t(shape)
        nodes.append(ir.NodeIR(kind, inputs, [out], opts))
        return out

    conv = dict(padding="SAME", stride_h=1, stride_w=1)
    a = node("CONV_2D", [x, w(24, 1, 1, C), w(24)], (1, H, H, 24), activation="RELU", **conv)
    p = node("AVERAGE_POOL_2D", [a], (1, 1, 1, 24), padding="VALID", stride_h=H,
             stride_w=H, filter_h=H, filter_w=H, activation="NONE")
    f = node("CONV_2D", [p, w(8, 1, 1, 24), w(8)], (1, 1, 1, 8), activation="RELU", **conv)
    size = t((2,), [H, H], np.int32)
    u = node("RESIZE_BILINEAR", [f, size], (1, H, H, 8), align_corners=False,
             half_pixel_centers=False)
    k = node("CONCATENATION", [u, a], (1, H, H, 32), axis=3, activation="NONE")
    y = node("CONV_2D", [k, w(C, 1, 1, 32), w(C)], (1, H, H, C), activation="NONE", **conv)
    out = node("ADD", [y, x], (1, H, H, C), activation="RELU6")
    return ir.GraphIR("flat", ts, nodes, [x], [out]), out


def test_synthetic_span_kernels_match_plain(cuda_device):
    """A plan runs on the card only as its op table: not compiled, it
    raises; compiled, one bs_body_mega launch matches the plain plan."""
    from backscrub_tpu_torch.tflite import ir
    g, out = span_graph(ir)
    plan = BodyPlan(build_model(g), 0, len(g.nodes), 0, out)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((8, 144)).astype(
        np.float32)).to(cuda_device)
    with pytest.raises(RuntimeError, match="compile_mega"):
        plan.run_cuda(x)
    plan.compile_mega()
    before = body_launch.by_kernel["bs_body_mega"]
    torch.testing.assert_close(plan.run_cuda(x), plan.run_plain(x), atol=2e-3, rtol=1e-3)
    assert body_launch.by_kernel["bs_body_mega"] == before + 1


def _front_case(case, dev):
    """(canvas, parameter block, front kwargs) of a K1 case on ``dev``: the
    segm front (96x160 canvas of a 320x240 frame), the deeplab front
    (257x257 of a 640x480 frame), or a ragged 37x54 canvas with Cout = 13
    (seeded) whose oh, ow and Cout divide no tile."""
    if case == "ragged":
        rng = np.random.default_rng(11)
        img = rng.integers(0, 256, (3, 37, 54)).astype(np.float32)
        canvas = np.pad(img, ((0, 0), (2, 2), (2, 2)), mode="reflect")
        params = tedge.front_params((rng.standard_normal((3, 3, 3, 13)) * 0.2).astype(
            np.float32), (rng.standard_normal(13) * 0.1).astype(np.float32))
        kw = dict(H=37, W=54, oh=19, ow=27, pad_lo_h=1, pad_lo_w=0, use_bilateral=True,
                  scale=1 / 127.5, offset=-1.0, activation="RELU6")
        return torch.from_numpy(canvas).to(dev), torch.from_numpy(params).to(dev), kw
    path, (w, h) = (FULL, (320, 240)) if case == "segm" else (DEEPLAB, (640, 480))
    e = FramePipeline(str(path), PipelineConfig(width=w, height=h), device=dev).maskgen.edge
    return e.canvas(torch.from_numpy(_frame(w, h)).to(dev)), e.front_params, e.front_kwargs()


@pytest.mark.parametrize("activation", ["NONE", "RELU6", "HARD_SWISH"])
@pytest.mark.parametrize("use_bilateral", [True, False])
@pytest.mark.parametrize("case", ["segm", "deeplab", "ragged"])
def test_front_kernel_variants_match_plain(cuda_device, case, activation, use_bilateral):
    canvas, params, kw = _front_case(case, cuda_device)
    kw = dict(kw, activation=activation, use_bilateral=use_bilateral)
    with torch.no_grad():
        before = tedge.front_fused.launches
        got = tedge.front_fused(canvas, params, **kw)
        assert tedge.front_fused.launches == before + 1
        torch.testing.assert_close(got, tedge.front_plain(canvas, params, **kw),
                                   atol=2e-3, rtol=1e-3)


@pytest.mark.parametrize("tile", tedge.FRONT_TILES)
@pytest.mark.parametrize("case", ["segm", "deeplab", "ragged"])
def test_front_kernel_tiles_agree(cuda_device, monkeypatch, case, tile):
    """Each tile of FRONT_TILES, forced, gives the bits of front_tile's own
    choice (each output's 27-tap chain does not depend on the tiling)
    within the bar of the plain version."""
    canvas, params, kw = _front_case(case, cuda_device)
    with torch.no_grad():
        own = tedge.front_fused(canvas, params, **kw)
        monkeypatch.setattr(tedge, "front_tile", lambda oh, ow, sms: tile)
        got = tedge.front_fused(canvas, params, **kw)
        torch.testing.assert_close(got, tedge.front_plain(canvas, params, **kw),
                                   atol=2e-3, rtol=1e-3)
        assert torch.equal(got, own), f"tile {tile}"


def test_front_kernels_on_two_streams(cuda_device):
    """Fronts with different weights, launched alternately on two streams,
    each read their own parameter block."""
    pipe = FramePipeline(str(FULL), PipelineConfig(width=640, height=480),
                         device=cuda_device)
    e = pipe.maskgen.edge
    kw = e.front_kwargs()
    other = e.front_params.clone()
    other[:-13] = torch.from_numpy(np.random.default_rng(5).standard_normal(
        other.numel() - 13).astype(np.float32)).to(cuda_device)
    params = (e.front_params, other)
    streams = (torch.cuda.Stream(), torch.cuda.Stream())
    outs = ([], [])
    with torch.no_grad():
        canvas = e.canvas(torch.from_numpy(_frame(640, 480)).to(cuda_device))
        torch.cuda.synchronize()
        for _ in range(8):
            for k in (0, 1):
                with torch.cuda.stream(streams[k]):
                    outs[k].append(tedge.front_fused(canvas, params[k], **kw))
        torch.cuda.synchronize()
        for k in (0, 1):
            ref = tedge.front_plain(canvas, params[k], **kw)
            for o in outs[k]:
                torch.testing.assert_close(o, ref, atol=2e-3, rtol=1e-3)


def _frames(w, h, n, seed=0):
    tools = str(ROOT / "tools")
    if tools not in sys.path:
        sys.path.insert(0, tools)
    from make_synth_segm import moving_frames
    return moving_frames(w, h, n, seed)


def _frame(w, h):
    return _frames(w, h, 1)[0]


def _pack_inputs(h, w, dev, seed=3):
    """Seeded frame, background and mask (a quarter of rows 255, a quarter
    0, the rest random)."""
    rng = np.random.default_rng(seed)
    fr, bg = (torch.from_numpy(rng.integers(0, 256, (h, w, 3), np.uint8)).to(dev)
              for _ in range(2))
    m = rng.integers(0, 256, (h, w), np.uint8)
    m[: h // 4], m[h // 4: h // 2] = 255, 0
    return fr, bg, torch.from_numpy(m).to(dev)


@pytest.mark.parametrize("h,w", [(37, 64), (480, 640), (720, 1280), (37, 642), (721, 1282)])
def test_blend_pack_kernel_matches_plain(cuda_device, h, w):
    fr, bg, m = _pack_inputs(h, w, cuda_device)
    for order in ("reference", "yuy2"):
        for cc in (False, True):
            before = blend_pack_yuyv.launches
            got = blend_pack_yuyv(fr, bg, m, order, cc)
            assert blend_pack_yuyv.launches == before + 1
            assert torch.equal(got, blend_pack_yuyv_plain(fr, bg, m, order, cc))


def test_blend_pack_kernel_on_misaligned_views(cuda_device):
    """Views one row into contiguous frames of width 642 start off a 4-byte
    boundary (1926 and 642 bytes in), so off every vector width: the kernel
    takes its per-pair path and stays byte-identical."""
    h, w = 37, 642
    big_fr, big_bg, big_m = _pack_inputs(h + 1, w, cuda_device, seed=5)
    fr, bg, m = big_fr[1:], big_bg[1:], big_m[1:]
    assert fr.is_contiguous() and fr.data_ptr() % 4 and m.data_ptr() % 4
    for order in ("reference", "yuy2"):
        for cc in (False, True):
            ref = blend_pack_yuyv_plain(fr, bg, m, order, cc)
            assert torch.equal(blend_pack_yuyv(fr, bg, m, order, cc), ref)
            assert torch.equal(blend_pack_yuyv(fr, bg, big_m[1:].clone(), order, cc), ref)


@pytest.mark.parametrize("w,h", [(640, 480), (1280, 720)])
def test_front_and_body_kernels_match_plain(cuda_device, w, h):
    pipe = FramePipeline(str(FULL), PipelineConfig(width=w, height=h), device=cuda_device)
    e = pipe.maskgen.edge
    frame = torch.from_numpy(_frame(w, h)).to(cuda_device)
    with torch.no_grad():
        canvas, kw = e.canvas(frame), e.front_kwargs()
        before = tedge.front_fused.launches
        k1 = tedge.front_fused(canvas, e.front_params, **kw)
        assert tedge.front_fused.launches == before + 1
        torch.testing.assert_close(k1, tedge.front_plain(canvas, e.front_params, **kw),
                                   atol=2e-3, rtol=1e-3)
        x = k1.reshape(k1.shape[0], -1)
        before = body_launch.launches
        k2 = e.body_plan.run_cuda(x)
        assert body_launch.launches == before + e.body_plan.launches_per_run
        torch.testing.assert_close(k2, e.body_plan.run_plain(x), atol=2e-3, rtol=1e-3)


@pytest.mark.parametrize("h,w", [(42, 58), (480, 640), (720, 1280), (480, 642)])
def test_blend_pack_420_kernel_matches_plain(cuda_device, h, w):
    """K4 byte-identical to its plain version, NV12 and I420: the vector
    path at W % 4 == 0, the per-block path at W % 4 == 2."""
    rng = np.random.default_rng(h)
    fr, bg = (torch.from_numpy(rng.integers(0, 256, (h, w, 3), np.uint8)).to(cuda_device)
              for _ in range(2))
    m = rng.integers(0, 256, (h, w), np.uint8)
    m[: h // 4], m[h // 4: h // 2] = 255, 0
    m = torch.from_numpy(m).to(cuda_device)
    for layout in ("nv12", "i420"):
        before = blend_pack_420.launches
        got = blend_pack_420(fr, bg, m, layout)
        assert blend_pack_420.launches == before + 1
        assert torch.equal(got, blend_pack_420_plain(fr, bg, m, layout))


def test_blend_pack_420_kernel_on_misaligned_views(cuda_device):
    """A view one row into a 642-wide frame starts off a 4-byte boundary
    (1926 and 642 bytes in): every block takes the per-block path, byte-
    identical, NV12 and I420."""
    h, w = 480, 642
    big_fr, big_bg, big_m = _pack_inputs(h + 1, w, cuda_device, seed=6)
    fr, bg, m = big_fr[1:], big_bg[1:], big_m[1:]
    assert fr.is_contiguous() and fr.data_ptr() % 4 and m.data_ptr() % 4
    for layout in ("nv12", "i420"):
        assert torch.equal(blend_pack_420(fr, bg, m, layout),
                           blend_pack_420_plain(fr, bg, m, layout))


@pytest.mark.parametrize("n,h,w", [(1, 96, 160), (1, 257, 257), (4, 257, 257), (2, 5, 7)])
def test_bilateral_kernel_matches_plain(cuda_device, n, h, w):
    """K5 within allclose(atol=2e-3, rtol=1e-3) of its plain version; after
    rounding no byte off by more than 1."""
    x = torch.from_numpy(np.random.default_rng(n * h).integers(
        0, 256, (n, h, w, 3)).astype(np.float32)).to(cuda_device)
    x = x[0] if n == 1 else x
    before = bilateral5.launches
    got = bilateral5(x)
    assert bilateral5.launches == before + 1
    ref = bilateral5_plain(x)
    torch.testing.assert_close(got, ref, atol=2e-3, rtol=1e-3)
    assert float((torch.round(got) - torch.round(ref)).abs().max()) <= 1


def test_classic_nv12_pipeline_launches_and_matches_plain(cuda_device):
    """Three frames of the classic path with NV12 out: one K5 and one K4
    launch a frame, no K1/K2/K3; the outputs against the plain path on the
    card under the tolerance invariant."""
    w, h = 640, 480
    pipe = FramePipeline(str(FULL), PipelineConfig(width=w, height=h, edge_fused=False,
                                                   output_format="nv12"),
                         device=cuda_device)
    mg = pipe.maskgen
    frames = [torch.from_numpy(f).to(cuda_device) for f in _frames(w, h, 3)]
    bg = torch.from_numpy(np.random.default_rng(4).integers(
        0, 256, (h, w, 3), np.uint8)).to(cuda_device)
    counters = (bilateral5, blend_pack_420, tedge.front_fused, body_launch, blend_pack_yuyv)
    before = [c.launches for c in counters]
    ema = mg.ema.clone()
    fracs = []
    with torch.no_grad():
        for f in frames:
            out, mask = pipe.step(f, bg)
            x = plain_input(mg, f)
            rm, ema = mg._decode_post(mg._infer(x), ema)
            for a, b in ((out, blend_pack_420_plain(f, bg, rm)), (mask, rm)):
                assert int((a.int() - b.int()).abs().max()) <= 1
                fracs.append(float((a != b).float().mean()))
    assert [c.launches - b for c, b in zip(counters, before)] == [3, 3, 0, 0, 0]
    assert max(fracs) <= 0.02 and float(np.mean(fracs)) <= 0.002


def test_fused_nv12_pipeline_launches_and_matches_plain(cuda_device):
    """Three frames of the default (fused) segm path with NV12 out: one K1,
    one K2 and one K4 launch a frame, no K3 or K5; output and mask against
    the plain path on the card under the tolerance invariant."""
    w, h = 640, 480
    pipe = FramePipeline(str(FULL), PipelineConfig(width=w, height=h, output_format="nv12"),
                         device=cuda_device)
    e = pipe.maskgen.edge
    assert e is not None and e.body_plan is not None
    frames = [torch.from_numpy(f).to(cuda_device) for f in _frames(w, h, 3)]
    bg = torch.from_numpy(np.random.default_rng(4).integers(
        0, 256, (h, w, 3), np.uint8)).to(cuda_device)
    counters = (tedge.front_fused, body_launch, blend_pack_420, blend_pack_yuyv, bilateral5)
    ema = pipe.maskgen.ema.clone()
    fracs = []
    with torch.no_grad():
        for f in frames:
            before = [c.launches for c in counters]
            out, mask = pipe.step(f, bg)
            assert [c.launches - b for c, b in zip(counters, before)] == [1, 1, 1, 0, 0]
            k1 = tedge.front_plain(e.canvas(f), e.front_params, **e.front_kwargs())
            ema = e.tail(e.body_plan.run_plain(k1.reshape(k1.shape[0], -1)), ema)
            rm = e.postprocess(ema)
            for a, b in ((out, blend_pack_420_plain(f, bg, rm)), (mask, rm)):
                assert a.shape == b.shape and int((a.int() - b.int()).abs().max()) <= 1
                fracs.append(float((a != b).float().mean()))
    assert max(fracs) <= 0.02 and float(np.mean(fracs)) <= 0.002


@pytest.mark.parametrize("w,h", [(640, 480), (1280, 720)])
def test_selfie_front_and_body_match_plain(cuda_device, w, h):
    """The mlkit selfie family's K1 (256x256 canvas -> 16x128x128) and K2
    (its 128-wide body as one bs_body_mega launch) against their plain
    versions; two K2 runs bit-identical."""
    pipe = FramePipeline(str(SELFIE), PipelineConfig(width=w, height=h), device=cuda_device)
    e = pipe.maskgen.edge
    assert e.info.tail_kind == "threshold" and e.body_plan.launches_per_run == 1
    frame = torch.from_numpy(_frame(w, h)).to(cuda_device)
    with torch.no_grad():
        canvas, kw = e.canvas(frame), e.front_kwargs()
        k1 = tedge.front_fused(canvas, e.front_params, **kw)
        torch.testing.assert_close(k1, tedge.front_plain(canvas, e.front_params, **kw),
                                   atol=2e-3, rtol=1e-3)
        x = k1.reshape(k1.shape[0], -1)
        before = dict(body_launch.by_kernel)
        got = e.body_plan.run_cuda(x).clone()
        again = e.body_plan.run_cuda(x)
        torch.cuda.synchronize()
    assert body_launch.by_kernel["bs_body_mega"] == before.get("bs_body_mega", 0) + 2
    torch.testing.assert_close(got, e.body_plan.run_plain(x), atol=2e-3, rtol=1e-3)
    assert torch.equal(got, again)


def _near_tie_flips(ema_k, ema, margin, ever_flipped):
    """The decode flip rule: a decode that differs (EMA bits 5-7) sits at
    |margin| <= 1e-3, and the EMAs are equal wherever no decode flipped."""
    flipped = (ema_k >> 5) != (ema >> 5)
    assert bool((margin[flipped].abs() <= 1e-3).all())
    ever_flipped |= flipped
    assert torch.equal(ema_k[~ever_flipped], ema[~ever_flipped])


def test_selfie_fused_pipeline_launches_and_matches_plain(cuda_device):
    """Three frames of the mlkit selfie family's fused path, YUYV out: one
    K1, one K2 and one K3 launch a frame (the threshold tail between K2 and
    the post), no K4 or K5; against the plain path under the decode flip
    rule, no byte off by more than 1 outside the flips' post footprint."""
    w, h = 640, 480
    pipe = FramePipeline(str(SELFIE), PipelineConfig(width=w, height=h), device=cuda_device)
    e = pipe.maskgen.edge
    frames = [torch.from_numpy(f).to(cuda_device) for f in _frames(w, h, 3)]
    bg = torch.from_numpy(np.random.default_rng(4).integers(
        0, 256, (h, w, 3), np.uint8)).to(cuda_device)
    counters = (tedge.front_fused, body_launch, blend_pack_yuyv, blend_pack_420, bilateral5)
    ema = pipe.maskgen.ema.clone()
    ever = torch.zeros_like(ema, dtype=torch.bool)
    fracs = []
    with torch.no_grad():
        for f in frames:
            before = [c.launches for c in counters]
            out, mask = pipe.step(f, bg)
            assert [c.launches - b for c, b in zip(counters, before)] == [1, 1, 1, 0, 0]
            body = e.body(e.front(f, plain=True), plain=True)
            body = body.reshape(body.shape[0], -1)
            margin = e.tail_logits(body) - e.info.tail_threshold
            ema = e.tail(body, ema)
            _near_tie_flips(pipe.maskgen.ema, ema, margin, ever)
            rm = e.postprocess(ema)
            foot = tedge.post_footprint(pipe.maskgen.ema != ema, e.geo, e.post_mats)
            foot_yuyv = foot.reshape(h, w // 2, 2).any(-1)[..., None].expand(h, w // 2, 4)
            for a, b, m in ((out, blend_pack_yuyv_plain(f, bg, rm), foot_yuyv.reshape(h, 2 * w)),
                            (mask, rm, foot)):
                assert a.shape == b.shape
                assert int(torch.where(m, 0, (a.int() - b.int()).abs()).max()) <= 1
                fracs.append(float((a != b).float().mean()))
    assert max(fracs) <= 0.02 and float(np.mean(fracs)) <= 0.002
    assert 0.01 < float((mask < 128).float().mean()) < 0.99


def test_selfie_classic_nv12_pipeline_launches_and_matches_plain(cuda_device):
    """Three frames of the mlkit selfie family's classic path with NV12
    out: one K5 (256x256 canvas) and one K4 launch a frame, no K1/K2/K3;
    the masks against the plain path under the decode flip rule (the
    margin the logit of the model's probability less logit(0.65))."""
    w, h = 640, 480
    pipe = FramePipeline(str(SELFIE), PipelineConfig(width=w, height=h, edge_fused=False,
                                                     output_format="nv12"),
                         device=cuda_device)
    mg = pipe.maskgen
    frames = [torch.from_numpy(f).to(cuda_device) for f in _frames(w, h, 3)]
    bg = torch.from_numpy(np.random.default_rng(4).integers(
        0, 256, (h, w, 3), np.uint8)).to(cuda_device)
    counters = (bilateral5, blend_pack_420, tedge.front_fused, body_launch, blend_pack_yuyv)
    thr = float(np.log(0.65 / 0.35))
    ema = mg.ema.clone()
    ever = torch.zeros_like(ema, dtype=torch.bool)
    with torch.no_grad():
        for f in frames:
            before = [c.launches for c in counters]
            out, mask = pipe.step(f, bg)
            assert [c.launches - b for c, b in zip(counters, before)] == [1, 1, 0, 0, 0]
            prob = mg._infer(plain_input(mg, f))
            rm, ema = mg._decode_post(prob, ema)
            p = prob[..., 0].double()
            _near_tie_flips(mg.ema, ema, torch.log(p / (1 - p)) - thr, ever)
            foot = tedge.post_footprint(mg.ema != ema, mg.geo, mg.post_mats)
            assert int(torch.where(foot, 0, (mask.int() - rm.int()).abs()).max()) <= 1
            assert out.shape == blend_pack_420_plain(f, bg, rm).shape


def _family_front_and_body(path, w, h, device):
    """K1 and the family's one body plan (K2, or K2' alone) against their
    plain versions on a frame: allclose(2e-3, 1e-3), the plan one
    bs_body_mega launch a run, two runs bit-identical.  Returns the edge
    path."""
    pipe = FramePipeline(str(path), PipelineConfig(width=w, height=h), device=device)
    e = pipe.maskgen.edge
    plan = e.body_plan or e.prefix_plan
    assert e.cont_plan is None and plan.launches_per_run == 1
    frame = torch.from_numpy(_frame(w, h)).to(device)
    with torch.no_grad():
        canvas, kw = e.canvas(frame), e.front_kwargs()
        k1 = tedge.front_fused(canvas, e.front_params, **kw)
        torch.testing.assert_close(k1, tedge.front_plain(canvas, e.front_params, **kw),
                                   atol=2e-3, rtol=1e-3)
        x = k1.reshape(k1.shape[0], -1)
        before = dict(body_launch.by_kernel)
        got = plan.run_cuda(x).clone()
        again = plan.run_cuda(x)
        torch.cuda.synchronize()
    assert body_launch.by_kernel["bs_body_mega"] == before.get("bs_body_mega", 0) + 2
    torch.testing.assert_close(got, plan.run_plain(x), atol=2e-3, rtol=1e-3)
    assert torch.equal(got, again)
    return e


def _family_fused_matches_plain(path, device, margin, n=3):
    """``n`` frames of a family's fused path at 640x480, YUYV out: one K1,
    one body plan and one K3 launch a frame, no K4 or K5; against the plain
    path under the decode flip rule (``margin`` of the model output where
    there is no fused tail), no byte off by more than 1 outside the flips'
    post footprint."""
    from backscrub_tpu_torch.pipeline.decode import decode_val, ema_update
    w, h = 640, 480
    pipe = FramePipeline(str(path), PipelineConfig(width=w, height=h), device=device)
    e = pipe.maskgen.edge
    frames = [torch.from_numpy(f).to(device) for f in _frames(w, h, n)]
    bg = torch.from_numpy(np.random.default_rng(4).integers(
        0, 256, (h, w, 3), np.uint8)).to(device)
    counters = (tedge.front_fused, body_launch, blend_pack_yuyv, blend_pack_420, bilateral5)
    ema = pipe.maskgen.ema.clone()
    ever = torch.zeros_like(ema, dtype=torch.bool)
    fracs = []
    with torch.no_grad():
        for f in frames:
            before = [c.launches for c in counters]
            out, mask = pipe.step(f, bg)
            assert [c.launches - b for c, b in zip(counters, before)] == [1, 1, 1, 0, 0]
            body = e.body(e.front(f, plain=True), plain=True)
            if e.info.tail_ok:
                body = body.reshape(body.shape[0], -1)
                m = e.tail_logits(body) - e.info.tail_threshold
                ema = e.tail(body, ema)
            else:
                y = body.permute(1, 2, 0)
                m = margin(y)
                ema = ema_update(ema, decode_val(y, e.spec))
            _near_tie_flips(pipe.maskgen.ema, ema, m, ever)
            rm = e.postprocess(ema)
            foot = tedge.post_footprint(pipe.maskgen.ema != ema, e.geo, e.post_mats)
            foot_yuyv = foot.reshape(h, w // 2, 2).any(-1)[..., None].expand(h, w // 2, 4)
            for a, b, ft in ((out, blend_pack_yuyv_plain(f, bg, rm),
                              foot_yuyv.reshape(h, 2 * w)), (mask, rm, foot)):
                assert a.shape == b.shape
                assert int(torch.where(ft, 0, (a.int() - b.int()).abs()).max()) <= 1
                fracs.append(float((a != b).float().mean()))
    assert max(fracs) <= 0.02 and float(np.mean(fracs)) <= 0.002
    assert 0.01 < float((mask < 128).float().mean()) < 0.99


def _family_classic_matches_plain(path, device, margin, n=3):
    """``n`` frames of a family's classic path at 640x480 with NV12 out:
    one K5 and one K4 launch a frame, no K1/K2/K3; the masks against the
    plain path under the decode flip rule (``margin`` of the model
    output)."""
    w, h = 640, 480
    pipe = FramePipeline(str(path), PipelineConfig(width=w, height=h, edge_fused=False,
                                                   output_format="nv12"), device=device)
    mg = pipe.maskgen
    frames = [torch.from_numpy(f).to(device) for f in _frames(w, h, n)]
    bg = torch.from_numpy(np.random.default_rng(4).integers(
        0, 256, (h, w, 3), np.uint8)).to(device)
    counters = (bilateral5, blend_pack_420, tedge.front_fused, body_launch, blend_pack_yuyv)
    ema = mg.ema.clone()
    ever = torch.zeros_like(ema, dtype=torch.bool)
    with torch.no_grad():
        for f in frames:
            before = [c.launches for c in counters]
            out, mask = pipe.step(f, bg)
            assert [c.launches - b for c, b in zip(counters, before)] == [1, 1, 0, 0, 0]
            y = mg._infer(plain_input(mg, f))
            rm, ema = mg._decode_post(y, ema)
            _near_tie_flips(mg.ema, ema, margin(y), ever)
            foot = tedge.post_footprint(mg.ema != ema, mg.geo, mg.post_mats)
            assert int(torch.where(foot, 0, (mask.int() - rm.int()).abs()).max()) <= 1
            assert out.shape == blend_pack_420_plain(f, bg, rm).shape


@pytest.mark.parametrize("w,h", [(640, 480), (1280, 720)])
def test_segm_full_front_and_body_match_plain(cuda_device, w, h):
    """segm_full's K1 (144x256 canvas -> 16x72x128) and K2 (its segm body
    on a 128-wide first stage, one launch) against their plain versions."""
    e = _family_front_and_body(SEGM_FULL, w, h, cuda_device)
    assert e.body_plan is not None and e.info.tail_kind == "two_channel"


def test_segm_full_fused_pipeline_launches_and_matches_plain(cuda_device):
    """segm_full's fused path: K1, K2, the two-channel tail, K3."""
    _family_fused_matches_plain(SEGM_FULL, cuda_device, None)


def test_segm_full_classic_nv12_pipeline_launches_and_matches_plain(cuda_device):
    """segm_full's classic path: K5 at 144x256, the executor, K4."""
    _family_classic_matches_plain(SEGM_FULL, cuda_device, lambda y: y[..., 1] - y[..., 0])


@pytest.mark.parametrize("w,h", [(640, 480), (1280, 720)])
def test_bodypix_front_and_prefix_match_plain(cuda_device, w, h):
    """BodyPix's K1 (257x257 canvas -> 16x129x129, RELU6) and K2' alone
    (its MobileNetV1 prefix to 33x33, one launch) against their plain
    versions; the executor takes the rest."""
    e = _family_front_and_body(BODYPIX, w, h, cuda_device)
    assert e.prefix_plan is not None and e.rest is not None and e.post_mats is None


def test_bodypix_fused_pipeline_launches_and_matches_plain(cuda_device):
    """BodyPix's fused path: K1, K2', the executor remainder, the threshold
    decode on the logit, the two-stage post, K3."""
    _family_fused_matches_plain(BODYPIX, cuda_device, lambda y: y[..., 0] - 0.65)


def test_bodypix_classic_nv12_pipeline_launches_and_matches_plain(cuda_device):
    """BodyPix's classic path: K5 at 257x257, the executor, the threshold
    decode, the two-stage post, K4."""
    _family_classic_matches_plain(BODYPIX, cuda_device, lambda y: y[..., 0] - 0.65)


def test_staged_maskgen_on_card(cuda_device):
    """MaskGen(fused=False) on the card: the hooks in order, one K5 launch
    a frame."""
    calls = []
    mg = MaskGen(str(FULL), 640, 480, fused=False, device=cuda_device,
                 onprep=lambda: calls.append("prep"), oninfer=lambda: calls.append("infer"),
                 onmask=lambda: calls.append("mask"))
    before = bilateral5.launches
    for f in _frames(640, 480, 2):
        mask = mg.process(f)
        assert mask.device.type == "cuda" and mask.shape == (480, 640)
    assert calls == ["prep", "infer", "mask"] * 2 and bilateral5.launches == before + 2


def test_default_device_is_cuda(cuda_device):
    pipe = FramePipeline(str(FULL), PipelineConfig(width=320, height=240))
    assert pipe.device.type == "cuda" and pipe.maskgen.ema.device.type == "cuda"


def test_wrappers_validate_inputs(cuda_device):
    frame = torch.zeros((48, 64, 3), dtype=torch.uint8, device=cuda_device)
    mask = torch.zeros((48, 64), dtype=torch.uint8, device=cuda_device)
    with pytest.raises(ValueError):
        blend_pack_420(frame[:47], frame[:47], mask[:47])
    with pytest.raises(ValueError):
        blend_pack_420(frame, frame, mask, "yv12")
    with pytest.raises(ValueError):
        bilateral5(torch.zeros((2, 64, 3), device=cuda_device))
    with pytest.raises(ValueError):
        blend_pack_yuyv(frame, frame, mask.float())
    with pytest.raises(ValueError):
        blend_pack_yuyv(frame, frame[:, :32], mask)
    with pytest.raises(ValueError):
        blend_pack_yuyv(frame, frame.transpose(0, 1).contiguous().transpose(0, 1), mask)


# the deeplab frame's 15 1x1 shapes at L = 33 * 33, and ragged ones
_GEMM_SHAPES = [(co, ci, 1089) for co, ci in (
    (16, 96), (21, 256), (32, 96), (32, 192), (48, 192), (48, 288), (80, 288), (80, 480),
    (96, 16), (160, 480), (192, 32), (256, 160), (256, 512), (288, 48), (480, 80))] + [
    (7, 5, 33), (33, 100, 77), (130, 13, 1)]


@pytest.mark.parametrize("co,ci,L", _GEMM_SHAPES)
@pytest.mark.parametrize("act", ["NONE", "RELU6"])
def test_gemm_kernel_matches_plain(cuda_device, co, ci, L, act):
    """The K2'' bf16x3 GEMM (``bs_gemm`` at three terms, the wgmma tile) at
    the continuation's 15 shapes and at ragged ones: allclose(2e-3, 1e-3)
    of the f32 plain version, 1e-5 relative of the bf16x3 plain version,
    two runs bit-identical, the weights given as their split or laid out."""
    rng = np.random.default_rng(co * 1000 + ci)
    w, x = (torch.from_numpy((rng.standard_normal(s) / np.sqrt(ci)).astype(np.float32))
            .to(cuda_device) for s in ((co, ci), (ci, L)))
    b = torch.from_numpy(rng.standard_normal(co).astype(np.float32)).to(cuda_device)
    before = body_launch.by_kernel["bs_gemm"]
    got = conv1x1_gemm(w, b, x, act)
    again = conv1x1_gemm(w, b, x, act, split=split_bf16(w))
    laid = conv1x1_gemm(w, b, x, act, split=wgmma_weights(w, 3, L))
    assert body_launch.by_kernel["bs_gemm"] == before + 3
    torch.testing.assert_close(got, conv1x1_plain(w, b, x, act), atol=2e-3, rtol=1e-3)
    ref = conv1x1_bf16x3_plain(w, b, x, act)
    assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
    assert torch.equal(got, again) and torch.equal(got, laid)


@pytest.mark.parametrize("w,h", [(640, 480), (1280, 720)])
def test_body_mega_matches_plain(cuda_device, w, h):
    """K2 as one bs_body_mega launch a run, against the plain plan; two runs
    bit-identical."""
    pipe = FramePipeline(str(FULL), PipelineConfig(width=w, height=h), device=cuda_device)
    plan = pipe.maskgen.edge.body_plan
    with torch.no_grad():
        x = pipe.maskgen.edge.front(torch.from_numpy(_frame(w, h)).to(cuda_device))
        x = x.reshape(x.shape[0], -1)
        before = dict(body_launch.by_kernel)
        got = plan.run_cuda(x).clone()
        again = plan.run_cuda(x)
        torch.cuda.synchronize()
    assert body_launch.by_kernel["bs_body_mega"] == before.get("bs_body_mega", 0) + 2
    assert sum(body_launch.by_kernel.values()) == sum(before.values()) + 2
    torch.testing.assert_close(got, plan.run_plain(x), atol=2e-3, rtol=1e-3)
    assert torch.equal(got, again)


def test_body_mega_span_graph_matches_plain(cuda_device):
    """The persistent kernel's generic ops (dilated and 5x5/s2 depthwise,
    pooled activation, FC, broadcast ADD gate, resize, concat, spatial MUL)."""
    from backscrub_tpu_torch.tflite import ir
    g, out = span_graph(ir)
    plan = BodyPlan(build_model(g), 0, len(g.nodes), 0, out)
    plan.compile_mega()
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((8, 144)).astype(
        np.float32)).to(cuda_device)
    before = body_launch.by_kernel["bs_body_mega"]
    got = plan.run_cuda(x).clone()
    assert body_launch.by_kernel["bs_body_mega"] == before + 1 and plan.launches == 1
    torch.testing.assert_close(got, plan.run_plain(x), atol=2e-3, rtol=1e-3)
    assert torch.equal(got, plan.run_cuda(x))


def test_refused_launches_raise(cuda_device):
    """A table whose shared memory exceeds the card's, and a cluster the
    card does not schedule, raise instead of running."""
    pipe = FramePipeline(str(FULL), PipelineConfig(width=640, height=480), device=cuda_device)
    plan = pipe.maskgen.edge.body_plan
    x = torch.zeros((plan.in_meta.c, plan.in_meta.rows * plan.in_meta.w), device=cuda_device)
    arena, table = plan.mega.on(x.device)
    ws = torch.empty(plan._total, device=cuda_device)
    with pytest.raises(RuntimeError, match="bs_body_mega launch failed"):
        _build.launch("bs_body_mega", x.data_ptr(), ws.data_ptr(), arena.data_ptr(),
                      table.data_ptr(), len(plan.mega.ops), 300 * 1024, 0, 1, x.numel(),
                      plan.ws_stride, None)
    with pytest.raises(RuntimeError, match="bs_barrier_bench launch failed"):
        _build.launch("bs_barrier_bench", 1, 1, 64)
    _build.launch("bs_barrier_bench", 10, 0, 0)      # the grid the table runs on
    torch.cuda.synchronize()


def test_bcast_kernel(cuda_device):
    """The table's broadcast (the ASPP pooling branch: gpool, then the fc
    writing its output across the columns of a homed concat) and GEMM ops,
    one with a residual, on a small flat plan: one bs_body_mega launch,
    within allclose(atol=2e-4, rtol=1e-4) of the plain plan in its own
    arithmetic (run_plain(gemm="bf16x3")), two runs bit-identical."""
    from backscrub_tpu_torch.tflite import ir
    g, out = flat_graph(ir)
    plan = BodyPlan(build_model(g), 0, len(g.nodes), 0, out, flat=True)
    plan.compile_mega()
    assert plan.mega.kinds["gemm"] == 2 and plan.mega.kinds["copy"] == 0
    assert [m.get("bn") for m in plan.mega.ops if m["kind"] == "fc"] == [1089]
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((16, 1089)).astype(
        np.float32)).to(cuda_device)
    before = body_launch.by_kernel["bs_body_mega"]
    got = plan.run_cuda(x).clone()
    assert body_launch.by_kernel["bs_body_mega"] == before + 1
    torch.testing.assert_close(got, plan.run_plain(x, gemm="bf16x3"), atol=2e-4, rtol=1e-4)
    assert torch.equal(got, plan.run_cuda(x))


def _deeplab(device, n):
    """The deeplab pipeline and ``n`` frames held out from the synthetic
    model's fit (seed 0, frames 0-29): seed 1, from frame 30 on."""
    pipe = FramePipeline(str(DEEPLAB), PipelineConfig(width=640, height=480), device=device)
    frames = _frames(640, 480, 60, seed=1)[30:30 + n]
    return pipe, [torch.from_numpy(f).to(device) for f in frames]


def test_deeplab_prefix_and_continuation_match_plain(cuda_device):
    pipe, (frame,) = _deeplab(cuda_device, 1)
    e = pipe.maskgen.edge
    pre, cont = e.prefix_plan, e.cont_plan
    with torch.no_grad():
        h = e.front(frame).reshape(16, -1)
        before = pre.launches, cont.launches, dict(body_launch.by_kernel)
        k2 = pre.run_cuda(h)
        torch.testing.assert_close(k2, pre.run_plain(h), atol=2e-3, rtol=1e-3)
        k3 = cont.run_cuda(k2)
        # K2'' in its own arithmetic (bf16x3 GEMMs), at the bars of
        # chip_smoke.py (MATCHED_*: above the split's noise floor); f32 is
        # the precision gap
        matched = cont.run_plain(k2, gemm="bf16x3")
        torch.testing.assert_close(k3, matched, atol=2e-3, rtol=1e-4)
        assert float((k3 - matched).abs().mean()) <= 1e-4
        torch.testing.assert_close(k3, cont.run_plain(k2), atol=2e-3, rtol=1e-3)
        assert torch.equal(k2, pre.run_cuda(h)) and torch.equal(k3, cont.run_cuda(k2))
    # each plan: one bs_body_mega launch a run, no other body kernel
    assert (pre.launches, cont.launches) == (before[0] + 2, before[1] + 2)
    assert dict(body_launch.by_kernel) == dict(
        before[2], bs_body_mega=before[2].get("bs_body_mega", 0) + 4)


def test_deeplab_pipeline_matches_plain(cuda_device):
    """Five held-out frames of the deeplab FramePipeline on the card against
    the plain path in the kernels' arithmetic (K2''s GEMMs bf16x3), under
    the tolerance invariant, with a person fraction inside (0.01, 0.99):
    at most 2% of a frame's
    bytes differ, 0.2% over the sequence; a decode decision may flip only
    at a near-tie of the person margin (|margin| <= 1e-3); the EMAs are
    equal wherever the decode never flipped; and outside the post's
    footprint of the EMA pixels that differ no byte is off by more than 1."""
    from backscrub_tpu_torch.pipeline.decode import decode_val, ema_update
    pipe, frames = _deeplab(cuda_device, 5)
    e = pipe.maskgen.edge
    bg = torch.from_numpy(np.random.default_rng(4).integers(
        0, 256, (480, 640, 3), np.uint8)).to(cuda_device)
    ema = torch.full(pipe.maskgen.ema_shape, 255, dtype=torch.uint8, device=cuda_device)
    ever_flipped = torch.zeros_like(ema, dtype=torch.bool)
    fracs = []
    with torch.no_grad():
        for f in frames:
            yuyv, mask = pipe.step(f, bg)
            ema_k = pipe.maskgen.ema
            logits = e.body(e.front(f, plain=True), plain=True,
                            gemm="bf16x3").permute(1, 2, 0)
            ema = ema_update(ema, decode_val(logits, e.spec))
            rm = e.postprocess(ema)
            ry = blend_pack_yuyv_plain(f, bg, rm)
            others = torch.cat([logits[..., :15], logits[..., 16:]], -1)
            _near_tie_flips(ema_k, ema, logits[..., 15] - others.max(-1).values, ever_flipped)
            foot = tedge.post_footprint(ema_k != ema, e.geo, e.post_mats)
            foot_yuyv = foot.reshape(480, 320, 2).any(-1)[..., None].expand(480, 320, 4)
            for a, b, m in ((yuyv, ry, foot_yuyv.reshape(480, 1280)), (mask, rm, foot)):
                assert int(torch.where(m, 0, (a.int() - b.int()).abs()).max()) <= 1
            fracs.append(float(torch.cat([(yuyv != ry).flatten(),
                                          (mask != rm).flatten()]).float().mean()))
    assert max(fracs) <= 0.02 and float(np.mean(fracs)) <= 0.002
    assert 0.01 < float((mask < 128).float().mean()) < 0.99


_PROBES = ["dw_flat_lane_shifts_9tap", "dw_padded_rows_9tap", "dot_default", "dot_high",
           "dot_highest", "se_pool_fc_gate", "sublane_concat", "lane_stride2",
           "inkernel_reshape"]


@pytest.fixture(scope="module")
def probe_runs():
    """tools/probe_hopper.py's probes on the card, by name."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels build only there)")
    _frames(8, 8, 1)        # puts tools/ on sys.path
    import probe_hopper
    from backscrub_tpu_torch.pipeline.maskgen import set_precision_policy
    set_precision_policy()
    return {p.name: p for p in probe_hopper.probes("cuda")}


@pytest.mark.parametrize("name", _PROBES)
def test_probe_kernel_matches_plain(probe_runs, name):
    """P1-P7 on tools/probe_mosaic.py's inputs: one launch each, P1, P2 and
    P5-P7 bit-identical to their plain twins, P3 and P4 within 1e-5; two
    runs bit-identical; within the original's atol of its numpy reference."""
    p = probe_runs[name]
    before = p.counter.launches
    with torch.no_grad():
        got, again, plain = p.kernel(), p.kernel(), p.plain()
        torch.cuda.synchronize()
    assert p.counter.launches == before + 2
    if p.exact:
        assert torch.equal(got, plain)
    else:
        assert float((got - plain).abs().max()) <= 1e-5
    assert torch.equal(got, again)
    np.testing.assert_allclose(got.cpu().numpy(), p.ref, atol=p.atol, rtol=1e-4)


def test_probe_kernels_at_ragged_shapes(cuda_device):
    """The probes' scalar paths: widths that are no multiple of 4 or 8 (no
    16-byte vectors, a partial MMA tile), a concat of unequal heights; P1
    and P2 at probe_hopper's stencil cases (W = 81 and 7, C = 1, a ragged
    warp, both zero ends of P2's row, a view off 16 bytes), each
    bit-identical to its twin on the path its shape picks, by the
    profiler's kernel name."""
    _frames(8, 8, 1)        # puts tools/ on sys.path
    import probe_hopper
    from backscrub_tpu_torch.ops import probe_kernels as pk
    rng = np.random.default_rng(12)

    def t(*shape):
        return torch.from_numpy(rng.random(shape, np.float32)).to(cuda_device)
    w, x = t(16, 16), t(16, 37)
    for prec in pk.PRECISIONS:
        assert float((pk.dot(w, x, prec) - pk.dot_plain(w, x, prec)).abs().max()) <= 1e-5
    xs, ws = t(5, 333), t(5, 5)
    assert float((pk.se(xs, ws) - pk.se_plain(xs, ws)).abs().max()) <= 1e-5
    a, b = t(3, 7), t(2, 7)
    assert torch.equal(pk.concat(a, b), pk.concat_plain(a, b))
    assert torch.equal(pk.lane_stride2(x), pk.lane_stride2_plain(x))
    x3 = t(3, 5, 7)
    assert torch.equal(pk.reshape_flat(x3), pk.reshape_flat_plain(x3))
    xf, xr = t(4, 4 * 9 + 5 * 9), t(2, 3 * 128 + 3)
    assert torch.equal(pk.dw_flat(xf, 9), pk.dw_flat_plain(xf, 9))
    assert torch.equal(pk.dw_rowpad(xr), pk.dw_rowpad_plain(xr))
    for name, kernel, plain, vec in probe_hopper.stencil_cases("cuda"):
        assert torch.equal(kernel(), plain()), name
        names = probe_hopper.launched_kernels(kernel)
        assert len(names) == 1 and probe_hopper.STENCIL_KERNELS[vec] in names[0], (name, names)
    with pytest.raises(ValueError):
        pk.dot(w, x, "tf32")
    with pytest.raises(ValueError):
        pk.dot(w[:8], x)
    with pytest.raises(ValueError):
        pk.se(t(33, 8), t(33, 33))
    with pytest.raises(ValueError):
        pk.concat(a, t(2, 8))
    with pytest.raises(ValueError):
        pk.dw_rowpad(t(2, 256))


def test_strided_copy_at_copy_shapes(cuda_device):
    """P6 and P7 at probe_hopper's copy cases (the probe shapes, odd n, a
    row length of 6, C = 1, partial last vectors, rows past gridDim.y's
    limit, views off 16 bytes): each bit-identical to its twin and over
    two runs, on the path its shape picks, by the profiler's kernel name."""
    _frames(8, 8, 1)        # puts tools/ on sys.path
    import probe_hopper
    for name, kernel, plain, vec in probe_hopper.copy_cases("cuda"):
        got, again = kernel(), kernel()
        assert torch.equal(got, plain()) and torch.equal(got, again), name
        names = probe_hopper.launched_kernels(kernel)
        assert len(names) == 1 and probe_hopper.COPY_KERNELS[vec] in names[0], (name, names)


def test_concat_at_cat_shapes(cuda_device):
    """P5 at probe_hopper's concat cases (the probe shape, unequal heights,
    partial vectors, an empty source, partial last CTAs, a large pair, a
    or b a view off 16 bytes): each one launch a call, bit-identical to
    its twin and over two runs, on the path its shapes pick, by the
    profiler's kernel name."""
    _frames(8, 8, 1)        # puts tools/ on sys.path
    import probe_hopper
    from backscrub_tpu_torch.ops import probe_kernels as pk
    for name, kernel, plain, vec in probe_hopper.cat_cases("cuda"):
        before = pk.concat.launches
        got, again = kernel(), kernel()
        assert pk.concat.launches == before + 2, name
        assert torch.equal(got, plain()) and torch.equal(got, again), name
        names = probe_hopper.launched_kernels(kernel)
        assert len(names) == 1 and probe_hopper.CAT_KERNELS[vec] in names[0], (name, names)


def test_concat_past_int_max_raises(cuda_device):
    """A concat of more than 2**31 - 1 floats in all is refused by the
    launcher, and the wrapper raises (12 GB of the card's memory)."""
    from backscrub_tpu_torch.ops import probe_kernels as pk
    a = torch.empty((2 ** 14, 2 ** 16), device=cuda_device)
    before = pk.concat.launches
    with pytest.raises(RuntimeError, match="cudaError"):
        pk.concat(a, a)
    assert pk.concat.launches == before
    del a
    torch.cuda.empty_cache()


def test_launch_floor_kernels(cuda_device):
    """bs_probe_empty launches; bs_probe_touch copies its 512 bytes."""
    src = torch.rand(128, device=cuda_device)
    dst = torch.zeros_like(src)
    _build.launch("bs_probe_empty")
    _build.launch("bs_probe_touch", src.data_ptr(), dst.data_ptr())
    torch.cuda.synchronize()
    assert torch.equal(dst, src)


def test_se_cluster_at_edge_shapes(cuda_device):
    """P4's cluster kernel where its common path does not reach: the
    chunked slices of (32, 100000) (x read again for the multiply), one
    column (1, 1) (15 CTAs with no columns), and (16, 3840) as a view off
    a 16-byte boundary (4-byte copies, scalar stores); each within 1e-5 of
    se_plain and bit-identical over two runs."""
    from backscrub_tpu_torch.ops import probe_kernels as pk
    rng = np.random.default_rng(13)

    def t(*shape):
        return torch.from_numpy(rng.random(shape, np.float32)).to(cuda_device)
    view = t(16 * 3840 + 1)[1:].view(16, 3840)
    assert view.data_ptr() % 16 != 0
    for x, w in ((t(32, 100000), t(32, 32) - 0.5), (t(1, 1), t(1, 1)), (view, t(16, 16))):
        got, again = pk.se(x, w), pk.se(x, w)
        assert torch.equal(got, again), tuple(x.shape)
        assert float((got - pk.se_plain(x, w)).abs().max()) <= 1e-5, tuple(x.shape)


@pytest.mark.parametrize("n", [1, 63, 64, 65, 4 * 3840])
@pytest.mark.parametrize("prec", ["default", "high", "highest"])
def test_dot_kernel_at_tile_edges(cuda_device, n, prec):
    """P3 at widths around its 64-column tile (a lone column, a ragged
    tile, one tile, a tile and one column) and at four times the probe's
    width (more tiles than SMs), every precision, within 1e-5 of its plain
    twin and bit-identical over two runs."""
    from backscrub_tpu_torch.ops import probe_kernels as pk
    rng = np.random.default_rng(n)
    w, x = (torch.from_numpy(rng.random(s, np.float32)).to(cuda_device)
            for s in ((16, 16), (16, n)))
    got, again = pk.dot(w, x, prec), pk.dot(w, x, prec)
    assert torch.equal(got, again)
    assert float((got - pk.dot_plain(w, x, prec)).abs().max()) <= 1e-5


def test_refused_cluster_launch_raises(cuda_device):
    """``launch_cluster`` (csrc/launch.cuh), P4's launcher, refuses a
    cluster the card cannot hold (32 CTAs, twice the non-portable 16) and
    launches nothing; the wrapper raises on the error, with no fallback."""
    with pytest.raises(RuntimeError, match="cudaError"):
        _build.launch("bs_barrier_bench", 1, 1, 32)
    torch.cuda.synchronize()


def _synthetic_frames(w, h, n):
    from backscrub_tpu_torch.io.streams import SyntheticSource
    src = SyntheticSource(w, h)
    return [src.read() for _ in range(n)]


def _direct_steps(pipe, frames, bgs):
    """Sequential ``step`` calls from a fresh EMA, downloaded one by one."""
    pipe.reset()
    return [pipe.step(f, b)[0].cpu().numpy() for f, b in zip(frames, bgs)]


@pytest.mark.parametrize("fmt", ["yuyv", "nv12"])
def test_staged_serving_loop_matches_plain(cuda_device, fmt):
    """The staged ServingLoop (page-locked upload ring, side-stream
    downloads) writes the plain loop's bytes and the direct steps', on
    the default family at 640x480; every kernel of the path once a frame."""
    from backscrub_tpu_torch.runtime.serving import ServingLoop
    pipe = FramePipeline(str(SELFIE), PipelineConfig(width=640, height=480,
                                                     output_format=fmt),
                         device=cuda_device)
    frames = _synthetic_frames(640, 480, 20)
    bgs = [np.roll(f, 7, axis=1) for f in frames]
    golden = _direct_steps(pipe, frames, bgs)
    pack = blend_pack_yuyv if fmt == "yuyv" else blend_pack_420
    outs = {}
    for staged in (False, True):
        pipe.reset()
        loop = ServingLoop(pipe, depth=3, staging=staged)
        assert staged is False or loop.staging.supported
        before = (tedge.front_fused.launches, body_launch.launches, pack.launches)
        it, bg_it, got = iter(frames), iter(bgs), []
        assert loop.run(lambda: next(it, None), got.append,
                        background=lambda: next(bg_it)) == len(frames)
        after = (tedge.front_fused.launches, body_launch.launches, pack.launches)
        assert [a - b for a, b in zip(after, before)] == [len(frames)] * 3
        outs[staged] = got
    for g, a, b in zip(golden, outs[False], outs[True]):
        np.testing.assert_array_equal(a, g)
        np.testing.assert_array_equal(b, g)


def test_staged_ring_300_frames_drain_thread(cuda_device):
    """300 frames through a depth-3 staged ring with the drain thread, a
    different background every frame: byte-identical to direct steps (a
    page-locked slot rewritten before its copy ran, or a result freed
    before its download, would change frames here)."""
    from backscrub_tpu_torch.runtime.serving import ServingLoop
    pipe = FramePipeline(str(FULL), PipelineConfig(width=640, height=480), device=cuda_device)
    frames = _synthetic_frames(640, 480, 300)
    bgs = [frames[(i * 37) % 300] for i in range(300)]
    golden = _direct_steps(pipe, frames, bgs)
    pipe.reset()
    loop = ServingLoop(pipe, depth=3, staging=True, drain_thread=True)
    it, bg_it, got = iter(frames), iter(bgs), []
    assert loop.run(lambda: next(it, None), got.append, background=lambda: next(bg_it)) == 300
    assert len(got) == 300
    for i, (g, o) in enumerate(zip(golden, got)):
        assert np.array_equal(g, o), f"frame {i} differs"


def test_cli_main_on_cuda_matches_direct_steps(cuda_device, tmp_path):
    """``cli.main`` on the card writes the bytes of direct ``step`` calls
    on the same SyntheticSource frames, plain and with staging forced."""
    from backscrub_tpu_torch import cli
    n = 30
    frames = _synthetic_frames(640, 480, n)
    pipe = FramePipeline(str(SELFIE), PipelineConfig(width=640, height=480), device=cuda_device)
    golden = b"".join(g.tobytes() for g in _direct_steps(pipe, frames, [None] * n))
    for extra in ([], ["--staging-force", "--drain-thread"]):
        out = tmp_path / "o.yuv"
        assert cli.main(["-c", "test:", "-m", str(SELFIE), "--frames", str(n),
                         "-v", f"file:{out}", *extra]) == 0
        assert out.read_bytes() == golden, extra


# ---------------------------------------------------------------------------
# the MJPG decode kernel (bs_jpeg_decode) and the encode on the card

_JPEG_META = ROOT / "tests" / "data" / "mjpg_synth.json"
# (sampling factors, ncomp) of every decode method: 4:2:0, 4:2:2, 4:4:4,
# 4:4:0 (h1v2), 4:1:1 (replication), grayscale
JPEG_SAMPLINGS = {"420": ((2, 2), (1, 1), (1, 1)), "422": ((2, 1), (1, 1), (1, 1)),
                  "444": ((1, 1), (1, 1), (1, 1)), "440": ((1, 2), (1, 1), (1, 1)),
                  "411": ((4, 1), (1, 1), (1, 1)), "311": ((3, 1), (1, 1), (1, 1)),
                  "gray": ((1, 1),)}


def random_coefficients(info, seed, device):
    """Seeded coefficient arrays and int32 quant tables for ``info``: the
    dequantized values span the 8-bit baseline range."""
    rng = np.random.default_rng(seed)
    coefs = [torch.from_numpy(rng.integers(-40, 41, (bh, bw, 64)).astype(np.int16)).to(device)
             for bh, bw in info.blocks]
    q = torch.from_numpy(rng.integers(1, 50, (info.ncomp, 64)).astype(np.int32)).to(device)
    return coefs, q


@pytest.mark.parametrize("size,sampling", [((640, 480), "420"), ((1280, 720), "420")] + [
    ((64, 48), s) for s in JPEG_SAMPLINGS] + [((63, 47), s) for s in JPEG_SAMPLINGS])
def test_jpeg_decode_matches_plain(cuda_device, size, sampling):
    """bs_jpeg_decode byte-identical to its plain version, one call a decode."""
    from backscrub_tpu_torch.io.jpeg import make_info
    from backscrub_tpu_torch.ops.jpeg_kernels import decode_jpeg_bgr, decode_jpeg_bgr_plain
    sf = JPEG_SAMPLINGS[sampling]
    info = make_info(*size, sf, ncomp=len(sf))
    coefs, q = random_coefficients(info, sum(size), cuda_device)
    before = decode_jpeg_bgr.launches
    got = decode_jpeg_bgr(coefs, q, info)
    torch.cuda.synchronize()
    assert decode_jpeg_bgr.launches == before + 1
    want = decode_jpeg_bgr_plain(coefs, q, info)
    assert got.shape == (size[1], size[0], 3) and torch.equal(got, want)


@pytest.mark.parametrize("sampling", list(JPEG_SAMPLINGS))
def test_jpeg_decode_on_views_off_16_bytes(cuda_device, sampling):
    """Coefficients given as views 2 bytes past a 16-byte boundary (the
    kernel's 2-byte staging path; the first component aligned, the others
    not) at an odd size: byte-identical to the plain version, one launch."""
    from backscrub_tpu_torch.io.jpeg import make_info
    from backscrub_tpu_torch.ops.jpeg_kernels import decode_jpeg_bgr, decode_jpeg_bgr_plain
    sf = JPEG_SAMPLINGS[sampling]
    info = make_info(63, 47, sf, ncomp=len(sf))
    coefs, q = random_coefficients(info, 5, cuda_device)
    views = [coefs[0]]
    for c in coefs[1:]:
        buf = torch.zeros(c.numel() + 8, dtype=torch.int16, device=cuda_device)
        views.append(buf[1:1 + c.numel()].view(c.shape))
        views[-1].copy_(c)
    assert all(v.data_ptr() % 16 == 2 for v in views[1:])
    before = decode_jpeg_bgr.launches
    got = decode_jpeg_bgr(views, q, info)
    assert decode_jpeg_bgr.launches == before + 1
    assert torch.equal(got, decode_jpeg_bgr_plain(coefs, q, info))


def test_jpeg_decode_wraps_like_plain(cuda_device):
    """Coefficients and tables no valid stream holds overflow the IDCT's
    int32: the kernel's unsigned butterfly wraps as the plain version's
    int32 tensors do, byte for byte."""
    from backscrub_tpu_torch.io.jpeg import make_info
    from backscrub_tpu_torch.ops.jpeg_kernels import decode_jpeg_bgr, decode_jpeg_bgr_plain
    info = make_info(48, 32, JPEG_SAMPLINGS["420"])
    rng = np.random.default_rng(11)
    coefs = [torch.from_numpy(rng.integers(-32768, 32768, (bh, bw, 64)).astype(np.int16))
             .to(cuda_device) for bh, bw in info.blocks]
    q = torch.from_numpy(rng.integers(1, 65536, (3, 64)).astype(np.int32)).to(cuda_device)
    assert torch.equal(decode_jpeg_bgr(coefs, q, info), decode_jpeg_bgr_plain(coefs, q, info))


def test_jpeg_decode_fixtures_match_opencv(cuda_device):
    """Every committed JPEG, entropy-decoded on the host and decoded by the
    kernel, hashes to its committed cv2.imdecode sha256."""
    import hashlib
    import json
    from backscrub_tpu_torch.io.jpeg import JpegEntropyDecoder
    from backscrub_tpu_torch.ops.jpeg_kernels import decode_jpeg_bgr
    meta = json.loads(_JPEG_META.read_text())
    n = 0
    for name, frames in meta["frames"].items():
        data = (ROOT / "tests" / "data" / name).read_bytes()
        for f in frames:
            dec = JpegEntropyDecoder()
            coefs, q = dec.decode(data[f["offset"]:f["offset"] + f["length"]])
            out = decode_jpeg_bgr([torch.from_numpy(c).to(cuda_device) for c in coefs],
                                  torch.from_numpy(q.astype(np.int32)).to(cuda_device), dec.info)
            got = hashlib.sha256(out.cpu().numpy().tobytes()).hexdigest()
            assert got == f["decoded_sha256"], (name, f["sampling"])
            n += 1
    assert n == 8


def test_jpeg_encode_on_card_matches_opencv(cuda_device):
    """The encoder's PyTorch ops on the card plus the host packer write the
    committed cv2.imencode bytes."""
    import hashlib
    import json
    sys.path.insert(0, str(ROOT / "tools"))
    from make_synth_mjpg import encode_input
    from backscrub_tpu_torch.io.jpeg import JpegHuffmanEncoder, make_info
    from backscrub_tpu_torch.pipeline.jpeg_enc import encode_jpeg_coefs, stream_qtabs
    for e in json.loads(_JPEG_META.read_text())["encodes"]:
        img = torch.from_numpy(encode_input(e["width"], e["height"], e["seed"])).to(cuda_device)
        info = make_info(e["width"], e["height"], JPEG_SAMPLINGS[e["sampling"]])
        qt = stream_qtabs(e["quality"])
        coefs = encode_jpeg_coefs(img, torch.from_numpy(qt.astype(np.int32)).to(cuda_device), info)
        assert all(c.device.type == "cuda" for c in coefs)
        jpg = JpegHuffmanEncoder(info, qt).encode([c.cpu().numpy() for c in coefs])
        assert hashlib.sha256(jpg).hexdigest() == e["sha256"], e


def test_jpeg_decode_refuses_bad_inputs(cuda_device):
    from backscrub_tpu_torch.io.jpeg import make_info
    from backscrub_tpu_torch.ops.jpeg_kernels import decode_jpeg_bgr
    info = make_info(64, 48)
    coefs, q = random_coefficients(info, 0, cuda_device)
    with pytest.raises(ValueError):
        decode_jpeg_bgr([c.int() for c in coefs], q, info)
    with pytest.raises(ValueError):
        decode_jpeg_bgr(coefs, q.to(torch.int16), info)
    with pytest.raises(ValueError):
        decode_jpeg_bgr(coefs[:2], q, info)
    bad = make_info(64, 48, ((3, 2), (2, 2), (1, 1)))
    with pytest.raises(ValueError):
        decode_jpeg_bgr(random_coefficients(bad, 0, cuda_device)[0], q, bad)


def _fixture_jpeg_frames():
    """The committed 640x480 MJPG frames as (coefs, qtabs) and their info."""
    import json
    from backscrub_tpu_torch.io.jpeg import JpegEntropyDecoder
    frames = json.loads(_JPEG_META.read_text())["frames"]["mjpg_synth_640x480.mjpg"]
    data = (ROOT / "tests" / "data" / "mjpg_synth_640x480.mjpg").read_bytes()
    dec, out = JpegEntropyDecoder(), []
    for f in frames:
        coefs, q = dec.decode(data[f["offset"]:f["offset"] + f["length"]])
        out.append((tuple(c.copy() for c in coefs), q.astype(np.int32)))
    return out, dec.info


def test_mjpg_pipeline_on_card_is_the_bgr_pipeline(cuda_device):
    """MJPG in on the card: one bs_jpeg_decode call, K1, K2 and K3 a frame,
    and byte for byte the BGR pipeline on the plainly decoded frames."""
    from backscrub_tpu_torch.ops.jpeg_kernels import decode_jpeg_bgr, decode_jpeg_bgr_plain
    frames, info = _fixture_jpeg_frames()
    m = FramePipeline(str(FULL), PipelineConfig(width=640, height=480, input_format="mjpg",
                                                jpeg_info=info), device=cuda_device)
    b = FramePipeline(str(FULL), PipelineConfig(width=640, height=480), device=cuda_device)
    counters = (decode_jpeg_bgr, tedge.front_fused, body_launch, blend_pack_yuyv)
    for coefs, q in frames:
        before = [c.launches for c in counters]
        out, mask = m.step((coefs, q))
        assert [c.launches - x for c, x in zip(counters, before)] == [1, 1, 1, 1]
        bgr = decode_jpeg_bgr_plain([torch.from_numpy(c) for c in coefs], torch.from_numpy(q),
                                    info)
        bout, bmask = b.step(bgr)
        assert torch.equal(out, bout) and torch.equal(mask, bmask)


def test_mjpg_output_on_card_is_the_encode_of_the_bgr_output(cuda_device):
    """MJPG out on the card: the coefficients are the encode of the BGR
    pipeline's output, and the packed stream what OpenCV would write for it
    (the encoder's bytes are held to OpenCV's by the committed hashes)."""
    from backscrub_tpu_torch.pipeline.jpeg_enc import encode_jpeg_coefs
    m = FramePipeline(str(SELFIE), PipelineConfig(width=640, height=480, output_format="mjpg",
                                                  out_jpeg_quality=80), device=cuda_device)
    b = FramePipeline(str(SELFIE), PipelineConfig(width=640, height=480, output_format="bgr"),
                      device=cuda_device)
    q = torch.from_numpy(m.out_jpeg_qtabs.astype(np.int32)).to(cuda_device)
    for f in _synthetic_frames(640, 480, 3):
        out, _ = m.step(f)
        bout, _ = b.step(f)
        want = encode_jpeg_coefs(bout, q, m.out_jpeg_info)
        assert len(out) == 3 and all(torch.equal(x, y) for x, y in zip(out, want))


@pytest.mark.parametrize("path", [FULL, SELFIE])
@pytest.mark.parametrize("option", ["refine:guided", "morph:open:3", "u8exact"])
def test_post_options_on_card_match_plain(cuda_device, monkeypatch, path, option):
    """A post option on the card takes the JAX route: K1, then the graph
    executor over the body (no body plan), the decode, the post with the
    option, K3; each frame's mask against the plain route from the same
    EMA under the tolerance invariant.  u8exact comes from the
    BACKSCRUB_U8_EXACT environment default, as the C ABI and the CLI set it."""
    opts = {"refine:guided": dict(mask_refine="guided"),
            "morph:open:3": dict(mask_morph="open:3"), "u8exact": {}}[option]
    if option == "u8exact":
        monkeypatch.setenv("BACKSCRUB_U8_EXACT", "1")
    pipe = FramePipeline(str(path), PipelineConfig(width=640, height=480, **opts),
                         device=cuda_device)
    e = pipe.maskgen.edge
    assert e is not None and e.plans == [] and not e.info.tail_ok
    counters = (tedge.front_fused, body_launch, blend_pack_yuyv)
    fracs = []
    with torch.no_grad():
        for f in _frames(640, 480, 3):
            ft = torch.from_numpy(f).to(cuda_device)
            ema = pipe.maskgen.ema.clone()
            before = [c.launches for c in counters]
            out, mask = pipe.step(ft)
            assert [c.launches - x for c, x in zip(counters, before)] == [1, 0, 1]
            rm, _ = e.step_mask(ft, ema, plain=True)
            assert int((mask.int() - rm.int()).abs().max()) <= 1
            fracs.append(float((mask != rm).float().mean()))
    assert max(fracs) <= 0.02 and float(np.mean(fracs)) <= 0.002


def test_mjpg_serving_and_cli_on_card_match_direct_steps(cuda_device, tmp_path, monkeypatch):
    """MJPG in and out through the staged serving loop with the drain
    thread, and ``backscrub-torch -c mjpg: --sink-format mjpg`` (the
    synthetic camera decoded in the loop's thread), write the bytes of
    direct steps on the same JPEGs."""
    import functools
    from backscrub_tpu_torch import cli
    from backscrub_tpu_torch.io import streams
    from backscrub_tpu_torch.io.jpeg import JpegEntropyDecoder, JpegHuffmanEncoder
    from backscrub_tpu_torch.runtime.serving import ServingLoop
    n = 12
    cam, dec = streams.SyntheticJpegCamera(640, 480), JpegEntropyDecoder()
    frames = []
    for _ in range(n):
        coefs, q = dec.decode(cam())
        frames.append((tuple(c.copy() for c in coefs), q.astype(np.int32)))
    pipe = FramePipeline(str(SELFIE), PipelineConfig(width=640, height=480, input_format="mjpg",
                                                     jpeg_info=dec.info, output_format="mjpg"),
                         device=cuda_device)
    enc = JpegHuffmanEncoder(pipe.out_jpeg_info, pipe.out_jpeg_qtabs)
    golden = [enc.encode([c.cpu().numpy() for c in pipe.step(f)[0]]) for f in frames]
    pipe.reset()
    loop = ServingLoop(pipe, depth=3, staging=True, drain_thread=True)
    it, got = iter(frames), []
    assert loop.run(lambda: next(it, None), lambda a: got.append(enc.encode(a))) == n
    assert got == golden
    monkeypatch.setattr(streams, "JpegSource", functools.partial(streams.JpegSource,
                                                                 prefetch=False))
    out = tmp_path / "o.mjpg"
    assert cli.main(["-c", "mjpg:", "--cg", "640x480", "-m", str(SELFIE), "--frames", str(n),
                     "--sink-format", "mjpg", "-v", f"file:{out}"]) == 0
    assert out.read_bytes() == b"".join(golden)


# ---------------------------------------------------------------------------
# the bf16 mode: body_mega_kernel<1> and the one-term GEMM


@pytest.mark.parametrize("path", [FULL, SELFIE, DEEPLAB, BODYPIX])
def test_bf16_tables_match_plain(cuda_device, path):
    """Each bf16 plan of a family's fused path (``precision="default"``) as
    one launch, two runs bit-identical, and held op by op
    (``BodyPlan.rows_on_card``: each phase's rows on the kernel's own
    workspace of the phase before against ``walk_phase``'s plain rows) at
    allclose(2e-3, 1e-3); the control, those rows with the dots'
    activations unrounded, misses the bar on some row of every plan
    (tests/test_torch_precision.py says why the whole span is not held at
    that bar)."""
    mg = MaskGen(str(path), 640, 480, device="cuda", compute_dtype=torch.bfloat16,
                 precision="default")
    e = mg.edge
    assert e is not None and all(p.dots == "bf16" for p in e.plans)
    frame = torch.from_numpy(np.random.default_rng(2).integers(
        0, 256, (480, 640, 3), np.uint8)).cuda()
    with torch.no_grad():
        x = e.front(frame).reshape(e.plans[0].in_meta.c, -1)
        for plan in e.plans:
            k, k2 = plan.run_cuda(x).clone(), plan.run_cuda(x)
            torch.cuda.synchronize()
            assert torch.equal(k, k2)
            off = 0
            for phase, kind, got, want, ctl in plan.rows_on_card(x):
                torch.testing.assert_close(got, want, atol=2e-3, rtol=1e-3,
                                           msg=f"a {kind} row of phase {phase}")
                off += not torch.allclose(ctl, want, atol=2e-3, rtol=1e-3)
            assert off > 0
            x = k


@pytest.mark.parametrize("co,ci,L", _GEMM_SHAPES)
def test_gemm_one_term_matches_plain(cuda_device, co, ci, L):
    """``bs_gemm`` with terms=1 (the wgmma tile) at the continuation's 15
    shapes and at ragged ones against ``conv1x1_bf16_plain`` (relative
    1e-5, the summation order alone), bit-identical twice, and not the
    three-term result."""
    g = torch.Generator().manual_seed(co + ci)
    w = (torch.randn(co, ci, generator=g) / ci ** 0.5).cuda()
    b = torch.randn(co, generator=g).cuda()
    x = (torch.rand(ci, L, generator=g) * 2).cuda()
    hi, _ = split_bf16(w)
    k, k2 = (conv1x1_gemm(w, b, x, split=(hi, None), terms=1) for _ in range(2))
    p = conv1x1_bf16_plain(w, b, x)
    torch.cuda.synchronize()
    assert torch.equal(k, k2)
    assert float((k - p).abs().max() / p.abs().max()) <= 1e-5
    assert not torch.equal(k, conv1x1_gemm(w, b, x))


@pytest.mark.parametrize("co,ci,L", _GEMM_SHAPES)
def test_gemm_six_terms_matches_plain(cuda_device, co, ci, L):
    """``bs_gemm`` with terms=6 (the TPU's HIGHEST split on the wgmma tile)
    at the continuation's 15 shapes and at ragged ones against
    ``conv1x1_bf16x6_plain`` (relative 1e-5, the summation order alone),
    bit-identical twice, closer to f32 than the three-term result."""
    g = torch.Generator().manual_seed(co + ci)
    w = (torch.randn(co, ci, generator=g) / ci ** 0.5).cuda()
    b = torch.randn(co, generator=g).cuda()
    x = (torch.rand(ci, L, generator=g) * 2).cuda()
    k, k2 = (conv1x1_gemm(w, b, x, split=split_bf16(w, 3), terms=6) for _ in range(2))
    p, f32 = conv1x1_bf16x6_plain(w, b, x), conv1x1_plain(w, b, x)
    torch.cuda.synchronize()
    assert torch.equal(k, k2)
    assert float((k - p).abs().max() / p.abs().max()) <= 1e-5
    assert float((k - f32).abs().max()) < float((conv1x1_gemm(w, b, x) - f32).abs().max())


def test_deeplab_highest_continuation_matches_its_twin(cuda_device):
    """deeplab at "highest": K2'' with the six-term GEMM as one launch,
    two runs bit-identical, within allclose(2e-3, 1e-3) of
    ``run_plain(gemm="bf16x6")`` and mean 1e-4, and at most a tenth of the
    three-term twin's distance from the f32 plain plan (those bars alone
    would pass three terms)."""
    pipe = FramePipeline(str(DEEPLAB), PipelineConfig(width=640, height=480),
                         device=cuda_device, precision="highest")
    frame = torch.from_numpy(_frames(640, 480, 31, seed=1)[30]).to(cuda_device)
    e = pipe.maskgen.edge
    assert e.cont_plan.dots == "bf16x6"
    with torch.no_grad():
        k2 = e.prefix_plan.run_cuda(e.front(frame).reshape(16, -1)).clone()
        k3 = e.cont_plan.run_cuda(k2).clone()
        twin = e.cont_plan.run_plain(k2, gemm="bf16x6")
        torch.testing.assert_close(k3, twin, atol=2e-3, rtol=1e-3)
        assert float((k3 - twin).abs().mean()) <= 1e-4
        assert torch.equal(k3, e.cont_plan.run_cuda(k2))
        f32 = e.cont_plan.run_plain(k2)
        three = e.cont_plan.run_plain(k2, gemm="bf16x3")
        assert 10 * float((k3 - f32).abs().max()) <= float((three - f32).abs().max())


@pytest.mark.parametrize("S", [3, 8])
@pytest.mark.parametrize("precision", ["default", "high", "highest"])
def test_deeplab_continuation_stream_batch_is_per_image(cuda_device, precision, S):
    """K2'' with the wgmma GEMM tile (the bf16 mode's one term at
    "default", the bf16x3 split at "high", six terms at "highest") over a
    stream batch of S held-out frames (at 8 a CTA takes several tiles of an
    op through one ring): one launch, every image bit-identical to its own
    launch."""
    mg = MaskGen(str(DEEPLAB), 640, 480, device=cuda_device, precision=precision)
    e = mg.edge
    assert e.cont_plan.dots == {"default": "bf16", "high": "bf16x3",
                                "highest": "bf16x6"}[precision]
    fr = torch.from_numpy(np.stack(_frames(640, 480, 30 + S, seed=1)[30:])).to(cuda_device)
    with torch.no_grad():
        x = tedge.front_fused(e.canvas(fr), e.front_params, **e.front_kwargs())
        x = e.prefix_plan(x.reshape(S, x.shape[1], -1))
        before = body_launch.by_kernel["bs_body_mega"]
        out = e.cont_plan(x)
        assert body_launch.by_kernel["bs_body_mega"] == before + 1
        for i in range(S):
            assert torch.equal(out[i], e.cont_plan(x[i]))


def test_cli_bf16_and_int8_on_cuda(cuda_device, tmp_path):
    """``backscrub-torch --bf16`` and ``--int8`` on the card write the bytes
    of direct steps in their modes."""
    from backscrub_tpu_torch import cli
    from backscrub_tpu_torch.io.streams import SyntheticSource
    n = 5
    for flags, kw in ((["--bf16"], dict(compute_dtype=torch.bfloat16, precision="default")),
                      (["--int8"], dict(quantize="int8"))):
        src = SyntheticSource(640, 480)
        pipe = FramePipeline(str(SELFIE), PipelineConfig(width=640, height=480), **kw)
        want = b"".join(pipe.step(src.read())[0].cpu().numpy().tobytes() for _ in range(n))
        out = tmp_path / f"{flags[0][2:]}.yuv"
        assert cli.main(["-c", "test:", "--cg", "640x480", "-m", str(SELFIE), "--frames",
                         str(n), "-v", f"file:{out}", *flags]) == 0
        assert out.read_bytes() == want


@pytest.mark.parametrize("S", [3, 8])
@pytest.mark.parametrize("path", [FULL, SELFIE, DEEPLAB, SEGM_FULL, BODYPIX])
def test_stream_batch_is_one_launch_of_each_kernel(cuda_device, path, S):
    """A stream batch of S 640x480 frames (at 8 a CTA of the body kernels
    takes several items of an op, the SE gates of several images): K1, each
    body plan (mlkit's and segm_lite's K2 with their SE blocks), K3 and K4
    one launch a batch each, every image bit-identical to its own launch."""
    from backscrub_tpu_torch.ops.pack_kernels import blend_pack_420, blend_pack_yuyv
    pipe = FramePipeline(str(path), PipelineConfig(width=640, height=480), device=cuda_device)
    e = pipe.maskgen.edge
    rng = np.random.default_rng(2)
    fr, bg = (torch.from_numpy(rng.integers(0, 256, (S, 480, 640, 3), np.uint8))
              .to(cuda_device) for _ in range(2))
    mask = torch.from_numpy(rng.integers(0, 256, (S, 480, 640), np.uint8)).to(cuda_device)

    def one_launch(counter, fn, *args):
        before = counter()
        out = fn(*args)
        assert counter() == before + 1
        for s in range(S):
            assert torch.equal(out[s], fn(*(a[s] if torch.is_tensor(a) else a for a in args)))
        return out

    with torch.no_grad():
        canvas = e.canvas(fr)
        x = one_launch(lambda: tedge.front_fused.launches,
                       lambda c: tedge.front_fused(c, e.front_params, **e.front_kwargs()), canvas)
        x = x.reshape(S, x.shape[1], -1)
        for plan in e.plans:
            x = one_launch(lambda: body_launch.by_kernel["bs_body_mega"], plan, x)
        one_launch(lambda: blend_pack_yuyv.launches, blend_pack_yuyv, fr, bg, mask)
        one_launch(lambda: blend_pack_420.launches, blend_pack_420, fr, bg, mask, "nv12")


def test_multistream_server_on_card_is_direct_steps(cuda_device):
    """MultiStreamServer (pull) on the card delivers the bytes of direct
    batched steps, one K1, one K2 and one K3 launch a tick."""
    from backscrub_tpu_torch.parallel.streams import MultiStreamPipeline
    from backscrub_tpu_torch.runtime.multistream import MultiStreamServer
    cfg, S, n = PipelineConfig(width=320, height=240), 3, 4
    rng = np.random.default_rng(3)
    frames = rng.integers(0, 256, (n, S, 240, 320, 3), np.uint8)
    direct = MultiStreamPipeline(str(FULL), cfg, S, device=cuda_device)
    want = [direct.step(frames[k])[0].cpu().numpy() for k in range(n)]
    got = [[] for _ in range(S)]
    its = [iter(frames[:, s]) for s in range(S)]
    server = MultiStreamServer(MultiStreamPipeline(str(FULL), cfg, S, device=cuda_device),
                               [lambda it=it: next(it, None) for it in its],
                               [g.append for g in got])
    before = (tedge.front_fused.launches, body_launch.by_kernel["bs_body_mega"])
    assert server.run() == n
    assert (tedge.front_fused.launches - before[0],
            body_launch.by_kernel["bs_body_mega"] - before[1]) == (n, n)
    for s in range(S):
        for k in range(n):
            np.testing.assert_array_equal(got[s][k], want[k][s])


# ---------------------------------------------------------------------------
# the C ABI and the flagship entry on the card


@pytest.mark.parametrize("staged", [False, True])
def test_capi_on_card_is_maskgen(cuda_device, monkeypatch, staged):
    """The C ABI by ctypes with BACKSCRUB_TORCH_DEVICE unset runs on the
    card: fused, one K1 and one K2 launch a frame and no K5; staged (a stage
    hook set), one K5 a frame and no K1 or K2; the masks byte-identical to
    an in-process MaskGen on the card."""
    import ctypes
    monkeypatch.delenv("BACKSCRUB_TORCH_DEVICE", raising=False)
    lib = ctypes.CDLL(_build.capi_library())
    lib.bs_maskgen_new.restype = ctypes.c_void_p
    lib.bs_maskgen_new.argtypes = [ctypes.c_char_p] + [ctypes.c_size_t] * 3 + [ctypes.c_void_p] * 5
    lib.bs_maskgen_process.restype = ctypes.c_bool
    lib.bs_maskgen_process.argtypes = [ctypes.c_void_p] * 3
    lib.bs_maskgen_delete.argtypes = [ctypes.c_void_p]
    n, (w, h) = 5, (640, 480)
    frames = [np.ascontiguousarray(f) for f in _synthetic_frames(w, h, n)]
    ref = MaskGen(str(FULL), w, h, device=cuda_device, fused=not staged)
    want = [ref.process(f).cpu().numpy() for f in frames]
    hook = ctypes.CFUNCTYPE(None, ctypes.c_void_p)(lambda _c: None)
    hooks = [ctypes.cast(hook, ctypes.c_void_p) if staged else None, None, None]
    ctx = lib.bs_maskgen_new(str(FULL).encode(), 2, w, h, None, *hooks, None)
    assert ctx
    before = (tedge.front_fused.launches, body_launch.by_kernel["bs_body_mega"],
              bilateral5.launches)
    for f, m in zip(frames, want):
        got = np.zeros((h, w), np.uint8)
        assert lib.bs_maskgen_process(ctx, f.ctypes.data, got.ctypes.data)
        assert np.array_equal(got, m)
    lib.bs_maskgen_delete(ctx)
    after = (tedge.front_fused.launches, body_launch.by_kernel["bs_body_mega"],
             bilateral5.launches)
    assert tuple(a - b for a, b in zip(after, before)) == ((0, 0, n) if staged else (n, n, 0))


def test_entry_on_card_is_frame_pipeline_step(cuda_device):
    """``entry()``'s step on the card (``pipe.step_batch`` on a batch of
    one) over its example frame and three synthetic ones, the EMA carried:
    FramePipeline.step's bytes, one K1, one K2 and one K3 launch a call."""
    from backscrub_tpu_torch.entry import entry
    fn, (frame, bg, ema) = entry(str(FULL))
    assert all(a.device.type == "cuda" for a in (frame, bg, ema))
    pipe = FramePipeline(str(FULL), PipelineConfig(width=640, height=480), device=cuda_device)
    for f in [frame] + [torch.from_numpy(np.ascontiguousarray(x)).cuda()
                        for x in _synthetic_frames(640, 480, 3)]:
        want_out, want_mask = pipe.step(f, bg)
        before = (tedge.front_fused.launches, body_launch.by_kernel["bs_body_mega"],
                  blend_pack_yuyv.launches)
        out, mask, ema = fn(f, bg, ema)
        after = (tedge.front_fused.launches, body_launch.by_kernel["bs_body_mega"],
                 blend_pack_yuyv.launches)
        assert tuple(a - b for a, b in zip(after, before)) == (1, 1, 1)
        assert torch.equal(out, want_out) and torch.equal(mask, want_mask)
        assert torch.equal(ema, pipe.maskgen.ema)


def test_train_step_on_card_matches_cpu(cuda_device):
    """Two Adam steps of segm_lite on the card against the same steps on
    the CPU from the same parameters (losses rtol 1e-4, parameters within
    2·lr·n), with TF32 off inside ``Trainer`` even where it was on."""
    from backscrub_tpu_torch.graph.executor import load_model
    from backscrub_tpu_torch.models.specs import spec_for_model
    from backscrub_tpu_torch.train.trainer import TrainConfig, Trainer
    rng = np.random.default_rng(3)
    x = rng.random((4, 96, 160, 3), dtype=np.float32)
    y = (rng.random((4, 96, 160)) > 0.5).astype(np.float32)
    spec, cfg = spec_for_model(str(FULL)), TrainConfig(learning_rate=1e-3)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    card = Trainer(load_model(str(FULL), "cuda"), spec, config=cfg)
    assert not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32
    host = Trainer(load_model(str(FULL), "cpu"), spec, config=cfg)
    lc = [card.step(x, y) for _ in range(2)]
    lh = [host.step(x, y) for _ in range(2)]
    np.testing.assert_allclose(lc, lh, rtol=1e-4)
    for k, v in host.params.items():
        assert float((card.params[k].detach().cpu() - v.detach()).abs().max()) <= 2 * 1e-3 * 2, k


def test_stream_batch_post_is_solo_post_on_card(cuda_device):
    """The fold-blur post over a batch of 4 mlkit EMAs at 640x480 equals
    each EMA's solo post bit for bit on the card (a single GEMM over the
    batch's rows put mask bytes 1 apart: ROADMAP queue 3)."""
    from backscrub_tpu_torch.pipeline.geometry import compute_roi
    geo = compute_roi(640, 480, 256, 256, 256, 256)
    mats = tedge.fold_blur_tensors(geo, cuda_device)
    rng = np.random.default_rng(5)
    for _ in range(5):
        ema = torch.from_numpy(rng.integers(0, 256, (4, 256, 256), np.uint8)).to(cuda_device)
        batch = tedge.postprocess_mask(ema, geo, mats)
        assert torch.equal(batch, torch.stack([tedge.postprocess_mask(e, geo, mats)
                                               for e in ema]))


@pytest.fixture
def nccl_mesh(cuda_device):
    """A (1, 1) mesh in an NCCL world of one (NCCL puts no two ranks on one
    card), started in this process and torn down after the test."""
    import torch.distributed as dist
    from backscrub_tpu_torch.parallel.mesh import make_mesh
    started = not dist.is_initialized()
    yield make_mesh(1, device="cuda")
    if started:
        dist.destroy_process_group()


def test_mesh_stream_batch_on_card_matches_no_mesh(nccl_mesh):
    """``MultiStreamPipeline`` over the (1, 1) mesh (K1, K2 and K3 on the
    card, the whole batch gathered over "data" by NCCL) against the same
    batch off the mesh, byte for byte, over 5 ticks of 3 streams."""
    from backscrub_tpu_torch.parallel.streams import MultiStreamPipeline
    cfg = PipelineConfig(width=640, height=480)
    meshed = MultiStreamPipeline(str(FULL), cfg, 3, nccl_mesh)
    one = MultiStreamPipeline(str(FULL), cfg, 3, device="cuda")
    assert meshed.pipe.maskgen.edge is not None
    rng = np.random.default_rng(4)
    for _ in range(5):
        f = rng.integers(0, 256, (3, 480, 640, 3), np.uint8)
        for a, b in zip(meshed.step(f), one.step(f)):
            assert torch.equal(a, b)
    assert torch.equal(meshed.ema, one.ema)


def test_mesh_server_on_card_matches_no_mesh(nccl_mesh):
    """``MultiStreamServer`` over the (1, 1) NCCL mesh, its per-tick flags
    agreed on the mesh's gloo group of the host (``Mesh.host_group``),
    against the same server off the mesh: every stream's deliveries byte
    for byte, 4 ticks of 3 streams in pull mode."""
    from backscrub_tpu_torch.parallel.streams import MultiStreamPipeline
    from backscrub_tpu_torch.runtime.multistream import MultiStreamServer
    assert nccl_mesh.host_group() is not None
    cfg = PipelineConfig(width=640, height=480)
    rng = np.random.default_rng(5)
    frames = rng.integers(0, 256, (3, 4, 480, 640, 3), np.uint8)

    def serve(mesh):
        got = [[] for _ in range(3)]
        its = [iter(frames[s]) for s in range(3)]
        srv = MultiStreamServer(
            MultiStreamPipeline(str(FULL), cfg, 3, mesh, device="cuda"),
            [lambda it=it: next(it, None) for it in its], [g.append for g in got])
        assert srv.run() == 4
        return [b"".join(a.tobytes() for a in g) for g in got]

    assert serve(nccl_mesh) == serve(None)


def test_mesh_train_step_on_card_matches_one_card(nccl_mesh):
    """A dp + tp + sp ``Trainer`` on the (1, 1) mesh against the one-card
    Trainer from the same parameters: losses rtol 1e-6, parameters within
    2·lr·n after 3 steps."""
    from backscrub_tpu_torch.graph.executor import load_model
    from backscrub_tpu_torch.models.specs import spec_for_model
    from backscrub_tpu_torch.train.trainer import TrainConfig, Trainer
    rng = np.random.default_rng(3)
    x = rng.random((4, 96, 160, 3), dtype=np.float32)
    y = (rng.random((4, 96, 160)) > 0.5).astype(np.float32)
    spec = spec_for_model(str(FULL))
    meshed = Trainer(load_model(str(FULL), "cuda"), spec, nccl_mesh,
                     TrainConfig(learning_rate=1e-3, spatial_shard=True))
    one = Trainer(load_model(str(FULL), "cuda"), spec, config=TrainConfig(learning_rate=1e-3))
    np.testing.assert_allclose([meshed.step(x, y) for _ in range(3)],
                               [one.step(x, y) for _ in range(3)], rtol=1e-6)
    got = meshed.params
    for k, v in one.params.items():
        assert float((got[k] - v.detach()).abs().max()) <= 2 * 1e-3 * 3, k


def test_mesh_without_cuda_raises(monkeypatch):
    """CUDA asked for and absent: the mesh and the world raise, with no
    fall back to the CPU."""
    from backscrub_tpu_torch.parallel.mesh import make_mesh, run_world
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_mesh(1, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_world(print, 1, "cuda")
