"""The port's flagship entry, examples and tools on the CPU: ``entry()``
against ``FramePipeline.step`` and the JAX entry's step, the soak, the
atomic artifact writer, the device trace, the TFLite parity helpers and
the precision parity tool, and both examples.

Bars: ``entry()``'s step byte-equal to ``FramePipeline.step`` (the same
code on the same device) and, against the JAX package's
``FramePipeline._make_step("explicit", False, False, True)`` (the step
``__graft_entry__.entry()`` returns), the repo's tolerance invariant on
YUYV, mask and EMA (no byte off by more than 1, at most 2% of a frame's
bytes differ, at most 0.2% over the sequence).  The TFLite bar is the
north star's: person IoU >= 0.99 against ``utils/parity.reference_maskgen``
(cv2 + TFLite), at 640x480, the size the synthetic model was fitted at,
and no mask byte off by more than 1.
"""

import argparse
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from backscrub_tpu_torch.entry import entry, frame_step
from backscrub_tpu_torch.pipeline import edge as tedge
from backscrub_tpu_torch.pipeline.frame import FramePipeline, PipelineConfig
from backscrub_tpu_torch.utils.artifacts import atomic_json_dump
from backscrub_tpu_torch.utils.profiling import annotate, device_trace, wall_timer

ROOT = pathlib.Path(__file__).resolve().parent.parent
LITE = str(ROOT / "tests" / "data" / "segm_synth_lite_96x160.tflite")
FRAME_TOL, MEAN_TOL = 0.02, 0.002


def _frames(w, h, n):
    tools = str(ROOT / "tools")
    if tools not in sys.path:
        sys.path.insert(0, tools)
    from make_synth_segm import moving_frames
    return moving_frames(w, h, n)


def _invariant(pairs):
    fracs = []
    for a, b in pairs:
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype == np.uint8
        assert int(np.abs(a.astype(np.int16) - b).max()) <= 1
        fracs.append(float((a != b).mean()))
        assert fracs[-1] <= FRAME_TOL
    assert float(np.mean(fracs)) <= MEAN_TOL


def _env():
    return dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=str(ROOT))


def test_entry_matches_frame_pipeline_and_jax_entry_step():
    fn, (frame, bg, ema) = entry(LITE, device="cpu")
    assert frame.shape == bg.shape == (480, 640, 3) and frame.dtype == torch.uint8
    assert bool((ema == 255).all())
    pipe = FramePipeline(LITE, PipelineConfig(width=640, height=480), device="cpu")

    from backscrub_tpu.pipeline.frame import FramePipeline as JaxPipeline
    from backscrub_tpu.pipeline.frame import PipelineConfig as JaxConfig
    jp = JaxPipeline(LITE, JaxConfig(width=640, height=480))
    jstep = jp._make_step("explicit", False, False, True)
    jema = jp.maskgen.ema

    pairs = []
    for f in [frame.numpy()] + list(_frames(640, 480, 3)):
        yuyv, mask, ema = fn(torch.from_numpy(np.ascontiguousarray(f)), bg, ema)
        want, want_mask = pipe.step(f, bg)
        assert torch.equal(yuyv, want) and torch.equal(mask, want_mask)
        assert torch.equal(ema, pipe.maskgen.ema)
        jy, jm, jema = jstep(jp.maskgen.model.params, f, bg.numpy(), jema)
        pairs += [(yuyv, jy), (mask, jm), (ema, jema)]
    _invariant(pairs)


def _mjpg(img, info):
    """A BGR frame as the host entropy decoder's (coefs, qtabs) of its JPEG."""
    from backscrub_tpu_torch.io.jpeg import JpegEntropyDecoder, JpegHuffmanEncoder
    from backscrub_tpu_torch.pipeline.jpeg_enc import encode_jpeg_coefs, stream_qtabs
    qt = stream_qtabs(75)
    with torch.no_grad():
        c = encode_jpeg_coefs(torch.from_numpy(img), torch.from_numpy(qt.astype(np.int32)), info)
    cs, q = JpegEntropyDecoder().decode(JpegHuffmanEncoder(info, qt).encode([a.numpy() for a in c]))
    return [a.copy() for a in cs], q


@pytest.mark.parametrize("kw", [dict(input_format="yuyv", blur_strength=5),
                                dict(input_format="nv12", output_format="nv12",
                                     bg_desaturate=True, bg_pixelate=4),
                                dict(flip_horizontal=True, output_format="bgr"),
                                dict(input_format="mjpg", output_format="mjpg")])
def test_frame_step_is_step_for_every_option(kw):
    """``frame_step`` is the pipeline's own step (the input decode, the
    background effects with no background given, the flips, MJPG in and
    out), byte for byte, with the EMA carried outside."""
    from backscrub_tpu_torch.io.jpeg import make_info
    w, h = 64, 48
    if kw.get("input_format") == "mjpg":
        kw = dict(kw, jpeg_info=make_info(w, h))
    pipe = FramePipeline(LITE, PipelineConfig(width=w, height=h, **kw), device="cpu")
    solo = FramePipeline(LITE, PipelineConfig(width=w, height=h, **kw), device="cpu")
    fn, ema = frame_step(pipe), pipe.maskgen.ema.clone()
    shape = {"bgr": (h, w, 3), "yuyv": (h, 2 * w), "nv12": (h * 3 // 2, w), "mjpg": (h, w, 3)}
    fmt = kw.get("input_format", "bgr")
    rng = np.random.default_rng(3)
    for _ in range(3):
        f = rng.integers(0, 256, shape[fmt], np.uint8)
        if fmt == "mjpg":
            f = _mjpg(f, kw["jpeg_info"])
        out, mask, ema = fn(f, None, ema)
        want, want_mask = solo.step(f)
        if isinstance(want, tuple):      # MJPG out: coefficients a component
            assert len(out) == len(want) and all(map(torch.equal, out, want))
        else:
            assert torch.equal(out, want)
        assert torch.equal(mask, want_mask)
        assert torch.equal(ema, solo.maskgen.ema)
    assert bool((pipe.maskgen.ema == 255).all())     # the pipeline's own EMA untouched


def test_entry_without_the_model_raises():
    with pytest.raises(FileNotFoundError):
        entry("/no/such/model.tflite", device="cpu")


@pytest.mark.parametrize("extra", [["--ticks", "40", "--duration", "0"],
                                   ["--sigterm", "--duration", "60", "--sigterm-at", "3"],
                                   ["--ticks", "40", "--duration", "0", "--slots", "3"]])
def test_soak_smoke(tmp_path, extra):
    """Over the CPU's (2, 2) mesh of four gloo ranks, each stream checked on
    the rank that served it: 40 ticks; or unbounded until a SIGTERM to the
    tool's process at 3 s, which every rank gets and drains; or 40 ticks
    with 3 slots, rounded up to the data axis."""
    report = tmp_path / "report.json"
    r = subprocess.run([sys.executable, str(ROOT / "tools" / "soak_torch.py"), "--model", LITE,
                        "--device", "cpu", "--churn-every", "10",
                        "--check-every", "20", "--report", str(report), *extra],
                       capture_output=True, text=True, timeout=600, env=_env(), cwd=ROOT)
    assert r.returncode == 0, (r.stdout[-1000:], r.stderr[-2000:])
    rep = json.loads(report.read_text())
    assert rep["ok"], rep["failures"]
    assert rep["identity_bar"] == "byte-equal" and rep["device"] == "cpu"
    assert 0 < rep["frames_delivered"] <= rep["frames_produced"]
    assert rep["identity_checked"] == rep["frames_delivered"]
    assert not (tmp_path / "report.json.partial").exists()
    assert rep["sigterm_drained"] == ("--sigterm" in extra)
    assert rep["mesh"] == {"data": 2, "model": 2}
    assert rep["slots"] == (4 if "--slots" in extra else 8)


@pytest.mark.parametrize("case", ["clean", "off the ties", "inside the ties"])
def test_soak_card_bar(case):
    """The soak's card bar (``Verifier(exact=False)``) run here on solo
    outputs: clean frames pass; 4 corrupted bytes of one frame (far under
    the 2% share) fail where no near-tie decode reaches them, and pass
    where every EMA pixel counts as a near-tie (the post then reaches
    every pixel)."""
    tools = str(ROOT / "tools")
    if tools not in sys.path:
        sys.path.insert(0, tools)
    import soak_torch

    w, h = 64, 48
    cfg = PipelineConfig(width=w, height=h)
    v = soak_torch.Verifier(FramePipeline(LITE, cfg, device="cpu"), exact=False)
    if case == "inside the ties":
        v.tie = float("inf")
    solo = FramePipeline(LITE, cfg, device="cpu")
    sim = soak_torch.StreamSim(5, w, h, lifetime=4)
    v.register(sim)
    frames = [sim.source() for _ in range(4)]
    for f in frames:
        sim.sink(solo.step(f, solo.green)[0].numpy())
    mg = v.pipe.maskgen
    near = torch.zeros(mg.ema_shape, dtype=torch.bool)
    for f in frames[:3]:
        near |= soak_torch.decode_margin(mg, torch.from_numpy(f)).abs() <= v.TIE
    foot = soak_torch.yuyv_footprint(tedge.post_footprint(near, mg.geo, mg.post_mats)).numpy()
    if case != "clean":
        at = np.flatnonzero(~foot)[:4]
        assert at.size == 4
        sim.delivered[2].reshape(-1)[at] ^= 0x80
    if case == "off the ties":
        with pytest.raises(AssertionError, match="outside the post's reach"):
            v.advance(sim)
    else:
        assert v.advance(sim) == 4


def test_soak_without_cuda_fails():
    r = subprocess.run([sys.executable, str(ROOT / "tools" / "soak_torch.py"), "--model", LITE,
                        "--ticks", "1"], capture_output=True, text=True, timeout=300,
                       env=_env(), cwd=ROOT)
    assert r.returncode != 0 and "CUDA is not available" in r.stderr


def test_atomic_json_dump(tmp_path):
    path = tmp_path / "rec.json"
    atomic_json_dump({"a": np.float32(1.5), "n": np.int64(3), "ok": np.bool_(True),
                      "t": torch.tensor(2.0), "l": (1, [np.uint8(7)])}, path)
    assert json.loads(path.read_text()) == {"a": 1.5, "n": 3, "ok": True, "t": 2.0,
                                            "l": [1, [7]]}
    assert os.listdir(tmp_path) == ["rec.json"]
    before = path.read_text()
    for bad in (np.zeros(3), torch.zeros(2), object()):
        with pytest.raises(TypeError):
            atomic_json_dump({"fine": 1, "bad": bad}, path)
        assert path.read_text() == before and os.listdir(tmp_path) == ["rec.json"]


def test_device_trace_writes_a_trace(tmp_path):
    times = {}
    with device_trace(str(tmp_path / "trace")) as prof:
        with annotate("bs_region"), wall_timer("step", times):
            torch.ones(64).cumsum(0)
    trace = json.loads(pathlib.Path(prof.trace_path).read_text())
    assert any(e.get("name") == "bs_region" for e in trace["traceEvents"])
    assert times["step"] > 0


def test_parity_iou_against_tflite():
    from backscrub_tpu_torch.models.specs import spec_for_model
    from backscrub_tpu_torch.pipeline.maskgen import MaskGen
    from backscrub_tpu_torch.utils.parity import classmap_agreement, iou, reference_maskgen
    w, h = 640, 480
    frames = _frames(w, h, 4)
    spec = spec_for_model(LITE)
    ref = reference_maskgen(LITE, frames, w, h, spec)
    mg = MaskGen(LITE, w, h, device="cpu")
    for f in frames:
        ours = mg.process(f).numpy()
    assert iou(ours < 128, ref < 128) >= 0.99
    assert int(np.abs(ours.astype(np.int16) - ref).max()) <= 1
    assert iou(np.zeros(4, bool), np.zeros(4, bool)) == 1.0
    assert classmap_agreement(LITE, frames[0], w, h, spec) == 1.0


def test_prec_parity_tool(capsys):
    sys.path.insert(0, str(ROOT / "tools"))
    import prec_parity_torch
    assert prec_parity_torch.main(["--model", LITE, "--frames", "3"]) == 0
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]
    assert [r["mode"] for r in lines] == ["f32", "bf16", "int8"]
    assert lines[0]["agreement_min"] == 1.0   # f32: the same arithmetic as TFLite
    assert min(r["agreement_min"] for r in lines) >= 0.99


def test_minimal_demo(tmp_path, capsys):
    sys.path.insert(0, str(ROOT / "examples"))
    import minimal_demo_torch as demo
    out = tmp_path / "out.ppm"
    assert demo.main(["--model", LITE, "--device", "cpu", str(out)]) == 0
    img = demo.read_ppm(str(out))
    assert img.shape == (480, 640, 3)
    # the composite read back as input: a PPM round trip, resized from another size
    small = tmp_path / "small.ppm"
    demo.write_ppm(str(small), img[::2, ::2])
    assert demo.main(["--model", LITE, "--device", "cpu", str(small), str(out),
                      str(tmp_path / "again.ppm")]) == 0
    assert demo.read_ppm(str(tmp_path / "again.ppm")).shape == (480, 640, 3)
    assert "person pixels" in capsys.readouterr().out


def test_serve_multistream_example(capsys):
    """The example's serving in a world of one, as on a one-card machine."""
    sys.path.insert(0, str(ROOT / "examples"))
    import serve_multistream_torch as serve
    from backscrub_tpu_torch.parallel.mesh import run_world
    args = argparse.Namespace(model=LITE, device="cpu", n_streams=3, frames=2)
    assert run_world(serve.serve, 1, "cpu", args) == 0
    out = capsys.readouterr().out
    assert "mesh {'data': 1, 'model': 1}, serving 3 streams" in out
    assert "per-stream deliveries [10, 11, 12]" in out


def test_serve_multistream_example_on_a_mesh(tmp_path):
    """The example on the CPU: a (2, 2) mesh of four gloo ranks; 3 streams
    round up to the data axis, each stream delivered in full by its rank."""
    r = subprocess.run([sys.executable, str(ROOT / "examples" / "serve_multistream_torch.py"),
                        "--model", LITE, "--device", "cpu", "3", "2"],
                       capture_output=True, text=True, timeout=600, env=_env(), cwd=ROOT)
    assert r.returncode == 0, (r.stdout[-1000:], r.stderr[-2000:])
    assert "mesh {'data': 2, 'model': 2}, serving 4 streams" in r.stdout
    assert "per-stream deliveries [10, 11, 12, 10]" in r.stdout
