"""The port's program: CLI parsing, sources and sinks, background sources,
the V4L2 bindings, path resolution, raw camera ingest and ``cli.main``
itself, on the CPU, against the JAX package's counterparts
(``tests/test_io_cli.py``, ``tests/test_resolve_path.py``,
``tests/test_debug_ui.py``).

``cli.main(argv, device="cpu")`` and the JAX ``cli.main(argv)`` run the
same argv on the committed synthetic segm_lite model; their raw output
files have equal sizes and meet the repo's tolerance invariant (no byte
off by more than 1, at most 2% of a frame's bytes differ, at most 0.2%
over the sequence).  Raw ingest decoders are bit for bit the JAX ones.
"""

import json
import os
import pathlib
import signal
import sys

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

import backscrub_tpu.cli as jcli
from backscrub_tpu.io.streams import SyntheticSource as JaxSyntheticSource
from backscrub_tpu.models import specs as jspecs
from backscrub_tpu.pipeline import image as jimage
from backscrub_tpu.pipeline.frame import FramePipeline as JaxPipeline
from backscrub_tpu.pipeline.frame import PipelineConfig as JaxConfig
from backscrub_tpu.utils.debug_ui import DebugState as JaxDebugState
from backscrub_tpu.utils.debug_ui import compose_debug_view as jax_compose

from backscrub_tpu_torch import cli
from backscrub_tpu_torch.io import streams
from backscrub_tpu_torch.io.background import BackgroundSource, load_background
from backscrub_tpu_torch.io.streams import (FileFrameSink, FileSource, LatestFrameReader,
                                            NullFrameSink, SyntheticSource, open_sink,
                                            open_source)
from backscrub_tpu_torch.models import specs
from backscrub_tpu_torch.pipeline import image
from backscrub_tpu_torch.pipeline.frame import FramePipeline, PipelineConfig
from backscrub_tpu_torch.utils.debug_ui import DebugState, compose_debug_view
from backscrub_tpu_torch.utils.timing import StageTimer

from conftest import background_image_path, background_video_path

ROOT = pathlib.Path(__file__).resolve().parent.parent
MODEL = str(ROOT / "tests" / "data" / "segm_synth_lite_96x160.tflite")
FRAME_TOL, MEAN_TOL = 0.02, 0.002
# --bf16: the port's differing bytes from the JAX bf16 file, at most this
# share of the JAX bf16 file's from the JAX f32 one
BF16_SHARE = 0.5
CW, CH, N = 128, 96, 8


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: at these tiny frames it is faster than many,
    and the suite's parallel workers then do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tools():
    tools = str(ROOT / "tools")
    if tools not in sys.path:
        sys.path.insert(0, tools)
    import make_synth_segm
    return make_synth_segm


def _held(a: np.ndarray, b: np.ndarray, frame_bytes: int):
    """The tolerance invariant over a raw file's frames."""
    assert a.shape == b.shape and a.size % frame_bytes == 0
    assert int(np.abs(a.astype(np.int16) - b).max(initial=0)) <= 1
    fracs = (a != b).reshape(-1, frame_bytes).mean(axis=1)
    assert fracs.max() <= FRAME_TOL, fracs
    assert fracs.mean() <= MEAN_TOL, fracs


# ---------------------------------------------------------------------------
# argument parsing (app/deepseg.cc:379-530 contract; tests/test_io_cli.py)


def test_parse_defaults():
    cfg = cli.parse_args([])
    assert cfg["ccam"] == "/dev/video0"
    assert cfg["vcam"] == "/dev/video1"
    assert cfg["cap_geo"] == (640, 480)
    assert "selfiesegmentation_mlkit" in cfg["model"]


def test_parse_geometry_flags():
    cfg = cli.parse_args(["--cg", "1280x720", "--vg", "1920x1080"])
    assert cfg["cap_geo"] == (1280, 720)
    assert cfg["vid_geo"] == (1920, 1080)
    assert cli.parse_geometry("nonsense") is None


def test_parse_deprecated_wh_conflict():
    with pytest.raises(ValueError):
        cli.parse_args(["-w", "640", "--cg", "640x480"])


def test_parse_device_prefix():
    cfg = cli.parse_args(["-c", "video5", "-v", "video9"])
    assert cfg["ccam"] == "/dev/video5"
    assert cfg["vcam"] == "/dev/video9"
    cfg = cli.parse_args(["-c", "test:", "-v", "null:"])
    assert cfg["ccam"] == "test:"


def test_parse_bgblur_reference_semantics():
    # odd accepted; even rejected; non-numeric falls back to 25
    # (app/deepseg.cc:420-430)
    assert cli.parse_args(["-p", "bgblur:25"])["blur_strength"] == 25
    with pytest.raises(ValueError):
        cli.parse_args(["-p", "bgblur:24"])
    assert cli.parse_args(["-p", "bgblur:x"])["blur_strength"] == 25
    with pytest.raises(ValueError):
        cli.parse_args(["-p", "nonsense:1"])


def test_parse_bg_effects():
    cfg = cli.parse_args(["-p", "bgpixelate:12", "-p", "bgdesat"])
    assert cfg["bg_pixelate"] == 12 and cfg["bg_desaturate"]
    assert cli.parse_args(["-p", "bgpixelate"])["bg_pixelate"] == 16  # default
    with pytest.raises(ValueError):
        cli.parse_args(["-p", "bgpixelate:1"])


def test_usage_on_unknown(capsys):
    with pytest.raises(ValueError):
        cli.parse_args(["--bogus"])
    assert cli.main(["--bogus"], device="cpu") == 1
    assert "usage:" in capsys.readouterr().err
    assert cli.main(["-?"], device="cpu") == 1


@pytest.mark.parametrize("argv", [
    [], ["-c", "video5", "-v", "video9", "-d", "-d", "-s"],
    ["--cg", "320x240", "--vg", "160x120", "-t", "4", "-f", "YUYV", "-H", "-V"],
    ["-w", "320", "-h", "240", "-p", "bgblur:7", "-p", "refine:box", "-p", "jpegq:70"],
    ["-p", "morph:close:5", "--frames", "9", "--bf16", "--int8", "--no-bilateral",
     "--correct-colors", "--staging-force", "--sink-format", "NV12",
     "--stats-json", "s.jsonl", "--drain-thread", "-b", "bg.png", "-m", "m.tflite"]])
def test_parse_args_matches_jax(argv):
    assert cli.parse_args(argv) == jcli.parse_args(argv)


# ---------------------------------------------------------------------------
# sources and sinks


def test_synthetic_source_bit_identical_to_jax():
    a, b = SyntheticSource(64, 48), JaxSyntheticSource(64, 48)
    for _ in range(5):
        fa, fb = a.read(), b.read()
        assert fa.shape == (48, 64, 3) and fa.dtype == np.uint8
        np.testing.assert_array_equal(fa, fb)
    assert not np.array_equal(SyntheticSource(64, 48).read(), fa)


def test_file_source_still_image():
    src = open_source(background_image_path(), 320, 240)
    f = src.read()
    assert f.shape == (240, 320, 3)
    np.testing.assert_array_equal(f, src.read())  # stills repeat forever
    src.close()


def test_file_source_video_loops():
    src = FileSource(background_video_path(), 160, 120, loop=True)
    n_frames = 0
    for _ in range(100):
        if src.read() is None:
            break
        n_frames += 1
    assert n_frames == 100  # the 24-frame video looped past EOF
    src.close()
    once = FileSource(background_video_path(), 160, 120, loop=False)
    assert sum(once.read() is not None for _ in range(30)) == 24
    once.close()


def test_latest_frame_reader_paces_and_eofs():
    """Consumer gets each frame at most once, in order, None at EOF."""
    import time
    counter = [0]

    def produce():
        if counter[0] >= 20:
            return None
        counter[0] += 1
        time.sleep(0.002)
        return np.full((2, 2), counter[0], np.uint8)

    r = LatestFrameReader(produce)
    seen = []
    while True:
        f = r.read(timeout=2.0)
        if f is None:
            break
        seen.append(int(f[0, 0]))
    r.close()
    r.join()
    assert seen, "no frames delivered"
    assert seen == sorted(set(seen)), "stale or duplicate frame delivered"
    assert seen[-1] == 20 or len(seen) < 20


def test_latest_frame_reader_skips_to_newest():
    """A slow consumer sees the newest frame, not a backlog."""
    import time
    counter = [0]

    def produce():
        if counter[0] >= 50:
            return None
        counter[0] += 1
        return np.full((1,), counter[0], np.uint8)

    r = LatestFrameReader(produce)
    time.sleep(0.2)  # let the producer run ahead to EOF
    first = r.read(timeout=2.0)
    assert first is not None and int(first[0]) == 50
    assert r.read(timeout=2.0) is None  # nothing newer, EOF
    r.close()


def test_null_sink_counts():
    sink = open_sink("null:", 64, 48)
    assert isinstance(sink, NullFrameSink)
    sink.write_yuyv(np.zeros((48, 128), np.uint8))
    assert sink.frames == 1


def test_raw_yuv_file_sink(tmp_path):
    p = str(tmp_path / "out.yuv")
    sink = FileFrameSink(p, 64, 48)
    sink.write_yuyv(np.full((48, 128), 7, np.uint8))
    sink.write_yuyv(np.full((48, 128), 9, np.uint8))
    sink.close()
    data = open(p, "rb").read()
    assert len(data) == 2 * 48 * 128
    assert data[0] == 7 and data[-1] == 9
    sink = open_sink(f"file:{tmp_path / 'o.raw'}", 64, 48, out_format="nv12")
    sink.write_yuyv(np.full((72, 64), 3, np.uint8))
    sink.close()
    assert (tmp_path / "o.raw").stat().st_size == 72 * 64


@pytest.fixture
def jax_streams():
    """The JAX package's streams, its entropy codec the library the port
    builds (no CMake build needed)."""
    from backscrub_tpu_torch import _build
    os.environ.setdefault("BSJPEG_LIB", _build.host_library("bsjpeg"))
    from backscrub_tpu.io import streams as jstreams
    return jstreams


def _mjpg_source(mod, jstreams):
    """``open_source("mjpg:", 64, 48)``: the first frame (decoded at
    construction, so deterministic) and the geometry match the JAX
    source's."""
    ours, theirs = mod.open_source("mjpg:", 64, 48), jstreams.open_source("mjpg:", 64, 48)
    try:
        assert ours.jpeg_info.__dict__ == theirs.jpeg_info.__dict__
        (c1, q1), (c2, q2) = ours.read(), theirs.read()
        assert all(np.array_equal(a, b) for a, b in zip(c1, c2)) and np.array_equal(q1, q2)
    finally:
        ours.close()
        theirs.close()


def _mjpg_sink(mod, jstreams, tmp_path):
    """``open_sink(..., out_format="mjpg")``: null: counts frames as the
    JAX sink does; a file sink packs the bytes the JAX sink packs."""
    from backscrub_tpu_torch.io.jpeg import make_info
    from backscrub_tpu_torch.pipeline.jpeg_enc import encode_jpeg_coefs, stream_qtabs
    assert type(mod.open_sink("null:", 64, 48, out_format="mjpg")).__name__ == \
        type(jstreams.open_sink("null:", 64, 48, out_format="mjpg")).__name__ == "NullFrameSink"
    info, qt = make_info(64, 48), stream_qtabs(85)
    img = torch.from_numpy(np.random.default_rng(1).integers(0, 256, (48, 64, 3), np.uint8))
    coefs = tuple(c.numpy() for c in encode_jpeg_coefs(img, torch.from_numpy(
        qt.astype(np.int32)), info))
    for m, name in ((mod, "t.mjpg"), (jstreams, "j.mjpg")):
        sink = m.open_sink(f"file:{tmp_path / name}", 64, 48, out_format="mjpg",
                           jpeg_info=info, jpeg_qtabs=qt)
        sink.write_yuyv(coefs)
        sink.close()
    assert (tmp_path / "t.mjpg").read_bytes() == (tmp_path / "j.mjpg").read_bytes()


def _empty_jpeg(mod, jstreams):
    """A grab that returns no bytes raises the JAX source's ValueError."""
    errs = []
    for m in (mod, jstreams):
        with pytest.raises(ValueError) as e:
            m.JpegSource(lambda: b"")
        errs.append(str(e.value))
    assert errs[0] == errs[1]


def _packing_sink(mod, jstreams):
    """JpegPackingSink takes the JAX sink's arguments and writes its bytes."""
    from backscrub_tpu_torch.io.jpeg import make_info
    from backscrub_tpu_torch.pipeline.jpeg_enc import stream_qtabs
    for m in (mod, jstreams):
        with pytest.raises(TypeError):
            m.JpegPackingSink()
    info, qt = make_info(16, 16), stream_qtabs(50)
    coefs = tuple(np.zeros(b + (64,), np.int16) for b in info.blocks)
    got = []
    for m in (mod, jstreams):
        out = []
        m.JpegPackingSink(info, qt, out.append).write_yuyv(coefs)
        got.append(out)
    assert got[0] == got[1] and len(got[0]) == 1


@pytest.mark.parametrize("make", [_mjpg_source, _mjpg_sink, _empty_jpeg, _packing_sink])
def test_mjpg_io_not_yet(make, jax_streams, tmp_path):
    """The MJPG sources and sinks that raised NotImplementedError before
    the port served them, each against the JAX package's."""
    kw = {"tmp_path": tmp_path} if make is _mjpg_sink else {}
    make(streams, jax_streams, **kw)


# ---------------------------------------------------------------------------
# background source (app/background.cc behaviour)


def test_background_still():
    bg = BackgroundSource(background_image_path())
    assert not bg.video
    f = bg.grab(320, 200)
    assert f.shape == (200, 320, 3)
    bg.close()


def test_background_video_paced():
    import time
    with BackgroundSource(background_video_path()) as bg:
        assert bg.video and bg.fps > 0
        f1 = bg.grab(160, 120)
        time.sleep(3.0 / bg.fps)
        f2 = bg.grab(160, 120)
        assert f1.shape == f2.shape == (120, 160, 3)
        assert not np.array_equal(f1, f2)  # the reader thread advanced


def test_background_load_failure_returns_none():
    assert load_background("/no/such/file.png") is None


# ---------------------------------------------------------------------------
# native shim (build availability + fd write loop)


def test_bsio_loads_and_writes(tmp_path):
    from backscrub_tpu_torch.io import v4l2
    try:
        lib = v4l2.load_bsio()
    except RuntimeError:
        pytest.skip("libbsio.so not built")
    assert b"bsio" in lib.bsio_version()
    p = str(tmp_path / "frame.bin")
    fd = os.open(p, os.O_WRONLY | os.O_CREAT, 0o644)
    buf = np.arange(4096, dtype=np.uint8)
    rc = lib.bsio_loopback_write(fd, buf.ctypes.data, buf.nbytes)
    os.close(fd)
    assert rc == 0
    assert open(p, "rb").read() == buf.tobytes()


def test_fourcc():
    from backscrub_tpu_torch.io.v4l2 import fourcc
    assert fourcc("YUYV") == 0x56595559
    assert fourcc("MJPG") == 0x47504A4D
    assert fourcc("47504A4D") == 0x47504A4D
    assert fourcc("nv12") == fourcc("NV12")


# ---------------------------------------------------------------------------
# resource resolution (app/deepseg.cc:292-347; tests/test_resolve_path.py)


@pytest.fixture
def clean_env(monkeypatch, tmp_path):
    """Every search root at an empty temp dir, so only what the test
    creates can match."""
    for var in ("BACKSCRUB_PATH", "BACKSCRUB_TPU_MODELS", "BACKSCRUB_TPU_BACKGROUNDS"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("XDG_DATA_HOME", str(tmp_path / "xdg"))
    monkeypatch.setenv("BACKSCRUB_INSTALL_PREFIX", str(tmp_path / "prefix"))
    return tmp_path


@pytest.mark.parametrize("type_", ["models", "backgrounds"])
def test_resolve_path_matches_jax(clean_env, monkeypatch, type_):
    t = clean_env
    for d in (t / "rootA" / type_, t / "flat", t / "xdg" / "backscrub" / type_,
              t / "prefix" / "share" / "backscrub" / type_, t / "extra"):
        d.mkdir(parents=True)
    (t / "rootA" / type_ / "a.bin").write_bytes(b"x")
    (t / "flat" / "b.bin").write_bytes(b"x")
    (t / "xdg" / "backscrub" / type_ / "c.bin").write_bytes(b"x")
    (t / "prefix" / "share" / "backscrub" / type_ / "d.bin").write_bytes(b"x")
    (t / "extra" / "e.bin").write_bytes(b"x")
    (t / "lit.bin").write_bytes(b"x")
    monkeypatch.setenv("BACKSCRUB_PATH", f"{t / 'rootB'}:{t / 'rootA'}:{t / 'flat'}")
    monkeypatch.setenv("BACKSCRUB_TPU_MODELS" if type_ == "models"
                       else "BACKSCRUB_TPU_BACKGROUNDS", str(t / "extra"))
    names = ["a.bin", "b.bin", "c.bin", "d.bin", "e.bin", "missing.bin", str(t / "lit.bin"),
             "sub/a.bin", "https://example.com/bg.mp4", "v4l2src:/dev/video9", "C:missing"]
    got = [specs.resolve_path(n, type_) for n in names]
    assert got == [jspecs.resolve_path(n, type_) for n in names]
    assert got[:5] == [str(t / "rootA" / type_ / "a.bin"), str(t / "flat" / "b.bin"),
                       str(t / "xdg" / "backscrub" / type_ / "c.bin"),
                       str(t / "prefix" / "share" / "backscrub" / type_ / "d.bin"),
                       str(t / "extra" / "e.bin")]
    assert got[5:] == [None, str(t / "lit.bin"), None, "https://example.com/bg.mp4",
                       "v4l2src:/dev/video9", None]
    # the package-relative step is each package's own root; the rest agree
    assert specs.search_candidates("x", type_)[:-3] == jspecs.search_candidates("x", type_)[:-3]


def test_resolve_model_path_raises(clean_env):
    assert specs.resolve_model_path(MODEL) == MODEL
    with pytest.raises(FileNotFoundError, match="BACKSCRUB_PATH"):
        specs.resolve_model_path("no_such_model.tflite")


# ---------------------------------------------------------------------------
# debug HUD and stage timing


def test_debug_state_and_compose_match_jax():
    keys = "shvfbm?xq"
    a, b = DebugState(), JaxDebugState()
    for c in keys:
        a.handle_key(ord(c))
        b.handle_key(ord(c))
        assert vars(a) == vars(b)
    a.handle_key(-1)
    out = np.random.default_rng(2).integers(0, 256, (480, 640, 3), np.uint8)
    mask = np.full((480, 640), 255, np.uint8)
    mask[100:200, 100:200] = 0
    thumb = np.full((120, 160, 3), 128, np.uint8)
    for state in (DebugState(show_help=True), DebugState(show_mask=False)):
        kw = dict(mask=mask, bg_thumb=thumb, main_fps=30.0, ai_fps=25.0,
                  cap_geo=(640, 480), vid_geo=(640, 480))
        np.testing.assert_array_equal(compose_debug_view(out, state, **kw),
                                      jax_compose(out, state, **kw))


def test_stage_timer_report():
    import time
    t = StageTimer()
    for _ in range(3):
        t.start()
        time.sleep(0.001)
        t.mark("grab")
        time.sleep(0.002)
        t.mark("dispatch")
        t.frame_done()
    rec = t.report_dict()
    assert rec["fps"] > 0 and rec["ai_fps"] > 0
    assert 1.0 <= rec["grab_ms"] < rec["dispatch_ms"]
    assert "upload_ms" not in rec
    assert "dispatch:" in t.report_line() and "AiFPS:" in t.report_line()


# ---------------------------------------------------------------------------
# raw camera ingest (backscrub_tpu/pipeline/image.py:475-540, frame.py:229-238)


@pytest.mark.parametrize("layout", ["yuyv", "uyvy"])
@pytest.mark.parametrize("chroma_order", ["yuy2", "reference"])
def test_yuyv_to_rgb_bit_identical_to_jax(layout, chroma_order):
    x = np.random.default_rng(7).integers(0, 256, (2, 10, 16, 2), np.uint8)
    got = image.yuyv_to_rgb_u8(torch.from_numpy(x), chroma_order, layout)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jimage.yuyv_to_rgb_u8(x, chroma_order, layout=layout)))
    code = cv2.COLOR_YUV2RGB_YUY2 if layout == "yuyv" else cv2.COLOR_YUV2RGB_UYVY
    if chroma_order == "yuy2":
        np.testing.assert_array_equal(got[0].numpy(), cv2.cvtColor(x[0], code))


def test_nv12_to_bgr_bit_identical_to_jax_and_cv2():
    x = np.random.default_rng(8).integers(0, 256, (2, 30, 16), np.uint8)
    got = image.nv12_to_bgr_u8(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jimage.nv12_to_bgr_u8(x)))
    np.testing.assert_array_equal(got[0], cv2.cvtColor(x[0], cv2.COLOR_YUV2BGR_NV12))


def _raw(frame_bgr, fmt):
    """A BGR frame as a camera's raw bytes."""
    h, w = frame_bgr.shape[:2]
    if fmt == "yuyv":
        return cv2.cvtColor(frame_bgr, cv2.COLOR_BGR2YUV_YUY2).reshape(h, 2 * w)
    if fmt == "uyvy":
        return cv2.cvtColor(frame_bgr, cv2.COLOR_BGR2YUV_UYVY).reshape(h, 2 * w)
    return image.bgr_to_nv12(torch.from_numpy(frame_bgr)).numpy()


@pytest.mark.parametrize("fmt", ["yuyv", "uyvy", "nv12"])
def test_raw_ingest_pipeline_matches_jax(fmt):
    """FramePipeline(input_format=fmt) against the JAX one on the same raw
    bytes (YUYV out, packed output and mask under the invariant), and
    byte for byte against the port's BGR path on the decoded frame."""
    frames = [_raw(f, fmt) for f in _tools().moving_frames(CW, CH, 4)]
    bg = np.random.default_rng(5).integers(0, 256, (CH, CW, 3), np.uint8)
    port = FramePipeline(MODEL, PipelineConfig(width=CW, height=CH, input_format=fmt),
                         device="cpu")
    bgr = FramePipeline(MODEL, PipelineConfig(width=CW, height=CH), device="cpu")
    ref = JaxPipeline(MODEL, JaxConfig(width=CW, height=CH, input_format=fmt))
    outs, masks = [], []
    for raw in frames:
        y, m = port.step(raw, bg)
        jy, jm = ref.step(raw, bg)
        decoded = port.decode(torch.from_numpy(raw))
        by, bm = bgr.step(decoded, bg)
        assert torch.equal(y, by) and torch.equal(m, bm)
        outs.append((y.numpy(), np.asarray(jy)))
        masks.append((m.numpy(), np.asarray(jm)))
    assert 0.1 <= float((masks[0][0] < 128).mean()) <= 0.9
    for pairs in (outs, masks):
        a = np.stack([p for p, _ in pairs])
        b = np.stack([q for _, q in pairs])
        _held(a.ravel(), b.ravel(), a[0].size)


def test_raw_ingest_checks():
    with pytest.raises(ValueError, match="even width"):
        FramePipeline(MODEL, PipelineConfig(width=127, height=96, input_format="yuyv",
                                            output_format="bgr"), device="cpu")
    with pytest.raises(ValueError, match="even width and height"):
        FramePipeline(MODEL, PipelineConfig(width=128, height=95, input_format="nv12",
                                            output_format="bgr"), device="cpu")
    with pytest.raises(ValueError, match="input_format"):
        FramePipeline(MODEL, PipelineConfig(input_format="rgb565"), device="cpu")
    p = FramePipeline(MODEL, PipelineConfig(width=CW, height=CH, input_format="nv12"),
                      device="cpu")
    with pytest.raises(ValueError, match="expected"):
        p.step(np.zeros((CH, 2 * CW), np.uint8))


# ---------------------------------------------------------------------------
# cli.main against the JAX CLI


def _argv(out, *extra):
    return ["-c", "test:", "--cg", f"{CW}x{CH}", "-m", MODEL, "--frames", str(N),
            "-v", f"file:{out}", *extra]


@pytest.mark.parametrize("case,extra,geo,fmt", [
    ("yuyv", [], (CW, CH), "yuyv"),
    ("nv12", ["--sink-format", "nv12"], (CW, CH), "nv12"),
    ("mirror", ["-H"], (CW, CH), "yuyv"),
    ("vg", ["--vg", "64x48"], (64, 48), "yuyv"),
    ("bgblur", ["-p", "bgblur:5"], (CW, CH), "yuyv")])
def test_cli_main_matches_jax_cli(tmp_path, case, extra, geo, fmt):
    stats = tmp_path / "s.jsonl"
    assert jcli.main(_argv(tmp_path / "j.yuv", *extra)) == 0
    assert cli.main(_argv(tmp_path / "t.yuv", *extra, "--stats-json", str(stats)),
                    device="cpu") == 0
    j = np.fromfile(tmp_path / "j.yuv", np.uint8)
    t = np.fromfile(tmp_path / "t.yuv", np.uint8)
    w, h = geo
    frame_bytes = w * h * 2 if fmt == "yuyv" else w * h * 3 // 2
    assert t.size == j.size == N * frame_bytes
    _held(t, j, frame_bytes)
    lines = [json.loads(line) for line in open(stats)]
    assert lines[-1]["final"] is True and lines[-1]["frames"] == N
    assert lines[-1]["fps"] > 0 and lines[-1]["dispatch_ms"] > 0


def test_cli_serving_modes_change_no_byte(tmp_path, capsys):
    """Drain thread, staging (probed and forced: on the CPU both degrade to
    plain transfers) and the debug level that asks for the HUD (no display
    here) write the same bytes as the plain run."""
    modes = {"plain": [], "drain": ["--drain-thread"], "staging": ["--staging"],
             "force": ["--staging-force"], "hud": ["-d", "-d"]}
    data, errs = {}, {}
    for name, extra in modes.items():
        assert cli.main(_argv(tmp_path / f"{name}.yuv", *extra), device="cpu") == 0
        data[name] = (tmp_path / f"{name}.yuv").read_bytes()
        errs[name] = capsys.readouterr().err
    assert len(data["plain"]) == N * CW * CH * 2
    assert all(d == data["plain"] for d in data.values())
    assert "using plain transfers" in errs["staging"] and "using plain transfers" in errs["force"]
    assert f"processed {N} frames" in errs["plain"]
    if not (os.environ.get("DISPLAY") or os.environ.get("WAYLAND_DISPLAY")):
        assert "HUD disabled" in errs["hud"]


class _FakeMjpgCapture:
    """A V4L2 capture that granted MJPG: the test pattern, JPEG-encoded at
    quality 90, one frame a grab."""

    def __init__(self, device, width=0, height=0, pixfmt=""):
        self.width, self.height, self.pixelformat = width, height, "MJPG"
        self._pattern = SyntheticSource(width, height)

    def grab_raw(self):
        ok, enc = cv2.imencode(".jpg", self._pattern.read(), [cv2.IMWRITE_JPEG_QUALITY, 90])
        return enc.reshape(-1)

    def close(self):
        pass


def _jpeg_frames(stream: bytes):
    """The coefficient arrays of each JPEG of a concatenated MJPEG stream
    (entropy-coded data never holds an EOI marker)."""
    from backscrub_tpu_torch.io.jpeg import JpegEntropyDecoder
    dec = JpegEntropyDecoder()
    out = []
    for part in stream.split(b"\xff\xd9")[:-1]:
        coefs, q = dec.decode(part + b"\xff\xd9")
        out.append([c.copy() for c in coefs])
    return out


@pytest.mark.parametrize("extra,title", [
    (["--bf16"], "bf16 mode"),
    (["--int8"], "Remaining lowerings and model loading"),
    (["-p", "refine:guided"], "Frame options and formats"),
    (["-p", "morph:open"], "Frame options and formats"),
    (["--sink-format", "mjpg"], "Frame options and formats"),
    (["-c", "mjpg:"], "Frame options and formats"),
    (["-c", "/dev/video0"], "Frame options and formats")])
def test_cli_refuses_what_the_port_lacks(tmp_path, capsys, monkeypatch, extra, title):
    """Every flag the port refused before it served it now runs and writes
    the JAX CLI's frames (each case keeps the ROADMAP title it was refused
    under as its label): the options of "Frame options and formats" and
    ``--int8`` (the classic stages in both programs) YUYV files under the
    tolerance invariant, MJPG streams with at most 2% of each frame's
    blocks differing; ``--bf16`` (one-pass bf16 dots, a bf16 executor) on
    the relative bar of tests/test_torch_precision_masks.py: in every
    frame no more bytes differ from the JAX CLI's ``--bf16`` file than
    that file differs from the JAX CLI's f32 file, plus 0.5% of the frame,
    and over the file at most BF16_SHARE = 0.5 as many (0.25 here), which
    the port's f32 run, the control, misses (1.0: a port that ignored bf16
    writes the JAX f32 bytes).  The JAX CLI runs its fused route (its
    Pallas kernels in interpret mode), the route it takes on its device
    and the port's on every device: its classic route on the CPU can flip
    a near-tie decode of a JPEG frame the fused route does not.  The MJPG
    sources decode in the loop's thread (no prefetch), so both programs
    take every frame; the camera is a fake V4L2 capture that grants
    MJPG."""
    import functools
    from backscrub_tpu.io import streams as jstreams
    from backscrub_tpu.io import v4l2 as jv4l2
    from backscrub_tpu.pipeline import frame as jframe
    from backscrub_tpu_torch import _build
    from backscrub_tpu_torch.io import v4l2
    monkeypatch.setattr(v4l2, "V4L2Capture", _FakeMjpgCapture)
    monkeypatch.setattr(jv4l2, "V4L2Capture", _FakeMjpgCapture)
    monkeypatch.setenv("BSJPEG_LIB", _build.host_library("bsjpeg"))
    for mod in (streams, jstreams):
        monkeypatch.setattr(mod, "JpegSource", functools.partial(mod.JpegSource, prefetch=False))
    monkeypatch.setattr(jframe, "PipelineConfig", functools.partial(
        JaxConfig, edge_interpret=True, pack_interpret=True))
    if extra[0] == "-c":
        argv = lambda o: ["-c", extra[1], "--cg", f"{CW}x{CH}", "-m", MODEL,  # noqa: E731
                          "--frames", str(N), "-v", f"file:{o}"]
    else:
        argv = lambda o: _argv(o, *extra)  # noqa: E731
    assert jcli.main(argv(tmp_path / "j.yuv")) == 0
    assert cli.main(argv(tmp_path / "t.yuv"), device="cpu") == 0
    j, t = (tmp_path / "j.yuv").read_bytes(), (tmp_path / "t.yuv").read_bytes()
    if "mjpg" in extra and extra[0] == "--sink-format":
        jf, tf = _jpeg_frames(j), _jpeg_frames(t)
        assert len(jf) == len(tf) == N
        for a, b in zip(tf, jf):
            for x, y in zip(a, b):
                assert (x != y).any(axis=-1).mean() <= FRAME_TOL
    elif extra == ["--bf16"]:
        assert jcli.main(_argv(tmp_path / "f.yuv")) == 0
        assert cli.main(_argv(tmp_path / "c.yuv"), device="cpu") == 0
        f32, ctl = (tmp_path / "f.yuv").read_bytes(), (tmp_path / "c.yuv").read_bytes()
        assert len(t) == len(j) == len(f32) == len(ctl) == N * CW * CH * 2
        tb, jb, jf, cb = (np.frombuffer(d, np.uint8).reshape(N, -1) for d in (t, j, f32, ctl))
        port, effect = (tb != jb).mean(axis=1), (jb != jf).mean(axis=1)
        assert (port <= effect + 0.005).all() and effect.mean() > 0
        assert port.mean() <= BF16_SHARE * effect.mean(), (port, effect)
        assert (cb != jb).mean() > BF16_SHARE * effect.mean()     # the control misses it
    else:
        assert len(t) == len(j) == N * CW * CH * 2
        _held(np.frombuffer(t, np.uint8), np.frombuffer(j, np.uint8), CW * CH * 2)


def test_cli_without_cuda_returns_1(tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main(_argv(tmp_path / "o.yuv")) == 1
    assert "CUDA is not available" in capsys.readouterr().err
    assert not (tmp_path / "o.yuv").exists()


def test_cli_sigterm_graceful(tmp_path, monkeypatch):
    """SIGTERM (sent from the source after 5 frames) ends the run with rc
    0, whole frames on disk and a final stats record; the previous handler
    is back afterwards."""
    real = streams.open_source

    class Terminating:
        def __init__(self, src):
            self.src, self.width, self.height, self.n = src, src.width, src.height, 0

        def read(self):
            self.n += 1
            if self.n == 6:
                os.kill(os.getpid(), signal.SIGTERM)
            return self.src.read()

        def close(self):
            self.src.close()

    monkeypatch.setattr(streams, "open_source", lambda *a: Terminating(real(*a)))
    prev = signal.getsignal(signal.SIGTERM)
    out, stats = tmp_path / "o.yuv", tmp_path / "s.jsonl"
    argv = ["-c", "test:", "--cg", f"{CW}x{CH}", "-m", MODEL, "-v", f"file:{out}",
            "--stats-json", str(stats)]
    assert cli.main(argv, device="cpu") == 0
    assert signal.getsignal(signal.SIGTERM) is prev
    assert out.stat().st_size == 6 * CW * CH * 2
    lines = [json.loads(line) for line in open(stats)]
    assert lines[-1]["final"] is True and lines[-1]["frames"] == 6
