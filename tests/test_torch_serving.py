"""The port's serving loop and staging ring on the CPU (counterparts of
``tests/test_serving.py`` and ``tests/test_staging.py``, case for case):
the loop delivers exactly the bytes of sequential ``step`` calls, in
order, in every mode; the ring's bounds and the drain thread's error path
hold; on a CPU device staging reports itself unsupported and degrades to
plain transfers with identical bytes.  The card's side (page-locked
copies, side-stream downloads) is held in ``tests/test_torch_cuda.py``.
"""

import pathlib
import sys
import threading

import numpy as np
import pytest
import torch

from backscrub_tpu_torch.io.staging import (Download, StagingRing, pinned_supported,
                                            probe_staging, start_download)
from backscrub_tpu_torch.pipeline.frame import FramePipeline, PipelineConfig
from backscrub_tpu_torch.runtime.serving import ServingLoop

ROOT = pathlib.Path(__file__).resolve().parent.parent
MODEL = ROOT / "tests" / "data" / "segm_synth_lite_96x160.tflite"
W, H = 64, 48


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: at these tiny frames it is faster than many,
    and the suite's parallel workers then do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pipe():
    return FramePipeline(str(MODEL), PipelineConfig(width=W, height=H, use_bilateral=False),
                         device="cpu")


def _frames(n, seed=1234):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (H, W, 3), np.uint8) for _ in range(n)]


def _golden(pipe, frames, bg):
    pipe.reset()
    return [pipe.step(f, bg)[0].numpy().copy() for f in frames]


@pytest.mark.parametrize("depth,drain_thread,staging", [
    (1, False, False), (2, False, False), (3, False, False), (3, True, False),
    (2, True, True)])
def test_serving_preserves_order_and_count(pipe, depth, drain_thread, staging):
    frames = _frames(10)
    bg = np.zeros((H, W, 3), np.uint8)
    golden = _golden(pipe, frames, bg)
    pipe.reset()
    loop = ServingLoop(pipe, depth=depth, drain_thread=drain_thread, staging=staging)
    got = []
    it = iter(frames)
    n = loop.run(lambda: next(it, None), lambda a: got.append(a.copy()),
                 background=lambda: bg)
    assert n == 10 and len(got) == 10
    for g, o in zip(golden, got):
        np.testing.assert_array_equal(g, o)


def test_serving_frame_budget(pipe):
    frames = iter(_frames(20))
    outs = []
    loop = ServingLoop(pipe, depth=2)
    n = loop.run(lambda: next(frames, None), outs.append, frames=5)
    assert n == 5 and len(outs) == 5


def test_serving_bad_depth(pipe):
    with pytest.raises(ValueError):
        ServingLoop(pipe, depth=0)


@pytest.mark.parametrize("drain_thread", [False, True])
def test_serving_loop_soak_ring_bounded(pipe, drain_thread):
    """300 frames: the in-flight ring never exceeds depth+1, every frame is
    delivered exactly once, in submission order (each frame's index is
    stamped into its top-left block; filter off, so output = its YUYV).
    With the drain thread the interpreter switches threads every
    microsecond, so a lost or reordered hand-off would show."""
    loop = ServingLoop(pipe, depth=3, drain_thread=drain_thread)
    frames = []
    for i in range(300):
        f = np.zeros((H, W, 3), np.uint8)
        f[:8, :8] = (i * 97) % 251
        frames.append(f)
    expect = [int(pipe.step(f, frames[0], filter_active=False)[0][0, 0]) for f in frames]
    got, max_ring = [], 0
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for f in frames:
            loop.submit(f, frames[0], filter_active=False)
            max_ring = max(max_ring, len(loop._ring))
            loop.drain_ready(lambda a: got.append(int(a[0, 0])))
        loop.drain_all(lambda a: got.append(int(a[0, 0])))
    finally:
        sys.setswitchinterval(old)
        loop.close()
    assert len(got) == 300 and max_ring <= loop.depth + 1
    assert got == expect
    if drain_thread:
        assert not loop._worker.is_alive()


def test_serving_drain_thread_matches_sync(pipe):
    """drain_thread=True delivers the same outputs in the same order as
    the synchronous path, with every sink call on the consumer thread."""
    frames = _frames(10)
    bg = np.zeros((H, W, 3), np.uint8)
    golden = _golden(pipe, frames, bg)
    pipe.reset()
    loop = ServingLoop(pipe, depth=3, drain_thread=True)
    got, threads = [], set()

    def sink(arr):
        got.append(arr.copy())
        threads.add(threading.current_thread().name)

    it = iter(frames)
    n = loop.run(lambda: next(it, None), sink, background=lambda: bg)
    loop.close()
    assert n == 10 and len(got) == 10
    assert threads == {"bs-drain"}
    for g, ref in zip(got, golden):
        np.testing.assert_array_equal(g, ref)


def test_serving_drain_thread_sink_error_propagates(pipe):
    pipe.reset()
    loop = ServingLoop(pipe, depth=1, drain_thread=True)
    bg = np.zeros((H, W, 3), np.uint8)

    def bad_sink(arr):
        raise RuntimeError("sink exploded")

    with pytest.raises(RuntimeError, match="sink exploded"):
        for f in _frames(5):
            loop.submit(f, bg)
            loop.drain_ready(bad_sink)
        loop.drain_all(bad_sink)
    loop.close()
    loop.close()  # idempotent


# ---------------------------------------------------------------------------
# staging (counterpart of tests/test_staging.py)


def test_pinned_supported_false_on_cpu():
    assert pinned_supported("cpu") is False
    assert StagingRing("cpu").supported is False


def test_staging_ring_refuses_missing_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert pinned_supported("cuda") is False
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        StagingRing()


def test_upload_roundtrip_bit_exact():
    ring = StagingRing("cpu")
    x = np.random.default_rng(3).integers(0, 256, (H, W, 3), np.uint8)
    dev = ring.upload(x)
    assert dev.device.type == "cpu"
    np.testing.assert_array_equal(dev.numpy(), x)
    np.testing.assert_array_equal(ring.fetch(dev), x)


def test_upload_accepts_noncontiguous():
    ring = StagingRing("cpu")
    x = np.random.default_rng(4).integers(0, 256, (H, 2 * W, 3), np.uint8)[:, ::2]
    np.testing.assert_array_equal(ring.upload(x).numpy(), x)


def test_ring_depth_semantics():
    ring = StagingRing("cpu", depth=2)
    rng = np.random.default_rng(5)
    xs = [rng.integers(0, 256, (16, 16), np.uint8) for _ in range(5)]
    got = []
    for x in xs:
        ring.stage_out(ring.upload(x))
        got.extend(ring.drain())
    assert len(got) == 3  # 5 staged, 2 still in flight
    got.extend(ring.drain(force=True))
    assert len(got) == 5
    for a, b in zip(got, xs):
        np.testing.assert_array_equal(a, b)


def test_bad_depth_rejected():
    with pytest.raises(ValueError):
        StagingRing("cpu", depth=0)


def test_download_of_a_cpu_tensor_is_the_tensor():
    t = torch.arange(12, dtype=torch.uint8).reshape(3, 4)
    d = start_download(t, None)
    assert isinstance(d, Download)
    np.testing.assert_array_equal(d.wait(), t.numpy())
    assert np.shares_memory(d.wait(), t.numpy())  # no copy: the tensor is its own host copy


@pytest.mark.parametrize("fmt", ["yuyv", "nv12"])
def test_serving_loop_staged_matches_plain(fmt):
    frames = _frames(6)
    bg = np.random.default_rng(6).integers(0, 256, (H, W, 3), np.uint8)
    outs = {}
    for staged in (False, True):
        p = FramePipeline(str(MODEL), PipelineConfig(width=W, height=H, output_format=fmt),
                          device="cpu")
        loop = ServingLoop(p, depth=2, staging=staged)
        assert (loop.staging is not None) == staged
        it = iter(frames)
        got = []
        loop.run(lambda: next(it, None), lambda a: got.append(a.copy()),
                 background=lambda: bg)
        outs[staged] = got
    assert len(outs[False]) == len(outs[True]) == len(frames)
    for a, b in zip(outs[False], outs[True]):
        np.testing.assert_array_equal(a, b)


def test_probe_staging_reports_and_decides():
    """On a CPU device the probe measures the plain roundtrip and decides
    against staging."""
    pr = probe_staging(W, H, frames=4, device="cpu")
    assert pr["plain_ms"] > 0
    assert pr["supported"] is False and pr["use_staging"] is False


def _jpeg_frames(n):
    """(coefs, qtabs) frames of n seeded JPEGs (the port's encoder and
    host packer, quality 90) and their stream geometry."""
    from backscrub_tpu_torch.io.jpeg import JpegEntropyDecoder, JpegHuffmanEncoder, make_info
    from backscrub_tpu_torch.pipeline.jpeg_enc import encode_jpeg_coefs, stream_qtabs
    info, qt = make_info(W, H), stream_qtabs(90)
    enc, dec = JpegHuffmanEncoder(info, qt), JpegEntropyDecoder()
    out = []
    for f in _frames(n):
        coefs = encode_jpeg_coefs(torch.from_numpy(f), torch.from_numpy(qt.astype(np.int32)),
                                  info)
        c, q = dec.decode(enc.encode([x.numpy() for x in coefs]))
        out.append((tuple(x.copy() for x in c), q))
    return out, dec.info


@pytest.mark.parametrize("drain_thread,staging", [(False, False), (True, True)])
def test_serving_loop_mjpg_in_and_out_matches_steps(drain_thread, staging):
    """MJPG coefficient frames in and coefficient tuples out through the
    loop: every array of a frame staged (one ring slot), every array of a
    result downloaded, and the results those of sequential steps."""
    frames, info = _jpeg_frames(5)
    cfg = PipelineConfig(width=W, height=H, input_format="mjpg", jpeg_info=info,
                         output_format="mjpg")
    p = FramePipeline(str(MODEL), cfg, device="cpu")
    golden = [tuple(c.numpy().copy() for c in p.step(f)[0]) for f in frames]
    p.reset()
    loop = ServingLoop(p, depth=2, staging=staging, drain_thread=drain_thread)
    it, got = iter(frames), []
    assert loop.run(lambda: next(it, None), got.append) == len(frames)
    assert len(got) == len(golden)
    for a, b in zip(got, golden):
        assert isinstance(a, tuple) and len(a) == 3
        assert all(np.array_equal(x, y) for x, y in zip(a, b))


def test_staging_ring_uploads_a_frame_tuple_in_one_slot():
    ring = StagingRing("cpu", depth=1)
    frames, _ = _jpeg_frames(1)
    coefs, q = frames[0]
    dev = ring.upload((coefs, q))
    assert isinstance(dev, tuple) and isinstance(dev[0], tuple) and len(dev[0]) == 3
    assert all(np.array_equal(d.numpy(), c) for d, c in zip(dev[0], coefs))
    assert np.array_equal(dev[1].numpy(), q)
