"""The port's C ABI (``backscrub_tpu_torch/native/bs_capi.cc``) through
ctypes, in this process (counterpart of ``tests/test_capi.py``, case for
case, on the committed synthetic segm_lite model).

The shim embeds CPython; loaded into a running interpreter it attaches to
it, so the whole path (context creation, frame and mask marshalling, the
callbacks) runs here.  It is built with the host ``c++`` at first use
(``_build.capi_library``).  The device comes from
``BACKSCRUB_TORCH_DEVICE``: ``cpu`` here, where the kernels run their
plain versions; unset, it is the card, and without one construction fails.

Bars: the C path's masks byte-equal to the Python ``MaskGen`` on the same
device and options; the staged masks against the fused ones under the
repo's tolerance invariant, as ``tests/test_torch_classic.py`` holds them
(no byte off by more than 1, at most 2% of a frame's bytes differ, at most
0.2% over the sequence); the C path's masks against the JAX ``MaskGen``
(its classic route, the JAX package's CPU path) under the same invariant.
"""

import ctypes
import os
import pathlib
import sys

import numpy as np
import pytest
import torch

from backscrub_tpu_torch import _build
from backscrub_tpu_torch.pipeline.maskgen import MaskGen

ROOT = pathlib.Path(__file__).resolve().parent.parent
LITE = str(ROOT / "tests" / "data" / "segm_synth_lite_96x160.tflite")
W, H = 64, 48
FRAME_TOL, MEAN_TOL = 0.02, 0.002
CB = ctypes.CFUNCTYPE(None, ctypes.c_void_p)
DBG = ctypes.CFUNCTYPE(None, ctypes.c_void_p, ctypes.c_char_p)


@pytest.fixture(scope="module")
def lib():
    lib = ctypes.CDLL(_build.capi_library())
    lib.bs_tensorflow_version.restype = ctypes.c_char_p
    lib.bs_maskgen_new.restype = ctypes.c_void_p
    lib.bs_maskgen_new.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_size_t,
                                   ctypes.c_size_t] + [ctypes.c_void_p] * 5
    lib.bs_maskgen_new_ex.restype = ctypes.c_void_p
    lib.bs_maskgen_new_ex.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_size_t,
                                      ctypes.c_size_t, ctypes.c_char_p] + [ctypes.c_void_p] * 5
    lib.bs_maskgen_process.restype = ctypes.c_bool
    lib.bs_maskgen_process.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    lib.bs_maskgen_delete.argtypes = [ctypes.c_void_p]
    return lib


@pytest.fixture(autouse=True)
def on_cpu(monkeypatch):
    monkeypatch.setenv("BACKSCRUB_TORCH_DEVICE", "cpu")


def _frame(seed, w=W, h=H):
    return np.ascontiguousarray(np.random.default_rng(seed).integers(0, 256, (h, w, 3), np.uint8))


def _process(lib, ctx, frame):
    h, w = frame.shape[:2]
    mask = np.zeros((h, w), np.uint8)
    assert lib.bs_maskgen_process(ctx, frame.ctypes.data, mask.ctypes.data)
    return mask


def _ptr(cb):
    return ctypes.cast(cb, ctypes.c_void_p)


def _invariant(pairs):
    fracs = []
    for a, b in pairs:
        assert a.shape == b.shape and a.dtype == b.dtype == np.uint8
        assert int(np.abs(a.astype(np.int16) - b).max()) <= 1
        fracs.append(float((a != b).mean()))
        assert fracs[-1] <= FRAME_TOL
    assert float(np.mean(fracs)) <= MEAN_TOL


def test_version(lib):
    assert lib.bs_tensorflow_version() == f"torch-{torch.__version__}".encode()


def test_maskgen_lifecycle(lib):
    ctx = lib.bs_maskgen_new(LITE.encode(), 2, W, H, None, None, None, None, None)
    assert ctx
    frame = _frame(0)
    mask = _process(lib, ctx, frame)
    assert mask.max() > 0
    lib.bs_maskgen_delete(ctx)
    np.testing.assert_array_equal(mask, MaskGen(LITE, W, H, device="cpu").process(frame).numpy())


def test_stage_callbacks_fire_in_order_and_match_fused(lib):
    """onprep, oninfer and onmask fire a frame in the reference order
    (``lib/libbackscrub.cc:303,311,363``) when a stage hook is set (the
    staged mode), and the staged masks hold to the fused ones."""
    frames = [_frame(i) for i in range(3)]
    order = []
    hooks = [CB(lambda _c, n=n: order.append(n)) for n in ("prep", "infer", "mask")]
    ctx = lib.bs_maskgen_new(LITE.encode(), 2, W, H, None, *map(_ptr, hooks), None)
    assert ctx
    staged = [_process(lib, ctx, f) for f in frames]
    lib.bs_maskgen_delete(ctx)
    assert order == ["prep", "infer", "mask"] * 3

    ctx = lib.bs_maskgen_new(LITE.encode(), 2, W, H, None, None, None, None, None)
    fused = [_process(lib, ctx, f) for f in frames]
    lib.bs_maskgen_delete(ctx)
    _invariant(list(zip(staged, fused)))
    ref = MaskGen(LITE, W, H, device="cpu", fused=False)
    for f, m in zip(frames, staged):
        np.testing.assert_array_equal(m, ref.process(f).numpy())


def test_onmask_fires_in_fused_mode(lib):
    hits = []
    onmask = CB(lambda _c: hits.append(1))
    ctx = lib.bs_maskgen_new(LITE.encode(), 2, W, H, None, None, None, _ptr(onmask), None)
    assert ctx
    frame = _frame(7)
    _process(lib, ctx, frame)
    _process(lib, ctx, frame)
    lib.bs_maskgen_delete(ctx)
    assert len(hits) == 2


def test_maskgen_new_failure_returns_null(lib):
    msgs = []
    ondebug = DBG(lambda _c, m: msgs.append(m))
    ctx = lib.bs_maskgen_new(b"/no/such/model.tflite", 2, W, H, _ptr(ondebug),
                             None, None, None, None)
    assert not ctx
    assert any(b"not found" in m for m in msgs), msgs
    assert not lib.bs_maskgen_process(None, None, None)
    lib.bs_maskgen_delete(None)


@pytest.mark.parametrize("options,kw", [
    (b"refine:guided,morph:open:3", dict(refine="guided", morph="open:3")),
    (b"u8exact,morph:close", dict(u8_exact_post=True, morph="close")),
    (b"no-bilateral", dict(use_bilateral=False)),
])
def test_new_ex_options_match_python_pipeline_bytes(lib, options, kw):
    """bs_maskgen_new_ex carries the -p options into the pipeline: the C
    path's masks equal the Python MaskGen's with the same settings."""
    ctx = lib.bs_maskgen_new_ex(LITE.encode(), 2, W, H, options, None, None, None, None, None)
    assert ctx
    ref = MaskGen(LITE, W, H, device="cpu", **kw)
    rng = np.random.default_rng(11)
    for _ in range(3):
        f = np.ascontiguousarray(rng.integers(0, 256, (H, W, 3), np.uint8))
        np.testing.assert_array_equal(_process(lib, ctx, f), ref.process(f).numpy())
    lib.bs_maskgen_delete(ctx)


def test_new_ex_unknown_option_fails(lib):
    msgs = []
    ondebug = DBG(lambda _c, m: msgs.append(m))
    ctx = lib.bs_maskgen_new_ex(LITE.encode(), 2, W, H, b"bogus:1", _ptr(ondebug),
                                None, None, None, None)
    assert not ctx
    assert any(b"bogus:1" in m and b"unknown maskgen option" in m for m in msgs), msgs


def test_plain_new_equals_new_ex_empty_options(lib):
    frame = _frame(13)
    masks = []
    for make in (lambda: lib.bs_maskgen_new(LITE.encode(), 2, W, H, None, None, None, None, None),
                 lambda: lib.bs_maskgen_new_ex(LITE.encode(), 2, W, H, b"", None, None, None,
                                               None, None),
                 lambda: lib.bs_maskgen_new_ex(LITE.encode(), 2, W, H, None, None, None, None,
                                               None, None)):
        ctx = make()
        assert ctx
        masks.append(_process(lib, ctx, frame))
        lib.bs_maskgen_delete(ctx)
    np.testing.assert_array_equal(masks[0], masks[1])
    np.testing.assert_array_equal(masks[0], masks[2])


def test_masks_match_jax_maskgen(lib):
    """The C path (fused, the kernels' plain versions) against the JAX
    MaskGen on the CPU (its classic route: the JAX package takes its Pallas
    path only on the TPU or in interpret mode) over the committed model's
    moving sequence at 640x480, the EMA carried."""
    from backscrub_tpu.pipeline.maskgen import MaskGen as JaxMaskGen
    sys.path.insert(0, str(ROOT / "tools"))
    from make_synth_segm import moving_frames
    w, h = 640, 480
    ctx = lib.bs_maskgen_new(LITE.encode(), 2, w, h, None, None, None, None, None)
    assert ctx
    ref = JaxMaskGen(LITE, w, h)
    pairs = [(_process(lib, ctx, np.ascontiguousarray(f)), np.asarray(ref.process(f)))
             for f in moving_frames(w, h, 4)]
    lib.bs_maskgen_delete(ctx)
    _invariant(pairs)


def test_without_cuda_the_default_device_fails(lib, monkeypatch):
    """With BACKSCRUB_TORCH_DEVICE unset the C ABI asks for the card; here,
    with no CUDA, construction returns NULL with the reason on ondebug and
    never runs on the CPU silently.  An unknown device fails the same way."""
    assert not torch.cuda.is_available()
    for value, want in ((None, b"CUDA is not available"), ("bogus", b"BACKSCRUB_TORCH_DEVICE")):
        if value is None:
            monkeypatch.delenv("BACKSCRUB_TORCH_DEVICE")
        else:
            monkeypatch.setenv("BACKSCRUB_TORCH_DEVICE", value)
        msgs = []
        ondebug = DBG(lambda _c, m: msgs.append(m))
        ctx = lib.bs_maskgen_new(LITE.encode(), 2, W, H, _ptr(ondebug), None, None, None, None)
        assert not ctx
        assert any(want in m for m in msgs), msgs


def test_capi_library_builds_into_the_package():
    path = _build.capi_library()
    assert os.path.dirname(path) == _build.BUILD_DIR
    assert os.path.basename(path).startswith("libbs_capi_")
    assert _build.capi_library() == path   # cached by its hash
