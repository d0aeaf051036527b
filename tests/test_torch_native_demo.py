"""The pure-C++ consumer (``native/demo.cc`` and ``native/bsio.cc``, as
they are) linked against the port's C ABI, run as its own process with
its own embedded CPython (counterpart of ``tests/test_native_demo.py``,
case for case, on the committed synthetic segm_lite model).

``_build.native_program`` builds it with the host ``c++``; it runs with
the repository and the site-packages on ``PYTHONPATH`` and
``BACKSCRUB_TORCH_DEVICE=cpu``.  Bars: its YUYV byte-equal to the JAX
package's composite of its dumped masks (``alpha_blend_u8``, ``flip``,
``rgb_to_yuyv`` with the reference chroma order over the green screen);
its masks byte-equal to the port's in-process ``MaskGen`` on the same
frames (the same EMA trajectory).
"""

import os
import pathlib
import site
import subprocess

import numpy as np
import pytest

from backscrub_tpu_torch import _build
from backscrub_tpu_torch.pipeline.maskgen import MaskGen
from test_native_demo import make_pattern

ROOT = pathlib.Path(__file__).resolve().parent.parent
LITE = str(ROOT / "tests" / "data" / "segm_synth_lite_96x160.tflite")
W, H, FRAMES = 64, 48, 4
TIMEOUT = 300   # an embedded interpreter's exit must not hang the suite


def _env(device="cpu"):
    env = dict(os.environ, PYTHONPATH=":".join([str(ROOT)] + site.getsitepackages()),
               OMP_NUM_THREADS="2")
    env.pop("BACKSCRUB_TORCH_DEVICE", None)
    if device:
        env["BACKSCRUB_TORCH_DEVICE"] = device
    return env


@pytest.fixture(scope="module")
def demo():
    return _build.native_program()


@pytest.fixture(scope="module")
def demo_run(demo, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("native_demo_torch")
    out, maskdump = str(tmp / "out.yuyv"), str(tmp / "masks.raw")
    r = subprocess.run([demo, "-m", LITE, "--cg", f"{W}x{H}", "-n", str(FRAMES), "-H",
                        "-v", out, "--dump-mask", maskdump],
                       env=_env(), capture_output=True, text=True, timeout=TIMEOUT)
    assert r.returncode == 0, r.stderr[-2000:]
    yuyv, masks = np.fromfile(out, np.uint8), np.fromfile(maskdump, np.uint8)
    assert yuyv.size == FRAMES * H * W * 2 and masks.size == FRAMES * H * W, r.stderr[-2000:]
    return yuyv.reshape(FRAMES, H, 2 * W), masks.reshape(FRAMES, H, W)


def test_native_demo_bit_exact_vs_jax_composite(demo_run):
    from backscrub_tpu.pipeline.image import alpha_blend_u8, flip, rgb_to_yuyv
    yuyv, masks = demo_run
    bg = np.zeros((H, W, 3), np.uint8)
    bg[..., 1] = 255   # the green-screen fallback, BGR
    for n in range(FRAMES):
        comp = np.asarray(flip(np.asarray(alpha_blend_u8(bg, make_pattern(n), masks[n])),
                               horizontal=True))
        want = np.asarray(rgb_to_yuyv(comp, chroma_order="reference")).reshape(H, 2 * W)
        np.testing.assert_array_equal(yuyv[n], want)


def test_native_demo_masks_match_maskgen(demo_run):
    _, masks = demo_run
    mg = MaskGen(LITE, W, H, device="cpu")
    for n in range(FRAMES):
        np.testing.assert_array_equal(masks[n], mg.process(make_pattern(n)).numpy())


def test_native_demo_version(demo):
    r = subprocess.run([demo, "--version"], env=_env(None), capture_output=True, text=True,
                       timeout=TIMEOUT)
    assert r.returncode == 0, r.stderr[-2000:]
    import torch
    assert f"torch-{torch.__version__}" in r.stdout and "bsio" in r.stdout


@pytest.mark.parametrize("device,model,want", [
    ("cpu", "/no/such.tflite", "not found"),
    (None, LITE, "CUDA is not available"),
])
def test_native_demo_fails_cleanly(demo, device, model, want):
    """A bad model, or the default device (the card) where there is no
    CUDA: a nonzero exit, the reason on the debug line, no output."""
    r = subprocess.run([demo, "-m", model, "-n", "1", "-d"], env=_env(device),
                       capture_output=True, text=True, timeout=TIMEOUT)
    assert r.returncode != 0
    assert "bs_maskgen_new failed" in r.stderr and want in r.stderr, r.stderr[-2000:]


def test_native_program_links_the_port_shim(demo):
    assert os.path.dirname(demo) == _build.BUILD_DIR
    assert os.path.basename(demo).startswith("backscrub_native_torch_")
    r = subprocess.run(["ldd", demo], capture_output=True, text=True, timeout=60)
    if r.returncode == 0:
        assert os.path.basename(_build.capi_library()) in r.stdout
