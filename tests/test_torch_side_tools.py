"""The port's side tools (``tools/*_torch.py``) against the JAX package's
(``tests/test_tools.py``): the loopback self-test harness over the port's
sinks, the converter with its ``--check`` on the port's executor, and the
transparent viewer's chroma key."""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
if str(ROOT / "tools") not in sys.path:
    sys.path.insert(0, str(ROOT / "tools"))


def test_loopback_selftest_harness(tmp_path):
    """A ``file:`` sink at 64x32 gets 3 YUYV frames, each different, byte
    for byte those that ``tools/loopback_test.py`` writes."""
    outs = {tool: str(tmp_path / f"{tool}.yuv")
            for tool in ("loopback_test_torch.py", "loopback_test.py")}
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    procs = [subprocess.Popen([sys.executable, f"tools/{tool}", f"file:{out}", "64x32", "3"],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              cwd=str(ROOT), env=env)
             for tool, out in outs.items()]
    for p in procs:
        _, err = p.communicate(timeout=120)
        assert p.returncode == 0, err[-400:]
    data = open(outs["loopback_test_torch.py"], "rb").read()
    assert len(data) == 3 * 32 * 128
    f0, f1, f2 = (data[i * 32 * 128:(i + 1) * 32 * 128] for i in range(3))
    assert f0 != f1 != f2
    assert data == open(outs["loopback_test.py"], "rb").read()


def test_convert_keras_model_loads_in_executor(tmp_path, capsys):
    """A Keras net converted by the tool (SavedModel in), its ``--check``
    on the CPU, and the port's output on it against the JAX executor's and
    TFLite's at 1e-4."""
    tf = pytest.importorskip("tensorflow")
    import convert_model_torch
    inp = tf.keras.Input((32, 32, 3))
    x = tf.keras.layers.Conv2D(8, 3, padding="same", activation="relu")(inp)
    x = tf.keras.layers.DepthwiseConv2D(3, padding="same")(x)
    x = tf.keras.layers.Conv2D(4, 1, activation="relu")(x)
    x = tf.keras.layers.UpSampling2D(interpolation="bilinear")(x)
    out = tf.keras.layers.Conv2D(1, 1, activation="sigmoid")(x)
    model = tf.keras.Model(inp, out)
    saved = str(tmp_path / "saved")
    model.export(saved)
    dst = str(tmp_path / "custom_selfie.tflite")
    assert convert_model_torch.main([saved, dst, "--check", "--device", "cpu"]) == 0
    assert "loads OK on cpu: input (1, 32, 32, 3) -> output (1, 64, 64, 1)" in \
        capsys.readouterr().out

    from backscrub_tpu.graph.executor import load_model as jax_load_model
    from backscrub_tpu_torch.graph.executor import load_model
    from conftest import tflite_invoke
    x_in = np.random.default_rng(0).random((1, 32, 32, 3), np.float32)
    with torch.no_grad():
        y = load_model(dst, "cpu")(torch.from_numpy(x_in)).numpy()
    assert y.shape[-3:] == (64, 64, 1)
    np.testing.assert_allclose(y, np.asarray(jax_load_model(dst)(x_in)), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(y, tflite_invoke(dst, x_in), atol=1e-4, rtol=1e-4)


def test_chroma_key_green_matches_jax_tool():
    """Byte-equal BGRA to ``tools/transparent_viewer.py``'s, pure green
    keyed out and nothing else."""
    pytest.importorskip("cv2")
    import transparent_viewer
    import transparent_viewer_torch
    rng = np.random.default_rng(3)
    frame = rng.integers(0, 256, (24, 40, 3), np.uint8)
    frame[::3, ::2] = (0, 255, 0)
    frame[1, :5] = (1, 255, 0)
    got = transparent_viewer_torch.chroma_key_green(frame)
    ref = transparent_viewer.chroma_key_green(frame)
    assert got.dtype == ref.dtype == np.uint8 and got.tobytes() == ref.tobytes()
    assert (got[..., 3] == 0).sum() == (24 // 3) * (40 // 2)
