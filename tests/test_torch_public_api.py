"""The port's public surface against the JAX package's: the same names in
``__all__``, each bound to the port's counterpart; importing the package
touches no CUDA, builds no kernel and imports neither JAX, the JAX package
nor OpenCV; ``install_default_search_roots`` adds the source tree's
``models/`` and ``backgrounds/`` where they exist."""

import os
import subprocess
import sys

import pytest

import backscrub_tpu
import backscrub_tpu_torch
from backscrub_tpu_torch import cli, cli_multi
from backscrub_tpu_torch.models import specs


def test_all_names_match_the_jax_package_and_resolve():
    assert set(backscrub_tpu_torch.__all__) == set(backscrub_tpu.__all__)
    assert len(backscrub_tpu_torch.__all__) == len(set(backscrub_tpu_torch.__all__)) == 17
    for name in backscrub_tpu_torch.__all__:
        obj = getattr(backscrub_tpu_torch, name)
        if callable(obj):
            assert obj.__module__.startswith("backscrub_tpu_torch."), name
    from backscrub_tpu_torch.pipeline.frame import FramePipeline
    from backscrub_tpu_torch.pipeline.maskgen import MaskGen
    from backscrub_tpu_torch.runtime.serving import ServingLoop
    assert backscrub_tpu_torch.FramePipeline is FramePipeline
    assert backscrub_tpu_torch.MaskGen is MaskGen and backscrub_tpu_torch.ServingLoop is ServingLoop
    assert backscrub_tpu_torch.bs_tensorflow_version().startswith("torch-")


def test_default_model_and_version_are_the_jax_packages():
    assert backscrub_tpu_torch.DEFAULT_MODEL == backscrub_tpu.DEFAULT_MODEL
    assert backscrub_tpu_torch.__version__ == backscrub_tpu.__version__
    assert cli.parse_args([])["model"] == backscrub_tpu_torch.DEFAULT_MODEL
    assert cli_multi.parse_args(["--stream", "src=test:,sink=null:,geo=64x48"])["model"] == \
        backscrub_tpu_torch.DEFAULT_MODEL


def test_import_loads_no_jax_no_opencv_and_no_cuda():
    code = ("import sys, backscrub_tpu_torch as bt, torch\n"
            "bad = sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'backscrub_tpu', 'cv2', 'tensorflow'})\n"
            "assert not bad, bad\n"
            "assert not torch.cuda.is_initialized()\n"
            "from backscrub_tpu_torch import _build\n"
            "assert _build._Lib.handle is None\n"
            "print(len(bt.__all__))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       env=env, timeout=300)
    assert r.returncode == 0 and r.stdout.strip() == "17", r.stderr[-2000:]


@pytest.mark.parametrize("present", [True, False])
def test_install_default_search_roots(monkeypatch, tmp_path, present):
    root = tmp_path / "tree"
    root.mkdir()
    if present:
        (root / "models").mkdir()
        (root / "backgrounds").mkdir()
    monkeypatch.setattr(specs, "_package_root", lambda: str(root))
    for var in ("BACKSCRUB_TPU_MODELS", "BACKSCRUB_TPU_BACKGROUNDS"):
        monkeypatch.delenv(var, raising=False)
    specs.install_default_search_roots()
    got = [os.environ.get(v) for v in ("BACKSCRUB_TPU_MODELS", "BACKSCRUB_TPU_BACKGROUNDS")]
    assert got == ([str(root / "models"), str(root / "backgrounds")] if present
                   else [None, None])
    monkeypatch.setenv("BACKSCRUB_TPU_MODELS", "/elsewhere")
    specs.install_default_search_roots()
    assert os.environ["BACKSCRUB_TPU_MODELS"] == "/elsewhere"
