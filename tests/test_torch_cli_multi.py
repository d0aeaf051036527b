"""The port's multi-camera CLI (``backscrub_tpu_torch/cli_multi.py``) on
the CPU: its flags and stream specs parse as the JAX package's do; a
headless run of streams in two geometries and two models writes to each
``file:`` sink exactly ``--frames`` frames, byte-equal to direct batched
steps of its bucket; ``--data-axis`` parses as the JAX CLI's; a run
without a card fails cleanly."""

import pathlib

import numpy as np
import pytest
import torch

from backscrub_tpu import cli_multi as jax_cli_multi
from backscrub_tpu_torch import cli_multi
from backscrub_tpu_torch.io.streams import SyntheticSource
from backscrub_tpu_torch.parallel.streams import MultiStreamPipeline
from backscrub_tpu_torch.pipeline.frame import PipelineConfig

ROOT = pathlib.Path(__file__).resolve().parent.parent
LITE = str(ROOT / "tests" / "data" / "segm_synth_lite_96x160.tflite")
MLKIT = str(ROOT / "tests" / "data" / "selfie_synth_mlkit_256x256.tflite")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: the suite's parallel workers then do not
    oversubscribe the cores (each worker's default is every core)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("argv", [
    ["--stream", "src=test:,sink=null:,geo=64x48"],
    ["-m", "x.tflite", "-b", "bg.png", "-d", "-d", "--frames", "7", "--threaded",
     "--depth", "3", "--bf16", "--stall-timeout", "2.5",
     "--stream", "src=/dev/video0,sink=/dev/video2,geo=1280x720",
     "--stream", "src=mjpg:,sink=file:/tmp/b.yuv,geo=640x480,bg=b.jpg,model=m.tflite"],
    ["-?"],
])
def test_parse_matches_jax(argv):
    assert cli_multi.parse_args(argv) == jax_cli_multi.parse_args(argv)


@pytest.mark.parametrize("argv,msg", [
    ([], "at least one --stream"),
    (["--stream", "src=test:,geo=64x48"], "missing 'sink'"),
    (["--stream", "src=test:,sink=null:,geo=64"], "bad geo"),
    (["--stream", "src=test:,sink=null:,geo=64x48,fps=30"], "unknown stream spec key"),
    (["--stream", "src=test:,sink=null:,geo=64x48", "--bogus"], "unknown argument"),
    (["--stream", "src"], "not key=value"),
    (["--frames"], "missing value"),
])
def test_parse_refuses_what_jax_refuses(argv, msg):
    with pytest.raises(ValueError, match=msg):
        cli_multi.parse_args(argv)
    with pytest.raises(ValueError):
        jax_cli_multi.parse_args(argv)


def test_data_axis_parses_as_jax(capsys):
    """``--data-axis`` is served, no longer refused: it parses as the JAX
    CLI's, and a data axis of 1 serves on one device with the mesh shape
    on the debug line (``tests/test_torch_mesh.py`` serves 2 over a gloo
    world)."""
    argv = ["--data-axis", "2", "--stream", "src=test:,sink=null:,geo=64x48"]
    assert cli_multi.parse_args(argv) == jax_cli_multi.parse_args(argv)
    assert cli_multi.parse_args(argv)["data_axis"] == 2
    one = ["-m", LITE, "-d", "--frames", "1", "--data-axis", "1"] + argv[2:]
    assert cli_multi.main(one, device="cpu") == 0
    assert "mesh {'data': 1, 'model': 1}" in capsys.readouterr().err


def _direct(path, w, h, n, frames):
    """Direct batched steps of a bucket of ``n`` ``test:`` streams."""
    ms = MultiStreamPipeline(path, PipelineConfig(width=w, height=h), n, device="cpu")
    srcs = [SyntheticSource(w, h) for _ in range(n)]
    outs = [[] for _ in range(n)]
    for _ in range(frames):
        out, _ = ms.step(np.stack([s.read() for s in srcs]))
        for s in range(n):
            outs[s].append(out[s].numpy().tobytes())
    return [b"".join(o) for o in outs]


def test_headless_two_geometries_match_direct_steps(tmp_path):
    frames = 3
    specs = [("a", "160x120", None), ("b", "64x48", None), ("c", "160x120", None),
             ("d", "64x48", MLKIT)]
    argv = ["-m", LITE, "--frames", str(frames)]
    for name, geo, model in specs:
        argv += ["--stream", f"src=test:,sink=file:{tmp_path / name}.yuv,geo={geo}"
                 + (f",model={model}" if model else "")]
    assert cli_multi.main(argv, device="cpu") == 0
    got = {name: (tmp_path / f"{name}.yuv").read_bytes() for name, _, _ in specs}
    a, c = _direct(LITE, 160, 120, 2, frames)
    (b,) = _direct(LITE, 64, 48, 1, frames)
    (d,) = _direct(MLKIT, 64, 48, 1, frames)
    assert len(got["a"]) == frames * 120 * 2 * 160 and len(got["b"]) == frames * 48 * 2 * 64
    assert (got["a"], got["b"], got["c"], got["d"]) == (a, b, c, d)


def test_without_a_card_it_fails_cleanly(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli_multi.main(["--stream", "src=test:,sink=null:,geo=64x48"]) == 1
    assert "CUDA is not available" in capsys.readouterr().err


def test_missing_model_fails_cleanly(capsys):
    argv = ["-m", "no_such_model.tflite", "--stream", "src=test:,sink=null:,geo=64x48"]
    assert cli_multi.main(argv, device="cpu") == 1
    assert "Error" in capsys.readouterr().err
