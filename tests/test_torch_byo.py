"""A model of the user's own through the port, against the JAX package: the
committed converted U-Net (``tools/make_synth_unet.py``: builtin
TRANSPOSE_CONV, RESIZE_NEAREST_NEIGHBOR, MAX_POOL_2D, LEAKY_RELU, MEAN,
CONCATENATION; f16 weights) and the committed op-coverage graph
(``tools/make_synth_coverage.py``) with its golden outputs.

- The U-Net's path: the fused front (K1's plain version here) and the
  graph executor over the whole body (no body plan: the span after the
  front has no cut that one tensor crosses, as in the JAX package), the
  threshold decode of the "unknown" spec; and the classic path (K5's plain
  version, the executor).  Three moving frames at 640x480, YUYV against
  the JAX fused path (interpret mode) and NV12 against the JAX classic
  path, each port path held by the bars of ``tests/test_torch_selfie.py``:
  EMAs equal or a decode flip at a near-tie (|logit - logit(0.65)| <=
  1e-3), no byte off by more than 1, at most 2% of a frame's bytes, and
  off the post's exact x.5 ties at most 0.2% of the sequence's.
- ``backscrub-torch -m`` on the U-Net against the JAX CLI: the tolerance
  invariant over the raw files; ``MaskGen`` and ``MultiStreamServer`` on
  it against the JAX fused path's steps.
- The first ``Trainer`` step's gradients against ``jax.grad`` of the same
  loss (rtol 1e-4, atol 1e-4 of each tensor's largest gradient); a WHILE
  whose carried values need gradients is refused where ``jax.grad``
  refuses it.
- The coverage graph's committed golden is what the JAX executor gives
  now, and the port gives it within the card's bars (f32 within 1e-5 +
  1e-5·|ref|, integers and bools exactly).
- The card-install guard: in a subprocess whose import hook refuses
  ``jax``, ``tensorflow``, ``flatbuffers`` and ``cv2`` (none is on the
  card's machine), every module of the port, ``chip_smoke`` and the new
  ``_torch`` tools import, and ``chip_smoke.byo_cpu_twin`` runs the
  coverage graph against its golden and the U-Net ``FramePipeline`` for 2
  frames on the CPU.
"""

from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import backscrub_tpu.cli as jcli
from backscrub_tpu.graph.executor import build_model as jax_build
from backscrub_tpu.graph.executor import load_model as jax_load_model
from backscrub_tpu.models.specs import spec_for_model as jax_spec
from backscrub_tpu.pipeline.frame import FramePipeline as JaxPipeline
from backscrub_tpu.pipeline.frame import PipelineConfig as JaxConfig
from backscrub_tpu.tflite.loader import load_tflite as jax_load_tflite
from backscrub_tpu.train import trainer as jtrainer
from backscrub_tpu_torch import cli
from backscrub_tpu_torch.graph.executor import build_model, load_model
from backscrub_tpu_torch.models.specs import spec_for_model
from backscrub_tpu_torch.ops.megakernel import NO_CUT, body_plan_prefix_for
from backscrub_tpu_torch.pipeline.frame import FramePipeline, PipelineConfig
from backscrub_tpu_torch.train.trainer import Trainer

from test_torch_lowerings import Case, X, _while_subgraphs, jir, normal, tir
from test_torch_selfie import _Bars, _yuyv, post_ties

ROOT = pathlib.Path(__file__).resolve().parent.parent
DATA = ROOT / "tests" / "data"
UNET = str(DATA / "unet_synth_256x256.tflite")
COVERAGE = str(DATA / "ops_synth_coverage.tflite")
GOLDEN = str(DATA / "ops_synth_coverage.npz")
W, H, N = 640, 480, 3
BG = np.random.default_rng(5).integers(0, 256, (H, W, 3), np.uint8)


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _frames(n=N, w=W, h=H):
    tools = str(ROOT / "tools")
    if tools not in sys.path:
        sys.path.insert(0, tools)
    from make_synth_segm import moving_frames
    return moving_frames(w, h, n)


def _nv12(pixels):
    """A frame's pixels (H, W) as its NV12 bytes (3H/2, W)."""
    h, w = pixels.shape
    uv = pixels.reshape(h // 2, 2, w // 2, 2).any(3).any(1)
    return np.concatenate([pixels, np.repeat(uv, 2, axis=1)])


def test_unet_structure_and_path():
    """The converted U-Net: the kinds TF's converter writes for it, the
    "unknown" spec, K1's front detected, no tail, and no body plan (the
    prefix span has no single-tensor cut: the executor runs the body)."""
    m = load_model(UNET, "cpu")
    assert m.input_shape == (1, 256, 256, 3) and m.output_shape == (1, 256, 256, 1)
    assert os.path.getsize(UNET) <= 1_500_000
    kinds = m.graph.op_histogram()
    assert kinds == {"CONV_2D": 10, "LEAKY_RELU": 3, "MAX_POOL_2D": 1, "MEAN": 1,
                     "LOGISTIC": 2, "MUL": 1, "TRANSPOSE_CONV": 2, "CONCATENATION": 3,
                     "RESIZE_NEAREST_NEIGHBOR": 2}, kinds
    spec = spec_for_model(UNET)
    assert (spec.kind, spec.decode, spec.threshold) == ("unknown", "threshold", 0.65)
    p = FramePipeline(UNET, PipelineConfig(width=W, height=H), device="cpu")
    e = p.maskgen.edge
    assert e is not None and e.info.front_ok and not e.info.tail_ok
    assert e.info.front_activation == "RELU6" and e.plans == [] and e.rest is not None
    assert body_plan_prefix_for(m, e.info) is NO_CUT


def _port_margin(mg, frame):
    """The port's decode margin a pixel: logit(p) - logit(0.65), float64,
    of the path's own model output (``mg`` a MaskGen)."""
    with torch.no_grad():
        if mg.edge is not None:
            e = mg.edge
            out = e.body(e.front(torch.from_numpy(frame))).permute(1, 2, 0)
        else:
            out = mg._infer(mg._pre(torch.from_numpy(frame)))
    p = out[..., 0].double().numpy()
    return np.log(p / (1 - p)) - np.log(0.65 / 0.35)


def _jax_steps(ref, frames):
    """The JAX pipeline's (output, mask, EMA) a frame, over BG."""
    steps = []
    for f in frames:
        jy, jm = (np.asarray(v) for v in ref.step(f, BG))
        steps.append((jy, jm, np.asarray(ref.maskgen.ema)))
    return steps


@pytest.fixture(scope="module")
def jax_fused_yuyv():
    """The JAX fused path (interpret mode) with YUYV out on the N moving
    frames at 640x480, run once for the module."""
    ref = JaxPipeline(UNET, JaxConfig(width=W, height=H, edge_fused=True,
                                      edge_interpret=True, pack_interpret=True))
    assert ref.maskgen.edge is not None and ref.maskgen.edge.mega is None
    return _jax_steps(ref, _frames())


@pytest.mark.parametrize("fmt", ["yuyv", "nv12"])
def test_unet_pipeline_matches_jax(fmt, request):
    """The U-Net through the port's FramePipeline, fused and classic, with
    ``fmt`` out, against the JAX fused path in interpret mode (YUYV) or
    the JAX classic path (NV12), three frames at 640x480."""
    frames = _frames()
    if fmt == "yuyv":
        steps = request.getfixturevalue("jax_fused_yuyv")
    else:
        steps = _jax_steps(JaxPipeline(UNET, JaxConfig(width=W, height=H, edge_fused=False,
                                                       fused_pack=False, output_format="nv12")),
                           frames)
    ports = {k: FramePipeline(UNET, PipelineConfig(width=W, height=H, edge_fused=fused,
                                                   output_format=fmt), device="cpu")
             for k, fused in (("fused", None), ("classic", False))}
    assert ports["fused"].maskgen.edge is not None and ports["classic"].maskgen.edge is None
    bars = {k: _Bars((256, 256)) for k in ports}
    person = []
    for f, (jy, jm, jema) in zip(frames, steps):
        ties = post_ties(jema, ports["fused"].geo)
        for k, p in ports.items():
            y, m = (v.numpy() for v in p.step(f, BG))
            bars[k].ema(p.maskgen.ema.numpy(), jema, _port_margin(p.maskgen, f))
            bars[k].bytes([((m, jm), ties),
                           ((y, jy), _yuyv(ties) if fmt == "yuyv" else _nv12(ties))])
        r = ports["fused"].geo.roi
        person.append(float((jm[r.y:r.y + r.h, r.x:r.x + r.w] < 128).mean()))
    for b in bars.values():
        b.check()
    assert all(0.1 <= q <= 0.9 for q in person), person


def test_unet_serves_through_maskgen_and_multistream_server(jax_fused_yuyv):
    """The same model through ``MaskGen`` and ``MultiStreamServer`` (two
    streams in one stream batch: the three frames, and the first two of
    them), held to the JAX fused path's steps as the FramePipeline above:
    MaskGen's EMAs by the decode flip rule and its masks, each stream's
    YUYV, by the tolerance invariant."""
    from backscrub_tpu_torch.parallel.streams import MultiStreamPipeline
    from backscrub_tpu_torch.pipeline.maskgen import MaskGen
    from backscrub_tpu_torch.runtime.multistream import MultiStreamServer
    frames = _frames()
    mg = MaskGen(UNET, W, H, device="cpu")
    assert mg.edge is not None and mg.edge.plans == []
    ties = [post_ties(jema, mg.geo) for _, _, jema in jax_fused_yuyv]
    bars = _Bars((256, 256))
    for f, (_, jm, jema), t in zip(frames, jax_fused_yuyv, ties):
        m = mg.process(f).numpy()
        bars.ema(mg.ema.numpy(), jema, _port_margin(mg, f))
        bars.bytes([((m, jm), t)])
    bars.check()
    streams = [frames, frames[:2]]
    got = [[], []]
    seqs = [iter(s) for s in streams]
    server = MultiStreamServer(MultiStreamPipeline(UNET, PipelineConfig(width=W, height=H), 2,
                                                   device="cpu"),
                               [lambda it=it: next(it, None) for it in seqs],
                               [g.append for g in got], backgrounds=np.stack([BG, BG]))
    assert server.run() == len(frames)
    for s in range(2):
        assert len(got[s]) == len(streams[s])
        b = _Bars((256, 256))
        for out, (jy, _, _), t in zip(got[s], jax_fused_yuyv, ties):
            b.bytes([((out, jy), _yuyv(t))])
        b.check()


def test_unet_cli_matches_jax_cli(tmp_path):
    """``backscrub-torch -m <unet>`` and the JAX CLI on the same argv: raw
    YUYV files of equal size under the tolerance invariant."""
    cw, ch, n = 128, 96, 4
    argv = ["-c", "test:", "--cg", f"{cw}x{ch}", "-m", UNET, "--frames", str(n)]
    assert jcli.main(argv + ["-v", f"file:{tmp_path / 'j.yuv'}"]) == 0
    assert cli.main(argv + ["-v", f"file:{tmp_path / 't.yuv'}"], device="cpu") == 0
    j = np.fromfile(tmp_path / "j.yuv", np.uint8)
    t = np.fromfile(tmp_path / "t.yuv", np.uint8)
    assert t.size == j.size == n * cw * ch * 2
    assert int(np.abs(t.astype(np.int16) - j).max()) <= 1
    fracs = (t != j).reshape(n, -1).mean(axis=1)
    assert fracs.max() <= 0.02 and fracs.mean() <= 0.002, fracs


def test_unet_first_step_gradients_match_jax():
    """Autograd through the U-Net's lowerings (TRANSPOSE_CONV, MAX_POOL_2D,
    LEAKY_RELU, MEAN, the nearest resize, the concats) against jax.grad of
    the threshold loss, every parameter."""
    jm, tm = jax_load_model(UNET), load_model(UNET, "cpu")
    rng = np.random.default_rng(3)
    x = rng.random((1, 256, 256, 3), dtype=np.float32)
    yy, xx = np.mgrid[:256, :256]
    y = (np.exp(-(((yy - 140) / 60.0) ** 2 + ((xx - 128) / 50.0) ** 2)) > 0.5)[None]
    y = y.astype(np.float32)
    jloss = jtrainer.segmentation_loss(jax_spec(UNET))
    params = {k: jnp.asarray(np.asarray(v, np.float32)) for k, v in jm.params.items()}
    # jitted with constants evaluated while tracing: the JAX MAX_POOL_2D's
    # -inf init value is then a constant and lax.reduce_window takes its max
    # form, which has a reverse-mode rule.  Traced as the JAX Trainer traces
    # it, the init is no constant and the generic form has none: the JAX
    # Trainer cannot train this model
    with jax.ensure_compile_time_eval():
        jgrads = jax.jit(jax.grad(lambda p: jloss(
            jm.raw_fn(p, jnp.asarray(x)).astype(jnp.float32), jnp.asarray(y))))(params)
    tr = Trainer(tm, spec_for_model(UNET))
    tr.loss_fn(tm.raw_fn(tr.params, torch.from_numpy(x)), torch.from_numpy(y)).backward()
    assert set(jgrads) == set(tr.params)
    for k, g in jgrads.items():
        g = np.asarray(g)
        got = tr.params[k].grad
        assert got is not None, k
        np.testing.assert_allclose(got.numpy(), g, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(g).max()), err_msg=k)


def test_while_on_the_gradient_path_is_refused_as_jax():
    """A WHILE whose body owns a weight: jax.grad refuses reverse-mode
    differentiation of the while loop, and the port's WHILE raises
    ValueError naming the node (through raw_fn and through the Trainer);
    without gradients both run."""
    case = Case("WHILE", [X(np.asarray([0], np.int32)), X(normal("wv", (1, 4)))],
                {"cond_subgraph": 1, "body_subgraph": 2}, out=(np.int32, np.float32),
                n_out=2, subs=_while_subgraphs)
    i0, v0 = case.inputs()
    jm = jax_build(case.graph(jir))
    tm = build_model(case.graph(tir))
    params = {k: jnp.asarray(np.asarray(v, np.float32)) if np.asarray(v).dtype.kind == "f"
              else jnp.asarray(v) for k, v in jm.params.items()}
    floats = {k: v for k, v in params.items() if v.dtype == jnp.float32}
    with pytest.raises(ValueError, match="while_loop"):
        jax.grad(lambda f: jnp.sum(jm.raw_fn(dict(params, **f),
                                             (jnp.asarray(i0), jnp.asarray(v0)))[1]))(floats)
    grad_params = {k: v.clone().requires_grad_(v.is_floating_point())
                   for k, v in tm.params.items()}
    with pytest.raises(ValueError, match="WHILE node"):
        tm.raw_fn(grad_params, (torch.from_numpy(i0), torch.from_numpy(v0)))
    with torch.no_grad():
        got = tm.raw_fn(grad_params, (torch.from_numpy(i0), torch.from_numpy(v0)))
    ref = jm(tuple(jnp.asarray(a) for a in (i0, v0)))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]), rtol=1e-6, atol=1e-6)
    # the Trainer's step meets the same refusal
    spec = spec_for_model("while.tflite")
    tr = Trainer(tm, spec)
    with pytest.raises(ValueError, match="WHILE node"):
        tr.loss_fn(tm.raw_fn(tr.params, (torch.from_numpy(i0), torch.from_numpy(v0)))[1],
                   torch.zeros(1))


def _golden_holds(ys, gold):
    for i, y in enumerate(ys):
        ref = gold[f"jax_{i}"]
        assert y.dtype == ref.dtype and y.shape == ref.shape, (i, y.dtype, ref.dtype)
        if ref.dtype.kind == "f":
            assert (np.abs(y - ref) <= 1e-5 + 1e-5 * np.abs(ref)).all(), i
        else:
            np.testing.assert_array_equal(y, ref)


def test_coverage_golden_is_the_jax_executor_now():
    """The committed golden equals the JAX executor's output on the
    committed graph today, TFLite's beside it within 1e-5, and the port
    holds it at the card's bars with the WHILE taken ``trips`` times."""
    from backscrub_tpu_torch.ops.control_flow import while_op
    gold = np.load(GOLDEN)
    x = gold["x"]
    ys = jax_build(jax_load_tflite(COVERAGE))(jnp.asarray(x))
    assert len(ys) == 3
    for i, y in enumerate(ys):
        np.testing.assert_array_equal(np.asarray(y), gold[f"jax_{i}"])
        np.testing.assert_allclose(gold[f"tflite_{i}"].astype(np.float64),
                                   gold[f"jax_{i}"].astype(np.float64), rtol=1e-5, atol=1e-5)
    m = load_model(COVERAGE, "cpu")
    while_op.iterations = 0
    with torch.no_grad():
        got = [v.numpy() for v in m(torch.from_numpy(x))]
    assert while_op.iterations == int(gold["trips"]) == 3
    _golden_holds(got, gold)


def test_card_install_guard(tmp_path):
    """Nothing the card runs needs a package the card lacks."""
    script = tmp_path / "guard.py"
    script.write_text(f'''
import importlib, importlib.abc, pkgutil, sys
REFUSED = ("jax", "jaxlib", "tensorflow", "flatbuffers", "cv2", "backscrub_tpu")

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in REFUSED:
            raise ImportError(f"{{name}} is not installed on the card's machine")
        return None

sys.meta_path.insert(0, Refuse())
sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / "tools")!r}]
import backscrub_tpu_torch
names = [m.name for m in pkgutil.walk_packages(backscrub_tpu_torch.__path__,
                                                "backscrub_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke, loopback_test_torch, transparent_viewer_torch, convert_model_torch
print("imported", len(names))
import json
print("twin", json.dumps(chip_smoke.byo_cpu_twin(frames=2)))
''')
    env = dict(os.environ, PYTHONPATH="", OMP_NUM_THREADS="2")
    r = subprocess.run([sys.executable, str(script)], capture_output=True, text=True,
                       timeout=300, cwd=str(tmp_path), env=env)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
    lines = r.stdout.splitlines()
    assert lines[0].startswith("imported ") and int(lines[0].split()[1]) > 40
    twin = json.loads(lines[-1].split(" ", 1)[1])
    assert twin["trips"] == 3 and twin["frames"] == 2 and 0.0 < twin["person"] < 1.0
