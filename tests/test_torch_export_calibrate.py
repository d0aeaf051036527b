"""The PyTorch port's export back to ``.tflite`` (``tflite/export.py``),
its weight metadata (``graph/executor.py``) and activation calibration
(``quant/calibrate.py``) against the JAX package's, on the committed
synthetic segm_lite and mlkit models (both f16 files whose weights sit
behind DEQUANTIZE nodes, so every payload is reached through a folded
alias).

Bars: an unmodified export byte-equal to its source; an export of
changed parameters byte-equal to the JAX ``export_params_to_tflite``
output for the same parameters (which reads the file through TF's
flatbuffer schema), and read back by the port's loader as the f16-rounded
parameters; an int8 model's export byte-equal to the JAX one's;
calibration ranges on the same tensor indices, each bound within 1e-5
of the JAX one relative to that tensor's largest magnitude.
"""

import copy
import functools
import pathlib

import numpy as np
import pytest
import torch

from backscrub_tpu.graph.executor import load_model as jax_load_model
from backscrub_tpu.quant.calibrate import calibrate as jax_calibrate
from backscrub_tpu.tflite.export import export_params_to_tflite as jax_export
from backscrub_tpu_torch.graph.executor import build_model, load_model
from backscrub_tpu_torch.quant.calibrate import calibrate, report
from backscrub_tpu_torch.tflite.export import export_params_to_tflite
from backscrub_tpu_torch.tflite.loader import load_tflite, subgraph_count

ROOT = pathlib.Path(__file__).resolve().parent.parent
MODELS = {"segm_lite": str(ROOT / "tests" / "data" / "segm_synth_lite_96x160.tflite"),
          "mlkit": str(ROOT / "tests" / "data" / "selfie_synth_mlkit_256x256.tflite")}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the test run shares a few cores between six
    processes, where torch's default pool (a thread a core) stalls."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _models(name):
    path = MODELS[name]
    return path, jax_load_model(path), load_model(path, "cpu")


@pytest.fixture(scope="module", params=list(MODELS))
def pair(request):
    return _models(request.param)


def _tuned(params, seed):
    """Parameters as a fine-tuning would leave them: each moved by seeded
    noise of 1% of its scale, in f32."""
    rng = np.random.default_rng(seed)
    return {k: (np.asarray(v, np.float32)
                + np.float32(0.01) * np.float32(np.abs(np.asarray(v, np.float32)).max())
                * rng.standard_normal(np.shape(v)).astype(np.float32))
            for k, v in params.items()}


def test_weight_meta_matches_jax(pair):
    """Every prepared key in the JAX executor's order, with its tensor
    index, payload dtype (f16) and an inverse exactly where the JAX
    lowering has one; each inverse undoes its layout on the file's
    payload."""
    path, jm, tm = pair
    assert list(tm.weight_meta) == list(jm.weight_meta)
    raw = load_tflite(path)
    for k, meta in tm.weight_meta.items():
        ref = jm.weight_meta[k]
        assert (meta["tensor_index"], meta["dtype"]) == (ref["tensor_index"], ref["dtype"])
        assert (meta["inverse"] is None) == (ref["inverse"] is None), k
        if meta["inverse"] is not None:
            idx = tm.graph.aliases.get(meta["tensor_index"], meta["tensor_index"])
            payload = raw.tensor(idx).data
            np.testing.assert_array_equal(meta["inverse"](tm.host_params[k]),
                                          payload.astype(np.float32))


def test_loader_records_buffer_spans(pair):
    """Each stored tensor's span in the file holds its payload."""
    path, _, _ = pair
    buf = pathlib.Path(path).read_bytes()
    g = load_tflite(path)
    assert subgraph_count(buf) == 1
    stored = [t for t in g.tensors if t.buffer_offset is not None]
    assert len(stored) > 50
    for t in stored:
        raw = np.frombuffer(buf[t.buffer_offset:t.buffer_offset + t.buffer_size],
                            t.data.dtype)
        np.testing.assert_array_equal(raw, t.data.reshape(-1))
    assert all(t.buffer_size == 0 for t in g.tensors if t.buffer_offset is None)


def test_unmodified_export_is_byte_equal(pair, tmp_path):
    path, _, tm = pair
    out = tmp_path / "same.tflite"
    n = export_params_to_tflite(path, tm, tm.params, str(out))
    assert n == len(tm.weight_meta)
    assert out.read_bytes() == pathlib.Path(path).read_bytes()


def test_tuned_export_matches_jax(pair, tmp_path):
    """Changed parameters: the port's export byte-equal to the JAX
    package's for the same values, read back by the port's loader as the
    values rounded to the file's f16."""
    path, jm, tm = pair
    params = _tuned(jm.params, 11)
    ours, theirs = tmp_path / "port.tflite", tmp_path / "jax.tflite"
    n = export_params_to_tflite(path, tm, {k: torch.from_numpy(v) for k, v in params.items()},
                                str(ours))
    assert n == jax_export(path, jm, params, str(theirs)) == len(tm.weight_meta)
    assert ours.read_bytes() == theirs.read_bytes()
    assert ours.read_bytes() != pathlib.Path(path).read_bytes()
    back = load_model(str(ours), "cpu")
    for k, v in params.items():
        np.testing.assert_array_equal(back.params[k].numpy(),
                                      v.astype(np.float16).astype(np.float32), err_msg=k)


def test_int8_export_matches_jax(tmp_path):
    """An int8 model's export writes its kernels dequantized (int8 x
    scale, cast to the file's f16), byte-equal to the JAX package's, and
    close to the source file's weights."""
    path = MODELS["segm_lite"]
    jm, tm = jax_load_model(path, quantize="int8"), load_model(path, "cpu", quantize="int8")
    assert any(v.dtype == torch.int8 for v in tm.params.values())
    ours, theirs = tmp_path / "port.tflite", tmp_path / "jax.tflite"
    n = export_params_to_tflite(path, tm, tm.params, str(ours))
    assert n == jax_export(path, jm, {k: np.asarray(v) for k, v in jm.params.items()},
                           str(theirs))
    assert ours.read_bytes() == theirs.read_bytes()
    src, back = load_model(path, "cpu"), load_model(str(ours), "cpu")
    for k, v in src.params.items():
        w = v.numpy()
        assert np.abs(back.params[k].numpy() - w).max() <= np.abs(w).max() / 127 + 1e-3, k


def test_export_refuses_size_mismatch(tmp_path):
    path = MODELS["segm_lite"]
    tm = load_model(path, "cpu")
    k = next(k for k, m in tm.weight_meta.items() if m["inverse"] is None)
    bad = dict(tm.params, **{k: torch.zeros(tm.params[k].numel() + 1)})
    with pytest.raises(ValueError, match="payload"):
        export_params_to_tflite(path, tm, bad, str(tmp_path / "bad.tflite"))


def test_export_refuses_several_subgraphs(tmp_path):
    """A file with several subgraphs (the committed coverage model: a WHILE
    and an IF whose subgraphs own weights) exports every parameter into
    the subgraph its ``weight_meta`` names, byte-equal to the JAX export
    of the same changed parameters, and loads back as those parameters in
    the file's dtypes.  (The export refused such files until the port
    loaded subgraphs; the test keeps its name.)"""
    pytest.importorskip("tensorflow")
    path = str(ROOT / "tests" / "data" / "ops_synth_coverage.tflite")
    jm, tm = jax_load_model(path), load_model(path, "cpu")
    assert len(tm.graph.subgraphs) == 5
    assert {k: (m["tensor_index"], m["subgraph"], m["dtype"]) for k, m in tm.weight_meta.items()} \
        == {k: (m["tensor_index"], m["subgraph"], m["dtype"]) for k, m in jm.weight_meta.items()}
    subs = {m["subgraph"] for m in tm.weight_meta.values()}
    assert {0, 2, 3, 4} <= subs, subs
    floats = {k: v for k, v in tm.host_params.items() if v.dtype == np.float32}
    tuned = dict(tm.host_params, **_tuned(floats, 6))
    ours, theirs = tmp_path / "port.tflite", tmp_path / "jax.tflite"
    n = export_params_to_tflite(path, tm, {k: torch.from_numpy(v) for k, v in tuned.items()},
                                str(ours))
    assert n == jax_export(path, jm, tuned, str(theirs)) == len(tm.weight_meta)
    assert ours.read_bytes() == theirs.read_bytes() != pathlib.Path(path).read_bytes()
    back = load_model(str(ours), "cpu")
    for k, v in tuned.items():
        np.testing.assert_array_equal(back.params[k].numpy(), v.astype(v.dtype), err_msg=k)


def test_calibration_matches_jax():
    """Ranges over a seeded sample on the same tensor indices as the JAX
    calibration (segm_lite; the JAX side runs op by op, so one sample),
    each bound within 1e-5 of the JAX one relative to the tensor's largest
    magnitude; a second sample widens them (aggregation)."""
    _, jm, tm = _models("segm_lite")
    rng = np.random.default_rng(12)
    samples = [rng.random(tm.input_shape, dtype=np.float32) for _ in range(2)]
    got = calibrate(tm.graph, tm.params, samples[:1])
    ref = jax_calibrate(jm.graph, jm.params, samples[:1])
    assert set(got) == set(ref) and len(got) > 50
    for i, r in ref.items():
        g = got[i]
        assert (g.name, g.shape) == (r.name, r.shape)
        np.testing.assert_allclose([g.lo, g.hi], [r.lo, r.hi], rtol=1e-5,
                                   atol=1e-5 * max(r.absmax, 1e-30))
    both = calibrate(tm.graph, tm.params, samples)
    assert all(both[i].lo <= g.lo and both[i].hi >= g.hi for i, g in got.items())
    assert any(both[i].lo < g.lo or both[i].hi > g.hi for i, g in got.items())
    assert "activations calibrated" in report(both)
