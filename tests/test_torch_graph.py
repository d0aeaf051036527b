"""The PyTorch port's graph executor against the JAX package's
``build_model`` on the same graphs (allclose 1e-4), and the parameter
bridge ``params_from_jax``."""

import pathlib
import sys

import numpy as np
import pytest
import torch

from backscrub_tpu.graph.executor import build_model as jax_build
from backscrub_tpu.graph.executor import load_model as jax_load_model
from backscrub_tpu.tflite.ir import GraphIR, NodeIR, TensorIR
from backscrub_tpu_torch.graph.executor import (build_model, load_model,
                                                params_from_jax, span_fn)

ROOT = pathlib.Path(__file__).resolve().parent.parent
FULL = ROOT / "tests" / "data" / "segm_synth_lite_96x160.tflite"


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    tools = str(ROOT / "tools")
    if tools not in sys.path:
        sys.path.insert(0, tools)
    from make_synth_segm import write_model
    narrow = tmp_path_factory.mktemp("synth") / "segm_synth_narrow_96x160.tflite"
    write_model(str(narrow), width=0.5, depth=4)
    return {"full": str(FULL), "narrow": str(narrow)}


@pytest.mark.parametrize("which", ["full", "narrow"])
def test_compiled_model_matches_jax(models, which):
    jm, tm = jax_load_model(models[which]), load_model(models[which], "cpu")
    assert tm.input_shape == jm.input_shape and tm.output_shape == jm.output_shape
    rng = np.random.default_rng(0)
    for _ in range(2):
        x = rng.random((1, 96, 160, 3), dtype=np.float32)
        ref = np.asarray(jm(x))
        with torch.no_grad():
            got = tm(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("which", ["full", "narrow"])
def test_params_from_jax_equal_own_load(models, which):
    jm, tm = jax_load_model(models[which]), load_model(models[which], "cpu")
    for src in (jm.params, jm.host_params):
        p = params_from_jax(src)
        assert set(p) == set(tm.params)
        for k, v in p.items():
            assert v.dtype == torch.float32
            assert torch.equal(v, tm.params[k]), k
    # and a port model running on the JAX parameters computes the same
    tm.params = params_from_jax(jm.params)
    x = np.random.default_rng(1).random((1, 96, 160, 3), dtype=np.float32)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jm(x)), atol=1e-4, rtol=1e-4)


def _ops_graph():
    """Lowerings the synthetic segm graphs do not reach: SAME and VALID
    non-global average pools, RESHAPE, SUB/DIV, RELU6, a dilated conv,
    a stride-2 5x5 depthwise and a VALID transposed conv."""
    rng = np.random.default_rng(5)
    H, W, C = 8, 10, 4

    def t(i, shape, data=None, dtype=np.float32):
        return TensorIR(i, f"t{i}", tuple(shape), dtype,
                        None if data is None else np.asarray(data, dtype))

    h2, w2 = H // 2, W // 2            # after the SAME 3x3/s2 pool
    ts = [t(0, (1, H, W, C)),
          t(1, (C, 3, 3, C), rng.standard_normal((C, 3, 3, C))),
          t(2, (C,), rng.standard_normal(C)),
          t(3, (1, H, W, C)),                                # dilated conv
          t(4, (1, h2, w2, C)),                              # SAME pool
          t(5, (1, 5, 5, C), rng.standard_normal((1, 5, 5, C))),
          t(6, (C,), rng.standard_normal(C)),
          t(7, (1, -(-h2 // 2), -(-w2 // 2), C)),            # dw 5x5/s2 SAME
          t(8, (1, h2 - 1, w2 - 1, C)),                      # VALID pool 2x2/s1
          t(9, (1, 1, 1, C), rng.random((1, 1, 1, C)) + 0.5),
          t(10, (1, h2 - 1, w2 - 1, C)),                     # SUB
          t(11, (1, h2 - 1, w2 - 1, C)),                     # DIV + RELU6
          t(12, (2, 4, 2, C), rng.standard_normal((2, 4, 2, C))),  # OHWI
          t(13, (2,), rng.standard_normal(2)),
          t(14, (1, 2 * (h2 - 2) + 4, 2 * (w2 - 2) + 2, 2)),  # tconv VALID
          t(15, (4,), [1, -1, 2, 2], np.int32),
          t(16, (1, (2 * (h2 - 2) + 4) * (2 * (w2 - 2) + 2) // 2, 2, 2))]
    pool = dict(padding="SAME", stride_h=2, stride_w=2, filter_h=3, filter_w=3,
                activation="NONE")
    nodes = [
        NodeIR("CONV_2D", [0, 1, 2], [3], dict(padding="SAME", stride_h=1,
                                               stride_w=1, dilation_h=2,
                                               dilation_w=2, activation="RELU")),
        NodeIR("AVERAGE_POOL_2D", [3], [4], pool),
        NodeIR("DEPTHWISE_CONV_2D", [4, 5, 6], [7],
               dict(padding="SAME", stride_h=2, stride_w=2, depth_multiplier=1,
                    activation="NONE")),
        NodeIR("AVERAGE_POOL_2D", [4], [8], dict(pool, padding="VALID", stride_h=1,
                                                 stride_w=1, filter_h=2, filter_w=2)),
        NodeIR("SUB", [8, 9], [10], dict(activation="NONE")),
        NodeIR("DIV", [10, 9], [11], dict(activation="RELU6")),
        NodeIR("CUSTOM", [11, 12, 13], [14],
               dict(padding="VALID", stride_h=2, stride_w=2),
               custom_code="Convolution2DTransposeBias"),
        NodeIR("RESHAPE", [14, 15], [16], {}),
    ]
    return GraphIR("ops", ts, nodes, [0], [16]), (1, H, W, C)


def test_lowerings_match_jax_on_op_graph():
    g, shape = _ops_graph()
    jm = jax_build(g, jit=False)
    g2, _ = _ops_graph()
    tm = build_model(g2)
    x = np.random.default_rng(9).standard_normal(shape).astype(np.float32)
    ref = np.asarray(jm(x))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4)
    # the depthwise branch (not on the output path) through a span runner
    run = span_fn(tm, 0, 3, 0, 7)
    with torch.no_grad():
        dw = run(torch.from_numpy(x)).numpy()
    assert dw.shape == (1, 2, 3, 4)
