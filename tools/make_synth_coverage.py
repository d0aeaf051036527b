"""Write the op-coverage ``.tflite`` fixture and its golden outputs.

``tests/data/ops_synth_coverage.tflite`` is one TF-built graph that holds
every op kind TensorFlow's converter emits from the lowerings no bundled
model family uses: the unary math, the reducers, the comparisons and
logical ops, the shape plumbing (a dynamic batch makes the converter emit
SHAPE -> STRIDED_SLICE -> PACK -> RESHAPE), the space/depth moves,
gathers, mirror and constant pads, the builtin TRANSPOSE_CONV, and a
WHILE and an IF whose subgraphs own weights of their own.  Its outputs
are three tensors, in the order the file lists them: the float results
flattened and concatenated, the integer ones, the bool ones.

``tests/data/ops_synth_coverage.npz`` holds the seeded input (``x``), the
JAX package's executor outputs on the CPU (``jax_0``..``jax_2``, in the
file's output order), TFLite's (``tflite_0``..``tflite_2``) and the WHILE
trip count (``trips``): the
PyTorch port reads both files with its own loader where neither
TensorFlow nor JAX is installed.

Usage (needs TensorFlow and the JAX package)::

    python tools/make_synth_coverage.py tests/data

Run it in a process of its own: TensorFlow names the IF's branch
functions (and so the subgraphs) by a counter of the process, which any
graph traced before moves.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

NAME = "ops_synth_coverage"
IN_SHAPE = (1, 8, 8, 4)
TRIPS = 3


def _weights(seed: int):
    rng = np.random.default_rng(seed)
    f = np.float32
    return dict(
        body_w=(rng.standard_normal((4, 4)) * 0.5).astype(f),
        body_b=(rng.standard_normal((4,)) * 0.1).astype(f),
        then_w=(rng.standard_normal((4,)) * 0.5 + 1.0).astype(f),
        else_b=(rng.standard_normal((4,)) * 0.1).astype(f),
        tconv_w=(rng.standard_normal((3, 3, 2, 4)) * 0.3).astype(f),   # (fh, fw, out, in)
        prelu=(rng.standard_normal((4,)) * 0.2).astype(f),
    )


def build_model(seed: int = 0) -> bytes:
    """The flatbuffer bytes of the coverage graph (deterministic for one
    TensorFlow version)."""
    import tensorflow as tf

    w = _weights(seed)

    def fn(x, px):
        f32 = []                      # float results, flattened at the end
        ints, bools = [], []
        a = tf.abs(x) + 1.0
        # unary math and binary arithmetic
        f32 += [tf.negative(x), tf.exp(x), tf.math.log(a), tf.sqrt(a), tf.math.rsqrt(a),
                tf.square(x), tf.floor(x * 3.0), tf.math.ceil(x * 3.0), tf.round(x * 3.0),
                tf.sin(x), tf.cos(x), tf.nn.elu(x), tf.nn.gelu(x, approximate=True),
                tf.pow(a, x), tf.math.squared_difference(x, 0.5 * a),
                tf.minimum(x, 0.25), tf.maximum(x, -0.25), tf.tanh(x),
                tf.nn.leaky_relu(x, 0.2), tf.clip_by_value(x, -1.0, 1.0),
                px,
                tf.math.floordiv(x * 5.0, 2.0), tf.math.floormod(x * 5.0, -2.0)]
        # reducers, softmaxes, normalization, cumulative sums
        f32 += [tf.reduce_sum(x, [1, 2]), tf.reduce_max(x, [1, 2], keepdims=True),
                tf.reduce_min(x, -1), tf.reduce_prod(a, 1), tf.reduce_mean(x, [1, 2]),
                tf.nn.softmax(x * 1.5), tf.nn.log_softmax(x), tf.nn.l2_normalize(x, -1),
                tf.cumsum(x, axis=2, exclusive=True, reverse=True), tf.cumsum(x, axis=1)]
        # resizes, pads, space/depth moves, gathers, tiles, pooling
        f32 += [tf.image.resize(x, (12, 12), method="nearest"),
                tf.compat.v1.image.resize_nearest_neighbor(x, (5, 7), align_corners=True),
                tf.pad(x, [[0, 0], [2, 1], [1, 2], [0, 0]], mode="REFLECT"),
                tf.pad(x, [[0, 0], [1, 2], [2, 1], [0, 0]], mode="SYMMETRIC"),
                tf.pad(x, [[0, 0], [1, 1], [0, 2], [0, 0]], constant_values=-1.5),
                tf.pad(x, [[0, 0], [1, 0], [0, 1], [0, 0]]),
                tf.nn.depth_to_space(tf.nn.space_to_depth(x, 2) * 2.0, 2),
                tf.batch_to_space(tf.nn.relu(tf.space_to_batch_nd(
                    x, [2, 2], [[1, 1], [2, 0]])), [2, 2], [[1, 1], [2, 0]]),
                tf.gather(x, [3, 0, 2], axis=3), tf.tile(x[:, :2], [1, 2, 1, 3]),
                tf.nn.max_pool2d(x, 3, 2, "SAME"), tf.nn.max_pool2d(x, 2, 2, "VALID"),
                # SAME: with VALID and an output smaller than (in-1)*s + f,
                # TFLite crops from the start and the JAX lowering centres
                tf.nn.conv2d_transpose(x, w["tconv_w"], tf.stack([tf.shape(x)[0], 15, 15, 2]),
                                       2, "SAME")]
        # shape plumbing on the dynamic batch
        flat = tf.reshape(x, tf.stack([tf.shape(x)[0], -1]))
        parts = tf.unstack(x, axis=3)
        halves = tf.split(x, 2, axis=2)
        f32 += [flat, tf.stack(parts[::-1], axis=1), halves[1] - halves[0],
                tf.transpose(x, [0, 3, 1, 2]), tf.slice(x, [0, 1, 2, 0], [-1, 3, 4, 2]),
                x[:, ::2, 1:7:3, ::-1],
                tf.expand_dims(tf.squeeze(
                    tf.reshape(x, tf.stack([tf.shape(x)[0], 1, -1])), 1), -1),
                tf.linalg.matmul(x[0], x[0], transpose_b=True),
                tf.fill([1, 3], tf.reduce_max(x)), tf.zeros_like(flat) + 0.5]
        # integers and bools
        amin = tf.argmin(x, -1, output_type=tf.int32)
        f32 += [tf.one_hot(amin, 4, on_value=2.0, off_value=-1.0)]
        ints += [amin, tf.argmax(x, 1, output_type=tf.int32), tf.cast(x * 4.0, tf.int32)]
        g = tf.greater(x, 0.1)
        bools += [g, tf.greater_equal(x, 0.1), tf.less(x, -0.2), tf.less_equal(x, -0.2),
                  tf.equal(tf.round(x * 2.0), 1.0), tf.not_equal(tf.round(x * 2.0), 0.0),
                  tf.logical_and(g, tf.less(x, 0.8)), tf.logical_or(g, tf.less(x, -0.5)),
                  tf.logical_not(tf.cast(tf.round(x * 2.0), tf.bool))]
        f32 += [tf.raw_ops.Select(condition=g, x=x, y=-x),
                tf.where(tf.less(x[..., :1], 0.0), x, 0.5)]
        # control flow: a WHILE whose body owns a weight matrix and a bias,
        # an IF whose branches own weights
        v = tf.reduce_mean(x, [1, 2])                       # (N, 4)
        _, v = tf.while_loop(
            lambda i, v: i < TRIPS,
            lambda i, v: (i + 1, tf.tanh(tf.linalg.matmul(v, w["body_w"]) + w["body_b"])),
            [tf.constant(0), v])
        v = tf.cond(tf.reduce_sum(x) > 0.0, lambda: v * w["then_w"], lambda: v + w["else_b"])
        f32 += [v]
        out_f = tf.concat([tf.reshape(t, [-1]) for t in f32], 0)
        out_i = tf.concat([tf.reshape(t, [-1]) for t in ints], 0)
        out_b = tf.concat([tf.reshape(t, [-1]) for t in bools], 0)
        return out_f, out_i, out_b

    class Coverage(tf.keras.layers.Layer):
        def call(self, x, px):
            return fn(x, px)

    # a Keras model: the converter emits PRELU for Keras's layer (and for no
    # pattern of plain ops) on a tensor that nothing else reads
    inp = tf.keras.Input(IN_SHAPE[1:], name="x")
    px = tf.keras.layers.Rescaling(1.5, name="prelu_in")(inp)
    px = tf.keras.layers.PReLU(alpha_initializer=tf.constant_initializer(w["prelu"]),
                               shared_axes=[1, 2], name="prelu")(px)
    model = tf.keras.Model(inp, Coverage(name="coverage")(inp, px), name="coverage")
    return tf.lite.TFLiteConverter.from_keras_model(model).convert()


def golden(blob: bytes, seed: int = 0) -> dict:
    """The seeded input, the JAX executor's outputs, TFLite's and the
    WHILE trip count."""
    import tensorflow as tf
    import jax.numpy as jnp
    from backscrub_tpu.graph.executor import build_model as jax_build
    from backscrub_tpu.tflite.loader import load_tflite_bytes

    x = np.random.default_rng(seed + 1).uniform(-1, 1, IN_SHAPE).astype(np.float32)
    g = load_tflite_bytes(blob)
    ys = jax_build(g)(jnp.asarray(x))
    out = {"x": x, "trips": np.asarray(TRIPS, np.int32)}
    for i, y in enumerate(ys):
        out[f"jax_{i}"] = np.asarray(y)
    it = tf.lite.Interpreter(model_content=blob)
    it.allocate_tensors()
    it.set_tensor(it.get_input_details()[0]["index"], x)
    it.invoke()
    for i, idx in enumerate(g.outputs):
        out[f"tflite_{i}"] = it.get_tensor(idx)
    return out


def write(out_dir: str, seed: int = 0) -> tuple:
    blob = build_model(seed)
    path = os.path.join(out_dir, NAME + ".tflite")
    with open(path, "wb") as f:
        f.write(blob)
    npz = os.path.join(out_dir, NAME + ".npz")
    np.savez(npz, **golden(blob, seed))
    return path, npz


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("out_dir")
    ap.add_argument("--seed", type=int, default=0)
    a = ap.parse_args(argv)
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    print(*write(a.out_dir, a.seed))


if __name__ == "__main__":
    main()
