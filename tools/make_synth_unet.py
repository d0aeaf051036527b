"""Write a converted U-Net from a seed: a model of the user's own, in the
shape a bring-your-own segmentation network takes.

``tests/data/unet_synth_256x256.tflite`` is a Keras U-Net converted by
TensorFlow's own TFLite converter (builtin ops only, f16 weights behind
DEQUANTIZE nodes), where the bundled families are written op by op:

- input 1x256x256x3 f32 (x/255), output 1x256x256x1 person probability;
- node 0 a 3x3 stride-2 SAME CONV_2D from 3 channels to 16 with RELU6
  fused, so the fused path takes it as its front (K1);
- an encoder of widths 16/32/64/128: strided convolutions, a
  MAX_POOL_2D, LEAKY_RELU activations, and a squeeze-excite block on the
  128-wide bottleneck (MEAN -> 1x1 CONV_2D -> RELU -> 1x1 CONV_2D ->
  LOGISTIC -> MUL);
- a decoder of builtin TRANSPOSE_CONV (3x3/s2) and
  RESIZE_NEAREST_NEIGHBOR (2x) upsamplings, each joined to its encoder
  skip by CONCATENATION and a 3x3 conv;
- a one-channel 1x1 CONV_2D head and a LOGISTIC.

Its name holds none of the family keys of ``models/specs.py``, so it takes
the "unknown" spec: x/255 in, the threshold decode at 0.65.  The head's
bias is calibrated so that frame 0 of ``make_synth_segm.moving_frames``
puts the median output logit over the model-output ROI at logit(0.65)
(through the PyTorch port's classic preprocess and graph executor on the
CPU), so that its mask mixes person and background.  Every layer is named,
so that the converter writes the same bytes for the same seed and
TensorFlow version.

Usage (needs TensorFlow)::

    python tools/make_synth_unet.py tests/data/unet_synth_256x256.tflite
"""

from __future__ import annotations

import argparse
import math
import os
import sys

import numpy as np

IN_H = IN_W = 256
THRESHOLD = 0.65
LEAK = 0.1


def _keras_unet(tf):
    L = tf.keras.layers

    def conv(x, n, name, stride=1, act=None, k=3):
        return L.Conv2D(n, k, strides=stride, padding="same", activation=act, name=name)(x)

    def leaky(x, name):
        return L.LeakyReLU(negative_slope=LEAK, name=name)(x)

    def up2(x, name):
        # tf.image.resize converts to RESIZE_NEAREST_NEIGHBOR (UpSampling2D
        # to RESHAPE and TILE)
        h, w = x.shape[1:3]
        return L.Lambda(lambda t: tf.image.resize(t, (2 * h, 2 * w), method="nearest"),
                        name=name)(x)

    inp = tf.keras.Input((IN_H, IN_W, 3), batch_size=1, name="input")
    s0 = conv(inp, 16, "stem", 2, "relu6")                              # 128x128x16
    e1 = leaky(conv(s0, 32, "enc1", 2), "enc1_act")                      # 64x64x32
    e2 = L.MaxPooling2D(2, name="enc2_pool")(e1)                         # 32x32x32
    e2 = leaky(conv(e2, 64, "enc2"), "enc2_act")                         # 32x32x64
    e3 = leaky(conv(e2, 128, "enc3", 2), "enc3_act")                     # 16x16x128
    se = L.GlobalAveragePooling2D(keepdims=True, name="se_mean")(e3)
    se = conv(se, 32, "se_reduce", act="relu", k=1)
    se = conv(se, 128, "se_expand", act="sigmoid", k=1)
    b = L.Multiply(name="se_mul")([e3, se])
    d2 = L.Conv2DTranspose(64, 3, strides=2, padding="same", name="dec2_up")(b)
    d2 = conv(L.Concatenate(name="dec2_cat")([d2, e2]), 64, "dec2", act="relu")    # 32x32
    d1 = up2(d2, "dec1_up")
    d1 = conv(L.Concatenate(name="dec1_cat")([d1, e1]), 32, "dec1", act="relu")    # 64x64
    d0 = L.Conv2DTranspose(16, 3, strides=2, padding="same", name="dec0_up")(d1)
    d0 = conv(L.Concatenate(name="dec0_cat")([d0, s0]), 16, "dec0", act="relu")    # 128x128
    up = up2(d0, "head_up")                                                         # 256x256
    out = conv(up, 1, "head", act="sigmoid", k=1)
    return tf.keras.Model(inp, out, name="unet_synth")


def build_model(seed: int = 0, head_bias: float = 0.0) -> bytes:
    """The flatbuffer bytes of the U-Net (deterministic): He-normal
    weights from ``numpy.random.default_rng(seed)``, zero biases but the
    head's."""
    import tensorflow as tf

    model = _keras_unet(tf)
    rng = np.random.default_rng(seed)
    for layer in model.layers:
        ws = layer.get_weights()
        if not ws:
            continue
        k = ws[0]
        transposed = isinstance(layer, tf.keras.layers.Conv2DTranspose)
        fan_in = k.shape[0] * k.shape[1] * (k.shape[3] if transposed else k.shape[2])
        k = (rng.standard_normal(k.shape) * math.sqrt(2.0 / fan_in)).astype(np.float32)
        bias = np.zeros(ws[1].shape, np.float32)
        if layer.name == "head":
            bias[:] = head_bias
        layer.set_weights([k, bias])
    conv = tf.lite.TFLiteConverter.from_keras_model(model)
    conv.optimizations = [tf.lite.Optimize.DEFAULT]
    conv.target_spec.supported_types = [tf.float16]
    return conv.convert()


def calibrate_head_bias(path: str, frame) -> float:
    """Median output logit over the model-output ROI for ``frame``, through
    the PyTorch port's classic preprocess and graph executor on the CPU."""
    import torch
    from backscrub_tpu_torch.graph.executor import load_model
    from backscrub_tpu_torch.models.specs import spec_for_model
    from backscrub_tpu_torch.pipeline.geometry import compute_roi
    from backscrub_tpu_torch.pipeline.maskgen import preprocess

    model = load_model(path, "cpu")
    h, w = frame.shape[:2]
    geo = compute_roi(w, h, IN_W, IN_H, IN_W, IN_H)
    with torch.no_grad():
        x = preprocess(torch.from_numpy(frame), geo, spec_for_model(path))
        p = model(x[None]).double().numpy()[0, ..., 0]
    o = geo.out_roi
    p = np.clip(p[o.y:o.y + o.h, o.x:o.x + o.w], 1e-12, 1 - 1e-12)
    return float(np.median(np.log(p / (1 - p))))


def write_model(path: str, seed: int = 0) -> str:
    """Write the calibrated model to ``path`` (two passes: zero head bias,
    then the bias that puts frame 0's median logit at logit(THRESHOLD))."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from make_synth_segm import moving_frames
    with open(path, "wb") as f:
        f.write(build_model(seed))
    med = calibrate_head_bias(path, moving_frames(320, 240, 1)[0])
    bias = float(np.float16(math.log(THRESHOLD / (1 - THRESHOLD)) - med))
    with open(path, "wb") as f:
        f.write(build_model(seed, head_bias=bias))
    return path


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("out", help="output .tflite path (no family key in its name)")
    ap.add_argument("--seed", type=int, default=0)
    a = ap.parse_args(argv)
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    print(write_model(a.out, a.seed))


if __name__ == "__main__":
    main()
