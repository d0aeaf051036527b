"""Write a deeplabv3_257-shaped synthetic ``.tflite`` model from a seed.

The reference's ``deeplabv3_257_mv_gpu.tflite`` is not part of the
repository, so the PyTorch port (``backscrub_tpu_torch``) and its tests run
its deeplab path on a model built here instead.  The file name must
contain ``deeplab`` so that ``spec_for_model`` picks the deeplab spec
(x / 127.5 - 1, argmax over 21 classes, person = class 15).

Architecture: DeepLabV3 on MobileNetV2 (Sandler et al. 2018, "MobileNetV2:
Inverted Residuals and Linear Bottlenecks", Table 2) at depth multiplier
0.5 without channel rounding (DeepLab's feature extractor sets
``divisible_by=1`` when the multiplier is not 1), run at output stride 8
as the TFLite example model is:

- 1x257x257x3 f32 in; stem CONV 3x3/s2 3->16, fused RELU6;
- bottleneck groups (t, c, n, s) of ``GROUPS``; each unit is an expansion
  1x1 (RELU6, absent when t = 1), a depthwise 3x3 (RELU6) and a linear
  projection 1x1, with an ADD where the stride is 1 and the widths match.
  Past output stride 8 a stride becomes a dilation rate: the unit that
  would stride keeps the current rate, the units after it take the
  multiplied one (block 4's first DW has dilation 1, the three
  480-channel DWs dilation 4);
- ASPP: AVERAGE_POOL_2D 33x33 VALID -> 1x1 160->256 RELU -> RESIZE_BILINEAR
  1->33, a 1x1 160->256 RELU branch, CONCATENATION -> 1x1 512->256 RELU;
- 1x1 256->21 logits, RESIZE_BILINEAR 33->33 (align_corners, an identity)
  and 33->257 (align_corners).

After constant folding the graph has 70 nodes with SURVEY.md 2.2's op
counts (CONV_2D x38, DEPTHWISE_CONV_2D x17, ADD x10, AVERAGE_POOL_2D,
CONCATENATION, RESIZE_BILINEAR x3); node 25 is a dilation-2 DW, node 63
the broadcast resize and node 68 the identity resize.  Weights are drawn
from ``numpy.random.default_rng(seed)`` with fan-in scaling and stored f16
behind DEQUANTIZE nodes (folded away on load, so the node indices stay
the real model's).  Class 15's (person) logit is then fitted through the
JAX reference package on four frames of ``moving_frames``: its weights are
a ridge regression of the frames' person masks on the 256 ASPP features,
and its bias puts the decoded person share at the masks'.  So the mask
follows the moving figure, as a trained model's does: an all-background
mask makes parity tests vacuous, and a noisy one has so many near-tie
pixels that two f32 summation orders flip some of them.

Usage::

    python tools/make_synth_deeplab.py tests/data/deeplab_synth_257.tflite
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from make_synth_segm import _Graph, moving_frames, person_mask

SIZE = 257
STEM = 16
# MobileNetV2 Table 2 at multiplier 0.5, up to the 160-channel stage:
# (expansion t, output channels c, repeats n, stride s)
GROUPS = ((1, 8, 1, 1), (6, 12, 2, 2), (6, 16, 3, 2), (6, 32, 4, 2),
          (6, 48, 3, 1), (6, 80, 3, 2), (6, 160, 1, 1))
OUTPUT_STRIDE = 8
ASPP = 256
CLASSES = 21
PERSON = 15
FIT_FRAMES = (0, 10, 20, 29)    # frames of moving_frames the person logit is fitted on


def _pool(g, name, x, shape):
    sg = g.sg
    h, w, c = shape
    opt = sg.Pool2DOptionsT()
    opt.padding, opt.strideW, opt.strideH = 1, w, h
    opt.filterWidth, opt.filterHeight = w, h
    return g.op("AVERAGE_POOL_2D", [x], [g.tensor(name, (1, 1, 1, c))], opt,
                sg.BuiltinOptions.Pool2DOptions)


def _resize(g, name, x, c, oh, ow):
    sg = g.sg
    size = g.tensor(name + "/size", (2,), 2, np.array([oh, ow], np.int32).tobytes())
    opt = sg.ResizeBilinearOptionsT()
    opt.alignCorners, opt.halfPixelCenters = True, False
    y = g.tensor(name, (1, oh, ow, c))
    g.op("RESIZE_BILINEAR", [x, size], [y], opt, sg.BuiltinOptions.ResizeBilinearOptions)
    return y


def build_model(seed: int = 0, person=None, features: bool = False) -> bytes:
    """The flatbuffer bytes of the synthetic model (deterministic).

    ``person``: (weights (256,), bias) of class 15's logit, replacing the
    drawn ones.  ``features``: end the graph at the ASPP projection (the
    logits' input) instead."""
    from tensorflow.lite.python import schema_py_generated as sg

    rng = np.random.default_rng(seed)
    g = _Graph(sg, rng)
    x = g.tensor("input", (1, SIZE, SIZE, 3))
    x, shape = g.conv("stem", x, (SIZE, SIZE, 3), STEM, 3, 2, act="RELU6")
    stride, rate = 2, 1
    unit = 0
    for t, c, n, s in GROUPS:
        for i in range(n):
            name = f"unit{unit}"
            unit += 1
            inp, in_shape = x, shape
            st, dil = (s if i == 0 else 1), rate
            if st > 1 and stride >= OUTPUT_STRIDE:
                st, rate = 1, rate * st   # this unit keeps dil; later ones take rate
            elif st > 1:
                stride *= st
            if t != 1:
                x, shape = g.conv(name + "/expand", x, shape, t * shape[2], act="RELU6")
            x, shape = g.dw(name + "/dw", x, shape, 3, st, act="RELU6", dilation=dil)
            x, shape = g.conv(name + "/project", x, shape, c)
            if st == 1 and in_shape == shape:
                x = g.binary("ADD", name + "/add", inp, x, (1,) + shape)
    h, w, c = shape
    pooled = _pool(g, "aspp/pool", x, shape)
    pooled, _ = g.conv("aspp/pool_conv", pooled, (1, 1, c), ASPP, act="RELU")
    pooled = _resize(g, "aspp/pool_up", pooled, ASPP, h, w)
    branch, _ = g.conv("aspp/conv0", x, shape, ASPP, act="RELU")
    x, shape = g.concat("aspp/concat", [pooled, branch], [(h, w, ASPP), (h, w, ASPP)])
    x, shape = g.conv("aspp/project", x, shape, ASPP, act="RELU")
    # logits: fan-in scaled weights and drawn biases, class 15's replaced
    weights = rng.standard_normal((CLASSES, 1, 1, ASPP)) * np.sqrt(1.0 / ASPP)
    bias = rng.standard_normal(CLASSES) * 0.1
    if person is not None:
        weights[PERSON, 0, 0], bias[PERSON] = person
    y = x
    if not features:
        wt, b = g.weight("logits/w", weights), g.weight("logits/b", bias)
        logits = g.tensor("logits", (1, h, w, CLASSES))
        opt = sg.Conv2DOptionsT()
        opt.padding, opt.strideW, opt.strideH = 0, 1, 1
        g.op("CONV_2D", [x, wt, b], [logits], opt, sg.BuiltinOptions.Conv2DOptions)
        same = _resize(g, "logits/same", logits, CLASSES, h, w)
        y = _resize(g, "output", same, CLASSES, SIZE, SIZE)

    return g.pack(y, f"backscrub synthetic deeplabv3_257-shaped model, seed={seed}")


def _jax_run(path: str, frame) -> np.ndarray:
    """The model at ``path`` on ``frame`` through the JAX reference's
    classic preprocess and graph executor; the output cropped to the
    output ROI."""
    from backscrub_tpu.graph.executor import load_model
    from backscrub_tpu.models.specs import spec_for_model
    from backscrub_tpu.pipeline.maskgen import preprocess

    model = load_model(path)
    geo = _geometry(frame)
    x = preprocess(frame, geo, spec_for_model(path))
    out = np.asarray(model(x[None]))[0]
    oh, ow = out.shape[:2]
    s = oh / SIZE
    o = geo.out_roi
    y0, x0 = int(round(o.y * s)), int(round(o.x * s))
    return out[y0:y0 + max(1, int(round(o.h * s))), x0:x0 + max(1, int(round(o.w * s)))]


def _geometry(frame):
    from backscrub_tpu.pipeline.geometry import compute_roi
    h, w = frame.shape[:2]
    return compute_roi(w, h, SIZE, SIZE, SIZE, SIZE)


def person_target(frame, k: int, n: int) -> np.ndarray:
    """Frame ``k``'s person mask sampled on an n x n grid over the model
    canvas (align_corners: grid point i sits at canvas row i*(SIZE-1)/(n-1))."""
    geo = _geometry(frame)
    h, w = frame.shape[:2]
    c = np.arange(n) * (SIZE - 1) / (n - 1)
    r, i = geo.roi, geo.in_roi
    fy = r.y + (c - i.y + 0.5) * r.h / i.h - 0.5
    fx = r.x + (c - i.x + 0.5) * r.w / i.w - 0.5
    return person_mask(fx[None, :] / w, fy[:, None] / h, k)


def person_margin(path: str, frame) -> np.ndarray:
    """Class 15's logit minus the largest other logit over the output ROI."""
    out = _jax_run(path, frame)
    return out[..., PERSON] - np.delete(out, PERSON, axis=-1).max(axis=-1)


def write_model(path: str, seed: int = 0) -> str:
    """Write the fitted model to ``path``.  Three passes: the ASPP features
    of the frames ``FIT_FRAMES`` give class 15's weights (ridge regression
    on their person masks, scaled to a score spread of 4); the model with
    those weights and bias 0 gives the margins; the bias moves the margin
    quantile of the masks' person share to 0 (the bilinear resizes keep a
    constant channel offset, so the bias moves the decoded margin one for
    one)."""
    frames = moving_frames(320, 240, max(FIT_FRAMES) + 1)
    with open(path, "wb") as f:
        f.write(build_model(seed, features=True))
    feats = [_jax_run(path, frames[k]) for k in FIT_FRAMES]
    n = feats[0].shape[0]
    a = np.concatenate([f.reshape(-1, ASPP) for f in feats]).astype(np.float64)
    t = np.concatenate([person_target(frames[k], k, n).reshape(-1)
                        for k in FIT_FRAMES]).astype(np.float64)
    am = a - a.mean(axis=0)
    gram = am.T @ am
    wfit = np.linalg.solve(gram + 1e-2 * np.trace(gram) / ASPP * np.eye(ASPP),
                           am.T @ (t - t.mean()))
    wfit *= 4.0 / np.std(am @ wfit)
    wfit = wfit.astype(np.float16).astype(np.float64)
    with open(path, "wb") as f:
        f.write(build_model(seed, person=(wfit, 0.0)))
    margin = np.concatenate([person_margin(path, frames[k]).reshape(-1) for k in FIT_FRAMES])
    bias = np.float16(-np.quantile(margin, 1.0 - t.mean()))
    with open(path, "wb") as f:
        f.write(build_model(seed, person=(wfit, float(bias))))
    return path


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("out", help="output .tflite path (the name must contain 'deeplab')")
    ap.add_argument("--seed", type=int, default=0)
    a = ap.parse_args(argv)
    if "deeplab" not in os.path.basename(a.out):
        ap.error("the file name must contain 'deeplab' (spec_for_model keys on it)")
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    print(write_model(a.out, a.seed))


if __name__ == "__main__":
    main()
