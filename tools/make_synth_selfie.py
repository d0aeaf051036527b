"""Write an MLKit-selfie-shaped synthetic ``.tflite`` model from a seed.

The reference's default model, ``selfiesegmentation_mlkit-256x256-
2021_01_19-v1215.f16.tflite`` (``app/deepseg.cc:376``), is not part of the
repository, so the PyTorch port (``backscrub_tpu_torch``) and its tests run
on a model built here instead.  It keeps what the pipeline depends on:

- the shapes: 1x256x256x3 f32 in, normalized x/255, 1x256x256x1
  probability out, decoded by threshold > 0.65 (``models/specs.py``);
- the op kinds of the MLKit file (SURVEY.md 2.2): node 0 is a 3x3/s2 SAME
  CONV_2D 3->16 followed by HARD_SWISH; 1x1 convs, depthwise 3x3/5x5 at
  stride 1 and 2; squeeze-excite blocks done with 1x1 CONV_2D on the
  pooled vector (AVERAGE_POOL_2D -> CONV_2D -> RELU -> CONV_2D -> LOGISTIC
  -> MUL), since the file has no FULLY_CONNECTED; residual ADDs; three
  decoder stages that join their skips by ADD (a 1x1 reduce conv to the
  skip's width, RESIZE_BILINEAR 2x, ADD), since it has no CONCATENATION;
  the MediaPipe custom ``Convolution2DTransposeBias`` 2x2/s2 tail from 16
  channels to 1, then LOGISTIC;
- weights stored f16 behind DEQUANTIZE nodes, as the MLKit file stores
  them.

The encoder is ``make_synth_segm.BLOCKS`` (MobileNetV3-small, Howard et
al. 2019, Table 2, at its published widths) down to 16x16, then two more
stride-1 5x5 blocks at 96 channels (expansion 576, as published), so that
it has the file's 11 depthwise convs.  The decoder runs 16x16 -> 32x32 ->
64x64 -> 128x128 and the tail 128x128 -> 256x256.

Op counts at full width against SURVEY.md 2.2's mlkit row:

====================  =====  ======
op                    here   mlkit
====================  =====  ======
CONV_2D               43     43
DEPTHWISE_CONV_2D     11     11
AVERAGE_POOL_2D       9      10
LOGISTIC              10     11
MUL                   9      10
ADD                   9      14
HARD_SWISH            17     11
RELU                  9      22
RESIZE_BILINEAR       3      3
transpose conv        1      1
DEQUANTIZE            110    110
====================  =====  ======

Where they differ: MobileNetV3-small has squeeze-excite on 9 of its 11
blocks, one fewer than the file's pools (its tenth gate is not
published); the file adds 5 more ADDs than the 6 residual and 3 decoder
joins here; HARD_SWISH follows both the expansion and the depthwise conv
of every HARD_SWISH block here (as in ``make_synth_segm``), where the file
has 11; the RELU blocks' and the decoder's RELUs are fused into their
convs here, standalone nodes in the file.  None of these changes a kernel
or a shape on the port's path: every kind and every tensor width the
file's body has is here.

Weights are drawn from ``numpy.random.default_rng(seed)``.  The tail bias
is calibrated so that the first frame of ``moving_frames`` puts the median
output logit over the model-output ROI at logit(0.65), the decode's
threshold: a mask that is a mix of person and background (a mask that is
all one value makes parity tests vacuous).  The calibration runs the JAX
reference package.

Usage::

    python tools/make_synth_selfie.py tests/data/selfie_synth_mlkit_256x256.tflite
    python tools/make_synth_selfie.py out.tflite --width 0.5 --depth 4

The file name must contain ``selfie`` and none of ``segm_``, ``deeplab``,
``body-pix`` or ``multiclass``: ``spec_for_model`` picks the family by name.
"""

from __future__ import annotations

import argparse
import math
import os
import struct
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from make_synth_segm import BLOCKS, STEM, _div8, _Graph, moving_frames  # noqa: E402

IN_H = IN_W = 256
THRESHOLD = 0.65
# the encoder: segm's MobileNetV3-small blocks to 16x16, then two more
# (kernel, expansion, out, squeeze-excite, activation, stride)
SELFIE_BLOCKS = BLOCKS + ((5, 576, 96, True, "HARD_SWISH", 1),) * 2


def se_conv(g: _Graph, name: str, x, shape):
    """Squeeze-excite as the MLKit file has it: global AVERAGE_POOL_2D, 1x1
    CONV_2D to c/4 (rounded to 8), RELU, 1x1 CONV_2D back to c, LOGISTIC,
    MUL with the block's tensor."""
    sg = g.sg
    h, w, c = shape
    opt = sg.Pool2DOptionsT()
    opt.padding, opt.strideW, opt.strideH = 1, w, h
    opt.filterWidth, opt.filterHeight = w, h
    vec = g.op("AVERAGE_POOL_2D", [x], [g.tensor(name + "/pool", (1, 1, 1, c))], opt,
               sg.BuiltinOptions.Pool2DOptions)
    mid = _div8(c / 4)
    vec, _ = g.conv(name + "/fc0", vec, (1, 1, c), mid)
    vec = g.unary("RELU", name + "/relu", vec, (1, 1, 1, mid))
    vec, _ = g.conv(name + "/fc1", vec, (1, 1, mid), c)
    gate = g.unary("LOGISTIC", name + "/gate", vec, (1, 1, 1, c))
    return g.binary("MUL", name + "/mul", x, gate, (1, h, w, c))


def build_model(seed: int = 0, width: float = 1.0, depth: int = len(SELFIE_BLOCKS),
                tail_bias: float = 0.0) -> bytes:
    """The flatbuffer bytes of the synthetic model (deterministic)."""
    from tensorflow.lite.python import schema_py_generated as sg

    n_strided = sum(b[5] == 2 for b in SELFIE_BLOCKS)
    if depth < n_strided:
        raise ValueError(f"depth must keep the {n_strided} strided blocks")
    keep, free = [], depth - n_strided
    for blk in SELFIE_BLOCKS:
        if blk[5] == 2 or free > 0:
            keep.append(blk)
            free -= blk[5] == 1
    rng = np.random.default_rng(seed)
    g = _Graph(sg, rng)

    x = g.tensor("input", (1, IN_H, IN_W, 3))
    x, shape = g.conv("stem", x, (IN_H, IN_W, 3), _div8(STEM * width), 3, 2)
    x = g.act("stem", x, shape, "HARD_SWISH")
    skips = {shape[:2]: (x, shape)}
    for i, (k, exp, out, se, act, stride) in enumerate(keep):
        name = f"block{i}"
        inp, in_shape = x, shape
        exp, out = _div8(exp * width), _div8(out * width)
        if exp != shape[2]:
            x, shape = g.conv(name + "/expand", x, shape, exp,
                              act="RELU" if act == "RELU" else "NONE")
            x = g.act(name + "/expand", x, shape, act)
        x, shape = g.dw(name + "/dw", x, shape, k, stride,
                        act="RELU" if act == "RELU" else "NONE")
        x = g.act(name + "/dw", x, shape, act)
        if se:
            x = se_conv(g, name + "/se", x, shape)
        x, shape = g.conv(name + "/project", x, shape, out)
        if stride == 1 and in_shape == shape:
            x = g.binary("ADD", name + "/add", inp, x, (1,) + shape)
        skips[shape[:2]] = (x, shape)
    # decoder: 16x16 -> 32x32 -> 64x64 -> 128x128, each stage a 1x1 reduce
    # conv to the skip's width, a 2x bilinear resize and an ADD with the skip
    for i in range(3):
        name = f"decoder{i}"
        skip, skip_shape = skips[(2 * shape[0], 2 * shape[1])]
        x, shape = g.conv(name + "/reduce", x, shape, skip_shape[2], act="RELU")
        x, shape = g.resize2x(name + "/up", x, shape)
        x = g.binary("ADD", name + "/add", x, skip, (1,) + shape)
    # 2x2/s2 transpose conv 16->1 (OHWI), MediaPipe custom op options:
    # {TfLitePadding padding (1 = SAME); int stride_w; int stride_h}
    k_in = shape[2]
    wt = g.weight("tail/w", rng.standard_normal((1, 2, 2, k_in)) * np.sqrt(1.0 / k_in))
    b = g.weight("tail/b", np.asarray([tail_bias], np.float32))
    logit = g.tensor("tail", (1, IN_H, IN_W, 1))
    g.op("Convolution2DTransposeBias", [x, wt, b], [logit], custom=struct.pack("<iii", 1, 2, 2))
    y = g.unary("LOGISTIC", "output", logit, (1, IN_H, IN_W, 1))
    return g.pack(y, f"backscrub synthetic mlkit-selfie-shaped model, seed={seed} "
                     f"width={width} depth={depth}")


def calibrate_tail_bias(path: str, frame) -> float:
    """Median output logit over the model-output ROI for ``frame`` under
    the model's zero tail bias, through the JAX reference's classic
    preprocess + graph executor."""
    from backscrub_tpu.graph.executor import load_model
    from backscrub_tpu.models.specs import spec_for_model
    from backscrub_tpu.pipeline.geometry import compute_roi
    from backscrub_tpu.pipeline.maskgen import preprocess

    model = load_model(path)
    h, w = frame.shape[:2]
    geo = compute_roi(w, h, IN_W, IN_H, IN_W, IN_H)
    x = preprocess(frame, geo, spec_for_model(path))
    p = np.asarray(model(x[None]), np.float64)[0, ..., 0]
    o = geo.out_roi
    p = np.clip(p[o.y:o.y + o.h, o.x:o.x + o.w], 1e-12, 1 - 1e-12)
    return float(np.median(np.log(p / (1 - p))))


def write_model(path: str, seed: int = 0, width: float = 1.0,
                depth: int = len(SELFIE_BLOCKS)) -> str:
    """Write the calibrated model to ``path`` (two passes: zero tail bias,
    then the bias that puts frame 0's median logit at logit(THRESHOLD))."""
    with open(path, "wb") as f:
        f.write(build_model(seed, width, depth))
    frame = moving_frames(320, 240, 1)[0]
    med = calibrate_tail_bias(path, frame)
    bias = np.float16(math.log(THRESHOLD / (1 - THRESHOLD)) - med)
    with open(path, "wb") as f:
        f.write(build_model(seed, width, depth, tail_bias=float(bias)))
    return path


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("out", help="output .tflite path (its name must contain 'selfie')")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--width", type=float, default=1.0,
                    help="channel multiplier (MobileNet rounding to 8)")
    ap.add_argument("--depth", type=int, default=len(SELFIE_BLOCKS),
                    help="encoder blocks kept (strided ones always stay)")
    a = ap.parse_args(argv)
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    print(write_model(a.out, a.seed, a.width, a.depth))


if __name__ == "__main__":
    main()
