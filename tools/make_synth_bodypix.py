"""Write a BodyPix-shaped synthetic ``.tflite`` model from a seed.

The reference's ``body-pix-float-050-8.tflite`` (fetched and converted by
``models/body-pix/get-model.sh`` and ``convert.sh`` in the original
project) is not part of the repository, so the PyTorch port
(``backscrub_tpu_torch``) and its tests run its BodyPix path on a model
built here instead.  It keeps what the pipeline depends on:

- the shapes: 1x257x257x3 f32 in, normalized x/255, 1x33x33x1 logit out
  (``float_segments``), decoded by logit > 0.65 (``models/specs.py``);
- the op kinds and counts of the file (SURVEY.md 2.2): CONV_2D x15 and
  DEPTHWISE_CONV_2D x13, every activation a fused RELU6, no DEQUANTIZE:
  the weights are stored f32, as the float file stores them.

The architecture is the published one: tfjs-models
``body-pix/src/mobilenet.ts``, ``mobileNet100Architecture`` at multiplier
0.50 and output stride 8.  Its ``toOutputStridedLayers`` rule: once the
running stride reaches 8, each later stride becomes 1 and multiplies the
dilation rate of the blocks after it.  So:

=====  ==============  ======  ======  ========  =========
block  op              stride  rate    channels  output
=====  ==============  ======  ======  ========  =========
0      CONV_2D 3x3     2       1       16        129x129
1      DW 3x3 + PW     1       1       32        129x129
2      DW 3x3 + PW     2       1       64        65x65
3      DW 3x3 + PW     1       1       64        65x65
4      DW 3x3 + PW     2       1       128       33x33
5      DW 3x3 + PW     1       1       128       33x33
6      DW 3x3 + PW     1 (2)   1       256       33x33
7-11   DW 3x3 + PW     1       2       256       33x33
12     DW 3x3 + PW     1 (2)   2       512       33x33
13     DW 3x3 + PW     1       4       512       33x33
head   CONV_2D 1x1     1       1       1         33x33
=====  ==============  ======  ======  ========  =========

(a stride in brackets is the published one, turned into a rate), SAME
padding throughout (257 -> 129 -> 65 -> 33), each block a depthwise 3x3
then a pointwise 1x1, both with RELU6 fused and a bias, and the
``float_segments`` head a 1x1 CONV_2D 512 -> 1 with bias and no
activation.  Where the graph may differ from the real file: the file's
other heads (part and pose maps) are cut away by its converter
(``myconverter.py`` keeps ``float_segments``), and so absent here too;
its input is named ``sub_2`` after the tfjs graph's preprocess, here
``input``; the dilated depthwise convs carry their rate as the op's
dilation factor (SURVEY.md lists no SPACE_TO_BATCH_ND).

Weights are drawn from ``numpy.random.default_rng(seed)`` with fan-in
scaling.  The head bias is calibrated so that the first frame of
``moving_frames`` puts the median output logit over the model-output ROI
at 0.65, the decode's threshold: a mask that is a mix of person and
background (a mask that is all one value makes parity tests vacuous).
The calibration runs the JAX reference package.

Usage::

    python tools/make_synth_bodypix.py tests/data/body-pix_synth_050_8_257.tflite
    python tools/make_synth_bodypix.py body-pix_narrow.tflite --width 0.5 --depth 9

The file name must contain ``body-pix`` (hyphen included):
``spec_for_model`` picks the family by name.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from make_synth_segm import _div8, _Graph, moving_frames  # noqa: E402

SIZE = 257
OUT = 33
THRESHOLD = 0.65
OUTPUT_STRIDE = 8
# mobileNet100Architecture (tfjs-models body-pix/src/mobilenet.ts): (op,
# published stride), with the output channels at multiplier 0.50
ARCH = (("conv2d", 2, 16),
        ("separableConv", 1, 32), ("separableConv", 2, 64), ("separableConv", 1, 64),
        ("separableConv", 2, 128), ("separableConv", 1, 128), ("separableConv", 2, 256),
        ("separableConv", 1, 256), ("separableConv", 1, 256), ("separableConv", 1, 256),
        ("separableConv", 1, 256), ("separableConv", 1, 256),
        ("separableConv", 2, 512), ("separableConv", 1, 512))
BLOCKS = len(ARCH) - 1           # the separable blocks


def output_strided(arch, output_stride: int = OUTPUT_STRIDE):
    """``toOutputStridedLayers``: each layer's (stride, rate).  Once the
    running stride reaches ``output_stride``, a layer takes stride 1 and
    the current rate, and its published stride multiplies the rate of the
    layers after it."""
    current, rate, out = 1, 1, []
    for _, stride, _ in arch:
        if current == output_stride:
            out.append((1, rate))
            rate *= stride
        else:
            out.append((stride, 1))
            current *= stride
    return out


def kept_blocks(depth: int):
    """``ARCH`` with ``depth`` separable blocks: the stem and every block
    whose published stride is 2 always stay, then stride-1 blocks in
    order while ``depth`` allows."""
    n_strided = sum(a[1] == 2 for a in ARCH[1:])
    if not n_strided <= depth <= BLOCKS:
        raise ValueError(f"depth must lie in {n_strided}..{BLOCKS}")
    keep, free = [ARCH[0]], depth - n_strided
    for a in ARCH[1:]:
        if a[1] == 2 or free > 0:
            keep.append(a)
            free -= a[1] == 1
    return tuple(keep)


class _F32Graph(_Graph):
    """``make_synth_segm``'s graph, with f32 constants and no DEQUANTIZE nodes."""

    def weight(self, name, arr):
        a = np.ascontiguousarray(arr, np.float32)
        return self.tensor(name, a.shape, 0, a.tobytes())


def build_model(seed: int = 0, width: float = 1.0, depth: int = BLOCKS,
                head_bias=None) -> bytes:
    """The flatbuffer bytes of the synthetic model (deterministic);
    ``head_bias``, where given, replaces the drawn bias of the
    ``float_segments`` head."""
    from tensorflow.lite.python import schema_py_generated as sg

    arch = kept_blocks(depth)
    rng = np.random.default_rng(seed)
    g = _F32Graph(sg, rng)
    x = g.tensor("input", (1, SIZE, SIZE, 3))
    shape = (SIZE, SIZE, 3)
    for i, ((op, _, c), (stride, rate)) in enumerate(zip(arch, output_strided(arch))):
        c = _div8(c * width)
        if op == "conv2d":
            x, shape = g.conv(f"conv{i}", x, shape, c, 3, stride, act="RELU6")
            continue
        x, shape = g.dw(f"block{i}/dw", x, shape, 3, stride, act="RELU6", dilation=rate)
        x, shape = g.conv(f"block{i}/pw", x, shape, c, act="RELU6")
    # the float_segments head: 1x1 conv to one logit, bias, no activation
    wt = rng.standard_normal((1, 1, 1, shape[2])) * np.sqrt(1.0 / shape[2])
    bias = rng.standard_normal(1) * 0.1
    if head_bias is not None:
        bias = np.asarray([head_bias])
    wt, b = g.weight("float_segments/w", wt), g.weight("float_segments/b", bias)
    y = g.tensor("float_segments", (1,) + shape[:2] + (1,))
    opt = sg.Conv2DOptionsT()
    opt.padding, opt.strideW, opt.strideH = 0, 1, 1
    g.op("CONV_2D", [x, wt, b], [y], opt, sg.BuiltinOptions.Conv2DOptions)
    return g.pack(y, f"backscrub synthetic body-pix-float-050-8-shaped model, seed={seed} "
                     f"width={width} depth={depth}")


def calibrate_head_bias(path: str, frame) -> float:
    """Median output logit over the model-output ROI for ``frame``,
    through the JAX reference's classic preprocess + graph executor."""
    from backscrub_tpu.graph.executor import load_model
    from backscrub_tpu.models.specs import spec_for_model
    from backscrub_tpu.pipeline.geometry import compute_roi
    from backscrub_tpu.pipeline.maskgen import preprocess

    model = load_model(path)
    h, w = frame.shape[:2]
    geo = compute_roi(w, h, SIZE, SIZE, OUT, OUT)
    x = preprocess(frame, geo, spec_for_model(path))
    out = np.asarray(model(x[None]), np.float64)[0, ..., 0]
    o = geo.out_roi
    return float(np.median(out[o.y:o.y + o.h, o.x:o.x + o.w]))


def write_model(path: str, seed: int = 0, width: float = 1.0, depth: int = BLOCKS) -> str:
    """Write the calibrated model to ``path`` (two passes: head bias 0,
    then the bias that puts frame 0's median logit over the ROI at
    THRESHOLD; the head is linear, so the bias moves every logit one for
    one)."""
    with open(path, "wb") as f:
        f.write(build_model(seed, width, depth, head_bias=0.0))
    med = calibrate_head_bias(path, moving_frames(320, 240, 1)[0])
    with open(path, "wb") as f:
        f.write(build_model(seed, width, depth, head_bias=float(np.float32(THRESHOLD - med))))
    return path


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("out", help="output .tflite path (its name must contain 'body-pix')")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--width", type=float, default=1.0,
                    help="channel multiplier on the 0.50 model's widths (rounding to 8)")
    ap.add_argument("--depth", type=int, default=BLOCKS,
                    help="separable blocks kept (strided ones always stay)")
    a = ap.parse_args(argv)
    if "body-pix" not in os.path.basename(a.out):
        ap.error("the file name must contain 'body-pix' (spec_for_model keys on it)")
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    print(write_model(a.out, a.seed, a.width, a.depth))


if __name__ == "__main__":
    main()
