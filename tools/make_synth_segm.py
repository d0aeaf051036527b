"""Write a segm_lite- or segm_full-shaped synthetic ``.tflite`` model from a seed.

The bundled Google Meet models are not part of the repository, so the
PyTorch port (``backscrub_tpu_torch``) and its tests run on a model built
here instead.  It keeps what the pipeline depends on:

- the shapes: 1xHxWx3 f32 in, 1xHxWx2 out (two-channel decode), at
  segm_lite's 96x160 (the default) or segm_full's 144x256 (``--size``;
  SURVEY.md 2.2: the full model has "the identical op mix" at that size);
- the op kinds of segm_lite (SURVEY.md 2.2): node 0 is a 3x3/s2 SAME
  CONV_2D 3->16 followed by HARD_SWISH; 1x1 convs, depthwise 3x3/5x5 at
  stride 1 and 2, squeeze-excite blocks (AVERAGE_POOL_2D ->
  FULLY_CONNECTED -> RELU -> FULLY_CONNECTED -> LOGISTIC -> MUL), residual
  ADDs, three RESIZE_BILINEAR 2x + CONCATENATION decoder stages and the
  MediaPipe custom ``Convolution2DTransposeBias`` 2x2/s2 tail;
- weights stored f16 behind DEQUANTIZE nodes, as the Meet files store them.

The encoder follows MobileNetV3-small (Howard et al. 2019, "Searching for
MobileNetV3", Table 2) down to 1/16 of the input (6x10 at 96x160, 9x16 at
144x256), with its published widths 16, 24, 40, 48, 96 and expansions
72/88/96/240/120/144/288; the decoder's three 2x stages climb back to 1/2
and the tail to the input size, so H and W must be multiples of 16.
Weights are drawn from ``numpy.random.default_rng(seed)``.  The tail bias is calibrated so that
the first frame of ``moving_frames`` decodes to a mix of person and
background pixels (a mask that is all one value makes parity tests
vacuous); the calibration runs the JAX reference package.

Usage::

    python tools/make_synth_segm.py tests/data/segm_synth_lite_96x160.tflite
    python tools/make_synth_segm.py tests/data/segm_synth_full_144x256.tflite --size 144x256
    python tools/make_synth_segm.py out.tflite --width 0.5 --depth 4

The file name must contain ``segm_`` and none of ``body-pix`` or
``deeplab``: ``spec_for_model`` picks the family by name.
"""

from __future__ import annotations

import argparse
import os
import struct
import sys

import numpy as np

IN_H, IN_W = 96, 160            # segm_lite's input, the default size
# the published models of this shape, by input size (the model's description)
SIZES = {(96, 160): "segm_lite", (144, 256): "segm_full"}

# MobileNetV3-small bnecks (Table 2) down to the 6x10 stage:
# (kernel, expansion, out, squeeze-excite, activation, stride)
BLOCKS = (
    (3, 16, 16, True, "RELU", 2),
    (3, 72, 24, False, "RELU", 2),
    (3, 88, 24, False, "RELU", 1),
    (5, 96, 40, True, "HARD_SWISH", 2),
    (5, 240, 40, True, "HARD_SWISH", 1),
    (5, 240, 40, True, "HARD_SWISH", 1),
    (5, 120, 48, True, "HARD_SWISH", 1),
    (5, 144, 48, True, "HARD_SWISH", 1),
    (5, 288, 96, True, "HARD_SWISH", 1),
)
STEM = 16
# decoder: channels after each 2x upsample stage (6x10 -> 12x20 -> 24x40
# -> 48x80); the last one is the tail's input width
DECODER = (24, 16, 16)

_ACT = {"NONE": 0, "RELU": 1, "RELU6": 3}


def _div8(c: float) -> int:
    """MobileNet channel rounding: nearest multiple of 8, never below 90%."""
    v = max(8, int(c + 4) // 8 * 8)
    return v + 8 if v < 0.9 * c else v


def moving_frames(width: int, height: int, n: int, seed: int = 0):
    """``n`` BGR u8 frames of a seeded scene: a textured background and a
    head-and-shoulders blob that moves a few pixels per frame.  Drawn in
    normalized coordinates, so every frame size shows the same scene."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float32)
    u, v = xx / width, yy / height
    base = np.stack([80 + 60 * np.sin(6.0 * u + 1.0) * np.cos(4.0 * v),
                     120 + 50 * np.cos(5.0 * u - 2.0 * v),
                     90 + 70 * np.sin(3.0 * v + 2.0 * u)], axis=-1)
    grain = rng.integers(-12, 13, (height, width, 3))
    colour = np.array([60.0, 110.0, 200.0], np.float32)
    frames = []
    for k in range(n):
        person = person_mask(u, v, k)[..., None]
        shade = 40.0 * np.cos(9.0 * u + 0.5 * k)[..., None]
        img = np.where(person, colour + shade, base) + grain
        frames.append(np.clip(img, 0, 255).astype(np.uint8))
    return frames


def person_mask(u, v, k: int):
    """Where frame ``k`` of ``moving_frames`` shows the person, at the
    normalized coordinates ``u`` (x / width) and ``v`` (y / height)."""
    cx = 0.5 + 0.15 * np.sin(0.3 * k)
    cy = 0.02 * np.cos(0.2 * k)
    head = ((u - cx) / 0.12) ** 2 + ((v - 0.35 - cy) / 0.18) ** 2 < 1.0
    body = ((u - cx) / 0.30) ** 2 + ((v - 1.0 - cy) / 0.45) ** 2 < 1.0
    return head | body


class _Graph:
    """Accumulates tensors, buffers and operators for ModelT.Pack."""

    def __init__(self, sg, rng):
        self.sg, self.rng = sg, rng
        self.tensors, self.buffers, self.ops, self.codes = [], [b""], [], []

    def tensor(self, name, shape, ttype=0, data: bytes = b""):
        t = self.sg.TensorT()
        t.shape, t.type, t.name = list(shape), ttype, name
        if data:
            self.buffers.append(data)
            t.buffer = len(self.buffers) - 1
        self.tensors.append(t)
        return len(self.tensors) - 1

    def weight(self, name, arr):
        """f16 constant behind a DEQUANTIZE node -> the f32 tensor id."""
        h = np.ascontiguousarray(arr, np.float16)
        src = self.tensor(name + "/f16", h.shape, 1, h.tobytes())
        dst = self.tensor(name, h.shape)
        self.op("DEQUANTIZE", [src], [dst])
        return dst

    def code(self, builtin: int, custom=None):
        key = (builtin, custom)
        if key not in self.codes:
            self.codes.append(key)
        return self.codes.index(key)

    def op(self, kind, inputs, outputs, opt=None, opt_type=0, custom=None):
        sg = self.sg
        o = sg.OperatorT()
        if custom is not None:
            o.opcodeIndex = self.code(sg.BuiltinOperator.CUSTOM, kind)
            o.customOptions = list(custom)
        else:
            o.opcodeIndex = self.code(getattr(sg.BuiltinOperator, kind))
            o.builtinOptionsType, o.builtinOptions = opt_type, opt
        o.inputs, o.outputs = list(inputs), list(outputs)
        self.ops.append(o)
        return outputs[0]

    def pack(self, output: int, description: str) -> bytes:
        """The flatbuffer bytes of a one-subgraph model: input tensor 0,
        ``output`` its output."""
        import flatbuffers
        sg = self.sg
        sub = sg.SubGraphT()
        sub.tensors, sub.operators = self.tensors, self.ops
        sub.inputs, sub.outputs, sub.name = [0], [output], "main"
        model = sg.ModelT()
        model.version = 3
        model.description = description
        model.subgraphs = [sub]
        model.buffers = []
        for data in self.buffers:
            buf = sg.BufferT()
            buf.data = np.frombuffer(data, np.uint8) if data else None
            model.buffers.append(buf)
        model.operatorCodes = []
        for builtin, custom in self.codes:
            oc = sg.OperatorCodeT()
            oc.builtinCode, oc.deprecatedBuiltinCode = builtin, min(builtin, 127)
            oc.customCode = custom
            model.operatorCodes.append(oc)
        fb = flatbuffers.Builder(1024)
        fb.Finish(model.Pack(fb), file_identifier=b"TFL3")
        return bytes(fb.Output())

    # -- layers ------------------------------------------------------------
    def conv(self, name, x, shape, cout, k=1, stride=1, act="NONE"):
        sg, rng = self.sg, self.rng
        h, w, cin = shape
        fan = k * k * cin
        gain = 1.0 if act == "NONE" else 2.0
        wt = self.weight(name + "/w", rng.standard_normal((cout, k, k, cin))
                         * np.sqrt(gain / fan))
        b = self.weight(name + "/b", rng.standard_normal(cout) * 0.1)
        oh, ow = -(-h // stride), -(-w // stride)
        y = self.tensor(name, (1, oh, ow, cout))
        opt = sg.Conv2DOptionsT()
        opt.padding, opt.strideW, opt.strideH = 0, stride, stride
        opt.fusedActivationFunction = _ACT[act]
        self.op("CONV_2D", [x, wt, b], [y], opt, sg.BuiltinOptions.Conv2DOptions)
        return y, (oh, ow, cout)

    def dw(self, name, x, shape, k, stride, act="NONE", dilation=1):
        sg, rng = self.sg, self.rng
        h, w, c = shape
        wt = self.weight(name + "/w", rng.standard_normal((1, k, k, c))
                         * np.sqrt(2.0 / (k * k)))
        b = self.weight(name + "/b", rng.standard_normal(c) * 0.1)
        oh, ow = -(-h // stride), -(-w // stride)
        y = self.tensor(name, (1, oh, ow, c))
        opt = sg.DepthwiseConv2DOptionsT()
        opt.padding, opt.strideW, opt.strideH = 0, stride, stride
        opt.dilationWFactor = opt.dilationHFactor = dilation
        opt.depthMultiplier, opt.fusedActivationFunction = 1, _ACT[act]
        self.op("DEPTHWISE_CONV_2D", [x, wt, b], [y], opt,
                sg.BuiltinOptions.DepthwiseConv2DOptions)
        return y, (oh, ow, c)

    def unary(self, kind, name, x, shape):
        return self.op(kind, [x], [self.tensor(name, shape)])

    def binary(self, kind, name, a, b, shape):
        sg = self.sg
        opt = sg.AddOptionsT() if kind == "ADD" else sg.MulOptionsT()
        ot = (sg.BuiltinOptions.AddOptions if kind == "ADD"
              else sg.BuiltinOptions.MulOptions)
        return self.op(kind, [a, b], [self.tensor(name, shape)], opt, ot)

    def se(self, name, x, shape):
        sg, rng = self.sg, self.rng
        h, w, c = shape
        mid = _div8(c / 4)
        opt = sg.Pool2DOptionsT()
        opt.padding, opt.strideW, opt.strideH = 1, w, h
        opt.filterWidth, opt.filterHeight = w, h
        pooled = self.op("AVERAGE_POOL_2D", [x],
                         [self.tensor(name + "/pool", (1, 1, 1, c))], opt,
                         sg.BuiltinOptions.Pool2DOptions)
        vec = pooled
        for i, (cin, cout) in enumerate(((c, mid), (mid, c))):
            wt = self.weight(f"{name}/fc{i}/w", rng.standard_normal(
                (cout, cin)) * np.sqrt(1.0 / cin))
            b = self.weight(f"{name}/fc{i}/b", rng.standard_normal(cout) * 0.1
                            + (1.0 if i else 0.0))
            fo = sg.FullyConnectedOptionsT()
            fo.keepNumDims = True
            vec = self.op("FULLY_CONNECTED", [vec, wt, b],
                          [self.tensor(f"{name}/fc{i}", (1, 1, 1, cout))],
                          fo, sg.BuiltinOptions.FullyConnectedOptions)
            if i == 0:
                vec = self.unary("RELU", name + "/relu", vec, (1, 1, 1, cout))
        gate = self.unary("LOGISTIC", name + "/gate", vec, (1, 1, 1, c))
        return self.binary("MUL", name + "/mul", x, gate, (1, h, w, c))

    def act(self, name, x, shape, act):
        """A standalone HARD_SWISH node (as segm_lite has them); RELU is
        fused into the producing conv instead."""
        if act == "HARD_SWISH":
            return self.unary("HARD_SWISH", name + "/hs", x, (1,) + shape)
        return x

    def resize2x(self, name, x, shape):
        sg = self.sg
        h, w, c = shape
        size = self.tensor(name + "/size", (2,), 2,
                           np.array([2 * h, 2 * w], np.int32).tobytes())
        opt = sg.ResizeBilinearOptionsT()
        opt.alignCorners, opt.halfPixelCenters = False, True
        y = self.tensor(name, (1, 2 * h, 2 * w, c))
        self.op("RESIZE_BILINEAR", [x, size], [y], opt,
                sg.BuiltinOptions.ResizeBilinearOptions)
        return y, (2 * h, 2 * w, c)

    def concat(self, name, parts, shapes):
        sg = self.sg
        h, w = shapes[0][:2]
        c = sum(s[2] for s in shapes)
        opt = sg.ConcatenationOptionsT()
        opt.axis = 3
        y = self.tensor(name, (1, h, w, c))
        self.op("CONCATENATION", parts, [y], opt,
                sg.BuiltinOptions.ConcatenationOptions)
        return y, (h, w, c)


def build_model(seed: int = 0, width: float = 1.0, depth: int = len(BLOCKS),
                tail_bias=(0.0, 0.0), size=(IN_H, IN_W)) -> bytes:
    """The flatbuffer bytes of the synthetic model (deterministic) with
    input and output ``size`` (H, W), both multiples of 16."""
    from tensorflow.lite.python import schema_py_generated as sg

    in_h, in_w = size
    if in_h % 16 or in_w % 16:
        raise ValueError(f"size {in_h}x{in_w}: H and W must be multiples of 16")

    n_strided = sum(b[5] == 2 for b in BLOCKS)
    if depth < n_strided:
        raise ValueError(f"depth must keep the {n_strided} strided blocks")
    keep, free = [], depth - n_strided
    for blk in BLOCKS:
        if blk[5] == 2 or free > 0:
            keep.append(blk)
            free -= blk[5] == 1
    rng = np.random.default_rng(seed)
    g = _Graph(sg, rng)

    x = g.tensor("input", (1, in_h, in_w, 3))
    x, shape = g.conv("stem", x, (in_h, in_w, 3), _div8(STEM * width), 3, 2)
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
            x = g.se(name + "/se", x, shape)
        x, shape = g.conv(name + "/project", x, shape, out)
        if stride == 1 and in_shape == shape:
            x = g.binary("ADD", name + "/add", inp, x, (1,) + shape)
        skips[shape[:2]] = (x, shape)
    for i, dc in enumerate(DECODER):
        name = f"decoder{i}"
        x, shape = g.conv(name + "/reduce", x, shape, _div8(dc * width),
                          act="RELU")
        x, shape = g.resize2x(name + "/up", x, shape)
        skip, skip_shape = skips[shape[:2]]
        x, shape = g.concat(name + "/concat", [x, skip], [shape, skip_shape])
    x, shape = g.conv("decoder/out", x, shape, _div8(DECODER[-1] * width),
                      act="RELU")
    # 2x2/s2 transpose conv 16->2 (OHWI), MediaPipe custom op options:
    # {TfLitePadding padding (1 = SAME); int stride_w; int stride_h}
    k_in = shape[2]
    wt = g.weight("tail/w", rng.standard_normal((2, 2, 2, k_in))
                  * np.sqrt(1.0 / k_in))
    b = g.weight("tail/b", np.asarray(tail_bias, np.float32))
    y = g.tensor("output", (1, in_h, in_w, 2))
    g.op("Convolution2DTransposeBias", [x, wt, b], [y],
         custom=struct.pack("<iii", 1, 2, 2))

    shaped = SIZES.get((in_h, in_w), f"segm {in_h}x{in_w}")
    return g.pack(y, f"backscrub synthetic {shaped}-shaped model, seed={seed} "
                     f"width={width} depth={depth}")


def calibrate_tail_bias(path: str, frame, size=(IN_H, IN_W)) -> float:
    """Median channel difference (out1 - out0) over the model-output ROI
    for ``frame`` under the model's zero tail bias, through the JAX
    reference's classic preprocess + graph executor; ``size`` is the
    model's (H, W)."""
    from backscrub_tpu.graph.executor import load_model
    from backscrub_tpu.models.specs import spec_for_model
    from backscrub_tpu.pipeline.geometry import compute_roi
    from backscrub_tpu.pipeline.maskgen import preprocess

    model = load_model(path)
    h, w = frame.shape[:2]
    geo = compute_roi(w, h, size[1], size[0], size[1], size[0])
    x = preprocess(frame, geo, spec_for_model(path))
    out = np.asarray(model(x[None]))[0]
    o = geo.out_roi
    d = (out[..., 1] - out[..., 0])[o.y:o.y + o.h, o.x:o.x + o.w]
    return float(np.median(d))


def write_model(path: str, seed: int = 0, width: float = 1.0,
                depth: int = len(BLOCKS), size=(IN_H, IN_W)) -> str:
    """Write the calibrated model of input ``size`` (H, W) to ``path`` (two
    passes: zero tail bias, then the bias that centres frame 0's channel
    difference)."""
    with open(path, "wb") as f:
        f.write(build_model(seed, width, depth, size=size))
    frame = moving_frames(320, 240, 1)[0]
    med = np.float16(calibrate_tail_bias(path, frame, size))
    with open(path, "wb") as f:
        f.write(build_model(seed, width, depth, tail_bias=(0.0, -med), size=size))
    return path


def parse_size(text: str):
    """``"144x256"`` -> (144, 256): H x W."""
    h, _, w = text.lower().partition("x")
    return int(h), int(w)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("out", help="output .tflite path (its name must contain 'segm_')")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--width", type=float, default=1.0,
                    help="channel multiplier (MobileNet rounding to 8)")
    ap.add_argument("--depth", type=int, default=len(BLOCKS),
                    help="encoder blocks kept (strided ones always stay)")
    ap.add_argument("--size", type=parse_size, default=(IN_H, IN_W),
                    help=f"input HxW, multiples of 16 (default {IN_H}x{IN_W}; "
                         "segm_full: 144x256)")
    a = ap.parse_args(argv)
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    print(write_model(a.out, a.seed, a.width, a.depth, a.size))


if __name__ == "__main__":
    main()
