#!/usr/bin/env python3
"""Convert a TF SavedModel / Keras model to ``.tflite`` and check it on the
PyTorch port (counterpart of ``tools/convert_model.py``).

Any segmentation network with an NHWC float input converts through
``tf.lite.TFLiteConverter`` (TensorFlow is needed for this step only, on
a host that has it; it is imported inside ``convert``).  ``--check`` then
loads the result with the port's own loader and graph executor
(``backscrub_tpu_torch.graph.executor.load_model``: no TensorFlow, no
flatbuffers), on the card unless ``--device cpu``, runs it once on
zeros and prints its shapes and op histogram.

Usage:
  python tools/convert_model_torch.py saved_model_dir out.tflite [--check]
  python tools/convert_model_torch.py model.keras out.tflite --f16 --check --device cpu

After conversion, the model runs in ``backscrub-torch -m out.tflite``.  Its
decode rule comes from its file name (``models/specs.py`` keys on
'selfie', 'segm_', 'deeplab', 'body-pix', 'multiclass'); any other name
takes the "unknown" spec: x/255 in, a one-channel probability
thresholded at 0.65.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def convert(src: str, out: str, f16: bool = False) -> bytes:
    import tensorflow as tf
    if os.path.isdir(src):
        conv = tf.lite.TFLiteConverter.from_saved_model(src)
    else:
        model = tf.keras.models.load_model(src)
        conv = tf.lite.TFLiteConverter.from_keras_model(model)
    if f16:
        conv.optimizations = [tf.lite.Optimize.DEFAULT]
        conv.target_spec.supported_types = [tf.float16]
    blob = conv.convert()
    with open(out, "wb") as f:
        f.write(blob)
    return blob


def check(path: str, device: str = "cuda"):
    """Load ``path`` on the port and run it once on zeros; returns the
    model."""
    import torch
    from backscrub_tpu_torch._build import resolve_device
    from backscrub_tpu_torch.graph.executor import load_model
    m = load_model(path, device)
    with torch.no_grad():
        y = m(torch.zeros(m.input_shape, device=resolve_device(device)))
    print(f"loads OK on {device}: input {m.input_shape} -> output {tuple(y.shape)}")
    print(m.graph.summary())
    return m


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("src")
    ap.add_argument("out")
    ap.add_argument("--f16", action="store_true",
                    help="store weights half precision (like the Meet/MLKit models)")
    ap.add_argument("--check", action="store_true",
                    help="load the result with the port's executor and report")
    ap.add_argument("--device", default="cuda", help="where --check runs (cuda or cpu)")
    args = ap.parse_args(argv)

    convert(args.src, args.out, f16=args.f16)
    print(f"wrote {args.out} ({os.path.getsize(args.out)} bytes)")
    if args.check:
        check(args.out, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
