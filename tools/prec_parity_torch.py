#!/usr/bin/env python3
"""Decode-level parity of the port's CNN against TFLite on the CPU, in each
of the port's precision modes (counterpart of ``tools/prec_parity.py``).

The JAX tool compares its executor at three MXU precisions.  The port's
modes are f32 (the default), bf16 (``--bf16``: ``compute_dtype=
torch.bfloat16, precision="default"``) and int8 (``--int8``: per-channel
int8 kernels); "ours" is the port's ``MaskGen`` in that mode, its model
stage (``MaskGen._infer``) on the reference's preprocessed input, so the
comparison measures the CNN and nothing else.  The frames: the synthetic
portrait and still background (``tools/gen_assets.py``) and low-frequency
random fields, whose score maps cross many decode boundaries a frame.

Prints one JSON line a mode: the mean and least agreement of the decode
map with TFLite's over the frames, the largest score deviation and the
golden's 0.01-percentile decode margin (a deviation far under that margin
makes agreement 1.0 forced, not lucky).

TFLite and OpenCV are imported here and the card's machine has neither:
this tool runs on the CPU only (``device="cpu"``).

Usage: python tools/prec_parity_torch.py --model PATH [--frames 6]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

_TOOLS = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(_TOOLS, os.pardir))
sys.path.insert(0, _TOOLS)

def make_frames(n: int, w: int = 1280, h: int = 720):
    """The portrait and the still background, then low-frequency random
    fields (seed 7), ``n`` frames of ``w`` x ``h`` BGR u8."""
    import cv2
    from gen_assets import ensure_assets
    portrait, _, still = ensure_assets()
    frames = [cv2.resize(cv2.imread(portrait), (w, h)), cv2.resize(cv2.imread(still), (w, h))]
    rng = np.random.default_rng(7)
    while len(frames) < n:
        tiny = rng.integers(0, 256, (9, 16, 3), np.uint8)
        frames.append(cv2.resize(tiny, (w, h), interpolation=cv2.INTER_CUBIC))
    return frames[:n]


def margins(out: np.ndarray, spec) -> np.ndarray:
    """How far a score must move before the decode can flip: top-1 less
    top-2 for an argmax, |score - threshold|, |out1 - out0|."""
    if spec.decode.startswith("argmax"):
        part = np.partition(out, -2, axis=-1)
        return part[..., -1] - part[..., -2]
    if spec.decode == "threshold":
        return np.abs(out[..., 0] - spec.threshold)
    return np.abs(out[..., 1] - out[..., 0])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="deeplabv3_257_mv_gpu.tflite",
                    help="a .tflite path or a name resolve_model_path finds")
    ap.add_argument("--frames", type=int, default=6)
    args = ap.parse_args(argv)

    import torch
    from backscrub_tpu_torch.models.specs import resolve_model_path, spec_for_model
    from backscrub_tpu_torch.pipeline.maskgen import MaskGen
    from backscrub_tpu_torch.utils.parity import decode_map, golden_output

    w, h = 1280, 720
    path = resolve_model_path(args.model)
    spec = spec_for_model(path)
    goldens = [golden_output(path, f, w, h, spec) for f in make_frames(args.frames, w, h)]
    modes = {"f32": {}, "bf16": dict(compute_dtype=torch.bfloat16, precision="default"),
             "int8": dict(quantize="int8")}
    for mode, kw in modes.items():
        mg = MaskGen(path, w, h, device="cpu", edge_fused=False, **kw)
        ags, persons, devs, margin_mins = [], [], [], []
        for gout, x in goldens:
            with torch.no_grad():
                dev = mg._infer(torch.from_numpy(x)).float().numpy()
            dmap, gmap = decode_map(dev, spec), decode_map(gout, spec)
            ags.append(float((dmap == gmap).mean()))
            persons.append(float((dmap != 0).mean()))
            devs.append(float(np.abs(dev - gout).max()))
            margin_mins.append(float(np.percentile(margins(gout, spec), 0.01)))
        print(json.dumps({
            "model": os.path.basename(path), "mode": mode,
            "agreement_mean": round(float(np.mean(ags)), 6),
            "agreement_min": round(float(np.min(ags)), 6),
            "per_frame": [round(a, 6) for a in ags],
            "nonzero_frac": [round(p, 4) for p in persons],
            "score_dev_max_vs_cpu": round(float(np.max(devs)), 5),
            "golden_margin_p001": round(float(np.min(margin_mins)), 5),
        }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
