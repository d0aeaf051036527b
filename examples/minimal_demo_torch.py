#!/usr/bin/env python3
"""Minimal readable demo of the PyTorch port (counterpart of
``examples/minimal_demo.py``): load a segmentation model, mask one image,
composite a background, save the result.

Images are binary PPM (P6) files, so the demo needs no OpenCV: ``input``
and ``background`` are read as PPM and resized to 640x480 if they differ;
without them the synthetic moving pattern (``io.streams.SyntheticSource``)
and a seeded background stand in.  The composite is written as PPM.  It
runs on the card unless given ``--device cpu``.

Usage: python examples/minimal_demo_torch.py --model MODEL.tflite
           [--device cuda|cpu] [input.ppm background.ppm] [out.ppm]
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir))

from backscrub_tpu_torch.io.streams import SyntheticSource
from backscrub_tpu_torch.pipeline.frame import FramePipeline, PipelineConfig
from backscrub_tpu_torch.pipeline.image import resize_bilinear

W, H = 640, 480


def read_ppm(path: str) -> np.ndarray:
    """A binary PPM (P6, maxval 255) as (H, W, 3) BGR u8."""
    with open(path, "rb") as f:
        data = f.read()
    fields, pos = [], 0
    while len(fields) < 4:
        while data[pos:pos + 1].isspace():
            pos += 1
        if data[pos:pos + 1] == b"#":
            pos = data.index(b"\n", pos)
            continue
        end = pos
        while not data[end:end + 1].isspace():
            end += 1
        fields.append(data[pos:end])
        pos = end
    magic, w, h, maxval = fields[0], int(fields[1]), int(fields[2]), int(fields[3])
    if magic != b"P6" or maxval != 255:
        raise ValueError(f"{path}: not a binary 8-bit PPM (P6, maxval 255)")
    rgb = np.frombuffer(data, np.uint8, w * h * 3, pos + 1).reshape(h, w, 3)
    return np.ascontiguousarray(rgb[..., ::-1])


def write_ppm(path: str, bgr: np.ndarray) -> None:
    h, w = bgr.shape[:2]
    with open(path, "wb") as f:
        f.write(b"P6\n%d %d\n255\n" % (w, h))
        f.write(np.ascontiguousarray(bgr[..., ::-1]).tobytes())


def fit(img: np.ndarray) -> np.ndarray:
    """``img`` at 640x480 (bilinear, rounded) if it is not already."""
    if img.shape[:2] == (H, W):
        return img
    import torch
    out = resize_bilinear(torch.from_numpy(img).float(), H, W)
    return torch.clamp(torch.round(out), 0, 255).to(torch.uint8).numpy()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", required=True, help="a .tflite segmentation model")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("images", nargs="*", help="[input.ppm background.ppm] [out.ppm]")
    args = ap.parse_args(argv)
    if len(args.images) >= 2:
        frame, bg = fit(read_ppm(args.images[0])), fit(read_ppm(args.images[1]))
    else:
        frame = SyntheticSource(W, H).read()
        bg = np.random.default_rng(0).integers(0, 256, (H, W, 3), np.uint8)
    out = args.images[2] if len(args.images) > 2 else (args.images[0] if len(args.images) == 1
                                                       else "demo_out.ppm")

    pipe = FramePipeline(args.model, PipelineConfig(width=W, height=H, output_format="bgr"),
                         device=args.device)
    for _ in range(4):  # settle the temporal EMA (about three frames)
        composited, mask = pipe.step(frame, bg)

    write_ppm(out, composited.cpu().numpy())
    print(f"person pixels: {(mask < 128).float().mean().item():.1%}; wrote {out} "
          f"({pipe.device})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
