#!/usr/bin/env python3
"""Multi-stream serving demo of the PyTorch port: N camera streams on one
card (counterpart of ``examples/serve_multistream.py``).

Frames from S streams stack into one batch and the whole frame step
(mask, composite, YUYV) runs once over it, each kernel one launch for the
batch, with every stream's temporal EMA carried on the device.  The JAX
demo shards the batch over a device mesh; the port serves one card, so
there is no mesh.  Then the production shape: S live sources glued to the
batched step by ``MultiStreamServer`` (a per-stream EMA, streams ending
at different times).  It runs on the card unless given ``--device cpu``.

Usage: python examples/serve_multistream_torch.py --model MODEL.tflite
           [--device cuda|cpu] [n_streams] [frames]
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir))

from backscrub_tpu_torch.parallel.streams import MultiStreamPipeline
from backscrub_tpu_torch.pipeline.frame import PipelineConfig
from backscrub_tpu_torch.runtime.multistream import MultiStreamServer


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", required=True, help="a .tflite segmentation model")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("n_streams", nargs="?", type=int, default=8)
    ap.add_argument("frames", nargs="?", type=int, default=50)
    args = ap.parse_args(argv)
    import torch

    w, h = 640, 480
    n = args.n_streams
    ms = MultiStreamPipeline(args.model, PipelineConfig(width=w, height=h), n,
                             device=args.device)
    print(f"serving {n} streams on {ms.device}")

    rng = np.random.default_rng(0)
    frames = rng.integers(0, 256, (n, h, w, 3), np.uint8)
    bgs = rng.integers(0, 256, (n, h, w, 3), np.uint8)

    def sync():
        if ms.device.type == "cuda":
            torch.cuda.synchronize()

    ms.step(frames, bgs)   # the first call builds the kernels
    sync()
    t0 = time.perf_counter()
    for _ in range(args.frames):
        out, masks = ms.step(frames, bgs)
    sync()
    dt = time.perf_counter() - t0
    print(f"{args.frames} batched steps: {args.frames * n / dt:.1f} aggregate frames/s "
          f"({args.frames / dt:.1f} steps/s)")

    lengths = [10 + (s % 3) for s in range(n)]
    iters = [iter([frames[s]] * lengths[s]) for s in range(n)]
    sources = [lambda it=it: next(it, None) for it in iters]
    counts = [0] * n
    sinks = [lambda _o, s=s: counts.__setitem__(s, counts[s] + 1) for s in range(n)]
    ticks = MultiStreamServer(ms, sources, sinks, backgrounds=bgs).run()
    print(f"MultiStreamServer: {ticks} ticks, per-stream deliveries {counts}")
    return 0 if counts == lengths else 1


if __name__ == "__main__":
    sys.exit(main())
