#!/usr/bin/env python3
"""Multi-stream serving demo of the PyTorch port: N camera streams over
a device mesh (counterpart of ``examples/serve_multistream.py``).

Frames from S streams stack into one batch, sharded over the mesh's
"data" axis, and the whole frame step (mask, composite, YUYV) runs once
over each device's streams, each kernel one launch for them, with every
stream's temporal EMA carried on the device that serves it.  The mesh
spans every device up to 8 (``parallel/mesh.py`` ``device_count``: the
cards, one process a card, or four gloo ranks on the CPU), and S is
rounded up to its data axis.  Then the
production shape: S live sources glued to the batched step by
``MultiStreamServer`` (a per-stream EMA, streams ending at different
times).  It runs on the card unless given ``--device cpu``.

Usage: python examples/serve_multistream_torch.py --model MODEL.tflite
           [--device cuda|cpu] [n_streams] [frames]
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir))

from backscrub_tpu_torch.parallel.mesh import device_count, make_mesh, run_world
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
    return run_world(serve, min(device_count(args.device), 8), args.device, args)


def serve(args) -> int:
    """One rank's demo over the world's mesh; rank 0 prints."""
    import torch
    import torch.distributed as dist

    mesh = make_mesh(dist.get_world_size(), device=args.device)
    dp = mesh.shape["data"]
    n = -(-args.n_streams // dp) * dp
    say = print if dist.get_rank() == 0 else (lambda *a: None)
    say(f"mesh {mesh.shape}, serving {n} streams")
    w, h = 640, 480
    ms = MultiStreamPipeline(args.model, PipelineConfig(width=w, height=h), n, mesh)

    rng = np.random.default_rng(0)
    frames = rng.integers(0, 256, (n, h, w, 3), np.uint8)
    bgs = rng.integers(0, 256, (n, h, w, 3), np.uint8)

    def sync():
        if ms.device.type == "cuda":
            torch.cuda.synchronize(ms.device)

    ms.step(frames, bgs)   # the first call builds the kernels
    sync()
    t0 = time.perf_counter()
    for _ in range(args.frames):
        out, masks = ms.step(frames, bgs)
    sync()
    dt = time.perf_counter() - t0
    say(f"{args.frames} batched steps: {args.frames * n / dt:.1f} aggregate frames/s "
        f"({args.frames / dt:.1f} steps/s)")

    lengths = [10 + (s % 3) for s in range(n)]
    iters = [iter([frames[s]] * lengths[s]) for s in range(n)]
    sources = [lambda it=it: next(it, None) for it in iters]
    counts = [0] * n
    sinks = [lambda _o, s=s: counts.__setitem__(s, counts[s] + 1) for s in range(n)]
    ticks = MultiStreamServer(ms, sources, sinks, backgrounds=bgs).run()
    # each stream is delivered on the rank that serves it
    total = torch.tensor(counts, device=ms.device)
    dist.all_reduce(total)
    counts = total.tolist()
    say(f"MultiStreamServer: {ticks} ticks, per-stream deliveries {counts}")
    return 0 if counts == lengths else 1


if __name__ == "__main__":
    sys.exit(main())
