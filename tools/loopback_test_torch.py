#!/usr/bin/env python3
"""Loopback sink self-test over the PyTorch port's sinks: write a moving
test pattern to a sink (counterpart of ``tools/loopback_test.py``).

The reference's ``#ifdef standalone`` harness in videoio/loopback.cc:103-144
(an incrementing pattern at 10 fps), for any sink URI the port's
``io/streams.open_sink`` takes, so that it also runs headless (``file:``,
``null:``).  No model and no card: the frames are made on the host.

Usage: python tools/loopback_test_torch.py [/dev/video1|file:out.yuv|null:] [WxH] [frames]
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def pattern(i: int, width: int, height: int) -> np.ndarray:
    """Frame ``i``: a diagonal ramp in the Y plane that moves 4 px a frame,
    neutral chroma (128), as YUYV (height, 2 * width) u8."""
    yy, xx = np.mgrid[0:height, 0:width]
    yuyv = np.empty((height, 2 * width), np.uint8)
    yuyv[:, 0::2] = ((xx + yy + 4 * i) % 256).astype(np.uint8)
    yuyv[:, 1::2] = 128
    return yuyv


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    uri = argv[0] if len(argv) > 0 else "/dev/video1"
    geo = argv[1] if len(argv) > 1 else "640x480"
    frames = int(argv[2]) if len(argv) > 2 else 100
    w, h = (int(v) for v in geo.split("x"))

    from backscrub_tpu_torch.io.streams import open_sink
    sink = open_sink(uri, w, h)
    for i in range(frames):
        sink.write_yuyv(pattern(i, w, h))
        time.sleep(0.1)  # 10 fps, like the reference harness
    sink.close()
    print(f"wrote {frames} pattern frames to {uri}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
