#!/usr/bin/env python3
"""Transparent virtual-camera viewer over the PyTorch port's sources
(counterpart of ``tools/transparent_viewer.py``).

The reference side tool attic/transparent_viewer.c: render the virtual
camera in a window, turning pure-green pixels (the green-screen fallback
background) transparent so the video floats over the desktop.  X11
per-pixel transparency needs a compositor; without a display, ``--out
DIR`` writes the BGRA frames as PNG files instead.  OpenCV is imported
only inside the functions that need it.

Usage: python tools/transparent_viewer_torch.py [/dev/video1|file:...] [--out dir]
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def chroma_key_green(frame_bgr: np.ndarray) -> np.ndarray:
    """BGRA with 100% green -> alpha 0 (attic/transparent_viewer.c:67-80)."""
    b, g, r = frame_bgr[..., 0], frame_bgr[..., 1], frame_bgr[..., 2]
    alpha = np.where((g == 255) & (b == 0) & (r == 0), 0, 255).astype(np.uint8)
    return np.dstack([frame_bgr, alpha])


def main(argv=None):
    import cv2
    ap = argparse.ArgumentParser()
    ap.add_argument("source", nargs="?", default="/dev/video1")
    ap.add_argument("--frames", type=int, default=0)
    ap.add_argument("--out", default=None,
                    help="write BGRA pngs here instead of opening a window")
    args = ap.parse_args(argv)

    from backscrub_tpu_torch.io.streams import open_source
    src = open_source(args.source, 0, 0)

    window = args.out is None
    if window:
        try:
            cv2.namedWindow("viewer", cv2.WINDOW_AUTOSIZE)
        except Exception:
            print("no display; use --out DIR", file=sys.stderr)
            return 1
    else:
        os.makedirs(args.out, exist_ok=True)

    n = 0
    while args.frames == 0 or n < args.frames:
        frame = src.read()
        if frame is None:
            break
        bgra = chroma_key_green(frame)
        if window:
            cv2.imshow("viewer", bgra)
            if cv2.waitKey(1) == ord("q"):
                break
        else:
            cv2.imwrite(os.path.join(args.out, f"frame{n:05d}.png"), bgra)
        n += 1
    src.close()
    print(f"viewed {n} frames", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
