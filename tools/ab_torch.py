#!/usr/bin/env python3
"""One-variant A/B probe of the port for per-model experiments.

The counterpart of ``tools/ab.py`` for ``backscrub_tpu_torch``.  Measures
the 720p step (``FramePipeline.step``, YUYV out, the EMA carried) of ONE
(model, precision, edge, mega) variant and dumps parity artifacts for
cross-variant diffs:

- host ms a frame from loops of steps whose outputs fold into a checksum
  on the device (so that no step can be skipped), synchronized once a
  window: the median and the best of WINDOWS windows of ``--iters`` steps
  in all;
- device busy a frame and the idle share of a profiled window of up to
  PROFILED steps, read through
  ``backscrub_tpu_torch/utils/roofline.py:window_rows``;
- ``<tmp>/ab_torch_<model>_<tag>_mask.npy``: the frame-size u8 mask of
  the image (``--image``, by default ``assets/portrait.jpg``, which
  ``tools/gen_assets.py`` writes) from a fresh EMA;
- ``<tmp>/ab_torch_<model>_<tag>_arg.npy``: the model-size decode map of
  the classic stages (argmax class for deeplab's 21 channels, out1 > out0
  for two channels, the channel > 0.5 otherwise).

``<tmp>`` is ``--out-dir``, by default the system's temporary directory.
The image is decoded by the port's JPEG path (the host's entropy decode,
then ``bs_jpeg_decode`` on the card or its plain twin) and taken as it is
at the step's size; at another size it is resized by the port's
cv2-exact bilinear (``pipeline/image.py:resize_bilinear_u8_exact``).  No
OpenCV.  Run each variant in its own process (``tools/ab_driver_torch.sh``).

Usage: python tools/ab_torch.py --model deeplab --precision high --edge auto --tag h
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from roofline_torch import MODEL_SHORT, REPO, card, model_path, profiled, resolve  # noqa: E402

PORTRAIT = os.path.join(REPO, "assets", "portrait.jpg")
WINDOWS, PROFILED = 5, 20


def load_frame(path: str, w: int, h: int, device):
    """The JPEG at ``path`` as a (h, w, 3) BGR u8 tensor on ``device``."""
    import torch
    from backscrub_tpu_torch.io.jpeg import JpegEntropyDecoder
    from backscrub_tpu_torch.ops.jpeg_kernels import decode_jpeg_bgr
    from backscrub_tpu_torch.pipeline.image import resize_bilinear_u8_exact
    with open(path, "rb") as fh:
        jpg = fh.read()
    dec = JpegEntropyDecoder()
    coefs, qtabs = dec.decode(jpg)
    with torch.no_grad():
        img = decode_jpeg_bgr([torch.from_numpy(c.copy()).to(device) for c in coefs],
                              torch.from_numpy(qtabs.astype(np.int32)).to(device), dec.info)
        if tuple(img.shape[:2]) != (h, w):
            img = resize_bilinear_u8_exact(img, h, w)
    return img.contiguous()


def decode_map(out: np.ndarray) -> np.ndarray:
    """The model output (oh, ow, C) as the reference's decode map."""
    if out.shape[-1] > 2:
        return np.argmax(out, -1).astype(np.int32)
    if out.shape[-1] == 2:
        return (out[..., 1] > out[..., 0]).astype(np.int32)
    return (out[..., 0] > 0.5).astype(np.int32)


def host_ms(step, iters: int, windows: int, device: str):
    """Host ms a frame of ``windows`` windows of ``iters // windows`` steps
    each, every output folded into a checksum on the device and one
    synchronize a window: (median, best, checksum)."""
    import torch
    n = max(1, iters // windows)
    acc = torch.zeros((), dtype=torch.int64, device=device)
    res = []
    for _ in range(windows):
        if device == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            acc += step().sum(dtype=torch.int64)
        if device == "cuda":
            torch.cuda.synchronize()
        res.append((time.perf_counter() - t0) * 1e3 / n)
    return float(np.median(res)), min(res), int(acc)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="deeplab", help=f"{', '.join(MODEL_SHORT)} or a path")
    ap.add_argument("--precision", default="highest", choices=("highest", "high", "default"))
    ap.add_argument("--edge", default="auto", choices=["auto", "off"])
    ap.add_argument("--mega", default="auto", choices=["auto", "off"],
                    help="the body plans (off: the graph executor over the body)")
    ap.add_argument("--iters", type=int, default=300)
    ap.add_argument("--tag", default="base")
    ap.add_argument("--skip-parity", action="store_true")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--size", default="1280x720", help="the step's WxH")
    ap.add_argument("--image", default=PORTRAIT, help="the parity image (a JPEG)")
    ap.add_argument("--out-dir", default=tempfile.gettempdir())
    a = ap.parse_args(argv)

    import torch
    from backscrub_tpu_torch.pipeline.frame import FramePipeline, PipelineConfig
    from backscrub_tpu_torch.utils import roofline as rl
    dev = resolve(a.device)
    w, h = (int(v) for v in a.size.lower().split("x"))
    cfg = PipelineConfig(width=w, height=h,
                         edge_fused=False if a.edge == "off" else None,
                         edge_mega=False if a.mega == "off" else None)
    pipe = FramePipeline(model_path(a.model), cfg, device=dev, precision=a.precision)
    rng = np.random.default_rng(0)
    frames = [torch.from_numpy(rng.integers(0, 256, (h, w, 3), np.uint8)).to(dev)
              for _ in range(2)]
    bg = torch.from_numpy(rng.integers(0, 256, (h, w, 3), np.uint8)).to(dev)
    state = {"i": 0}

    @torch.no_grad()
    def step():
        state["i"] += 1
        return pipe.step(frames[state["i"] % 2], bg)[0]

    for _ in range(3):
        step()
    med, best, checksum = host_ms(step, a.iters, WINDOWS, a.device)
    n_prof = min(PROFILED, max(1, a.iters))
    prof, window = profiled(step, n_prof, a.device)
    _, busy = rl.window_rows(prof, a.device)
    mg = pipe.maskgen
    rec = {"tool": "ab_torch", "model": a.model, "tag": a.tag, "precision": mg.precision,
           "edge": a.edge, "mega": a.mega, "size": f"{w}x{h}", "fused": mg.edge is not None,
           "dots": [p.dots for p in mg.edge.plans] if mg.edge is not None else None,
           "ms_per_frame_median": med, "ms_per_frame_best": best,
           "fps_median": 1e3 / med, "fps_best": 1e3 / best, "checksum": checksum,
           "busy_ms_per_frame": busy / 1e3 / n_prof,
           "idle_share": max(0.0, 1.0 - busy / window), "clock": "device"
           if a.device == "cuda" else "host", "device": card(a.device)}

    if not a.skip_parity:
        frame = load_frame(a.image, w, h, dev)
        with torch.no_grad():
            pipe.reset()
            mask = pipe.step(frame)[1].cpu().numpy()
            out = mg._infer(mg._pre(frame)).float().cpu().numpy()
        stem = os.path.join(a.out_dir, f"ab_torch_{a.model}_{a.tag}")
        dec = decode_map(out)
        np.save(f"{stem}_mask.npy", mask)
        np.save(f"{stem}_arg.npy", dec)
        rec.update(image=a.image, mask_mean=float(mask.mean()),
                   decode_person_frac=float((dec != dec.max()).mean()),
                   dumps=[f"{stem}_mask.npy", f"{stem}_arg.npy"])
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
