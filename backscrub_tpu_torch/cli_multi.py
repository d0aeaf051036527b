"""Multi-camera CLI on the PyTorch port: N capture -> virtual-camera
streams in one process on one card (counterpart of
``backscrub_tpu/cli_multi.py``; installed as ``backscrub-multi-torch``).

The reference needs one ``backscrub`` process a camera
(app/deepseg.cc:627-804).  Here every stream rides the batched steps of
:class:`MultiGeometryServer`: streams bucket by (model, geometry), each
bucket one batched step a tick (one launch of each kernel for all of its
streams), all on one card.

Usage:
  python -m backscrub_tpu_torch.cli_multi [-m MODEL] [-b BACKGROUND] [-d]
      [--frames N] [--threaded] [--depth N] [--bf16] [--stall-timeout S]
      --stream src=/dev/video0,sink=/dev/video2,geo=1280x720
      --stream src=test:,sink=file:/tmp/b.yuv,geo=640x480,model=m.tflite

Stream spec keys: ``src`` (URI: /dev/videoN | file:PATH | test: | mjpg:),
``sink`` (URI: /dev/videoN | file:PATH | null:), ``geo`` (WxH), optional
``bg`` (a still image; overrides the shared -b for this stream) and
``model`` (a .tflite name or path; overrides the shared -m).  Backgrounds
are static stills here.  ``--bf16`` runs every bucket's CNN in bfloat16
with one-pass bf16 dots, as the port's ``cli.py`` does.  ``--data-axis N``
with N > 1 asks for several cards, which the port does not serve yet
(ROADMAP queue 1 item 8): it is refused.
"""

from __future__ import annotations

import sys
import time
from typing import List, Optional

from .cli import parse_geometry

USAGE = __doc__


def parse_stream_spec(spec: str) -> dict:
    out = {}
    for part in spec.split(","):
        if "=" not in part:
            raise ValueError(f"stream spec part {part!r} is not key=value")
        k, v = part.split("=", 1)
        if k not in ("src", "sink", "geo", "bg", "model"):
            raise ValueError(f"unknown stream spec key {k!r}")
        out[k] = v
    for req in ("src", "sink", "geo"):
        if req not in out:
            raise ValueError(f"stream spec missing {req!r}: {spec!r}")
    geo = parse_geometry(out["geo"])
    if geo is None:
        raise ValueError(f"bad geo {out['geo']!r} (expected WxH)")
    out["geo"] = geo
    return out


def parse_args(argv: List[str]) -> Optional[dict]:
    cfg = dict(streams=[], model="selfiesegmentation_mlkit-256x256-2021_01_19-v1215.f16.tflite",
               background=None, debug=0, frames=0, threaded=False, depth=2,
               data_axis=1, bf16=False, stall_timeout=5.0)
    i = 0
    while i < len(argv):
        a = argv[i]

        def val():
            nonlocal i
            i += 1
            if i >= len(argv):
                raise ValueError(f"missing value for {a}")
            return argv[i]

        if a == "-?":
            return None
        elif a == "--stream":
            cfg["streams"].append(parse_stream_spec(val()))
        elif a == "-m":
            cfg["model"] = val()
        elif a == "-b":
            cfg["background"] = val()
        elif a == "-d":
            cfg["debug"] += 1
        elif a == "--frames":
            cfg["frames"] = int(val())
        elif a == "--threaded":
            cfg["threaded"] = True
        elif a == "--depth":
            cfg["depth"] = int(val())
        elif a == "--data-axis":
            cfg["data_axis"] = int(val())
        elif a == "--bf16":
            cfg["bf16"] = True
        elif a == "--stall-timeout":
            cfg["stall_timeout"] = float(val())
        else:
            raise ValueError(f"unknown argument {a!r}")
        i += 1
    if not cfg["streams"]:
        raise ValueError("need at least one --stream")
    if cfg["data_axis"] > 1:
        raise ValueError(f"--data-axis {cfg['data_axis']}: the port serves one card; "
                         "serving across cards is ROADMAP queue 1 item 8 (multi-device, "
                         "on torch.distributed)")
    return cfg


def _load_background(name: Optional[str], w: int, h: int):
    """A still background resized to (h, w, 3) BGR u8, or None (green),
    with a warning when ``name`` is given but cannot be read (OpenCV is
    imported only here)."""
    if not name:
        return None
    import cv2
    from .models.specs import resolve_path
    p = resolve_path(name, "backgrounds")
    img = cv2.imread(p) if p else None
    if img is None:
        print(f"Warning: could not load background {name!r}, using green", file=sys.stderr)
        return None
    return cv2.resize(img, (w, h))


def main(argv: Optional[List[str]] = None, *, device="cuda") -> int:
    """Run the CLI; ``device`` is the torch device the buckets run on
    (tests pass "cpu")."""
    argv = sys.argv[1:] if argv is None else argv
    try:
        cfg = parse_args(argv)
    except ValueError as e:
        print(f"Error: {e}", file=sys.stderr)
        print(USAGE, file=sys.stderr)
        return 1
    if cfg is None:
        print(USAGE, file=sys.stderr)
        return 1

    import torch
    from . import _build
    try:
        dev = _build.resolve_device(device)
    except RuntimeError as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    from .io.streams import open_sink, open_source
    from .models.specs import resolve_model_path
    from .pipeline.frame import PipelineConfig
    from .runtime.multistream import MultiGeometryServer

    try:
        model_path = resolve_model_path(cfg["model"])
        models = [resolve_model_path(s["model"]) if s.get("model") else None
                  for s in cfg["streams"]]
    except FileNotFoundError as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1

    sources, sinks, streams = [], [], []
    try:
        for s, smodel in zip(cfg["streams"], models):
            w, h = s["geo"]
            src = open_source(s["src"], w, h)
            sources.append(src)
            sink = open_sink(s["sink"], src.width, src.height)
            sinks.append(sink)
            if (src.width, src.height) != (w, h):
                print("Warning: capture device geometry changed from requested values.",
                      file=sys.stderr)
                w, h = src.width, src.height
            bg = _load_background(s.get("bg", cfg["background"]), w, h)
            # MJPG cameras deliver entropy-decoded coefficients; their
            # bucket decodes on the card
            streams.append((src.read, sink.write_yuyv, w, h, bg,
                            getattr(src, "jpeg_info", None), smodel))
    except OSError as e:
        print(f"Error: {e}", file=sys.stderr)
        for s_ in sources:
            s_.close()
        for k in sinks:
            k.close()
        return 1

    server = MultiGeometryServer(
        model_path, PipelineConfig(width=0, height=0), streams, device=dev,
        threaded=cfg["threaded"], depth=cfg["depth"],
        stall_timeout=cfg["stall_timeout"] if cfg["threaded"] else None,
        compute_dtype=torch.bfloat16 if cfg["bf16"] else torch.float32,
        precision="default" if cfg["bf16"] else None)   # None: the family's default
    if cfg["debug"]:
        name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
        print(f"model: {model_path}\nstreams: {len(streams)} in {server.n_groups} "
              f"(model, geometry) bucket(s) on {dev} {name}", file=sys.stderr)

    t0 = time.perf_counter()
    try:
        ticks = server.run(frames=cfg["frames"])
    except KeyboardInterrupt:
        ticks = -1
    finally:
        for s_ in sources:
            s_.close()
        for k in sinks:
            k.close()
    dt = time.perf_counter() - t0
    if ticks >= 0:
        print(f"served {ticks} ticks x {len(streams)} streams "
              f"({ticks * len(streams) / max(dt, 1e-9):.1f} aggregate fps)", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
