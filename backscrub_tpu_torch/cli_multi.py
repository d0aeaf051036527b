"""Multi-camera CLI on the PyTorch port: N capture -> virtual-camera
streams in one process on one card, or over a mesh of devices
(counterpart of ``backscrub_tpu/cli_multi.py``; installed as
``backscrub-multi-torch``).

The reference needs one ``backscrub`` process a camera
(app/deepseg.cc:627-804).  Here every stream rides the batched steps of
:class:`MultiGeometryServer`: streams bucket by (model, geometry), each
bucket one batched step a tick (one launch of each kernel for all of its
streams of a device).

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
with N > 1 serves over ``make_mesh(min(N, devices))`` (``parallel/mesh.py``:
the JAX split, so N = 2 gives a (1, 2) mesh), devices being the cards, or
N on the CPU: where that is above 1 the CLI spawns its ranks itself
(``run_world``, one process a device), and each rank runs this CLI over the
same streams, serving its slots of each bucket.  Rank 0 opens each source
once to learn its geometry and closes it; then a source opens at its first
read, and a sink at its first frame, on the one rank that reads and
delivers that stream (a camera streams to one opener).  NCCL puts no two
ranks on one card, so on a one-card machine the mesh is (1, 1), in this
process.
"""

from __future__ import annotations

import sys
import time
from typing import List, Optional

from .cli import parse_geometry
from .models.specs import DEFAULT_MODEL

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
    cfg = dict(streams=[], model=DEFAULT_MODEL,
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


class _FirstReadSource:
    """A source opened at its first read: on a mesh only the rank that
    reads a stream opens its source.  ``geometry`` is (width, height,
    jpeg_info) as rank 0's probe found it; the open must give it again."""

    def __init__(self, uri: str, width: int, height: int, geometry: tuple):
        self.uri, self._ask = uri, (width, height)
        self.width, self.height, self.jpeg_info = geometry
        self._src = None

    def read(self):
        if self._src is None:
            from .io.streams import open_source
            self._src = open_source(self.uri, *self._ask)
            got = (self._src.width, self._src.height, getattr(self._src, "jpeg_info", None))
            if got != (self.width, self.height, self.jpeg_info):
                raise OSError(f"{self.uri}: opened as {got[:2]}, probed as "
                              f"{(self.width, self.height)}")
        return self._src.read()

    def close(self) -> None:
        if self._src is not None:
            self._src.close()


def _probe(streams: List[dict]) -> tuple:
    """On rank 0 of the world: open each stream's source, note its
    (width, height, jpeg_info), close it.  Every rank gets the list, or
    the error that stopped it (a collective: every rank calls it)."""
    import torch.distributed as dist
    from .io.streams import open_source
    box = [None]
    if dist.get_rank() == 0:
        geos = []
        try:
            for s in streams:
                src = open_source(s["src"], *s["geo"])
                try:
                    geos.append((src.width, src.height, getattr(src, "jpeg_info", None)))
                finally:
                    src.close()
            box[0] = (geos, None)
        except OSError as e:
            box[0] = (None, str(e))
    dist.broadcast_object_list(box, 0)
    return box[0]


class _FirstWriteSink:
    """A sink opened at its first frame: on a mesh only the rank that
    delivers a stream opens its sink."""

    def __init__(self, uri: str, width: int, height: int):
        self.uri, self.width, self.height = uri, width, height
        self._sink = None

    def write_yuyv(self, frame) -> None:
        if self._sink is None:
            from .io.streams import open_sink
            self._sink = open_sink(self.uri, self.width, self.height)
        self._sink.write_yuyv(frame)

    def close(self) -> None:
        if self._sink is not None:
            self._sink.close()


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

    from . import _build
    try:
        dev = _build.resolve_device(device)
    except RuntimeError as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    if cfg["data_axis"] > 1:
        from .parallel.mesh import run_world
        return run_world(_serve_rank, cfg["data_axis"], dev, cfg, dev.type)
    return _serve(cfg, dev, None)


def _serve_rank(cfg: dict, dev_type: str) -> int:
    """One rank of a ``--data-axis`` world: the CLI over the world's mesh."""
    import torch.distributed as dist
    from .parallel.mesh import make_mesh
    mesh = make_mesh(dist.get_world_size(), device=dev_type)
    return _serve(cfg, mesh.device, mesh)


def _serve(cfg: dict, dev, mesh) -> int:
    """Serve ``cfg``'s streams on ``dev``, or over ``mesh`` (then every
    rank runs this with the same streams; rank 0 speaks)."""
    import torch
    import torch.distributed
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

    first = mesh is None or torch.distributed.get_rank() == 0
    if mesh is not None:
        geos, err = _probe(cfg["streams"])
        if err is not None:
            if first:
                print(f"Error: {err}", file=sys.stderr)
            return 1
    sources, sinks, streams = [], [], []
    try:
        for i, (s, smodel) in enumerate(zip(cfg["streams"], models)):
            w, h = s["geo"]
            src = (open_source(s["src"], w, h) if mesh is None
                   else _FirstReadSource(s["src"], w, h, geos[i]))
            sources.append(src)
            sink = (open_sink(s["sink"], src.width, src.height) if mesh is None
                    else _FirstWriteSink(s["sink"], src.width, src.height))
            sinks.append(sink)
            if (src.width, src.height) != (w, h) and first:
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
        model_path, PipelineConfig(width=0, height=0), streams, mesh, device=dev,
        threaded=cfg["threaded"], depth=cfg["depth"],
        stall_timeout=cfg["stall_timeout"] if cfg["threaded"] else None,
        compute_dtype=torch.bfloat16 if cfg["bf16"] else torch.float32,
        precision="default" if cfg["bf16"] else None)   # None: the family's default
    if cfg["debug"] and first:
        name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
        shape = mesh.shape if mesh is not None else {"data": 1, "model": 1}
        print(f"model: {model_path}\nstreams: {len(streams)} in {server.n_groups} "
              f"(model, geometry) bucket(s) on {dev} {name}, mesh {shape}", file=sys.stderr)

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
    if ticks >= 0 and first:
        print(f"served {ticks} ticks x {len(streams)} streams "
              f"({ticks * len(streams) / max(dt, 1e-9):.1f} aggregate fps)", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
