"""Frame sources and sinks for the CLI (counterpart of
``backscrub_tpu/io/streams.py``).

The reference supports exactly one source (V4L2 camera via OpenCV,
app/deepseg.cc:543) and one sink (v4l2loopback write, :683).  We keep those
and add file/URI sources and file/null sinks so the pipeline runs and tests
headless (no kernel video devices needed).

URI forms for sources:  /dev/video0 | file:video.mp4 | image.png | test:
Sinks:                  /dev/video1 | file:out.mp4 | file:out.yuv | null:

MJPG (the ``mjpg:`` source, MJPG cameras, the mjpg sink) is not in the
port yet: it raises NotImplementedError naming its ROADMAP item.  OpenCV
is imported only where a file, video or camera fallback needs it.
"""

from __future__ import annotations

import sys
import threading
from typing import Callable, Optional

import numpy as np

from ..pipeline.maskgen import ROADMAP_FRAME_OPTIONS


def _no_mjpg(what: str):
    return NotImplementedError(f"{what} is not in the PyTorch port yet: "
                               f"{ROADMAP_FRAME_OPTIONS} (MJPG decode and encode)")


class LatestFrameReader:
    """Runs a blocking read/decode callable in its own thread, keeping only
    the newest result — the host-thread analog of bsio's kernel-side queue
    drain and the reference's CalcMask frame_next overwrite
    (app/deepseg.cc:272-277).

    ``read()`` blocks until a frame NEWER than the last one returned is
    available (so the consumer paces at the camera rate, like the
    reference's blocking grab), but the read happens in this thread,
    overlapped with the consumer's device dispatch instead of serialized
    with it.  ``read_fn`` returning None or raising marks EOF; read() then
    returns None.
    """

    def __init__(self, read_fn: Callable[[], Optional[np.ndarray]]):
        self._fn = read_fn
        self._cond = threading.Condition()
        self._frame: Optional[np.ndarray] = None
        self._seq = 0
        self._last = 0
        self._eof = False
        self._stop = False
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="bs-frame-reader")
        self._thread.start()

    def _run(self):
        while not self._stop:
            try:
                f = self._fn()
            except Exception as e:
                # a dying reader must be visible, not a silent EOF
                print(f"frame reader failed: {e!r}", file=sys.stderr)
                f = None
            with self._cond:
                if f is None or self._stop:
                    self._eof = True
                    self._cond.notify_all()
                    return
                self._frame = f
                self._seq += 1
                self._cond.notify_all()
        with self._cond:
            self._eof = True
            self._cond.notify_all()

    def read(self, timeout: Optional[float] = None) -> Optional[np.ndarray]:
        with self._cond:
            if not self._cond.wait_for(
                    lambda: self._seq > self._last or self._eof,
                    timeout=timeout):
                return None
            if self._seq == self._last:  # EOF with nothing newer
                return None
            self._last = self._seq
            return self._frame

    def close(self):
        self._stop = True
        # the thread may be blocked inside read_fn; the owner should close
        # the underlying device after this call to unblock it
        with self._cond:
            self._cond.notify_all()

    def join(self, timeout: float = 1.0):
        self._thread.join(timeout)


class FrameSource:
    width: int
    height: int

    def read(self) -> Optional[np.ndarray]:  # BGR u8 or None at EOF
        raise NotImplementedError

    def close(self):
        pass


class JpegSource(FrameSource):
    """The MJPG coefficient source of the JAX package: not ported yet."""

    def __init__(self, grab_jpeg=None, prefetch: bool = True):
        raise _no_mjpg("JpegSource (MJPG device decode)")


class CameraSource(FrameSource):
    """V4L2 camera through the native shim (fallback: OpenCV).

    YUYV/UYVY/NV12 cameras hand their raw payload to :meth:`read_raw`,
    uploaded verbatim and decoded on the device
    (``PipelineConfig.input_format``); :meth:`read` decodes to BGR on the
    host.  A camera that grants MJPG raises NotImplementedError: its
    device decode is not in the port yet.
    """

    def __init__(self, device: str, width: int, height: int, pixfmt: str = ""):
        from .v4l2 import V4L2Capture
        try:
            self.cap = V4L2Capture(device, width, height, pixfmt)
            self.width, self.height = self.cap.width, self.cap.height
            self._native = True
        except Exception:
            import cv2
            cap = cv2.VideoCapture(device, cv2.CAP_V4L2)
            if not cap.isOpened():
                raise OSError(f"cannot open camera {device}")
            if width:
                cap.set(cv2.CAP_PROP_FRAME_WIDTH, width)
            if height:
                cap.set(cv2.CAP_PROP_FRAME_HEIGHT, height)
            self.cap = cap
            self.width = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
            self.height = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
            self._native = False
        if self._native and self.cap.pixelformat in ("MJPG", "JPEG"):
            self.cap.close()
            raise _no_mjpg(f"an MJPG camera ({device} granted {self.cap.pixelformat})")

    @property
    def raw_format(self):
        """'yuyv'/'uyvy'/'nv12' when the camera delivers a format the device
        can ingest raw (PipelineConfig.input_format); None otherwise."""
        if not self._native:
            return None
        return {"YUYV": "yuyv", "UYVY": "uyvy",
                "NV12": "nv12"}.get(self.cap.pixelformat)

    def read(self):
        if self._native:
            return self.cap.grab_bgr()
        ok, frame = self.cap.read()
        return frame if ok else None

    def read_raw(self):
        """Raw camera bytes — (H, 2W) u8 for YUYV/UYVY, (3H/2, W) u8 for
        NV12 — uploaded verbatim, decoded on the device."""
        raw = self.cap.grab_raw()
        if self.raw_format == "nv12":
            shape = (self.height * 3 // 2, self.width)
        else:
            shape = (self.height, self.width * 2)
        # copy: grab_raw returns a view into the capture's reused buffer,
        # and the serving loop uploads asynchronously — the next grab must
        # not overwrite bytes still in flight
        return raw.reshape(shape).copy()

    def close(self):
        self.cap.close() if self._native else self.cap.release()


class FileSource(FrameSource):
    """Video file / URL / still image source (loops video at EOF)."""

    def __init__(self, path: str, width: int = 0, height: int = 0, loop: bool = True):
        import cv2
        self._cv2 = cv2
        self.loop = loop
        self._still = None
        cap = cv2.VideoCapture(path)
        ok, f1 = cap.read() if cap.isOpened() else (False, None)
        if not ok:
            raise OSError(f"cannot open source {path}")
        ok2, _ = cap.read()
        if not ok2:  # still image
            cap.release()
            self._still = f1
            self.cap = None
        else:
            cap.set(cv2.CAP_PROP_POS_FRAMES, 0)
            self.cap = cap
        h, w = f1.shape[:2]
        self.width = width or w
        self.height = height or h
        self._resize = (self.width, self.height) != (w, h)

    def read(self):
        if self._still is not None:
            frame = self._still
        else:
            ok, frame = self.cap.read()
            if not ok:
                if not self.loop:
                    return None
                self.cap.set(self._cv2.CAP_PROP_POS_FRAMES, 0)
                ok, frame = self.cap.read()
                if not ok:
                    return None
        if self._resize:
            frame = self._cv2.resize(frame, (self.width, self.height))
        return frame

    def close(self):
        if self.cap is not None:
            self.cap.release()


class SyntheticSource(FrameSource):
    """Synthetic moving pattern (like the loopback self-test,
    videoio/loopback.cc:103-144), for headless smoke runs."""

    def __init__(self, width: int = 640, height: int = 480):
        self.width, self.height = width, height
        self._i = 0
        yy, xx = np.mgrid[0:height, 0:width]
        base = np.stack([xx % 256, yy % 256, (xx + yy) % 256], axis=-1).astype(np.uint8)
        self._rows = base.reshape(height, width * 3)

    def read(self):
        t = self._i
        self._i += 1
        # u8 wraparound gives the same moving pattern without regenerating
        # grids; the shift goes on as one (3W,) vector a row: numpy's inner
        # loop then runs over a row, not over a pixel's 3 bytes
        shift = np.array([(2 * t) % 256, t % 256, (3 * t) % 256], np.uint8)
        return (self._rows + np.tile(shift, self.width)).reshape(self.height, self.width, 3)


def open_source(uri: str, width: int, height: int, pixfmt: str = "") -> FrameSource:
    if uri.startswith("test:"):
        return SyntheticSource(width or 640, height or 480)
    if uri.startswith("mjpg:"):
        raise _no_mjpg("the mjpg: source")
    if uri.startswith("/dev/"):
        return CameraSource(uri, width, height, pixfmt)
    if uri.startswith("file:"):
        uri = uri[5:]
    return FileSource(uri, width, height)


def packed_to_bgr(buf, fmt: str, width: int, height: int) -> np.ndarray:
    """Packed sink-format buffer -> BGR u8 (host-side decode for debug
    views and video-container sinks; the single source of truth for the
    per-format layout)."""
    import cv2
    buf = np.asarray(buf, np.uint8)
    if fmt == "yuyv":
        return cv2.cvtColor(buf.reshape(height, width, 2),
                            cv2.COLOR_YUV2BGR_YUY2)
    if fmt == "nv12":
        return cv2.cvtColor(buf.reshape(height * 3 // 2, width),
                            cv2.COLOR_YUV2BGR_NV12)
    if fmt == "i420":
        return cv2.cvtColor(buf.reshape(height * 3 // 2, width),
                            cv2.COLOR_YUV2BGR_I420)
    if fmt in ("bgr24", "bgr"):
        return buf.reshape(height, width, 3)
    raise ValueError(f"unknown packed format {fmt!r}")


class FrameSink:
    def write_yuyv(self, yuyv_bytes: np.ndarray):  # the packed output frame
        raise NotImplementedError

    def write_bgr(self, bgr: np.ndarray):
        raise NotImplementedError

    def close(self):
        pass


class LoopbackFrameSink(FrameSink):
    def __init__(self, device: str, width: int, height: int,
                 out_format: str = "yuyv"):
        from .v4l2 import LoopbackSink
        fourcc = {"yuyv": "YUYV", "nv12": "NV12", "i420": "YU12",
                  "bgr24": "BGR3"}[out_format]
        self.sink = LoopbackSink(device, width, height, pixel_format=fourcc)

    def write_yuyv(self, yuyv_bytes):
        self.sink.write(yuyv_bytes)

    def write_bgr(self, bgr):
        import cv2
        yuyv = cv2.cvtColor(bgr, cv2.COLOR_BGR2YUV_YUY2) if hasattr(cv2, "COLOR_BGR2YUV_YUY2") else None
        if yuyv is None:
            raise NotImplementedError("BGR->YUYV host conversion unavailable")
        self.sink.write(yuyv)

    def close(self):
        self.sink.close()


class FileFrameSink(FrameSink):
    """.yuv/.raw -> raw append of the packed frames (no OpenCV); other
    extensions -> OpenCV VideoWriter."""

    def __init__(self, path: str, width: int, height: int, fps: float = 30.0,
                 out_format: str = "yuyv"):
        self.path = path
        self.width, self.height = width, height
        self.out_format = out_format
        if path.endswith((".yuv", ".raw")):
            self._f = open(path, "wb")
            self._writer = None
        else:
            import cv2
            four = cv2.VideoWriter_fourcc(*"mp4v")
            self._writer = cv2.VideoWriter(path, four, fps, (width, height))
            self._f = None

    def write_yuyv(self, yuyv_bytes):
        if self._f is not None:
            self._f.write(np.ascontiguousarray(yuyv_bytes, np.uint8).tobytes())
            return
        self._writer.write(packed_to_bgr(yuyv_bytes, self.out_format,
                                         self.width, self.height))

    def write_bgr(self, bgr):
        if self._writer is not None:
            self._writer.write(np.asarray(bgr, np.uint8))
        else:
            raise ValueError("raw .yuv sink needs YUYV frames")

    def close(self):
        if self._f is not None:
            self._f.close()
        if self._writer is not None:
            self._writer.release()


class JpegPackingSink(FrameSink):
    """The MJPG sink of the JAX package: not ported yet."""

    def __init__(self, jpeg_info=None, qtabs=None, write_bytes=None, close=None):
        raise _no_mjpg("JpegPackingSink (MJPG device encode)")


class NullFrameSink(FrameSink):
    def __init__(self):
        self.frames = 0

    def write_yuyv(self, yuyv_bytes):
        self.frames += 1

    def write_bgr(self, bgr):
        self.frames += 1


def open_sink(uri: str, width: int, height: int, fps: float = 30.0,
              out_format: str = "yuyv") -> FrameSink:
    if out_format == "mjpg":
        raise _no_mjpg("the mjpg sink format")
    if uri.startswith("null:"):
        return NullFrameSink()
    if uri.startswith("/dev/"):
        return LoopbackFrameSink(uri, width, height, out_format=out_format)
    if uri.startswith("file:"):
        uri = uri[5:]
    return FileFrameSink(uri, width, height, fps, out_format=out_format)
