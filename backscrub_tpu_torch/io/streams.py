"""Frame sources and sinks for the CLI (counterpart of
``backscrub_tpu/io/streams.py``).

The reference supports exactly one source (V4L2 camera via OpenCV,
app/deepseg.cc:543) and one sink (v4l2loopback write, :683).  We keep those
and add file/URI sources and file/null sinks so the pipeline runs and tests
headless (no kernel video devices needed).

URI forms for sources:  /dev/video0 | file:video.mp4 | image.png | test: | mjpg:
Sinks:                  /dev/video1 | file:out.mp4 | file:out.yuv | null:

MJPG: a camera that grants MJPG, and the synthetic ``mjpg:`` camera, are
:class:`JpegSource` objects: only the Huffman entropy decode runs on the host
(``io/jpeg.py``), the rest on the card (``PipelineConfig(input_format=
"mjpg")``).  The mjpg sink (:class:`JpegPackingSink`) Huffman-packs the
coefficients the card encodes.  OpenCV is imported only where a file,
video or camera fallback needs it, or for a camera's non-baseline JPEG.
"""

from __future__ import annotations

import sys
import threading
from typing import Callable, Optional

import numpy as np


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
    """MJPG stream -> coefficient frames for the card's decode.

    Wraps a ``grab_jpeg()`` callable (camera DQBUF, file reader, ...)
    returning one JPEG per call, or None at the end.  The Huffman entropy
    decode runs in a :class:`LatestFrameReader` thread (``prefetch``);
    ``read()`` returns ``(coefs, qtabs)`` ready for upload, for
    ``PipelineConfig(input_format="mjpg", jpeg_info=self.jpeg_info)``.

    The first frame is decoded at construction to fix the static geometry
    (``jpeg_info``) before the pipeline is built, then delivered as the
    first ``read()``.  A stream the entropy codec does not take raises
    :class:`~backscrub_tpu_torch.io.jpeg.JpegUnsupported`.
    """

    def __init__(self, grab_jpeg, prefetch: bool = True):
        from .jpeg import JpegEntropyDecoder
        self._grab = grab_jpeg
        self._dec = JpegEntropyDecoder()
        first = grab_jpeg()
        if first is None:
            raise OSError("MJPG source produced no frames")
        self._first = self._decode(first)
        self.jpeg_info = self._dec.info
        self.width, self.height = self.jpeg_info.width, self.jpeg_info.height
        self._reader = LatestFrameReader(self._read_sync) if prefetch else None

    def _decode(self, jpg: bytes):
        coefs, qtabs = self._dec.decode(jpg)
        # copy: the decoder reuses its buffers, and the serving loop
        # uploads asynchronously — the next decode must not overwrite
        # bytes still in flight; the tables as the int32 the card reads
        return tuple(c.copy() for c in coefs), qtabs.astype(np.int32)

    def _read_sync(self):
        jpg = self._grab()
        if jpg is None:
            return None
        return self._decode(jpg)

    def read(self):
        if self._first is not None:
            f, self._first = self._first, None
            return f
        if self._reader is not None:
            return self._reader.read()
        return self._read_sync()

    def close(self):
        if self._reader is not None:
            self._reader.close()
            self._reader.join()


class CameraSource(FrameSource):
    """V4L2 camera through the native shim (fallback: OpenCV).

    A camera that grants MJPG is read through a :class:`JpegSource`
    (``jpeg_info`` set, ``read()`` yields ``(coefs, qtabs)`` for
    ``PipelineConfig(input_format="mjpg")``): only the entropy decode runs
    on the host.  Its stream decodes on the host (cv2.imdecode, in a
    :class:`LatestFrameReader` thread) only where it is not baseline JPEG
    (progressive, arithmetic, 12-bit, CMYK), with a note on stderr; without
    OpenCV that raises.  YUYV/UYVY/NV12 cameras hand their raw payload to
    :meth:`read_raw`, uploaded verbatim and decoded on the device;
    :meth:`read` decodes those to BGR on the host.
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
        self.jpeg_info = None
        self._jpeg: Optional[JpegSource] = None
        self._reader: Optional[LatestFrameReader] = None
        if self._native and self.cap.pixelformat in ("MJPG", "JPEG"):
            from .jpeg import JpegUnsupported
            try:
                self._jpeg = JpegSource(self._grab_jpeg)
                self.jpeg_info = self._jpeg.jpeg_info
            except JpegUnsupported as e:
                import cv2  # noqa: F401  (the host decode needs OpenCV: raise here without it)
                print(f"MJPG stream of {device} is not baseline JPEG ({e}); decoding it "
                      "on the host", file=sys.stderr)
                self._reader = LatestFrameReader(self.cap.grab_bgr)
            except BaseException:
                self.cap.close()
                raise

    def _grab_jpeg(self):
        return self.cap.grab_raw().tobytes()

    @property
    def raw_format(self):
        """'yuyv'/'uyvy'/'nv12' when the camera delivers a format the device
        can ingest raw (PipelineConfig.input_format); None otherwise."""
        if not self._native:
            return None
        return {"YUYV": "yuyv", "UYVY": "uyvy",
                "NV12": "nv12"}.get(self.cap.pixelformat)

    def read(self):
        if self._jpeg is not None:
            return self._jpeg.read()
        if self._reader is not None:
            return self._reader.read()
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
        readers = [r for r in (self._reader, self._jpeg and self._jpeg._reader) if r]
        for r in readers:
            r.close()
        # closing the device unblocks a reader thread stuck in grab
        self.cap.close() if self._native else self.cap.release()
        for r in readers:
            r.join()


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


class SyntheticJpegCamera:
    """The ``mjpg:`` camera's frames: the moving test pattern JPEG-encoded
    at quality 90, 4:2:0, by the port's encoder (``pipeline/jpeg_enc.py``,
    on the CPU) and the host packer — byte for byte what
    ``cv2.imencode`` writes for the JAX package's ``mjpg:`` camera, with no
    OpenCV."""

    QUALITY = 90

    def __init__(self, width: int, height: int):
        import torch
        from ..pipeline.jpeg_enc import stream_qtabs
        from .jpeg import JpegHuffmanEncoder, make_info
        self.pattern = SyntheticSource(width, height)
        self.info = make_info(width, height)
        qt = stream_qtabs(self.QUALITY)
        self._qtabs = torch.from_numpy(qt.astype(np.int32))
        self._packer = JpegHuffmanEncoder(self.info, qt)

    def __call__(self) -> bytes:
        import torch
        from ..pipeline.jpeg_enc import encode_jpeg_coefs
        with torch.no_grad():
            coefs = encode_jpeg_coefs(torch.from_numpy(self.pattern.read()), self._qtabs,
                                      self.info)
        return self._packer.encode([c.numpy() for c in coefs])


def open_source(uri: str, width: int, height: int, pixfmt: str = "") -> FrameSource:
    if uri.startswith("test:"):
        return SyntheticSource(width or 640, height or 480)
    if uri.startswith("mjpg:"):
        # synthetic MJPG camera: drives the card's decode headless
        return JpegSource(SyntheticJpegCamera(width or 640, height or 480))
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
    """MJPG sink: takes the pipeline's coefficient tuples
    (``PipelineConfig(output_format="mjpg")``), Huffman-packs them
    (``io/jpeg.py:JpegHuffmanEncoder``, the only host work) and hands the
    JPEG bytes to ``write_bytes`` (a raw file appender or an MJPG
    v4l2loopback writer; concatenated JPEGs are the MJPEG stream format)."""

    def __init__(self, jpeg_info, qtabs, write_bytes, close=None):
        from .jpeg import JpegHuffmanEncoder
        self._enc = JpegHuffmanEncoder(jpeg_info, qtabs)
        self._write = write_bytes
        self._close = close
        self.last_jpeg: Optional[bytes] = None

    def write_yuyv(self, coefs):  # the pipeline's output rides the generic slot
        jpg = self._enc.encode(coefs)
        self.last_jpeg = jpg
        self._write(jpg)

    def close(self):
        if self._close:
            self._close()


class NullFrameSink(FrameSink):
    def __init__(self):
        self.frames = 0

    def write_yuyv(self, yuyv_bytes):
        self.frames += 1

    def write_bgr(self, bgr):
        self.frames += 1


def open_sink(uri: str, width: int, height: int, fps: float = 30.0,
              out_format: str = "yuyv", jpeg_info=None, jpeg_qtabs=None) -> FrameSink:
    if uri.startswith("null:"):
        return NullFrameSink()
    if out_format == "mjpg":
        if jpeg_info is None or jpeg_qtabs is None:
            raise ValueError("mjpg sink needs jpeg_info/jpeg_qtabs "
                             "(FramePipeline.out_jpeg_info/out_jpeg_qtabs)")
        if uri.startswith("/dev/"):
            from .v4l2 import LoopbackSink
            lb = LoopbackSink(uri, width, height, pixel_format="MJPG")
            return JpegPackingSink(jpeg_info, jpeg_qtabs, lb.write_bytes, lb.close)
        if uri.startswith("file:"):
            uri = uri[5:]
        f = open(uri, "wb")
        return JpegPackingSink(jpeg_info, jpeg_qtabs, f.write, f.close)
    if uri.startswith("/dev/"):
        return LoopbackFrameSink(uri, width, height, out_format=out_format)
    if uri.startswith("file:"):
        uri = uri[5:]
    return FileFrameSink(uri, width, height, fps, out_format=out_format)
