"""ctypes bindings to the native bsio shim (``native/bsio.cc``), the
counterpart of ``backscrub_tpu/io/v4l2.py``.

Replaces videoio/loopback.{h,cc} (loopback_init/loopback_free + raw write)
and the reference's OpenCV CAP_V4L2 capture path with a thin C ABI: the
frame pipeline runs on the card, this layer only moves bytes through
kernel V4L2 buffers.  The library is loaded as ``native/`` builds it;
nothing here builds it.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np

_LIB = None


def _find_lib() -> Optional[str]:
    here = os.path.dirname(os.path.abspath(__file__))
    repo = os.path.dirname(os.path.dirname(here))
    for cand in [
        os.environ.get("BSIO_LIB", ""),
        os.path.join(repo, "native", "build", "libbsio.so"),
        os.path.join(here, "libbsio.so"),
        "libbsio.so",
    ]:
        if cand and (os.path.exists(cand) or os.path.sep not in cand):
            return cand
    return None


def load_bsio() -> ctypes.CDLL:
    global _LIB
    if _LIB is not None:
        return _LIB
    path = _find_lib()
    try:
        if path is None:
            raise OSError("no candidate path")
        lib = ctypes.CDLL(path)
    except OSError as e:
        # the bare-soname fallback makes _find_lib never return None, so
        # the dlopen failure is the real "not found" signal
        raise RuntimeError(
            "libbsio.so not found — build it with: cmake -S native -B "
            f"native/build && cmake --build native/build ({e})") from None
    try:
        lib.bsio_loopback_init_fmt.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                               ctypes.c_int, ctypes.c_uint32]
        lib.bsio_loopback_init_fmt.restype = ctypes.c_int
    except AttributeError:
        raise RuntimeError(
            f"{path} is a stale build missing bsio_loopback_init_fmt — "
            "rebuild with: cmake --build native/build") from None
    lib.bsio_loopback_init.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int]
    lib.bsio_loopback_init.restype = ctypes.c_int
    lib.bsio_loopback_write.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int64]
    lib.bsio_loopback_write.restype = ctypes.c_int
    lib.bsio_loopback_free.argtypes = [ctypes.c_int]
    lib.bsio_loopback_free.restype = ctypes.c_int
    lib.bsio_cap_open.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
                                  ctypes.POINTER(ctypes.c_int), ctypes.c_uint32]
    lib.bsio_cap_open.restype = ctypes.c_void_p
    lib.bsio_cap_grab.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]
    lib.bsio_cap_grab.restype = ctypes.c_int64
    lib.bsio_cap_pixelformat.argtypes = [ctypes.c_void_p]
    lib.bsio_cap_pixelformat.restype = ctypes.c_uint32
    lib.bsio_cap_close.argtypes = [ctypes.c_void_p]
    lib.bsio_cap_close.restype = ctypes.c_int
    lib.bsio_version.restype = ctypes.c_char_p
    _LIB = lib
    return lib


def fourcc(code: str) -> int:
    """'YUYV'/'MJPG' or 8-hex-digit form ('47504A4D') -> packed fourcc int
    (fourCcFromString, app/deepseg.cc:54-77: <=4 chars are space-padded and
    upper-cased; exactly 8 chars parse as a hex integer)."""
    if len(code) == 8:
        return int(code, 16)
    code = (code.upper() + "    ")[:4]
    return (ord(code[0]) | (ord(code[1]) << 8) | (ord(code[2]) << 16)
            | (ord(code[3]) << 24))


# bytes per pixel numerator/denominator per supported output format
# (MJPG is compressed: framesize is a per-frame maximum, not fixed — 4
# bytes/px headroom so jpegq:95+/high-entropy frames aren't rejected;
# must match bsio.cc's MJPG sizeimage)
_FORMAT_BYTES = {"YUYV": (2, 1), "NV12": (3, 2), "YU12": (3, 2),
                 "BGR3": (3, 1), "RGB3": (3, 1), "MJPG": (4, 1)}


class LoopbackSink:
    """v4l2loopback writer: loopback_init/free + framed write()s.

    ``pixel_format``: 'YUYV' (default, 4:2:2), 'NV12' or 'YU12' (I420,
    both 4:2:0, 1.5 bytes/px), 'BGR3'/'RGB3' (raw 24-bit), or 'MJPG'
    (compressed; variable-length frames via :meth:`write_bytes`)."""

    def __init__(self, device: str, width: int, height: int,
                 pixel_format: str = "YUYV"):
        self.lib = load_bsio()
        self.width, self.height = width, height
        self.compressed = pixel_format.upper() == "MJPG"
        try:
            num, den = _FORMAT_BYTES[pixel_format.upper()]
        except KeyError:
            raise ValueError(f"unsupported loopback format {pixel_format!r}; "
                             f"supported: {sorted(_FORMAT_BYTES)}") from None
        self.framesize = width * height * num // den
        fd = self.lib.bsio_loopback_init_fmt(device.encode(), width, height,
                                             fourcc(pixel_format))
        if fd < 0:
            raise OSError(-fd, f"loopback_init({device}) failed: {os.strerror(-fd)}")
        self.fd = fd

    def write(self, yuyv: np.ndarray) -> None:
        buf = np.ascontiguousarray(yuyv, dtype=np.uint8)
        if not self.compressed and buf.nbytes != self.framesize:
            raise ValueError(f"frame is {buf.nbytes} bytes, expected {self.framesize}")
        rc = self.lib.bsio_loopback_write(self.fd, buf.ctypes.data, buf.nbytes)
        if rc < 0:
            raise OSError(-rc, f"loopback write failed: {os.strerror(-rc)}")

    def write_bytes(self, data: bytes) -> None:
        """Variable-length frame write (compressed formats, e.g. MJPG;
        sizeimage set at init is the per-frame maximum).

        A frame exceeding sizeimage is DROPPED with a warning rather than
        raised: one pathological high-entropy frame must not kill a live
        stream mid-run (the kernel would reject the oversized write anyway;
        consumers see a skipped frame, same as a capture-side drop)."""
        if len(data) > self.framesize:
            import sys
            print(f"warning: dropping {len(data)}-byte compressed frame "
                  f"> sizeimage {self.framesize} (raise via larger geometry "
                  "or lower -p jpegq)", file=sys.stderr)
            return
        buf = np.frombuffer(data, np.uint8)
        rc = self.lib.bsio_loopback_write(self.fd, buf.ctypes.data, buf.nbytes)
        if rc < 0:
            raise OSError(-rc, f"loopback write failed: {os.strerror(-rc)}")

    def close(self):
        if self.fd >= 0:
            self.lib.bsio_loopback_free(self.fd)
            self.fd = -1

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class V4L2Capture:
    """mmap-streaming camera capture with latest-frame-wins dequeue."""

    def __init__(self, device: str, width: int = 0, height: int = 0,
                 pixfmt: str = ""):
        self.lib = load_bsio()
        w = ctypes.c_int(width)
        h = ctypes.c_int(height)
        self.handle = self.lib.bsio_cap_open(device.encode(), ctypes.byref(w),
                                             ctypes.byref(h),
                                             fourcc(pixfmt) if pixfmt else 0)
        if not self.handle:
            raise OSError(f"cannot open capture device {device}")
        self.width, self.height = w.value, h.value
        pf = self.lib.bsio_cap_pixelformat(self.handle)
        self.pixelformat = bytes([pf & 0xFF, (pf >> 8) & 0xFF, (pf >> 16) & 0xFF,
                                  (pf >> 24) & 0xFF]).decode(errors="replace")
        self._buf = np.empty(self.width * self.height * 4, np.uint8)

    def grab_raw(self) -> np.ndarray:
        """Newest raw frame payload (YUYV/MJPG bytes, in the camera's format)."""
        n = self.lib.bsio_cap_grab(self.handle, self._buf.ctypes.data, self._buf.nbytes)
        if n < 0:
            raise OSError(-n, f"capture grab failed: {os.strerror(-int(n))}")
        return self._buf[:n]

    def grab_bgr(self) -> np.ndarray:
        """Newest frame decoded to BGR u8 (host-side decode for MJPG)."""
        raw = self.grab_raw()
        if self.pixelformat == "YUYV":
            yuyv = raw.reshape(self.height, self.width, 2)
            import cv2
            return cv2.cvtColor(yuyv, cv2.COLOR_YUV2BGR_YUY2)
        if self.pixelformat in ("MJPG", "JPEG"):
            import cv2
            return cv2.imdecode(raw, cv2.IMREAD_COLOR)
        raise NotImplementedError(f"pixel format {self.pixelformat!r}")

    def close(self):
        if self.handle:
            self.lib.bsio_cap_close(self.handle)
            self.handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
