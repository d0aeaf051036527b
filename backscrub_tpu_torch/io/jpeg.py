"""Host half of the MJPG path: the baseline-JPEG entropy codec
(counterpart of ``backscrub_tpu/io/jpeg.py``, the port's own copy).

MJPG is the common high-resolution webcam format (the reference
negotiates it, app/deepseg.cc:543-570, and lets OpenCV decode frames on
the host).  Only the serial Huffman entropy decode and encode stay on the
host (``native/bsjpeg.cc``, built by ``_build.host_library`` into
``backscrub_tpu_torch/_build/``); dequantize, IDCT, chroma upsampling and
YCbCr->BGR run on the card (``ops/jpeg_kernels.py``), and the encoder's
colour conversion, DCT and quantisation as PyTorch ops
(``pipeline/jpeg_enc.py``).

:class:`JpegEntropyDecoder` turns JPEG bytes into static-shape
``(blocks_h, blocks_w, 64) int16`` coefficient arrays per component;
:class:`JpegHuffmanEncoder` packs such arrays into a baseline JPEG.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from .. import _build

_LIB = None

_ERRORS = {
    -1: "truncated JPEG stream",
    -2: "not a JPEG (no SOI marker)",
    -3: "unsupported JPEG flavor (progressive/arithmetic/12-bit/CMYK)",
    -4: "corrupt JPEG stream",
    -5: "bad argument / geometry changed mid-stream",
}


class _BsjpegInfo(ctypes.Structure):
    # ctypes mirror of bsjpeg_info_t — canonical layout: native/bsjpeg.h
    # (the C sources include that header; keep field order in sync with it)
    _fields_ = [
        ("width", ctypes.c_int32), ("height", ctypes.c_int32),
        ("ncomp", ctypes.c_int32),
        ("h", ctypes.c_int32 * 3), ("v", ctypes.c_int32 * 3),
        ("blocks_w", ctypes.c_int32 * 3), ("blocks_h", ctypes.c_int32 * 3),
        ("qtab", (ctypes.c_uint16 * 64) * 3),
        ("restart_interval", ctypes.c_int32),
    ]


def load_bsjpeg() -> ctypes.CDLL:
    """The entropy codec, ``native/bsjpeg.cc`` built by
    :func:`_build.host_library` into the port's ``_build/`` at first use
    (never a ``native/build/`` tree); KernelBuildError where it does not
    build."""
    global _LIB
    if _LIB is not None:
        return _LIB
    lib = ctypes.CDLL(_build.host_library("bsjpeg"))
    lib.bsjpeg_parse.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                 ctypes.POINTER(_BsjpegInfo)]
    lib.bsjpeg_parse.restype = ctypes.c_int
    lib.bsjpeg_decode.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                  ctypes.POINTER(_BsjpegInfo),
                                  ctypes.c_void_p, ctypes.c_void_p,
                                  ctypes.c_void_p]
    lib.bsjpeg_decode.restype = ctypes.c_int
    lib.bsjpeg_encode_zz.argtypes = [
        ctypes.POINTER(_BsjpegInfo), ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]
    lib.bsjpeg_encode_zz.restype = ctypes.c_int64
    lib.bsjpeg_version.restype = ctypes.c_char_p
    _LIB = lib
    return lib


@dataclasses.dataclass(frozen=True)
class JpegInfo:
    """Static frame geometry of an MJPG stream: shapes and sampling are
    fixed for its lifetime, so the decode's buffers and launch geometry are
    set once a camera; quant tables may vary per frame and travel with the
    coefficients."""
    width: int
    height: int
    ncomp: int
    sampling: Tuple[Tuple[int, int], ...]   # (h, v) per component
    blocks: Tuple[Tuple[int, int], ...]     # (blocks_h, blocks_w) per component

    @property
    def is_420(self) -> bool:
        return (self.ncomp == 3 and self.sampling[0] == (2, 2)
                and self.sampling[1] == (1, 1) and self.sampling[2] == (1, 1))


class JpegUnsupported(ValueError):
    """A JPEG flavour the entropy codec does not take (progressive,
    arithmetic, 12-bit, CMYK): the one case a camera source decodes on the
    host instead."""


def _raise(rc: int, what: str):
    cls = JpegUnsupported if rc == -3 else ValueError
    raise cls(f"bsjpeg {what} failed: {_ERRORS.get(rc, f'error {rc}')}")


def _to_info(ci: _BsjpegInfo) -> JpegInfo:
    n = ci.ncomp
    return JpegInfo(
        width=ci.width, height=ci.height, ncomp=n,
        sampling=tuple((ci.h[c], ci.v[c]) for c in range(n)),
        blocks=tuple((ci.blocks_h[c], ci.blocks_w[c]) for c in range(n)))


def parse_header(jpg: bytes) -> JpegInfo:
    """Marker-parse only (no entropy decode): geometry + sampling."""
    lib = load_bsjpeg()
    ci = _BsjpegInfo()
    buf = bytes(jpg)
    rc = lib.bsjpeg_parse(buf, len(buf), ctypes.byref(ci))
    if rc != 0:
        _raise(rc, "parse")
    return _to_info(ci)


class JpegEntropyDecoder:
    """Reusable per-stream decoder with preallocated coefficient buffers.

    A camera's MJPG stream keeps one geometry for its lifetime, so the
    first frame fixes the static shapes; later frames reuse the buffers and cost ONE native call
    (bsjpeg_decode verifies geometry and returns fresh quant tables
    itself).  ``decode(jpg)`` returns ``(coefs, qtabs)``:

    - ``coefs``: list of ``(blocks_h, blocks_w, 64) int16`` arrays, natural
      8x8 order, RAW quantized values (device multiplies by qtab);
    - ``qtabs``: ``(ncomp, 64) uint16`` dequant tables in natural order
      (runtime data — some encoders re-tune tables per frame).

    ``max_pixels`` bounds the coefficient allocation a hostile/corrupt
    first frame can demand (default 4K with margin; the decode contract
    stays ValueError-only instead of surfacing a MemoryError).
    """

    def __init__(self, max_pixels: int = 16 << 20):
        self.lib = load_bsjpeg()
        self.info: Optional[JpegInfo] = None
        self.max_pixels = max_pixels
        self._ci = _BsjpegInfo()
        self._coefs: List[np.ndarray] = []

    def decode(self, jpg: bytes) -> Tuple[List[np.ndarray], np.ndarray]:
        buf = bytes(jpg)
        ci = self._ci
        if self.info is None:  # first frame fixes the static shapes
            rc = self.lib.bsjpeg_parse(buf, len(buf), ctypes.byref(ci))
            if rc != 0:
                _raise(rc, "parse")
            info = _to_info(ci)
            if info.width * info.height > self.max_pixels:
                raise ValueError(
                    f"JPEG is {info.width}x{info.height} "
                    f"(> max_pixels={self.max_pixels}); refusing to allocate")
            self.info = info
            self._coefs = [np.empty((bh, bw, 64), np.int16)
                           for bh, bw in info.blocks]
        ptrs = [c.ctypes.data for c in self._coefs] + [None, None]
        rc = self.lib.bsjpeg_decode(buf, len(buf), ctypes.byref(ci),
                                    ptrs[0], ptrs[1], ptrs[2])
        if rc == -5:  # BADARG: this frame's geometry/sampling differs
            raise ValueError(
                f"MJPG stream changed geometry mid-stream (was {self.info}); "
                "reopen the decoder")
        if rc != 0:
            _raise(rc, "decode")
        qtabs = np.ctypeslib.as_array(ci.qtab)[:self.info.ncomp].copy()
        return self._coefs, qtabs


# zigzag index -> natural index (ITU T.81 Figure A.6): the encoder's
# gather (pipeline/jpeg_enc.py) and _zz_to_natural's inverse
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63],
    np.int64)


def make_info(width: int, height: int, sampling=((2, 2), (1, 1), (1, 1)),
              ncomp: int = 3) -> JpegInfo:
    """Build the static JpegInfo for an ENCODER stream (mirrors the
    geometry the decoder derives from SOF): MCU-padded block dims."""
    hmax = max(s[0] for s in sampling[:ncomp])
    vmax = max(s[1] for s in sampling[:ncomp])
    mx = -(-width // (8 * hmax))
    my = -(-height // (8 * vmax))
    return JpegInfo(
        width=width, height=height, ncomp=ncomp,
        sampling=tuple(sampling[:ncomp]),
        blocks=tuple((my * v, mx * h) for h, v in sampling[:ncomp]))


class JpegHuffmanEncoder:
    """Host half of MJPG *encode*: pack device-produced quantized
    coefficients (pipeline/jpeg_enc.py) into a baseline JPEG stream.

    Headers + Annex K Huffman tables follow libjpeg's layout, so for the
    bit-exact coefficients of pipeline/jpeg_enc.py the emitted bytes match cv2.imencode
    (libjpeg-turbo defaults, optimize=off).  The output buffer grows on
    demand and is reused across frames.  The coefficients come in zigzag
    order, pipeline/jpeg_enc.py's layout (``bsjpeg_encode_zz``).
    """

    def __init__(self, info: JpegInfo, qtabs: np.ndarray):
        self.lib = load_bsjpeg()
        self.info = info
        self._ci = _BsjpegInfo()
        self._ci.width = info.width
        self._ci.height = info.height
        self._ci.ncomp = info.ncomp
        for c in range(info.ncomp):
            self._ci.h[c], self._ci.v[c] = info.sampling[c]
            self._ci.blocks_h[c], self._ci.blocks_w[c] = info.blocks[c]
            for i in range(64):
                self._ci.qtab[c][i] = int(qtabs[c][i])
        # worst case: ~2 bytes per coefficient + headers
        cap = info.width * info.height * 8 + 4096
        self._buf = np.empty(cap, np.uint8)

    def encode(self, coefs) -> bytes:
        arrs = [np.ascontiguousarray(np.asarray(c), dtype=np.int16)
                for c in coefs]
        for c, a in enumerate(arrs):
            bh, bw = self.info.blocks[c]
            if a.shape != (bh, bw, 64):
                raise ValueError(f"component {c}: coefficient shape "
                                 f"{a.shape} != {(bh, bw, 64)}")
        fn = self.lib.bsjpeg_encode_zz
        ptrs = [a.ctypes.data for a in arrs] + [None, None]
        n = fn(ctypes.byref(self._ci), ptrs[0], ptrs[1],
               ptrs[2], self._buf.ctypes.data, self._buf.nbytes)
        if n < 0:
            _raise(int(n), "encode")
        if n > self._buf.nbytes:  # grew past the buffer: retry exact-size
            self._buf = np.empty(int(n), np.uint8)
            n = fn(ctypes.byref(self._ci), ptrs[0], ptrs[1], ptrs[2],
                   self._buf.ctypes.data, self._buf.nbytes)
        return self._buf[:int(n)].tobytes()


def _zz_to_natural(zz: np.ndarray) -> np.ndarray:
    """(..., 64) zigzag-order blocks -> natural order."""
    nat = np.empty_like(zz)
    nat[..., ZIGZAG] = zz
    return nat
