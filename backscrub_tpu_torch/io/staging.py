"""Pinned-host staging for the host<->card frame path (counterpart of
``backscrub_tpu/io/staging.py``).

At the north-star rate the scarce resource is the host link: 720p YUYV is
~1.8 MB a frame each way.  The reference's analog is the kernel's V4L2
buffer queue (mmap'd DMA buffers, `videoio/loopback.cc:52-69`); the CUDA
analog is page-locked host memory.  A copy between it and the card is a
DMA that runs asynchronously to the host (``non_blocking=True``), where a
copy from pageable memory goes through a CUDA bounce buffer and returns
only once the bytes are staged.

:class:`StagingRing` covers both directions:

- ``upload(host)``: the host array — or every array of an MJPG frame
  ``(coefs, qtabs)``, three coefficient planes and a table in one slot —
  is copied into the next page-locked slot of a ring, then
  ``.to(device, non_blocking=True)`` on the current stream.  A slot is
  rewritten only after the event recorded behind its last copy has fired:
  an asynchronous copy reads its source after the call returns.
- ``to_pinned(dev)``: :func:`start_download`, a copy into fresh page-locked
  memory on a side stream that first waits on the current (compute)
  stream, with an event behind it.  The returned :class:`Download` waits
  on that event before numpy reads the bytes, and holds the device tensor
  until then, so the caching allocator cannot hand its memory to a later
  frame while the copy still reads it.

On a CPU device there is nothing to pin: ``supported`` is False, uploads
are plain tensors and downloads the tensors themselves, with identical
bytes, so callers never branch.
"""

from __future__ import annotations

import collections
import time

import numpy as np
import torch

from .. import _build


def pinned_supported(device="cuda") -> bool:
    """True if ``device`` is a CUDA device that accepts an asynchronous
    copy from page-locked host memory."""
    dev = torch.device(device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        return False
    try:
        probe = torch.zeros(8, dtype=torch.uint8, pin_memory=True)
        probe.to(dev, non_blocking=True)
        torch.cuda.synchronize(dev)
        return True
    except RuntimeError:
        return False


class Download:
    """A device -> host copy in flight.  :meth:`wait` blocks on its event
    and returns the host bytes, an array that nothing writes to again.  It
    launches no CUDA work, so any thread may call it."""

    def __init__(self, host: torch.Tensor, event=None, src=None):
        self._host = host
        self._event = event
        self._src = src

    def wait(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
            self._event = None
            self._src = None  # the copy has read it: the allocator may reuse it
        return self._host.numpy()


def start_download(t: torch.Tensor, stream) -> Download:
    """Start copying ``t`` to page-locked host memory on ``stream`` (which
    first waits on ``t``'s current stream); a CPU tensor is its own host
    copy."""
    if t.device.type != "cuda":
        return Download(t)
    stream.wait_stream(torch.cuda.current_stream(t.device))
    with torch.cuda.stream(stream):
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        event = torch.cuda.Event()
        event.record(stream)
    return Download(host, event, t)


def _leaves(tree) -> list:
    """The ndarrays of a (nested) tuple/list, in order."""
    if isinstance(tree, (tuple, list)):
        return [a for t in tree for a in _leaves(t)]
    return [np.asarray(tree)]


def _rebuild(tree, it):
    """``tree`` with each leaf replaced by the next of ``it``."""
    if isinstance(tree, (tuple, list)):
        return type(tree)(_rebuild(t, it) for t in tree)
    return next(it)


def _torch_dtype(dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dtype)).dtype


class StagingRing:
    """Pinned-host staging in both directions with a bounded in-flight ring.

    ``depth`` bounds how many staged downloads are kept in flight before
    ``drain()`` must consume them (mirrors ServingLoop's result ring).  The
    upload ring holds ``2 * (depth + 1)`` page-locked slots: two uploads a
    frame (the frame — an MJPG frame's arrays together — and its
    background), ``depth + 1`` frames deep.
    """

    def __init__(self, device="cuda", depth: int = 3):
        if depth < 1:
            raise ValueError("depth must be >= 1")
        self.device = _build.resolve_device(device)
        self.depth = depth
        self.supported = pinned_supported(self.device)
        self._slots = [(None, None)] * (2 * (depth + 1))
        self._next = 0
        self._stream = torch.cuda.Stream(self.device) if self.supported else None
        self._out: collections.deque = collections.deque()

    # -- host -> device -----------------------------------------------------
    def upload(self, host):
        """Host ndarray -> device tensor via a page-locked slot; a tuple or
        list of ndarrays (nested, as an MJPG frame ``(coefs, qtabs)``) takes
        one slot for all its arrays and comes back with the same nesting."""
        leaves = _leaves(host)
        if not self.supported:
            dev = [torch.as_tensor(np.ascontiguousarray(a)).to(self.device) for a in leaves]
            return _rebuild(host, iter(dev))
        i = self._next
        self._next = (i + 1) % len(self._slots)
        bufs, event = self._slots[i]
        if event is not None:
            event.synchronize()  # the slot's last copy has read it
        if bufs is None or len(bufs) != len(leaves) or any(
                tuple(b.shape) != a.shape or b.dtype != _torch_dtype(a.dtype)
                for b, a in zip(bufs, leaves)):
            bufs = [torch.empty(a.shape, dtype=_torch_dtype(a.dtype), pin_memory=True)
                    for a in leaves]
        dev = []
        for b, a in zip(bufs, leaves):
            np.copyto(b.numpy(), a)
            dev.append(b.to(self.device, non_blocking=True))
        event = torch.cuda.Event()
        event.record()
        self._slots[i] = (bufs, event)
        return _rebuild(host, iter(dev))

    # -- device -> host -----------------------------------------------------
    def to_pinned(self, dev_tensor: torch.Tensor) -> Download:
        """Start the D2H transfer; returns a :class:`Download`.  No ring
        bookkeeping: callers with their own in-flight ring (ServingLoop) use
        this primitive directly."""
        return start_download(dev_tensor, self._stream)

    def stage_out(self, dev_tensor: torch.Tensor) -> Download:
        """Start the D2H transfer of ``dev_tensor``; enqueue the handle."""
        h = self.to_pinned(dev_tensor)
        self._out.append(h)
        return h

    def ready(self) -> bool:
        return len(self._out) > self.depth

    def drain(self, force: bool = False):
        """Yield completed downloads as ndarrays (all of them if ``force``)."""
        while self._out and (force or len(self._out) > self.depth):
            yield self._out.popleft().wait()

    def fetch(self, dev_tensor: torch.Tensor) -> np.ndarray:
        """Blocking one-shot download through the page-locked path."""
        return self.to_pinned(dev_tensor).wait()


def probe_staging(width: int, height: int, *, frames: int = 8, device="cuda") -> dict:
    """Measure staged vs plain host<->device roundtrips of a (height, width,
    3) u8 frame; returns per-frame ms of each and the winner.

    Staging pays only where the page-locked hop saves a bounce copy, so
    callers (cli --staging) run this once at startup and keep staging
    only on a clear win.  Each window is a host clock between two
    ``torch.cuda.synchronize()`` calls.
    """
    dev = _build.resolve_device(device)
    rng = np.random.default_rng(0)
    hosts = [rng.integers(0, 256, (height, width, 3), np.uint8) for _ in range(4)]
    ring = StagingRing(dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def roundtrip_ms(upload, download) -> float:
        download(upload(hosts[0]))  # warm both directions
        sync()
        t0 = time.perf_counter()
        for i in range(frames):
            download(upload(hosts[i % 4]))
        sync()
        return (time.perf_counter() - t0) / frames * 1e3

    plain_ms = roundtrip_ms(lambda h: torch.as_tensor(h).to(dev),
                            lambda d: d.cpu().numpy())
    if not ring.supported:
        return {"supported": False, "use_staging": False,
                "plain_ms": plain_ms, "staged_ms": float("nan")}
    staged_ms = roundtrip_ms(ring.upload, ring.fetch)
    return {"supported": True,
            # hysteresis: keep staging only on a clear (>10%) win so noisy
            # ties don't flap run-to-run
            "use_staging": staged_ms < plain_ms * 0.9,
            "plain_ms": plain_ms, "staged_ms": staged_ms}
