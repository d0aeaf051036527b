"""Serving loop: overlap host I/O with device compute (counterpart of
``backscrub_tpu/runtime/serving.py``).

The reference hides its inference behind a worker thread (CalcMask).
Here the device step is short and the host is the bottleneck (PERF.md
§5), so the serving loop pipelines differently:

  upload(frame i+1)  ||  dispatch(step i)  ||  download(result i-k)  ||  sink(result i-k-1)

A small in-flight ring holds results whose device -> host copies started
as soon as their step was dispatched: on a side stream that waits on the
compute stream, into page-locked memory, with an event behind each
(``io/staging.py:start_download``).  The sink consumes them ``depth``
frames later, so the copy's latency is overlapped, not paid per frame.
"""

from __future__ import annotations

import collections
import queue
import threading
from typing import Callable, Optional

import numpy as np
import torch

from ..io.staging import StagingRing, start_download
from ..pipeline.frame import FramePipeline


class ServingLoop:
    """Pipelined frame server around a FramePipeline.

    ``run(source, sink, background=None, frames=0)`` pulls frames from
    ``source`` (callable -> frame | None), pushes packed results into
    ``sink`` (callable, given a host ndarray), keeping ``depth`` results in
    flight, in FIFO order.

    ``staging=True`` uploads frames and backgrounds through a ring of
    page-locked slots (``io/staging.py``); downloads take the page-locked
    path either way.  Results are byte-identical with staging on or off; on
    a device without page-locked copies (the CPU) it degrades to plain
    uploads.

    ``drain_thread=True`` moves the wait for each download and the sink
    call onto a dedicated consumer thread, so the submit side never stalls
    on a download.  The thread launches no CUDA work: it waits on events
    and hands numpy arrays to the sink.  FIFO order is preserved (single
    consumer); the queue is bounded at ``depth`` for backpressure; a sink
    error is raised on the submit side.
    """

    def __init__(self, pipe: FramePipeline, depth: int = 3,
                 staging: bool = False, drain_thread: bool = False):
        if depth < 1:
            raise ValueError("depth must be >= 1")
        self.pipe = pipe
        self.depth = depth
        self.staging = StagingRing(pipe.device, depth=depth) if staging else None
        self._d2h = torch.cuda.Stream(pipe.device) if pipe.device.type == "cuda" else None
        self._ring: collections.deque = collections.deque()
        self._q: Optional[queue.Queue] = None
        self._worker: Optional[threading.Thread] = None
        self._sink_error: Optional[Exception] = None
        if drain_thread:
            self._q = queue.Queue(maxsize=depth)

    # -- drain-thread mode ---------------------------------------------------
    def _ensure_worker(self, sink: Callable[[np.ndarray], None]):
        if self._worker is None or not self._worker.is_alive():
            def consume():
                while True:
                    item = self._q.get()
                    if item is None:
                        self._q.task_done()
                        return
                    try:
                        sink(self._materialize(item))
                    except Exception as e:  # surface on the submit side
                        self._sink_error = e
                    finally:
                        self._q.task_done()
            self._worker = threading.Thread(target=consume, daemon=True,
                                            name="bs-drain")
            self._worker.start()

    def _raise_sink_error(self):
        if self._sink_error is not None:
            e, self._sink_error = self._sink_error, None
            raise e

    @staticmethod
    def _materialize(out):
        """Wait for a result's download; the host array it returns (a tuple
        of them for an MJPG coefficient output) is the sink's to keep."""
        if isinstance(out, tuple):
            return tuple(d.wait() for d in out)
        return out.wait()

    def _drain_one(self, sink: Callable[[np.ndarray], None]):
        sink(self._materialize(self._ring.popleft()))

    def submit(self, frame, background=None, **step_kwargs):
        """Dispatch one frame (an MJPG frame: ``(coefs, qtabs)``, every
        array of it staged); starts its download immediately — every
        coefficient array of an MJPG output."""
        if self.staging is not None:
            if isinstance(frame, (np.ndarray, tuple)):
                frame = self.staging.upload(frame)
            if isinstance(background, np.ndarray):
                background = self.staging.upload(background)
        out, _mask = self.pipe.step(frame, background, **step_kwargs)
        if isinstance(out, tuple):
            self._ring.append(tuple(start_download(o, self._d2h) for o in out))
        else:
            self._ring.append(start_download(out, self._d2h))

    def ready(self) -> bool:
        return len(self._ring) > self.depth

    def drain_ready(self, sink: Callable[[np.ndarray], None]) -> int:
        """Deliver all results past the pipeline depth; returns count.

        In drain-thread mode this hands results to the consumer thread
        (blocking only when ``depth`` results are already queued) and
        returns the number handed off."""
        n = 0
        if self._q is not None:
            self._ensure_worker(sink)
            self._raise_sink_error()
            while self.ready():
                self._q.put(self._ring.popleft())
                n += 1
            return n
        while self.ready():
            self._drain_one(sink)
            n += 1
        return n

    def drain_all(self, sink: Callable[[np.ndarray], None]) -> int:
        """Deliver every in-flight result (end of stream); returns count."""
        n = 0
        if self._q is not None:
            self._ensure_worker(sink)
            while self._ring:
                self._q.put(self._ring.popleft())
                n += 1
            self._q.join()  # all sink calls completed
            self._raise_sink_error()
            return n
        while self._ring:
            self._drain_one(sink)
            n += 1
        return n

    def close(self):
        """Stop the drain thread (drain-thread mode); safe to call twice."""
        if self._q is not None and self._worker is not None \
                and self._worker.is_alive():
            self._q.put(None)
            self._worker.join(timeout=5.0)

    def run(self, source: Callable[[], Optional[np.ndarray]],
            sink: Callable[[np.ndarray], None],
            background: Optional[Callable[[], Optional[np.ndarray]]] = None,
            frames: int = 0, **step_kwargs) -> int:
        n = 0
        try:
            while frames == 0 or n < frames:
                frame = source()
                if frame is None:
                    break
                bg = background() if background else None
                self.submit(frame, bg, **step_kwargs)
                n += 1
                self.drain_ready(sink)
        finally:
            self.drain_all(sink)
            self.close()
        return n
