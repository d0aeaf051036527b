"""Multi-stream server: N live sources -> one batched step -> N sinks
(counterpart of ``backscrub_tpu/runtime/multistream.py``).

The reference serves one camera per process (app/deepseg.cc main loop).
Here S streams share one card, or a mesh's "data" axis (below): each
tick gathers one frame a stream into
the (S, H, W, 3) batch (or the stream batch of the pipeline's
``input_format``), runs :class:`..parallel.streams.MultiStreamPipeline`'s
step (one launch of each kernel for the whole batch), and fans the
per-stream results out to sinks through a ring of ``depth`` results whose
device -> host copies started when their step was dispatched: on a side
stream, into page-locked memory, an event each (``io/staging.py:
start_download``, as ``runtime/serving.py`` does), so the copies overlap
the next gather and step.

Two gather modes:

- ``threaded=False`` (pull): sources are called in turn each tick.
  Deterministic: stream s sees exactly the frames its source yields, and
  its deliveries equal the pipeline's direct steps on those batches.
- ``threaded=True``: one reader thread a source, latest frame wins (the
  reference's CalcMask/background-reader pattern, app/deepseg.cc:272-277,
  app/background.cc:29-104, per stream).  A stalled camera never blocks
  the batch; its stream re-serves its last frame.  A stream that has
  never produced a frame gets no deliveries (its slot runs on a zero
  placeholder until then).

A stream whose source ends (returns None) is marked done; its last frame
keeps riding the batch (the batch's shape is fixed) and its sink stops
receiving.  The server stops when every stream is done, the frame budget
is reached, or, threaded, no stream produced a frame for
``stall_timeout`` seconds.

On a mesh (the pipeline's ``mesh``), every rank builds the same server
from the same stream list, SPMD: ``attach`` and ``detach`` are called on
every rank alike, between ticks.  A rank gathers, steps and delivers only
its own slots (``MultiStreamPipeline.slots``).  The model ranks of a data
slice compute the same rows: the one at "model" coordinate 0 calls the
slots' sources and sinks, and gives the others each tick's frames and
flags by a broadcast over "model" (so a camera is read by one process).
The ranks agree each tick, by one all-reduce over the mesh, whether any
slot is live and any frame fresh, and in ``run`` whether the stall timeout
passed, so every rank steps the same ticks and stops together.  Both
collectives move host values over gloo (``Mesh.host_group``), so they
never wait on the card's queue and the result ring keeps its overlap.
"""

from __future__ import annotations

import collections
import dataclasses
import sys
import threading
import time
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..io.staging import start_download
from ..parallel.mesh import agree
from ..parallel.streams import MultiStreamPipeline, take_rows


class _Reader:
    """Latest-frame-wins reader thread for one source."""

    def __init__(self, source: Callable[[], Optional[np.ndarray]]):
        self.source = source
        self.lock = threading.Lock()
        self.latest = None
        self.seq = 0           # bumps on every new frame
        self._consumed = 0     # the last seq the server consumed
        self.done = False
        self._stop = False
        self.thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        while not self._stop:
            try:
                frame = self.source()
            except Exception as e:
                # a dead reader must look like EOF, not a silent stall
                print(f"stream reader failed: {e!r}", file=sys.stderr)
                with self.lock:
                    self.done = True
                return
            if frame is None:
                with self.lock:
                    self.done = True
                return
            with self.lock:
                self.latest = frame
                self.seq += 1

    def snapshot(self):
        with self.lock:
            return self.latest, self.seq, self.done

    def stop(self):
        self._stop = True


class MultiStreamServer:
    """Serve up to S streams through one MultiStreamPipeline.

    ``sources``: callables -> frame or None at EOF, the frame as the
    pipeline's ``input_format`` gives it: (H, W, 3) BGR u8, (H, 2W) raw
    YUYV/UYVY, (3H/2, W) NV12, or for "mjpg" the ``(coefs, qtabs)`` that an
    ``io.streams.JpegSource`` yields (every stream of a batch shares the
    geometry and the chroma sampling; each stream's quant tables ride the
    batch as data).  ``sinks``: callables given each stream's packed
    output (a host array; for MJPG output a tuple of coefficient arrays).
    ``backgrounds``: a callable -> (S, H, W, 3) u8 a tick, or a static (S,
    H, W, 3) array (uploaded to the card once); None is green.
    ``depth``: results in flight.

    Fewer sources than slots: the tail slots are padding, riding the batch
    and never delivering (``MultiGeometryServer`` rounds a batch up to a
    mesh's data axis this way).  Membership is elastic: :meth:`attach`
    occupies a free slot at run time and :meth:`detach` frees one; the slot's EMA
    resets to a fresh pipeline's, and a generation count a slot keeps the
    ring from handing a previous occupant's results to a new sink.
    """

    def __init__(self, ms: MultiStreamPipeline,
                 sources: Sequence[Callable[[], Optional[np.ndarray]]],
                 sinks: Sequence[Callable[[np.ndarray], None]],
                 backgrounds=None, threaded: bool = False, depth: int = 2,
                 stall_timeout: Optional[float] = None,
                 keep_alive: bool = False):
        if len(sources) > ms.n_streams or len(sinks) != len(sources):
            raise ValueError(
                f"need at most {ms.n_streams} sources with matching sinks "
                f"(got {len(sources)}/{len(sinks)})")
        if depth < 1:
            raise ValueError("depth must be >= 1")
        self.ms = ms
        S = ms.n_streams
        self._own = ms.slots       # the slots this rank gathers, steps and delivers
        # this rank calls its slots' sources and sinks (model coordinate 0)
        self._lead = ms.mesh is None or ms.mesh.coord("model") == 0
        self._peers = ms.mesh is not None and ms.mesh.shape["model"] > 1
        pad = S - len(sources)
        self.sources = list(sources) + [None] * pad   # None: a free slot
        self.sinks = list(sinks) + [None] * pad
        self._gen = [0] * S            # bumps on attach/detach
        self._slots_lock = threading.Lock()
        self.threaded = threaded
        self.depth = depth
        self.stall_timeout = stall_timeout
        # an elastic server survives its last stream ending: tick() reports
        # idle rather than done, so later attach() calls find it serving
        self.keep_alive = keep_alive
        cfg = ms.pipe.cfg
        self.n_real = len(sources)
        self._mjpg = cfg.input_format == "mjpg"
        if self._mjpg:
            info = cfg.jpeg_info
            self._shape = None
            self._frames = (
                tuple(np.zeros((S, bh, bw, 64), np.int16) for bh, bw in info.blocks),
                np.zeros((S, info.ncomp, 64), np.uint16))
        else:
            if cfg.input_format in ("yuyv", "uyvy"):
                self._shape = (cfg.height, 2 * cfg.width)
            elif cfg.input_format == "nv12":
                self._shape = (cfg.height * 3 // 2, cfg.width)
            else:
                self._shape = (cfg.height, cfg.width, 3)
            self._frames = np.zeros((S,) + self._shape, np.uint8)
        self._live = [s < self.n_real for s in range(S)]
        self._ever = [False] * S       # produced at least one frame
        self._readers: Optional[List[Optional[_Reader]]] = None
        self.backgrounds = backgrounds
        self._bg_host: Optional[np.ndarray] = None   # for attach-time edits
        if backgrounds is not None and not callable(backgrounds):
            self._set_bg_host(self._pad_batch(np.asarray(backgrounds)).copy())
        self._d2h = torch.cuda.Stream(ms.device) if ms.device.type == "cuda" else None
        self._ring: collections.deque = collections.deque()
        # pop + deliver under one lock, so two drainers (a tick racing a
        # bucket's growth) never reorder a stream's outputs
        self._ring_lock = threading.Lock()

    def _on_card(self, host: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(host)).to(self.ms.device)

    def _local(self, batch):
        """This rank's rows of a whole-batch array (all of it off a mesh)."""
        return batch if self.ms.mesh is None else take_rows(batch, self.ms.rows)

    def _set_bg_host(self, host: np.ndarray) -> None:
        """Static backgrounds of every slot: kept on the host for
        attach-time edits, this rank's rows uploaded once."""
        self._bg_host = host
        self.backgrounds = self._on_card(self._local(host))

    def _store(self, s: int, frame) -> None:
        """Write one stream's frame into batch slot s (shape checked)."""
        if self._mjpg:
            coefs, qtabs = frame
            bcoefs, bqt = self._frames
            for c, arr in enumerate(coefs):
                if arr.shape != bcoefs[c].shape[1:]:
                    raise ValueError(
                        f"stream {s}: coefficient shape {arr.shape} != "
                        f"{bcoefs[c].shape[1:]} (all streams in a batch must "
                        "share the MJPG geometry and sampling)")
                bcoefs[c][s] = arr
            bqt[s] = qtabs
            return
        if frame.shape != self._shape:
            raise ValueError(f"stream {s}: frame shape {frame.shape} != {self._shape}")
        self._frames[s] = frame

    # -- one gather: fill self._frames, return per-stream "fresh" flags ----
    def live_slots(self) -> List[bool]:
        """Each slot's liveness (attached and its source not ended), as
        the rank that serves it sees it (agreed over the mesh)."""
        own = set(self._own)
        return list(agree(self.ms.mesh, *(self._live[s] and s in own
                                          for s in range(self.ms.n_streams))))

    def _gather_pull(self) -> List[bool]:
        fresh = [False] * self.ms.n_streams
        for s in self._own:
            src = self.sources[s]
            if src is None or not self._live[s]:
                continue
            frame = src()
            if frame is None:
                self._live[s] = False
                continue
            self._store(s, frame)
            fresh[s] = self._ever[s] = True
        return fresh

    def _gather_threaded(self) -> List[bool]:
        fresh = [False] * self.ms.n_streams
        for s, r in enumerate(self._readers):
            if r is None or not self._live[s]:
                continue
            latest, seq, done = r.snapshot()
            if latest is not None and seq != r._consumed:
                self._store(s, latest)
                r._consumed = seq
                fresh[s] = self._ever[s] = True
            if done and not fresh[s]:
                self._live[s] = False
        return fresh

    def _share(self, fresh: List[bool]) -> None:
        """From the lead to the other model ranks of its data slice, by
        broadcasts over "model" on the host: the slots' live, ever and
        fresh flags, and where a frame is fresh, the slice's frames."""
        g = self.ms.mesh.host_group("model")
        src = dist.get_global_rank(g, 0)
        own = self._own
        flags = torch.tensor([[self._live[s], self._ever[s], fresh[s]] for s in own],
                             dtype=torch.uint8)
        dist.broadcast(flags, src, group=g)
        for s, (live, ever, new) in zip(own, flags.tolist()):
            self._live[s], self._ever[s], fresh[s] = bool(live), bool(ever), bool(new)
        if not any(fresh[s] for s in own):
            return
        for arr in ([*self._frames[0], self._frames[1]] if self._mjpg else [self._frames]):
            rows = np.ascontiguousarray(arr[self.ms.rows])
            dist.broadcast(torch.from_numpy(rows.reshape(-1).view(np.uint8)), src, group=g)
            if not self._lead:
                arr[self.ms.rows] = rows

    def _pad_batch(self, b: np.ndarray) -> np.ndarray:
        """A batch of the real streams extended to every slot (padding
        slots get zeros; they never deliver)."""
        if b.shape[0] >= self.ms.n_streams:
            return b
        pad = np.zeros((self.ms.n_streams - b.shape[0],) + b.shape[1:], b.dtype)
        return np.concatenate([b, pad])

    def _background_batch(self):
        bgs = self.backgrounds
        if callable(bgs):
            bgs = self._local(self._pad_batch(np.asarray(bgs())))
        return bgs

    # -- the result ring ------------------------------------------------------
    def _submit(self, out, deliver: List[bool]):
        if isinstance(out, tuple):
            pending = tuple(start_download(o, self._d2h) for o in out)
        else:
            pending = start_download(out, self._d2h)
        self._ring.append((pending, deliver, list(self._gen)))

    def _drain(self, force: bool = False):
        with self._ring_lock:
            while self._ring and (force or len(self._ring) > self.depth):
                pending, deliver, gens = self._ring.popleft()
                # an MJPG output is a tuple of coefficient arrays, each
                # stream-batched on axis 0
                if isinstance(pending, tuple):
                    host = tuple(p.wait() for p in pending)
                else:
                    host = pending.wait()
                if not self._lead:
                    continue
                for i, s in enumerate(self._own):
                    sink = self.sinks[s]
                    # never hand a previous occupant's result to a slot
                    # attached since the dispatch
                    if sink is not None and deliver[s] and gens[s] == self._gen[s]:
                        sink(tuple(a[i] for a in host) if isinstance(host, tuple)
                             else host[i])

    # -- elastic membership ---------------------------------------------------
    def attach(self, source: Callable[[], Optional[np.ndarray]],
               sink: Callable[[np.ndarray], None],
               background: Optional[np.ndarray] = None) -> int:
        """Occupy a free slot with a new live stream; returns the slot.

        The batch's shape does not change: the slot's EMA resets to the
        all-background init (a fresh solo pipeline's state), its frame
        placeholder zeroes, and threaded, a reader thread starts.  Raises
        RuntimeError when every slot is occupied.  ``background`` (H, W, 3
        BGR u8) sets the slot's static background; it conflicts with a
        per-tick backgrounds callable (ValueError)."""
        with self._slots_lock:
            free = [s for s in range(self.ms.n_streams) if self.sources[s] is None]
            if not free:
                raise RuntimeError(f"all {self.ms.n_streams} batch slots are occupied")
            s = free[0]
            if background is not None and callable(self.backgrounds):
                raise ValueError("per-slot background conflicts with a "
                                 "per-tick backgrounds callable")
            self.sources[s] = source
            self.sinks[s] = sink
            self._gen[s] += 1
            self._live[s] = True
            self._ever[s] = False
            self.ms.reset_stream(s)
            if self._mjpg:
                bcoefs, bqt = self._frames
                for c in bcoefs:
                    c[s] = 0
                bqt[s] = 0
            else:
                self._frames[s] = 0
            if background is not None:
                if self._bg_host is None:
                    green = self.ms.pipe.green.cpu().numpy()
                    self._bg_host = np.broadcast_to(
                        green, (self.ms.n_streams,) + green.shape).copy()
                self._bg_host[s] = background
                self._set_bg_host(self._bg_host)
            if self.threaded and self._readers is not None and s in self._own and self._lead:
                r = _Reader(source)
                self._readers[s] = r
                r.thread.start()
            self.n_real = max(self.n_real, s + 1)
            return s

    def detach(self, slot: int) -> None:
        """Free a slot: its sink stops receiving (results in flight too)
        and the slot can be attached again."""
        with self._slots_lock:
            if not (0 <= slot < self.ms.n_streams) or self.sources[slot] is None:
                raise ValueError(f"slot {slot} is not attached")
            if self._readers is not None and self._readers[slot] is not None:
                self._readers[slot].stop()
                self._readers[slot] = None
            self.sources[slot] = None
            self.sinks[slot] = None
            self._gen[slot] += 1
            self._live[slot] = False
            self._ever[slot] = False

    def start(self):
        """Start the reader threads (threaded mode); idempotent."""
        if self.threaded and self._readers is None:
            self._readers = [_Reader(src) if src is not None and s in self._own and self._lead
                             else None
                             for s, src in enumerate(self.sources)]
            for r in self._readers:
                if r is not None:
                    r.thread.start()

    def tick(self) -> Optional[bool]:
        """One gather -> step -> drain cycle.  True when a batch was
        dispatched, False when nothing new arrived (threaded, or every
        stream done with ``keep_alive``), None when every stream is
        done."""
        with self._slots_lock:
            if not self._lead:
                fresh = [False] * self.ms.n_streams
            else:
                fresh = self._gather_threaded() if self.threaded else self._gather_pull()
            if self._peers:
                self._share(fresh)
            live, new = agree(self.ms.mesh, any(self._live[s] for s in self._own),
                              any(fresh))
            if not live:
                return False if self.keep_alive else None
            if self.threaded and not new:
                return False
            out, _masks = self.ms.step_local(self._local(self._frames),
                                             self._background_batch())
            # deliver to live streams that have produced frames; in pull
            # mode only fresh ones (a stream at EOF must not repeat its last)
            deliver = [self._live[s] and self._ever[s] and (fresh[s] or self.threaded)
                       for s in range(self.ms.n_streams)]
            self._submit(out, deliver)
        self._drain()
        return True

    def finish(self):
        """Flush the ring and stop the reader threads."""
        self._drain(force=True)
        if self._readers is not None:
            for r in self._readers:
                if r is not None:
                    r.stop()

    def run(self, frames: int = 0) -> int:
        """Serve until every stream ends (or ``frames`` ticks, or a full
        stall in threaded mode); returns the batches dispatched."""
        self.start()
        ticks = 0
        last_fresh = time.monotonic()
        try:
            while frames == 0 or ticks < frames:
                r = self.tick()
                if r is None:
                    break
                if r is False:
                    # nothing new anywhere: yield the core (and the GIL the
                    # reader threads need)
                    if self.stall_timeout is not None and agree(
                            self.ms.mesh, time.monotonic() - last_fresh > self.stall_timeout)[0]:
                        break
                    time.sleep(0.001)
                    continue
                last_fresh = time.monotonic()
                ticks += 1
        finally:
            self.finish()
        return ticks


class _StreamHandle:
    """A stream attached through MultiGeometryServer: (server, slot), kept
    valid across a bucket's growth (the migration rewrites ``srv``)."""

    __slots__ = ("srv", "slot")

    def __init__(self, srv: MultiStreamServer, slot: int):
        self.srv = srv
        self.slot = slot


class MultiGeometryServer:
    """Serve streams of different geometries, models and JPEG samplings on
    one card, or over ``mesh``'s "data" axis (each bucket's batch rounded
    up to it, the padding slots never delivering; SPMD as
    :class:`MultiStreamServer` on a mesh).

    A batch needs one shape, so streams bucket by (model, width, height,
    JPEG sampling); each bucket is a :class:`MultiStreamServer` over its
    own :class:`MultiStreamPipeline`, and every tick steps each bucket in
    turn: G buckets cost G steps a tick, not G processes
    (app/deepseg.cc:627-804 runs one process a camera).

    ``streams``: (source, sink, width, height[, background[, jpeg_info[,
    model]]]) tuples; ``background`` a static (height, width, 3) BGR u8
    array or None (green); ``jpeg_info`` (``io.jpeg.JpegInfo``, e.g. a
    JpegSource's ``.jpeg_info``) marks an MJPG stream of coefficient
    frames, decoded on the card; ``model`` a .tflite path in place of the
    server's.  ``pipe_kwargs`` (``compute_dtype``, ``precision``) go to
    every bucket's pipeline.

    Membership is elastic: :meth:`attach` with a key that has no bucket
    builds one, and warms it with one discarded step, before it joins the
    tick loop, so the other buckets never wait on it; :meth:`detach`
    retires a bucket whose last stream left.  Attaching to a full bucket
    builds a larger sibling the same way and migrates every occupied slot
    into it (sources, sinks, frames, backgrounds, reader threads, EMA
    rows), so the streams' outputs go on as they would have.
    """

    def __init__(self, model: str, config, streams: Sequence[tuple], mesh=None, *,
                 device="cuda", threaded: bool = False, depth: int = 2,
                 stall_timeout: Optional[float] = None, keep_alive: bool = False,
                 **pipe_kwargs):
        groups = {}
        for entry in streams:
            src, sink, w, h = entry[:4]
            bg = entry[4] if len(entry) > 4 else None
            jinfo = entry[5] if len(entry) > 5 else None
            smodel = entry[6] if len(entry) > 6 and entry[6] else model
            key = (smodel, w, h, jinfo.sampling if jinfo is not None else None)
            groups.setdefault(key, (jinfo, []))[1].append((src, sink, bg))
        self._mesh = mesh
        self._model = model
        self._config = config
        self._device = device
        self._pipe_kwargs = pipe_kwargs
        self._threaded = threaded
        self._depth = depth
        self._keep_alive = keep_alive
        self.stall_timeout = stall_timeout
        self._lock = threading.Lock()
        self._started = False
        self._handles: List[_StreamHandle] = []
        self.servers: List[MultiStreamServer] = []
        self._keys: List[tuple] = []    # parallel to self.servers
        for key, (jinfo, members) in groups.items():
            srv = self._build_bucket(key, jinfo, len(members))
            n = len(members)
            srv.sources[:n] = [m[0] for m in members]
            srv.sinks[:n] = [m[1] for m in members]
            srv._live[:n] = [True] * n
            srv.n_real = n
            if any(m[2] is not None for m in members):
                green = srv.ms.pipe.green.cpu().numpy()
                bgs = np.stack([m[2] if m[2] is not None else green for m in members])
                srv._set_bg_host(srv._pad_batch(bgs).copy())
            self.servers.append(srv)
            self._keys.append(key)

    def _build_bucket(self, key: tuple, jinfo, n_slots: int) -> MultiStreamServer:
        """A bucket for (model, w, h, sampling) with ``n_slots`` slots
        (rounded up to the mesh's data axis), every slot free."""
        smodel, w, h, _sampling = key
        cfg = dataclasses.replace(
            self._config, width=w, height=h, out_width=w, out_height=h,
            input_format="mjpg" if jinfo is not None else self._config.input_format,
            jpeg_info=jinfo if jinfo is not None else self._config.jpeg_info)
        d = 1 if self._mesh is None else self._mesh.shape["data"]
        ms = MultiStreamPipeline(smodel, cfg, -(-max(n_slots, 1) // d) * d, self._mesh,
                                 device=self._device, **self._pipe_kwargs)
        return MultiStreamServer(ms, [], [], threaded=self._threaded, depth=self._depth,
                                 stall_timeout=self.stall_timeout,
                                 keep_alive=self._keep_alive)

    @property
    def n_groups(self) -> int:
        return len(self.servers)

    def _register(self, srv: MultiStreamServer, slot: int) -> _StreamHandle:
        h = _StreamHandle(srv, slot)
        self._handles.append(h)
        return h

    def _migrate(self, old: MultiStreamServer, new: MultiStreamServer) -> None:
        """Move every occupied slot of ``old`` to the same slot of the
        larger, warmed, unstarted ``new`` (callers hold self._lock and
        old._slots_lock, so no tick is in flight on ``old``): results in
        flight drain through the old sinks first, then frames, backgrounds,
        reader threads and EMA rows move.  ``old`` is left empty, so a tick
        that took it before the splice idles."""
        S_old = old.ms.n_streams
        old._drain(force=True)
        new.sources[:S_old] = old.sources
        new.sinks[:S_old] = old.sinks
        new._live[:S_old] = old._live
        new._ever[:S_old] = old._ever
        if old._mjpg:
            (ocoefs, oqt), (ncoefs, nqt) = old._frames, new._frames
            for c in range(len(ocoefs)):
                ncoefs[c][:S_old] = ocoefs[c]
            nqt[:S_old] = oqt
        else:
            new._frames[:S_old] = old._frames
        new.ms.reset()
        # a slot keeps its rank and its local row as the batch grows
        # (parallel/mesh.py stream_slice), so the EMA rows move in place
        new.ms.ema[:old.ms.ema.shape[0]] = old.ms.ema
        if callable(old.backgrounds):
            new.backgrounds = old.backgrounds
        elif old._bg_host is not None:
            new._set_bg_host(new._pad_batch(old._bg_host).copy())
        if old._readers is not None:
            new._readers = list(old._readers) + [None] * (new.ms.n_streams - S_old)
            old._readers = None    # old.finish() must not stop moved readers
        new.n_real = old.n_real
        old.sources = [None] * S_old
        old.sinks = [None] * S_old
        old._live = [False] * S_old
        old._ever = [False] * S_old
        for h in self._handles:
            if h.srv is old:
                h.srv = new

    def attach(self, source: Callable[[], Optional[np.ndarray]],
               sink: Callable[[np.ndarray], None], width: int, height: int, *,
               background: Optional[np.ndarray] = None, jpeg_info=None,
               model: Optional[str] = None) -> _StreamHandle:
        """Attach a stream at run time, building its bucket if none exists
        or growing it when it is full, off the tick path (built and warmed
        by one discarded step before it is spliced in).  Returns a handle
        for :meth:`detach`, valid across later growth."""
        smodel = model or self._model
        key = (smodel, width, height, jpeg_info.sampling if jpeg_info is not None else None)
        while True:
            with self._lock:
                cur = None
                for srv, k in zip(self.servers, self._keys):
                    if k == key:
                        cur = srv
                        try:
                            return self._register(srv, srv.attach(source, sink, background))
                        except RuntimeError:     # full: grow (below)
                            occupied = sum(s is not None for s in srv.sources)
                        break
            new = self._build_bucket(key, jpeg_info, occupied + 1 if cur is not None else 1)
            new.ms.step_local(new._local(new._frames), None)      # warm-up; discarded
            with self._lock:
                # find the bucket again: it may have freed a slot, grown or
                # been retired meanwhile
                live = next((srv for srv, k in zip(self.servers, self._keys) if k == key),
                            None)
                if live is not None:
                    try:
                        return self._register(live, live.attach(source, sink, background))
                    except RuntimeError:
                        if live.ms.n_streams >= new.ms.n_streams:
                            continue             # raced: build a larger one
                        with live._slots_lock:
                            self._migrate(live, new)
                        self.servers[self.servers.index(live)] = new
                        slot = new.attach(source, sink, background)
                        if self._started:
                            new.start()
                        return self._register(new, slot)
                slot = new.attach(source, sink, background)
                if self._started:
                    new.start()
                self.servers.append(new)
                self._keys.append(key)
                return self._register(new, slot)

    def detach(self, handle: _StreamHandle) -> None:
        """Detach a stream by its handle; a bucket whose last stream left
        is retired (its ring flushed, its readers stopped)."""
        srv, slot = handle.srv, handle.slot
        with self._lock:
            srv.detach(slot)
            if handle in self._handles:
                self._handles.remove(handle)
            if any(s is not None for s in srv.sources):
                return
            if srv not in self.servers:
                return
            i = self.servers.index(srv)
            self.servers.pop(i)
            self._keys.pop(i)
        srv.finish()

    def start(self):
        with self._lock:
            self._started = True
            for s in self.servers:
                s.start()

    def finish(self):
        with self._lock:
            self._started = False
            servers = list(self.servers)
        for s in servers:
            s.finish()

    def run(self, frames: int = 0) -> int:
        """Serve every bucket; returns the ticks (a tick steps each bucket
        with news once).  Buckets attached mid-run join the loop; buckets
        whose streams all ended (without keep_alive) leave it."""
        self.start()
        done: set = set()
        ticks = 0
        last_fresh = time.monotonic()
        try:
            while frames == 0 or ticks < frames:
                with self._lock:
                    servers = list(self.servers)
                dispatched = False
                for s in servers:
                    if id(s) in done:
                        continue
                    r = s.tick()
                    if r is None:
                        done.add(id(s))
                    elif r:
                        dispatched = True
                if not any(id(s) not in done for s in servers):
                    break
                if not dispatched:
                    if self.stall_timeout is not None and agree(
                            self._mesh, time.monotonic() - last_fresh > self.stall_timeout)[0]:
                        break
                    time.sleep(0.001)
                    continue
                last_fresh = time.monotonic()
                ticks += 1
        finally:
            self.finish()
        return ticks
