#!/usr/bin/env python3
"""Long-haul elastic-serving soak of the PyTorch port: MultiStreamServer
under churn (counterpart of ``tools/soak.py``).

A ``MultiStreamServer`` runs for ``--duration`` seconds (or ``--ticks``)
while streams attach, die mid-stream (abrupt EOF, like a camera unplug)
and detach at random; ``--sigterm`` sends the tool's process a SIGTERM
halfway through (or at ``--sigterm-at`` seconds), which reaches every
rank, and the server drains.  Checked
throughout:

- **each stream against solo steps**: every delivered frame of every
  stream generation is compared with one shared solo ``FramePipeline``
  step (``entry.frame_step``) fed the same frames from a fresh EMA a
  generation, incrementally.  On the CPU the batch is byte-equal to solo
  steps (every stage is the same plain arithmetic), so any differing byte
  fails.  On the card a stream batch runs the canvas resize and the
  executor remainder through library calls whose algorithms depend on the
  batch size, so a decode at a near-tie may flip; there the flip rule of
  ``chip_smoke.py``'s multistream phase holds, read on the outputs the
  sinks get: a byte may differ only inside the post's reach of the EMA
  pixels whose solo decode has sat at a near-tie (|margin| <= ``TIE``,
  deeplab's ``ARGMAX_TIE``) on some frame of the generation, and at most
  2% of a frame's bytes and 0.2% of a stream's differ.  EMA cross-talk, a
  stale generation or an out-of-order frame corrupt bytes off the ties
  and fail;
- **no ring leak**: the result ring is empty after ``finish`` and no
  stream is delivered more frames than it produced;
- **generation guard**: a result in flight across a detach is never
  delivered to the slot's next occupant (a new generation's frames must
  match a fresh solo state);
- **stable RSS**: resident-set growth after warm-up stays under
  ``--rss-budget-mb``.

Writes a JSON report (``--report``, through
``utils.artifacts.atomic_json_dump``) and prints it; exits 1 on any
violation.  Runs on the card unless given ``--device cpu``, over a mesh
of every device, as ``tools/soak.py`` does (``parallel/mesh.py``
``device_count``: the cards, or four gloo ranks on the CPU): one process a
device (``run_world``; a world of one in this process), the slots rounded
up to the data axis.  Every rank runs the
same churn from the same seed; the server's ticks, the slots' liveness
and the stop are agreed over the mesh, each rank checks the streams it
delivered, and rank 0 writes the report of them all.

Usage::

    python tools/soak_torch.py --model tests/data/segm_synth_lite_96x160.tflite \\
        --ticks 400 --duration 0 [--device cpu] [--sigterm --duration 30]
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import threading
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir))


def rss_mb() -> float:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) / 1024.0
    return float("nan")


class StreamSim:
    """One deterministic synthetic stream: seeded frames, a finite life."""

    def __init__(self, seed: int, w: int, h: int, lifetime: int):
        self.seed = seed
        self.w, self.h = w, h
        self.lifetime = lifetime  # frames until an abrupt EOF (a reader's death)
        self.produced = 0
        self.delivered = []       # the sink's outputs, in order; None once checked
        self._rng = np.random.default_rng(seed)
        # the verifier's replay of the same frames
        self.v_rng = np.random.default_rng(seed)
        self.v_ema = None
        self.v_checked = 0
        self.v_diff_frames = 0    # frames with any byte off the solo step's
        self.v_diff_sum = 0.0     # the sum of their differing fractions

    def source(self):
        if self.produced >= self.lifetime:
            return None
        self.produced += 1
        return self._rng.integers(0, 256, (self.h, self.w, 3), np.uint8)

    def sink(self, arr):
        self.delivered.append(np.array(arr, copy=True))


def decode_margin(mg, frame):
    """The decode's margin at each EMA pixel (oh, ow) of one BGR u8 frame
    on ``mg``'s device, by ``mg``'s own path: the value the decode compares
    less its threshold, for deeplab's argmax the person class's output less
    the largest other one; the decision flips at 0
    (``tests/test_torch_multistream.py``'s ``_margins``)."""
    import torch
    f = frame[None]
    e = mg.edge
    with torch.no_grad():
        if e is not None:
            out = e.body(e.front(f))
            if e.info.tail_ok:
                return (e.tail_logits(out.flatten(-2)) - e.info.tail_threshold)[0]
            out = out.movedim(-3, -1)
        else:
            out = mg._infer(mg._pre(f))
    o, spec = out[0], mg.spec
    if spec.decode == "two_channel":
        return o[..., 1] - o[..., 0]
    if spec.decode == "threshold":
        return o[..., 0] - spec.threshold
    if spec.decode == "argmax_person":
        k = spec.person_class
        return o[..., k] - torch.cat([o[..., :k], o[..., k + 1:]], -1).max(-1).values
    raise ValueError(f"the soak's card bar has no decode margin for {spec.decode!r}")


def yuyv_footprint(foot):
    """A frame's pixels (H, W) bool as the bytes of its YUYV (H, 2W): a
    pixel pair's four bytes wherever either pixel is marked."""
    h, w = foot.shape
    return foot.reshape(h, w // 2, 2).any(-1)[..., None].expand(h, w // 2, 4).reshape(h, 2 * w)


class Verifier:
    """Replays each stream through ONE shared solo step with a per-stream
    EMA, incrementally (work in the new frames only)."""

    TIE = 1e-3          # the card: a near-tie decode margin (the flip rule's)
    ARGMAX_TIE = 0.02   # deeplab's batch-vs-solo limit (chip_smoke.MS_DEEPLAB_TIE)
    FRAME_TOL = 0.02    # at most 2% of a frame's bytes differ
    MEAN_TOL = 0.002    # and 0.2% of a stream's

    def __init__(self, pipe, exact: bool):
        from backscrub_tpu_torch.entry import frame_step
        if pipe.cfg.output_format != "yuyv":
            raise ValueError("the soak's verifier reads YUYV outputs")
        self.pipe = pipe
        self.step = frame_step(pipe)
        self.exact = exact
        self.tie = self.ARGMAX_TIE if pipe.maskgen.spec.decode == "argmax_person" else self.TIE

    def register(self, sim: StreamSim):
        sim.v_ema = self.pipe.maskgen.ema.clone()   # the all-background init
        sim.v_near = None   # the EMA pixels whose solo decode has sat at a near-tie

    def _off_the_ties(self, sim: StreamSim, frame, apart) -> int:
        """The card's flip rule on one frame: the differing bytes ``apart``
        that lie outside the post's reach of the generation's near-tie EMA
        pixels (``sim.v_near``, updated here with this frame's)."""
        import torch
        from backscrub_tpu_torch.pipeline.edge import post_footprint
        mg = self.pipe.maskgen
        near = decode_margin(mg, torch.from_numpy(frame).to(self.pipe.device)).abs() <= self.tie
        sim.v_near = near if sim.v_near is None else sim.v_near | near
        if not apart.any():
            return 0
        foot = yuyv_footprint(post_footprint(sim.v_near, mg.geo, mg.post_mats))
        return int((apart & ~foot.cpu().numpy()).sum())

    def advance(self, sim: StreamSim) -> int:
        """Check the delivered frames not yet checked; returns how many,
        or raises AssertionError naming the first frame at fault."""
        n = 0
        while sim.v_checked < len(sim.delivered):
            frame = sim.v_rng.integers(0, 256, (sim.h, sim.w, 3), np.uint8)
            out, _mask, sim.v_ema = self.step(frame, self.pipe.green, sim.v_ema)
            i = sim.v_checked
            want = out.cpu().numpy()
            apart = sim.delivered[i] != want
            sim.delivered[i] = None   # keep the count, free the frame
            diff = int(apart.sum())
            if diff and self.exact:
                raise AssertionError(f"frame {i}: {diff} bytes differ from the solo "
                                     "step (the CPU batch is byte-equal to it)")
            off = 0 if self.exact else self._off_the_ties(sim, frame, apart)
            if off:
                raise AssertionError(f"frame {i}: {off} bytes differ from the solo step "
                                     "outside the post's reach of the near-tie decodes "
                                     "(EMA cross-talk or a mis-delivery)")
            if diff:
                frac = diff / want.size
                sim.v_diff_frames += 1
                sim.v_diff_sum += frac
                if frac > self.FRAME_TOL:
                    raise AssertionError(f"frame {i}: {frac:.1%} of bytes differ from the "
                                         "solo step")
                mean = sim.v_diff_sum / (sim.v_checked + 1)
                if mean > self.MEAN_TOL:
                    raise AssertionError(f"frame {i}: the stream's mean is {mean:.2%} "
                                         "(a persistent divergence)")
            sim.v_checked += 1
            n += 1
        return n


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="segm_lite_v681.tflite",
                    help="a .tflite path or a name resolve_model_path finds")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    ap.add_argument("--duration", type=float, default=60.0,
                    help="seconds to run (0 = use --ticks only)")
    ap.add_argument("--ticks", type=int, default=0, help="most batches (0 = unbounded)")
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--geometry", default="64x48")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--churn-every", type=int, default=25,
                    help="ticks between random attach/detach events")
    ap.add_argument("--check-every", type=int, default=50,
                    help="ticks between incremental identity sweeps")
    ap.add_argument("--rss-budget-mb", type=float, default=200.0)
    ap.add_argument("--sigterm", action="store_true",
                    help="send SIGTERM to the tool's process halfway through")
    ap.add_argument("--sigterm-at", type=float, default=0.0,
                    help="with --sigterm: at this many seconds, not duration/2")
    ap.add_argument("--report", default="soak_report.json")
    args = ap.parse_args(argv)

    from backscrub_tpu_torch.parallel.mesh import device_count, run_world
    return run_world(soak, device_count(args.device), args.device, args)


def soak(args) -> int:
    """One rank's soak over the world's mesh; rank 0's exit code."""
    import torch
    import torch.distributed as dist
    from backscrub_tpu_torch.models.specs import resolve_model_path
    from backscrub_tpu_torch.parallel.mesh import agree, make_mesh
    from backscrub_tpu_torch.parallel.streams import MultiStreamPipeline
    from backscrub_tpu_torch.pipeline.frame import FramePipeline, PipelineConfig
    from backscrub_tpu_torch.runtime.multistream import MultiStreamServer
    from backscrub_tpu_torch.utils.artifacts import atomic_json_dump

    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    mesh = make_mesh(dist.get_world_size(), device=args.device)
    w, h = (int(x) for x in args.geometry.split("x"))
    rng = np.random.default_rng(args.seed)
    path = resolve_model_path(args.model)
    cfg = PipelineConfig(width=w, height=h)
    da = mesh.shape["data"]
    S = (max(args.slots, da) + da - 1) // da * da
    ms = MultiStreamPipeline(path, cfg, S, mesh)
    verifier = Verifier(FramePipeline(path, cfg, device=ms.device),
                        exact=ms.device.type == "cpu")

    all_sims = []

    def new_sim() -> StreamSim:
        sim = StreamSim(int(rng.integers(1, 2**31)), w, h,
                        lifetime=int(rng.integers(50, 400)))
        verifier.register(sim)
        all_sims.append(sim)
        return sim

    # start half full; keep_alive, so the server outlives quiet moments
    sims = [new_sim() for _ in range(max(1, S // 2))]
    server = MultiStreamServer(ms, [s.source for s in sims], [s.sink for s in sims],
                               keep_alive=True)
    slot_sim = dict(enumerate(sims))

    # every rank drains on a SIGTERM from here on; then rank 0 may send one
    dist.barrier(group=mesh.host_group())
    if args.sigterm and args.duration and dist.get_rank() == 0:
        # the process the tool runs in: this one, or the spawned ranks' parent
        pid = os.getppid() if dist.get_world_size() > 1 else os.getpid()
        t = threading.Timer(args.sigterm_at or args.duration / 2,
                            lambda: os.kill(pid, signal.SIGTERM))
        t.daemon = True
        t.start()

    failures = []
    checked = [0]

    def sweep(label):
        for sim in all_sims:
            if len(sim.delivered) > sim.produced:
                failures.append(f"{label}: delivered {len(sim.delivered)} > produced "
                                f"{sim.produced} (ring leak)")
                return
            try:
                checked[0] += verifier.advance(sim)
            except AssertionError as e:
                failures.append(f"{label}: sim(seed={sim.seed}, life={sim.lifetime}, "
                                f"produced={sim.produced}, delivered={len(sim.delivered)}): "
                                f"{e}")
                return

    server.start()
    t0 = time.monotonic()
    rss0 = None
    ticks = attaches = detaches = deaths = 0
    try:
        while True:
            if agree(mesh, stop.is_set() or bool(
                    args.duration and time.monotonic() - t0 > args.duration))[0]:
                break
            if args.ticks and ticks >= args.ticks:
                break
            r = server.tick()
            if r is None:
                break
            if r:
                ticks += 1
            else:
                time.sleep(0.001)
            if ticks == 20 and rss0 is None:
                rss0 = rss_mb()   # after the first allocations and the ring's warm-up

            # a reader's death shows as the slot no longer live while attached
            # (on whichever rank serves it): detach it, so that the slot can be
            # used again
            live = server.live_slots()
            for slot, sim in list(slot_sim.items()):
                if not live[slot]:
                    server.detach(slot)
                    deaths += 1
                    del slot_sim[slot]

            if ticks and ticks % args.churn_every == 0 and r:
                if slot_sim and rng.random() < 0.5:
                    slot = list(slot_sim)[int(rng.integers(len(slot_sim)))]
                    slot_sim.pop(slot)
                    server.detach(slot)
                    detaches += 1
                elif len(slot_sim) < S:
                    sim = new_sim()
                    slot_sim[server.attach(sim.source, sim.sink)] = sim
                    attaches += 1

            if ticks and ticks % args.check_every == 0 and r:
                sweep("sweep")
                if failures:
                    break
    finally:
        server.finish()

    sweep("final")
    if server._ring:
        failures.append(f"result ring not empty after finish: {len(server._ring)} entries")
    rss1 = rss_mb()
    growth = rss1 - (rss0 if rss0 is not None else rss1)
    if growth > args.rss_budget_mb:
        failures.append(f"RSS grew {growth:.0f} MB > budget {args.rss_budget_mb:.0f} MB")

    # every rank's tallies of the streams it served
    mine = dict(failures=failures, produced=sum(s.produced for s in all_sims),
                delivered=sum(len(s.delivered) for s in all_sims), checked=checked[0],
                flip_frames=sum(s.v_diff_frames for s in all_sims),
                flip_sum=sum(s.v_diff_sum for s in all_sims))
    ranks = [None] * dist.get_world_size()
    dist.all_gather_object(ranks, mine)
    if dist.get_rank():
        return 0
    failures = [f for r in ranks for f in r["failures"]]
    checked[0] = sum(r["checked"] for r in ranks)
    dev = ms.device
    report = {
        "ok": not failures,
        "failures": failures,
        "duration_s": round(time.monotonic() - t0, 1),
        "ticks": ticks,
        "slots": S,
        "mesh": mesh.shape,
        "geometry": f"{w}x{h}",
        "model": os.path.basename(path),
        "streams_total": len(all_sims),
        "attaches": attaches,
        "detaches": detaches,
        "reader_deaths": deaths,
        # a stream's frames are produced on the lead of its data slice
        "frames_produced": sum(r["produced"] for r in ranks),
        "frames_delivered": sum(r["delivered"] for r in ranks),
        "identity_checked": checked[0],
        "identity_bar": ("byte-equal" if verifier.exact else
                         f"byte-equal outside the post's reach of near-tie decodes "
                         f"(|margin| <= {verifier.tie:g}), frame 2%, stream mean 0.2%"),
        "boundary_flip_frames": sum(r["flip_frames"] for r in ranks),
        "boundary_flip_mean_frac": round(sum(r["flip_sum"] for r in ranks)
                                         / max(checked[0], 1), 6),
        "sigterm_drained": bool(args.sigterm and stop.is_set()),
        "rss_warm_mb": round(rss0, 1) if rss0 is not None else None,
        "rss_end_mb": round(rss1, 1),
        "rss_growth_mb": round(growth, 1),
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"),
    }
    atomic_json_dump(report, args.report)
    print(json.dumps(report))
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
