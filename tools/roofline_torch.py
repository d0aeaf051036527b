#!/usr/bin/env python3
"""Per-op roofline of the port's shipped step, from a device trace.

The counterpart of ``tools/roofline.py`` for ``backscrub_tpu_torch``:

1. builds the step the program ships: ``FramePipeline`` on segm_lite at
   1280x720 by default, YUYV out, the EMA carried from step to step
   (``--batch S``: one ``step_batch`` of S frames a step, their EMAs
   carried);
2. after ``--warmup`` steps, records a ``torch.profiler`` window of
   ``--steps`` steps with the input shapes of every op;
3. gives every device kernel the op that launched it
   (``backscrub_tpu_torch/utils/roofline.py:window_rows``): the port's
   hand-written kernels by their names, with the bytes and operations the
   port counts for them (``step_kernel_work``); cuBLAS, cuDNN and ATen
   kernels by the recorded input shapes of their ATen op (mm, addmm,
   convolution, elementwise, copy);
4. reports for each op its time a step, its share of the busy time,
   bytes and FLOPs a call, achieved GB/s and TFLOP/s, its bound (the
   least time the card could take for that work) and its share of that
   roof, and the window's idle share (1 - busy / the window's host-clock
   time).

The peaks come from ``utils/roofline.py``'s table by the card's name; a
card not in it needs all three ``--peak-*`` flags.  ``--device cpu`` runs
the plain versions and reports host times of the ATen ops (no device
exists there: ``clock`` says "host").  The last line of standard output is
one JSON object naming the device and its power limit (nvidia-smi);
``--json PATH`` writes the full record.

Usage::

    python tools/roofline_torch.py [--model segm_lite] [--batch 1]
        [--steps 10] [--warmup 5] [--json out.json] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir)
sys.path.insert(0, REPO)

from backscrub_tpu_torch.models.specs import (install_default_search_roots,  # noqa: E402
                                              resolve_model_path)

# short names: the committed synthetic models of each family's shapes
MODEL_SHORT = {
    "segm_lite": "tests/data/segm_synth_lite_96x160.tflite",
    "segm_full": "tests/data/segm_synth_full_144x256.tflite",
    "mlkit": "tests/data/selfie_synth_mlkit_256x256.tflite",
    "deeplab": "tests/data/deeplab_synth_257.tflite",
    "bodypix": "tests/data/body-pix_synth_050_8_257.tflite",
    "unet": "tests/data/unet_synth_256x256.tflite",
}


def model_path(name: str) -> str:
    """A short name's committed model, else the name resolved as the CLI
    resolves ``-m`` (a path, or a file under the search roots)."""
    if name in MODEL_SHORT:
        return os.path.normpath(os.path.join(REPO, MODEL_SHORT[name]))
    install_default_search_roots()
    return resolve_model_path(name)


def card(device: str) -> dict:
    """The device that ran: the card's name and power limit as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    prints them, or the CPU."""
    if device == "cpu":
        return {"platform": "cpu", "name": "cpu", "power_limit": None}
    import torch
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    line = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else ""
    name, _, limit = line.rpartition(", ")
    return {"platform": "gpu", "name": torch.cuda.get_device_name(0),
            "nvidia_smi": line, "smi_name": name or None, "power_limit": limit or None}


def peak_args(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--peak-hbm-gbs", type=float, help="memory GB/s (an unknown card)")
    ap.add_argument("--peak-f32-tflops", type=float, help="f32 TFLOP/s (an unknown card)")
    ap.add_argument("--peak-bf16-tflops", type=float, help="dense bf16 TFLOP/s")


def resolve(device: str):
    """``device`` as a torch.device; a card that is asked for must exist."""
    import torch
    if device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("CUDA is not available (pass --device cpu for the plain "
                         "versions on the CPU)")
    return torch.device(device)


def profiled(step, n: int, device: str):
    """A ``torch.profiler`` window (shapes recorded) of ``n`` calls of
    ``step``; on the card opened by an uncounted ``torch.cuda._sleep`` (the
    profiler leaves out a window's first kernel) and closed by a
    synchronize.  Returns (profiler, the window's host-clock µs)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device == "cuda" else [])
    if device == "cuda":
        torch.cuda.synchronize()
    with profile(activities=acts, record_shapes=True) as prof:
        if device == "cuda":
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        if device == "cuda":
            torch.cuda.synchronize()
        window = (time.perf_counter() - t0) * 1e6
    return prof, window


def analyze(pipe, step, steps: int, device: str, batch: int, peaks) -> dict:
    """The per-op roofline of ``steps`` calls of ``step``."""
    from backscrub_tpu_torch.utils import roofline as rl
    prof, window = profiled(step, steps, device)
    rows, busy = rl.window_rows(prof, device, rl.step_kernel_work(pipe, batch))
    out = []
    for r in rows:
        us = r.us / steps
        rec = {"op": r.op, "us_per_step": us, "share_of_busy": r.us / busy if busy else None,
               "calls_per_step": r.calls / steps, "kernels": sorted(r.kernels)[:4],
               "bytes": r.nbytes, "flops": r.ops + r.bf16_ops, "bf16_flops": r.bf16_ops,
               "how": r.how}
        if r.nbytes is not None:
            per_step = r.calls / steps
            b_ms, by = rl.bound(r.nbytes, r.ops, r.bf16_ops, peaks)
            rec.update(bound_us=b_ms * 1e3 * per_step, bound_by=by)
            if device == "cuda" and us > 0:
                rec.update(gbs=r.nbytes * per_step / (us * 1e-6) / 1e9,
                           tflops=(r.ops + r.bf16_ops) * per_step / (us * 1e-6) / 1e12,
                           share_of_roof=b_ms * 1e3 * per_step / us)
        out.append(rec)
    return {"steps": steps, "busy_us_per_step": busy / steps,
            "window_us_per_step": window / steps,
            "idle_share": max(0.0, 1.0 - busy / window) if window else None,
            "rows": out}


def make_step(pipe, w: int, h: int, batch: int, device):
    """The shipped step on seeded frames (two frames alternating, one
    background), the EMA carried; a stream batch through ``step_batch``."""
    import torch
    rng = np.random.default_rng(0)
    shp = (batch, h, w, 3) if batch > 1 else (h, w, 3)
    frames = [torch.from_numpy(rng.integers(0, 256, shp, np.uint8)).to(device)
              for _ in range(2)]
    bg = torch.from_numpy(rng.integers(0, 256, shp, np.uint8)).to(device)
    state = {"i": 0, "ema": torch.full((batch,) + tuple(pipe.maskgen.ema_shape), 255,
                                       dtype=torch.uint8, device=device)}

    @torch.no_grad()
    def step():
        f = frames[state["i"] % 2]
        state["i"] += 1
        if batch > 1:
            out, _, state["ema"] = pipe.step_batch(f, bg, state["ema"])
            return out
        return pipe.step(f, bg)[0]
    return step


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="segm_lite",
                    help=f"{', '.join(MODEL_SHORT)} or a model path")
    ap.add_argument("--width", type=int, default=1280)
    ap.add_argument("--height", type=int, default=720)
    ap.add_argument("--batch", type=int, default=1, help="streams a step (step_batch)")
    ap.add_argument("--steps", type=int, default=10, help="steps in the profiled window")
    ap.add_argument("--warmup", type=int, default=5)
    ap.add_argument("--precision", choices=("highest", "high", "default"))
    ap.add_argument("--top", type=int, default=25, help="rows on the last line")
    ap.add_argument("--json", help="write the full record here")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    peak_args(ap)
    a = ap.parse_args(argv)

    import torch
    from backscrub_tpu_torch.pipeline.frame import FramePipeline, PipelineConfig
    from backscrub_tpu_torch.utils import roofline as rl
    from backscrub_tpu_torch.utils.artifacts import atomic_json_dump
    dev = resolve(a.device)
    dcard = card(a.device)
    # on the CPU the bounds are still the H100 SXM's (what the work would
    # need there); no rate or roof share is computed from host times
    peaks = (rl.peaks_for(dcard["name"], a.peak_hbm_gbs, a.peak_f32_tflops,
                          a.peak_bf16_tflops) if a.device == "cuda" else rl.H100_SXM)
    path = model_path(a.model)
    pipe = FramePipeline(path, PipelineConfig(width=a.width, height=a.height), device=dev,
                         precision=a.precision)
    step = make_step(pipe, a.width, a.height, a.batch, dev)
    for _ in range(a.warmup):
        step()
    rec = analyze(pipe, step, a.steps, a.device, a.batch, peaks)
    rec.update(tool="roofline_torch", model=a.model, model_path=os.path.relpath(path, REPO),
               width=a.width, height=a.height, batch=a.batch,
               fused=pipe.maskgen.edge is not None, clock="device" if a.device == "cuda"
               else "host", device=dcard,
               peaks={"bytes_per_s": peaks.bytes_per_s, "f32_flops": peaks.f32_flops,
                      "bf16_flops": peaks.bf16_flops}, torch=torch.__version__)
    if a.json:
        atomic_json_dump(rec, a.json)
    print(f"{dcard.get('nvidia_smi') or dcard['name']}; {a.model} {a.width}x{a.height} batch "
          f"{a.batch}: busy {rec['busy_us_per_step']:.2f} us a step of "
          f"{rec['window_us_per_step']:.2f} ({rec['clock']} clock), idle share "
          f"{rec['idle_share']:.4f}", file=sys.stderr)
    for r in rec["rows"][:a.top]:
        rates = (f"{r['gbs']:8.1f} GB/s {r['tflops']:7.3f} TFLOP/s roof "
                 f"{100 * r['share_of_roof']:5.1f}%" if "gbs" in r else
                 f"bound {r.get('bound_us') or 0:8.3f} us ({r.get('bound_by')})")
        print(f"  {r['us_per_step']:9.2f} us {100 * (r['share_of_busy'] or 0):5.1f}%  {rates}  "
              f"{r['op'][:70]}", file=sys.stderr)
    print(json.dumps(dict(rec, rows=rec["rows"][:a.top])))
    return 0


if __name__ == "__main__":
    sys.exit(main())
