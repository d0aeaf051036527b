"""Profile the PyTorch port's frame pipeline on one CUDA card.

Runs ``FramePipeline`` on the committed synthetic segm_lite-shaped model
(or ``--model``, e.g. the synthetic deeplab model) on the card, warms up,
then prints:

- ms/frame over ``--frames`` frames (host clock around work that ends in
  ``torch.cuda.synchronize()``);
- a ``torch.profiler`` window over ``--window`` frames: device time by
  kernel name, the device's busy time per frame and its idle share, and
  each of the port's own kernels' launches per frame and device time per
  launch;
- the device time of each body plan of the fused path (K2, or K2' and
  K2'') run alone on the frame's body input, by kernel name (each plan is
  one ``bs_body_mega`` launch over its op table: its ops and phases);
- optionally (``--trace PATH``) the window's Chrome trace;
- with ``--streams S``, each body plan's phase clock by op kind
  (``BodyPlan.phase_kinds``: the phases of each kind, their device us)
  on one frame and on a stream batch of S frames (stream s the moving
  sequence of seed s), one launch each, with the batch's us a frame.

``--classic`` runs the classic stages (``edge_fused=False``: preprocess
with K5, the graph executor), ``--output-format`` picks yuyv, nv12, i420
or bgr, ``--edge-cont on|off`` overrides the spec's choice of the flat
continuation plan (K2'') after a prefix (e.g. BodyPix's, off by default),
and ``--staged`` profiles ``MaskGen(fused=False).process`` (the staged
libbackscrub API, masks only) instead of the pipeline.

Usage::

    python tools/profile_torch_pipeline.py --width 640 --height 480
    python tools/profile_torch_pipeline.py --model tests/data/deeplab_synth_257.tflite
    python tools/profile_torch_pipeline.py --classic --output-format nv12
    python tools/profile_torch_pipeline.py --staged --model tests/data/deeplab_synth_257.tflite
    python tools/profile_torch_pipeline.py --model tests/data/body-pix_synth_050_8_257.tflite \
        --edge-cont on
    python tools/profile_torch_pipeline.py --model tests/data/selfie_synth_mlkit_256x256.tflite \
        --streams 8
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the __global__ functions of backscrub_tpu_torch/csrc (templates by name)
_PORT_KERNELS = {"front_kernel", "bilateral_kernel", "blend_pack_yuyv_kernel",
                 "blend_pack_420_kernel", "gemm_wg_kernel",
                 "splitk_sum_kernel", "body_mega_kernel"}


def _kernel_name(key: str) -> str:
    """A profiler key as a plain kernel name: no namespace, return type,
    template arguments or parameter list."""
    key = key.replace("(anonymous namespace)::", "")
    return key.removeprefix("void ").split("(")[0].split("<")[0]


def _print_phases(plan, x, runs: int = 20) -> None:
    """The plan's phases by the device clock (``BodyPlan.phase_ns``, the
    median of ``runs`` measurement runs), each with its table ops."""
    ns = np.median(np.array([plan.phase_ns(x) for _ in range(runs)]), axis=0)
    ops = {}
    for m in plan.mega.ops:
        ops.setdefault(m["level"], []).append(m)
    print(f"  phases by device clock (median of {runs} runs): {ns.sum() / 1e3:.2f} us")
    for level, t in enumerate(ns, 1):
        desc = ", ".join(f"{m['kind']}{'+res' if m.get('res') is not None else ''} "
                         f"{plan.meta[m['src']].c}->{plan.meta[m['out']].c}"
                         for m in ops.get(level, []))
        print(f"  phase {level}: {t / 1e3:.2f} us  {desc}")


def _print_kinds(edge, frames, streams: int, runs: int = 20) -> None:
    """Each body plan's phase clock by op kind (``BodyPlan.phase_kinds``)
    on ``frames[0]`` alone and on the batch ``frames[:streams]``."""
    import torch
    with torch.no_grad():
        xs = {1: edge.front(frames[0]), streams: edge.front(frames[:streams])}
    for name, plan in (("K2", edge.body_plan), ("K2'", edge.prefix_plan),
                       ("K2''", edge.cont_plan)):
        if plan is None:
            continue
        kinds = {}
        for S, h in xs.items():
            lead = h.shape[:-3]
            kinds[S] = plan.phase_kinds(h.reshape(lead + (h.shape[-3], -1)), runs)
            with torch.no_grad():
                xs[S] = plan(h.reshape(lead + (h.shape[-3], -1))).reshape(
                    lead + (plan.out_meta.c, plan.out_meta.rows, plan.out_meta.w))
        tot = {S: sum(t for _, t in k.values()) for S, k in kinds.items()}
        print(f"plan {name} phases by op kind (median of {runs} runs; us at S = 1 / "
              f"S = {streams}, and a frame): {tot[1] / 1e3:.2f} / {tot[streams] / 1e3:.2f}, "
              f"{tot[streams] / 1e3 / streams:.2f} a frame")
        for label in sorted(kinds[1], key=lambda k: -kinds[streams][k][1]):
            n, t1 = kinds[1][label]
            tS = kinds[streams][label][1]
            print(f"  {label}: {n} phases, {t1 / 1e3:.2f} / {tS / 1e3:.2f} us "
                  f"({tS / max(t1, 1.0):.2f}x; {100 * tS / tot[streams]:.1f}% of the batch)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", default=os.path.join(
        _REPO, "tests", "data", "segm_synth_lite_96x160.tflite"))
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--frames", type=int, default=200)
    ap.add_argument("--window", type=int, default=20)
    ap.add_argument("--trace", default="")
    ap.add_argument("--classic", action="store_true")
    ap.add_argument("--staged", action="store_true")
    ap.add_argument("--output-format", default="yuyv")
    ap.add_argument("--edge-cont", choices=("on", "off"), default=None,
                    help="the flat continuation after a prefix plan (default: the spec's)")
    ap.add_argument("--streams", type=int, default=0,
                    help="also each body plan's phase clock by op kind over a batch of S")
    a = ap.parse_args(argv)

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        print("profile_torch_pipeline: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, _REPO)
    sys.path.insert(0, os.path.join(_REPO, "tools"))
    from backscrub_tpu_torch.pipeline.frame import FramePipeline, PipelineConfig
    from backscrub_tpu_torch.pipeline.maskgen import MaskGen
    from make_synth_segm import moving_frames

    w, h = a.width, a.height
    frames = [torch.from_numpy(f).cuda() for f in moving_frames(w, h, 16)]
    bg = torch.from_numpy(np.random.default_rng(4).integers(
        0, 256, (h, w, 3), np.uint8)).cuda()
    if a.staged:
        mg = MaskGen(a.model, w, h, fused=False)     # on the card by default
        step, edge, what = (lambda f: mg.process(f)), None, "staged MaskGen"
    else:
        pipe = FramePipeline(a.model, PipelineConfig(
            width=w, height=h, edge_fused=False if a.classic else None,
            edge_cont=None if a.edge_cont is None else a.edge_cont == "on",
            output_format=a.output_format))
        step, edge = (lambda f: pipe.step(f, bg)), pipe.maskgen.edge
        what = f"{'classic' if edge is None else 'fused'} {a.output_format}"
    for i in range(20):
        step(frames[i % len(frames)])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(a.frames):
        step(frames[i % len(frames)])
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / a.frames
    print(f"{what} {w}x{h}: {ms:.4f} ms/frame over {a.frames} frames "
          f"({torch.cuda.get_device_name(0)})")

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(a.window):
            step(frames[i % len(frames)])
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    # device-side rows only (kernels, memcpy/memset): the aten rows repeat
    # the time of the kernels they launch
    busy_us = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA)
    busy_ms = busy_us / 1e3 / a.window
    print(f"profiler window: {a.window} frames, wall {wall / a.window:.4f} ms/frame "
          f"(profiled), device busy {busy_ms:.4f} ms/frame; idle share "
          f"{1 - busy_ms / ms:.3f} of the unprofiled {ms:.4f} ms/frame")
    print(prof.key_averages().table(sort_by="self_device_time_total", row_limit=30))
    # the port's own kernels (csrc/), by name: launches and device time
    for k in sorted(prof.key_averages(), key=lambda k: -k.self_device_time_total):
        name = _kernel_name(k.key)
        if k.device_type == DeviceType.CUDA and name in _PORT_KERNELS:
            print(f"port kernel {name}: {k.count / a.window:.1f} launches/frame, "
                  f"{k.self_device_time_total / k.count:.3f} us/launch, "
                  f"{k.self_device_time_total / a.window:.3f} us/frame")
    if a.trace:
        os.makedirs(os.path.dirname(os.path.abspath(a.trace)), exist_ok=True)
        prof.export_chrome_trace(a.trace)

    e = edge
    if e is not None and e.plans:
        with torch.no_grad():
            x = e.front(frames[0])
            for name, plan in (("K2", e.body_plan), ("K2'", e.prefix_plan),
                               ("K2''", e.cont_plan)):
                if plan is None:
                    continue
                m = plan.out_meta
                x = x.reshape(x.shape[0], -1)
                with profile(activities=[ProfilerActivity.CUDA]) as pp:
                    for _ in range(a.window):
                        y = plan(x)
                    torch.cuda.synchronize()
                rows = {k.key: k.self_device_time_total / a.window
                        for k in pp.key_averages() if k.device_type == DeviceType.CUDA}
                print(f"plan {name} -> {m.c}x{m.rows}x{m.w}, "
                      f"{dict(plan.kernels_per_run)} a run, {len(plan.mega.ops)} table ops "
                      f"in {plan.mega.phases} phases: device "
                      f"{sum(rows.values()):.2f} us/run; " + "; ".join(
                          f"{_kernel_name(k)} {v:.2f} us"
                          for k, v in sorted(rows.items(), key=lambda kv: -kv[1])))
                if plan.mega is not None:
                    _print_phases(plan, x)
                x = y
    if e is not None and e.plans and a.streams > 0:
        batch = torch.from_numpy(np.stack([moving_frames(w, h, 1, seed=s)[0]
                                           for s in range(a.streams)])).cuda()
        _print_kinds(e, batch, a.streams)
    return 0


if __name__ == "__main__":
    sys.exit(main())
