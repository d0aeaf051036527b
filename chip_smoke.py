#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU.

Usage (from the repository root, on a machine with a CUDA card)::

    python3 chip_smoke.py

1. prints the card's name and power limit (nvidia-smi);
2. builds the CUDA kernels from ``backscrub_tpu_torch/csrc`` (nvcc, sm_90a,
   one process per source);
3. holds each kernel against its plain PyTorch version on the card, at the
   main path's shapes (the committed synthetic segm_lite-shaped model at
   640x480 and 1280x720): K3 (blend + YUYV pack) byte-identical, K1
   (front) and K2 (body) within allclose(atol=2e-3, rtol=1e-3); times both
   with CUDA events;
4. runs ``FramePipeline`` for 50 frames of a seeded moving sequence at
   640x480 and 1280x720 on ``cuda``, checks that every kernel's launch
   counter rose as the path requires, and holds YUYV and mask against the
   port's plain path on the card under the repo's tolerance invariant (at
   most 2% of a frame's bytes differ, at most 0.2% over the sequence);
5. the deeplab path on the committed synthetic deeplabv3_257-shaped model
   at 640x480: K1 at the 257x257 canvas, K2' (the prefix plan), K2'' (the
   flat continuation plan) and its tiled GEMM alone against their plain
   versions (allclose(atol=2e-3, rtol=1e-3), CUDA-event times), then 30
   frames of ``FramePipeline`` against the plain path on the card under
   the tolerance invariant (every decode flip a near-tie of class 15's
   margin, the EMAs equal wherever the decode never flipped, no byte off
   by more than 1 outside the post's footprint of the EMA pixels that
   differ), every
   launch counter checked by kernel, and a person fraction strictly
   inside (0.01, 0.99);
6. prints one JSON line with every kernel's numbers, then
   ``{"ok": true, "device": {...}}`` as the last line.

Any failure raises and the script exits non-zero; without CUDA it exits 1
before printing any result.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
MODEL = os.path.join(REPO, "tests", "data", "segm_synth_lite_96x160.tflite")
SIZES = ((640, 480), (1280, 720))
FRAMES = 50
DEEPLAB = os.path.join(REPO, "tests", "data", "deeplab_synth_257.tflite")
DEEPLAB_SIZE, DEEPLAB_FRAMES = (640, 480), 30
PERSON, TIE = 15, 1e-3      # deeplab's person class; a near-tie decode margin
ATOL, RTOL = 2e-3, 1e-3
FRAME_TOL, MEAN_TOL = 0.02, 0.002


def timed(fn, n=30, warmup=3):
    """Mean ms per call of ``fn`` from CUDA event pairs around each call,
    with each output folded into a checksum outside the timed pairs."""
    import torch
    for _ in range(warmup):
        fn()
    checksum = torch.zeros((), dtype=torch.float64, device="cuda")
    pairs = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn()
        b.record()
        checksum += out.double().sum()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / n, float(checksum)


def kernel_phase(w, h):
    """K1, K2, K3 against their plain versions at one frame size."""
    import torch
    from backscrub_tpu_torch.ops.pack_kernels import (blend_pack_yuyv,
                                                      blend_pack_yuyv_plain)
    from backscrub_tpu_torch.pipeline.edge import front_fused, front_plain
    from backscrub_tpu_torch.pipeline.frame import FramePipeline, PipelineConfig
    from make_synth_segm import moving_frames

    pipe = FramePipeline(MODEL, PipelineConfig(width=w, height=h), device="cuda")
    edge = pipe.maskgen.edge
    if edge is None or edge.body_plan is None:
        raise RuntimeError("the synthetic model did not take the fused path")
    frame = torch.from_numpy(moving_frames(w, h, 1)[0]).cuda()
    res = {}
    with torch.no_grad():
        canvas, kw = edge.canvas(frame), edge.front_kwargs()
        k1 = front_fused(canvas, edge.front_params, **kw)
        p1 = front_plain(canvas, edge.front_params, **kw)
        torch.cuda.synchronize()
        torch.testing.assert_close(k1, p1, atol=ATOL, rtol=RTOL)
        res["front"] = dict(max_abs_err=float((k1 - p1).abs().max()),
                            ms=timed(lambda: front_fused(canvas, edge.front_params, **kw)),
                            plain_ms=timed(lambda: front_plain(canvas, edge.front_params, **kw)))

        plan = edge.body_plan
        x = k1.reshape(k1.shape[0], -1)
        k2, p2 = plan.run_cuda(x), plan.run_plain(x)
        torch.cuda.synchronize()
        torch.testing.assert_close(k2, p2, atol=ATOL, rtol=RTOL)
        res["body"] = dict(max_abs_err=float((k2 - p2).abs().max()),
                           ms=timed(lambda: plan.run_cuda(x)),
                           plain_ms=timed(lambda: plan.run_plain(x)))

        rng = np.random.default_rng(3)
        bg = torch.from_numpy(rng.integers(0, 256, (h, w, 3), np.uint8)).cuda()
        mask = rng.integers(0, 256, (h, w), np.uint8)
        mask[: h // 4] = 0
        mask[h // 4: h // 2] = 255
        mask = torch.from_numpy(mask).cuda()
        for order in ("reference", "yuy2"):
            for cc in (False, True):
                k3 = blend_pack_yuyv(frame, bg, mask, order, cc)
                p3 = blend_pack_yuyv_plain(frame, bg, mask, order, cc)
                if not torch.equal(k3, p3):
                    raise AssertionError(f"K3 differs from its plain version "
                                         f"({order}, correct_colors={cc})")
        res["pack"] = dict(max_abs_err=0.0,
                           ms=timed(lambda: blend_pack_yuyv(frame, bg, mask)),
                           plain_ms=timed(lambda: blend_pack_yuyv_plain(frame, bg, mask)))
    for name, r in res.items():
        print(f"kernel {name} {w}x{h}: max_abs_err={r['max_abs_err']:.3g} "
              f"kernel {r['ms'][0]:.4f} ms (checksum {r['ms'][1]:.6g}) "
              f"plain {r['plain_ms'][0]:.4f} ms (checksum {r['plain_ms'][1]:.6g})")
    return res


def plain_step(pipe, frame, bg, ema):
    """The port's main path with every kernel replaced by its plain version."""
    from backscrub_tpu_torch.ops.pack_kernels import blend_pack_yuyv_plain
    from backscrub_tpu_torch.pipeline.edge import front_plain
    e = pipe.maskgen.edge
    h = front_plain(e.canvas(frame), e.front_params, **e.front_kwargs())
    body = e.body_plan.run_plain(h.reshape(h.shape[0], -1))
    ema = e.tail(body, ema)
    mask = e.postprocess(ema)
    return blend_pack_yuyv_plain(frame, bg, mask), mask, ema


def pipeline_phase(w, h):
    """50 frames through FramePipeline on cuda: launch counts, outputs
    against the plain path, ms/frame."""
    import torch
    from backscrub_tpu_torch.ops.megakernel import body_launch
    from backscrub_tpu_torch.ops.pack_kernels import blend_pack_yuyv
    from backscrub_tpu_torch.pipeline.edge import front_fused
    from backscrub_tpu_torch.pipeline.frame import FramePipeline, PipelineConfig
    from make_synth_segm import moving_frames

    pipe = FramePipeline(MODEL, PipelineConfig(width=w, height=h), device="cuda")
    frames = [torch.from_numpy(f).cuda() for f in moving_frames(w, h, FRAMES)]
    bg = torch.from_numpy(np.random.default_rng(4).integers(
        0, 256, (h, w, 3), np.uint8)).cuda()
    for f in frames[:10]:             # warm-up: library load, allocator, cuBLAS
        pipe.step(f, bg)
    per_run = pipe.maskgen.edge.body_plan.launches_per_run
    want = dict(front=FRAMES, body=FRAMES * per_run, pack=FRAMES)

    def drive(keep):
        """One pass of the sequence from a fresh EMA; returns the launch
        counts of the pass and, with ``keep``, its outputs (the timed pass
        drops them, as a camera loop does, so the allocator reuses blocks)."""
        pipe.reset()
        torch.cuda.synchronize()
        front_fused.launches = body_launch.launches = blend_pack_yuyv.launches = 0
        outs = []
        for f in frames:
            out = pipe.step(f, bg)
            if keep:
                outs.append(out)
        torch.cuda.synchronize()
        counts = dict(front=front_fused.launches, body=body_launch.launches,
                      pack=blend_pack_yuyv.launches)
        if counts != want:
            raise AssertionError(f"launch counts {counts}, expected {want}")
        return counts, outs

    t0 = time.perf_counter()
    launches, _ = drive(keep=False)
    ms = (time.perf_counter() - t0) * 1e3 / FRAMES
    _, outs = drive(keep=True)

    ema = torch.full(pipe.maskgen.ema_shape, 255, dtype=torch.uint8, device="cuda")
    fracs, worst = [], 0
    with torch.no_grad():
        for f, (yuyv, mask) in zip(frames, outs):
            if yuyv.shape != (h, 2 * w) or mask.shape != (h, w) \
                    or yuyv.dtype != torch.uint8 or mask.dtype != torch.uint8:
                raise AssertionError(f"output shapes {yuyv.shape} {mask.shape}")
            ry, rm, ema = plain_step(pipe, f, bg, ema)
            d = torch.cat([(yuyv != ry).flatten(), (mask != rm).flatten()])
            frac = float(d.float().mean())
            worst = max(worst, int((yuyv.int() - ry.int()).abs().max()),
                        int((mask.int() - rm.int()).abs().max()))
            if frac > FRAME_TOL:
                raise AssertionError(f"{100 * frac:.3f}% of a frame's bytes differ")
            fracs.append(frac)
    if float(np.mean(fracs)) > MEAN_TOL:
        raise AssertionError(f"{100 * np.mean(fracs):.4f}% of bytes differ on average")
    person = float((outs[-1][1] < 128).float().mean())
    if not 0.01 < person < 0.99:
        raise AssertionError(f"degenerate mask: person fraction {person}")
    print(f"pipeline {w}x{h}: {FRAMES} frames, {ms:.4f} ms/frame (host clock, "
          f"synchronized), launches {launches}, differing bytes vs plain path "
          f"mean {100 * np.mean(fracs):.4f}% max {100 * max(fracs):.4f}%, "
          f"max byte diff {worst}, person fraction {person:.3f}")
    return launches, ms


def _held(name, k, p, fn_k, fn_p):
    """Hold kernel output ``k`` against plain ``p``; time both callables."""
    import torch
    torch.cuda.synchronize()
    torch.testing.assert_close(k, p, atol=ATOL, rtol=RTOL)
    r = dict(max_abs_err=float((k - p).abs().max()), ms=timed(fn_k), plain_ms=timed(fn_p))
    print(f"kernel {name} deeplab {DEEPLAB_SIZE[0]}x{DEEPLAB_SIZE[1]}: "
          f"max_abs_err={r['max_abs_err']:.3g} kernel {r['ms'][0]:.4f} ms "
          f"(checksum {r['ms'][1]:.6g}) plain {r['plain_ms'][0]:.4f} ms "
          f"(checksum {r['plain_ms'][1]:.6g})")
    return r


def deeplab_phase():
    """The deeplab path: K1 at 257x257, K2', K2'' and the GEMM against their
    plain versions, then DEEPLAB_FRAMES frames of FramePipeline on cuda
    against the plain path, with every launch counter checked."""
    import torch
    from backscrub_tpu_torch.ops.megakernel import (body_launch, conv1x1_gemm,
                                                    conv1x1_plain)
    from backscrub_tpu_torch.ops.pack_kernels import (blend_pack_yuyv,
                                                      blend_pack_yuyv_plain)
    from backscrub_tpu_torch.pipeline.decode import decode_val, ema_update
    from backscrub_tpu_torch.pipeline.edge import front_fused, front_plain, post_footprint
    from backscrub_tpu_torch.pipeline.frame import FramePipeline, PipelineConfig
    from make_synth_segm import moving_frames

    w, h = DEEPLAB_SIZE
    pipe = FramePipeline(DEEPLAB, PipelineConfig(width=w, height=h), device="cuda")
    e = pipe.maskgen.edge
    if e is None or e.prefix_plan is None or e.cont_plan is None:
        raise RuntimeError("the deeplab model did not take the prefix + continuation path")
    pre, cont = e.prefix_plan, e.cont_plan
    dils = sorted({p[8] for p in cont.plan if p[0] == "dw"})
    print(f"deeplab plans: prefix {len(pre.plan)} ops {dict(pre.kernels_per_run)}; "
          f"continuation {len(cont.plan)} ops {dict(cont.kernels_per_run)}, "
          f"depthwise dilations {dils}")
    if cont.kernels_per_run["bs_gemm"] == 0 or cont.kernels_per_run["bs_bcast"] == 0 \
            or not {2, 4} <= set(dils):
        raise AssertionError("the continuation plan lacks the GEMM, the broadcast "
                             "or the dilated depthwise convs")
    frames = [torch.from_numpy(f).cuda() for f in moving_frames(w, h, DEEPLAB_FRAMES)]
    res = {}
    with torch.no_grad():
        canvas, kw = e.canvas(frames[0]), e.front_kwargs()
        k1 = front_fused(canvas, e.front_params, **kw)
        res["front"] = _held("front", k1, front_plain(canvas, e.front_params, **kw),
                             lambda: front_fused(canvas, e.front_params, **kw),
                             lambda: front_plain(canvas, e.front_params, **kw))
        x = k1.reshape(k1.shape[0], -1)
        k2 = pre.run_cuda(x)
        res["body_prefix"] = _held("body_prefix", k2, pre.run_plain(x),
                                   lambda: pre.run_cuda(x), lambda: pre.run_plain(x))
        k3 = cont.run_cuda(k2)
        res["body_cont"] = _held("body_cont", k3, cont.run_plain(k2),
                                 lambda: cont.run_cuda(k2), lambda: cont.run_plain(k2))
        # the GEMM alone at the continuation's largest 1x1 (the ASPP projection)
        conv = max((p for p in cont.plan if p[0] == "conv1x1"),
                   key=lambda p: cont.weights[p[3]].size)
        ws = cont._weights_on(k2.device)
        gw, gb = ws[conv[3]], ws[conv[4]]
        gx = torch.from_numpy(np.random.default_rng(6).uniform(
            0, 2, (gw.shape[1], 33 * 33)).astype(np.float32)).cuda()
        kg = conv1x1_gemm(gw, gb, gx, conv[5])
        res["gemm"] = _held(f"gemm {tuple(gw.shape)}x{tuple(gx.shape)}", kg,
                            conv1x1_plain(gw, gb, gx, conv[5]),
                            lambda: conv1x1_gemm(gw, gb, gx, conv[5]),
                            lambda: conv1x1_plain(gw, gb, gx, conv[5]))

    bg = torch.from_numpy(np.random.default_rng(4).integers(
        0, 256, (h, w, 3), np.uint8)).cuda()
    for f in frames[:5]:
        pipe.step(f, bg)
    n = DEEPLAB_FRAMES
    want_kernels = {k: n * (pre.kernels_per_run[k] + cont.kernels_per_run[k])
                    for k in pre.kernels_per_run | cont.kernels_per_run}
    want = dict(front=n, body_prefix=n * pre.launches_per_run,
                body_cont=n * cont.launches_per_run, pack=n)

    def drive(keep):
        """One pass from a fresh EMA; with ``keep``, the outputs and the EMA
        after each frame."""
        pipe.reset()
        torch.cuda.synchronize()
        front_fused.launches = body_launch.launches = blend_pack_yuyv.launches = 0
        pre.launches = cont.launches = 0
        body_launch.by_kernel.clear()
        outs = []
        for f in frames:
            out = pipe.step(f, bg)
            if keep:
                outs.append(out + (pipe.maskgen.ema.clone(),))
        torch.cuda.synchronize()
        counts = dict(front=front_fused.launches, body_prefix=pre.launches,
                      body_cont=cont.launches, pack=blend_pack_yuyv.launches)
        if counts != want or dict(body_launch.by_kernel) != want_kernels:
            raise AssertionError(f"launch counts {counts} {dict(body_launch.by_kernel)}, "
                                 f"expected {want} {want_kernels}")
        return counts, outs

    t0 = time.perf_counter()
    launches, _ = drive(keep=False)
    ms = (time.perf_counter() - t0) * 1e3 / n
    _, outs = drive(keep=True)
    print(f"deeplab launches by kernel over {n} frames: {dict(body_launch.by_kernel)}")

    # The plain path, frame by frame from the same fresh EMA.  A decode
    # decision may flip where class 15's margin is a near-tie (the two
    # paths sum in different orders); the flip moves that EMA pixel by up
    # to 224 for the frames the EMA carries it, and the mask and YUYV bytes
    # it reaches through the post by more than 1.  So: every flip must be a
    # near-tie (|margin| <= TIE in the plain logits); the EMAs must be equal
    # at every pixel whose decode never flipped; and outside the footprint
    # of the pixels where the EMAs differ, no mask or YUYV byte may be off
    # by more than 1.
    ema = torch.full(pipe.maskgen.ema_shape, 255, dtype=torch.uint8, device="cuda")
    ever_flipped = torch.zeros_like(ema, dtype=torch.bool)
    fracs, worst, flips, flip_margin, masked = [], 0, 0, 0.0, 0
    with torch.no_grad():
        for f, (yuyv, mask, ema_k) in zip(frames, outs):
            if yuyv.shape != (h, 2 * w) or mask.shape != (h, w):
                raise AssertionError(f"output shapes {yuyv.shape} {mask.shape}")
            logits = e.body(e.front(f, plain=True), plain=True).permute(1, 2, 0)
            ema = ema_update(ema, decode_val(logits, e.spec))
            rm = e.postprocess(ema)
            ry = blend_pack_yuyv_plain(f, bg, rm)
            flipped = (ema_k >> 5) != (ema >> 5)
            if flipped.any():
                others = torch.cat([logits[..., :PERSON], logits[..., PERSON + 1:]], -1)
                margin = (logits[..., PERSON] - others.max(-1).values)[flipped].abs()
                flips += int(flipped.sum())
                flip_margin = max(flip_margin, float(margin.max()))
            ever_flipped |= flipped
            if not torch.equal(ema_k[~ever_flipped], ema[~ever_flipped]):
                raise AssertionError("the EMAs differ at a pixel whose decode never flipped")
            d = torch.cat([(yuyv != ry).flatten(), (mask != rm).flatten()])
            fracs.append(float(d.float().mean()))
            foot = post_footprint(ema_k != ema, e.geo, e.post_mats)
            pairs = foot.reshape(h, w // 2, 2).any(-1)
            foot_yuyv = pairs[..., None].expand(h, w // 2, 4).reshape(h, 2 * w)
            masked += int(foot.sum()) + int(foot_yuyv.sum())
            worst = max(worst,
                        int(torch.where(foot_yuyv, 0, (yuyv.int() - ry.int()).abs()).max()),
                        int(torch.where(foot, 0, (mask.int() - rm.int()).abs()).max()))
    person = float((outs[-1][1] < 128).float().mean())
    print(f"pipeline deeplab {w}x{h}: {n} frames, {ms:.4f} ms/frame (host clock, "
          f"synchronized), launches {launches}, differing bytes vs plain path mean "
          f"{100 * np.mean(fracs):.4f}% max {100 * max(fracs):.4f}% ({sum(map(bool, fracs))} "
          f"frames differ), decode flips {flips} (largest |margin| {flip_margin:.3g}), "
          f"bytes in the flips' footprint {masked} of {n * 3 * h * w}, max byte diff "
          f"outside it {worst}, person fraction {person:.3f}")
    if max(fracs) > FRAME_TOL or float(np.mean(fracs)) > MEAN_TOL or worst > 1:
        raise AssertionError("deeplab outputs outside the tolerance invariant")
    if flip_margin > TIE:
        raise AssertionError(f"a decode flip at |margin| {flip_margin} is not a near-tie")
    if not 0.01 < person < 0.99:
        raise AssertionError(f"degenerate mask: person fraction {person}")
    return res, launches, ms


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    sys.path.insert(0, os.path.join(REPO, "tools"))
    from backscrub_tpu_torch import _build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    _build.lib()
    nvcc = _build._Lib.build_seconds
    print(f"kernel build + load: {time.perf_counter() - t0:.2f} s ("
          + (f"nvcc {nvcc:.2f} s" if nvcc is not None else "cached library") + ")")

    kernels = {size: kernel_phase(*size) for size in SIZES}
    runs = {size: pipeline_phase(*size) for size in SIZES}
    t0 = time.perf_counter()
    dl_kernels, dl_launches, _ = deeplab_phase()
    print(f"deeplab phase: {time.perf_counter() - t0:.2f} s")
    main_size = SIZES[0]
    launches = dict(runs[main_size][0], body_prefix=dl_launches["body_prefix"],
                    body_cont=dl_launches["body_cont"])
    results = dict(kernels[main_size], body_prefix=dl_kernels["body_prefix"],
                   body_cont=dl_kernels["body_cont"])
    meta = {
        "front": ("backscrub_tpu_torch/csrc/front.cu", "backscrub_tpu/pipeline/edge.py:424"),
        "body": ("backscrub_tpu_torch/csrc/body.cu",
                 "backscrub_tpu/ops/megakernel.py:660 (BodyMega, full span)"),
        "pack": ("backscrub_tpu_torch/csrc/blend_pack.cu",
                 "backscrub_tpu/ops/pallas_kernels.py:156"),
        "body_prefix": ("backscrub_tpu_torch/csrc/body.cu",
                        "backscrub_tpu/ops/megakernel.py:712 (BodyMega, prefix mode)"),
        "body_cont": ("backscrub_tpu_torch/csrc/body_flat.cu",
                      "backscrub_tpu/ops/megakernel.py:794 (BodyMega flat=True, "
                      "continuation chain)"),
    }
    line = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name],
         "max_abs_err": results[name]["max_abs_err"],
         "ms": results[name]["ms"][0],
         "plain_ms": results[name]["plain_ms"][0]}
        for name, (src, rep) in meta.items()]}
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
