"""Check that a kernel's wrapper gives the same bits as the same wrapper of
another checkout of this repository (an earlier commit, unpacked with
``git archive``), on one CUDA card.

Each case is a list of calls of one wrapper, named as ``module:function``,
on inputs made here and saved with ``torch.save``.  Each checkout runs
the calls in a subprocess of its own (its ``_build.py`` builds its library
into its own ``_build/``), so any wrapper whose arguments did not change
between the two checkouts can be compared.  The cases:

- ``front``: K1, ``front_fused`` on ``chip_smoke.py``'s canvases: the segm
  front on the first frame at 640x480 and 1280x720, the deeplab front on
  the first held-out deeplab frame (seed 1, frame 30), each with its
  model's parameter block and options, at the tile ``front_tile`` picks;
- ``gemm``: the K2'' GEMM tile alone, ``conv1x1_gemm`` under RELU6 at
  every 1x1 shape of the deeplab frame and at ragged ones, on seeded
  inputs, at ``gemm_config``'s tile and split, at three terms (the bf16x3
  split of "high"); ``gemm_bf16`` the same with ``terms=1`` (the bf16
  mode's one-term tile) and ``gemm_highest`` with ``terms=6`` (the
  six-term tile of "highest"); all timed at the deeplab shapes (the kernel
  alone, without a split-K sum pass); the three-term calls reported, not
  held: a build whose tile sums in another order (the wgmma tile of
  ``csrc/gemm_wg.cuh`` against the ``mma.sync`` tile of ``gemm_tc.cuh``
  before it) differs in the last bits, and each build is held to the
  plain twins by ``chip_smoke.py`` and the card tests; the one- and
  six-term calls held bit for bit;
- ``body``: the body plans, ``MaskGen(...).edge.body`` on K1's output of
  the first held-out deeplab frame at "high" (K2' and K2'' with the
  three-term GEMM, then the executor's resize; reported, as its GEMM's
  tile may sum in another order) and "default" (the bf16 tables), and of
  segm_lite's first frame at 640x480 (K2), held bit for bit;
- ``cont``: K2'' alone, ``edge.cont_plan`` on the prefix's output of that
  deeplab frame at "high" (reported), "default" and "highest" (held bit
  for bit), timed, and K2' alone at "high" (held bit for bit);
- ``batch``: every body plan of the fused path, one image and a stream
  batch of 4 and of 8 (``BATCHES``): segm_lite's, mlkit's and segm_full's
  K2, BodyPix's K2' and deeplab's K2' and K2'' at "high", "default" and
  "highest", each on its input from ``chip_smoke.py``'s moving frames at
  640x480 (stream s the sequence of seed s: K1's output, then each plan's
  output for the next plan), held bit for bit and timed;
- ``jpeg``: ``bs_jpeg_decode``, ``decode_jpeg_bgr`` on the synthetic MJPG
  camera's frames at 640x480 and 1280x720 (timed) and on seeded
  coefficients at every sampling, gray and odd sizes, bit for bit;
- ``bilateral``: K5, ``bilateral5`` on seeded u8-valued canvases at
  (1, 96, 160), (1, 257, 257), (4, 257, 257) and (2, 5, 7);
- ``pack420``: K4, ``blend_pack_420`` NV12 and I420 on seeded frames,
  backgrounds and masks at 480x640, 720x1280, 42x58 and 480x642;
- ``pack_yuyv``: K3, ``blend_pack_yuyv`` in both chroma orders, with and
  without colour correction, on the same inputs;
- ``probe_se``: P4, ``se`` on the original probe inputs (16, 3840) and at
  (5, 333) and (32, 100000);
- ``probe_dot``: P3, ``dot`` at DEFAULT, HIGH and HIGHEST on the original
  probe inputs and at n = 37;
- ``probe_dw_flat``, ``probe_dw_rowpad``: P1 and P2, ``dw_flat`` and
  ``dw_rowpad``, at ``tools/probe_hopper.py``'s ``STENCIL_SHAPES`` on
  seeded inputs (the probe shape and the shapes of the scalar path), bit
  for bit;
- ``probe_cat``: P5, ``concat``, at ``tools/probe_hopper.py``'s
  ``CAT_SHAPES`` (the probe shape on the original's inputs), bit for bit;
  its kernel was ``cat_kernel`` before the two-source copy;
- ``probe_stride2``, ``probe_copy``: P6 and P7, ``lane_stride2`` and
  ``reshape_flat``, at ``tools/probe_hopper.py``'s ``COPY_SHAPES`` (the
  probe shape on the original's input), bit for bit.  Their kernels were
  ``stride2_kernel`` and ``cat_kernel`` before the strided copy.  A build
  whose CUDA sources do not name a call's kernel (``jpeg_decode_kernel`` is
  ``idct_kernel`` and ``color_kernel`` before the one-launch decode) is
  timed by the old names.  The GEMM calls are timed by the kernels whose
  name starts with ``gemm_`` (``gemm_wg_kernel``; ``gemm_tc_kernel`` at
  three terms before the wgmma tile took them).

Prints, per call, whether the outputs are bit-identical (else how many
values differ and by how much) and exits 1 if any differs; the probe
calls, whose kernels may sum in another order than the other build's,
print the largest difference instead and fail above 2e-5, and the calls
marked reported print it and never fail.  With
``--time`` it also times the kernel of each call at a main path's shape
(K1's canvases, K5 at the three canvas shapes, K3 and K4 at 640x480
and 1280x720, the probes on the original's inputs) in each checkout by the
profiler's device time a launch, warm
(the inputs in the 50 MB L2) and cold (a 128 MB buffer overwritten
before each launch), both by this checkout's ``chip_smoke.device_ms``,
in fresh subprocesses in turns: the other, this, this, the other.

Usage (from the repository root, on a machine with a CUDA card)::

    python tools/bits_vs_build.py OTHER_CHECKOUT [--time] [front] [gemm] [gemm_bf16]
        [gemm_highest] [body] [cont] [batch] [jpeg] [bilateral] [pack420]
        [pack_yuyv] [probe_se] [probe_dot] [probe_dw_flat] [probe_dw_rowpad] [probe_cat]
        [probe_stride2] [probe_copy]
"""

import os
import subprocess
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# run in a checkout: each call's wrapper on the saved inputs, on the card
# (a call with ``build`` first builds an object by that callable, and its
# ``wrapper`` is an attribute path on it); given a timer file (this
# checkout's chip_smoke.py), also its kernel's device us a launch by that
# file's device_ms, warm and cold
_RUN = """
import functools, importlib, importlib.util, sys, torch
sys.path.insert(0, sys.argv[1])
import backscrub_tpu_torch  # this checkout's, before the timer puts its own repository first
device_ms = None
if len(sys.argv) > 4:
    spec = importlib.util.spec_from_file_location("timer", sys.argv[4])
    timer = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(timer)
    device_ms = timer.device_ms
def dev(v):
    if isinstance(v, dict) and "make" in v:      # an argument built in the checkout
        mod, name = v["make"].split(":")
        return getattr(importlib.import_module(mod), name)(*v["args"])
    if isinstance(v, list):
        return [dev(t) for t in v]
    return v.cuda() if isinstance(v, torch.Tensor) else v
# a call's kernel by its name in this checkout's sources, else its old_kernel
import glob
SOURCES = "".join(open(f).read() for f in glob.glob("backscrub_tpu_torch/csrc/*.cu*"))
outs, times = [], []
with torch.no_grad():
    for c in torch.load(sys.argv[2]):
        if "build" in c:
            mod, name = c["build"].split(":")
            obj = getattr(importlib.import_module(mod), name)(*c["build_args"],
                                                              **c["build_kwargs"])
            fn = functools.reduce(getattr, c["wrapper"].split("."), obj)
        else:
            mod, name = c["wrapper"].split(":")
            fn = getattr(importlib.import_module(mod), name)
        call = functools.partial(fn, *map(dev, c["args"]),
                                 **{k: dev(v) for k, v in c["kwargs"].items()})
        outs.append(call().cpu())
        if device_ms is not None:
            k = c["kernel"]
            if "old_kernel" in c and k.lstrip(":") not in SOURCES:
                k = c["old_kernel"]
            ks = k if isinstance(k, (list, tuple)) else [k]   # a call's kernels, summed
            times.append((sum(1e3 * device_ms(call, kernel=q) for q in ks),
                          sum(1e3 * device_ms(call, cold=q) for q in ks)))
torch.save((outs, times), sys.argv[3])
"""

GEMM_SHAPES = [(16, 96), (21, 256), (32, 96), (32, 192), (48, 192), (48, 288), (80, 288),
               (80, 480), (96, 16), (160, 480), (192, 32), (256, 160), (256, 512),
               (288, 48), (480, 80)]
GEMM_L = 33 * 33
GEMM_RAGGED = [(7, 5, 33), (33, 100, 77), (130, 13, 1)]


def front_calls():
    """(name, call) of K1 on chip_smoke.py's three canvases."""
    import torch
    sys.path.insert(0, os.path.join(REPO, "tools"))
    from chip_smoke import DEEPLAB, DEEPLAB_FRAMES, MODEL, SIZES
    from backscrub_tpu_torch.pipeline.frame import FramePipeline, PipelineConfig
    from make_synth_segm import moving_frames

    inputs = [((w, h), MODEL, moving_frames(w, h, 1)[0]) for w, h in SIZES]
    inputs.append(((640, 480), DEEPLAB,
                   moving_frames(640, 480, 2 * DEEPLAB_FRAMES, seed=1)[DEEPLAB_FRAMES]))
    calls = []
    with torch.no_grad():
        for (w, h), path, frame in inputs:
            e = FramePipeline(path, PipelineConfig(width=w, height=h),
                              device="cuda").maskgen.edge
            canvas = e.canvas(torch.from_numpy(frame).cuda()).cpu()
            calls.append((f"front {os.path.basename(path)} {w}x{h}", dict(
                wrapper="backscrub_tpu_torch.pipeline.edge:front_fused", kernel="front_kernel",
                timed=True, args=[canvas, e.front_params.cpu()], kwargs=e.front_kwargs())))
    return calls


def gemm_calls():
    """(name, call) of the three-term GEMM at the deeplab shapes and ragged
    ones: reported, the deeplab shapes timed."""
    import torch
    calls = []
    for co, ci, n in [(co, ci, GEMM_L) for co, ci in GEMM_SHAPES] + GEMM_RAGGED:
        rng = np.random.default_rng(co * 1000 + ci)
        w, x = (torch.from_numpy((rng.standard_normal(s) / np.sqrt(ci)).astype(np.float32))
                for s in ((co, ci), (ci, n)))
        b = torch.from_numpy(rng.standard_normal(co).astype(np.float32))
        calls.append((f"gemm {co}x{ci}x{n}", dict(
            wrapper="backscrub_tpu_torch.ops.megakernel:conv1x1_gemm", kernel="::gemm_",
            exact=False, tol=None, timed=n == GEMM_L,
            args=[w, b, x], kwargs=dict(act="RELU6"))))
    return calls


def _wgmma_calls(terms):
    """(name, call) of the GEMM at ``terms`` 1 or 6 at the ``gemm`` case's
    inputs: held bit for bit, the deeplab shapes timed."""
    return [(f"{name} terms={terms}", dict(call, kwargs=dict(call["kwargs"], terms=terms),
                                             exact=True))
            for name, call in gemm_calls()]


def gemm_bf16_calls():
    """(name, call) of the one-term GEMM at the ``gemm`` case's inputs."""
    return _wgmma_calls(1)


def gemm_highest_calls():
    """(name, call) of the six-term GEMM at the ``gemm`` case's inputs."""
    return _wgmma_calls(6)


def body_calls():
    """(name, call) of the body plans of deeplab at "high" and "default"
    and of segm_lite, each on its K1 output of ``chip_smoke.py``'s first
    frame (deeplab's first held-out one)."""
    import torch
    sys.path.insert(0, os.path.join(REPO, "tools"))
    from chip_smoke import DEEPLAB, DEEPLAB_FRAMES, MODEL
    from backscrub_tpu_torch.pipeline.maskgen import MaskGen
    from make_synth_segm import moving_frames

    calls = []
    for path, frame, precs in (
            (DEEPLAB, moving_frames(640, 480, 2 * DEEPLAB_FRAMES, seed=1)[DEEPLAB_FRAMES],
             ("high", "default")),
            (MODEL, moving_frames(640, 480, 1)[0], ("highest",))):
        for prec in precs:
            kw = dict(device="cuda", precision=prec)
            with torch.no_grad():
                h = MaskGen(path, 640, 480, **kw).edge.front(torch.from_numpy(frame).cuda())
            # deeplab's "high" tables run the three-term GEMM: reported
            calls.append((f"body {os.path.basename(path)} {prec}", dict(
                build="backscrub_tpu_torch.pipeline.maskgen:MaskGen",
                build_args=[path, 640, 480], build_kwargs=kw, wrapper="edge.body",
                kernel="body_mega_kernel", args=[h.cpu()], kwargs={},
                **(dict(exact=False, tol=None) if prec == "high" else {}))))
    return calls


def cont_calls():
    """(name, call) of K2'' alone at "high", "default" and "highest", each
    on its prefix's output of ``chip_smoke.py``'s first held-out deeplab
    frame, timed ("high", the three-term GEMM's, reported; the others held
    bit for bit), and K2' alone at "high" on K1's output, held bit for
    bit."""
    import torch
    sys.path.insert(0, os.path.join(REPO, "tools"))
    from chip_smoke import DEEPLAB, DEEPLAB_FRAMES
    from backscrub_tpu_torch.pipeline.maskgen import MaskGen
    from make_synth_segm import moving_frames

    frame = moving_frames(640, 480, 2 * DEEPLAB_FRAMES, seed=1)[DEEPLAB_FRAMES]
    calls = []
    for prec in ("high", "default", "highest"):
        kw = dict(device="cuda", precision=prec)
        with torch.no_grad():
            e = MaskGen(DEEPLAB, 640, 480, **kw).edge
            k1 = e.front(torch.from_numpy(frame).cuda()).reshape(16, -1)
            x = e.prefix_plan(k1)
        if prec == "high":
            calls.append(("prefix deeplab high", dict(
                build="backscrub_tpu_torch.pipeline.maskgen:MaskGen",
                build_args=[DEEPLAB, 640, 480], build_kwargs=kw, wrapper="edge.prefix_plan",
                kernel="body_mega_kernel", args=[k1.cpu()], kwargs={})))
        calls.append((f"cont deeplab {prec}", dict(
            build="backscrub_tpu_torch.pipeline.maskgen:MaskGen",
            build_args=[DEEPLAB, 640, 480], build_kwargs=kw, wrapper="edge.cont_plan",
            kernel="body_mega_kernel", timed=True, args=[x.cpu()], kwargs={},
            **(dict(exact=False, tol=None) if prec == "high" else {}))))
    return calls


BATCHES = (1, 4, 8)


def batch_calls():
    """(name, call) of every fused body plan of the five families at
    BATCHES images, held bit for bit and timed."""
    import torch
    sys.path.insert(0, os.path.join(REPO, "tools"))
    from chip_smoke import BODYPIX, DEEPLAB, MODEL, SEGM_FULL, SELFIE
    from backscrub_tpu_torch.pipeline.maskgen import MaskGen
    from make_synth_segm import moving_frames

    frames = torch.from_numpy(np.stack([moving_frames(640, 480, 1, seed=s)[0]
                                        for s in range(max(BATCHES))])).cuda()
    calls = []
    for path, prec in ((MODEL, "highest"), (SELFIE, "highest"), (SEGM_FULL, "highest"),
                       (BODYPIX, "highest"), (DEEPLAB, "high"), (DEEPLAB, "default"),
                       (DEEPLAB, "highest")):
        kw = dict(device="cuda", precision=prec)
        e = MaskGen(path, 640, 480, **kw).edge
        for S in BATCHES:
            with torch.no_grad():
                h = e.front(frames[:S] if S > 1 else frames[0])
                x = h.reshape(h.shape[:-3] + (h.shape[-3], -1))
                for attr in ("body_plan", "prefix_plan", "cont_plan"):
                    plan = getattr(e, attr)
                    if plan is None:
                        continue
                    calls.append((f"batch {os.path.basename(path)} {prec} {attr} S={S}", dict(
                        build="backscrub_tpu_torch.pipeline.maskgen:MaskGen",
                        build_args=[path, 640, 480], build_kwargs=kw, wrapper=f"edge.{attr}",
                        kernel="body_mega_kernel", timed=True, args=[x.cpu()], kwargs={})))
                    x = plan(x)
    return calls


JPEG_SAMPLINGS = {"420": ((2, 2), (1, 1), (1, 1)), "422": ((2, 1), (1, 1), (1, 1)),
                  "444": ((1, 1), (1, 1), (1, 1)), "440": ((1, 2), (1, 1), (1, 1)),
                  "411": ((4, 1), (1, 1), (1, 1)), "311": ((3, 1), (1, 1), (1, 1)),
                  "gray": ((1, 1),)}


def jpeg_calls():
    """(name, call) of the decode: the synthetic camera's JPEGs at 640x480
    and 1280x720, timed, and seeded coefficients at every sampling at
    63x47 and 64x48."""
    import torch
    from backscrub_tpu_torch.io import streams
    from backscrub_tpu_torch.io.jpeg import JpegEntropyDecoder

    def call(w, h, sf, coefs, q, timed):
        info = dict(make="backscrub_tpu_torch.io.jpeg:make_info", args=[w, h, sf, len(sf)])
        return dict(wrapper="backscrub_tpu_torch.ops.jpeg_kernels:decode_jpeg_bgr",
                    kernel="jpeg_decode_kernel", old_kernel=("idct_kernel", "color_kernel"),
                    timed=timed, args=[[torch.from_numpy(c) for c in coefs],
                                       torch.from_numpy(np.asarray(q, np.int32)), info],
                    kwargs={})
    calls = []
    for w, h in ((640, 480), (1280, 720)):
        dec = JpegEntropyDecoder()
        coefs, q = dec.decode(streams.SyntheticJpegCamera(w, h)())
        sf = tuple(dec.info.sampling)
        calls.append((f"jpeg camera {w}x{h}", call(w, h, sf, coefs, q, True)))
    for name, sf in JPEG_SAMPLINGS.items():
        for w, h in ((63, 47), (64, 48)):
            hm, vm = max(s[0] for s in sf), max(s[1] for s in sf)
            blocks = [(-(-h // (8 * vm)) * v, -(-w // (8 * hm)) * hh) for hh, v in sf]
            rng = np.random.default_rng(w * h + len(name))
            coefs = [rng.integers(-40, 41, (bh, bw, 64)).astype(np.int16) for bh, bw in blocks]
            q = rng.integers(1, 50, (len(sf), 64))
            calls.append((f"jpeg {name} {w}x{h}", call(w, h, sf, coefs, q, False)))
    return calls


BILATERAL_SHAPES = [(1, 96, 160), (1, 257, 257), (4, 257, 257), (2, 5, 7)]
PACK420_SHAPES = [(480, 640), (720, 1280), (42, 58), (480, 642)]


def bilateral_calls():
    """(name, call) of K5 on seeded canvases at the classic path's shapes."""
    import torch
    calls = []
    for n, h, w in BILATERAL_SHAPES:
        x = torch.from_numpy(np.random.default_rng(n * h * w).integers(
            0, 256, (n, h, w, 3)).astype(np.float32))
        calls.append((f"bilateral {n}x{h}x{w}", dict(
            wrapper="backscrub_tpu_torch.ops.image_kernels:bilateral5",
            kernel="bilateral_kernel", timed=h > 5, args=[x], kwargs={})))
    return calls


def _pack_inputs():
    """(h, w, frame, background, mask) of the packs' seeded inputs at
    PACK420_SHAPES."""
    import torch
    for h, w in PACK420_SHAPES:
        rng = np.random.default_rng(h + w)
        fr, bg = (torch.from_numpy(rng.integers(0, 256, (h, w, 3), np.uint8))
                  for _ in range(2))
        m = rng.integers(0, 256, (h, w), np.uint8)
        m[: h // 4], m[h // 4: h // 2] = 255, 0
        yield h, w, fr, bg, torch.from_numpy(m)


def pack420_calls():
    """(name, call) of K4, NV12 and I420, on seeded inputs."""
    return [(f"pack420 {layout} {h}x{w}", dict(
        wrapper="backscrub_tpu_torch.ops.pack_kernels:blend_pack_420",
        kernel="blend_pack_420_kernel", timed=(h, w) in ((480, 640), (720, 1280)),
        args=[fr, bg, m, layout], kwargs={}))
        for h, w, fr, bg, m in _pack_inputs() for layout in ("nv12", "i420")]


def pack_yuyv_calls():
    """(name, call) of K3 in both chroma orders, with and without colour
    correction, on the packs' seeded inputs."""
    return [(f"pack_yuyv {order} cc={cc} {h}x{w}", dict(
        wrapper="backscrub_tpu_torch.ops.pack_kernels:blend_pack_yuyv",
        kernel="blend_pack_yuyv_kernel",
        timed=(h, w) in ((480, 640), (720, 1280)) and order == "reference" and not cc,
        args=[fr, bg, m, order, cc], kwargs={}))
        for h, w, fr, bg, m in _pack_inputs() for order in ("reference", "yuy2")
        for cc in (False, True)]


def _probe_inputs():
    """The original probe inputs x2 (16, 3840) and w16 (16, 16) as tensors."""
    import torch
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import probe_hopper
    a = probe_hopper.inputs()
    return torch.from_numpy(a["x2"]), torch.from_numpy(a["w16"])


def _stencil_calls(probe, wrapper):
    """(name, call) of a stencil probe's wrapper at probe_hopper's
    STENCIL_SHAPES of that probe: the probe shape on the original's input,
    timed, the others on seeded inputs."""
    import torch
    import probe_hopper
    orig = probe_hopper.inputs()["xpad" if probe == "P1" else "xp"]
    calls = []
    for name, (p, c, n, width, _) in probe_hopper.STENCIL_SHAPES.items():
        if p != probe:
            continue
        x = torch.from_numpy(orig if name.endswith("original") else
                             np.random.default_rng(c * n).random((c, n), np.float32))
        calls.append((f"probe_{wrapper} {name}", dict(
            wrapper=f"backscrub_tpu_torch.ops.probe_kernels:{wrapper}", kernel="::dw9_",
            timed=name.endswith("original"), args=[x] + ([width] if width else []),
            kwargs={})))
    return calls


def probe_dw_flat_calls():
    """(name, call) of P1, ``dw_flat``, on the original's input and at the
    other P1 stencil shapes."""
    _probe_inputs()            # puts tools/ on sys.path
    return _stencil_calls("P1", "dw_flat")


def probe_dw_rowpad_calls():
    """(name, call) of P2, ``dw_rowpad``, as probe_dw_flat_calls."""
    _probe_inputs()
    return _stencil_calls("P2", "dw_rowpad")


def _copy_calls(probe, wrapper, old_kernel):
    """(name, call) of a copy probe's wrapper at probe_hopper's COPY_SHAPES
    of that probe: the probe shape on the original's input, timed, the
    others on seeded inputs; ``old_kernel`` its kernel's name in a build
    without the strided copy."""
    import torch
    _probe_inputs()            # puts tools/ on sys.path
    import probe_hopper
    orig = probe_hopper.inputs()["x2" if probe == "P6" else "x3"]
    calls = []
    for name, (p, shape, _) in probe_hopper.COPY_SHAPES.items():
        if p != probe:
            continue
        x = torch.from_numpy(orig if name.endswith("original") else
                             np.random.default_rng(sum(shape)).random(shape, np.float32))
        calls.append((f"probe_{wrapper} {name}", dict(
            wrapper=f"backscrub_tpu_torch.ops.probe_kernels:{wrapper}",
            kernel="::strided_copy_", old_kernel=old_kernel, timed=name.endswith("original"),
            args=[x], kwargs={})))
    return calls


def probe_cat_calls():
    """(name, call) of P5, ``concat``, at probe_hopper's CAT_SHAPES: the
    probe shape on the original's inputs, timed, the others on seeded
    inputs; ``cat_kernel`` its kernel's name in a build without the
    two-source copy."""
    import torch
    x2, _ = _probe_inputs()    # puts tools/ on sys.path
    import probe_hopper
    calls = []
    for name, (sa, sb, _) in probe_hopper.CAT_SHAPES.items():
        rng = np.random.default_rng(sum(sa) + sum(sb))
        a, b = ((x2, x2) if name.endswith("original") else
                (torch.from_numpy(rng.random(s, np.float32)) for s in (sa, sb)))
        calls.append((f"probe_concat {name}", dict(
            wrapper="backscrub_tpu_torch.ops.probe_kernels:concat", kernel="::concat_",
            old_kernel="::cat_kernel", timed=name.endswith("original"), args=[a, b],
            kwargs={})))
    return calls


def probe_stride2_calls():
    """(name, call) of P6, ``lane_stride2``, at the P6 copy shapes."""
    return _copy_calls("P6", "lane_stride2", "::stride2_kernel")


def probe_copy_calls():
    """(name, call) of P7, ``reshape_flat``, at the P7 copy shapes."""
    return _copy_calls("P7", "reshape_flat", "::cat_kernel")


def probe_se_calls():
    """(name, call) of P4, ``se``, on the original's inputs and at (5, 333)
    and the chunked (32, 100000)."""
    import torch
    x2, w16 = _probe_inputs()
    rng = np.random.default_rng(13)
    cases = [(x2, w16)] + [(torch.from_numpy(rng.random((c, n), np.float32)),
                            torch.from_numpy(rng.random((c, c), np.float32) - 0.5))
                           for c, n in ((5, 333), (32, 100000))]
    return [(f"probe_se {tuple(x.shape)}", dict(
        wrapper="backscrub_tpu_torch.ops.probe_kernels:se", kernel="::se_kernel",
        timed=k == 0, exact=False, args=[x, w], kwargs={})) for k, (x, w) in enumerate(cases)]


def probe_dot_calls():
    """(name, call) of P3, ``dot``, at each precision on the original's
    inputs and at n = 37."""
    import torch
    x2, w16 = _probe_inputs()
    x37 = torch.from_numpy(np.random.default_rng(37).random((16, 37), np.float32))
    return [(f"probe_dot {prec} {tuple(x.shape)}", dict(
        wrapper="backscrub_tpu_torch.ops.probe_kernels:dot", kernel="::dot_",
        timed=x is x2, exact=False, args=[w16, x, prec], kwargs={}))
        for x in (x2, x37) for prec in ("default", "high", "highest")]


CASES = {"front": front_calls, "gemm": gemm_calls, "gemm_bf16": gemm_bf16_calls,
         "gemm_highest": gemm_highest_calls, "body": body_calls, "cont": cont_calls,
         "batch": batch_calls,
         "jpeg": jpeg_calls, "bilateral": bilateral_calls,
         "pack420": pack420_calls, "pack_yuyv": pack_yuyv_calls, "probe_se": probe_se_calls,
         "probe_dot": probe_dot_calls, "probe_cat": probe_cat_calls,
         "probe_dw_flat": probe_dw_flat_calls, "probe_dw_rowpad": probe_dw_rowpad_calls,
         "probe_stride2": probe_stride2_calls, "probe_copy": probe_copy_calls}
# calls not bit for bit (``exact`` False): the most two builds' outputs may
# differ, each within 1e-5 of the same plain twin (summation order)
INEXACT_TOL = 2e-5


def run(checkout: str, calls, tmp: str, tag: str, time: bool):
    """The outputs of ``calls`` in ``checkout``, run in a subprocess there,
    and with ``time`` each call's (warm, cold) device us a launch."""
    import torch
    inp, outp = os.path.join(tmp, f"{tag}.in.pt"), os.path.join(tmp, f"{tag}.out.pt")
    torch.save(calls, inp)
    timer = [os.path.join(REPO, "chip_smoke.py")] if time else []
    subprocess.run([sys.executable, "-c", _RUN, checkout, inp, outp, *timer], check=True,
                   cwd=checkout)
    return torch.load(outp)


def main(argv) -> int:
    import torch
    time = "--time" in argv
    argv = [a for a in argv if a != "--time"]
    if not argv or any(c not in CASES for c in argv[1:]):
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("bits_vs_build: CUDA is not available", file=sys.stderr)
        return 1
    other = os.path.abspath(argv[0])
    sys.path.insert(0, REPO)
    named = [nc for case in (argv[1:] or list(CASES)) for nc in CASES[case]()]
    names, calls = [n for n, _ in named], [c for _, c in named]
    timed = [k for k, c in enumerate(calls) if c.get("timed")]
    with tempfile.TemporaryDirectory() as tmp:
        ours, theirs = (run(d, calls, tmp, tag, False)[0]
                        for d, tag in ((REPO, "this"), (other, "other")))
        if time:        # the timed calls, in turns: other, this, this, other
            t_other, t_this, t_this2, t_other2 = (
                run(d, [calls[k] for k in timed], tmp, f"{tag}{i}", True)[1]
                for i, (d, tag) in enumerate(((other, "other"), (REPO, "this"),
                                              (REPO, "this"), (other, "other"))))
    differ = 0
    for name, call, got, ref in zip(names, calls, ours, theirs):
        if got.shape != ref.shape:
            differ += 1
            print(f"{name}: shapes {tuple(got.shape)} vs {tuple(ref.shape)}")
            continue
        diff = float((got - ref).abs().max())
        if not call.get("exact", True):
            tol = call.get("tol", INEXACT_TOL)
            differ += tol is not None and diff > tol
            print(f"{name} {tuple(ref.shape)}: max difference {diff:.3g} from the other "
                  f"build ({'reported' if tol is None else f'bar {tol:g}'})")
            continue
        same = torch.equal(got, ref)
        differ += not same
        print(f"{name} {tuple(ref.shape)}: " + (
            "bit-identical to the other build" if same else
            f"{int((got != ref).sum())} values differ, max {diff:.3g}"))
    if time:
        for k, name in enumerate(names[i] for i in timed):
            print(f"time {name}: device us a launch, this warm {t_this[k][0]:.3f} / "
                  f"{t_this2[k][0]:.3f}, cold {t_this[k][1]:.3f} / {t_this2[k][1]:.3f}; "
                  f"the other warm {t_other[k][0]:.3f} / {t_other2[k][0]:.3f}, cold "
                  f"{t_other[k][1]:.3f} / {t_other2[k][1]:.3f}")
    print(f"vs the other build: {len(calls)} calls, {differ} differ "
          f"({torch.cuda.get_device_name(0)})")
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
