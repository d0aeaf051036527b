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
  inputs, at ``gemm_config``'s tile and split.

Prints, per call, whether the outputs are bit-identical (else how many
values differ and by how much) and exits 1 if any differs.

Usage (from the repository root, on a machine with a CUDA card)::

    python tools/bits_vs_build.py OTHER_CHECKOUT [front] [gemm]
"""

import os
import subprocess
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# run in a checkout: each call's wrapper on the saved inputs, on the card
_RUN = """
import importlib, sys, torch
sys.path.insert(0, sys.argv[1])
def dev(v):
    return v.cuda() if isinstance(v, torch.Tensor) else v
outs = []
with torch.no_grad():
    for c in torch.load(sys.argv[2]):
        mod, name = c["wrapper"].split(":")
        fn = getattr(importlib.import_module(mod), name)
        outs.append(fn(*map(dev, c["args"]),
                       **{k: dev(v) for k, v in c["kwargs"].items()}).cpu())
torch.save(outs, sys.argv[3])
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
                wrapper="backscrub_tpu_torch.pipeline.edge:front_fused",
                args=[canvas, e.front_params.cpu()], kwargs=e.front_kwargs())))
    return calls


def gemm_calls():
    """(name, call) of the GEMM at the deeplab shapes and ragged ones."""
    import torch
    calls = []
    for co, ci, n in [(co, ci, GEMM_L) for co, ci in GEMM_SHAPES] + GEMM_RAGGED:
        rng = np.random.default_rng(co * 1000 + ci)
        w, x = (torch.from_numpy((rng.standard_normal(s) / np.sqrt(ci)).astype(np.float32))
                for s in ((co, ci), (ci, n)))
        b = torch.from_numpy(rng.standard_normal(co).astype(np.float32))
        calls.append((f"gemm {co}x{ci}x{n}", dict(
            wrapper="backscrub_tpu_torch.ops.megakernel:conv1x1_gemm",
            args=[w, b, x], kwargs=dict(act="RELU6"))))
    return calls


CASES = {"front": front_calls, "gemm": gemm_calls}


def run(checkout: str, calls, tmp: str, tag: str):
    """The outputs of ``calls`` in ``checkout``, run in a subprocess there."""
    import torch
    inp, outp = os.path.join(tmp, f"{tag}.in.pt"), os.path.join(tmp, f"{tag}.out.pt")
    torch.save(calls, inp)
    subprocess.run([sys.executable, "-c", _RUN, checkout, inp, outp], check=True,
                   cwd=checkout)
    return torch.load(outp)


def main(argv) -> int:
    import torch
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
    with tempfile.TemporaryDirectory() as tmp:
        ours, theirs = run(REPO, calls, tmp, "this"), run(other, calls, tmp, "other")
    differ = 0
    for name, got, ref in zip(names, ours, theirs):
        same = got.shape == ref.shape and torch.equal(got, ref)
        differ += not same
        print(f"{name} {tuple(ref.shape)}: " + (
            "bit-identical to the other build" if same else
            f"shapes {tuple(got.shape)} vs {tuple(ref.shape)}" if got.shape != ref.shape else
            f"{int((got != ref).sum())} values differ, max "
            f"{float((got - ref).abs().max()):.3g}"))
    print(f"vs the other build: {len(calls)} calls, {differ} differ "
          f"({torch.cuda.get_device_name(0)})")
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
