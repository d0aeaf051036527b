"""Check that the f32 paths of this checkout give the bytes of another
checkout (an earlier commit, unpacked with ``git archive``) on one CUDA
card, and time their body tables in turns.

For each synthetic family (segm_lite, segm_full, mlkit, deeplab, BodyPix)
each checkout runs, in a subprocess of its own (its ``_build.py`` builds
its library into its own ``_build/``), ``FramePipeline`` with YUYV out at
640x480 on the card, f32 (the default arguments), over ``chip_smoke.py``'s
moving sequence (``tools/make_synth_segm.py:moving_frames``, FRAMES
frames, seed 0) and a seeded background from a fresh EMA, and hashes
every frame's packed output and mask; then times each body plan of the
fused path (K2, or K2' and K2'') on the first frame's front output, by
this checkout's ``chip_smoke.device_ms`` (the profiler's device time a
launch); then times the step end to end: WINDOWS windows of WINDOW steps
each over the same frames, each window's wall ms a frame between two
synchronizations and host ms a frame (the time inside ``step`` calls),
reported as the median of the windows with their range.  Last, the CLI
(``cli.main``) on the mlkit model, ``test:`` camera at 640x480 to ``null:``
for CLI_FRAMES frames, CLI_RUNS times: the fps of its final stats line.
The subprocesses run in turns: the other, this, this, the other.

Prints per family whether the hashes of all four runs are equal, the
plans' device us a launch and the step's ms a frame in each run, and the
CLI's fps; exits 1 if any hash differs.

Usage (from the repository root, on a machine with a CUDA card)::

    python tools/f32_vs_build.py OTHER_CHECKOUT
"""

import json
import os
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FRAMES = 30
WINDOWS, WINDOW = 7, 60
CLI_FRAMES, CLI_RUNS = 600, 3
FAMILIES = ("segm_synth_lite_96x160", "segm_synth_full_144x256",
            "selfie_synth_mlkit_256x256", "deeplab_synth_257", "body-pix_synth_050_8_257")

# run in a checkout: argv = checkout, this checkout's chip_smoke.py, this
# checkout's tools/, the output file
_RUN = """
import hashlib, importlib.util, json, os, sys, tempfile, time
import numpy as np, torch
sys.path.insert(0, sys.argv[1]); sys.path.insert(0, sys.argv[3])
spec = importlib.util.spec_from_file_location("timer", sys.argv[2])
timer = importlib.util.module_from_spec(spec)
spec.loader.exec_module(timer)
from make_synth_segm import moving_frames
from backscrub_tpu_torch.pipeline.frame import FramePipeline, PipelineConfig
FRAMES, FAMILIES, WINDOWS, WINDOW, CLI_FRAMES, CLI_RUNS = %d, %r, %d, %d, %d, %d
frames = [torch.from_numpy(f).cuda() for f in moving_frames(640, 480, FRAMES)]
bg = torch.from_numpy(np.random.default_rng(4).integers(0, 256, (480, 640, 3), np.uint8)).cuda()
res = {}
with torch.no_grad():
    for fam in FAMILIES:
        pipe = FramePipeline(sys.argv[1] + "/tests/data/" + fam + ".tflite",
                             PipelineConfig(width=640, height=480), device="cuda")
        h = hashlib.sha256()
        for f in frames:
            out, mask = pipe.step(f, bg)
            h.update(out.cpu().numpy().tobytes())
            h.update(mask.cpu().numpy().tobytes())
        e = pipe.maskgen.edge
        x = e.front(frames[0]).reshape(e.plans[0].in_meta.c, -1)
        us = []
        for plan in e.plans:
            us.append(1e3 * timer.device_ms(lambda: plan.run_cuda(x), kernel="body_mega"))
            x = plan.run_cuda(x).clone()
        wall, host = [], []
        for _ in range(WINDOWS):
            torch.cuda.synchronize()
            inside, t0 = 0.0, time.perf_counter()
            for k in range(WINDOW):
                t1 = time.perf_counter()
                pipe.step(frames[k %% FRAMES], bg)
                inside += time.perf_counter() - t1
            torch.cuda.synchronize()
            wall.append((time.perf_counter() - t0) * 1e3 / WINDOW)
            host.append(inside * 1e3 / WINDOW)
        res[fam] = dict(sha=h.hexdigest(), plan_us=us, step_ms=wall, host_ms=host)
from backscrub_tpu_torch import cli
fps = []
with tempfile.TemporaryDirectory() as tmp:
    for i in range(CLI_RUNS):
        stats = os.path.join(tmp, "%%d.jsonl" %% i)
        rc = cli.main(["-c", "test:", "--cg", "640x480", "-m",
                       sys.argv[1] + "/tests/data/selfie_synth_mlkit_256x256.tflite",
                       "--frames", str(CLI_FRAMES), "-v", "null:", "--stats-json", stats])
        assert rc == 0, rc
        with open(stats) as fh:
            fps.append(json.loads(fh.read().splitlines()[-1])["fps"])
res["cli_fps"] = fps
json.dump(res, open(sys.argv[4], "w"))
""" % (FRAMES, FAMILIES, WINDOWS, WINDOW, CLI_FRAMES, CLI_RUNS)


def run(checkout, out):
    subprocess.run([sys.executable, "-c", _RUN, checkout, os.path.join(REPO, "chip_smoke.py"),
                    os.path.join(REPO, "tools"), out], check=True, cwd=checkout)
    with open(out) as fh:
        return json.load(fh)


def _spread(v):
    v = sorted(v)
    return f"{v[len(v) // 2]:.4f} [{v[0]:.4f}, {v[-1]:.4f}]"


def main(argv) -> int:
    import torch
    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("f32_vs_build: CUDA is not available", file=sys.stderr)
        return 1
    other = os.path.abspath(argv[0])
    with tempfile.TemporaryDirectory() as tmp:
        runs = [run(d, os.path.join(tmp, f"{i}.json"))
                for i, d in enumerate((other, REPO, REPO, other))]
    differ = 0
    for fam in FAMILIES:
        shas = {r[fam]["sha"] for r in runs}
        differ += len(shas) > 1
        times = "; ".join(f"{tag} " + ", ".join(f"{t:.2f}" for t in r[fam]["plan_us"])
                          for tag, r in zip(("other", "this", "this", "other"), runs))
        print(f"{fam}: {FRAMES} frames' YUYV and masks "
              + ("byte-identical in all four runs" if len(shas) == 1 else "DIFFER")
              + f"; body plans' device us a launch: {times}")
        steps = "; ".join(f"{tag} {_spread(r[fam]['step_ms'])} (host {_spread(r[fam]['host_ms'])})"
                          for tag, r in zip(("other", "this", "this", "other"), runs))
        print(f"{fam}: step ms a frame, median [min, max] of {WINDOWS} windows of {WINDOW}: "
              + steps)
    print(f"cli mlkit 640x480 fps, {CLI_RUNS} runs of {CLI_FRAMES} frames: " + "; ".join(
        f"{tag} " + ", ".join(f"{v:.2f}" for v in r["cli_fps"])
        for tag, r in zip(("other", "this", "this", "other"), runs)))
    print(f"f32 vs the other build: {len(FAMILIES)} families, {differ} differ "
          f"({torch.cuda.get_device_name(0)})")
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
