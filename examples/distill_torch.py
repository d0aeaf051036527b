#!/usr/bin/env python3
"""Cross-model distillation on the PyTorch port (counterpart of
``examples/distill.py``): teach segm_lite from mlkit's masks.

1. seeded moving frames (``tools/make_synth_segm.py:moving_frames``, a
   person-like shape over a moving background) at 640x480,
2. labelled by the TEACHER, the committed synthetic mlkit selfie model
   (256x256), through its fused ``MaskGen``,
3. the STUDENT, the committed synthetic segm_lite model (96x160), fine-tuned
   on the teacher's soft masks, with a checkpoint half way,
4. resumed from the checkpoint (as after a restart) to the last step,
5. exported back to ``.tflite``, read back by the port's loader, and its
   agreement with the teacher reported.

It runs on the card unless given ``--device cpu``.  The repository holds
no real models; ``--teacher`` and ``--student`` take others.

Usage: python examples/distill_torch.py [--steps N] [--out student.tflite]
           [--device cuda|cpu] [--teacher T.tflite] [--student S.tflite]
"""

import argparse
import os
import shutil
import sys
import tempfile

import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir)
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

from backscrub_tpu_torch.graph.executor import load_model  # noqa: E402
from backscrub_tpu_torch.models.specs import spec_for_model  # noqa: E402
from backscrub_tpu_torch.pipeline.decode import decode_val  # noqa: E402
from backscrub_tpu_torch.pipeline.maskgen import MaskGen  # noqa: E402
from backscrub_tpu_torch.tflite.export import export_params_to_tflite  # noqa: E402
from backscrub_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint  # noqa: E402
from backscrub_tpu_torch.train.data import SegmentationData  # noqa: E402
from backscrub_tpu_torch.train.trainer import TrainConfig, Trainer  # noqa: E402

DATA = os.path.join(ROOT, "tests", "data")


def agreement(model, params, ds, spec) -> float:
    """Share of output pixels where the student's deployed decode agrees
    with the teacher's label (person where the target > 0.5)."""
    dev = next(iter(params.values())).device
    with torch.no_grad():
        out = model.raw_fn(params, torch.from_numpy(ds.x).to(dev))
    pred = (decode_val(out.float(), spec) == 0).cpu().numpy()
    return float((pred == (ds.y > 0.5)).mean())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--out", default=None, help="exported student (default: in the work dir)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--teacher", default=os.path.join(DATA, "selfie_synth_mlkit_256x256.tflite"))
    ap.add_argument("--student", default=os.path.join(DATA, "segm_synth_lite_96x160.tflite"))
    args = ap.parse_args(argv)
    from make_synth_segm import moving_frames

    student = load_model(args.student, args.device)
    spec = spec_for_model(args.student)
    teacher = MaskGen(args.teacher, 640, 480, device=args.device)
    ds = SegmentationData.self_label(moving_frames(640, 480, args.frames, seed=3), teacher,
                                     student, spec)
    print(f"{len(ds.x)} frames labelled by the teacher ({100 * (ds.y > 0.5).mean():.1f}% "
          "person)")

    tr = Trainer(student, spec, config=TrainConfig(learning_rate=5e-4))
    before = agreement(student, tr.params, ds, spec)
    work = tempfile.mkdtemp(prefix="bs_distill_")
    ck, half = os.path.join(work, "distill_ck.npz"), args.steps // 2
    for _ in range(half):
        loss = tr.step(ds.x, ds.y)
    save_checkpoint(ck, tr.params, tr.opt_state, step=half)
    print(f"step {half}: loss {loss:.4f} (checkpoint saved)")

    # resume from the checkpoint in a fresh Trainer (a restart) and finish
    tr = Trainer(student, spec, config=TrainConfig(learning_rate=5e-4))
    params, opt, start = load_checkpoint(ck, tr.params, tr.opt_state)
    tr.params, tr.opt_state = params, opt
    for _ in range(start, args.steps):
        loss = tr.step(ds.x, ds.y)
    metrics = tr.evaluate(ds.x, ds.y)          # the deployed decode's IoU
    print(f"step {args.steps}: loss {loss:.4f}")
    print(f"teacher agreement: {before:.1%} -> {agreement(student, tr.params, ds, spec):.1%}; "
          f"IoU (deployed decode) {metrics['iou']:.3f}")

    out = args.out or os.path.join(work, "segm_lite_distilled.tflite")
    n = export_params_to_tflite(args.student, student, tr.params, out)
    back = load_model(out, args.device)
    print(f"exported {n} tensors -> {out}; read back: teacher agreement "
          f"{agreement(back, back.params, ds, spec):.1%}")
    if args.out:
        shutil.rmtree(work)   # the work files; the export lives elsewhere
    return 0


if __name__ == "__main__":
    sys.exit(main())
