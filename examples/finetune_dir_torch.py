#!/usr/bin/env python3
"""Fine-tune a segmentation model from an on-disk dataset with the
PyTorch port (counterpart of ``examples/finetune_dir.py``).

1. ``SegmentationData.from_dir`` loads matched image/mask pairs (mask 255
   = person),
2. ``Trainer`` runs augmented mini-batches on the card (``--device cpu``
   for the CPU; add ``mesh=make_mesh(N)`` from
   ``backscrub_tpu_torch.parallel.mesh``, in each rank of a world of N,
   for dp + tp + sp over N devices),
3. ``Trainer.evaluate`` reports the loss and the deployed decode's mask
   IoU before and after,
4. the tuned weights export back to a ``.tflite`` that TFLite, both
   packages and the reference binary load.

With no dataset given, a small synthetic one (a brighter rectangle is the
person) is written to a temp dir, so the example runs anywhere; reading
and writing the PNGs needs OpenCV.  The model defaults to the committed
synthetic segm_lite (96x160).

Usage: python examples/finetune_dir_torch.py [images_dir masks_dir]
           [--epochs N] [--model M.tflite] [--out tuned.tflite] [--device cuda|cpu]
"""

import argparse
import os
import shutil
import sys
import tempfile

import numpy as np

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir)
sys.path.insert(0, ROOT)

from backscrub_tpu_torch.graph.executor import load_model  # noqa: E402
from backscrub_tpu_torch.models.specs import spec_for_model  # noqa: E402
from backscrub_tpu_torch.tflite.export import export_params_to_tflite  # noqa: E402
from backscrub_tpu_torch.train.data import SegmentationData  # noqa: E402
from backscrub_tpu_torch.train.trainer import TrainConfig, Trainer  # noqa: E402


def make_synthetic_dataset(root, n=8, w=160, h=96):
    import cv2
    imgs, msks = os.path.join(root, "img"), os.path.join(root, "msk")
    os.makedirs(imgs), os.makedirs(msks)
    rng = np.random.default_rng(0)
    for i in range(n):
        frame = rng.integers(0, 256, (h, w, 3), np.uint8)
        mask = np.zeros((h, w), np.uint8)
        x0, y0 = rng.integers(10, w // 2), rng.integers(10, h // 2)
        mask[y0:y0 + h // 3, x0:x0 + w // 3] = 255  # person = white
        frame[mask > 0] = (frame[mask > 0] // 2) + 96  # make it learnable
        cv2.imwrite(os.path.join(imgs, f"{i}.png"), frame)
        cv2.imwrite(os.path.join(msks, f"{i}.png"), mask)
    return imgs, msks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("dirs", nargs="*", help="images_dir masks_dir")
    ap.add_argument("--epochs", type=int, default=8)
    ap.add_argument("--model", default=os.path.join(ROOT, "tests", "data",
                                                    "segm_synth_lite_96x160.tflite"))
    ap.add_argument("--out", default=None, help="tuned model (default: in the work dir)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if len(args.dirs) not in (0, 2):
        ap.error("give both images_dir and masks_dir, or neither")
    work = tempfile.mkdtemp(prefix="bs_finetune_")
    if args.dirs:
        images_dir, masks_dir = args.dirs
    else:
        images_dir, masks_dir = make_synthetic_dataset(work)
        print(f"no dataset given; synthesized one in {work}")

    model = load_model(args.model, args.device)
    spec = spec_for_model(args.model)
    ds = SegmentationData.from_dir(images_dir, masks_dir, model, spec)
    print(f"dataset: {len(ds.x)} pairs at {ds.x.shape[1:]}")

    tr = Trainer(model, spec, config=TrainConfig(learning_rate=1e-3))
    before = tr.evaluate(ds.x, ds.y)
    for x, y in ds.batches(min(4, len(ds.x)), rng=np.random.default_rng(1),
                           epochs=args.epochs):
        tr.step(x, y)
    after = tr.evaluate(ds.x, ds.y)
    print(f"loss {before['loss']:.4f} -> {after['loss']:.4f}; "
          f"mask IoU {before['iou']:.3f} -> {after['iou']:.3f}")

    out = args.out or os.path.join(work, "segm_lite_finetuned.tflite")
    n = export_params_to_tflite(args.model, model, tr.params, out)
    print(f"exported {n} tensors -> {out}")
    if args.out:
        shutil.rmtree(work)   # the work files; the export lives elsewhere
    return 0


if __name__ == "__main__":
    sys.exit(main())
