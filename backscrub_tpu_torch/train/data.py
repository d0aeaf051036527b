"""Training data for fine-tuning segmentation models (counterpart of
``backscrub_tpu/train/data.py``).

(BGR frame, person-probability target) pairs, resized to the model,
normalized, and served as shuffled, augmented batches with the JAX
package's numpy RNG draws in the same order, so both packages see the
same batches from the same seed.

Conventions:
- frames are BGR u8 images of any size, resized to the model input on the
  host at dataset-build time by ``pipeline/image.py``'s bit-exact copy of
  cv2's INTER_LINEAR (the card's machine has no OpenCV);
- targets are per-pixel person probability in [0, 1] at the model OUTPUT
  resolution, the contract of ``Trainer.step``/``evaluate``; float targets
  resize by ``pipeline/image.py:resize_bilinear`` (cv2's float
  INTER_LINEAR to within 1.2e-7 on [0, 1) values, against cv2 here);
- mask images on disk default to "person_white" (255 = person); pass
  mask_convention="backscrub" for the serving convention (0 = person).

OpenCV is imported only by :meth:`SegmentationData.from_dir`, which reads
image files.
"""

from __future__ import annotations

import os
import sys
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from ..pipeline.image import resize_bilinear, resize_bilinear_u8_exact


def _resize_u8(frame: np.ndarray, h: int, w: int) -> np.ndarray:
    return resize_bilinear_u8_exact(torch.from_numpy(np.ascontiguousarray(frame)), h, w).numpy()


class SegmentationData:
    """Batches of (normalized model input, person-prob target).

    Build with :meth:`from_arrays`, :meth:`from_dir`, or
    :meth:`self_label`; iterate with :meth:`batches`.
    """

    def __init__(self, x: np.ndarray, y: np.ndarray, spec):
        if len(x) != len(y):
            raise ValueError(f"{len(x)} frames vs {len(y)} targets")
        if len(x) == 0:
            raise ValueError("empty dataset")
        self.x = x  # (N, ih, iw, 3) f32, already normalized per spec
        self.y = y  # (N, oh, ow) f32 in [0, 1]
        self.spec = spec

    # -- constructors --------------------------------------------------------
    @classmethod
    def from_arrays(cls, frames_bgr: Sequence[np.ndarray],
                    targets: Sequence[np.ndarray], model, spec,
                    mask_convention: str = "person_white"):
        """frames: BGR u8 (any size); targets: (h, w) u8 masks or float
        probabilities (any size, resized to the model output)."""
        ih, iw = model.input_shape[1:3]
        oh, ow = model.output_shape[1:3]
        xs, ys = [], []
        for f, t in zip(frames_bgr, targets):
            xs.append(_normalize(_resize_u8(np.asarray(f), ih, iw), spec))
            t = np.asarray(t)
            if t.dtype == np.uint8:
                t = t.astype(np.float32) / 255.0
            if mask_convention == "backscrub":
                t = 1.0 - t  # serving convention: 0 = person -> prob 1
            elif mask_convention != "person_white":
                raise ValueError(
                    f"mask_convention must be 'person_white' or 'backscrub', "
                    f"got {mask_convention!r}")
            t = resize_bilinear(torch.from_numpy(t.astype(np.float32))[..., None],
                                oh, ow)[..., 0].numpy()
            ys.append(np.clip(t, 0.0, 1.0))
        return cls(np.stack(xs), np.stack(ys), spec)

    @classmethod
    def from_dir(cls, images_dir: str, masks_dir: str, model, spec,
                 mask_convention: str = "person_white"):
        """Matching filenames: images_dir/x.png + masks_dir/x.png (mask
        grayscale).  Any cv2-readable extensions."""
        import cv2
        frames, targets = [], []
        for name in sorted(os.listdir(images_dir)):
            mpath = os.path.join(masks_dir, name)
            if not os.path.exists(mpath):
                continue
            img = cv2.imread(os.path.join(images_dir, name))
            msk = cv2.imread(mpath, cv2.IMREAD_GRAYSCALE)
            if img is None or msk is None:
                print(f"warning: skipping unreadable pair {name!r}", file=sys.stderr)
                continue
            frames.append(img)
            targets.append(msk)
        if not frames:
            raise FileNotFoundError(
                f"no matching image/mask pairs in {images_dir} / {masks_dir}")
        return cls.from_arrays(frames, targets, model, spec,
                               mask_convention=mask_convention)

    @classmethod
    def self_label(cls, frames_bgr: Sequence[np.ndarray], teacher, model, spec):
        """Label frames with a teacher ``MaskGen`` (distillation: the
        teacher's serving-convention masks become soft person-prob
        targets).  The teacher runs on its device; its masks come to the
        host here."""
        targets = []
        for f in frames_bgr:
            f = np.asarray(f)
            if f.shape[:2] != (teacher.geo.frame_h, teacher.geo.frame_w):
                f = _resize_u8(f, teacher.geo.frame_h, teacher.geo.frame_w)
            mask = teacher.process(f).cpu().numpy()  # 0 = person
            targets.append(1.0 - mask.astype(np.float32) / 255.0)
        return cls.from_arrays(frames_bgr, targets, model, spec)

    # -- iteration ------------------------------------------------------------
    def batches(self, batch_size: int, *, rng: Optional[np.random.Generator] = None,
                augment: bool = True,
                epochs: int = 1) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Shuffled (x, y) batches; partial final batch dropped.
        Augmentation: horizontal flip (mirrors the target) and
        brightness/contrast jitter in the normalized domain (target
        unchanged)."""
        rng = rng or np.random.default_rng(0)
        n = len(self.x)
        if batch_size > n:
            raise ValueError(f"batch_size {batch_size} > dataset size {n}")
        for _ in range(epochs):
            order = rng.permutation(n)
            for i in range(0, n - batch_size + 1, batch_size):
                idx = order[i:i + batch_size]
                x = self.x[idx].copy()
                y = self.y[idx].copy()
                if augment:
                    flip = rng.random(batch_size) < 0.5
                    x[flip] = x[flip, :, ::-1]
                    y[flip] = y[flip, :, ::-1]
                    gain = rng.uniform(0.9, 1.1, (batch_size, 1, 1, 1)).astype(np.float32)
                    bias = rng.uniform(-0.05, 0.05, (batch_size, 1, 1, 1)).astype(np.float32)
                    lo, hi = self._norm_range()
                    x = np.clip(x * gain + bias * (hi - lo), lo, hi)
                yield x, y

    def _norm_range(self):
        s, o = self.spec.scale, self.spec.offset
        return (0 * s + o, 255 * s + o)


def _normalize(frame_bgr_u8: np.ndarray, spec) -> np.ndarray:
    """BGR u8 -> normalized RGB f32 per the model spec (the same
    normalization the serving preprocess applies, lib/libbackscrub.cc:302)."""
    rgb = frame_bgr_u8[..., ::-1].astype(np.float32)
    return rgb * np.float32(spec.scale) + np.float32(spec.offset)
