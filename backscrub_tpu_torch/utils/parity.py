"""Golden mask parity: the cv2 + TFLite CPU reference path (counterpart of
``backscrub_tpu/utils/parity.py``).

An implementation of ``bs_maskgen_process``'s semantics
(``lib/libbackscrub.cc:279-372``) independent of the port's code, the
golden for its tests and for ``tools/prec_parity_torch.py``.  OpenCV and
TensorFlow are imported inside the functions, never at import time.  The
card's machine has neither, so these functions run on the CPU only: the
port's side of a comparison runs there too (``device="cpu"``).
"""

from __future__ import annotations

import numpy as np

from ..pipeline.geometry import compute_roi


def _interpreter(path):
    import tensorflow as tf
    it = tf.lite.Interpreter(model_path=path)
    it.allocate_tensors()
    return it, it.get_input_details()[0], it.get_output_details()[0]


def golden_input(frame_bgr, geo, ih: int, iw: int, spec) -> np.ndarray:
    """The reference preprocess of one frame: ROI -> float resize, rounded
    onto the u8 canvas -> BGR2RGB -> 5x5 bilateral -> ``x * scale +
    offset``; (ih, iw, 3) f32."""
    import cv2
    g = geo
    roi = frame_bgr[g.roi.y:g.roi.y + g.roi.h, g.roi.x:g.roi.x + g.roi.w]
    canvas = np.zeros((ih, iw, 3), np.uint8)
    # the float resize: cv2's u8 resize is 11-bit fixed point and differs
    # from its own float path by 1 on ~13% of pixels, so the golden takes
    # the precise convention and the comparison measures the pipeline
    small = cv2.resize(roi.astype(np.float32), (g.in_roi.w, g.in_roi.h),
                       interpolation=cv2.INTER_LINEAR)
    canvas[g.in_roi.y:g.in_roi.y + g.in_roi.h, g.in_roi.x:g.in_roi.x + g.in_roi.w] = \
        np.clip(np.round(small), 0, 255).astype(np.uint8)
    rgb = cv2.cvtColor(canvas, cv2.COLOR_BGR2RGB)
    rgb = cv2.bilateralFilter(rgb, 5, 100.0, 100.0)
    return rgb.astype(np.float32) * spec.scale + spec.offset


def decode_map(out: np.ndarray, spec) -> np.ndarray:
    """The model output's per-pixel decision (int32): the argmax class, or
    1 where the threshold or two-channel rule calls the pixel a person."""
    if spec.decode.startswith("argmax"):
        return out.argmax(-1).astype(np.int32)
    if spec.decode == "threshold":
        return (out[..., 0] > spec.threshold).astype(np.int32)
    return (out[..., 0] < out[..., 1]).astype(np.int32)


def reference_maskgen(path, frames_bgr, width, height, spec) -> np.ndarray:
    """The golden mask (H, W) u8 after a frame sequence (the EMA carried),
    by cv2 + TFLite on the CPU."""
    import cv2
    it, din, dout = _interpreter(path)
    ih, iw = din["shape"][1:3]
    oh, ow = dout["shape"][1:3]
    g = compute_roi(width, height, iw, ih, ow, oh)
    ema = np.full((oh, ow), 255, np.uint8)
    mask_full = np.full((height, width), 255, np.uint8)
    for frame in frames_bgr:
        it.set_tensor(din["index"], golden_input(frame, g, ih, iw, spec)[None])
        it.invoke()
        out = it.get_tensor(dout["index"])[0]
        if spec.decode == "argmax_person":
            val = np.where(out.argmax(-1) == spec.person_class, 0, 255).astype(np.uint8)
        elif spec.decode == "threshold":
            val = np.where(out[..., 0] > spec.threshold, 0, 255).astype(np.uint8)
        else:
            val = np.where(out[..., 0] < out[..., 1], 0, 255).astype(np.uint8)
        ema = ((val & 0xE0) | (ema >> 3)).astype(np.uint8)
        small = ema[g.out_roi.y:g.out_roi.y + g.out_roi.h, g.out_roi.x:g.out_roi.x + g.out_roi.w]
        up = cv2.resize(small, (g.roi.w, g.roi.h), interpolation=cv2.INTER_LINEAR)
        mask_full[g.roi.y:g.roi.y + g.roi.h, g.roi.x:g.roi.x + g.roi.w] = cv2.blur(up, (5, 5))
    return mask_full


def iou(a_person: np.ndarray, b_person: np.ndarray) -> float:
    """Intersection over union of two boolean person maps (1.0 where both
    are empty)."""
    inter = np.logical_and(a_person, b_person).sum()
    union = np.logical_or(a_person, b_person).sum()
    return 1.0 if union == 0 else float(inter / union)


def golden_output(path, frame_bgr, width, height, spec):
    """(TFLite's output (oh, ow, C), the preprocessed input (ih, iw, 3))
    for one frame."""
    it, din, dout = _interpreter(path)
    ih, iw = din["shape"][1:3]
    oh, ow = dout["shape"][1:3]
    x = golden_input(frame_bgr, compute_roi(width, height, iw, ih, ow, oh), ih, iw, spec)
    it.set_tensor(din["index"], x[None])
    it.invoke()
    return it.get_tensor(dout["index"])[0], x


def classmap_agreement(path, frame_bgr, width, height, spec, model=None) -> float:
    """The fraction of pixels where the port's CNN (``model``, a
    CompiledModel on the CPU, or the file loaded there) decides as TFLite on the
    CPU does, on the same preprocessed frame: a parity signal that does
    not depend on the frame showing a person (deeplab reads the synthetic
    portrait as all background, where person IoU is vacuous)."""
    import torch
    from ..graph.executor import load_model
    ref, x = golden_output(path, frame_bgr, width, height, spec)
    m = model if model is not None else load_model(path, "cpu")
    with torch.no_grad():
        ours = m(torch.from_numpy(x[None]))[0].float().numpy()
    return float((decode_map(ref, spec) == decode_map(ours, spec)).mean())
