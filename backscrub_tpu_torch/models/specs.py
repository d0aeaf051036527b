"""Declarative model specs (counterpart of ``backscrub_tpu/models/specs.py``).

The reference sniffs the model "type" from the filename
(``lib/libbackscrub.cc:116-130``) and hardcodes normalization per type
(``:132-148``) and decode rules (``:317-361``).  A :class:`ModelSpec`
carries both as data, and which families take the flat continuation
(K2'', ``edge_cont``).  The JAX spec's MXU precision is not a field
here: the plans' plain versions and the classic path compute f32, and
the flat continuation's GEMM (K2'') computes bf16x3, the deeplab
family's HIGH precision (``backscrub_tpu/models/specs.py:59-61``), on the
card and in ``BodyPlan.run_plain(gemm="bf16x3")``.
"""

from __future__ import annotations

import dataclasses
import os
import sys


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    kind: str                      # "deeplab" | "bodypix" | "meet" | "selfie" | "multiclass" | "unknown"
    scale: float                   # input normalization: x * scale + offset
    offset: float
    decode: str                    # "argmax_person" | "threshold" | "two_channel" | "argmax_not_background"
    threshold: float = 0.65        # for decode == "threshold" (libbackscrub.cc:338)
    person_class: int = 15         # PASCAL-VOC "person" for deeplab (libbackscrub.cc:154-159)
    num_classes: int = 21          # expected output channels for argmax decodes
    # the fused edge path runs the flat continuation (K2'') after the
    # prefix cut when the caller does not choose (edge_cont=None); the
    # JAX spec's per-family choice: deeplab on, bodypix off
    edge_cont: bool = False

    def expected_channels(self):
        """Output-channel count this decode rule needs (None = any)."""
        return {"argmax_person": self.num_classes, "two_channel": 2,
                "threshold": 1, "argmax_not_background": self.num_classes}.get(self.decode)


_SPECS = {
    "deeplab": ModelSpec("deeplab", scale=1 / 127.5, offset=-1.0,
                         decode="argmax_person", edge_cont=True),
    "bodypix": ModelSpec("bodypix", scale=1 / 255.0, offset=0.0,
                         decode="threshold"),
    "meet": ModelSpec("meet", scale=1 / 255.0, offset=0.0, decode="two_channel"),
    "selfie": ModelSpec("selfie", scale=1 / 255.0, offset=0.0, decode="threshold"),
    "multiclass": ModelSpec("multiclass", scale=1 / 255.0, offset=0.0,
                            decode="argmax_not_background", num_classes=6),
    "unknown": ModelSpec("unknown", scale=1 / 255.0, offset=0.0, decode="threshold"),
}


def spec_for_model(model_path: str) -> ModelSpec:
    """Filename -> spec, mirroring get_modeltype (lib/libbackscrub.cc:116-130)."""
    name = os.path.basename(model_path)
    if "body-pix" in name:
        return _SPECS["bodypix"]
    if "deeplab" in name:
        return _SPECS["deeplab"]
    if "segm_" in name:
        return _SPECS["meet"]
    if "multiclass" in name:
        return _SPECS["multiclass"]
    if "selfie" in name:
        return _SPECS["selfie"]
    return _SPECS["unknown"]


def _package_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _model_candidates(name: str) -> list:
    """The model search roots of resolve_path (app/deepseg.cc:306-345)."""
    candidates = []
    for b in os.environ.get("BACKSCRUB_PATH", "").split(":"):
        if b:
            candidates += [os.path.join(b, "models", name), os.path.join(b, name)]
    xdg = os.environ.get("XDG_DATA_HOME") or os.path.expanduser("~/.local/share")
    candidates.append(os.path.join(xdg, "backscrub", "models", name))
    prefix = os.environ.get("BACKSCRUB_INSTALL_PREFIX", sys.prefix)
    candidates.append(os.path.join(prefix, "share", "backscrub", "models", name))
    root = _package_root()
    candidates.append(os.path.join(root, "share", "backscrub", "models", name))
    candidates.append(os.path.join(root, "models", name))
    for b in os.environ.get("BACKSCRUB_TPU_MODELS", "").split(":"):
        if b:
            candidates.append(os.path.join(b, name))
    return candidates


def resolve_model_path(name: str) -> str:
    """A model path as given, or a bare file name searched for under the
    model roots (app/deepseg.cc:292-347)."""
    if os.path.exists(name):
        return name
    if os.sep not in name:
        for cand in _model_candidates(name):
            if os.path.exists(cand):
                return cand
    raise FileNotFoundError(
        f"model {name!r} not found; searched literal path, $BACKSCRUB_PATH, "
        f"$XDG_DATA_HOME/backscrub/models, <prefix>/share/backscrub/models, "
        f"and the package tree ({_package_root()}/models). Set "
        f"BACKSCRUB_PATH or BACKSCRUB_TPU_MODELS to add search roots.")
