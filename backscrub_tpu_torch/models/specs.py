"""Declarative model specs (counterpart of ``backscrub_tpu/models/specs.py``).

The reference sniffs the model "type" from the filename
(``lib/libbackscrub.cc:116-130``) and hardcodes normalization per type
(``:132-148``) and decode rules (``:317-361``).  A :class:`ModelSpec`
carries both as data, which families take the flat continuation (K2'',
``edge_cont``), and the body's default precision (``mxu_precision``, the
JAX spec's field): "highest", "high" or "default", the string the port's
``MaskGen(precision=None)`` resolves to.  "default" is the bf16 mode's
one-pass bf16 dots (``ops/megakernel.py:dots_for``); "highest" and "high"
run the plans' dots in f32 except the flat continuation's GEMM (K2''),
which computes bf16x3, the reference's HIGH split, at both.
"""

from __future__ import annotations

import dataclasses
import os
import re
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
    # the body's precision where the caller gives none: "high" for the
    # FLOP-heavy 257x257 families, "highest" for the others (the JAX spec's)
    mxu_precision: str = "highest"
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
                         decode="argmax_person", mxu_precision="high", edge_cont=True),
    "bodypix": ModelSpec("bodypix", scale=1 / 255.0, offset=0.0,
                         decode="threshold", mxu_precision="high"),
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


# the default model file, the JAX spec's name (the mlkit selfie family)
DEFAULT_MODEL = "selfiesegmentation_mlkit-256x256-2021_01_19-v1215.f16.tflite"


def _package_root() -> str:
    """Directory holding the package: the Python analog of the reference's
    "relative to current binary location" step."""
    return os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def search_candidates(provided: str, type_: str) -> list:
    """The ordered candidate list for steps 2-5 of :func:`resolve_path`;
    ``type_`` is "models" or "backgrounds"."""
    candidates = []
    # 2. $BACKSCRUB_PATH prefixes (colon separated), "<prefix>/<type>/<name>"
    #    (app/deepseg.cc:306-314), then the flat "<prefix>/<name>"
    for b in os.environ.get("BACKSCRUB_PATH", "").split(":"):
        if b:
            candidates += [os.path.join(b, type_, provided), os.path.join(b, provided)]
    # 3. XDG data location (deepseg.cc:316-320)
    xdg = os.environ.get("XDG_DATA_HOME") or os.path.expanduser("~/.local/share")
    candidates.append(os.path.join(xdg, "backscrub", type_, provided))
    # 4. install prefix (deepseg.cc:321-324): the Python environment's
    prefix = os.environ.get("BACKSCRUB_INSTALL_PREFIX", sys.prefix)
    candidates.append(os.path.join(prefix, "share", "backscrub", type_, provided))
    # 5. relative to the package (deepseg.cc:326-345): an installed
    #    share/backscrub/<type>/ tree, then the source tree's <type>/
    root = _package_root()
    candidates.append(os.path.join(root, "share", "backscrub", type_, provided))
    candidates.append(os.path.join(root, type_, provided))
    # extra roots, opt-in by environment
    extra = os.environ.get("BACKSCRUB_TPU_MODELS" if type_ == "models"
                           else "BACKSCRUB_TPU_BACKGROUNDS", "")
    candidates += [os.path.join(b, provided) for b in extra.split(":") if b]
    return candidates


# a URI scheme of at least two characters, so a drive letter is no scheme
# (deepseg.cc:295-298)
_URI_RE = re.compile(r"^[A-Za-z][A-Za-z0-9+\-.]{1,}:")


def resolve_path(provided: str, type_: str):
    """Resource resolution as resolve_path (app/deepseg.cc:292-347):
    a URI passes through; then the literal path; a name holding a path
    separator stops there; then :func:`search_candidates`.  None when
    nothing matches (the caller decides how to fail)."""
    if _URI_RE.match(provided):
        return provided
    if os.path.exists(provided):
        return provided
    if os.sep in provided:
        return None
    for cand in search_candidates(provided, type_):
        if os.path.exists(cand):
            return cand
    return None


def resolve_model_path(name: str) -> str:
    """:func:`resolve_path` with type "models" (the reference's call site,
    app/deepseg.cc:540); raises where nothing matches."""
    p = resolve_path(name, "models")
    if p is not None:
        return p
    raise FileNotFoundError(
        f"model {name!r} not found; searched literal path, $BACKSCRUB_PATH, "
        f"$XDG_DATA_HOME/backscrub/models, <prefix>/share/backscrub/models, "
        f"and the package tree ({_package_root()}/models). Set "
        f"BACKSCRUB_PATH or BACKSCRUB_TPU_MODELS to add search roots.")


def install_default_search_roots() -> None:
    """Entry-point helper: add the source tree's ``models/`` and
    ``backgrounds/`` directories, where they exist, as the lowest-priority
    search roots (``BACKSCRUB_TPU_MODELS``, ``BACKSCRUB_TPU_BACKGROUNDS``).
    Library code never names an asset location; tools call this once at
    startup.  A variable already set wins."""
    root = _package_root()
    for var, sub in (("BACKSCRUB_TPU_MODELS", "models"),
                     ("BACKSCRUB_TPU_BACKGROUNDS", "backgrounds")):
        local = os.path.join(root, sub)
        if os.path.isdir(local):
            os.environ.setdefault(var, local)
