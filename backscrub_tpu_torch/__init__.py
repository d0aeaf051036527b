"""backscrub-tpu's frame pipeline in PyTorch, with hand-written CUDA
kernels for NVIDIA Hopper (sm_90a).

A port of the JAX package ``backscrub_tpu`` that imports neither JAX nor
TensorFlow nor the JAX package.  Module names mirror the JAX package so
each counterpart is easy to find.  Public functions keep its layouts:
frames (H, W, 3) BGR u8, masks (H, W) u8 with 0 = person, YUYV (H, 2W) u8.

Public surface (the JAX package's ``__all__``, name for name):

- load_model / build_model / CompiledModel  (graph executor)
- ModelSpec, spec_for_model, resolve_model_path, resolve_path, DEFAULT_MODEL
- FramePipeline, PipelineConfig             (whole-frame path)
- MaskGen, bs_maskgen_* aliases             (reference lib API parity)
- ServingLoop                               (the serving loop)

Entry points run on the card (``device="cuda"``) unless the caller passes
``device="cpu"``.  The CUDA kernels (``csrc/``) build on first use
(``_build.py``); importing the package touches no CUDA and builds nothing;
on CPU tensors every kernel wrapper runs its plain PyTorch version.
"""

__version__ = "0.1.0"

from .graph.executor import CompiledModel, build_model, load_model  # noqa: E402
from .models.specs import (DEFAULT_MODEL, ModelSpec, resolve_model_path,  # noqa: E402
                           resolve_path, spec_for_model)
from .pipeline.frame import FramePipeline, PipelineConfig  # noqa: E402
from .pipeline.maskgen import (MaskGen, bs_maskgen_delete, bs_maskgen_new,  # noqa: E402
                               bs_maskgen_process, bs_tensorflow_version)
from .runtime.serving import ServingLoop  # noqa: E402

__all__ = [
    "CompiledModel", "build_model", "load_model",
    "ModelSpec", "spec_for_model", "resolve_model_path", "resolve_path",
    "DEFAULT_MODEL",
    "FramePipeline", "PipelineConfig",
    "MaskGen", "bs_maskgen_new", "bs_maskgen_process", "bs_maskgen_delete",
    "bs_tensorflow_version", "ServingLoop",
    "__version__",
]
