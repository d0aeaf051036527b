"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``csrc/*.cu`` source compiles in its own ``nvcc`` process, all
started together, and one more ``nvcc`` call links the objects into a
shared library with a plain C interface (no PyTorch headers: seconds to
build, against minutes for ``torch.utils.cpp_extension.load``).  The
library lands in ``backscrub_tpu_torch/_build/``, named by a hash of the
sources, headers and flags, so an edited kernel rebuilds and an unchanged
one loads the cached file.  Every exported function returns the ``cudaError_t`` of its
launch; :func:`launch` raises on anything but 0.

:func:`host_library` builds a host C++ library (by default of
``native/``: the baseline-JPEG entropy codec, ``native/bsjpeg.cc``) with
the system's ``c++`` the same way: ``-O3 -shared -fPIC`` and
``-march=native`` where the compiler takes it (as
``native/CMakeLists.txt`` builds it), into ``_build/`` under a hash of
the source, its header and the flags.  :func:`capi_library` builds the
port's C ABI (``backscrub_tpu_torch/native/bs_capi.cc``, an embedded
CPython), :func:`native_program` the pure-C++ consumer
(``native/demo.cc`` and ``native/bsio.cc``) linked against it; both take
the embedding flags from ``sysconfig`` (:func:`python_embed`, in
``_embed.py``, which ``native/CMakeLists.txt`` runs for the same flags).

Nothing here runs at import time: the CPU tests import every module on a
machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import time

import torch

from ._embed import python_embed

_HERE = os.path.dirname(os.path.abspath(__file__))
SRC_DIR = os.path.join(_HERE, "csrc")
NATIVE_DIR = os.path.join(os.path.dirname(_HERE), "native")
CAPI_SRC = os.path.join(_HERE, "native", "bs_capi.cc")
BUILD_DIR = os.path.join(_HERE, "_build")
ARCH = "-gencode=arch=compute_90a,code=sm_90a"
FLAGS = ("-std=c++17", "-O3", "-Xcompiler", "-fPIC")

P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
F32 = ctypes.c_float
# exported symbol -> argument types (pointers and the stream as void*)
SIGNATURES = {
    "bs_blend_pack_yuyv": (P, P, P, P, I, I, I, I, P),
    "bs_blend_pack_420": (P, P, P, P, I, I, I, I, P),
    "bs_bilateral": (P, P, P, I, I, I, F32, P),
    "bs_front": (P, P, P, I, I, I, I, I, I, I, I, I, F32, F32, F32, I, I, I, I, P),
    "bs_gemm": (P, P, P, P, P, I, I, I, I, I, I, I, I, P),
    "bs_body_mega": (P, P, P, P, I, I, I, I, L, L, P, P),
    "bs_barrier_bench": (I, I, I, P),
    "bs_probe_dw9": (P, P, I, I, I, I, I, I, P),
    "bs_probe_dot": (P, P, P, I, I, P),
    "bs_probe_se": (P, P, P, I, I, P),
    "bs_probe_se_cluster": (),
    "bs_probe_cat": (P, P, P, I, I, P),
    "bs_probe_stride2": (P, P, I, I, P),
    "bs_probe_copy": (P, P, I, I, P),
    "bs_probe_empty": (P,),
    "bs_probe_touch": (P, P, P),
    "bs_jpeg_decode": (P, P, P, P, P, P, P),
}


class KernelBuildError(RuntimeError):
    pass


class _Lib:
    """The loaded library; one per process, created on first use."""

    handle = None
    build_seconds = None


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise KernelBuildError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")


def _sources():
    srcs = sorted(glob.glob(os.path.join(SRC_DIR, "*.cu")))
    if not srcs:
        raise KernelBuildError(f"no CUDA sources under {SRC_DIR}")
    return srcs


def library_path() -> str:
    h = hashlib.sha256()
    for s in _sources() + sorted(glob.glob(os.path.join(SRC_DIR, "*.cuh"))):
        h.update(os.path.basename(s).encode())
        with open(s, "rb") as f:
            h.update(f.read())
    h.update(" ".join((ARCH,) + FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libbs_kernels_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the kernels if no library for these sources exists; returns
    its path.  Raises KernelBuildError with nvcc's output on failure."""
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc, tag = _nvcc(), f"{os.getpid()}.tmp"
    t0 = time.perf_counter()
    jobs = []
    for src in _sources():
        obj = os.path.join(BUILD_DIR, f"{os.path.basename(src)}.{tag}.o")
        cmd = [nvcc, ARCH, *FLAGS, "-c", "-o", obj, src]
        jobs.append((obj, cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.PIPE, text=True)))
    failed = []
    for _, cmd, proc in jobs:
        so, se = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{so}\n{se}")
    objs = [obj for obj, _, _ in jobs]
    try:
        if failed:
            raise KernelBuildError("\n".join(failed))
        tmp = f"{out}.{tag}"
        cmd = [nvcc, ARCH, "-shared", "-o", tmp, *objs]
        r = subprocess.run(cmd, capture_output=True, text=True)
        if r.returncode != 0:
            raise KernelBuildError(f"nvcc link failed ({r.returncode}):\n{' '.join(cmd)}\n"
                                   f"{r.stdout}\n{r.stderr}")
        os.replace(tmp, out)
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    _Lib.build_seconds = time.perf_counter() - t0
    return out


def lib() -> ctypes.CDLL:
    """The kernel library, built and loaded on first call."""
    if _Lib.handle is None:
        handle = ctypes.CDLL(build())
        for name, args in SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = list(args)
            fn.restype = ctypes.c_int
        _Lib.handle = handle
    return _Lib.handle


HOST_FLAGS = ("-std=c++17", "-O3", "-fPIC")


def _cxx() -> str:
    for cand in ("c++", "g++"):
        path = shutil.which(cand)
        if path:
            return path
    raise KernelBuildError("no host C++ compiler (c++ or g++) found")


def _host_flags(cxx: str) -> tuple:
    """HOST_FLAGS, with ``-march=native`` where the compiler takes it, and
    the macros the compiler predefines under them: with ``-march=native``
    they name this host's instruction sets (``__AVX512F__`` ...), so a
    library built for one CPU never goes by the same name on another."""
    r = subprocess.run([cxx, "-march=native", "-x", "c++", "-fsyntax-only", "-"],
                       input="int main() { return 0; }\n", capture_output=True,
                       text=True)
    march = ("-march=native",) if r.returncode == 0 else ()
    m = subprocess.run([cxx, *march, "-dM", "-E", "-x", "c++", "-"],
                       input="", capture_output=True, text=True)
    if m.returncode != 0:
        raise KernelBuildError(f"{cxx} does not list its target macros:\n"
                               f"{m.stderr}")
    return HOST_FLAGS + march, m.stdout


def _host_build(out_stem: str, suffix: str, srcs, hashed, flags, tail=()) -> str:
    """``c++ flags -o _build/<out_stem>_<hash><suffix> srcs tail`` unless
    that file exists; the hash covers the compiler, the flags, the tail,
    the compiler's target macros and every file in ``srcs`` and ``hashed``
    (headers, libraries linked in) that exists.  Returns the path."""
    for src in srcs:
        if not os.path.exists(src):
            raise KernelBuildError(f"no source {src}")
    cxx = _cxx()
    base, target = _host_flags(cxx)
    flags = tuple(base) + tuple(flags)
    h = hashlib.sha256(" ".join((cxx,) + flags + tuple(tail)).encode())
    h.update(target.encode())
    for path in (*srcs, *hashed):
        if os.path.exists(path):
            with open(path, "rb") as f:
                h.update(f.read())
    out = os.path.join(BUILD_DIR, f"{out_stem}_{h.hexdigest()[:16]}{suffix}")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [cxx, *flags, "-o", tmp, *srcs, *tail]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise KernelBuildError(f"{out_stem} build failed ({r.returncode}):\n"
                               f"{' '.join(cmd)}\n{r.stdout}\n{r.stderr}")
    os.replace(tmp, out)
    return out


def host_library(source: str, extra_flags=(), link=(), headers=()) -> str:
    """Build a host C++ source into a shared library in ``_build/`` if
    none for this source, its header (``<stem>.h`` beside it) and
    ``headers``, the flags and the target exists; returns its path.
    ``source`` is a path to a ``.cc`` file or the name of one under
    ``native/`` (``"bsjpeg"``); the library is ``lib<stem>_<hash>.so``.
    Raises KernelBuildError with the compiler's output on failure."""
    src = source if source.endswith(".cc") else os.path.join(NATIVE_DIR, f"{source}.cc")
    stem = os.path.splitext(os.path.basename(src))[0]
    return _host_build(f"lib{stem}", ".so", [src], [src[:-3] + ".h", *headers],
                       ("-shared", *extra_flags), link)


def capi_library() -> str:
    """The port's C ABI, ``libbs_capi_<hash>.so``: the ``native/backscrub.h``
    symbols over ``backscrub_tpu_torch`` (``native/bs_capi.cc`` of this
    package), built at first use."""
    emb = python_embed()
    return host_library(CAPI_SRC, (*emb["include"], f"-I{NATIVE_DIR}"), emb["shim"],
                        headers=(os.path.join(NATIVE_DIR, "backscrub.h"),))


def native_program() -> str:
    """``native/demo.cc`` and ``native/bsio.cc`` (the pure-C++ consumer
    and its V4L2 shim, as they are) linked against :func:`capi_library`
    into the executable ``backscrub_native_torch_<hash>``, built at first
    use.  It embeds this interpreter: run it with the port and its
    site-packages on ``PYTHONPATH``."""
    shim = capi_library()
    emb = python_embed()
    srcs = [os.path.join(NATIVE_DIR, n) for n in ("demo.cc", "bsio.cc")]
    return _host_build("backscrub_native_torch", "", srcs,
                       [os.path.join(NATIVE_DIR, "backscrub.h"), shim],
                       (f"-I{NATIVE_DIR}",),
                       (shim, f"-Wl,-rpath,{os.path.dirname(shim)}", *emb["program"]))


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def launch(name: str, *args) -> None:
    """Call an exported launcher on PyTorch's current stream; raise if the
    launch was refused (cudaGetLastError != 0)."""
    err = getattr(lib(), name)(*args, stream())
    if err != 0:
        raise RuntimeError(f"{name} launch failed with cudaError {err}")


_SMS: dict[torch.device, int] = {}


def sm_count(device: torch.device) -> int:
    """The number of SMs of CUDA ``device`` (read once a device)."""
    if device not in _SMS:
        _SMS[device] = torch.cuda.get_device_properties(device).multi_processor_count
    return _SMS[device]


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device must exist (no silent
    fallback to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device={device!r} requested but CUDA is not "
                           f"available (pass device='cpu' to run the plain "
                           f"versions on the CPU)")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"device must be cpu or cuda, got {device!r}")
    return dev


def check_cuda(t: torch.Tensor, name: str, dtype, shape=None) -> None:
    """Validate a tensor before its pointer goes to a kernel."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
