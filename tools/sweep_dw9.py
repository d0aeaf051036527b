#!/usr/bin/env python3
"""Sweep the stencil kernel of P1 and P2 (``dw9_kernel`` in
``backscrub_tpu_torch/csrc/probes.cu``) on one CUDA card.

Each variant is a copy of ``probes.cu`` alone, written to a temporary
directory with ``DW_NT`` (threads a CTA: 128, 256, 512) and ``DW_VEC``
(outputs a thread: 4, 8) replaced, and built there by ``nvcc`` into a
library of its own, all builds at once; the checked-in sources are not
touched.  The ``register`` design is the tree's kernel (a register window
whose edge taps come by warp shuffles); ``register-nofence`` drops the
fence behind its loads, ``register-syncwarp`` puts ``__syncwarp()`` in
its place.  The ``shared`` design (where its window fits the 48 KB of
static shared memory) is the
body's depthwise staging (``dw_op`` in ``csrc/body_mega.cu``) in its
place: a CTA stages its segment's three tap-row windows in shared memory
with 16-byte loads, then every thread reads its 3 x (DW_VEC + 2) floats
from there (``SHARED_KERNEL`` below, swapped into the launcher's vector
path).  Every variant runs ``tools/probe_hopper.py``'s stencil cases,
bit-identical to the plain twins and on the kernel its shape picks (by
the profiler's kernel name), then P1 and P2 on the original's inputs are
timed by ``chip_smoke.device_ms``, warm (inputs in L2) and cold (a 128 MB
buffer overwritten before each launch), the variants in turns: in order,
then in reverse.

Usage (from the repository root, on a machine with a CUDA card)::

    python tools/sweep_dw9.py

Prints the card's name and power limit, a line a variant and turn, and
the variants ranked by their mean warm time; exits 1 if a variant is off
or without CUDA.
"""

import ctypes
import functools
import os
import re
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
THREADS = (128, 256, 512)
OUTPUTS = (4, 8)
DESIGNS = ("register", "register-nofence", "register-syncwarp", "shared")
SMEM_LIMIT = 48 * 1024     # static shared memory a CTA: the shared design's window
COLD = "::dw9_"            # both designs' kernels and the scalar path

# the shared-memory window, swapped in for dw9_kernel on the vector path
SHARED_KERNEL = r'''
namespace {

__global__ void __launch_bounds__(DW_NT)
dw9_smem_kernel(const float* __restrict__ x, float* __restrict__ out, int c, int n_in,
                int n_out, int s, int off, int di0) {
  constexpr int SEG = DW_NT * DW_VEC;          // outputs a CTA
  // a tap row's window: [3] the float left of the segment, [4, 4 + SEG)
  // its floats (16-byte aligned), [4 + n_seg] the float right of it
  __shared__ __align__(16) float win[3][SEG + 8];
  const int seg0 = blockIdx.x * SEG, t = threadIdx.x;
  const int n_seg = min(SEG, n_out - seg0), p0 = seg0 + t * DW_VEC;
  float w[3][3];
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int b = 0; b < 3; ++b) w[a][b] = dw9_weight(di0 + a, b);
  for (int ch = blockIdx.y; ch < c; ch += gridDim.y) {
    const float* row = x + (size_t)ch * n_in;
    // the window's loads into registers first, all in flight at once
    float4 body[3][DW_VEC / 4];
    float edge[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const int q0 = seg0 + off + a * s;
#pragma unroll
      for (int k = 0; k < DW_VEC / 4; ++k) {
        const int i = t + k * DW_NT;
        body[a][k] = ld4_if(row + q0 + 4 * i, i < n_seg / 4);
      }
      edge[a] = t == 0 ? ld_if(row + q0 - 1, q0 >= 1)
                       : ld_if(row + q0 + n_seg, t == 32 && q0 + n_seg < n_in);
    }
    __syncthreads();                           // the last channel's reads are done
#pragma unroll
    for (int a = 0; a < 3; ++a) {
#pragma unroll
      for (int k = 0; k < DW_VEC / 4; ++k)
        if (t + k * DW_NT < n_seg / 4) reinterpret_cast<float4*>(&win[a][4])[t + k * DW_NT] =
            body[a][k];
      if (t == 0) win[a][3] = edge[a];
      if (t == 32) win[a][4 + n_seg] = edge[a];
    }
    __syncthreads();
    if (p0 >= n_out) continue;
    float acc[DW_VEC];
#pragma unroll
    for (int j = 0; j < DW_VEC; ++j) acc[j] = 0.0f;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      float v[DW_VEC + 2];
      v[0] = win[a][3 + t * DW_VEC];
#pragma unroll
      for (int k = 0; k < DW_VEC / 4; ++k) {
        const float4 q = reinterpret_cast<const float4*>(&win[a][4])[t * (DW_VEC / 4) + k];
        v[1 + 4 * k] = q.x;
        v[2 + 4 * k] = q.y;
        v[3 + 4 * k] = q.z;
        v[4 + 4 * k] = q.w;
      }
      v[DW_VEC + 1] = win[a][4 + t * DW_VEC + DW_VEC];
#pragma unroll
      for (int b = 0; b < 3; ++b)
#pragma unroll
        for (int j = 0; j < DW_VEC; ++j)
          acc[j] = __fadd_rn(acc[j], __fmul_rn(v[j + b], w[a][b]));
    }
    float4* dst = reinterpret_cast<float4*>(out + (size_t)ch * n_out + p0);
#pragma unroll
    for (int k = 0; k < DW_VEC / 4; ++k)
      dst[k] = make_float4(acc[4 * k], acc[4 * k + 1], acc[4 * k + 2], acc[4 * k + 3]);
  }
}

}  // namespace

'''
_LAUNCHER = 'extern "C" int bs_probe_dw9('
_VECTOR = "vec ? &dw9_kernel : &dw9_scalar_kernel"
_FENCE = "__threadfence_block();                     // the loads' fence"


def variant_source(text: str, design: str, nt: int, vec: int) -> str:
    """probes.cu with DW_NT = ``nt``, DW_VEC = ``vec`` and, for the shared
    design, SHARED_KERNEL on the vector path."""
    for name, value in (("DW_NT", nt), ("DW_VEC", vec)):
        pattern = re.compile(rf"constexpr int {name} = \d+;")
        if len(pattern.findall(text)) != 1:
            raise RuntimeError(f"probes.cu does not define {name} once")
        text = pattern.sub(f"constexpr int {name} = {value};", text)
    if design.startswith("register-"):
        if text.count(_FENCE) != 1:
            raise RuntimeError("probes.cu's stencil fence is not where the sweep expects")
        text = text.replace(_FENCE, "__syncwarp();" if design.endswith("syncwarp") else "")
    if design == "shared":
        if text.count(_LAUNCHER) != 1 or text.count(_VECTOR) != 1:
            raise RuntimeError("probes.cu's stencil launcher is not where the sweep expects")
        text = text.replace(_LAUNCHER, SHARED_KERNEL + _LAUNCHER).replace(
            _VECTOR, "vec ? &dw9_smem_kernel : &dw9_scalar_kernel")
    return text


def build_all(variants, tmp: str):
    """Each variant's library (probes.cu alone), all nvcc processes at
    once; {variant: ctypes library} with the probes' argument types."""
    from backscrub_tpu_torch import _build
    with open(os.path.join(_build.SRC_DIR, "probes.cu")) as f:
        text = f.read()
    jobs = {}
    for v in variants:
        src = os.path.join(tmp, "probes_{}_{}_{}.cu".format(*v))
        with open(src, "w") as f:
            f.write(variant_source(text, *v))
        so = src[:-3] + ".so"
        cmd = [_build._nvcc(), _build.ARCH, *_build.FLAGS, "-shared", "-I", _build.SRC_DIR,
               "-o", so, src]
        jobs[v] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                        text=True))
    libs = {}
    for v, (so, proc) in jobs.items():
        out, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {v}:\n{out}\n{err}")
        lib = ctypes.CDLL(so)
        for name, args in _build.SIGNATURES.items():
            if name.startswith("bs_probe_"):
                fn = getattr(lib, name)
                fn.argtypes, fn.restype = list(args), ctypes.c_int
        libs[v] = lib
    return libs


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("sweep_dw9: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import probe_hopper
    from chip_smoke import device_ms
    from backscrub_tpu_torch import _build
    from backscrub_tpu_torch.ops import probe_kernels as pk
    from backscrub_tpu_torch.pipeline.maskgen import set_precision_policy

    set_precision_policy()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    a = probe_hopper.inputs()
    xpad, xp = torch.from_numpy(a["xpad"]).cuda(), torch.from_numpy(a["xp"]).cuda()
    timed = {"P1": functools.partial(pk.dw_flat, xpad, probe_hopper.W),
             "P2": functools.partial(pk.dw_rowpad, xp)}
    variants = [(d, nt, vec) for d in DESIGNS for nt in THREADS for vec in OUTPUTS
                if d != "shared" or 3 * (nt * vec + 8) * 4 <= SMEM_LIMIT]
    cases = probe_hopper.stencil_cases("cuda")
    vector_names = {d: "::dw9_smem_kernel" if d == "shared" else "::dw9_kernel"
                    for d in DESIGNS}
    bad, warm = 0, {v: [] for v in variants}
    with tempfile.TemporaryDirectory() as tmp, torch.no_grad():
        libs = build_all(variants, tmp)
        for v in variants:
            _build._Lib.handle = libs[v]
            off = []
            for name, kernel, plain, vec in cases:
                names, want_out = probe_hopper.launched_kernels(kernel), plain()
                vec = vec and want_out.shape[1] % v[2] == 0      # whole vectors of outputs
                want = vector_names[v[0]] if vec else probe_hopper.STENCIL_KERNELS[False]
                if not torch.equal(kernel(), want_out) or len(names) != 1 \
                        or want not in names[0]:
                    off.append(name)
            bad += bool(off)
            print("{} {} threads x {} outputs: ".format(*v)
                  + (f"OFF at {off}" if off else f"bit-identical at {len(cases)} shapes"))
        for turn, v in enumerate(variants + variants[::-1]):
            _build._Lib.handle = libs[v]
            t = {p: (device_ms(fn, kernel=COLD) * 1e3, device_ms(fn, cold=COLD) * 1e3)
                 for p, fn in timed.items()}
            warm[v].append(t["P1"][0] + t["P2"][0])
            print(f"turn {turn} " + "{} {} x {}".format(*v) + ": device us a launch, "
                  + ", ".join(f"{p} warm {w:.3f} cold {c:.3f}" for p, (w, c) in t.items()))
        _build._Lib.handle = None
    for v in sorted(variants, key=lambda v: sum(warm[v])):
        print("rank {} {} x {}: P1 + P2 warm {:.3f} us (mean of {} turns)".format(
            *v, sum(warm[v]) / len(warm[v]), len(warm[v])))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
