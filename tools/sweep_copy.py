#!/usr/bin/env python3
"""Sweep the strided copy of P6 and P7 (``strided_copy_kernel`` in
``backscrub_tpu_torch/csrc/probes.cu``) and P5's two-source copy on its
body (``concat_kernel``) on one CUDA card.

Each variant is a copy of ``probes.cu`` alone, written to a temporary
directory with ``CP_NT`` (threads a CTA: 64, 128, 256) and ``CP_LOADS``
(16-byte input vectors a thread: 2, 4, 8, so P6 stores 1, 2 or 4 vectors a
thread and P7 2, 4 or 8) replaced, and built there by ``nvcc``
into a library of its own, all builds at once; the checked-in sources are
not touched.  The ``register`` design is the tree's kernel (every load
into registers, then a fence, then the stores); ``register-nofence``
drops the fence; ``register-volatile`` loads by ``ld.volatile.global``
(``VOLATILE_LOAD``), which ptxas keeps 16 bytes wide where the tree's
plain load of P6's input vectors becomes two 4-byte loads of lanes x and
z.  The ``tma`` design (``TMA_KERNEL`` below, swapped into the
launcher's vector path for S = 1, P7) copies through the Tensor Memory
Accelerator: one thread a CTA issues ``cp.async.bulk`` of the CTA's
CP_NT x CP_LOADS vectors global -> shared, waits on its mbarrier, and
issues ``cp.async.bulk`` shared -> global.  The ``shfl`` design
(``SHFL_KERNEL``, swapped in for S = 2, P6) makes each of a warp's loads
512 contiguous bytes and trades lanes x and z by warp shuffles before the
16-byte stores, where the tree's kernel loads the two vectors behind a
thread's output (a warp's load spans 1 KB, half of each sector).  The
``concat`` design is the tree's source, timed on P5: at 128 threads and
``CP_LOADS`` 2, 4 and 8 the probe's 30720 output vectors take 120, 60 and
30 CTAs, so it reads how a copy's time moves with its CTA count.  Every
variant runs ``tools/probe_hopper.py``'s copy cases (``cat_cases`` for
``concat``), bit-identical to the plain twins and on the kernel its shape
picks (by the profiler's kernel name), then P6 and P7 (P5 for ``concat``)
on the original's inputs are timed by ``chip_smoke.device_ms``, warm
(inputs in L2) and cold (a 128 MB buffer overwritten before each launch),
the variants in turns: in order, then in reverse.

Usage (from the repository root, on a machine with a CUDA card)::

    python tools/sweep_copy.py [DESIGN ...]

(every design without arguments; one process a design keeps the
profiler's windows per process few).

Prints the card's name and power limit, a line a variant and turn, and
the variants ranked by their mean warm time (P6 + P7, or P5); exits 1 if a
variant is off or without CUDA.
"""

import ctypes
import functools
import os
import re
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
THREADS = (64, 128, 256)
LOADS = (2, 4, 8)
DESIGNS = ("register", "register-nofence", "register-volatile", "shfl", "tma", "concat")

# P7's vector path through the TMA, put in front of copy_vec
TMA_KERNEL = r'''
__global__ void __launch_bounds__(CP_NT)
copy_tma_kernel(const float4* __restrict__ x, float4* __restrict__ out, int m) {
  constexpr int SEG = CP_NT * CP_LOADS;        // vectors a CTA
  __shared__ __align__(128) float4 buf[SEG];
  __shared__ __align__(8) uint64_t bar;
  if (threadIdx.x != 0) return;
  const int v0 = blockIdx.x * SEG;
  const uint32_t bytes = 16u * (uint32_t)min(SEG, m - v0);
  const uint32_t b = smem_u32(&bar), s = smem_u32(buf);
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(b) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(b), "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(s), "l"(x + v0), "r"(bytes), "r"(b) : "memory");
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(b) : "memory");
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               ::"l"(out + v0), "r"(s), "r"(bytes) : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

'''
# P6's vector path with a warp's loads contiguous: a thread loads input
# vectors i = base + k CP_NT + t (k < CP_LOADS); the lanes of groups 2j and
# 2j + 1 trade lanes x and z by shuffles, lane l < 16 storing group 2j's
# output 16 w + l from lanes 2l and 2l + 1, lane l >= 16 group 2j + 1's
SHFL_KERNEL = r'''
__global__ void __launch_bounds__(CP_NT)
copy_shfl_kernel(const float4* __restrict__ x, float4* __restrict__ out, int m) {
  constexpr unsigned FULL = 0xffffffffu;
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  const int base = blockIdx.x * (CP_NT * CP_LOADS);     // the CTA's first input vector
  float4 in[CP_LOADS];
#pragma unroll
  for (int k = 0; k < CP_LOADS; ++k) {
    const int i = base + k * CP_NT + t;
    in[k] = ld4_if(reinterpret_cast<const float*>(x + i), i < 2 * m);
  }
  __threadfence_block();
  const int a = (2 * lane) & 31, b = a + 1;
  const bool lo = lane < 16;
#pragma unroll
  for (int j = 0; j < CP_LOADS / 2; ++j) {
    const float4 p = in[2 * j], q = in[2 * j + 1];
    const float pax = __shfl_sync(FULL, p.x, a), paz = __shfl_sync(FULL, p.z, a);
    const float pbx = __shfl_sync(FULL, p.x, b), pbz = __shfl_sync(FULL, p.z, b);
    const float qax = __shfl_sync(FULL, q.x, a), qaz = __shfl_sync(FULL, q.z, a);
    const float qbx = __shfl_sync(FULL, q.x, b), qbz = __shfl_sync(FULL, q.z, b);
    const int o = (base + (2 * j + (lo ? 0 : 1)) * CP_NT) / 2 + 16 * w + (lane & 15);
    if (o < m)
      out[o] = lo ? make_float4(pax, paz, pbx, pbz) : make_float4(qax, qaz, qbx, qbz);
  }
}

'''
_BEFORE = "// P6 and P7's vector path: the copy flat"
_LAUNCH = "    strided_copy_kernel<S><<<"
_TMA_LAUNCH = ("    void (*const kern)(const float4*, float4*, int) =\n"
               "        S == 1 ? &copy_tma_kernel : &strided_copy_kernel<S>;\n"
               "    kern<<<")
_SHFL_LAUNCH = ("    void (*const kern)(const float4*, float4*, int) =\n"
                "        S == 2 ? &copy_shfl_kernel : &strided_copy_kernel<S>;\n"
                "    kern<<<")
_FENCE = "__threadfence_block();"
# the copy's loads as volatile 16-byte loads, put in front of its kernel
VOLATILE_LOAD = r'''
__device__ __forceinline__ float4 ld4v_if(const float* p, bool pred) {
  float4 v;
  asm volatile(
      "{\n"
      ".reg .pred q;\n"
      "setp.ne.b32 q, %5, 0;\n"
      "mov.f32 %0, 0f00000000;\n"
      "mov.f32 %1, 0f00000000;\n"
      "mov.f32 %2, 0f00000000;\n"
      "mov.f32 %3, 0f00000000;\n"
      "@q ld.volatile.global.v4.f32 {%0, %1, %2, %3}, [%4];\n"
      "}\n"
      : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
      : "l"(p), "r"((int)pred));
  return v;
}

'''
_KERNEL = "template <int S>\n__device__ __forceinline__ void copy_vectors("
_LOAD = "in[k][s] = ld4_if("


def variant_source(text: str, design: str, nt: int, loads: int) -> str:
    """probes.cu with CP_NT = ``nt``, CP_LOADS = ``loads`` and the design's
    vector path."""
    for name, value in (("CP_NT", nt), ("CP_LOADS", loads)):
        pattern = re.compile(rf"constexpr int {name} = \d+;")
        if len(pattern.findall(text)) != 1:
            raise RuntimeError(f"probes.cu does not define {name} once")
        text = pattern.sub(f"constexpr int {name} = {value};", text)
    if design == "register-nofence":
        start = text.index("copy_vectors(const float4*")
        end = text.index("strided_copy_kernel(", start)
        if text[start:end].count(_FENCE) != 1:
            raise RuntimeError("probes.cu's copy fence is not where the sweep expects")
        text = text[:start] + text[start:end].replace(_FENCE, "") + text[end:]
    if design == "register-volatile":
        if text.count(_KERNEL) != 1 or text.count(_LOAD) != 1:
            raise RuntimeError("probes.cu's copy load is not where the sweep expects")
        text = text.replace(_KERNEL, VOLATILE_LOAD + _KERNEL).replace(_LOAD, "in[k][s] = ld4v_if(")
    if design in ("tma", "shfl"):
        if text.count(_BEFORE) != 1 or text.count(_LAUNCH) != 1:
            raise RuntimeError("probes.cu's copy launcher is not where the sweep expects")
        kernel, launch = (TMA_KERNEL, _TMA_LAUNCH) if design == "tma" else (SHFL_KERNEL,
                                                                             _SHFL_LAUNCH)
        text = text.replace(_BEFORE, kernel + _BEFORE).replace(_LAUNCH, launch)
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
        lib.path = so
        for name, args in _build.SIGNATURES.items():
            if name.startswith("bs_probe_"):
                fn = getattr(lib, name)
                fn.argtypes, fn.restype = list(args), ctypes.c_int
        libs[v] = lib
    return libs


def kernel_name(design: str, probe: str, vec: bool) -> str:
    """The profiler name of the kernel a variant launches for ``probe`` on
    the vector (``vec``) or the scalar path."""
    import probe_hopper
    if probe == "P5":
        return probe_hopper.CAT_KERNELS[vec]
    if vec and design == "tma" and probe == "P7":
        return "::copy_tma_kernel"
    if vec and design == "shfl" and probe == "P6":
        return "::copy_shfl_kernel"
    return probe_hopper.COPY_KERNELS[vec]


def main(argv) -> int:
    import torch
    designs = argv or list(DESIGNS)
    if any(d not in DESIGNS for d in designs):
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("sweep_copy: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import probe_hopper
    from chip_smoke import device_ms, loads_first_in_sass, sass_functions
    from backscrub_tpu_torch import _build
    from backscrub_tpu_torch.ops import probe_kernels as pk

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    a = probe_hopper.inputs()
    x2, x3 = torch.from_numpy(a["x2"]).cuda(), torch.from_numpy(a["x3"]).cuda()
    copies = {"P6": functools.partial(pk.lane_stride2, x2),
              "P7": functools.partial(pk.reshape_flat, x3)}
    concat = {"P5": functools.partial(pk.concat, x2, x2)}
    variants = [(d, nt, loads) for d in designs for nt in THREADS for loads in LOADS]
    copy_cases, cat_cases = probe_hopper.copy_cases("cuda"), probe_hopper.cat_cases("cuda")
    bad, warm = 0, {v: [] for v in variants}
    with tempfile.TemporaryDirectory() as tmp, torch.no_grad():
        libs = build_all(variants, tmp)
        for v in variants:
            _build._Lib.handle = libs[v]
            off = []
            cases = cat_cases if v[0] == "concat" else copy_cases
            for name, kernel, plain, vec in cases:
                names = probe_hopper.launched_kernels(kernel)
                want = kernel_name(v[0], name[:2], vec)
                if not torch.equal(kernel(), plain()) or len(names) != 1 or want not in names[0]:
                    off.append(name)
            bad += bool(off)
            try:
                sass = f"LDGs by probe {loads_first_in_sass(sass_functions(libs[v].path))}, each " \
                       f"before the first STG"
            except AssertionError as e:
                sass = str(e)
            print("{} {} threads x {} loads: ".format(*v)
                  + (f"OFF at {off}" if off else f"bit-identical at {len(cases)} shapes")
                  + f"; SASS: {sass}")
        for turn, v in enumerate(variants + variants[::-1]):
            _build._Lib.handle = libs[v]
            t = {}
            for p, fn in (concat if v[0] == "concat" else copies).items():
                k = kernel_name(v[0], p, True)
                t[p] = (device_ms(fn, kernel=k) * 1e3, device_ms(fn, cold=k) * 1e3)
            warm[v].append(sum(w for w, _ in t.values()))
            print(f"turn {turn} " + "{} {} x {}".format(*v) + ": device us a launch, "
                  + ", ".join(f"{p} warm {w:.3f} cold {c:.3f}" for p, (w, c) in t.items()))
        _build._Lib.handle = None
    for v in sorted(variants, key=lambda v: sum(warm[v])):
        print("rank {} {} x {}: {} warm {:.3f} us (mean of {} turns)".format(
            *v, "P5" if v[0] == "concat" else "P6 + P7", sum(warm[v]) / len(warm[v]),
            len(warm[v])))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
