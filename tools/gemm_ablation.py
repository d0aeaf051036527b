"""Time the wgmma GEMM tile (``csrc/gemm_wg.cuh``) with one part of its work
taken away at a time, on one CUDA card: what bounds it.

Builds ``csrc/body_flat.cu`` (``bs_gemm``) alone into a library of its own
for the tile as it is and for each ablation, each a copy of the sources
with one edit of ``gemm_wg.cuh``:

- ``no products``: no wgmma is issued (the accumulators stay 0);
- ``no split``: the A fragments are a constant, x is not read from shared
  memory nor split;
- ``no x loads``: no cp.async of x (the W blocks still come in);

then at each shape times ``bs_gemm`` at ``terms`` 1, 3 and 6 (the profiler's
device time of ``gemm_wg_kernel`` a launch, ``chip_smoke.device_ms``), at
``gemm_config``'s width, on seeded inputs, and prints each variant's
microseconds and the share of the tile's time that the part took away
saves.  The full tile is checked against its plain twin (1e-5 relative);
the ablations compute nothing meaningful.

Usage (from the repository root, on a machine with a CUDA card)::

    python tools/gemm_ablation.py [--shapes 256x512 80x480 ...]
"""

import argparse
import ctypes
import os
import shutil
import subprocess
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
L = 33 * 33

# (name, [(text in gemm_wg.cuh, its replacement)])
ABLATIONS = [
    ("no products", [("namespace gemm_wg {\n",
                      "namespace gemm_wg {\n"
                      "template <typename... A>\n"
                      "__device__ __forceinline__ void skip_mma(A...) {}\n"),
                     ("wg::mma<BN>(", "skip_mma(")]),
    ("no split", [("        if constexpr (TERMS == 6)\n"
                   "          wg::split3(r0[m], r1[m], af[h][0][q], af[h][1][q], af[h][2][q]);\n"
                   "        else if constexpr (TERMS == 3)\n"
                   "          wg::split2(r0[m], r1[m], af[h][0][q], af[h][1][q]);\n"
                   "        else\n"
                   "          af[h][0][q] = wg::round2(r0[m], r1[m]);",
                   "        (void)r0;\n        (void)r1;\n"
                   "        for (int p = 0; p < P; ++p) af[h][p][q] = 0x3f803f80u;")]),
    ("no x loads", [("    for (int e = tid; e < BK * XCH; e += NT) {",
                     "    for (int e = tid; e < 0; e += NT) {")]),
]


def build(src_dir, out, edits):
    """Start nvcc on a copy of ``src_dir`` with ``edits`` applied to
    gemm_wg.cuh, building body_flat.cu alone into ``out``."""
    from backscrub_tpu_torch import _build
    d = out + ".src"
    shutil.copytree(src_dir, d)
    path = os.path.join(d, "gemm_wg.cuh")
    text = open(path).read()
    for old, new in edits:
        if old not in text:
            raise RuntimeError(f"gemm_wg.cuh no longer holds the ablation's anchor: {old!r}")
        text = text.replace(old, new)
    with open(path, "w") as f:
        f.write(text)
    return subprocess.Popen([_build._nvcc(), _build.ARCH, *_build.FLAGS, "-shared", "-o", out,
                             os.path.join(d, "body_flat.cu")], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shapes", nargs="*", default=["16x96", "96x16", "80x480", "256x512"])
    a = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("gemm_ablation: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from backscrub_tpu_torch import _build
    from backscrub_tpu_torch.ops import megakernel as mk
    from chip_smoke import device_ms
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    variants = [("tile", [])] + ABLATIONS
    with tempfile.TemporaryDirectory() as tmp:
        procs = [build(_build.SRC_DIR, os.path.join(tmp, f"v{i}.so"), edits)
                 for i, (_, edits) in enumerate(variants)]
        for (name, _), proc in zip(variants, procs):
            out = proc.communicate()[0]
            if proc.returncode != 0:
                print(f"{name}: nvcc failed\n{out}", file=sys.stderr)
                return 1
        libs = []
        for i in range(len(variants)):
            lib = ctypes.CDLL(os.path.join(tmp, f"v{i}.so"))
            lib.bs_gemm.argtypes = list(_build.SIGNATURES["bs_gemm"])
            lib.bs_gemm.restype = ctypes.c_int
            libs.append(lib)
        print(f"{torch.cuda.get_device_name(0)}; bs_gemm, device us a launch")
        for terms in (1, 3, 6):
            for shape in a.shapes:
                co, ci = map(int, shape.split("x"))
                rng = np.random.default_rng(co * 1000 + ci)
                w = torch.from_numpy((rng.standard_normal((co, ci)) / np.sqrt(ci)).astype(
                    np.float32)).cuda()
                b = torch.from_numpy(rng.standard_normal(co).astype(np.float32)).cuda()
                x = torch.from_numpy(rng.uniform(0, 2, (ci, L)).astype(np.float32)).cuda()
                tile, split, kchunk = mk.gemm_config(co, ci, L, sms, terms)
                blk = mk.wgmma_weights(w, terms, L)
                y = torch.empty((co, L), device="cuda")
                part = torch.empty(split * co * L, device="cuda")
                times = []
                for lib in libs:
                    def run(lib=lib):
                        e = lib.bs_gemm(blk.data_ptr(), b.data_ptr(), x.data_ptr(),
                                        y.data_ptr(), part.data_ptr(), co, ci, L, 0, tile,
                                        split, kchunk, terms,
                                        torch.cuda.current_stream().cuda_stream)
                        if e != 0:
                            raise RuntimeError(f"bs_gemm returned {e}")
                    run()
                    if not times:
                        torch.cuda.synchronize()
                        ref = {1: mk.conv1x1_bf16_plain, 3: mk.conv1x1_bf16x3_plain,
                               6: mk.conv1x1_bf16x6_plain}[terms](w, b, x)
                        rel = float((y - ref).abs().max() / ref.abs().max())
                        if rel > 1e-5:
                            raise AssertionError(f"{shape} terms={terms}: {rel:.3g} from twin")
                    times.append(1e3 * device_ms(run, kernel="gemm_wg_kernel"))
                full = times[0]
                print(f"terms={terms} {shape} (width {mk._WG_TILES[tile]}, split {split}): "
                      f"tile {full:.3f} us; " + "; ".join(
                          f"{name} {t:.3f} us (saves {(full - t) / full:.1%})"
                          for (name, _), t in zip(ABLATIONS, times[1:])))
    return 0


if __name__ == "__main__":
    sys.exit(main())
