#!/usr/bin/env python3
"""Sweep the MJPG decode kernel (``jpeg_decode_kernel`` in
``backscrub_tpu_torch/csrc/jpeg.cu``) over its tile, and time it with one
of its steps taken away, on one CUDA card.

Each variant is a copy of ``jpeg.cu`` (with the header it includes),
written to a temporary directory with ``TILE_W`` (pixels a tile across:
32 or 64) and ``NT`` (threads a CTA) replaced, and for an ablation
one step of the kernel cut (``no loads``: no coefficient is staged; ``no
idct``: the windows are left as they are; ``no colour``: one byte a CTA
is written instead of its pixels; ``nothing``: all three), built there by ``nvcc`` with
``-Xptxas -v`` into a library of its own, all builds at once; the
checked-in sources are not touched.  Every full variant decodes the
synthetic MJPG camera's frames at 640x480 and 1280x720 and seeded
coefficients at every sampling at 63x47, byte for byte against the plain
twin (``pipeline/jpeg.py:decode_jpeg_bgr``); the ablations compute
nothing meaningful.  Then the two camera frames are timed by
``chip_smoke.device_ms`` (the profiler's time of ``jpeg_decode_kernel`` a
launch), warm and cold (a 128 MB buffer overwritten before each launch),
the variants in turns: in order, then in reverse.

Usage (from the repository root, on a machine with a CUDA card)::

    python tools/sweep_jpeg_tiles.py

Prints the card's name and power limit, each variant's registers, CTAs
and times; exits 1 if a variant is off or without CUDA.
"""

import ctypes
import os
import re
import shutil
import subprocess
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (TILE_W, NT, ablation): the tree's first
VARIANTS = ((32, 128, ""), (32, 192, ""), (32, 256, ""), (64, 256, ""), (32, 128, "no loads"),
            (32, 128, "no idct"), (32, 128, "no colour"), (32, 128, "nothing"))
# [(text in jpeg.cu, its replacement)] a step taken away
ABLATIONS = {
    "no loads": [("  for (int e = tid; e < nb * 8; e += NT) {",
                  "  for (int e = tid; e < 0; e += NT) {")],
    "no idct": [("  for (int b = grp; b < nb; b += NT / 8) {",
                 "  for (int b = grp; b < 0; b += NT / 8) {")],
    "no colour": [("  for (int s = tid; s < rows * segs; s += NT) {",
                   "  if (tid == 0) out[blockIdx.y * gridDim.x + blockIdx.x] = win[0][0];\n"
                   "  for (int s = tid; s < 0; s += NT) {")],
}
ABLATIONS["nothing"] = ABLATIONS["no loads"] + ABLATIONS["no idct"] + ABLATIONS["no colour"]
SAMPLINGS = {"420": ((2, 2), (1, 1), (1, 1)), "422": ((2, 1), (1, 1), (1, 1)),
             "444": ((1, 1), (1, 1), (1, 1)), "440": ((1, 2), (1, 1), (1, 1)),
             "411": ((4, 1), (1, 1), (1, 1)), "311": ((3, 1), (1, 1), (1, 1)),
             "gray": ((1, 1),)}


def variant_source(text, tile_w, nt, ablation=""):
    """jpeg.cu's ``text`` with the variant's constants and ablation."""
    for const, val in (("TILE_W", tile_w), ("NT", nt)):
        text, n = re.subn(rf"constexpr int {const} = \d+;", f"constexpr int {const} = {val};",
                          text)
        if n != 1:
            raise RuntimeError(f"jpeg.cu no longer defines {const} once")
    for old, new in ABLATIONS.get(ablation, ()):
        if text.count(old) != 1:
            raise RuntimeError(f"jpeg.cu no longer holds the ablation's anchor once: {old!r}")
        text = text.replace(old, new)
    return text


def build(tmp, name, tile_w, nt, ablation):
    """Start nvcc on a copy of jpeg.cu with the variant's constants and
    ablation."""
    from backscrub_tpu_torch import _build
    d = os.path.join(tmp, name)
    os.makedirs(d)
    for f in ("jpeg.cu", "async_copy.cuh"):
        shutil.copy(os.path.join(_build.SRC_DIR, f), d)
    path = os.path.join(d, "jpeg.cu")
    with open(path) as f:
        text = variant_source(f.read(), tile_w, nt, ablation)
    with open(path, "w") as f:
        f.write(text)
    return subprocess.Popen([_build._nvcc(), _build.ARCH, *_build.FLAGS, "-Xptxas", "-v",
                             "-shared", "-o", os.path.join(d, "lib.so"), path],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("sweep_jpeg_tiles: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from backscrub_tpu_torch import _build
    from backscrub_tpu_torch.io import streams
    from backscrub_tpu_torch.io.jpeg import JpegEntropyDecoder, make_info
    from backscrub_tpu_torch.pipeline.jpeg import decode_jpeg_bgr as plain
    from chip_smoke import device_ms
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(smi.strip())
    cases = []           # (name, coefs on the card, q on the card, info, timed)
    for w, h in ((640, 480), (1280, 720)):
        dec = JpegEntropyDecoder()
        coefs, q = dec.decode(streams.SyntheticJpegCamera(w, h)())
        cases.append((f"camera {w}x{h}", [torch.from_numpy(c).cuda() for c in coefs],
                      torch.from_numpy(q.astype(np.int32)).cuda(), dec.info, True))
    for name, sf in SAMPLINGS.items():
        info = make_info(63, 47, sf, ncomp=len(sf))
        rng = np.random.default_rng(len(name))
        cases.append((f"{name} 63x47",
                      [torch.from_numpy(rng.integers(-40, 41, (bh, bw, 64)).astype(np.int16))
                       .cuda() for bh, bw in info.blocks],
                      torch.from_numpy(rng.integers(1, 50, (len(sf), 64)).astype(np.int32))
                      .cuda(), info, False))
    with tempfile.TemporaryDirectory() as tmp:
        names = [f"tile_w={tw} nt={nt}{' ' + ab if ab else ''}" for tw, nt, ab in VARIANTS]
        procs = [build(tmp, f"v{i}", *v) for i, v in enumerate(VARIANTS)]
        libs = []
        for i, (name, proc) in enumerate(zip(names, procs)):
            out = proc.communicate()[0]
            if proc.returncode != 0:
                print(f"{name}: nvcc failed\n{out}", file=sys.stderr)
                return 1
            regs = re.search(r"Used (\d+) registers", out)
            print(f"{name}: {regs.group(1) if regs else '?'} registers")
            lib = ctypes.CDLL(os.path.join(tmp, f"v{i}", "lib.so"))
            lib.bs_jpeg_decode.argtypes = list(_build.SIGNATURES["bs_jpeg_decode"])
            lib.bs_jpeg_decode.restype = ctypes.c_int
            libs.append(lib)

        def runner(lib, coefs, q, info):
            out = torch.empty((info.height, info.width, 3), dtype=torch.uint8, device="cuda")
            geom = [info.height, info.width, info.ncomp]
            for c in range(3):
                geom += [*info.sampling[c], *info.blocks[c]] if c < info.ncomp else [0] * 4
            geom = (ctypes.c_int32 * 15)(*geom)
            ptrs = [coefs[c].data_ptr() if c < info.ncomp else None for c in range(3)]

            def run():
                e = lib.bs_jpeg_decode(*ptrs, q.data_ptr(), out.data_ptr(),
                                       ctypes.addressof(geom),
                                       torch.cuda.current_stream().cuda_stream)
                if e != 0:
                    raise RuntimeError(f"bs_jpeg_decode returned {e}")
                return out
            return run

        bad = 0
        for name, lib, v in zip(names, libs, VARIANTS):
            for case, coefs, q, info, _ in (cases if not v[2] else []):
                got = runner(lib, coefs, q, info)()
                if not torch.equal(got, plain(coefs, q, info)):
                    print(f"{name}: {case} differs from the plain twin")
                    bad += 1
        if bad:
            return 1
        times = {n: {} for n in names}
        for order in (list(range(len(libs))), list(reversed(range(len(libs))))):
            for i in order:
                for case, coefs, q, info, timed in cases:
                    if timed:
                        run = runner(libs[i], coefs, q, info)
                        times[names[i]].setdefault(case, []).append(
                            (1e3 * device_ms(run, kernel="jpeg_decode_kernel"),
                             1e3 * device_ms(run, cold="jpeg_decode_kernel")))
        for (tw, _, _), name in zip(VARIANTS, names):
            print(f"{name}: " + "; ".join(
                f"{case} ({-(-info.width // tw) * -(-info.height // 32)} CTAs) warm "
                + " / ".join(f"{t[0]:.3f}" for t in times[name][case]) + " us, cold "
                + " / ".join(f"{t[1]:.3f}" for t in times[name][case]) + " us"
                for case, _, _, info, timed in cases if timed))
    return 0


if __name__ == "__main__":
    sys.exit(main())
