"""Check that ``bs_gemm`` gives the same bits as the ``bs_gemm`` of another
checkout of this repository (an earlier commit, unpacked with ``git
archive``), on one CUDA card.

Builds the other checkout's kernel library with that checkout's own
``backscrub_tpu_torch/_build.py`` (into its own ``_build/``), loads it beside
this checkout's, and runs both ``bs_gemm`` on the same seeded inputs at
every 1x1 shape of the deeplab frame and at ragged ones, with each of the
four tiles unsplit and with ``gemm_config``'s own choice (split K
included), under RELU6.  Prints the shapes whose outputs differ and exits
1 if any does.

Usage (from the repository root, on a machine with a CUDA card)::

    python tools/gemm_bits_vs_build.py OTHER_CHECKOUT
"""

import ctypes
import importlib.util
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = [(16, 96), (21, 256), (32, 96), (32, 192), (48, 192), (48, 288), (80, 288),
          (80, 480), (96, 16), (160, 480), (192, 32), (256, 160), (256, 512), (288, 48),
          (480, 80)]
L = 33 * 33
RAGGED = [(7, 5, 33), (33, 100, 77), (130, 13, 1)]


def other_library(root: str) -> ctypes.CDLL:
    """``root``'s kernel library, built by its own _build.py."""
    spec = importlib.util.spec_from_file_location(
        "other_build", os.path.join(root, "backscrub_tpu_torch", "_build.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    lib = ctypes.CDLL(mod.build())
    lib.bs_gemm.argtypes = list(mod.SIGNATURES["bs_gemm"])
    lib.bs_gemm.restype = ctypes.c_int
    return lib


def main(argv) -> int:
    import torch
    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("gemm_bits_vs_build: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from backscrub_tpu_torch import _build
    from backscrub_tpu_torch.ops import megakernel as mk
    libs = {"this": _build.lib(), "other": other_library(os.path.abspath(argv[0]))}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    act = mk._ACT_CODES["RELU6"]
    differ, runs = [], 0
    for co, ci, n in [(co, ci, L) for co, ci in SHAPES] + RAGGED:
        rng = np.random.default_rng(co * 1000 + ci)
        w, x = (torch.from_numpy((rng.standard_normal(s) / np.sqrt(ci)).astype(np.float32))
                .cuda() for s in ((co, ci), (ci, n)))
        b = torch.from_numpy(rng.standard_normal(co).astype(np.float32)).cuda()
        hi, lo = mk.split_bf16(w)
        kp = hi.shape[1]
        configs = {(t, 1, kp + (-kp % 16)) for t in range(len(mk._GEMM_TILES))}
        configs.add(mk.gemm_config(co, ci, n, sms))
        for tile, split, kchunk in sorted(configs):
            part = torch.empty(split * co * n, device="cuda")
            outs = {}
            for name, lib in libs.items():
                y = torch.full((co, n), float("nan"), device="cuda")
                err = lib.bs_gemm(hi.data_ptr(), lo.data_ptr(), b.data_ptr(), x.data_ptr(),
                                  y.data_ptr(), part.data_ptr(), co, ci, kp, n, act, tile,
                                  split, kchunk, _build.stream())
                if err:
                    raise RuntimeError(f"{name} bs_gemm failed with cudaError {err}")
                outs[name] = y
            torch.cuda.synchronize()
            runs += 1
            if not torch.equal(outs["this"], outs["other"]):
                d = int((outs["this"] != outs["other"]).sum())
                differ.append(f"{co}x{ci}x{n} tile {tile} split {split}: {d} values differ")
    print(f"bs_gemm vs the other build: {runs} runs, {len(differ)} differ "
          f"({torch.cuda.get_device_name(0)})")
    for line in differ:
        print("  " + line)
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
