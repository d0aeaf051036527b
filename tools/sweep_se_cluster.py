#!/usr/bin/env python3
"""Sweep the cluster size of P4, the squeeze-excite probe kernel
(``SE_R`` in ``backscrub_tpu_torch/csrc/probes.cu``), on one CUDA card.

For each size R in ``SIZES`` the kernel sources are copied into a
temporary directory with ``constexpr int SE_R = R;`` and built there by
``_build`` into a library of their own; the checked-in sources are not
touched.  Each build runs ``probe_kernels.se`` on the original's seeded
inputs (``tools/probe_hopper.py``: x (16, 3840), w (16, 16)) and at
(32, 100000) (the chunked path), holds it within 1e-5 of ``se_plain``
with two runs bit-identical, and times it by ``chip_smoke.device_ms``
at the probe shape, warm (inputs in L2) and cold (a 128 MB buffer
overwritten before each launch), the sizes in turns: 8, 16, 16, 8.

Usage (from the repository root, on a machine with a CUDA card)::

    python tools/sweep_se_cluster.py

Prints the card's name and power limit, then a line a size and turn;
exits 1 if a build is off or without CUDA.
"""

import os
import re
import shutil
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZES = (8, 16)
TOL = 1e-5
# the kernel's profiler name ("(anonymous namespace)::se_kernel(...)"; the
# L2 flush's elementwise_kernel holds "se_kernel" too)
SE_KERNEL = "::se_kernel"
_PATTERN = re.compile(r"constexpr int SE_R = \d+;")


def build_variant(r: int, tmp: str):
    """The kernel library with SE_R = ``r``, built under ``tmp``."""
    from backscrub_tpu_torch import _build
    src = os.path.join(tmp, f"csrc_{r}")
    shutil.copytree(_build.SRC_DIR, src)
    path = os.path.join(src, "probes.cu")
    with open(path) as f:
        text = f.read()
    if len(_PATTERN.findall(text)) != 1:
        raise RuntimeError("probes.cu does not define SE_R once")
    with open(path, "w") as f:
        f.write(_PATTERN.sub(f"constexpr int SE_R = {r};", text))
    saved = _build.SRC_DIR, _build.BUILD_DIR, _build._Lib.handle
    _build.SRC_DIR, _build.BUILD_DIR = src, os.path.join(tmp, f"build_{r}")
    _build._Lib.handle = None
    try:
        return _build.lib()
    finally:
        _build.SRC_DIR, _build.BUILD_DIR, _build._Lib.handle = saved


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("sweep_se_cluster: CUDA is not available", file=sys.stderr)
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
    x, w = torch.from_numpy(a["x2"]).cuda(), torch.from_numpy(a["w16"]).cuda()
    rng = np.random.default_rng(5)
    xl = torch.from_numpy(rng.random((32, 100000), np.float32)).cuda()
    wl = torch.from_numpy(rng.random((32, 32), np.float32) - 0.5).cuda()
    bad = 0
    with tempfile.TemporaryDirectory() as tmp, torch.no_grad():
        libs = {r: build_variant(r, tmp) for r in SIZES}
        for r in SIZES:
            _build._Lib.handle = libs[r]
            if libs[r].bs_probe_se_cluster() != r:
                raise AssertionError(f"the build for R = {r} reports "
                                     f"{libs[r].bs_probe_se_cluster()}")
            for xi, wi in ((x, w), (xl, wl)):
                got, again = pk.se(xi, wi), pk.se(xi, wi)
                err = float((got - pk.se_plain(xi, wi)).abs().max())
                ok = err <= TOL and torch.equal(got, again)
                bad += not ok
                print(f"R {r} {tuple(xi.shape)}: ok={ok} (vs plain {err:.3g}, two runs "
                      f"{'bit-identical' if torch.equal(got, again) else 'differ'})")
        for turn, r in enumerate(SIZES + SIZES[::-1]):
            _build._Lib.handle = libs[r]
            warm = device_ms(lambda: pk.se(x, w)) * 1e3
            cold = device_ms(lambda: pk.se(x, w), cold=SE_KERNEL) * 1e3
            print(f"turn {turn} R {r}: device us a launch at (16, 3840), warm {warm:.3f}, "
                  f"cold {cold:.3f}")
        _build._Lib.handle = None
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
