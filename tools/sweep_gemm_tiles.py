"""Time the K2'' GEMM (``bs_gemm``) at every tile and split-K choice, at
each 1x1 shape of the deeplab frame, on one CUDA card.

For each (co, ci) at L = 33 * 33 prints the six fastest (tile, split)
choices by device time (the torch.profiler's kernel time, mean of 50
calls; the split-K sum kernel included), each checked against
``conv1x1_bf16x3_plain`` (1e-5 relative), beside what ``gemm_config``
picks.  The data behind ``gemm_config``'s rule.

Usage (from the repository root, on a machine with a CUDA card)::

    python tools/sweep_gemm_tiles.py
"""

import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = [(16, 96), (21, 256), (32, 96), (32, 192), (48, 192), (48, 288), (80, 288),
          (80, 480), (96, 16), (160, 480), (192, 32), (256, 160), (256, 512), (288, 48),
          (480, 80)]
L = 33 * 33


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("sweep_gemm_tiles: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from backscrub_tpu_torch import _build
    from backscrub_tpu_torch.ops import megakernel as mk
    from chip_smoke import device_ms
    torch.backends.cuda.matmul.allow_tf32 = False
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"{torch.cuda.get_device_name(0)}, {sms} SMs")
    for co, ci in SHAPES:
        rng = np.random.default_rng(co * 1000 + ci)
        w, x = (torch.from_numpy((rng.standard_normal(s) / np.sqrt(ci)).astype(np.float32))
                .cuda() for s in ((co, ci), (ci, L)))
        b = torch.from_numpy(rng.standard_normal(co).astype(np.float32)).cuda()
        hi, lo = mk.split_bf16(w)
        kp, slices = hi.shape[1], -(-hi.shape[1] // 16)
        y = torch.empty((co, L), device="cuda")
        ref = mk.conv1x1_bf16x3_plain(w, b, x)
        res = []
        for tile, (bm, bn) in enumerate(mk._GEMM_TILES):
            for want in (1, 2, 4, 8):
                if want > slices:
                    continue
                n16 = -(-slices // want)
                split = -(-slices // n16)
                part = torch.empty(split * co * L, device="cuda")

                def run():
                    _build.launch("bs_gemm", hi.data_ptr(), lo.data_ptr(), None, b.data_ptr(),
                                  x.data_ptr(), y.data_ptr(), part.data_ptr(), co, ci, kp, L,
                                  0, tile, split, 16 * n16, 3)
                run()
                torch.cuda.synchronize()
                ok = float((y - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
                res.append((device_ms(run, n=50) * 1e3, tile, split,
                            -(-co // bm) * -(-L // bn) * split, ok))
        res.sort()
        print(f"{co}x{ci}: gemm_config {mk.gemm_config(co, ci, L, sms)}; fastest " + "; ".join(
            f"tile {t} split {s} ({n} CTAs) {us:.2f} us{'' if ok else ' WRONG'}"
            for us, t, s, n, ok in res[:6]))
        if not all(r[4] for r in res):
            raise AssertionError(f"{co}x{ci}: a choice disagrees with the bf16x3 plain version")
    return 0


if __name__ == "__main__":
    sys.exit(main())
