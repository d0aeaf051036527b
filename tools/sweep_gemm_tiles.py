"""Time the K2'' GEMM (``bs_gemm``) at every tile and split-K choice, at
each 1x1 shape of the deeplab frame, on one CUDA card.

For each (co, ci) at L = 33 * 33 prints the six fastest (tile, split)
choices by device time (the torch.profiler's kernel time, mean of 50
calls; the split-K sum kernel included), each checked against its plain
twin (1e-5 relative), beside what ``gemm_config`` picks.  The data behind
``gemm_config``'s rule: the wgmma tile at each width of ``_WG_TILES`` and
split K into 1, 2, 4 or 8 ranges of whole 64-deep slices, at ``--terms 3``
(the default, the bf16x3 split, against ``conv1x1_bf16x3_plain``), ``1``
(``conv1x1_bf16_plain``) or ``6`` (``conv1x1_bf16x6_plain``).

Usage (from the repository root, on a machine with a CUDA card)::

    python tools/sweep_gemm_tiles.py [--terms 3|1|6]
"""

import argparse
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = [(16, 96), (21, 256), (32, 96), (32, 192), (48, 192), (48, 288), (80, 288),
          (80, 480), (96, 16), (160, 480), (192, 32), (256, 160), (256, 512), (288, 48),
          (480, 80)]
L = 33 * 33


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--terms", type=int, default=3, choices=(1, 3, 6))
    terms = ap.parse_args(argv).terms
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
    print(f"{torch.cuda.get_device_name(0)}, {sms} SMs, {terms} terms")
    for co, ci in SHAPES:
        rng = np.random.default_rng(co * 1000 + ci)
        w, x = (torch.from_numpy((rng.standard_normal(s) / np.sqrt(ci)).astype(np.float32))
                .cuda() for s in ((co, ci), (ci, L)))
        b = torch.from_numpy(rng.standard_normal(co).astype(np.float32)).cuda()
        y = torch.empty((co, L), device="cuda")
        res = []
        ref = {1: mk.conv1x1_bf16_plain, 3: mk.conv1x1_bf16x3_plain,
               6: mk.conv1x1_bf16x6_plain}[terms](w, b, x)
        pieces = mk.split_bf16(w, mk.GEMM_PIECES[terms])
        slices = -(-ci // mk._WG_BK)
        for tile, bn in enumerate(mk._WG_TILES):
            blk = mk.lay_wgmma(pieces, bn)      # alive while timed
            for want in (1, 2, 4, 8):
                if want > slices:
                    continue
                per = -(-slices // want)
                split = -(-slices // per)
                part = torch.empty(split * co * L, device="cuda")

                def run():
                    _build.launch("bs_gemm", blk.data_ptr(), b.data_ptr(), x.data_ptr(),
                                  y.data_ptr(), part.data_ptr(), co, ci, L, 0, tile, split,
                                  mk._WG_BK * per, terms)
                run()
                torch.cuda.synchronize()
                ok = float((y - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
                res.append((device_ms(run, n=50) * 1e3, tile, split,
                            -(-co // bn) * -(-L // mk._WG_BM) * split, ok))
        res.sort()
        cfg = mk.gemm_config(co, ci, L, sms, terms)
        print(f"{co}x{ci}: gemm_config {cfg}; fastest " + "; ".join(
            f"tile {t} split {s} ({n} CTAs) {us:.2f} us{'' if ok else ' WRONG'}"
            for us, t, s, n, ok in res[:6]))
        if not all(r[4] for r in res):
            raise AssertionError(f"{co}x{ci}: a choice disagrees with its plain twin")
    return 0


if __name__ == "__main__":
    sys.exit(main())
