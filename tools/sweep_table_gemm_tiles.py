"""Time each GEMM op of the deeplab continuation's op table at every table
tile, on one CUDA card.

The table's GEMM ops (``bs_body_mega``'s OP_GEMM) pick their tile from
``_MEGA_GEMM_TILES`` by ``_gemm_tile``.  For every GEMM op this sets each
tile in turn in the table on the card and reads the op's phase by the
device clock (``BodyPlan.phase_ns``, the median of ``--runs`` measurement
runs of the whole table), the other ops at their own tiles; then prints,
per op, each tile's microseconds and CTAs beside ``_gemm_tile``'s choice.
The data behind ``_gemm_tile``'s rule, for the three-term table (at
"high"; the one- and six-term tables' wgmma tile has its weights laid out
for its width when the table is compiled, and
``tools/sweep_gemm_tiles.py --terms 1|6`` sweeps its widths).

Usage (from the repository root, on a machine with a CUDA card)::

    python tools/sweep_table_gemm_tiles.py [--runs 9]
"""

import argparse
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEEPLAB = os.path.join(REPO, "tests", "data", "deeplab_synth_257.tflite")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", type=int, default=9)
    a = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("sweep_table_gemm_tiles: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    sys.path.insert(0, os.path.join(REPO, "tools"))
    from backscrub_tpu_torch.ops import megakernel as mk
    from backscrub_tpu_torch.pipeline.frame import FramePipeline, PipelineConfig
    from make_synth_segm import moving_frames

    pipe = FramePipeline(DEEPLAB, PipelineConfig(width=640, height=480), device="cuda",
                         precision="high")
    e = pipe.maskgen.edge
    frame = torch.from_numpy(moving_frames(640, 480, 1)[0]).cuda()
    with torch.no_grad():
        x = e.prefix_plan(e.front(frame).reshape(16, -1))
    plan, mt = e.cont_plan, e.cont_plan.mega
    f_tile = mk.MEGA_FIELDS.index("tile")
    table = mt.on(x.device)[1]
    own_smem = mt.smem_bytes
    mt.smem_bytes = max(own_smem, mt.table.nbytes + max(mk._gemm_ring_bytes(*t)
                                                        for t in mk._MEGA_GEMM_TILES))
    print(f"{torch.cuda.get_device_name(0)}; deeplab continuation ({mt.dots}), {len(mt.ops)} "
          f"table ops in {mt.phases} phases, median of {a.runs} runs")
    try:
        with torch.no_grad():
            for i, m in enumerate(mt.ops):
                if m["kind"] != "gemm":
                    continue
                own = int(mt.table[i, f_tile])
                co, L = plan.weights[m["w"]].shape[0], plan.meta[m["src"]].rows * plan.meta[
                    m["src"]].w
                cells = []
                for tile, (bm, bn) in enumerate(mk._MEGA_GEMM_TILES):
                    table[i, f_tile] = tile
                    ns = np.median([plan.phase_ns(x)[m["level"] - 1] for _ in range(a.runs)])
                    cells.append(f"{bm}x{bn} ({-(-co // bm) * -(-L // bn)} CTAs) "
                                 f"{ns / 1e3:.2f} us{' *' if tile == own else ''}")
                table[i, f_tile] = own
                print(f"op {i} gemm {plan.meta[m['src']].c}->{co}"
                      f"{'+res' if m['res'] is not None else ''}: " + "; ".join(cells))
    finally:
        mt.smem_bytes = own_smem
    return 0


if __name__ == "__main__":
    sys.exit(main())
