"""Time K1 (``csrc/front.cu``) at each tile of ``FRONT_TILES`` on one CUDA
card: the segm front (96x160 canvas -> 16x48x80) and the deeplab front
(257x257 -> 16x129x129) of the committed synthetic models, on
``chip_smoke.py``'s first frame at 640x480.

Each tile, forced in place of ``front_tile``'s choice, is held against
``front_plain`` (allclose(atol=2e-3, rtol=1e-3)) and against the bits of
that choice (the 27-tap chain does not depend on the tile), then timed by
the profiler's kernel time a launch (``chip_smoke.device_ms``, warm: the
working set fits in the 50 MB L2) in ``--passes`` interleaved passes.
The table gives each pass and marks ``front_tile``'s choice.  Exits 1 if
a tile is off.

Usage (from the repository root, on a machine with a CUDA card)::

    python tools/sweep_front_tiles.py [--passes 2]
"""

import argparse
import contextlib
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@contextlib.contextmanager
def forced_tile(edge, tile):
    """``edge.front_fused`` launching ``tile`` while in the block."""
    own = edge.front_tile
    edge.front_tile = lambda oh, ow, sms: tile
    try:
        yield
    finally:
        edge.front_tile = own


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--passes", type=int, default=2)
    a = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("sweep_front_tiles: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    sys.path.insert(0, os.path.join(REPO, "tools"))
    from chip_smoke import DEEPLAB, MODEL, device_ms
    from backscrub_tpu_torch import _build
    from backscrub_tpu_torch.pipeline import edge
    from backscrub_tpu_torch.pipeline.frame import FramePipeline, PipelineConfig
    from make_synth_segm import moving_frames

    sms = _build.sm_count(torch.device("cuda", 0))
    print(f"{torch.cuda.get_device_name(0)}, {sms} SMs; device us a launch "
          f"(profiler, warm), {a.passes} passes")
    bad = []
    with torch.no_grad():
        frame = torch.from_numpy(moving_frames(640, 480, 1)[0]).cuda()
        for name, path in (("segm", MODEL), ("deeplab", DEEPLAB)):
            e = FramePipeline(path, PipelineConfig(width=640, height=480),
                              device="cuda").maskgen.edge
            canvas, kw, par = e.canvas(frame), e.front_kwargs(), e.front_params
            ref, own = edge.front_plain(canvas, par, **kw), edge.front_fused(canvas, par, **kw)
            cout, oh, ow = ref.shape
            times = {}
            for tile in edge.FRONT_TILES:
                with forced_tile(edge, tile):
                    got = edge.front_fused(canvas, par, **kw)
                torch.cuda.synchronize()
                if not torch.allclose(got, ref, atol=2e-3, rtol=1e-3) \
                        or not torch.equal(got, own):
                    bad.append(f"front {name} tile {tile}: "
                               f"{float((got - ref).abs().max()):.3g} from plain, "
                               f"{int((got != own).sum())} values off front_tile's")
            for _ in range(a.passes):
                for tile in edge.FRONT_TILES:
                    with forced_tile(edge, tile):
                        times.setdefault(tile, []).append(1e3 * device_ms(
                            lambda: edge.front_fused(canvas, par, **kw)))
            chosen = edge.front_tile(oh, ow, sms)
            for (th, tw, g), us in times.items():
                ctas = -(-oh // th) * -(-ow // tw)
                threads = -(-max(th * tw * g, (2 * th + 1) * (2 * tw + 1)) // 32) * 32
                print(f"front {name} {cout}x{oh}x{ow} tile {th}x{tw}x{g}: {ctas} CTAs of "
                      f"{threads} threads, " + " / ".join(f"{x:.3f}" for x in us)
                      + " us" + ("  <- front_tile" if (th, tw, g) == chosen else ""))
    for line in bad:
        print("OFF: " + line)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
