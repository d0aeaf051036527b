"""Time ``MultiStreamServer``'s fps per card in this checkout against
another one (an earlier commit, unpacked with ``git archive``) on one
CUDA card, in turns.

Each turn is a subprocess that puts one checkout's ``backscrub_tpu_torch``
first on the path (its ``_build.py`` builds its library into its own
``_build/``) and runs this checkout's ``chip_smoke.multistream_servers``:
mlkit fused YUYV at 640x480, S streams of ``chip_smoke.py``'s moving
sequences, the deliveries checked byte-identical to direct steps, then
the fps per card over five windows of at least 2 s (median and range),
ms a tick, and a profiled window's host ms, device busy and idle share a
tick.  The turns run the other checkout, this, this, the other, the
other, this.  Prints one JSON line a turn and, per S, each tree's fps
medians.

Usage (from the repository root, on a machine with a CUDA card)::

    python tools/multistream_fps_vs_build.py OTHER_CHECKOUT [S ...]

S defaults to 4 and 8.
"""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TURNS = ("other", "this", "this", "other", "other", "this")

# run in a turn: argv = checkout, this checkout's root, the stream counts
_TURN = """
import importlib.util, json, sys
sys.path.insert(0, sys.argv[1]); sys.path.insert(1, sys.argv[2] + "/tools")
spec = importlib.util.spec_from_file_location("chip_smoke", sys.argv[2] + "/chip_smoke.py")
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
from backscrub_tpu_torch import _build
_build.lib()
cs.MS_FPS_STREAMS = tuple(int(s) for s in sys.argv[3].split(","))
frames = cs._stream_frames(*cs.MS_SIZE, max(cs.MS_FPS_STREAMS), cs.MS_TICKS)
res = cs.multistream_servers(frames)
print("TURN " + json.dumps({f"S={S}": {k: r[k] for k in (
    "fps", "fps_min", "fps_max", "ms_per_tick", "window_ms_per_tick", "busy_ms_per_tick",
    "idle_share")} for S, r in res.items()}))
"""


def main(argv) -> int:
    if not argv:
        print(__doc__)
        return 2
    other = os.path.abspath(argv[0])
    streams = ",".join(argv[1:]) or "4,8"
    trees = {"this": REPO, "other": other}
    # build both libraries at once (one nvcc per source in each)
    builds = [subprocess.Popen([sys.executable, "-c",
                                "from backscrub_tpu_torch import _build; _build.lib()"],
                               cwd=path) for path in trees.values()]
    if any(p.wait() for p in builds):
        raise SystemExit("a kernel build failed")
    fps = {}
    for tree in TURNS:
        out = subprocess.run([sys.executable, "-c", _TURN, trees[tree], REPO, streams],
                             capture_output=True, text=True, check=True, cwd=trees[tree])
        line = [ln for ln in out.stdout.splitlines() if ln.startswith("TURN ")][-1]
        turn = json.loads(line[5:])
        print(json.dumps({"tree": tree, **turn}))
        for s, r in turn.items():
            fps.setdefault(s, {}).setdefault(tree, []).append(r["fps"])
    for s, by_tree in fps.items():
        print(f"{s}: " + "; ".join(
            f"{tree} fps {sorted(v)} (median {sorted(v)[len(v) // 2]:.2f})"
            for tree, v in by_tree.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
