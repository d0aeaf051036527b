"""Per-frame stage timing, mirroring the reference telemetry (counterpart
of ``backscrub_tpu/utils/timing.py``).

The reference stamps nanosecond timestamps at every main-loop stage and
prints a one-line breakdown `grab/retr/copy/prep/mask/post/v4l2 + FPS`
(app/deepseg.cc:137-156, :630-719).  Here the host-visible stages are:
grab (source read), upload, dispatch (the device step's launches),
fetch (result readback), sink (v4l2/file write).  For the device side of
a dispatch use ``torch.profiler``.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Dict


class StageTimer:
    """Accumulates per-stage wall time over a sliding window of frames."""

    STAGES = ("grab", "upload", "dispatch", "fetch", "sink")

    def __init__(self, window: int = 120):
        self._window = window
        self._hist: Dict[str, deque] = {s: deque(maxlen=window) for s in self.STAGES}
        self._frame_times: deque = deque(maxlen=window)
        self._t0 = None
        self._last_frame = None

    def start(self):
        self._t0 = time.perf_counter_ns()

    def mark(self, stage: str):
        now = time.perf_counter_ns()
        self._hist[stage].append(now - self._t0)
        self._t0 = now

    def frame_done(self):
        now = time.perf_counter_ns()
        if self._last_frame is not None:
            self._frame_times.append(now - self._last_frame)
        self._last_frame = now

    @property
    def fps(self) -> float:
        if not self._frame_times:
            return 0.0
        return 1e9 * len(self._frame_times) / sum(self._frame_times)

    def stage_fps(self, *stages: str) -> float:
        """Rate the given stage(s) alone could sustain (1 / mean stage time).

        The reference reports a decoupled "AI FPS" next to the main-loop FPS
        (app/deepseg.cc:702-719) because the inference thread runs at its own
        rate; here the analogous figure is the model-step rate
        (dispatch[+fetch]) independent of grab/sink time.
        """
        total, n = 0, 0
        for s in stages:
            h = self._hist[s]
            total += sum(h)
            n = max(n, len(h))
        if n == 0 or total == 0:
            return 0.0
        return 1e9 * n / total

    def means_ms(self) -> Dict[str, float]:
        return {s: (sum(h) / len(h) / 1e6 if h else 0.0)
                for s, h in self._hist.items()}

    def report_line(self) -> str:
        m = self.means_ms()
        stages = " ".join(f"{s}:{m[s]:.2f}ms" for s in self.STAGES if m[s] > 0)
        line = f"{stages} FPS:{self.fps:.1f}"
        ai = self.stage_fps("dispatch")
        if ai > 0:
            line += f" AiFPS:{ai:.1f}"
        return line

    def report_dict(self) -> Dict[str, float]:
        """Machine-readable snapshot (CLI --stats-json): per-stage mean ms
        over the window plus the windowed FPS (+ decoupled model-step rate)."""
        out = {f"{s}_ms": round(v, 4) for s, v in self.means_ms().items() if v > 0}
        out["fps"] = round(self.fps, 2)
        ai = self.stage_fps("dispatch")
        if ai > 0:
            out["ai_fps"] = round(ai, 2)
        return out
