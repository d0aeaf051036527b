"""Debug HUD: picture-in-picture composition + keyboard toggle handling
(counterpart of ``backscrub_tpu/utils/debug_ui.py``).

Mirrors the reference debug window (app/deepseg.cc:724-803): FPS/geometry
status line at the bottom, keyboard help overlay, background thumbnail
pic-in-pic top-left, mask pic-in-pic top-right, and the keyboard map
q/s/h/v/f/b/m/?.  Pure composition function (testable headless) + a thin
cv2 window wrapper; OpenCV is imported only by the functions that draw.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

HELP_LINES = [
    "Keyboard help:",
    " q: quit",
    " s: switch filter on/off",
    " h: toggle horizontal flip",
    " v: toggle vertical flip",
    " f: toggle FPS display on/off",
    " b: toggle background display on/off",
    " m: toggle mask display on/off",
    " ?: toggle this help text on/off",
]


@dataclasses.dataclass
class DebugState:
    filter_active: bool = True
    flip_horizontal: bool = False
    flip_vertical: bool = False
    show_fps: bool = True
    show_background: bool = True
    show_mask: bool = True
    show_help: bool = False
    running: bool = True

    def handle_key(self, key: int) -> None:
        """Keyboard map from app/deepseg.cc:779-803."""
        c = chr(key & 0xFF) if key >= 0 else ""
        if c == "q":
            self.running = False
        elif c == "s":
            self.filter_active = not self.filter_active
        elif c == "h":
            self.flip_horizontal = not self.flip_horizontal
        elif c == "v":
            self.flip_vertical = not self.flip_vertical
        elif c == "f":
            self.show_fps = not self.show_fps
        elif c == "b":
            self.show_background = not self.show_background
        elif c == "m":
            self.show_mask = not self.show_mask
        elif c == "?":
            self.show_help = not self.show_help


def compose_debug_view(out_bgr: np.ndarray, state: DebugState,
                       mask: Optional[np.ndarray] = None,
                       bg_thumb: Optional[np.ndarray] = None,
                       main_fps: float = 0.0, ai_fps: float = 0.0,
                       cap_geo=(0, 0), vid_geo=(0, 0)) -> np.ndarray:
    """Compose the debug frame (app/deepseg.cc:723-776)."""
    import cv2
    view = out_bgr.copy()
    h, w = view.shape[:2]
    if state.show_fps:
        status = (f"MainFPS: {main_fps:5.2f} AiFPS: {ai_fps:5.2f} "
                  f"({cap_geo[0]}x{cap_geo[1]}->{vid_geo[0]}x{vid_geo[1]})")
        cv2.putText(view, status, (5, h - 5), cv2.FONT_HERSHEY_PLAIN, 1.0,
                    (0, 255, 255))
    if state.show_help:
        for i, line in enumerate(HELP_LINES):
            cv2.putText(view, line, (10, h // 2 + i * 15),
                        cv2.FONT_HERSHEY_PLAIN, 1.0, (0, 255, 255))
    if state.show_background and bg_thumb is not None:
        th, tw = bg_thumb.shape[:2]
        if th <= h and tw <= w:
            view[0:th, 0:tw] = bg_thumb
            cv2.rectangle(view, (0, 0), (tw, th), (255, 255, 255))
    if state.show_mask and mask is not None:
        mh = mask.shape[0] * 160 // mask.shape[1]
        smask = cv2.resize(mask, (160, mh))
        cmask = cv2.cvtColor(smask, cv2.COLOR_GRAY2BGR)
        x0 = w - 160
        if mh <= h:
            view[0:mh, x0:w] = cmask
            cv2.rectangle(view, (x0, 0), (w - 1, mh), (255, 255, 255))
            cv2.putText(view, "Mask", (x0 + 5, 115), cv2.FONT_HERSHEY_PLAIN,
                        1.0, (0, 255, 255))
    return view


class DebugWindow:
    """cv2 window wrapper; no-op when no display is available."""

    NAME = "backscrub-tpu"

    def __init__(self):
        import os
        import sys
        import cv2
        self._cv2 = cv2
        self.available = True
        # Probe in layers: some headless cv2 builds don't raise from
        # namedWindow, so an exception is not a reliable signal.
        # 1. no display server reachable at all -> headless
        if (os.name == "posix" and sys.platform != "darwin"
                and not os.environ.get("DISPLAY")
                and not os.environ.get("WAYLAND_DISPLAY")):
            self.available = False
            return
        # 2. window creation raising (GUI-less builds) -> headless
        try:
            cv2.namedWindow(self.NAME, cv2.WINDOW_AUTOSIZE)
        except Exception:
            self.available = False

    def show(self, view: np.ndarray, state: DebugState) -> None:
        if not self.available:
            return
        # 3. builds that create the window but fail at imshow/waitKey:
        # degrade to headless on first failure instead of crashing the
        # serve loop
        try:
            self._cv2.imshow(self.NAME, view)
            key = self._cv2.waitKey(1)
        except Exception:
            import sys
            print("debug: display went away, HUD disabled", file=sys.stderr)
            self.available = False
            return
        if key >= 0:
            state.handle_key(key)

    def close(self):
        if self.available:
            try:
                self._cv2.destroyWindow(self.NAME)
            except Exception:
                pass
