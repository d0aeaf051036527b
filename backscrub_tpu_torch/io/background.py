"""Background source: image / video / URL, with real-time-paced looping
(counterpart of ``backscrub_tpu/io/background.py``).

Python port of the reference background layer (app/background.cc):

- auto-detects still vs video by attempting two frame reads
  (background.cc:142-163);
- videos get a paced reader thread replaying at native FPS using absolute
  deadlines (sleep-until, background.cc:82-90) and looping by seeking frame
  0 at EOF (background.cc:92-100);
- callers fetch the latest frame resized to their geometry on demand under a
  lock (grab_background, background.cc:178-194), and a 160-wide debug
  thumbnail with FPS overlay (grab_thumbnail, background.cc:63-80, :196).

OpenCV is imported when a source is opened, not with this module.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

import numpy as np


class BackgroundSource:
    def __init__(self, path: str, debug: int = 0):
        try:
            import cv2
        except ImportError:
            raise RuntimeError("OpenCV required for background sources") from None
        self._cv2 = cv2
        self.path = path
        self.debug = debug
        self.video = False
        self.fps = 25.0
        self.frame_count = 0
        self._raw: Optional[np.ndarray] = None
        self._thumb: Optional[np.ndarray] = None
        self._lock = threading.Lock()
        self._thumb_lock = threading.Lock()
        self._run = False
        self._thread: Optional[threading.Thread] = None
        self._cap = None
        self._open()

    def _open(self):
        cv2 = self._cv2
        cap = cv2.VideoCapture(self.path)
        if not cap.isOpened():
            raise FileNotFoundError(f"cannot open background source {self.path!r}")
        ok1, f1 = cap.read()
        ok2, f2 = cap.read()  # videos yield a 2nd frame, stills don't
        if not ok1:
            cap.release()
            raise FileNotFoundError(f"cannot read background source {self.path!r}")
        if ok2:
            self.video = True
            fps = cap.get(cv2.CAP_PROP_FPS)
            self.fps = fps if fps and fps > 0 else 25.0
            cap.set(cv2.CAP_PROP_POS_FRAMES, 0)
            self._cap = cap
            self._raw = f1
            self._run = True
            self._thread = threading.Thread(target=self._read_loop, daemon=True,
                                            name="background-reader")
            self._thread.start()
        else:
            cap.release()
            self._raw = f1

    def _read_loop(self):
        if self.debug:
            print("background: thread start")
        last = time.monotonic()
        next_t = last
        while self._run:
            ok, grab = self._cap.read()
            if ok:
                with self._lock:
                    self._raw = grab
                    self.frame_count += 1
                now = time.monotonic()
                if self.debug > 1:
                    self._make_thumb(grab, 1.0 / max(now - last, 1e-9))
                last = now
                next_t += 1.0 / self.fps
                while now < next_t and self._run:
                    time.sleep(min(next_t - now, 0.1))
                    now = time.monotonic()
            else:
                # EOF: loop if we made progress, else stop (background.cc:92-100)
                if self.frame_count > 0 and self._cap.set(self._cv2.CAP_PROP_POS_FRAMES, 0):
                    with self._lock:
                        self.frame_count = 0
                else:
                    if self.debug:
                        print("background: end of stream, not resettable")
                    break
        if self.debug:
            print("background: thread stop")

    def _make_thumb(self, frame, fps: float):
        cv2 = self._cv2
        th = frame.shape[0] * 160 // frame.shape[1]
        thumb = cv2.resize(frame, (160, th))
        cv2.putText(thumb, f"FPS:{fps:0.1f}", (5, 15), cv2.FONT_HERSHEY_PLAIN,
                    1.0, (0, 255, 255))
        cv2.putText(thumb, f"FRM:{self.frame_count:05d}", (5, 30),
                    cv2.FONT_HERSHEY_PLAIN, 1.0, (0, 255, 255))
        cv2.putText(thumb, "Background", (5, th - 5), cv2.FONT_HERSHEY_PLAIN,
                    1.0, (0, 255, 255))
        with self._thumb_lock:
            self._thumb = thumb

    def grab(self, width: int, height: int) -> np.ndarray:
        """Latest frame resized to (height, width) BGR u8."""
        with self._lock:
            raw = self._raw
        if raw is None:
            raise RuntimeError("no background frame available")
        if raw.shape[1] != width or raw.shape[0] != height:
            return self._cv2.resize(raw, (width, height),
                                    interpolation=self._cv2.INTER_LINEAR)
        return raw.copy()

    def thumbnail(self) -> Optional[np.ndarray]:
        with self._thumb_lock:
            return None if self._thumb is None else self._thumb.copy()

    def close(self):
        self._run = False
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
        if self._cap is not None:
            self._cap.release()
            self._cap = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def load_background(path: str, debug: int = 0) -> Optional[BackgroundSource]:
    """load_background equivalent (app/background.h:14): None on failure, so
    the app can fall back to the green screen (app/deepseg.cc:596-603)."""
    try:
        return BackgroundSource(path, debug=debug)
    except Exception as e:
        if debug:
            print(f"background: load failed: {e}")
        return None
