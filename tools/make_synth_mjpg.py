"""Write the MJPG fixtures that hold the port's JPEG decode and encode to
OpenCV on a machine without OpenCV (the card's).

Usage, from the repository root (needs OpenCV)::

    PYTHONPATH=. python tools/make_synth_mjpg.py [tests/data]

Writes three files into the directory (default ``tests/data``):

- ``mjpg_synth_640x480.mjpg``: the first ``FRAMES`` frames of the
  headless test pattern (``backscrub_tpu_torch.io.streams.SyntheticSource``,
  the ``-c test:`` camera) at 640x480, each ``cv2.imencode`` at quality 90
  with OpenCV's default 4:2:0 sampling, concatenated (an MJPEG stream, as
  the ``-c mjpg:`` camera makes it);
- ``mjpg_samplings_64x48.mjpg``: one seeded 64x48 image a sampling the
  decode takes besides 4:2:0 (4:2:2, 4:4:4, 4:4:0, 4:1:1) and one
  grayscale image, at quality 75;
- ``mjpg_synth.json``: where each JPEG of the two streams starts and ends,
  the sha256 of its ``cv2.imdecode``, and the sha256 of ``cv2.imencode`` at
  quality 85 (optimize off) for seeded BGR inputs (``encode_input``) at
  4:2:0, 4:2:2 and 4:4:4, a frame size and an odd one.

The JSON's ``decoded_sha256`` bind the decode to libjpeg-turbo's bytes,
its ``sha256`` under ``encodes`` the encoder with the host Huffman packer.
"""

from __future__ import annotations

import hashlib
import json
import os
import sys

import numpy as np

FRAMES = 3
STREAM = "mjpg_synth_640x480.mjpg"
SAMPLINGS = "mjpg_samplings_64x48.mjpg"
JSON = "mjpg_synth.json"
ENCODES = ((640, 480, 1), (131, 97, 2))   # (width, height, seed) of each encode input
ENC_QUALITY = 85


def encode_input(width: int, height: int, seed: int) -> np.ndarray:
    """The encoder's seeded (height, width, 3) BGR u8 input: noise over a
    gradient, numpy only, so the card rebuilds it without OpenCV."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:height, 0:width]
    base = np.stack([xx * 255 // max(width - 1, 1), yy * 255 // max(height - 1, 1),
                     (xx + yy) % 256], axis=-1)
    noise = rng.integers(-40, 41, (height, width, 3))
    return np.clip(base + noise, 0, 255).astype(np.uint8)


def split(data: bytes, frames):
    """The JPEGs of a stream by the JSON's offsets."""
    return [data[f["offset"]:f["offset"] + f["length"]] for f in frames]


def _smooth(h: int, w: int, seed: int) -> np.ndarray:
    import cv2
    img = np.random.default_rng(seed).integers(0, 256, (h, w, 3), np.uint8)
    return cv2.GaussianBlur(img, (7, 7), 0)


def main(out_dir: str = os.path.join("tests", "data")) -> int:
    import cv2
    from backscrub_tpu_torch.io.streams import SyntheticSource

    def sha(b) -> str:
        return hashlib.sha256(np.ascontiguousarray(b).tobytes()).hexdigest()

    meta = {"source": "tools/make_synth_mjpg.py", "frames": {}, "encodes": []}
    src = SyntheticSource(640, 480)
    jpegs = []
    for _ in range(FRAMES):
        ok, enc = cv2.imencode(".jpg", src.read(), [cv2.IMWRITE_JPEG_QUALITY, 90])
        jpegs.append((enc.tobytes(), "420"))
    small = []
    for i, s in enumerate(("422", "444", "440", "411")):
        sf = getattr(cv2, f"IMWRITE_JPEG_SAMPLING_FACTOR_{s}")
        ok, enc = cv2.imencode(".jpg", _smooth(48, 64, i), [cv2.IMWRITE_JPEG_QUALITY, 75,
                                                            cv2.IMWRITE_JPEG_SAMPLING_FACTOR, sf])
        small.append((enc.tobytes(), s))
    gray = cv2.cvtColor(_smooth(48, 64, 9), cv2.COLOR_BGR2GRAY)
    ok, enc = cv2.imencode(".jpg", gray, [cv2.IMWRITE_JPEG_QUALITY, 75])
    small.append((enc.tobytes(), "gray"))
    for name, items in ((STREAM, jpegs), (SAMPLINGS, small)):
        frames, off = [], 0
        for b, s in items:
            dec = cv2.imdecode(np.frombuffer(b, np.uint8), cv2.IMREAD_COLOR)
            frames.append({"offset": off, "length": len(b), "sampling": s,
                           "width": dec.shape[1], "height": dec.shape[0],
                           "decoded_sha256": sha(dec)})
            off += len(b)
        with open(os.path.join(out_dir, name), "wb") as f:
            f.write(b"".join(b for b, _ in items))
        meta["frames"][name] = frames
    for w, h, seed in ENCODES:
        img = encode_input(w, h, seed)
        for s in ("420", "422", "444"):
            sf = getattr(cv2, f"IMWRITE_JPEG_SAMPLING_FACTOR_{s}")
            ok, enc = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, ENC_QUALITY,
                                                 cv2.IMWRITE_JPEG_SAMPLING_FACTOR, sf])
            meta["encodes"].append({"width": w, "height": h, "seed": seed, "sampling": s,
                                    "quality": ENC_QUALITY, "length": int(enc.size),
                                    "sha256": sha(enc)})
    with open(os.path.join(out_dir, JSON), "w") as f:
        json.dump(meta, f, indent=1)
        f.write("\n")
    return 0


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:]))
