"""Atomic JSON artifact writes (counterpart of
``backscrub_tpu/utils/artifacts.py``).

A killed process never leaves a truncated record where a complete older
one could stand: the whole object is converted and serialized first, then
written to ``<path>.partial`` in the same directory, flushed, fsynced and
renamed over ``path``.  The reference converts while it dumps, so a
multi-element array raises halfway through the file (ROADMAP queue 3);
here such a value raises before anything is written.
"""

from __future__ import annotations

import json
import os


def jsonable(obj):
    """``obj`` with numpy and torch scalars (zero-dimensional values) as
    Python scalars and tuples as lists, in dicts and lists at any depth.
    Raises TypeError for any other value json cannot write, a
    multi-element array included."""
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    if isinstance(obj, dict):
        return {jsonable(k): jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [jsonable(v) for v in obj]
    shape = getattr(obj, "shape", None)
    if shape is not None and tuple(shape) == () and callable(getattr(obj, "item", None)):
        return jsonable(obj.item())
    if shape is not None:
        raise TypeError(f"not JSON serializable: a {type(obj).__name__} of shape "
                        f"{tuple(shape)} (pass a list or a scalar)")
    raise TypeError(f"not JSON serializable: {type(obj).__name__}")


def atomic_json_dump(obj, path, indent: int = 1) -> None:
    """Write ``obj`` as JSON to ``path`` atomically (see the module
    docstring)."""
    text = json.dumps(jsonable(obj), indent=indent)
    tmp = f"{path}.partial"
    with open(tmp, "w") as fh:
        fh.write(text)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)
