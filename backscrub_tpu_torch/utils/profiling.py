"""Profiling: device traces, named regions and wall-clock scopes
(counterpart of ``backscrub_tpu/utils/profiling.py``).

The reference's observability seam is per-stage callbacks
(``lib/libbackscrub.h:24-30``); inside a frame the breakdown comes from a
device trace: ``with device_trace(dir):`` records a ``torch.profiler``
trace (the host's operations and, on the card, its kernels and copies)
and writes it as a Chrome trace, viewable in Perfetto or
``chrome://tracing``; ``annotate(name)`` names a region in it.
``utils/timing.py`` covers the host-visible stages.
"""

from __future__ import annotations

import contextlib
import os
import time


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Trace everything inside the block with ``torch.profiler`` (CPU
    activity, and CUDA activity where the card is there) and write
    ``<log_dir>/trace_<pid>_<n>.json``; yields the profiler, whose
    ``key_averages()`` hold the same events.  The file's path is the
    profiler's ``trace_path`` attribute once the block ends."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    os.makedirs(log_dir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    n = len([f for f in os.listdir(log_dir) if f.startswith(f"trace_{os.getpid()}_")])
    path = os.path.join(log_dir, f"trace_{os.getpid()}_{n}.json")
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(path)
    prof.trace_path = path


@contextlib.contextmanager
def wall_timer(label: str, out: dict | None = None):
    """A labelled wall-clock scope; records seconds into ``out`` if given."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        if out is not None:
            out[label] = dt


def annotate(name: str):
    """A named region in device traces (``torch.profiler.record_function``)."""
    from torch.profiler import record_function
    return record_function(name)
