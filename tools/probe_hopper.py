#!/usr/bin/env python3
"""The Hopper counterpart of ``tools/probe_mosaic.py``'s ``main()``.

Runs the seven probe kernels P1-P7 (``backscrub_tpu_torch/csrc/probes.cu``,
wrapped in ``backscrub_tpu_torch/ops/probe_kernels.py``) on the
original's seeded inputs (``default_rng(0)``, C, H, W = 16, 48, 80), P3 at
DEFAULT, HIGH (bf16x3, K2''s GEMM; not in the original) and HIGHEST,
checks each against the original's numpy reference at the original's atol
(rtol 1e-4), and times it.  Usage, on a machine with a CUDA card::

    python tools/probe_hopper.py

One line a probe: ``ok``, the kernel's device time, the library call's
(one PyTorch call computing the same function, where there is one) and
the bound (the bytes each input read once and the output written once
over 3.35 TB/s, or the operations over their peak, the larger).  Device
times are the profiler's kernel time a call over 100 back-to-back calls
(``chip_smoke.device_ms``): warm, every working set in L2.  Exits 1 if a
probe is off or without CUDA.  Imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import dataclasses
import functools
import os
import subprocess
import sys
from typing import Callable, List, Optional

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
C, H, W = 16, 48, 80
HW = H * W
SITE = "tools/probe_mosaic.py:"


@dataclasses.dataclass
class Probe:
    """One run of a probe kernel: its wrapper, plain twin and library call
    (None where there is none) as calls on the probe's inputs."""
    name: str                 # the original's run() name
    kernel_id: str            # P1-P7
    site: str                 # the pallas_call it replaces
    kernel: Callable
    plain: Callable
    library: Optional[Callable]
    ref: np.ndarray           # the original's numpy reference
    atol: float               # the original's atol
    exact: bool               # kernel and plain twin agree bit for bit
    counter: Callable         # the wrapper that counts its launches
    nbytes: int
    ops: int                  # f32 operations
    bf16_ops: int = 0         # bf16 operations on the tensor cores


def inputs():
    """The original's arrays, built as its main() builds them: x2 (C, HW),
    x3 (C, H, W), w16 (C, C), the flat input padded by 2W a side, the
    rowpad input ((H + 2) * 128 columns, x3's rows at 128-float strides)."""
    rng = np.random.default_rng(0)
    x2 = rng.random((C, HW), np.float32)
    x3 = rng.random((C, H, W), np.float32)
    w16 = rng.random((C, C), np.float32)
    xpad = np.pad(x2, ((0, 0), (2 * W, 2 * W)))
    xp = np.zeros((C, (H + 2) * 128), np.float32)
    for i in range(H):
        xp[:, (i + 1) * 128:(i + 1) * 128 + W] = x3[:, i, :]
    return dict(x2=x2, x3=x3, w16=w16, xpad=xpad, xp=xp)


def references(a):
    """The original's numpy references, by probe name."""
    xr, xp, x2, w16 = a["xpad"], a["xp"], a["x2"], a["w16"]
    hp = H * 128
    xmn = np.pad(xp[:, 1:], ((0, 0), (0, 1)))
    xpln = np.pad(xp[:, :-1], ((0, 0), (1, 0)))
    mm = x2.mean(1, keepdims=True)
    dot = w16 @ x2
    return {
        "dw_flat_lane_shifts_9tap": sum(
            xr[:, 2 * W + di * W + dj:2 * W + di * W + dj + HW] * (0.1 + di + 2 * dj)
            for di in (-1, 0, 1) for dj in (-1, 0, 1)),
        "dw_padded_rows_9tap": sum(
            s[:, di * 128:di * 128 + hp] * (0.1 + di + 2 * dj)
            for di in (0, 1, 2) for dj, s in ((-1, xpln), (0, xp), (1, xmn))),
        "dot_default": dot, "dot_high": dot, "dot_highest": dot,
        "se_pool_fc_gate": x2 * (1 / (1 + np.exp(-(w16 @ mm)))),
        "sublane_concat": np.concatenate([x2] * 2, 0),
        "lane_stride2": x2[:, 0::2],
        "inkernel_reshape": a["x3"].reshape(C, HW),
    }


def probes(device="cuda") -> List[Probe]:
    """Every probe run on the original's inputs on ``device`` (the card
    unless the caller asks for the CPU, where the wrappers run their plain
    twins)."""
    import torch
    from backscrub_tpu_torch import _build
    from backscrub_tpu_torch.ops import probe_kernels as pk

    dev = _build.resolve_device(device)
    a = inputs()
    ref = references(a)
    t = {k: torch.from_numpy(v).to(dev) for k, v in a.items()}
    x2, x3, w16, xpad, xp = t["x2"], t["x3"], t["w16"], t["xpad"], t["xp"]
    flat_taps, row_taps = pk.dw_taps(C, W, -1, dev), pk.dw_taps(C, pk.ROWPAD, 0, dev)
    wb, xb = w16.to(torch.bfloat16), x2.to(torch.bfloat16)
    f4 = 4
    dot_bytes = f4 * (w16.numel() + 2 * x2.numel())
    mm_ops = 2 * C * C * HW
    out = [
        Probe("dw_flat_lane_shifts_9tap", "P1", SITE + "103",
              lambda: pk.dw_flat(xpad, W), lambda: pk.dw_flat_plain(xpad, W),
              lambda: pk.dw_flat_library(xpad, W, flat_taps),
              ref["dw_flat_lane_shifts_9tap"], 1e-4, True, pk.dw_flat,
              f4 * (xpad.numel() + x2.numel()), 18 * C * HW),
        Probe("dw_padded_rows_9tap", "P2", SITE + "131",
              lambda: pk.dw_rowpad(xp), lambda: pk.dw_rowpad_plain(xp),
              lambda: pk.dw_rowpad_library(xp, row_taps),
              ref["dw_padded_rows_9tap"], 1e-4, True, pk.dw_rowpad,
              f4 * (xp.numel() + C * H * 128), 18 * C * H * 128),
    ]
    # P3 at each precision (HIGH is not in the original: its atol is run()'s
    # default); the library call on bf16 operands for DEFAULT, f32 otherwise
    for prec, atol, passes in (("default", 5e-2, 1), ("high", 1e-4, 3), ("highest", 1e-5, 0)):
        out.append(Probe(
            f"dot_{prec}", "P3", SITE + "140", functools.partial(pk.dot, w16, x2, prec),
            functools.partial(pk.dot_plain, w16, x2, prec),
            functools.partial(torch.matmul, *((wb, xb) if passes == 1 else (w16, x2))),
            ref[f"dot_{prec}"], atol, False, pk.dot, dot_bytes,
            0 if passes else mm_ops, passes * mm_ops))
    # P4 has no library call; P5-P7's plain twins are themselves one call
    out += [
        Probe("se_pool_fc_gate", "P4", SITE + "159", lambda: pk.se(x2, w16),
              lambda: pk.se_plain(x2, w16), None, ref["se_pool_fc_gate"], 1e-3, False,
              pk.se, dot_bytes, 2 * C * HW + 2 * C * C + 4 * C),
        Probe("sublane_concat", "P5", SITE + "166", lambda: pk.concat(x2, x2),
              lambda: pk.concat_plain(x2, x2), lambda: pk.concat_plain(x2, x2),
              ref["sublane_concat"], 1e-4, True, pk.concat, f4 * 4 * x2.numel(), 0),
        Probe("lane_stride2", "P6", SITE + "174", lambda: pk.lane_stride2(x2),
              lambda: pk.lane_stride2_plain(x2), lambda: pk.lane_stride2_plain(x2),
              ref["lane_stride2"], 1e-4, True, pk.lane_stride2,
              f4 * (x2.numel() + x2.numel() // 2), 0),
        Probe("inkernel_reshape", "P7", SITE + "180", lambda: pk.reshape_flat(x3),
              lambda: pk.reshape_flat_plain(x3), lambda: pk.reshape_flat_plain(x3),
              ref["inkernel_reshape"], 1e-4, True, pk.reshape_flat,
              f4 * 2 * x3.numel(), 0),
    ]
    return out


# P1 and P2 beyond the probe shape, for the stencil kernel's two paths:
# name -> (probe, C, columns, P1's row width, the vector path on
# 16-byte-aligned tensors)
STENCIL_SHAPES = {
    "P1 original": ("P1", C, HW + 4 * W, W, True),
    "P2 original": ("P2", C, (H + 2) * 128, None, True),
    "P1 W=81": ("P1", 3, 5 * 81 + 4 * 81, 81, False),
    "P1 W=7": ("P1", 4, 6 * 7 + 4 * 7, 7, False),
    "P1 C=1": ("P1", 1, HW + 4 * W, W, True),
    "P1 ragged warp": ("P1", 3, 5 * 20 + 4 * 20, 20, True),     # 100 outputs a row
    "P2 3x128+5": ("P2", 2, 3 * 128 + 5, None, False),
    "P2 3x128+4": ("P2", 2, 3 * 128 + 4, None, True),           # 132 outputs a row
}
# the kernels' profiler names on each path
STENCIL_KERNELS = {True: "::dw9_kernel", False: "::dw9_scalar_kernel"}


def stencil_cases(device="cuda"):
    """(name, kernel call, plain call, vector path) of P1 and P2 at each of
    STENCIL_SHAPES on seeded inputs, and at the probe shape as a view 4
    bytes off a 16-byte boundary (the scalar path)."""
    import torch
    from backscrub_tpu_torch import _build
    from backscrub_tpu_torch.ops import probe_kernels as pk

    dev = _build.resolve_device(device)
    shapes = dict(STENCIL_SHAPES)
    shapes["P1 original, a view off 16 bytes"] = STENCIL_SHAPES["P1 original"][:4] + (False,)
    out = []
    for seed, (name, (probe, c, n, width, vec)) in enumerate(shapes.items()):
        flat = torch.from_numpy(np.random.default_rng(seed).random(c * n + 1, np.float32))
        flat = flat.to(dev)
        x = (flat[1:] if "view" in name else flat[:-1]).view(c, n)
        if probe == "P1":
            out.append((name, functools.partial(pk.dw_flat, x, width),
                        functools.partial(pk.dw_flat_plain, x, width), vec))
        else:
            out.append((name, functools.partial(pk.dw_rowpad, x),
                        functools.partial(pk.dw_rowpad_plain, x), vec))
    return out


# P6 and P7 beyond the probe shape, for the strided copy's two paths:
# name -> (probe, x's shape, the vector path on 16-byte-aligned tensors)
COPY_SHAPES = {
    "P6 original": ("P6", (C, HW), True),
    "P7 original": ("P7", (C, H, W), True),
    "P6 n=37": ("P6", (3, 37), False),                  # odd n
    "P6 n=12": ("P6", (6, 12), True),                   # 6 outputs a row: vectors span rows
    "P6 C=1": ("P6", (1, HW), True),
    "P7 C=1": ("P7", (1, H, W), True),
    "P6 partial vector": ("P6", (3, 10), False),        # 15 outputs
    "P7 partial vector": ("P7", (3, 5, 7), False),      # 105 outputs
    "P6 rows past the grid limit": ("P6", (65537, 3), False),
}
# the kernels' profiler names on each path
COPY_KERNELS = {True: "::strided_copy_kernel", False: "::strided_copy_scalar_kernel"}


def copy_cases(device="cuda"):
    """(name, kernel call, plain call, vector path) of P6 and P7 at each of
    COPY_SHAPES on seeded inputs, and at their probe shapes as views 4
    bytes off a 16-byte boundary (the scalar path)."""
    import torch
    from backscrub_tpu_torch import _build
    from backscrub_tpu_torch.ops import probe_kernels as pk

    dev = _build.resolve_device(device)
    shapes = dict(COPY_SHAPES)
    for p in ("P6", "P7"):
        shapes[f"{p} original, a view off 16 bytes"] = COPY_SHAPES[f"{p} original"][:2] + (False,)
    fns = {"P6": (pk.lane_stride2, pk.lane_stride2_plain),
           "P7": (pk.reshape_flat, pk.reshape_flat_plain)}
    out = []
    for seed, (name, (probe, shape, vec)) in enumerate(shapes.items()):
        flat = np.random.default_rng(seed).random(int(np.prod(shape)) + 1, np.float32)
        flat = torch.from_numpy(flat).to(dev)
        x = (flat[1:] if "view" in name else flat[:-1]).view(shape)
        kernel, plain = fns[probe]
        out.append((name, functools.partial(kernel, x), functools.partial(plain, x), vec))
    return out


# P5 beyond the probe shape, for the concat's two paths: name -> (a's
# shape, b's shape, the vector path on 16-byte-aligned tensors)
CAT_SHAPES = {
    "P5 original": ((C, HW), (C, HW), True),
    "P5 unequal heights": ((3, HW), (5, HW), True),
    "P5 n=7": ((3, 7), (2, 7), False),                   # 21 and 14 floats
    "P5 b partial vector": ((4, 5), (3, 5), False),       # 20 and 15 floats
    "P5 a empty": ((0, HW), (C, HW), True),
    "P5 b empty": ((C, HW), (0, HW), True),
    "P5 one vector each": ((1, 4), (1, 4), True),
    "P5 past a CTA": ((1, 2056), (3, 2056), True),        # partial last CTAs
    "P5 large": ((256, HW), (128, HW), True),
}
# the kernels' profiler names on each path
CAT_KERNELS = {True: "::concat_kernel", False: "::concat_scalar_kernel"}


def cat_cases(device="cuda"):
    """(name, kernel call, plain call, vector path) of P5 at each of
    CAT_SHAPES on seeded inputs, and at the probe shape with ``a`` and
    then ``b`` a view 4 bytes off a 16-byte boundary (the scalar path;
    the output is allocated aligned)."""
    import torch
    from backscrub_tpu_torch import _build
    from backscrub_tpu_torch.ops import probe_kernels as pk

    dev = _build.resolve_device(device)
    shapes = dict(CAT_SHAPES)
    for which in ("a", "b"):
        shapes[f"P5 original, {which} off 16 bytes"] = \
            CAT_SHAPES["P5 original"][:2] + (False,)
    out = []
    for seed, (name, (sa, sb, vec)) in enumerate(shapes.items()):
        rng = np.random.default_rng(seed)
        xs = []
        for which, shape in (("a", sa), ("b", sb)):
            flat = torch.from_numpy(rng.random(int(np.prod(shape)) + 1, np.float32)).to(dev)
            view = f"{which} off" in name
            xs.append((flat[1:] if view else flat[:-1]).view(shape))
        out.append((name, functools.partial(pk.concat, *xs),
                    functools.partial(pk.concat_plain, *xs), vec))
    return out


def launched_kernels(fn, calls=10, attempts=5) -> List[str]:
    """The names of the CUDA kernels that ``fn`` launches, by the profiler
    over ``calls`` calls in one window (the profiler leaves out a window's
    first kernel, so one call alone may show none).  A window with no
    device events is taken again, up to ``attempts`` windows."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(attempts):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        names = [e.key for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        if names:
            return names
    return []


def run(ps: List[Probe]):
    """The probe path: each kernel once, against the original's reference
    at its atol (rtol 1e-4, as the original's run()).  Returns (probe, ok,
    max |output - reference|) a probe."""
    res = []
    for p in ps:
        o = p.kernel().float().cpu().numpy()
        ok = o.shape == p.ref.shape and bool(np.allclose(o, p.ref, atol=p.atol, rtol=1e-4))
        err = float(np.abs(o - p.ref).max()) if o.shape == p.ref.shape else float("inf")
        res.append((p, ok, err))
    return res


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("probe_hopper: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from chip_smoke import bound, device_ms
    from backscrub_tpu_torch.pipeline.maskgen import set_precision_policy

    set_precision_policy()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    bad = 0
    with torch.no_grad():
        for p, ok, err in run(probes("cuda")):
            bad += not ok
            dev = device_ms(p.kernel) * 1e3
            lib = f"{device_ms(p.library) * 1e3:.3f} us" if p.library else "none"
            b, by = bound(p.nbytes, p.ops, p.bf16_ops)
            print(f"{p.kernel_id} {p.name}: ok={ok} (max err {err:.3g}, atol {p.atol:g}) "
                  f"device {dev:.3f} us, library {lib}, bound {b * 1e3:.3f} us ({by})")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
