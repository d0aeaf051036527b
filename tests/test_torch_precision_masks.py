"""The port's bf16 mode (``compute_dtype=torch.bfloat16, precision=
"default"``) against the JAX package's (``compute_dtype=bfloat16,
precision=DEFAULT``), mask by mask: four ``SyntheticSource`` frames at
640x480 through ``MaskGen`` on every synthetic family, fused (the JAX
Pallas kernels in interpret mode) and classic.  The JAX runs are compiled
with XLA's excess precision off (tests/test_torch_precision.py says why).

Every bar is relative, and each has a control: the port's f32 path, a
port that ignored bf16, read by the same statistic against the JAX bf16.
The port's bf16 must read at most CONTROL_SHARE = 0.85 of what the
control reads, and the test asserts that the control misses that bar.
Let J be the JAX package's own bf16-vs-f32 mask IoU (``m < 128``) after
the four frames on a route.

- Where the body runs wholly in the kernels (segm_lite, segm_full and
  mlkit, fused), the decode flip rule against the JAX bf16: every flipped
  decode a near-tie, the EMAs equal wherever none flipped, no mask byte
  off by more than 1 outside the flips' post footprint.  The near-tie is
  0.85 of the largest |margin| at which the control's decode differs from
  the JAX bf16's: every dot operand is rounded to 8 significant bits, so
  where the two summation orders' f32 ulps straddle a bf16 rounding
  boundary they become bf16 ulps, and the two packages' tail logits drift
  apart: the port flips at |margin| up to 5.7e-4 (segm_lite), 1.3e-3
  (segm_full) and 1.5e-3 (mlkit), the control up to 2.8e-3, 2.8e-3 and
  6.7e-3 (0.20, 0.45 and 0.23 of it).
- Where a bf16 executor span runs (deeplab and BodyPix fused, whose
  remainder is the executor, and every classic route) and the bf16 effect
  spans at least MIN_CELLS = 10 decode cells, IoU(port, JAX bf16) >= 1 -
  0.85 (1 - J).  The port's share of 1 - J reads 0.03-0.69 on these
  routes (deeplab 0.58 fused, 0.69 classic), the control's 1.0-1.17.  A bar of min(0.99, 1 - (1 - J) / 2)
  would not hold (deeplab reads 0.58 fused and 0.69 classic, over the 0.5
  it needs: its argmax decode turns a few flipped logits into large mask
  areas), and its 0.99 floor would let the control pass.
- BodyPix's effect spans one decode cell of its 33x33 grid, so its masks
  cannot tell the modes apart (the port reads 1.29 of 1 - J fused, the
  control 1.0).  Its executor spans are held before the decode instead:
  the fused remainder in ``test_bf16_remainder_matches_jax`` (each frame's
  plan output through the port's and the JAX remainders, mean |port - JAX
  bf16| <= 0.5 mean |JAX bf16 - JAX f32|, the control missing it), the
  classic model in tests/test_torch_precision.py's executor test.
- The port's own bf16-vs-f32 IoU is at least J - 0.01.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from backscrub_tpu.io.streams import SyntheticSource
from backscrub_tpu.pipeline.maskgen import MaskGen as JaxMaskGen
from backscrub_tpu_torch.pipeline import edge as tedge
from backscrub_tpu_torch.pipeline.maskgen import MaskGen

from test_torch_precision import FAMILIES, NO_EXCESS, H, W

FRAMES = 4
# the module docstring's bars: the share of the control's reading the
# port's bf16 may reach, and the decode cells the bf16 effect must span for
# the mask IoU to be read
CONTROL_SHARE, MIN_CELLS = 0.85, 10
KERNEL_FAMILIES = ("segm_lite", "segm_full", "mlkit")


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _exact(mg):
    """The JAX MaskGen's fused step compiled with XLA's excess precision
    off, on its first call."""
    step, compiled = mg._step, []

    def run(params, frame, ema):
        if not compiled:
            compiled.append(step.lower(params, frame, ema).compile(compiler_options=NO_EXCESS))
        return compiled[0](params, frame, ema)
    mg._step = run
    return mg


def _quadrant_to_std(ema_q):
    q = np.asarray(ema_q)
    return q.transpose(2, 0, 3, 1).reshape(2 * q.shape[2], 2 * q.shape[3])


@pytest.fixture(scope="module")
def frames():
    src = SyntheticSource(W, H)
    return [src.read() for _ in range(FRAMES)]


@pytest.fixture(scope="module")
def jax_runs(frames):
    """(family, route, "bf16" | "f32") -> (masks, EMAs in the standard
    layout) of the JAX MaskGen over ``frames``, computed once."""
    cache = {}

    def get(family, route, mode):
        key = (family, route, mode)
        if key not in cache:
            kw = (dict(edge_fused=True, edge_interpret=True) if route == "fused"
                  else dict(edge_fused=False))
            if mode == "bf16":
                kw.update(compute_dtype=jnp.bfloat16, precision=jax.lax.Precision.DEFAULT)
            mg = _exact(JaxMaskGen(FAMILIES[family], W, H, **kw))
            masks, emas = [], []
            for f in frames:
                masks.append(np.asarray(mg.process(f)))
                ema = np.asarray(mg.ema)
                emas.append(_quadrant_to_std(ema) if ema.ndim == 4 else ema)
            cache[key] = masks, emas
        return cache[key]
    return get


def _iou(a, b):
    a, b = a < 128, b < 128
    return float((a & b).sum() / max((a | b).sum(), 1))


def _margin(mg, frame):
    """The fused path's decode margin (tail logit less its threshold) on
    ``frame``, recomputed from the frame."""
    e = mg.edge
    with torch.no_grad():
        body = e.body(e.front(torch.from_numpy(frame)))
        return (e.tail_logits(body.reshape(body.shape[0], -1))
                - e.info.tail_threshold).float().numpy()


@pytest.mark.parametrize("route", ["fused", "classic"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_bf16_masks_match_jax(frames, jax_runs, family, route):
    path = FAMILIES[family]
    kw = {} if route == "fused" else dict(edge_fused=False)
    port = MaskGen(path, W, H, device="cpu", compute_dtype=torch.bfloat16,
                   precision="default", **kw)
    f32 = MaskGen(path, W, H, device="cpu", **kw)
    assert port.precision == "default" and port.model.compute_dtype == torch.bfloat16
    assert (port.edge is not None) == (route == "fused")
    if route == "fused":
        assert all(p.dots == "bf16" for p in port.edge.plans)
    jb, jf = jax_runs(family, route, "bf16"), jax_runs(family, route, "f32")
    kernels_only = route == "fused" and family in KERNEL_FAMILIES
    runs = []
    for i, f in enumerate(frames):
        with torch.no_grad():
            mask, f32_mask = port.process(f).numpy(), f32.process(f).numpy()
        if kernels_only:
            runs.append((port.ema.numpy(), _margin(port, f), mask,
                         f32.ema.numpy(), _margin(f32, f)))
    J = _iou(jb[0][-1], jf[0][-1])
    assert _iou(mask, f32_mask) >= J - 0.01
    if kernels_only:
        # the control: the largest |margin| at which the f32 decode differs
        control = max(float(np.abs(m32[(e32 >> 5) != (jema >> 5)]).max(initial=0.0))
                      for (_, _, _, e32, m32), jema in zip(runs, jb[1]))
        tie = CONTROL_SHARE * control
        ever = np.zeros(port.ema_shape, bool)
        for (ema, margin, mask, _, _), jema, jmask in zip(runs, jb[1], jb[0]):
            flipped = (ema >> 5) != (jema >> 5)
            assert (np.abs(margin[flipped]) <= tie).all(), (np.abs(margin[flipped]).max(), tie)
            ever |= flipped
            assert np.array_equal(ema[~ever], jema[~ever])
            foot = tedge.post_footprint(torch.from_numpy(ema != jema), port.geo,
                                        port.post_mats).numpy()
            d = np.abs(mask.astype(int) - jmask.astype(int))
            assert int(np.where(foot, 0, d).max()) <= 1
        return
    cells = int(((jb[1][-1] >> 7) != (jf[1][-1] >> 7)).sum())     # the latest decodes
    if family == "bodypix":
        assert cells < MIN_CELLS        # held before the decode: module docstring
        return
    assert cells >= MIN_CELLS
    bar = 1 - CONTROL_SHARE * (1 - J)
    assert _iou(mask, jb[0][-1]) >= bar, (_iou(mask, jb[0][-1]), J)
    assert _iou(f32_mask, jb[0][-1]) < bar        # the control misses it


@pytest.mark.parametrize("family", ["deeplab", "bodypix"])
def test_bf16_remainder_matches_jax(frames, family):
    """The fused route's executor remainder in bf16: each frame's bf16
    plan output (the port's plain plans) through the port's remainder and
    the JAX fused route's, mean |port - JAX bf16| <= 0.5 mean |JAX bf16 -
    JAX f32| (the executor bar of tests/test_torch_precision.py), and the
    port's f32 remainder, the control, misses it."""
    path = FAMILIES[family]
    port = MaskGen(path, W, H, device="cpu", compute_dtype=torch.bfloat16, precision="default")
    ctl = MaskGen(path, W, H, device="cpu")
    e = port.edge
    assert e is not None and e.rest is not None and ctl.edge.rest is not None
    bodies = {}
    for mode in ("bf16", "f32"):
        kw = (dict(compute_dtype=jnp.bfloat16, precision=jax.lax.Precision.DEFAULT)
              if mode == "bf16" else {})
        mg = JaxMaskGen(path, W, H, edge_fused=True, edge_interpret=True, **kw)
        bodies[mode] = mg.edge._body, mg.model.params
    for f in frames:
        with torch.no_grad():
            h = e.front(torch.from_numpy(f))
            for plan in e.plans:
                m = plan.out_meta
                h = plan.run_plain(h.reshape(h.shape[0], -1), "bf16").reshape(m.c, m.rows, m.w)
            hin = h.permute(1, 2, 0)[None]
            got, got32 = (g.edge.rest(hin)[0].float().numpy() for g in (port, ctl))
        xj = jnp.asarray(hin.numpy())
        ref = {mode: np.asarray(jax.jit(fn).lower(params, xj).compile(
            compiler_options=NO_EXCESS)(params, xj)[0]).astype(np.float32)
            for mode, (fn, params) in bodies.items()}
        gap = np.abs(ref["bf16"] - ref["f32"]).mean()
        assert 0 < gap and np.abs(got - ref["bf16"]).mean() <= 0.5 * gap
        assert np.abs(got32 - ref["bf16"]).mean() > 0.5 * gap
