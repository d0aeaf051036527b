"""The probe kernels P1-P7 (``backscrub_tpu_torch/ops/probe_kernels.py``,
``csrc/probes.cu``) on the CPU, against the JAX probe kernels of
``tools/probe_mosaic.py`` themselves.

The tool is not edited: its ``main()`` runs with ``run`` replaced by a
recorder and ``pl.pallas_call`` by its interpret mode, and each recorded
kernel then runs under ``jax.jit`` on the CPU.  The port's plain twins get
the same arrays.  Bars: the stencils (P1, P2), P3 at HIGHEST and P4 within
1e-5; P3 at DEFAULT within the original's 5e-2 (JAX runs DEFAULT in f32 on
the CPU, the twin rounds its operands to bf16); the copies (P5-P7) byte for
byte.  The kernels themselves run against these twins in
tests/test_torch_cuda.py.
"""

import functools
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from backscrub_tpu_torch.ops import probe_kernels as pk
from backscrub_tpu_torch.ops.megakernel import conv1x1_bf16x3_plain

ROOT = pathlib.Path(__file__).resolve().parent.parent
if str(ROOT / "tools") not in sys.path:
    sys.path.insert(0, str(ROOT / "tools"))
import probe_hopper  # noqa: E402

W = probe_hopper.W
# the original's run() names -> (the port's plain twin on its arguments, atol
# against the JAX kernel; 0 = byte for byte)
TWINS = {
    "dw_flat_lane_shifts_9tap": (lambda xp: pk.dw_flat_plain(xp, W), 1e-5),
    "dw_padded_rows_9tap": (pk.dw_rowpad_plain, 1e-5),
    "dot_default": (lambda x, w: pk.dot_plain(w, x, "default"), 5e-2),
    "dot_highest": (lambda x, w: pk.dot_plain(w, x, "highest"), 1e-5),
    "se_pool_fc_gate": (pk.se_plain, 1e-5),
    "sublane_concat": (pk.concat_plain, 0),
    "lane_stride2": (pk.lane_stride2_plain, 0),
    "inkernel_reshape": (pk.reshape_flat_plain, 0),
}


def jax_probe_runs(names=None):
    """{name: (JAX output, arguments, the original's reference, its atol)}
    of the run()s in probe_mosaic.main() (those in ``names``, or all), the
    kernels in interpret mode.  The tool seeds model search roots in
    os.environ when it is imported; the environment is restored for the
    tests that follow."""
    env = dict(os.environ)
    try:
        import probe_mosaic
    finally:
        os.environ.clear()
        os.environ.update(env)
    recorded, out = [], {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(probe_mosaic, "run", lambda name, fn, args, ref=None, atol=1e-4:
                   recorded.append((name.split(" (")[0], fn, args, ref, atol)))
        mp.setattr(probe_mosaic.pl, "pallas_call",
                   functools.partial(pl.pallas_call, interpret=True))
        probe_mosaic.main()
        for name, fn, args, ref, atol in recorded:
            if names is None or name in names:
                out[name] = (np.asarray(jax.jit(fn)(*args)), [np.asarray(a) for a in args],
                             ref, atol)
    return out


@pytest.fixture(scope="module")
def jax_runs():
    """Every probe's JAX run (jax_probe_runs)."""
    return jax_probe_runs()


def test_every_pallas_call_is_recorded(jax_runs):
    assert sorted(jax_runs) == sorted(TWINS)


@pytest.mark.parametrize("name", sorted(TWINS))
def test_plain_twin_matches_jax_probe(jax_runs, name):
    """Each twin against the JAX kernel at the module's bars, and against the
    original's numpy reference at the original's atol."""
    got_jax, args, ref, atol = jax_runs[name]
    twin, tol = TWINS[name]
    got = twin(*(torch.from_numpy(a.copy()) for a in args)).numpy()
    assert got.shape == got_jax.shape
    if tol:
        np.testing.assert_allclose(got, got_jax, atol=tol, rtol=0)
    else:
        assert np.array_equal(got, got_jax)
    np.testing.assert_allclose(got, ref, atol=atol, rtol=1e-4)


def test_probe_hopper_reproduces_the_originals_inputs(jax_runs):
    """tools/probe_hopper.py builds the original's arrays and references bit
    for bit."""
    a, refs = probe_hopper.inputs(), probe_hopper.references(probe_hopper.inputs())
    want = {"dw_flat_lane_shifts_9tap": [a["xpad"]], "dw_padded_rows_9tap": [a["xp"]],
            "dot_default": [a["x2"], a["w16"]], "se_pool_fc_gate": [a["x2"], a["w16"]],
            "sublane_concat": [a["x2"], a["x2"]], "inkernel_reshape": [a["x3"]]}
    for name, arrays in want.items():
        assert all(np.array_equal(x, y) for x, y in zip(jax_runs[name][1], arrays)), name
    for name, (_, _, ref, _) in jax_runs.items():
        np.testing.assert_array_equal(refs[name], ref, err_msg=name)


def test_probe_path_on_the_cpu():
    """probe_hopper's probe path with CPU tensors: every wrapper runs its plain
    twin (no launch counted) within the original's atol of its reference."""
    before = [k.launches for k in pk.KERNELS]
    ps = probe_hopper.probes("cpu")
    assert [p.kernel_id for p in ps] == ["P1", "P2", "P3", "P3", "P3", "P4", "P5", "P6", "P7"]
    for p, ok, err in probe_hopper.run(ps):
        assert ok, (p.name, err)
        assert torch.equal(p.kernel(), p.plain()), p.name
    assert [k.launches for k in pk.KERNELS] == before
    # the bounds' bytes: each input read once, the output written once
    assert {p.kernel_id: p.nbytes for p in ps} == dict(
        P1=512000, P2=802816, P3=492544, P4=492544, P5=983040, P6=368640, P7=491520)


def test_library_twins_match_plain():
    """The one-call library twins (sparse depthwise F.conv1d for the
    stencils, torch.matmul, torch.cat, the strided slice, the clone) compute
    the twins' functions; P4 has none."""
    for p in probe_hopper.probes("cpu"):
        if p.library is None:
            assert p.kernel_id == "P4"
            continue
        lib, plain = p.library().float(), p.plain()
        # torch.matmul is no bf16x3 split: HIGH's library call is f32
        tol = {"dot_default": 5e-2, "dot_high": 1e-4}.get(
            p.name, 0 if p.kernel_id in ("P5", "P6", "P7") else 1e-5)
        assert lib.shape == plain.shape, p.name
        assert float((lib - plain).abs().max()) <= tol, p.name


def test_dot_high_is_the_gemm_split():
    """P3 at HIGH is K2''s GEMM arithmetic: conv1x1_bf16x3_plain with a zero
    bias, and the JAX package's three-pass split (megakernel.py:501-515)
    within 1e-5 relative."""
    a = probe_hopper.inputs()
    w, x = torch.from_numpy(a["w16"]), torch.from_numpy(a["x2"])
    got = pk.dot_plain(w, x, "high")
    assert torch.equal(got, conv1x1_bf16x3_plain(w, torch.zeros(16), x))

    def split(v):
        hi = v.astype(jnp.bfloat16)
        return hi, (v - hi.astype(jnp.float32)).astype(jnp.bfloat16)

    def d(u, v):
        return jax.lax.dot_general(u, v, (((1,), (0,)), ((), ())),
                                   preferred_element_type=jnp.float32)
    (wh, wl), (xh, xl) = split(jnp.asarray(a["w16"])), split(jnp.asarray(a["x2"]))
    ref = np.asarray(d(wh, xh) + d(wh, xl) + d(wl, xh))
    assert np.abs(got.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()


def test_stencils_at_other_shapes():
    """P1 at another row width and P2's zero shifts at both ends of the flat
    row, against a loop over the taps in numpy."""
    rng = np.random.default_rng(1)
    for w, xp in ((7, rng.random((3, 5 * 7 + 28), np.float32)),
                  (pk.ROWPAD, rng.random((2, 3 * pk.ROWPAD + 5), np.float32))):
        flat = w != pk.ROWPAD
        n_out = xp.shape[1] - (4 * w if flat else 2 * w)
        ref = np.zeros((xp.shape[0], n_out), np.float32)
        for a in range(3):
            for b in (-1, 0, 1):
                q = np.arange(n_out) + (w if flat else 0) + a * w + b
                inside = (q >= 0) & (q < xp.shape[1])
                v = np.where(inside, xp[:, np.clip(q, 0, xp.shape[1] - 1)], 0)
                ref = ref + v * np.float32(0.1 + (a - 1 if flat else a) + 2 * b)
        t = torch.from_numpy(xp)
        got = pk.dw_flat(t, w) if flat else pk.dw_rowpad(t)
        np.testing.assert_array_equal(got.numpy(), ref)


def test_probe_entry_point_needs_cuda():
    """probe_hopper runs on the card unless asked for the CPU, and raises
    without one; its main() exits 1."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        probe_hopper.probes()
    assert probe_hopper.main() == 1
    with pytest.raises(ValueError):
        pk.dot(torch.zeros(16, 16), torch.zeros(16, 8), "tf32")


def test_probe_modules_import_no_jax():
    code = ("import sys; sys.path.insert(0, 'tools'); "
            "import backscrub_tpu_torch.ops.probe_kernels, probe_hopper; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'tensorflow', 'backscrub_tpu')); "
            "print(bad); sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
