"""The decomposition of P1 and P2, the 9-tap stencils of
``backscrub_tpu_torch/csrc/probes.cu`` (``dw9_kernel``, the register
window, and ``dw9_scalar_kernel``), walked on the CPU.

:func:`walk` takes the path that the launcher's ``dw9_vec`` takes (its
condition is read from the source and evaluated here), lays out the 2-D
grid (``blockIdx.y`` the channel, looping past ``DW_MAX_Y``; ``blockIdx.x``
a segment of ``DW_NT`` threads), and on the vector path gives each thread
``DW_VEC`` adjacent outputs: one aligned 16-byte load a vector and tap
row, the float left of the vectors from the lane below and the one right
of them from the lane above (``__shfl_up_sync``/``__shfl_down_sync``), the
warp's first lane and its last lane with outputs loading their outer
float themselves, zero outside the row.  On the vector path every input
float of a warp's window must be loaded exactly once per warp and tap
row, every load and store must be 16-byte aligned and inside its row;
on both paths every output must be written once and the result be bit for
bit ``dw_flat_plain`` / ``dw_rowpad_plain``, and at the original shape
within 1e-5 of the JAX ``k_dw_flat`` and ``k_dwp`` in interpret mode.
The launch arguments are read from the wrappers' source; the card holds
the kernels to the plain twins in tests/test_torch_cuda.py.
"""

import pathlib
import re

import numpy as np
import pytest
import torch

from backscrub_tpu_torch.ops import probe_kernels as pk
from test_torch_probes import jax_probe_runs      # puts tools/ on sys.path

import probe_hopper  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
SOURCE = (ROOT / "backscrub_tpu_torch" / "csrc" / "probes.cu").read_text()
WRAPPERS = (ROOT / "backscrub_tpu_torch" / "ops" / "probe_kernels.py").read_text()
F32 = np.float32


def _const(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", SOURCE).group(1))


DW_NT, DW_VEC, DW_MAX_Y = _const("DW_NT"), _const("DW_VEC"), _const("DW_MAX_Y")

# dw9_vec's condition as a Python expression of the launcher's arguments
_VEC_EXPR = re.search(r"inline bool dw9_vec\([^)]*\) \{\s*return (.*?);\s*\}", SOURCE,
                      re.S).group(1)
_VEC_PY = "(" + (_VEC_EXPR.replace("&&", " and ").replace("||", " or ")
                 .replace("(long long)", "").replace("2LL", "2")) + ")"


def vector_path(x_addr, out_addr, n_in, n_out, s, off):
    """Whether the launcher takes dw9_kernel (else dw9_scalar_kernel)."""
    return bool(eval(_VEC_PY, {}, dict(
        x=x_addr, out=out_addr, n_in=n_in, n_out=n_out, s=s, off=off, DW_VEC=DW_VEC,
        aligned16=lambda p: p % 16 == 0)))


def _launch_args():
    """(c, n, width) -> (n_in, n_out, s, off, di0) of dw_flat's and
    dw_rowpad's bs_probe_dw9 calls, from the wrappers' source."""
    calls = re.findall(r'_build\.launch\("bs_probe_dw9", xp\.data_ptr\(\), out\.data_ptr\(\), '
                       r'c, (.*?)\)\n', WRAPPERS, re.S)
    assert len(calls) == 2
    return [eval(f"lambda n, width, ROWPAD: ({a})") for a in calls]


FLAT_ARGS, ROWPAD_ARGS = _launch_args()


def grid(c, n_out, vec):
    """The launcher's grid: (segments of a row, channel rows)."""
    per = n_out // DW_VEC if vec else n_out
    return -(-per // DW_NT), min(c, DW_MAX_Y)


def _weight(di, b):
    return F32(0.1 + di + 2 * (b - 1))


def _channels(c, gy):
    """Assert that the kernels' channel loop (ch = blockIdx.y, + gridDim.y,
    ...) visits every channel once."""
    visits = np.zeros(c, np.int64)
    for y in range(min(gy, c)):
        visits[y::gy] += 1
    assert (visits == 1).all()


def walk(x, n_out, s, off, di0, x_addr=0, out_addr=0):
    """The kernel the launcher picks, thread by thread on x (c, n_in) f32;
    returns (out, vec).  Asserts the loads, shuffles and stores described
    in the module docstring.  ``x_addr`` and ``out_addr`` stand for the
    tensors' addresses (only their alignment matters)."""
    c, n_in = x.shape
    vec = vector_path(x_addr, out_addr, n_in, n_out, s, off)
    gx, gy = grid(c, n_out, vec)
    _channels(c, gy)              # a channel's threads do the same whichever CTA row
    chans = np.arange(c)
    if vec:
        o, idx = _walk_vector(x, n_in, n_out, s, off, di0, gx, x_addr, out_addr, chans)
    else:
        o, idx = _walk_scalar(x, n_in, n_out, s, off, di0, gx)
    writes = np.bincount(idx, minlength=n_out)
    assert (writes == 1).all()                        # every output of a row once
    out = np.full((c, n_out), np.nan, F32)
    out[:, idx] = o
    return out, vec


def _walk_scalar(xs, n_in, n_out, s, off, di0, gx):
    p = np.arange(gx * DW_NT)
    p = p[p < n_out]                          # the threads that store
    acc = np.zeros((len(xs), len(p)), F32)
    for a in range(3):
        for b in range(3):
            q = p + off + a * s + b - 1
            inside = (q >= 0) & (q < n_in)
            v = np.where(inside, xs[:, np.clip(q, 0, n_in - 1)], F32(0))
            acc = acc + v * _weight(di0 + a, b)
    return acc, p


def _walk_vector(xs, n_in, n_out, s, off, di0, gx, x_addr, out_addr, chans):
    t = np.arange(gx * DW_NT).reshape(-1, 32)          # (warps, lanes)
    lane = t % 32
    p0 = t * DW_VEC
    active = p0 < n_out
    last = active & ((lane == 31) | (p0 + DW_VEC >= n_out))
    first = active & (lane == 0)
    acc = np.zeros((len(xs),) + t.shape + (DW_VEC,), F32)
    for a in range(3):
        q = p0 + off + a * s
        body = q[..., None] + np.arange(DW_VEC)          # the thread's vectors
        assert (body[active] >= 0).all() and (body[active] < n_in).all()
        assert ((x_addr + 4 * (chans[:, None] * n_in + q[active][None])) % 16 == 0).all()
        v = np.zeros((len(xs),) + t.shape + (DW_VEC + 2,), F32)
        v[..., 1:DW_VEC + 1] = np.where(active[..., None], xs[:, np.where(
            active[..., None], body, 0)], F32(0))
        # __shfl_up_sync(v[DW_VEC], 1) / __shfl_down_sync(v[1], 1): a lane
        # with no lane below (above) gets its own value back
        v[..., :, 0] = np.concatenate([v[..., :1, DW_VEC], v[..., :-1, DW_VEC]], -1)
        v[..., :, DW_VEC + 1] = np.concatenate([v[..., 1:, 1], v[..., -1:, 1]], -1)
        ql, qr = q - 1, q + DW_VEC
        v[:, first, 0] = np.where(ql[first] >= 0, xs[:, np.clip(ql[first], 0, None)], F32(0))
        v[:, last, DW_VEC + 1] = np.where(qr[last] < n_in,
                                          xs[:, np.clip(qr[last], None, n_in - 1)], F32(0))
        for w in range(t.shape[0]):                      # a warp's loads of this tap row
            if not active[w].any():
                continue
            got = np.concatenate([body[w][active[w]].ravel(),
                                  ql[w][first[w] & (ql[w] >= 0)], qr[w][last[w] & (qr[w] < n_in)]])
            lo, hi = q[w][active[w]].min() - 1, q[w][active[w]].max() + DW_VEC
            want = np.arange(max(lo, 0), min(hi, n_in - 1) + 1)
            assert len(got) == len(np.unique(got)), (w, a)          # each float once
            assert np.array_equal(np.sort(got), want), (w, a)       # the whole window
        for b in range(3):
            acc = acc + v[..., b:b + DW_VEC] * _weight(di0 + a, b)
    idx = (p0[active][:, None] + np.arange(DW_VEC)).ravel()
    assert ((out_addr + 4 * (chans[:, None] * n_out + p0[active][None])) % 16 == 0).all()
    return acc[:, active].reshape(len(xs), -1), idx


def _case(probe, c, n, width=None, seed=0):
    """(x, launch args, plain twin output) of P1 (``width``) or P2."""
    x = np.random.default_rng(seed).random((c, n), F32)
    t = torch.from_numpy(x)
    if probe == "P1":
        return x, FLAT_ARGS(n, width, pk.ROWPAD), pk.dw_flat_plain(t, width).numpy()
    return x, ROWPAD_ARGS(n, None, pk.ROWPAD), pk.dw_rowpad_plain(t).numpy()


SHAPES = probe_hopper.STENCIL_SHAPES


@pytest.fixture(scope="module")
def cases():
    """probe_hopper.stencil_cases on the CPU, by name."""
    return {name: (k, p, vec) for name, k, p, vec in probe_hopper.stencil_cases("cpu")}


@pytest.mark.parametrize("name", sorted(SHAPES) + ["P1 original, a view off 16 bytes"])
def test_walk_is_the_plain_twin(cases, name):
    """Each of probe_hopper's stencil cases (the ones the card checks) on
    the path the launcher picks for its tensor's alignment: every load and
    store as the module docstring says, the result bit for bit the plain
    twin's (which the wrapper runs on the CPU)."""
    kernel, plain, want_vec = cases[name]
    x = kernel.args[0]
    n = x.shape[1]
    args = FLAT_ARGS(n, kernel.args[1], pk.ROWPAD) if kernel.func is pk.dw_flat \
        else ROWPAD_ARGS(n, None, pk.ROWPAD)
    assert args[0] == n
    got, vec = walk(x.numpy(), *args[1:], x_addr=x.data_ptr() % 16)
    assert vec == want_vec
    want = plain().numpy()
    assert np.array_equal(got, want)
    assert np.array_equal(kernel().numpy(), want)


@pytest.mark.parametrize("name", ["P1 original", "P2 original", "P1 ragged warp"])
def test_misaligned_pointers_take_the_scalar_path(name):
    """A tensor off a 16-byte boundary (a view) takes the scalar path, with
    the same bits."""
    probe, c, n, width, _ = SHAPES[name]
    x, (n_in, n_out, s, off, di0), plain = _case(probe, c, n, width)
    for x_addr, out_addr in ((4, 0), (0, 8)):
        got, vec = walk(x, n_out, s, off, di0, x_addr, out_addr)
        assert not vec
        assert np.array_equal(got, plain)


def _reference(x, n_out, s, off, di0):
    """The stencil's definition on x (c, n_in): taps a outer, b inner,
    zeros outside the row, f32 products and sums."""
    n_in = x.shape[1]
    xz = np.pad(x, ((0, 0), (n_in, n_in)))       # a row's zeros on both sides
    acc = np.zeros((x.shape[0], n_out), F32)
    for a in range(3):
        for b in range(3):
            q0 = n_in + off + a * s + b - 1
            acc = acc + xz[:, q0:q0 + n_out] * _weight(di0 + a, b)
    return acc


# bs_probe_dw9's arguments beyond the wrappers' (n_in, n_out, s, off, di0):
# each breaks one clause of dw9_vec and must take the scalar path
RAW = {
    "rows off 16 bytes": (390, 132, 128, 0, 0),      # n_in % 4 == 2
    "vectors past the row": (388, 136, 128, 0, 0),   # n_out + off + 2 s > n_in
    "negative offset": (400, 128, 128, -4, 0),
    "outputs no whole vector": (264, 6, 128, 0, 0),
    "odd stride": (400, 128, 130, 0, 0),
}


@pytest.mark.parametrize("name", sorted(RAW))
def test_launches_off_the_vector_path(name):
    n_in, n_out, s, off, di0 = RAW[name]
    x = np.random.default_rng(n_in).random((3, n_in), F32)
    got, vec = walk(x, n_out, s, off, di0)
    assert not vec
    assert np.array_equal(got, _reference(x, n_out, s, off, di0))


def test_grid_at_the_probe_shapes():
    """The 2-D grid: P1's 3840 and P2's 6144 outputs a row as DW_VEC-wide
    threads in DW_NT-thread CTAs, one CTA row a channel; a warp's outputs
    cover 32 DW_VEC floats."""
    assert DW_VEC % 4 == 0 and DW_NT % 32 == 0
    for n_out in (3840, 6144):
        gx, gy = grid(16, n_out, True)
        assert gy == 16 and (gx - 1) * DW_NT * DW_VEC < n_out <= gx * DW_NT * DW_VEC
    assert grid(70000, 4, True) == (1, DW_MAX_Y)


def test_channels_past_the_grid_limit():
    """More channels than gridDim.y holds: each CTA row loops over channels
    DW_MAX_Y apart, every channel once, bit for bit the twin."""
    c, width = DW_MAX_Y + 2, 4
    x, (n_in, n_out, s, off, di0), plain = _case("P1", c, 1 * width + 4 * width, width, seed=3)
    got, vec = walk(x, n_out, s, off, di0)
    assert vec and np.array_equal(got, plain)


def test_launch_arguments():
    """The wrappers' arguments: P1 (n, n - 4W, W, W, -1), P2 (n, n - 256,
    128, 0, 0)."""
    assert FLAT_ARGS(4160, 80, 128) == (4160, 3840, 80, 80, -1)
    assert ROWPAD_ARGS(6400, None, 128) == (6400, 6144, 128, 0, 0)


@pytest.fixture(scope="module")
def jax_stencils():
    return jax_probe_runs(["dw_flat_lane_shifts_9tap", "dw_padded_rows_9tap"])


@pytest.mark.parametrize("name,probe", [("dw_flat_lane_shifts_9tap", "P1 original"),
                                        ("dw_padded_rows_9tap", "P2 original")])
def test_walk_matches_jax_probe(jax_stencils, name, probe):
    """At the original shape on the vector path: within 1e-5 of the JAX
    kernel in interpret mode, on the original's own input."""
    got_jax, (xp,), _, _ = jax_stencils[name]
    _, c, n, width, _ = SHAPES[probe]
    assert xp.shape == (c, n)
    args = FLAT_ARGS(n, width, pk.ROWPAD) if width else ROWPAD_ARGS(n, None, pk.ROWPAD)
    got, vec = walk(xp, *args[1:])
    assert vec
    np.testing.assert_allclose(got, got_jax, atol=1e-5, rtol=0)
