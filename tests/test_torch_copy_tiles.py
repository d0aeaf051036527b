"""The decomposition of P6 and P7, the strided copy of
``backscrub_tpu_torch/csrc/probes.cu`` (``strided_copy_kernel``, the
vector path, and ``strided_copy_scalar_kernel``), walked on the CPU.

Both probes write out[r, j] = x[r, S j], S = 2 for P6 (``lane_stride2``)
and 1 for P7 (``reshape_flat``, on the flat (C, H*W) view).  :func:`walk`
takes the path that the launcher's ``copy_vec`` takes (its condition is
read from the source and evaluated here).  On the vector path the copy is
flat, out_flat[k] = x_flat[S k]: a 1-D grid of ``CP_NT``-thread CTAs, each
thread ``CP_LOADS`` / S output vectors ``CP_NT`` apart, each loading the
S input vectors behind its output vector (``CP_LOADS`` in all) and
keeping lanes x and z of each where S = 2.  On the scalar path a 2-D grid (``blockIdx.y`` the row,
looping past ``DW_MAX_Y``; ``blockIdx.x`` a segment of ``CP_NT``
outputs), one output a thread.  Every output must be written exactly
once, every load and store on the vector path be 16-byte aligned and
inside its buffer, and the result be bit for bit ``lane_stride2_plain`` /
``reshape_flat_plain`` at each of ``tools/probe_hopper.py``'s
``COPY_SHAPES`` (the shapes the card checks), and at the probe shape the
JAX ``k_ls`` and ``k_rs`` in interpret mode.  The constants are read
from the source, the launch arguments from the wrappers' source; the card
holds the kernels to the plain twins in tests/test_torch_cuda.py.
"""

import pathlib
import re

import numpy as np
import pytest
import torch

from test_torch_probes import jax_probe_runs      # puts tools/ on sys.path

import probe_hopper  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
SOURCE = (ROOT / "backscrub_tpu_torch" / "csrc" / "probes.cu").read_text()
WRAPPERS = (ROOT / "backscrub_tpu_torch" / "ops" / "probe_kernels.py").read_text()
INT_MAX = 2 ** 31 - 1


def _const(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", SOURCE).group(1))


CP_NT, CP_LOADS, MAX_Y = _const("CP_NT"), _const("CP_LOADS"), _const("DW_MAX_Y")

# copy_vec's condition as a Python expression of the launcher's arguments
_VEC_EXPR = re.search(r"inline bool copy_vec\([^)]*\) \{\s*return (.*?);\s*\}", SOURCE,
                      re.S).group(1)
_VEC_PY = "(" + (_VEC_EXPR.replace("&&", " and ").replace("||", " or ")
                 .replace("(long long)", "").replace("/", "//")) + ")"


def vector_path(x_addr, out_addr, c, n, S):
    """Whether the launcher takes strided_copy_kernel (else the scalar
    kernel)."""
    return bool(eval(_VEC_PY, {}, dict(x=x_addr, out=out_addr, c=c, n=n, S=S, INT_MAX=INT_MAX,
                                       aligned16=lambda p: p % 16 == 0)))


def _launchers():
    """{exported launcher: S} of the strided copy, from the source."""
    return {name: int(s) for name, s in re.findall(
        r'extern "C" int (bs_probe_\w+)\([^)]*\) \{\s*return strided_copy<(\d)>\(', SOURCE)}


def _launch_args():
    """{wrapper: (launcher, x -> (c, n))} of lane_stride2's and
    reshape_flat's launches, from the wrappers' source."""
    out = {}
    for wrapper in ("lane_stride2", "reshape_flat"):
        body = WRAPPERS[WRAPPERS.index(f"def {wrapper}("):]
        name, args = re.search(r'_build\.launch\("(\w+)", x\.data_ptr\(\), out\.data_ptr\(\),'
                               r'\s*(.*?)\)\n', body, re.S).groups()
        out[wrapper] = (name, eval(f"lambda x: ({args})"))
    return out


LAUNCHERS, ARGS = _launchers(), _launch_args()


def grid(c, n, S, vec):
    """The launcher's grid: (x, y)."""
    if vec:
        return -(-(c * n // S // 4) // (CP_NT * (CP_LOADS // S))), 1
    return -(-(-(-n // S)) // CP_NT), min(c, MAX_Y)


def walk(x, S, x_addr=0, out_addr=0):
    """The kernel the launcher picks, thread by thread on x (c, n) f32;
    returns (out (c, ceil(n / S)), vec).  Asserts the loads and stores
    described in the module docstring.  ``x_addr`` and ``out_addr`` stand
    for the tensors' addresses (only their alignment matters)."""
    c, n = x.shape
    no = -(-n // S)
    vec = vector_path(x_addr, out_addr, c, n, S)
    gx, gy = grid(c, n, S, vec)
    out = np.full(c * no, np.nan, np.float32)
    writes = np.zeros(c * no, np.int64)
    if vec:
        m, V = c * n // S // 4, CP_LOADS // S            # output vectors, a thread's
        assert V * S == CP_LOADS
        t = np.arange(gx * CP_NT)                        # every thread of the grid
        v0 = t // CP_NT * (CP_NT * V) + t % CP_NT
        v = v0[:, None] + CP_NT * np.arange(V)           # (threads, V)
        v = v[v < m]                                     # the vectors stored
        idx = S * v[:, None] + np.arange(S)              # the input vectors loaded
        assert (idx >= 0).all() and (4 * idx + 4 <= c * n).all()
        assert ((x_addr + 16 * idx) % 16 == 0).all() and ((out_addr + 16 * v) % 16 == 0).all()
        assert len(np.unique(idx)) == idx.size           # each input vector read once
        got = x.reshape(-1, 4)[idx]                      # (vectors, S, 4)
        vals = got[:, 0] if S == 1 else got[:, :, [0, 2]].reshape(-1, 4)
        lanes = 4 * v[:, None] + np.arange(4)
        np.add.at(writes, lanes.ravel(), 1)
        out[lanes.ravel()] = vals.ravel()
    else:
        visits = np.zeros(c, np.int64)                   # the row loop: r = y, y + gy, ...
        for y in range(gy):
            visits[y::gy] += 1
        assert (visits == 1).all()
        j = np.arange(gx * CP_NT)
        j = j[j < no]                                    # the threads that store
        assert (S * j < n).all()
        rows = np.arange(c)[:, None]
        np.add.at(writes, (rows * no + j).ravel(), 1)
        out.reshape(c, no)[:, j] = x[:, S * j]
    assert (writes == 1).all()                           # every output once
    return out.reshape(c, no), vec


SHAPES = probe_hopper.COPY_SHAPES
VIEWS = ["P6 original, a view off 16 bytes", "P7 original, a view off 16 bytes"]


@pytest.fixture(scope="module")
def cases():
    """probe_hopper.copy_cases on the CPU, by name."""
    return {name: (k, p, vec) for name, k, p, vec in probe_hopper.copy_cases("cpu")}


@pytest.mark.parametrize("name", sorted(SHAPES) + VIEWS)
def test_walk_is_the_plain_twin(cases, name):
    """Each of probe_hopper's copy cases (the ones the card checks) on the
    path the launcher picks for its tensor's alignment: every load and
    store as the module docstring says, the result bit for bit the plain
    twin's (which the wrapper runs on the CPU)."""
    kernel, plain, want_vec = cases[name]
    x = kernel.args[0]
    launcher, args = ARGS[kernel.func.__name__]
    c, n = args(x)
    got, vec = walk(x.numpy().reshape(c, n), LAUNCHERS[launcher], x_addr=x.data_ptr() % 16)
    assert vec == want_vec
    want = plain().numpy()
    assert np.array_equal(got, want)
    assert np.array_equal(kernel().numpy(), want)


def test_launchers_and_arguments():
    """P6 launches the S = 2 copy on (C, N), P7 the S = 1 copy on (C, H*W)."""
    assert LAUNCHERS == {"bs_probe_stride2": 2, "bs_probe_copy": 1}
    x2, x3 = torch.zeros(16, 3840), torch.zeros(16, 48, 80)
    assert ARGS["lane_stride2"][0] == "bs_probe_stride2"
    assert ARGS["lane_stride2"][1](x2) == (16, 3840)
    assert ARGS["reshape_flat"][0] == "bs_probe_copy"
    assert ARGS["reshape_flat"][1](x3) == (16, 3840)


@pytest.mark.parametrize("name", ["P6 original", "P7 original", "P6 n=12"])
def test_misaligned_pointers_take_the_scalar_path(name):
    """A tensor off a 16-byte boundary takes the scalar path, with the same
    bits."""
    probe, shape, _ = SHAPES[name]
    x = np.random.default_rng(5).random(shape, np.float32)
    S = 2 if probe == "P6" else 1
    x2 = x.reshape(shape[0], -1)
    want = x2[:, 0::S]
    for x_addr, out_addr in ((4, 0), (0, 8)):
        got, vec = walk(x2, S, x_addr, out_addr)
        assert not vec
        assert np.array_equal(got, want)


# (c, n, S, vector path) beyond the probes' shapes: each clause of copy_vec
RAW = {
    "S=1 odd n, whole vectors": (4, 7, 1, True),       # a copy is flat at any n
    "S=2 odd n": (8, 7, 2, False),
    "S=2 n=4": (2, 4, 2, True),                          # one vector: two rows
    "S=2 outputs no whole vector": (1, 6, 2, False),
    "S=1 a partial vector": (1, 6, 1, False),
    "vectors past a CTA": (1, 4 * CP_NT * CP_LOADS * 2 + 8, 1, True),
}


@pytest.mark.parametrize("name", sorted(RAW))
def test_paths_at_other_shapes(name):
    c, n, S, want_vec = RAW[name]
    x = np.random.default_rng(n).random((c, n), np.float32)
    got, vec = walk(x, S)
    assert vec == want_vec
    assert np.array_equal(got, x[:, 0::S])


def test_counts_past_32_bits_take_the_scalar_path():
    """copy_vec keeps the vector path's flat indices in 32 bits."""
    assert not vector_path(0, 0, 2, 2 ** 30 + 4, 1)
    assert vector_path(0, 0, 1, 2 ** 30 + 4, 1)


def test_grid_at_the_probe_shapes():
    """P6's 7680 and P7's 15360 output vectors in CTAs of CP_NT threads,
    CP_LOADS / S vectors a thread: the same number of CTAs for both; the
    scalar path's rows past gridDim.y's limit."""
    grids = []
    for (c, n, S), m in (((16, 3840, 2), 7680), ((16, 3840, 1), 15360)):
        gx, gy = grid(c, n, S, True)
        per = CP_NT * (CP_LOADS // S)
        assert gy == 1 and (gx - 1) * per < m <= gx * per
        grids.append(gx)
    assert grids[0] == grids[1]
    assert grid(70000, 3, 2, False) == (1, MAX_Y)


@pytest.fixture(scope="module")
def jax_copies():
    return jax_probe_runs(["lane_stride2", "inkernel_reshape"])


@pytest.mark.parametrize("name,probe", [("lane_stride2", "P6 original"),
                                        ("inkernel_reshape", "P7 original")])
def test_walk_matches_jax_probe(jax_copies, name, probe):
    """At the original shape on the vector path: bit for bit the JAX kernel
    in interpret mode, on the original's own input."""
    got_jax, (x,), _, _ = jax_copies[name]
    p, shape, _ = SHAPES[probe]
    assert x.shape == shape
    got, vec = walk(x.reshape(shape[0], -1), 2 if p == "P6" else 1)
    assert vec
    assert np.array_equal(got, got_jax)


@pytest.mark.parametrize("design", ["register", "register-nofence", "register-volatile",
                                    "shfl", "tma"])
def test_sweep_variants_apply_to_the_source(design):
    """tools/sweep_copy.py's variants find what they replace in probes.cu:
    the constants, and each design's one edit."""
    import sweep_copy
    text = sweep_copy.variant_source(SOURCE, design, 64, 4)
    assert "constexpr int CP_NT = 64;" in text and "constexpr int CP_LOADS = 4;" in text
    assert ("in[k][s] = ld4v_if(" in text) == (design == "register-volatile")
    assert (text.count("__threadfence_block();") < SOURCE.count("__threadfence_block();")) \
        == (design == "register-nofence")
    assert ("copy_tma_kernel" in text) == (design == "tma")
    assert ("copy_shfl_kernel" in text) == (design == "shfl")
