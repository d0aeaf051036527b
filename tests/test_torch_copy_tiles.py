"""The decomposition of P6 and P7, the strided copy of
``backscrub_tpu_torch/csrc/probes.cu`` (``strided_copy_kernel``, the
vector path, and ``strided_copy_scalar_kernel``), and of P5, the concat
on the same vector body (``concat_kernel``, ``concat_scalar_kernel``),
walked on the CPU.

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

P5 (:func:`walk_cat`) is one launch on a 1-D grid split between its
sources, the split, the path (``concat_vec``) and the refusal past
INT_MAX floats read from the launcher and evaluated here, against
``concat_plain`` at ``probe_hopper.CAT_SHAPES`` and views off 16 bytes,
and against the JAX ``k_cat`` in interpret mode.
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



def _py(expr):
    """A C condition of the launcher's as a Python expression."""
    return "(" + (expr.replace("&&", " and ").replace("||", " or ")
                  .replace("(long long)", "").replace("/", "//")) + ")"


# copy_vec's condition as a Python expression of the launcher's arguments
_VEC_PY = _py(re.search(r"inline bool copy_vec\([^)]*\) \{\s*return (.*?);\s*\}", SOURCE,
                        re.S).group(1))


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


# -- P5: the concat, a two-source copy on the same body -----------------------

# concat_vec's condition and the launcher's refusal as Python expressions of
# the launcher's arguments
_CAT_VEC_PY = _py(re.search(r"inline bool concat_vec\([^)]*\) \{\s*return (.*?);\s*\}", SOURCE,
                            re.S).group(1))
_CAT_LAUNCHER = SOURCE[SOURCE.index('extern "C" int bs_probe_cat('):]
_CAT_REFUSE_PY = _py(re.search(r"if \((.*?)\) return \(int\)cudaErrorInvalidValue;",
                               _CAT_LAUNCHER).group(1))


def cat_vector_path(a_addr, b_addr, out_addr, na, nb):
    """Whether bs_probe_cat takes concat_kernel (else the scalar kernel)."""
    return bool(eval(_CAT_VEC_PY, {}, dict(a=a_addr, b=b_addr, out=out_addr, na=na, nb=nb,
                                            aligned16=lambda p: p % 16 == 0)))


def cat_refused(na, nb):
    """Whether bs_probe_cat refuses the counts (an error, nothing launched)."""
    return bool(eval(_CAT_REFUSE_PY, {}, dict(na=na, nb=nb, INT_MAX=INT_MAX)))


def cat_grid(na, nb, vec):
    """(CTAs of a, CTAs in all) of the split 1-D grid."""
    if vec:
        per = CP_NT * CP_LOADS
        ba = -(-(na // 4) // per)
        return ba, ba + -(-(nb // 4) // per)
    ba = -(-na // CP_NT)
    return ba, ba + -(-nb // CP_NT)


def walk_cat(a, b, a_addr=0, b_addr=0, out_addr=0):
    """bs_probe_cat thread by thread on flat f32 ``a`` and ``b``: returns
    (out, vec, CTAs of a, CTAs in all).  A CTA below ``ba`` copies a to
    out, the others b to out + na; on the vector path each half is the
    strided copy's body at S = 1 (CP_LOADS vectors a thread CP_NT apart,
    every load in its buffer and 16-byte aligned), on the scalar path one
    float a thread.  Asserts every output written exactly once."""
    na, nb = a.size, b.size
    assert not cat_refused(na, nb)
    vec = cat_vector_path(a_addr, b_addr, out_addr, na, nb)
    ba, nblocks = cat_grid(na, nb, vec)
    out = np.full(na + nb, np.nan, np.float32)
    writes = np.zeros(na + nb, np.int64)
    for cta in range(nblocks):
        first = cta < ba
        src, addr, base = (a, a_addr, 0) if first else (b, b_addr, na)
        k = cta if first else cta - ba
        if vec:
            m = src.size // 4
            v = k * CP_NT * CP_LOADS + np.arange(CP_NT)[:, None] + CP_NT * np.arange(CP_LOADS)
            v = v[v < m]                                 # the vectors loaded and stored
            assert (4 * v + 4 <= src.size).all() and ((addr + 16 * v) % 16 == 0).all()
            assert ((out_addr + 4 * base + 16 * v) % 16 == 0).all()
            lanes = (4 * v[:, None] + np.arange(4)).ravel()
        else:
            lanes = k * CP_NT + np.arange(CP_NT)
            lanes = lanes[lanes < src.size]
        np.add.at(writes, base + lanes, 1)
        out[base + lanes] = src[lanes]
    assert (writes == 1).all()                           # every output once
    return out, vec, ba, nblocks


@pytest.fixture(scope="module")
def cat_cases():
    """probe_hopper.cat_cases on the CPU, by name."""
    return {name: (k, p, vec) for name, k, p, vec in probe_hopper.cat_cases("cpu")}


CAT_VIEWS = ["P5 original, a off 16 bytes", "P5 original, b off 16 bytes"]


@pytest.mark.parametrize("name", sorted(probe_hopper.CAT_SHAPES) + CAT_VIEWS)
def test_concat_walk_is_the_plain_twin(cat_cases, name):
    """Each of probe_hopper's concat cases (the ones the card checks) on
    the path bs_probe_cat picks for its tensors' alignment: the split grid
    covers every output float once, each CTA from one source, and the
    result is bit for bit concat_plain (which the wrapper runs on the
    CPU)."""
    kernel, plain, want_vec = cat_cases[name]
    a, b = kernel.args
    got, vec, ba, nblocks = walk_cat(a.numpy().ravel(), b.numpy().ravel(),
                                     a.data_ptr() % 16, b.data_ptr() % 16)
    assert vec == want_vec
    want = plain().numpy()
    assert np.array_equal(got.reshape(want.shape), want)
    assert np.array_equal(kernel().numpy(), want)
    assert (ba == 0) == (a.numel() == 0) and (nblocks == ba) == (b.numel() == 0)


def test_concat_launch_arguments():
    """The wrapper passes a's and b's float counts, and P5 launches one
    kernel a call whose CTAs pick their source once, from blockIdx.x."""
    body = WRAPPERS[WRAPPERS.index("def concat("):]
    assert re.search(r'_build\.launch\("bs_probe_cat", a\.data_ptr\(\), b\.data_ptr\(\), '
                     r'out\.data_ptr\(\), a\.numel\(\),\s*b\.numel\(\)\)', body)
    assert _CAT_LAUNCHER.count("<<<") == 2 and "cat_kernel<<<" not in SOURCE.replace(
        "concat_kernel<<<", "")
    for kernel in ("concat_kernel", "concat_scalar_kernel"):
        k = SOURCE[SOURCE.index(f"\n{kernel}("):]
        k = k[:k.index("\n}\n")]
        assert "const bool first = (int)blockIdx.x < ba;" in k
    assert "copy_vectors<1>(" in SOURCE[SOURCE.index("\nconcat_kernel("):]


def test_concat_vector_path_clauses():
    """concat_vec: whole vectors on both sides, every non-empty source and
    the output aligned; an empty source's pointer does not count."""
    assert cat_vector_path(0, 0, 0, 8, 12)
    assert not cat_vector_path(0, 0, 0, 8, 13) and not cat_vector_path(0, 0, 0, 6, 12)
    assert not cat_vector_path(4, 0, 0, 8, 12) and not cat_vector_path(0, 8, 0, 8, 12)
    assert not cat_vector_path(0, 0, 4, 8, 12)
    assert cat_vector_path(4, 0, 0, 0, 12) and cat_vector_path(0, 4, 0, 8, 0)


@pytest.mark.parametrize("na,nb", [(0, 4), (4, 0), (0, 1), (1, 0), (3, 0), (2056, 6168),
                                   (CP_NT * CP_LOADS * 4, 4), (5, CP_NT + 1)])
def test_concat_split_at_edges(na, nb):
    """An empty source gets no CTA; a source that ends inside a CTA (a
    partial last CTA, a partial last vector) leaves nothing unwritten and
    writes nothing twice, on both paths (the scalar one by an output off
    16 bytes)."""
    rng = np.random.default_rng(na * 7 + nb)
    a, b = rng.random(na, np.float32), rng.random(nb, np.float32)
    for out_addr in (0, 4):
        got, vec, ba, nblocks = walk_cat(a, b, out_addr=out_addr)
        assert np.array_equal(got, np.concatenate([a, b]))
        assert vec == (out_addr == 0 and na % 4 == 0 and nb % 4 == 0)
        assert (ba == 0) == (na == 0) and (nblocks == ba) == (nb == 0)


def test_concat_refuses_past_int_max():
    """A total past INT_MAX floats is refused, not wrapped: at 2**31 floats
    the old launcher's int sum went negative, returned 0 and left the
    output uninitialized."""
    assert not cat_refused(INT_MAX - 4, 4) and not cat_refused(0, INT_MAX)
    assert cat_refused(INT_MAX - 3, 4) and cat_refused(2 ** 30, 2 ** 30)
    assert cat_refused(-1, 4)


def test_concat_grid_at_the_probe_shape():
    """The probe's two (16, 3840) sources: 15360 vectors each in CTAs of
    CP_NT threads, CP_LOADS vectors a thread, half the grid a source: as
    many CTAs a source as P7 has in all."""
    ba, n = cat_grid(16 * 3840, 16 * 3840, True)
    assert n == 2 * ba and ba == grid(16, 3840, 1, True)[0]


@pytest.fixture(scope="module")
def jax_cat():
    return jax_probe_runs(["sublane_concat"])


def test_concat_walk_matches_jax_probe(jax_cat):
    """At the original shape on the vector path: bit for bit the JAX
    ``k_cat`` in interpret mode, on the original's own inputs."""
    got_jax, (a, b), _, _ = jax_cat["sublane_concat"]
    assert a.shape == b.shape == (16, 3840)
    got, vec, _, _ = walk_cat(a.ravel(), b.ravel())
    assert vec
    assert np.array_equal(got.reshape(got_jax.shape), got_jax)
