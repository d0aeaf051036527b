"""The port's precision modes against the JAX package, on the CPU: the
per-channel int8 weights (``quant/ptq.py``), the bf16 plans' dots (K2, K2'
and K2'' through ``BodyPlan.run_plain(gemm="bf16")``, and the op tables
walked), the bf16 graph executor, and int8 on the classic stages.  The
bf16 masks are held in tests/test_torch_precision_masks.py.

The JAX bf16 reference runs compiled with XLA's excess precision off
(``compiler_options={"xla_allow_excess_precision": False}``).  With it on,
the default, XLA's CPU compiler may feed a convolution the f32 value of a
fused elementwise producer where the JAX source rounds it to bf16 first
(on the synthetic deeplab model the jitted bf16 program moves 0.9x as far
from the eager one as from f32), so the rounding points would be the
compiler's, not the package's.  Off, the compiled program equals the eager
one, which rounds after every op as the source writes it; the port rounds
where that does (``ops/conv.py``, ``ops/common.py``).

Tolerances:
- ptq: the port's copy equals the JAX module byte for byte (keys, int8
  bytes, scales, ``boundary_keys``), and the port's int8 model carries the
  JAX int8 model's parameters exactly.
- The bf16 dot against the JAX kernel's (interpret mode, DEFAULT: both
  operands rounded to bf16): relative 1e-6, the summation order alone.
- Plans in bf16 (the JAX ``BodyMega`` at ``precision=DEFAULT`` in
  interpret mode): closer to it on average than it is to its own HIGHEST
  run, and no element farther than twice the farthest the bf16 dots move
  one (``test_plan_bf16_matches_jax`` says why not allclose).  The op table
  walked phase by phase against ``run_plain(gemm="bf16")`` at
  allclose(atol=2e-3, rtol=1e-3).
- The bf16 executor: mean |port - JAX bf16| <= 0.5 * mean |JAX bf16 - JAX
  f32| on one preprocessed frame per family, and the port's f32 model
  (the control, a port that ignored bf16) misses that bar.
- ``BodyPlan.rows_on_card`` (the card's op-by-op check of a bf16 table)
  with the walker in the kernel's place: each row equal to its plain row,
  and the control (activations unrounded) off allclose(2e-3, 1e-3) on
  some row of every plan.
- int8 classic against the JAX int8 classic MaskGen, 4 ``SyntheticSource``
  frames at 640x480: both dequantize the same int8 bytes and scales to the
  same f32 weights, so the f32 bars of the family tests hold: the decode
  flip rule (a decode may differ only at a near-tie, |margin| <= 1e-3, the
  EMAs equal wherever none flipped), on model inputs equal to the JAX
  package's bit for bit (the classic preprocess rounds the resize's x.5
  ties as the JAX one, ROADMAP queue 3); no mask byte off by more than 1 outside
  the flips' post footprint, at most 2% of a frame's bytes and, off the
  post's exact x.5 ties, 0.2% of the sequence's differing
  (tests/test_torch_selfie.py ``_Bars``).
"""

import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from backscrub_tpu.graph.executor import load_model as jax_load_model
from backscrub_tpu.io.streams import SyntheticSource
from backscrub_tpu.models.specs import spec_for_model as jax_spec
from backscrub_tpu.ops import megakernel as jmega
from backscrub_tpu.pipeline import edge as jedge
from backscrub_tpu.pipeline.geometry import compute_roi
from backscrub_tpu.pipeline.maskgen import MaskGen as JaxMaskGen
from backscrub_tpu.quant import ptq as jptq
from backscrub_tpu_torch.graph.executor import load_model, params_from_jax
from backscrub_tpu_torch.models.specs import spec_for_model
from backscrub_tpu_torch.ops import megakernel as tmega
from backscrub_tpu_torch.pipeline import edge as tedge
from backscrub_tpu_torch.pipeline.maskgen import MaskGen, preprocess
from backscrub_tpu_torch.quant import ptq

from test_torch_body_mega import walk
from test_torch_selfie import _Bars, post_ties

ROOT = pathlib.Path(__file__).resolve().parent.parent
DATA = ROOT / "tests" / "data"
FAMILIES = {
    "segm_lite": str(DATA / "segm_synth_lite_96x160.tflite"),
    "segm_full": str(DATA / "segm_synth_full_144x256.tflite"),
    "mlkit": str(DATA / "selfie_synth_mlkit_256x256.tflite"),
    "deeplab": str(DATA / "deeplab_synth_257.tflite"),
    "bodypix": str(DATA / "body-pix_synth_050_8_257.tflite"),
}
W, H = 640, 480
DEFAULT = jax.lax.Precision.DEFAULT
NO_EXCESS = {"xla_allow_excess_precision": False}


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def exact_jit(fn, *args):
    """``fn(*args)`` compiled by XLA with its excess precision off."""
    return jax.jit(fn).lower(*args).compile(compiler_options=NO_EXCESS)(*args)


def _geo(model):
    ih, iw = model.input_shape[1:3]
    oh, ow = model.output_shape[1:3]
    return compute_roi(W, H, iw, ih, ow, oh)


# ---------------------------------------------------------------------------
# (a) ptq


@pytest.mark.parametrize("shape,axis", [((3, 3, 16, 32), 3), ((1, 1, 96, 24), 3),
                                        ((5, 5, 1, 40), 3), ((8, 64), 0)])
def test_quantize_per_channel_matches_jax(shape, axis):
    rng = np.random.default_rng(sum(shape))
    w = (rng.standard_normal(shape) * rng.uniform(0.01, 3, shape[axis]).reshape(
        [-1 if a == axis else 1 for a in range(len(shape))])).astype(np.float32)
    w.reshape(-1)[::7] = 0.0
    q, s = ptq.quantize_per_channel(w, axis)
    jq, js = jptq.quantize_per_channel(w, axis)
    assert q.dtype == jq.dtype == np.int8 and s.dtype == js.dtype == np.float32
    assert q.tobytes() == jq.tobytes() and s.tobytes() == js.tobytes()
    for dt, jdt in ((torch.float32, np.float32), (torch.bfloat16, jnp.bfloat16)):
        got = ptq.dequantize(torch.from_numpy(q), torch.from_numpy(s), dt)
        want = np.asarray(jptq.dequantize(jq, js, jdt)).astype(np.float32)
        assert got.dtype == dt and got.float().numpy().tobytes() == want.tobytes()


def test_quantize_params_matches_jax_on_a_mixed_dict():
    """Kernels of 3+ dims and 512+ elements quantize; biases, 2-D FC
    kernels, small tensors, integers and excluded keys (by the base key
    before ``@``) keep their dtype and bytes."""
    rng = np.random.default_rng(1)
    prepared = {"t1@hwio": rng.standard_normal((3, 3, 8, 32)).astype(np.float32),
                "t2@dw": rng.standard_normal((3, 3, 1, 64)).astype(np.float16),
                "t3@hwio": rng.standard_normal((1, 1, 4, 4)).astype(np.float32),
                "t4@ko": rng.standard_normal((64, 64)).astype(np.float32),
                "t5": rng.standard_normal(32).astype(np.float32),
                "t6@hwio": rng.standard_normal((3, 3, 16, 16)).astype(np.float32),
                "t7": np.arange(6, dtype=np.int32)}
    q, s = ptq.quantize_params(prepared, exclude={"t6"})
    jq, js = jptq.quantize_params(prepared, {}, exclude={"t6"})
    assert set(q) == set(jq) == set(prepared) and set(s) == set(js) == {"t1@hwio", "t2@dw"}
    for k in prepared:
        assert q[k].dtype == jq[k].dtype and q[k].tobytes() == jq[k].tobytes(), k
    for k in s:
        assert s[k].tobytes() == js[k].tobytes(), k


@pytest.mark.parametrize("family", list(FAMILIES))
def test_ptq_matches_jax_on_each_model(family):
    """On each synthetic model: the prepared dicts quantize alike (the
    port's f32 store, the JAX store's f16 payloads widened), the boundary
    keys of the folded graphs are equal, the int8 models carry the same
    int8 bytes and scales under the same keys, and ``params_from_jax``
    carries the JAX int8 model's int8 kernels and f32 scales across as
    they are."""
    path = FAMILIES[family]
    jm, tm = jax_load_model(path), load_model(path, "cpu")
    bk = ptq.boundary_keys(tm.graph)
    assert bk == jptq.boundary_keys(jm.graph) and bk
    q, s = ptq.quantize_params(tm.host_params, exclude=bk)
    jq, js = jptq.quantize_params(dict(jm.host_params), jm.weight_meta, exclude=bk)
    assert set(q) == set(jq) and set(s) == set(js) and s
    for k in s:
        assert q[k].tobytes() == jq[k].tobytes() and s[k].tobytes() == js[k].tobytes(), k
    j8, t8 = jax_load_model(path, quantize="int8"), load_model(path, "cpu", quantize="int8")
    assert t8.quantize_mode == j8.quantize_mode == "int8"
    assert set(t8.params) == set(j8.params)
    carried = params_from_jax(j8.params)
    for k, v in j8.params.items():
        v = np.asarray(v)
        if v.dtype == np.int8 or k.endswith("__scale"):
            assert t8.params[k].numpy().tobytes() == v.tobytes(), k
            assert carried[k].dtype == t8.params[k].dtype
            assert carried[k].numpy().tobytes() == v.tobytes(), k


# ---------------------------------------------------------------------------
# (b) the plans' bf16 dots


def _rowpad(x, rs):
    c, h, w = x.shape
    xr = np.zeros((c, h * rs), np.float32)
    for i in range(h):
        xr[:, i * rs:i * rs + w] = x[:, i]
    return xr


def _jax_mega(mk, x):
    """A JAX BodyMega (interpret mode) on (C, H, W) ``x``: rowpad in, dense
    (C, H*W) out at its output spacing."""
    om = mk.out_meta
    y = np.asarray(exact_jit(mk, jnp.asarray(_rowpad(x, mk.rs))))
    return np.stack([y[:, i * mk.rs + np.arange(om.w) * om.sp] for i in range(om.rows)],
                    axis=1).reshape(om.c, -1)


@pytest.fixture(scope="module")
def bf16_models():
    """(family, precision) -> (JAX bf16 model at ``precision``, port bf16
    model, JAX edge info, port edge info) at 640x480."""
    out = {}

    def get(family, precision=DEFAULT):
        if (family, precision) not in out:
            path = FAMILIES[family]
            jm = jax_load_model(path, compute_dtype=jnp.bfloat16, precision=precision)
            tm = load_model(path, "cpu", compute_dtype=torch.bfloat16)
            geo = _geo(tm)
            out[family, precision] = (jm, tm, jedge.edge_applicable(jm, jax_spec(path), geo),
                                      tedge.edge_applicable(tm, spec_for_model(path), geo))
        return out[family, precision]
    return get


def _bf16_plan(bf16_models, family, which):
    """The port's bf16 plan ``which`` of ``family`` and a seeded input (C,
    H, W); K2'' also with the prefix cut it continues from."""
    _, tm, _, tinfo = bf16_models(family)
    if which == "K2":
        plan = tmega.body_plan_for(tm, tinfo, "default")
        im = plan.in_meta
        return plan, (np.random.default_rng(11).standard_normal((im.c, im.rows, im.w)) * 2
                      ).astype(np.float32), None
    pre = tmega.body_plan_prefix_for(tm, tinfo, precision="default")
    if which == "K2'":
        im = pre[0].in_meta
        return pre[0], np.random.default_rng(3).uniform(0, 6, (im.c, im.rows, im.w)).astype(
            np.float32), pre
    plan = tmega.body_plan_continuation_for(tm, tinfo, pre[1], pre[2], precision="default")[0]
    im = plan.in_meta
    return plan, (np.random.default_rng(4).standard_normal((im.c, im.rows, im.w)) * 0.5
                  ).astype(np.float32), pre


def _plan_and_ref(bf16_models, family, which, precision):
    """The port's bf16 plan ``which`` of ``family``, a seeded input (C,
    H*W) and the JAX kernel's output on it with its model at
    ``precision``."""
    jm, _, jinfo, _ = bf16_models(family, precision)
    plan, x, pre = _bf16_plan(bf16_models, family, which)
    if which == "K2":
        return plan, x, _jax_mega(jmega.body_mega_for(jm, jinfo, interpret=True), x)
    jpre = jmega.body_mega_prefix_for(jm, jinfo, interpret=True)
    assert pre[1:] == jpre[1:]
    if which == "K2'":
        return plan, x, _jax_mega(jpre[0], x)
    links = jmega.body_mega_continuation_for(jm, jinfo, jpre[1], jpre[2], interpret=True)[0]
    h = jnp.asarray(x.reshape(plan.in_meta.c, -1))
    for mk in links:
        h = exact_jit(mk, h)
    assert plan.mega.kinds["gemm"] > 0
    return plan, x, np.asarray(h)


PLANS = [("segm_lite", "K2"), ("segm_full", "K2"), ("mlkit", "K2"),
         ("deeplab", "K2'"), ("bodypix", "K2'"), ("deeplab", "K2''")]


@pytest.mark.parametrize("family,which", PLANS)
def test_plan_bf16_matches_jax(bf16_models, family, which):
    """``run_plain(gemm="bf16")`` against the JAX kernel at DEFAULT, and the
    bf16 op table walked against ``run_plain``.

    Not allclose(2e-3, 1e-3): the rounding of every dot operand turns the
    two summation orders' f32 ulps, wherever a value sits at a bf16 rounding
    boundary, into bf16 ulps, which the ops after it carry on and spread.
    Fed the same input, each op agrees with the JAX op to an f32 ulp (the
    first conv of the deeplab continuation, 2.4e-7), but over a span the
    two drift apart: on these inputs the mean distance is 0.4-8% of what
    the bf16 dots move the JAX kernel from its HIGHEST run for K2 and K2'
    (up to 18% on mlkit's 53 phases) and 79% for the 48 dependent ops of
    the deeplab continuation, where a 1-ulp nudge of the input moves the
    plain plan as far.  The bar: the port is on average closer to the JAX
    bf16 kernel than that kernel is to its f32 run, and no element is
    farther from it than twice the farthest the bf16 dots move one (one
    element's cascade reached 0.72x here, 1.08x between the card's kernel
    and its plain twin on mlkit).  The dot itself is held to the JAX one
    tightly in ``test_bf16_dot_matches_jax``."""
    plan, x, ref = _plan_and_ref(bf16_models, family, which, DEFAULT)
    ref_f32 = _plan_and_ref(bf16_models, family, which, jax.lax.Precision.HIGHEST)[2]
    assert plan.dots == plan.mega.dots == "bf16"
    xt = torch.from_numpy(x.reshape(plan.in_meta.c, -1))
    with torch.no_grad():
        got = plan.run_plain(xt, gemm="bf16")
        walked, phases = walk(plan, xt)
        f32 = plan.run_plain(xt)
    assert phases == plan.mega.phases and bool(torch.isfinite(walked).all())
    effect = np.abs(ref - ref_f32)
    dist = np.abs(got.numpy() - ref)
    assert dist.mean() <= effect.mean() and dist.max() <= 2 * effect.max(), \
        (dist.mean(), effect.mean(), dist.max(), effect.max())
    torch.testing.assert_close(walked, got, atol=2e-3, rtol=1e-3)
    assert not torch.equal(got, f32)


@pytest.mark.parametrize("family,which", PLANS)
def test_rows_on_card_with_the_walker_as_kernel(bf16_models, family, which, monkeypatch):
    """``BodyPlan.rows_on_card``, the card's op-by-op check of a bf16
    table, with each launch of the table's first phases played by the
    walker on the CPU: every range a row writes is compared, each equal to
    its plain row on the "kernel's" workspace, and the control (the rows
    with the dots' activations unrounded) misses allclose(2e-3, 1e-3) on
    some row of every plan, so the check on the card, where the kernel
    must meet that bar, tells a kernel that skipped the rounding."""
    plan, x, _ = _bf16_plan(bf16_models, family, which)
    xt = torch.from_numpy(x.reshape(plan.in_meta.c, -1))
    ends = [end for _, end in plan.mega.phase_rows()]
    state = dict(k=0, ws=torch.full((plan._total,), float("nan")))

    def args(x_, n_ops=None):
        buf = torch.empty(plan._total)
        return buf, (buf, n_ops)

    def launch(name, buf, n_ops, stamps):        # the phases in order, as rows_on_card asks
        assert name == "bs_body_mega" and stamps is None
        while state["k"] <= ends.index(n_ops):
            state["ws"] = tmega.walk_phase(plan, xt, state["ws"], state["k"])[0]
            state["k"] += 1
        buf.copy_(state["ws"])

    monkeypatch.setattr(plan, "_mega_args", args)
    monkeypatch.setattr(tmega._build, "launch", launch)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    rows = off = 0
    with torch.no_grad():
        for phase, kind, got, want, ctl in plan.rows_on_card(xt):
            rows += 1
            assert bool(torch.isfinite(want).all()) and torch.equal(got, want)
            off += not torch.allclose(ctl, want, atol=2e-3, rtol=1e-3)
    assert state["k"] == plan.mega.phases and rows >= len(plan.mega.table) and off > 0


@pytest.mark.parametrize("co,ci", [(16, 96), (256, 512), (480, 80)])
def test_bf16_dot_matches_jax(co, ci):
    """The bf16 mode's dot (``conv1x1_bf16_plain``, and ``conv1x1_gemm``
    with one term on CPU tensors) against the JAX kernel's interpret-mode
    DEFAULT dot (both operands rounded to bf16, products summed in f32):
    relative 1e-6, the summation order alone."""
    rng = np.random.default_rng(co + ci)
    w = (rng.standard_normal((co, ci)) / np.sqrt(ci)).astype(np.float32)
    x = rng.uniform(0, 2, (ci, 1089)).astype(np.float32)
    b = rng.standard_normal(co).astype(np.float32)

    def dot_in(a):
        return a.astype(jnp.bfloat16).astype(jnp.float32)
    ref = np.asarray(exact_jit(lambda w, x: jax.lax.dot_general(
        dot_in(w), dot_in(x), (((1,), (0,)), ((), ())), precision=DEFAULT,
        preferred_element_type=jnp.float32), jnp.asarray(w), jnp.asarray(x))) + b[:, None]
    wt, bt, xt = (torch.from_numpy(a) for a in (w, b, x))
    got = tmega.conv1x1_bf16_plain(wt, bt, xt).numpy()
    assert np.abs(got - ref).max() <= 1e-6 * np.abs(ref).max()
    assert torch.equal(tmega.conv1x1_gemm(wt, bt, xt, terms=1), torch.from_numpy(got))
    f32 = tmega.conv1x1_plain(wt, bt, xt).numpy()
    assert np.abs(got - f32).max() > 1e-4 * np.abs(f32).max()


def test_bf16_table_arena_and_shared_memory():
    """The deeplab continuation's bf16 table: every dot weight in the arena
    is a bf16 value, each GEMM op carries W's hi half alone (no lo), and
    its ring asks for less shared memory than the bf16x3 table's."""
    tm = load_model(FAMILIES["deeplab"], "cpu")
    info = tedge.edge_applicable(tm, spec_for_model(FAMILIES["deeplab"]), _geo(tm))
    pre = tmega.body_plan_prefix_for(tm, info)
    tables = {p: tmega.body_plan_continuation_for(tm, info, pre[1], pre[2],
                                                  precision=p)[0].mega
              for p in ("high", "default")}
    assert (tables["high"].dots, tables["default"].dots) == ("bf16x3", "bf16")
    f = {n: i for i, n in enumerate(tmega.MEGA_FIELDS)}
    b16 = tables["default"]
    gemm = b16.table[b16.table[:, f["code"]] == tmega.MEGA_CODES["gemm"]]
    assert len(gemm) and (gemm[:, f["w1"]] == 0).all()
    for row in b16.table[np.isin(b16.table[:, f["code"]], [tmega.MEGA_CODES[k] for k in
                                                          ("conv", "convw", "fc")])]:
        n = row[f["co"]] * row[f["c"]]
        w = torch.from_numpy(b16.arena[row[f["w"]]:row[f["w"]] + n].copy())
        assert torch.equal(w, tmega.bf16_round(w))
    assert b16.smem_bytes <= tables["high"].smem_bytes
    assert b16.arena.size < tables["high"].arena.size


def test_dots_for_and_plan_guards():
    assert [tmega.dots_for(p, False) for p in ("highest", "high", "default")] == \
        ["f32", "f32", "bf16"]
    assert [tmega.dots_for(p, True) for p in ("highest", "high", "default")] == \
        ["bf16x6", "bf16x3", "bf16"]
    with pytest.raises(ValueError, match="precision"):
        tmega.dots_for("fast", False)
    tm = load_model(FAMILIES["segm_lite"], "cpu")
    info = tedge.edge_applicable(tm, spec_for_model(FAMILIES["segm_lite"]), _geo(tm))
    with pytest.raises(ValueError, match="dots"):
        tmega.BodyPlan(tm, info.body_start, info.body_end, info.body_in_tensor,
                       info.body_out_tensor, dots="bf16x3")
    q = load_model(FAMILIES["segm_lite"], "cpu", quantize="int8")
    with pytest.raises(tmega.Unsupported, match="quantized"):
        tmega.BodyPlan(q, info.body_start, info.body_end, info.body_in_tensor,
                       info.body_out_tensor)
    assert tmega.body_plan_for(q, info) is None and tedge.body_plans(q, info) is None


# ---------------------------------------------------------------------------
# (c) the bf16 executor


@pytest.mark.parametrize("family", list(FAMILIES))
def test_executor_bf16_matches_jax(family):
    path = FAMILIES[family]
    tm = load_model(path, "cpu", compute_dtype=torch.bfloat16)
    assert tm.compute_dtype == torch.bfloat16 and tm.quantize_mode is None
    assert all(v.dtype == torch.bfloat16 for v in tm.params.values() if v.is_floating_point())
    frame = torch.from_numpy(SyntheticSource(W, H).read())
    x = preprocess(frame, _geo(tm), spec_for_model(path))[None]
    jb = jax_load_model(path, compute_dtype=jnp.bfloat16, precision=DEFAULT)
    jf = jax_load_model(path)
    xj = jnp.asarray(x.numpy())
    jyb = np.asarray(exact_jit(jb.raw_fn, jb.params, xj).astype(jnp.float32))
    jyf = np.asarray(jf(xj))
    with torch.no_grad():
        y = tm(x)
        y32 = load_model(path, "cpu")(x)
    assert y.dtype == torch.bfloat16 and tuple(y.shape) == jyb.shape
    port, gap = np.abs(y.float().numpy() - jyb).mean(), np.abs(jyb - jyf).mean()
    assert 0 < gap and port <= 0.5 * gap, (port, gap)
    # the control: the port's f32 model, a port that ignored bf16, misses the bar
    assert np.abs(y32.numpy() - jyb).mean() > 0.5 * gap


def test_load_model_refuses_unknown_modes():
    with pytest.raises(ValueError, match="compute_dtype"):
        load_model(FAMILIES["segm_lite"], "cpu", compute_dtype=torch.float16)
    with pytest.raises(ValueError, match="quantize"):
        load_model(FAMILIES["segm_lite"], "cpu", quantize="int4")
    with pytest.raises(ValueError, match="precision"):
        MaskGen(FAMILIES["segm_lite"], W, H, device="cpu", precision="fast")


# ---------------------------------------------------------------------------
# (e) int8 on the classic stages


def _margin(out, spec):
    """The decode's margin a pixel of the model output (H, W, C), f64: it
    changes sign where the decision flips."""
    o = out.double()
    if spec.decode == "two_channel":
        return o[..., 1] - o[..., 0]
    if spec.decode == "threshold":
        return o[..., 0] - spec.threshold
    other = torch.cat([o[..., :spec.person_class], o[..., spec.person_class + 1:]], -1)
    return o[..., spec.person_class] - other.max(-1).values


@pytest.mark.parametrize("family", list(FAMILIES))
def test_int8_classic_matches_jax(family):
    path = FAMILIES[family]
    port = MaskGen(path, W, H, device="cpu", quantize="int8")
    ref = JaxMaskGen(path, W, H, quantize="int8", edge_fused=False)
    assert port.edge is None and port.model.quantize_mode == "int8"
    src = SyntheticSource(W, H)
    bars = _Bars(port.ema_shape)
    for _ in range(4):
        f = src.read()
        mask = port.process(f)
        jmask = np.asarray(ref.process(f))
        ema, jema = port.ema.numpy(), np.asarray(ref.ema)
        with torch.no_grad():
            x = port._pre(torch.from_numpy(f))
            out = port._infer(x)
        jx = ref._pre(jnp.asarray(f))
        np.testing.assert_array_equal(x.numpy(), np.asarray(jx))
        flipped = (ema >> 5) != (jema >> 5)
        bars.ema(ema, jema, _margin(out, port.spec).numpy())
        foot = tedge.post_footprint(torch.from_numpy(ema != jema), port.geo,
                                    port.post_mats).numpy()
        ties = (post_ties(jema, port.geo) if min(port.geo.out_roi.h, port.geo.out_roi.w) >= 64
                else np.zeros_like(foot))
        bars.bytes([((mask.numpy(), jmask), ties)], [foot])
        assert not (flipped & ~bars.ever).any()
    bars.check()


def test_int8_dequantizes_once(monkeypatch):
    """An int8 kernel is dequantized at its first use and kept: a second
    run dequantizes nothing and gives the same bits; replaced parameters
    are dequantized anew; ``.to`` drops the kept values."""
    from backscrub_tpu_torch.graph import executor
    calls = []
    real = executor.dequantize
    monkeypatch.setattr(executor, "dequantize", lambda *a: calls.append(1) or real(*a))
    tm = load_model(FAMILIES["segm_lite"], "cpu", quantize="int8")
    x = torch.from_numpy(np.random.default_rng(5).uniform(
        0, 1, (1,) + tm.input_shape[1:]).astype(np.float32))
    n_int8 = sum(1 for k in tm.params if k + "__scale" in tm.params)
    with torch.no_grad():
        y = tm(x)
        assert len(calls) == n_int8 > 0
        assert torch.equal(tm(x), y) and len(calls) == n_int8
        tm.params = {k: v.clone() for k, v in tm.params.items()}
        assert torch.equal(tm(x), y) and len(calls) == 2 * n_int8
        tm.to("cpu")
        assert tm.dequantized == {}


def test_int8_refuses_the_fused_path():
    """As in the JAX package: ``edge_fused=True`` with int8 raises; the
    default picks the classic stages."""
    path = FAMILIES["segm_lite"]
    with pytest.raises(ValueError):
        MaskGen(path, W, H, device="cpu", quantize="int8", edge_fused=True)
    with pytest.raises(ValueError):
        JaxMaskGen(path, W, H, quantize="int8", edge_fused=True, edge_interpret=True)
    tm = load_model(path, "cpu", quantize="int8")
    assert tedge.edge_applicable(tm, spec_for_model(path), _geo(tm), quantize="int8") is None
