"""The counting behind the port's bounds, and a reader of a profiled window.

What each of the port's kernels must move and compute (each input read
once, each output written once; operations from the shapes), the card's
published peaks, and the least time a card could take for that work (the
bound): the larger of the bytes over the memory rate and the operations
over the peak of their type.  ``chip_smoke.py`` bounds every kernel with
it; ``tools/roofline_torch.py`` and ``tools/ab_torch.py`` read a
``torch.profiler`` window through :func:`window_rows`, which gives every
kernel the op that launched it and that op's work: the port's
hand-written kernels by their names (:data:`PORT_KERNELS`, the work from
:func:`step_kernel_work`), cuBLAS, cuDNN and ATen kernels by the input
shapes that the profiler recorded for their ATen op (:func:`aten_work`).

A work is (bytes, f32 operations, bf16 operations on the tensor cores).
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..ops.megakernel import DOT_MODES, GEMM_PIECES


@dataclasses.dataclass(frozen=True)
class Peaks:
    """A card's published peaks: memory bytes/s, f32 FLOP/s outside the
    tensor cores, dense bf16 FLOP/s on them."""
    bytes_per_s: float
    f32_flops: float
    bf16_flops: float


# NVIDIA's data sheet, the H100 SXM part (dense rates, 700 W)
H100_SXM = Peaks(3.35e12, 67e12, 989e12)
# by torch.cuda.get_device_name()
PEAKS = {"NVIDIA H100 80GB HBM3": H100_SXM}

# operations a pixel of the d=5 bilateral: 13 taps of 3 subtractions, 3
# absolute values, 2 adds, 3 multiplies for the weight (counting its exp as
# one), 6 for the numerators, 1 for the denominator; then 3 divides
BILATERAL_OPS = 13 * 19 + 3


def peaks_for(device_name: str, hbm_gbs: Optional[float] = None,
              f32_tflops: Optional[float] = None,
              bf16_tflops: Optional[float] = None) -> Peaks:
    """The peaks of the card ``device_name`` from :data:`PEAKS`, any given
    figure replacing the table's; a card not in the table needs all three
    (``--peak-*`` flags of the tools)."""
    known = PEAKS.get(device_name)
    given = (hbm_gbs, f32_tflops, bf16_tflops)
    if known is None and None in given:
        raise ValueError(f"no published peaks for {device_name!r}: give the memory GB/s, "
                         f"the f32 TFLOP/s and the dense bf16 TFLOP/s (--peak-hbm-gbs, "
                         f"--peak-f32-tflops, --peak-bf16-tflops)")
    base = known or Peaks(0.0, 0.0, 0.0)
    return Peaks(base.bytes_per_s if hbm_gbs is None else hbm_gbs * 1e9,
                 base.f32_flops if f32_tflops is None else f32_tflops * 1e12,
                 base.bf16_flops if bf16_tflops is None else bf16_tflops * 1e12)


def bound(nbytes, ops, bf16_ops=0, peaks: Peaks = H100_SXM) -> Tuple[float, str]:
    """The least time (ms) the card could take: the larger of the bytes
    over the memory rate and the operations over their peak (f32, and
    ``bf16_ops`` on the tensor cores), and which of the two it is."""
    tb = nbytes / peaks.bytes_per_s * 1e3
    to = (ops / peaks.f32_flops + bf16_ops / peaks.bf16_flops) * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


# -- the port's kernels --------------------------------------------------------

def front_work(kw, cout):
    """(bytes, ops) of K1: canvas, parameters and output once; the
    bilateral, round and normalization a canvas pixel, 27 multiply-adds an
    output value."""
    H, W, oh, ow = kw["H"], kw["W"], kw["oh"], kw["ow"]
    nbytes = 4 * (3 * (H + 4) * (W + 4) + 28 * cout + 13 + cout * oh * ow)
    return nbytes, (BILATERAL_OPS + 9) * H * W + 2 * 27 * cout * oh * ow


def gemm_work(co, ci, L, terms=3):
    """(bytes, f32 ops, bf16 ops) of one GEMM: x, the bias and y in f32 and
    the split weights (``GEMM_PIECES[terms]`` bf16 pieces, ci padded to 8)
    moved once; ``terms`` bf16 products of 2 * co * ci * L operations on
    the tensor cores."""
    kp = ci + (-ci % 8)
    return (4 * (ci * L + co + co * L) + GEMM_PIECES[terms] * 2 * co * kp, 0,
            terms * 2 * co * ci * L)


def gemm_ops(plan):
    """The plan ops (1x1 convs) that ``plan``'s table runs as GEMM ops."""
    return [plan.plan[m["idx"][0]] for m in plan.mega.ops if m["kind"] == "gemm"]


def cont_work(plan):
    """(bytes, f32 ops, bf16 ops) of a flat plan (K2''): its work() with the
    GEMMs' multiply-adds moved to the tensor cores, as many passes as its
    dots' terms (3 for "bf16x3", 6 for "bf16x6")."""
    nbytes, flops = plan.work()
    mm = sum(2 * plan.weights[p[3]].size * plan.meta[p[1]].rows * plan.meta[p[1]].w
             for p in gemm_ops(plan))
    return nbytes, flops - mm, DOT_MODES[plan.dots][1] * mm


def bf16_work(plan):
    """(bytes, f32 ops, bf16 ops) of a bf16 plan: its work() with the dots'
    multiply-adds (1x1 convs and FCs, operands bf16) at the bf16 rate."""
    nbytes, flops = plan.work()
    mm = sum(2 * plan.weights[p[3]].size * (1 if plan.meta[p[1]].vec
                                            else plan.meta[p[1]].rows * plan.meta[p[1]].w)
             for p in plan.plan if p[0] == "conv1x1")
    return nbytes, flops - mm, mm


def plan_work(plan):
    """(bytes, f32 ops, bf16 ops) of a body plan in its own dots: a bf16
    plan's :func:`bf16_work`, a flat plan's :func:`cont_work`, else its
    work() all in f32."""
    if plan.dots == "bf16":
        return bf16_work(plan)
    if plan.flat:
        return cont_work(plan)
    return (*plan.work(), 0)


def pack_yuyv_work(h, w):
    """(bytes, ops) of K3 at h x w: frame, background and mask read, YUYV
    written (9 B a pixel); ~30 integer operations a pixel."""
    return 9 * h * w, 30 * h * w


def pack_420_work(h, w):
    """(bytes, ops) of K4 at h x w: 7 B read and 1.5 B written a pixel;
    ~35 integer operations a pixel."""
    return 17 * h * w // 2, 35 * h * w


def bilateral_work(pixels):
    """(bytes, ops) of K5 over ``pixels`` canvas pixels: 3 f32 in and out a
    pixel; :data:`BILATERAL_OPS` a pixel."""
    return 24 * pixels, BILATERAL_OPS * pixels


def jpeg_decode_work(coefs: Sequence[np.ndarray], w, h):
    """(bytes, ops) of ``bs_jpeg_decode``: the coefficient planes in, BGR
    out; ~22 integer operations a coefficient a pass (two passes), ~30 a
    pixel."""
    return (sum(c.nbytes for c in coefs) + 3 * w * h,
            44 * sum(c.size for c in coefs) + 30 * w * h)


# the port's hand-written kernels: a fragment of the device kernel's name
# (csrc/*.cu) -> its row's name
PORT_KERNELS = {
    "front_kernel": "K1 front",
    "body_mega_kernel": "K2 body plan",
    "gemm_wg_kernel": "K2'' GEMM, wgmma tile (probe)",
    "splitk_sum_kernel": "K2'' GEMM split-K sum",
    "blend_pack_yuyv_kernel": "K3 blend + YUYV",
    "blend_pack_420_kernel": "K4 blend + 4:2:0",
    "bilateral_kernel": "K5 bilateral",
    "jpeg_decode_kernel": "JPEG decode",
}


def port_kernel(name: str) -> Optional[str]:
    """The :data:`PORT_KERNELS` key whose fragment ``name`` holds, or None."""
    for frag in PORT_KERNELS:
        if frag in name:
            return frag
    return None


def step_kernel_work(pipe, batch: int = 1) -> Dict[str, List[tuple]]:
    """The work of each hand-written kernel that one ``FramePipeline``
    step (``batch`` > 1: one ``step_batch`` of that many frames) launches,
    by :data:`PORT_KERNELS` key, as a list in launch order (deeplab's
    two body plans: the prefix, then the continuation).  A stream batch is
    one launch of each kernel over ``batch`` frames."""
    mg = pipe.maskgen
    e, (w, h), s = mg.edge, (pipe.cfg.width, pipe.cfg.height), batch
    fmt = pipe.cfg.output_format
    out: Dict[str, List[tuple]] = collections.defaultdict(list)

    def add(key, work):
        out[key].append(tuple(s * v for v in (tuple(work) + (0,))[:3]))

    if e is not None:
        # the front parameters: 27 weights and a bias an output channel, 13 more
        add("front_kernel", front_work(e.front_kwargs(), (e.front_params.numel() - 13) // 28))
        for plan in e.plans:
            add("body_mega_kernel", plan_work(plan))
    elif mg.use_bilateral:
        ih, iw = mg.model.input_shape[1:3]
        add("bilateral_kernel", bilateral_work(ih * iw))
    if fmt == "yuyv":
        add("blend_pack_yuyv_kernel", pack_yuyv_work(h, w))
    elif fmt in ("nv12", "i420"):
        add("blend_pack_420_kernel", pack_420_work(h, w))
    return dict(out)


# -- ATen ops ------------------------------------------------------------------

_DTYPE_BYTES = {"float": 4, "c10::BFloat16": 2, "c10::Half": 2, "double": 8,
                "unsigned char": 1, "signed char": 1, "bool": 1, "int": 4,
                "long int": 8, "short int": 2}
_MATMUL = {"aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm", "aten::matmul"}
_CONV = {"aten::cudnn_convolution", "aten::convolution", "aten::_convolution",
         "aten::conv2d", "aten::mkldnn_convolution", "aten::thnn_conv2d",
         "aten::_slow_conv2d_forward"}
# ops that move no data of their own (views, allocations, wrappers whose
# children do the work)
_NO_DATA = {"aten::view", "aten::reshape", "aten::_reshape_alias", "aten::as_strided",
            "aten::expand", "aten::expand_as", "aten::permute", "aten::transpose",
            "aten::t", "aten::unsqueeze", "aten::squeeze", "aten::slice", "aten::select",
            "aten::narrow", "aten::movedim", "aten::unflatten", "aten::flatten",
            "aten::detach", "aten::alias", "aten::lift_fresh", "aten::resolve_conj",
            "aten::resolve_neg", "aten::empty", "aten::empty_strided", "aten::empty_like",
            "aten::resize_", "aten::to", "aten::_to_copy", "aten::contiguous",
            "aten::unbind", "aten::split", "aten::chunk", "aten::numpy_T", "aten::__getitem__",
            "aten::_unsafe_view", "aten::unfold", "aten::broadcast_to", "aten::item",
            "aten::_local_scalar_dense", "aten::record_stream", "aten::set_",
            "aten::is_nonzero", "aten::result_type", "aten::_nnpack_available"}


def _numel(shape) -> int:
    return int(np.prod(shape)) if shape else 1


def _bytes(dtype: str) -> int:
    return _DTYPE_BYTES.get(dtype, 4)


def _broadcast(shapes) -> list:
    nd = max(len(s) for s in shapes)
    out = []
    for i in range(nd):
        dims = [s[len(s) - nd + i] for s in shapes if len(s) - nd + i >= 0]
        out.append(max(dims) if 0 not in dims else 0)
    return out


def aten_work(name: str, shapes, dtypes, concrete=None) -> Tuple[int, int, str]:
    """(bytes, operations, how) of one call of ATen op ``name`` from the
    input shapes and dtypes the profiler recorded: each tensor input read
    once and the output written once.  Matrix products (``mm``,
    ``addmm``, ``bmm``, ``baddbmm``) 2·M·N·K operations; convolutions 2
    multiply-add operations an output value and input channel a tap (the
    output's spatial size from the recorded stride, padding and dilation);
    ``copy_`` a read and a write and no operation; views, allocations and
    conversions whose ``copy_`` does the work (:data:`_NO_DATA`) nothing;
    any other op one operation an output element, its output the broadcast
    of its tensor inputs.  ``how`` names the rule."""
    if name in _NO_DATA:
        return 0, 0, "no data of its own"
    tensors = [(list(s), d) for s, d in zip(shapes, dtypes) if s]
    if not tensors:
        return 0, 0, "no tensor inputs"
    db = _bytes(tensors[0][1])
    if name in _MATMUL and len(tensors) >= 2 and min(len(s) for s, _ in tensors[-2:]) >= 2:
        # mm(a, b), bmm(a, b), matmul(a, b) (batch dims broadcast);
        # addmm(bias, a, b), baddbmm(bias, a, b)
        (a, _), (b, _) = tensors[-2], tensors[-1]
        batch = _numel(_broadcast([a[:-2], b[:-2]])) if len(a) + len(b) > 4 else 1
        m, k, n = a[-2], a[-1], b[-1]
        nbytes = db * (sum(_numel(s) for s, _ in tensors) + batch * m * n)
        return nbytes, 2 * batch * m * n * k, "2·M·N·K"
    if name in _CONV and len(tensors) >= 2:
        x, wt = tensors[0][0], tensors[1][0]
        if len(x) == 4 and len(wt) == 4:
            st, pad, dil = _conv_params(name, concrete)
            oh = (x[2] + 2 * pad[0] - dil[0] * (wt[2] - 1) - 1) // st[0] + 1
            ow = (x[3] + 2 * pad[1] - dil[1] * (wt[3] - 1) - 1) // st[1] + 1
            out = x[0] * wt[0] * oh * ow
            nbytes = db * (_numel(x) + _numel(wt) + out + (wt[0] if len(tensors) > 2 else 0))
            return nbytes, 2 * out * wt[1] * wt[2] * wt[3], "2·out·Cin/g·kh·kw"
    if name in ("aten::copy_", "aten::clone"):
        src, sd = tensors[-1]           # copy_(dst, src); clone(src)
        return _numel(src) * (_bytes(sd) + _bytes(tensors[0][1])), 0, "copy"
    out = _numel(_broadcast([s for s, _ in tensors]))
    nbytes = sum(_numel(s) * _bytes(d) for s, d in tensors) + out * db
    return nbytes, out, "elementwise"


def _conv_params(name, concrete):
    """(stride, padding, dilation) of a recorded convolution, (1, 1), (0,
    0), (1, 1) where the profiler kept no concrete value."""
    # aten::convolution / _convolution / conv2d / cudnn_convolution:
    # (input, weight, bias?, stride, padding, dilation, ...); cudnn has no bias
    first = 2 if name == "aten::cudnn_convolution" else 3
    vals = []
    for i in range(first, first + 3):
        v = concrete[i] if concrete and i < len(concrete) else None
        vals.append(tuple(v) if isinstance(v, (list, tuple)) and len(v) == 2 else None)
    return (vals[0] or (1, 1), vals[1] or (0, 0), vals[2] or (1, 1))


# -- the reader ----------------------------------------------------------------

@dataclasses.dataclass
class Row:
    """One op of a profiled window: ``op`` (a port kernel's row name, or an
    ATen op with its input shapes), the kernels it launched, their time
    (µs, summed over the window), calls, and one call's bytes and
    operations (f32 and bf16) where known."""
    op: str
    kernels: set
    us: float = 0.0
    ids: set = dataclasses.field(default_factory=set)
    nbytes: Optional[int] = None
    ops: int = 0
    bf16_ops: int = 0
    how: str = ""

    @property
    def calls(self) -> int:
        return len(self.ids)


def _aten_parent(e):
    """The innermost ``aten::`` op at or above profiler event ``e``."""
    while e is not None and not e.name.startswith("aten::"):
        e = e.cpu_parent
    return e


def _target(op):
    """The op whose row a call of ATen op ``op`` joins: the outermost matrix
    product or convolution at or above it (its children are its own work),
    else ``op``."""
    t, e = op, op
    while e is not None:
        if e.name in _MATMUL or e.name in _CONV:
            t = e
        e = e.cpu_parent
    return t


def _kineto_dtypes(prof) -> dict:
    """Each CPU op's input dtypes by its id, from the profiler's kineto
    events: a ``FunctionEvent`` keeps them as ``input_dtypes`` only in
    newer PyTorch releases."""
    try:
        events = prof.profiler.kineto_results.events()
        return {k.correlation_id(): list(k.dtypes()) for k in events}
    except (AttributeError, RuntimeError, TypeError):
        return {}


def _op_work(t, dtypes: dict) -> tuple:
    """(bytes, operations, 0, how) of one call of ATen op event ``t``."""
    dt = getattr(t, "input_dtypes", None) or dtypes.get(t.id)
    note = "" if dt else " (no dtypes recorded: 4 B an element)"
    nbytes, ops, how = aten_work(t.name, t.input_shapes, dt or ["float"] * len(t.input_shapes),
                                 getattr(t, "concrete_inputs", None) or [])
    return nbytes, ops, 0, how + note


def _op_key(op) -> str:
    """A row's key: the op's name and input shapes (the name alone for an
    op that moves no data of its own)."""
    if op.name in _NO_DATA:
        return op.name
    return f"{op.name} {[list(s) for s in op.input_shapes]}"


def window_rows(prof, device: str, port_work: Optional[Dict[str, List[tuple]]] = None,
                skip=("spin_kernel", "_sleep")) -> Tuple[List[Row], float]:
    """The rows of a ``torch.profiler`` window (recorded with
    ``record_shapes=True``) and their busy time (µs, the sum of the rows).

    ``device="cuda"``: every device kernel (names holding one of ``skip``
    left out: the uncounted sleep that opens a window), by the op that
    launched it.  A kernel of :data:`PORT_KERNELS` takes its row and its
    work from ``port_work`` (:func:`step_kernel_work`: the i-th launch of a
    name takes the (i mod n)-th work of its list); any other kernel the
    ATen op at or above the CPU event that holds it in its ``kernels``, and
    that op's :func:`aten_work`; what no event holds, one row.
    ``device="cpu"``: every ATen op's self time on the host (no device
    exists: these are host times).  A call joins the row of
    the outermost matrix product or convolution above it, else its own
    (:func:`_target`); rows are keyed by op name and input shapes."""
    from torch.autograd import DeviceType
    events = list(prof.events())
    dtypes = {} if events and hasattr(events[0], "input_dtypes") else _kineto_dtypes(prof)
    rows: Dict[str, Row] = {}
    seen = collections.Counter()

    def row_for(key, kernel, work=None):
        r = rows.get(key)
        if r is None:
            r = rows[key] = Row(key, set())
            if work is not None:
                r.nbytes, r.ops, r.bf16_ops, r.how = work
        r.kernels.add(kernel)
        return r

    if device == "cpu":
        for e in events:
            if e.device_type != DeviceType.CPU or not e.name.startswith("aten::"):
                continue
            t = _target(e)
            r = row_for(_op_key(t), e.name, _op_work(t, dtypes))
            r.us += e.self_cpu_time_total
            r.ids.add(t.id)
    else:
        # the profiler hands each device kernel to the CPU event whose
        # correlation id it carries (the op open at its launch), in that
        # event's ``kernels`` as (name, device, duration); the port's
        # kernels, launched by ctypes with no op open, are read from the
        # device events by name, in start order
        total = 0.0
        for e in events:
            if e.device_type == DeviceType.CUDA:
                if not any(x in e.name for x in skip):
                    total += e.time_range.end - e.time_range.start
                continue
            for k in e.kernels:     # (an op's own name: a legacy profiler's total)
                if k.name == e.name or port_kernel(k.name) is not None \
                        or any(x in k.name for x in skip):
                    continue
                op = _aten_parent(e)
                if op is None:
                    r = row_for(f"(no op) {k.name[:60]}", k.name)
                    r.ids.add(("event", e.id))
                else:
                    t = _target(op)
                    r = row_for(_op_key(t), k.name, _op_work(t, dtypes))
                    r.ids.add(("op", t.id))
                r.us += k.duration
        port = sorted((e for e in events if e.device_type == DeviceType.CUDA
                       and port_kernel(e.name) is not None),
                      key=lambda e: e.time_range.start)
        for k in port:
            frag = port_kernel(k.name)
            works = (port_work or {}).get(frag)
            label = PORT_KERNELS[frag]
            if works:
                i = seen[frag] % len(works)
                seen[frag] += 1
                nbytes, nops, bf16 = works[i]
                key = label if len(works) == 1 else f"{label} #{i + 1}"
                r = row_for(key, k.name, (nbytes, nops, bf16, "the port's counting"))
            else:
                r = row_for(label, k.name)
            r.us += k.time_range.end - k.time_range.start
            r.ids.add(("kernel", k.id))
        # device kernels that no CPU op holds and that are not the port's
        rest = total - sum(r.us for r in rows.values())
        if rest > 1e-6 * total:
            rows["(launched by no op)"] = Row("(launched by no op)", set(), rest)
    out = sorted(rows.values(), key=lambda r: -r.us)
    return out, sum(r.us for r in out)
