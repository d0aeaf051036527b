"""The per-op roofline and A/B tools over the port, on the CPU.

``backscrub_tpu_torch/utils/roofline.py`` holds the counting that
``chip_smoke.py`` bounds every kernel with (checked here against the
figures the script wrote inline before), the peaks by card name, and the
reader of a profiled window; ``tools/roofline_torch.py`` and
``tools/ab_torch.py`` run with ``--device cpu`` at a small size (their
rows are host times there).  Bars: counts exactly; the rows' times add up
to the window's busy time; the A/B mask dump byte-equal to
``FramePipeline``'s on the same frame, and to the JAX package's within
the tolerance invariant (at most 2% of the frame's bytes differ).
"""

import ast
import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from backscrub_tpu.pipeline.frame import FramePipeline as JaxPipeline
from backscrub_tpu.pipeline.frame import PipelineConfig as JaxConfig
from backscrub_tpu_torch.io.streams import SyntheticJpegCamera
from backscrub_tpu_torch.pipeline.frame import FramePipeline, PipelineConfig
from backscrub_tpu_torch.utils import roofline as rl

ROOT = pathlib.Path(__file__).resolve().parent.parent
TOOLS = ROOT / "tools"
if str(TOOLS) not in sys.path:
    sys.path.insert(0, str(TOOLS))

import ab_torch  # noqa: E402
import roofline_torch  # noqa: E402

LITE = str(ROOT / "tests" / "data" / "segm_synth_lite_96x160.tflite")
DEEPLAB = str(ROOT / "tests" / "data" / "deeplab_synth_257.tflite")
W, H = 160, 120
FRAME_TOL = 0.02


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """The plain ops at these sizes run faster on 2 intra-op threads than on
    one per core when several test workers share the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def test_counting_keeps_the_figures_chip_smoke_wrote():
    """The moved functions give the figures of the formulas
    ``chip_smoke.py`` wrote inline, and the six-term GEMM reads three
    weight pieces and makes six passes."""
    co, ci, L = 256, 512, 1089
    assert rl.gemm_work(co, ci, L) == (4 * (ci * L + co + co * L) + 2 * 2 * co * ci, 0,
                                       3 * 2 * co * ci * L)
    assert rl.gemm_work(co, ci, L, terms=1) == (4 * (ci * L + co + co * L) + 2 * co * ci, 0,
                                                2 * co * ci * L)
    assert rl.gemm_work(co, ci, L, terms=6) == (4 * (ci * L + co + co * L) + 3 * 2 * co * ci, 0,
                                                6 * 2 * co * ci * L)
    assert rl.gemm_work(21, 20, 5)[0] == 4 * (20 * 5 + 21 + 21 * 5) + 2 * 2 * 21 * 24
    assert rl.pack_yuyv_work(480, 640) == (9 * 480 * 640, 30 * 480 * 640)
    assert rl.pack_420_work(480, 640) == (17 * 480 * 640 // 2, 35 * 480 * 640)
    assert rl.bilateral_work(96 * 160) == (24 * 96 * 160, (13 * 19 + 3) * 96 * 160)
    coefs = [np.zeros((60, 80, 64), np.int16), np.zeros((30, 40, 64), np.int16)]
    assert rl.jpeg_decode_work(coefs, 640, 480) == (
        sum(c.nbytes for c in coefs) + 3 * 640 * 480,
        44 * sum(c.size for c in coefs) + 30 * 640 * 480)
    kw = dict(H=96, W=160, oh=48, ow=80)
    assert rl.front_work(kw, 16) == (4 * (3 * 100 * 164 + 28 * 16 + 13 + 16 * 48 * 80),
                                     (rl.BILATERAL_OPS + 9) * 96 * 160 + 2 * 27 * 16 * 48 * 80)
    assert rl.bound(3.35e9, 0) == (pytest.approx(1.0), "bytes")
    assert rl.bound(0, 67e9) == (pytest.approx(1.0), "operations")
    assert rl.bound(1, 0, 989e9) == (pytest.approx(1.0), "operations")


def test_peaks_by_card_name():
    assert rl.peaks_for("NVIDIA H100 80GB HBM3") == rl.H100_SXM == rl.Peaks(3.35e12, 67e12, 989e12)
    assert rl.peaks_for("NVIDIA H100 80GB HBM3", hbm_gbs=2000).bytes_per_s == 2e12
    with pytest.raises(ValueError, match="--peak"):
        rl.peaks_for("Some Other Card", hbm_gbs=1000)
    assert rl.peaks_for("Some Other Card", 1000, 20, 300) == rl.Peaks(1e12, 20e12, 300e12)


def test_step_kernel_work_follows_each_route():
    """A step's hand-written kernels and their work: segm fused (K1, K2,
    K3), classic (K5, K3), deeplab's two plans in launch order, the six-term
    continuation twice the three-term one's tensor-core work; a stream
    batch one launch of S times the work."""
    segm = FramePipeline(LITE, PipelineConfig(width=W, height=H), device="cpu")
    e = segm.maskgen.edge
    work = rl.step_kernel_work(segm)
    assert work == {"front_kernel": [rl.front_work(e.front_kwargs(), 16) + (0,)],
                    "body_mega_kernel": [e.body_plan.work() + (0,)],
                    "blend_pack_yuyv_kernel": [rl.pack_yuyv_work(H, W) + (0,)]}
    assert rl.step_kernel_work(segm, 3)["blend_pack_yuyv_kernel"] == \
        [tuple(3 * v for v in rl.pack_yuyv_work(H, W)) + (0,)]
    classic = FramePipeline(LITE, PipelineConfig(width=W, height=H, edge_fused=False),
                            device="cpu")
    assert rl.step_kernel_work(classic) == {
        "bilateral_kernel": [rl.bilateral_work(96 * 160) + (0,)],
        "blend_pack_yuyv_kernel": [rl.pack_yuyv_work(H, W) + (0,)]}
    by = {}
    for prec in ("highest", "high"):
        dl = FramePipeline(DEEPLAB, PipelineConfig(width=W, height=H), device="cpu",
                           precision=prec)
        by[prec] = rl.step_kernel_work(dl)["body_mega_kernel"]
        assert by[prec] == [rl.plan_work(p) for p in dl.maskgen.edge.plans]
    assert by["highest"][0] == by["high"][0]
    six, three = by["highest"][1], by["high"][1]
    assert six[:2] == three[:2] and six[2] == 2 * three[2] > 0


class _Ev:
    """A profiler event as ``torch.profiler``'s ``events()`` gives it."""

    def __init__(self, id, name, device, start, end, kernels=(), parent=None, shapes=(),
                 dtypes=()):
        from torch.autograd import DeviceType
        self.id, self.name, self.cpu_parent = id, name, parent
        self.device_type = DeviceType.CUDA if device == "cuda" else DeviceType.CPU
        self.time_range = type("R", (), {"start": start, "end": end})()
        self.kernels = list(kernels)
        self.input_shapes, self.input_dtypes, self.concrete_inputs = shapes, dtypes, []


def test_window_rows_on_a_device_trace():
    """The device branch of the reader on a trace of two steps: an ATen
    kernel, held in its launching op's ``kernels``, takes that op's row and
    work (the outermost convolution above cuDNN's), the port's kernels
    (launched with no op open) their rows by name, deeplab's two body plans
    in launch order, a kernel no op holds one row, the window's opening
    sleep left out; the rows add up to the device time."""
    import collections
    kern = collections.namedtuple("Kernel", "name device duration")
    ev, t = [], 0.0

    def dev(name, dur):
        nonlocal t
        ev.append(_Ev(len(ev), name, "cuda", t, t + dur))
        t += dur + 1.0
        return kern(name, 0, dur)

    dev("spin_kernel", 50.0)
    work = {"front_kernel": [(10, 20, 0)], "body_mega_kernel": [(1, 2, 0), (3, 4, 5)],
            "blend_pack_yuyv_kernel": [(7, 8, 0)]}
    for step in range(2):
        dev("void front_kernel<4, 8, 8>(...)", 7.0)
        dev("void body_mega_kernel<0, 3>(...)", 60.0)
        dev("void body_mega_kernel<0, 3>(...)", 330.0)
        mm = dev("sm90_xmma_gemm_f32f32", 3.5)
        addmm = _Ev(100 + step, "aten::addmm", "cpu", t, t, [mm], None,
                    [[16], [64, 32], [32, 16], [], []], ["float"] * 3 + ["Scalar"] * 2)
        conv = _Ev(200 + step, "aten::conv2d", "cpu", t, t, [], None,
                   [[1, 3, 20, 20], [4, 3, 3, 3]], ["float"] * 2)
        cudnn = _Ev(300 + step, "aten::cudnn_convolution", "cpu", t, t,
                    [dev("cudnn_conv_kernel", 2.0)], conv, [[1, 3, 20, 20], [4, 3, 3, 3]],
                    ["float"] * 2)
        ev += [addmm, conv, cudnn]
        dev("void blend_pack_yuyv_kernel<false>(...)", 4.0)
    dev("stray_kernel", 1.5)
    prof = type("P", (), {"events": lambda self: ev})()
    rows, busy = rl.window_rows(prof, "cuda", work)
    by = {r.op: r for r in rows}
    assert busy == pytest.approx(2 * (7 + 60 + 330 + 3.5 + 2 + 4) + 1.5)
    assert by["(launched by no op)"].us == pytest.approx(1.5)
    assert by["K2 body plan #1"].us == 120 and by["K2 body plan #2"].us == 660
    assert (by["K2 body plan #2"].nbytes, by["K2 body plan #2"].ops,
            by["K2 body plan #2"].bf16_ops) == (3, 4, 5)
    assert by["K1 front"].calls == 2 and by["K3 blend + YUYV"].nbytes == 7
    addmm_row = by["aten::addmm [[16], [64, 32], [32, 16], [], []]"]
    assert (addmm_row.nbytes, addmm_row.ops, addmm_row.calls) == (14400, 65536, 2)
    conv_row = by["aten::conv2d [[1, 3, 20, 20], [4, 3, 3, 3]]"]
    assert conv_row.calls == 2 and conv_row.ops == 2 * 4 * 18 * 18 * 27
    assert not any("spin" in r.op for r in rows) and len(rows) == 7

    # an older profiler keeps no input dtypes on its events: they come from
    # its kineto events by id, and without those f32 is taken and said
    for e in ev:
        del e.input_dtypes
    prof.profiler = type("K", (), {"kineto_results": type("R", (), {"events": lambda self: [
        type("E", (), {"correlation_id": lambda self, i=i: i,
                       "dtypes": lambda self: ["unsigned char"] * 3 + ["Scalar"] * 2})()
        for i in (100, 101)]})()})()
    rows, _ = rl.window_rows(prof, "cuda", work)
    by = {r.op: r for r in rows}
    assert by["aten::addmm [[16], [64, 32], [32, 16], [], []]"].nbytes == 14400 // 4
    assert by["aten::conv2d [[1, 3, 20, 20], [4, 3, 3, 3]]"].how.endswith(
        "(no dtypes recorded: 4 B an element)")


def _last_json(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])


@pytest.mark.parametrize("batch", [1, 2])
def test_roofline_torch_on_the_cpu(capsys, tmp_path, batch):
    """Each matrix product's row counts 2·M·N·K from its recorded shapes
    and every row the reader's work for its op; the rows' times add up to
    the busy time, which the window holds; the last line names the device
    and the JSON file holds every row."""
    path = tmp_path / "roofline.json"
    assert roofline_torch.main(["--device", "cpu", "--width", str(W), "--height", str(H),
                                "--steps", "2", "--warmup", "1", "--batch", str(batch),
                                "--top", "5", "--json", str(path)]) == 0
    last = _last_json(capsys.readouterr().out)
    full = json.loads(path.read_text())
    assert last["device"] == {"platform": "cpu", "name": "cpu", "power_limit": None}
    assert last["clock"] == "host" and last["batch"] == batch and len(last["rows"]) == 5
    assert last["rows"] == full["rows"][:5]
    rows = full["rows"]
    assert sum(r["us_per_step"] for r in rows) == pytest.approx(full["busy_us_per_step"])
    assert 0 < full["busy_us_per_step"] <= full["window_us_per_step"]
    products = [r for r in rows if r["how"] == "2·M·N·K"]
    assert products
    for r in products:
        name, shapes = r["op"].split(" ", 1)
        mats = [s for s in ast.literal_eval(shapes) if len(s) >= 2]
        a, b = mats[-2], mats[-1]
        batch_dims = max(int(np.prod(a[:-2])), int(np.prod(b[:-2])))
        assert r["flops"] == 2 * batch_dims * a[-2] * a[-1] * b[-1], r
    for r in rows:
        if r["bytes"] is not None:
            assert r["bound_us"] == pytest.approx(
                rl.bound(r["bytes"], r["flops"] - r["bf16_flops"], r["bf16_flops"])[0] * 1e3
                * r["calls_per_step"])
        assert "gbs" not in r and "share_of_roof" not in r   # no rate from host times


@pytest.fixture(scope="module")
def jpeg(tmp_path_factory):
    path = tmp_path_factory.mktemp("ab_torch") / "frame.jpg"
    path.write_bytes(SyntheticJpegCamera(W, H)())
    return path


def test_ab_torch_on_the_cpu(capsys, tmp_path, jpeg):
    """The mask dump is ``FramePipeline``'s mask of the decoded image from
    a fresh EMA, byte for byte, and the JAX package's within the tolerance
    invariant; the decode map has the model's output size."""
    assert ab_torch.main(["--device", "cpu", "--model", "segm_lite", "--size", f"{W}x{H}",
                          "--iters", "2",
                          "--image", str(jpeg), "--out-dir", str(tmp_path), "--tag", "t"]) == 0
    rec = _last_json(capsys.readouterr().out)
    assert rec["device"]["platform"] == "cpu" and rec["clock"] == "host"
    assert rec["precision"] == "highest" and rec["fused"] and rec["dots"] == ["f32"]
    mask = np.load(tmp_path / "ab_torch_segm_lite_t_mask.npy")
    arg = np.load(tmp_path / "ab_torch_segm_lite_t_arg.npy")
    frame = ab_torch.load_frame(str(jpeg), W, H, torch.device("cpu"))
    pipe = FramePipeline(LITE, PipelineConfig(width=W, height=H), device="cpu")
    assert np.array_equal(mask, pipe.step(frame)[1].numpy())
    jmask = np.asarray(JaxPipeline(LITE, JaxConfig(width=W, height=H)).step(frame.numpy())[1])
    assert mask.shape == jmask.shape == (H, W)
    assert float((mask != jmask).mean()) <= FRAME_TOL
    assert arg.shape == (96, 160) and set(np.unique(arg)) <= {0, 1}


def test_ab_driver_runs_the_five_variants_of_the_jax_driver():
    ours = (TOOLS / "ab_driver_torch.sh").read_text()
    theirs = (TOOLS / "ab_driver.sh").read_text()
    variants = [ln.strip() for ln in theirs.splitlines() if ln.strip().startswith("for v in")]
    assert variants and variants[0] in ours and "tools/ab_torch.py" in ours
    assert subprocess.run(["bash", "-n", str(TOOLS / "ab_driver_torch.sh")]).returncode == 0
