"""The PyTorch port's training path against the JAX package's: the losses
(``train/trainer.py``), the first step's gradients, Adam and AdamW steps
of the ``Trainer``, ``evaluate``, the data pipeline (``train/data.py``),
and checkpoints (``train/checkpoint.py``) that cross between the two
packages, on the committed synthetic segm_lite model at its full 96x160
input, with the synthetic mlkit model as the distillation teacher.

Bars (port against JAX, same numpy-seeded inputs and parameters):
losses on the same outputs rtol 1e-6; first-step gradients rtol 1e-4
with an atol of 1e-4 of each tensor's largest gradient (the two
packages' convolutions sum in other orders); losses over 3 steps rtol
1e-4; parameters after n steps within 2·lr·n everywhere (Adam's early
updates are about lr·sign(g), so a gradient near 0 may take the other
sign), the share off by more than 1e-6 printed; a resumed run's next loss
within 1e-5 relative.
"""

import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from backscrub_tpu.graph.executor import load_model as jax_load_model
from backscrub_tpu.models.specs import ModelSpec as JaxSpec
from backscrub_tpu.models.specs import spec_for_model as jax_spec
from backscrub_tpu.train import checkpoint as jckpt
from backscrub_tpu.train import trainer as jtrainer
from backscrub_tpu.train.data import SegmentationData as JaxData
from backscrub_tpu_torch.graph.executor import load_model
from backscrub_tpu_torch.models.specs import ModelSpec, spec_for_model
from backscrub_tpu_torch.pipeline.image import resize_bilinear_u8_exact
from backscrub_tpu_torch.pipeline.maskgen import MaskGen
from backscrub_tpu_torch.train import checkpoint, trainer
from backscrub_tpu_torch.train.data import SegmentationData
from backscrub_tpu_torch.train.trainer import TrainConfig, Trainer

ROOT = pathlib.Path(__file__).resolve().parent.parent
LITE = str(ROOT / "tests" / "data" / "segm_synth_lite_96x160.tflite")
MLKIT = str(ROOT / "tests" / "data" / "selfie_synth_mlkit_256x256.tflite")
LR, STEPS = 1e-3, 3


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the test run shares a few cores between six
    processes, where torch's default pool (a thread a core) stalls."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def lite():
    return jax_load_model(LITE), load_model(LITE, "cpu"), spec_for_model(LITE)


@pytest.fixture(scope="module")
def batch():
    """Two normalized frames and soft targets at segm_lite's 96x160."""
    rng = np.random.default_rng(21)
    x = rng.random((2, 96, 160, 3), dtype=np.float32)
    yy, xx = np.mgrid[:96, :160]
    blob = np.exp(-(((yy - 48) / 30.0) ** 2 + ((xx - 80) / 40.0) ** 2)).astype(np.float32)
    y = np.clip(np.stack([blob, blob[:, ::-1]]) + rng.normal(0, 0.05, (2, 96, 160)),
                0, 1).astype(np.float32)
    return x, y


def _f32(params):
    return {k: jnp.asarray(np.asarray(v, np.float32)) for k, v in params.items()}


# ---------------------------------------------------------------------------
# losses and gradients


@pytest.mark.parametrize("decode,channels", [("two_channel", 2), ("argmax_not_background", 6),
                                             ("argmax_person", 21), ("threshold", 1)])
def test_losses_match_jax(decode, channels):
    """The four decode rules' losses and person probabilities on the same
    seeded outputs and targets (rtol 1e-6); the threshold head gets
    probabilities, some outside the clamp."""
    rng = np.random.default_rng(channels)
    out = rng.normal(0, 3, (2, 12, 10, channels)).astype(np.float32)
    if decode == "threshold":
        out = np.clip(rng.random(out.shape, dtype=np.float32) * 1.2 - 0.1, 0, 1)
    y = rng.random((2, 12, 10), dtype=np.float32)
    kw = dict(scale=1 / 255.0, offset=0.0, decode=decode, num_classes=channels)
    got = trainer.segmentation_loss(ModelSpec("x", **kw))(torch.from_numpy(out),
                                                         torch.from_numpy(y))
    ref = jtrainer.segmentation_loss(JaxSpec("x", **kw))(jnp.asarray(out), jnp.asarray(y))
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)
    np.testing.assert_allclose(
        trainer.person_probability(torch.from_numpy(out), ModelSpec("x", **kw)).numpy(),
        np.asarray(jtrainer.person_probability(jnp.asarray(out), JaxSpec("x", **kw))),
        rtol=1e-6, atol=1e-7)


def test_unknown_decode_has_no_loss():
    with pytest.raises(ValueError, match="no training loss"):
        trainer.segmentation_loss(ModelSpec("x", 1.0, 0.0, decode="nope"))


def test_first_step_gradients_match_jax(lite, batch):
    """Autograd through the port's lowerings (every op kind segm_lite
    uses: conv, depthwise, FC, hard-swish, pooling, resize, concat, the
    transposed conv) against ``jax.grad`` of the same loss, every
    parameter."""
    jm, tm, spec = lite
    x, y = batch
    jloss = jtrainer.segmentation_loss(jax_spec(LITE))
    jgrads = jax.jit(jax.grad(lambda p: jloss(jm.raw_fn(p, jnp.asarray(x)).astype(jnp.float32),
                                              jnp.asarray(y))))(_f32(jm.params))
    tr = Trainer(tm, spec)
    loss = tr.loss_fn(tm.raw_fn(tr.params, torch.from_numpy(x)), torch.from_numpy(y))
    loss.backward()
    assert set(jgrads) == set(tr.params)
    for k, g in jgrads.items():
        g = np.asarray(g)
        got = tr.params[k].grad
        assert got is not None, k
        np.testing.assert_allclose(got.numpy(), g, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(g).max()), err_msg=k)


@pytest.fixture(scope="module")
def runs(lite, batch, tmp_path_factory):
    """STEPS Adam and AdamW steps of both packages' Trainers from the same
    parameters on the same batch: {weight_decay: (JAX losses, port losses,
    JAX params, port Trainer)}; for Adam also each package's checkpoint
    before the last step, and the JAX Trainer's next loss resumed from the
    port's checkpoint."""
    jm, tm, spec = lite
    x, y = batch
    out, ck = {}, tmp_path_factory.mktemp("ck")
    for wd in (0.0, 1e-2):
        cfg = dict(learning_rate=LR, weight_decay=wd)
        jt = jtrainer.Trainer(jm, jax_spec(LITE), config=jtrainer.TrainConfig(**cfg))
        tt = Trainer(tm, spec, config=TrainConfig(**cfg))
        jl, tl = [], []
        for i in range(STEPS):
            if i == STEPS - 1 and not wd:
                checkpoint.save_checkpoint(str(ck / "port.npz"), tt.params, tt.opt_state, i)
                jckpt.save_checkpoint(str(ck / "jax.npz"), jt.params, jt.opt_state, i)
            jl.append(jt.step(x, y))
            tl.append(tt.step(x, y))
        out[wd] = (jl, tl, {k: np.asarray(v) for k, v in jt.params.items()}, tt)
        if not wd:
            p, o, step = jckpt.load_checkpoint(str(ck / "port.npz"), jt.params, jt.opt_state)
            assert step == STEPS - 1
            jt.params = {k: jnp.asarray(v) for k, v in p.items()}
            jt.opt_state = jax.tree_util.tree_map(jnp.asarray, o)
            out["jax_resumed"] = jt.step(x, y)
    out["dir"] = ck
    return out


@pytest.mark.parametrize("weight_decay", [0.0, 1e-2], ids=["adam", "adamw"])
def test_steps_match_jax_trainer(runs, weight_decay):
    """Three steps of the port's Trainer against the JAX Trainer from the
    same parameters on the same batch: losses rtol 1e-4, parameters within
    2·lr·n."""
    jl, tl, jparams, tt = runs[weight_decay]
    assert isinstance(tt.opt, torch.optim.AdamW if weight_decay else torch.optim.Adam)
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert tl[-1] < tl[0]
    off, total = 0, 0
    for k, v in jparams.items():
        d = np.abs(tt.params[k].detach().numpy() - v)
        assert d.max() <= 2 * LR * STEPS, k
        off, total = off + int((d > 1e-6).sum()), total + d.size
    print(f"{weight_decay=}: {off} of {total} parameters ({100 * off / total:.3f}%) "
          "more than 1e-6 from the JAX Trainer's after 3 steps")
    assert tt.opt_state["count"] == STEPS


def test_evaluate_matches_jax(lite, batch):
    """``evaluate``: the deployed decode rule's IoU exactly, the loss
    rtol 1e-5."""
    jm, tm, spec = lite
    x, y = batch
    got = Trainer(tm, spec).evaluate(x, y)
    ref = jtrainer.Trainer(jm, jax_spec(LITE)).evaluate(x, y)
    assert got["iou"] == ref["iou"] and 0.0 < got["iou"] < 1.0
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-5)


@pytest.fixture
def mesh_of_one():
    """A (1, 1) mesh in a gloo world of one, started in this process and
    torn down after the test."""
    import torch.distributed as dist
    from backscrub_tpu_torch.parallel.mesh import make_mesh
    started = not dist.is_initialized()
    yield make_mesh(1, device="cpu")
    if started:
        dist.destroy_process_group()


def test_refusals(lite, mesh_of_one):
    """An int8 model is refused as in the JAX package, on one device and
    on a mesh."""
    _, tm, spec = lite
    q = load_model(LITE, "cpu", quantize="int8")
    with pytest.raises(ValueError, match="int8"):
        Trainer(q, spec)
    with pytest.raises(ValueError, match="int8"):
        Trainer(q, spec, mesh=mesh_of_one)


def test_mesh_of_one_steps_as_one_card(lite, batch, mesh_of_one):
    """``Trainer(mesh=)`` on a (1, 1) mesh, dp + tp + sp, takes the one-card
    Trainer's steps: every collective runs on a group of one, so the
    losses and parameters are equal, and ``evaluate`` reads the same."""
    _, tm, spec = lite
    x, y = batch
    cfg = TrainConfig(learning_rate=LR, spatial_shard=True)
    one, meshed = Trainer(tm, spec, config=cfg), Trainer(tm, spec, mesh_of_one, cfg)
    assert [meshed.step(x, y) for _ in range(2)] == [one.step(x, y) for _ in range(2)]
    for k, v in one.params.items():
        assert torch.equal(meshed.params[k], v.detach()), k
    assert meshed.evaluate(x, y) == one.evaluate(x, y)


def test_trainer_pins_tf32_off(lite, monkeypatch):
    """``Trainer`` applies the precision policy itself (cuDNN and cuBLAS
    would otherwise train in TF32 on the card)."""
    _, tm, spec = lite
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    Trainer(tm, spec)
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32


# ---------------------------------------------------------------------------
# data


def _arrays(rng):
    """Frames and targets of sizes around segm_lite's 96x160: u8 masks
    and float probabilities, one at the output size."""
    sizes = [(120, 200), (60, 100), (97, 161), (96, 160), (240, 320), (73, 111)]
    frames = [rng.integers(0, 256, s + (3,), np.uint8) for s in sizes]
    targets = [rng.integers(0, 256, s, np.uint8) if i % 2 else
               rng.random(s, dtype=np.float32) for i, s in enumerate(sizes)]
    return frames, targets


@pytest.mark.parametrize("convention", ["person_white", "backscrub"])
def test_from_arrays_matches_jax(lite, convention):
    """Frames bit-equal to the JAX package's (cv2's INTER_LINEAR in u8),
    targets within 1e-6 (cv2's float INTER_LINEAR)."""
    jm, tm, spec = lite
    frames, targets = _arrays(np.random.default_rng(5))
    got = SegmentationData.from_arrays(frames, targets, tm, spec, mask_convention=convention)
    ref = JaxData.from_arrays(frames, targets, jm, jax_spec(LITE), mask_convention=convention)
    np.testing.assert_array_equal(got.x, ref.x)
    np.testing.assert_allclose(got.y, ref.y, rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="mask_convention"):
        SegmentationData.from_arrays(frames, targets, tm, spec, mask_convention="nope")


def test_batches_match_jax(lite):
    """Shuffle, flip and jitter draw the same numbers in the same order:
    every batch bit-equal to the JAX package's for one seed."""
    jm, tm, spec = lite
    frames, targets = _arrays(np.random.default_rng(6))
    ref_ds = JaxData.from_arrays(frames, targets, jm, jax_spec(LITE))
    ds = SegmentationData(ref_ds.x, ref_ds.y, spec)
    got = list(ds.batches(2, rng=np.random.default_rng(3), epochs=2))
    ref = list(ref_ds.batches(2, rng=np.random.default_rng(3), epochs=2))
    assert len(got) == len(ref) == 6
    for (gx, gy), (rx, ry) in zip(got, ref):
        np.testing.assert_array_equal(gx, rx)
        np.testing.assert_array_equal(gy, ry)
    with pytest.raises(ValueError, match="batch_size"):
        next(ds.batches(7))


def test_from_dir_reads_pairs(lite, tmp_path):
    """Matching names pair up, unreadable or unmatched files are skipped,
    and the result equals ``from_arrays`` on the same images."""
    cv2 = pytest.importorskip("cv2")
    _, tm, spec = lite
    rng = np.random.default_rng(7)
    img, msk = tmp_path / "img", tmp_path / "msk"
    img.mkdir(), msk.mkdir()
    frames, masks = [], []
    for i in range(3):
        frames.append(rng.integers(0, 256, (100, 150, 3), np.uint8))
        masks.append((rng.random((50, 75)) > 0.5).astype(np.uint8) * 255)
        cv2.imwrite(str(img / f"{i}.png"), frames[-1])
        cv2.imwrite(str(msk / f"{i}.png"), masks[-1])
    cv2.imwrite(str(img / "lonely.png"), frames[0])
    (img / "broken.png").write_bytes(b"no image")
    (msk / "broken.png").write_bytes(b"no image")
    ds = SegmentationData.from_dir(str(img), str(msk), tm, spec)
    ref = SegmentationData.from_arrays(frames, masks, tm, spec)
    np.testing.assert_array_equal(ds.x, ref.x)
    np.testing.assert_array_equal(ds.y, ref.y)
    with pytest.raises(FileNotFoundError):
        SegmentationData.from_dir(str(img), str(tmp_path), tm, spec)


def test_self_label_with_port_teacher(lite):
    """Distillation labels: the mlkit teacher's masks (its fused path's
    plain versions here) at the teacher's geometry, frames of another size
    resized to it, as soft targets 1 - mask/255 at the student's output."""
    _, tm, spec = lite
    teacher = MaskGen(MLKIT, 160, 96, device="cpu")
    assert teacher.edge is not None
    rng = np.random.default_rng(8)
    frames = [rng.integers(0, 256, (96, 160, 3), np.uint8),
              rng.integers(0, 256, (120, 200, 3), np.uint8)]
    ds = SegmentationData.self_label(frames, teacher, tm, spec)
    teacher.reset()
    masks = [teacher.process(f).numpy() for f in
             (frames[0], resize_bilinear_u8_exact(torch.from_numpy(frames[1]), 96, 160))]
    assert ds.y.shape == (2, 96, 160) and 0.0 <= ds.y.min() and ds.y.max() <= 1.0
    np.testing.assert_array_equal(ds.y, 1.0 - np.stack(masks).astype(np.float32) / 255.0)
    np.testing.assert_array_equal(ds.x, SegmentationData.from_arrays(
        frames, list(ds.y), tm, spec).x)


# ---------------------------------------------------------------------------
# checkpoints


def test_checkpoint_keys_and_roundtrip(lite, batch, tmp_path):
    """The JAX package's key strings, and a port save/load round trip that
    resumes to the same next loss as an uninterrupted run."""
    _, tm, spec = lite
    x, y = batch
    tr = Trainer(tm, spec, config=TrainConfig(learning_rate=LR))
    tr.step(x, y)
    path = str(tmp_path / "ck.npz")
    checkpoint.save_checkpoint(path, tr.params, tr.opt_state, step=1)
    names = set(np.load(path).files)
    k = next(iter(tr.params))
    assert {f"params/['{k}']", "opt/[0]/.count", f"opt/[0]/.mu/['{k}']",
            f"opt/[0]/.nu/['{k}']", "meta/step"} <= names
    assert len(names) == 3 * len(tr.params) + 2
    params, opt, step = checkpoint.load_checkpoint(path, tr.params, tr.opt_state)
    fresh = Trainer(tm, spec, config=TrainConfig(learning_rate=LR))
    fresh.params, fresh.opt_state = params, opt
    assert step == 1 and fresh.opt_state["count"] == 1
    assert fresh.step(x, y) == tr.step(x, y)
    with pytest.raises(KeyError):
        checkpoint.load_checkpoint(path, dict(tr.params, extra=torch.zeros(1)))


def test_checkpoints_cross_packages(lite, batch, runs):
    """A port checkpoint resumed by the JAX Trainer, and a JAX checkpoint
    resumed by the port's: each next loss within 1e-5 of the loss of the
    trainer that wrote it, continuing."""
    _, tm, spec = lite
    x, y = batch
    jl, tl = runs[0.0][:2]
    tr = Trainer(tm, spec, config=TrainConfig(learning_rate=LR))
    p, o, step = checkpoint.load_checkpoint(str(runs["dir"] / "jax.npz"), tr.params,
                                            tr.opt_state)
    tr.params, tr.opt_state = p, o
    assert step == STEPS - 1 and tr.opt_state["count"] == STEPS - 1
    np.testing.assert_allclose(tr.step(x, y), jl[-1], rtol=1e-5)
    np.testing.assert_allclose(runs["jax_resumed"], tl[-1], rtol=1e-5)


@pytest.mark.parametrize("name,argv", [
    ("distill_torch", ["--steps", "2", "--frames", "2"]),
    ("finetune_dir_torch", ["--epochs", "1"])])
def test_examples_run_on_cpu(name, argv, tmp_path, capsys):
    """Both training examples end to end on the CPU: labels or a dataset,
    steps, the export read back."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = tmp_path / "segm_tuned.tflite"
    assert mod.main(argv + ["--device", "cpu", "--out", str(out)]) == 0
    assert "exported 92 tensors" in capsys.readouterr().out
    assert load_model(str(out), "cpu").params.keys() == load_model(LITE, "cpu").params.keys()
