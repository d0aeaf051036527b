"""The port's (data, model) mesh on ``torch.distributed`` (gloo worlds of
2 and 4 processes on the CPU, ``backscrub_tpu_torch/parallel/mesh.py``)
against the JAX mesh at the same shape, (2, 2) from
``backscrub_tpu.parallel.mesh.make_mesh(4)`` on the conftest's 8 virtual
devices, and against the port's one-process runs.

Three worlds are spawned: the checks of ``tests/torch_mesh_ranks.py``
on a world of 4 (one spawn for the module), ``cli_multi --data-axis 2``
(a world of 2) and ``dryrun_multichip(4)``.

Bars:
- the sharding rule picks the same keys as the JAX rule on every
  synthetic family;
- ``MultiStreamRunner`` logits within 2e-4 of the JAX runner's
  (``tests/test_sharding.py``'s bar), the mask decisions equal, and
  within 1e-4 of one process;
- first-step gradients of dp + tp + sp, dp only and tp only within rtol
  1e-4 + 1e-4·max|g| of one process's (a gradient m times too large or
  too small fails); losses over 3 steps rtol 1e-4 against one process
  and against the JAX mesh trainer, parameters within 2·lr·n;
- deeplab's 21-class argmax loss at 257x257 on the (2, 2) mesh as in one
  process, at the same bars;
- a checkpoint written on the mesh resumes on one card (rtol 1e-4) and on
  the mesh (the uninterrupted run's loss exactly), and the export reads
  back as the gathered parameters' f16 rounding;
- the stream batch over "data" byte-equal to one process's batch and to
  the JAX mesh pipeline by ``tests/test_torch_multistream.py``'s bars;
  the servers and the CLI byte-equal to solo steps.
"""

import pathlib

import numpy as np
import pytest
import torch

import jax
from backscrub_tpu.graph.executor import load_model as jax_load_model
from backscrub_tpu.models.specs import spec_for_model as jax_spec
from backscrub_tpu.parallel.mesh import MultiStreamRunner as JaxRunner
from backscrub_tpu.parallel.mesh import make_mesh as jax_make_mesh
from backscrub_tpu.parallel.mesh import param_sharding_spec as jax_sharding_spec
from backscrub_tpu.parallel.streams import MultiStreamPipeline as JaxMultiStream
from backscrub_tpu.pipeline.frame import PipelineConfig as JaxConfig
from backscrub_tpu.train import trainer as jtrainer
from backscrub_tpu_torch import cli_multi
from backscrub_tpu_torch.entry import dryrun_multichip
from backscrub_tpu_torch.graph.executor import load_model
from backscrub_tpu_torch.models.specs import spec_for_model
from backscrub_tpu_torch.parallel.mesh import make_mesh, run_world
from backscrub_tpu_torch.parallel.streams import MultiStreamPipeline
from backscrub_tpu_torch.pipeline import edge as tedge
from backscrub_tpu_torch.pipeline.frame import FramePipeline, PipelineConfig
from backscrub_tpu_torch.train.checkpoint import load_checkpoint
from backscrub_tpu_torch.train.trainer import TrainConfig, Trainer

import torch_mesh_ranks as ranks
from test_torch_cli_multi import _direct
from test_torch_multistream import _margins, _std_ema
from test_torch_selfie import _Bars, _yuyv, post_ties

ROOT = pathlib.Path(__file__).resolve().parent.parent
LITE, DEEPLAB = ranks.LITE, ranks.DEEPLAB
MODES = ("dp_tp_sp", "dp", "tp")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread, as each spawned rank pins."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The (2, 2) world's readings and the directory its checkpoint and
    export went to."""
    d = tmp_path_factory.mktemp("mesh")
    return run_world(ranks.world_checks, 4, "cpu", str(d)), d


@pytest.fixture(scope="module")
def jmesh():
    return jax_make_mesh(4)


@pytest.fixture(scope="module")
def one_process():
    """The port's one-process Trainer over STEPS steps of the same batch:
    (losses, the first step's gradients, the parameters after)."""
    x, y = ranks.lite_batch()
    tr = Trainer(load_model(LITE, "cpu"), spec_for_model(LITE),
                 config=TrainConfig(learning_rate=ranks.LR))
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    tr.loss_fn(tr.model.raw_fn(tr.params, xt), yt).backward()
    grads = {k: p.grad.numpy().copy() for k, p in tr.params.items()}
    tr.opt.zero_grad(set_to_none=True)
    losses = [tr.step(x, y) for _ in range(ranks.STEPS)]
    return losses, grads, {k: v.detach().numpy() for k, v in tr.params.items()}


def _params_within(got, ref, bound):
    assert set(got) == set(ref)
    for k, v in ref.items():
        assert np.abs(np.asarray(got[k]) - np.asarray(v)).max() <= bound, k


# ---------------------------------------------------------------------------
# the mesh itself


def test_make_mesh_splits_and_refuses_as_jax(world, jmesh):
    """The (2, 2) split of 4, and the JAX ValueErrors; a mesh wider than
    the world, and CUDA asked for and absent, raise."""
    assert world[0]["mesh"] == dict(jmesh.shape) == {"data": 2, "model": 2}
    for kw, msg in ((dict(n_devices=3, data=2), "data=2 does not divide 3 devices"),
                    (dict(n_devices=4, model=3), "model=3 does not divide 4 devices")):
        with pytest.raises(ValueError, match=msg):
            make_mesh(**kw, device="cpu")
        with pytest.raises(ValueError, match=msg):
            jax_make_mesh(**kw)
    with pytest.raises(ValueError, match="needs a world of 2 ranks"):
        make_mesh(2, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_mesh(1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_world(print, 2, "cuda")


def test_param_sharding_spec_picks_jax_keys(world, jmesh):
    """The JAX rule on the (2, 2) JAX mesh, applied to each family's
    parameters (the port keeps the JAX executor's keys and layouts,
    ``graph/executor.py``), picks the keys the port's rule picked on the
    gloo mesh."""
    for name, path in ranks.FAMILIES.items():
        params = load_model(path, "cpu").params
        want = sorted(k for k, v in params.items()
                      if jax_sharding_spec(k, v.numpy(), jmesh) != jax.sharding.PartitionSpec())
        assert world[0]["specs"][name] == want and want, name


def test_runner_matches_jax_runner_and_one_process(world, jmesh):
    got = world[0]["runner"]
    xb = ranks.runner_batch()
    jm = jax_load_model(LITE)
    ref = np.asarray(JaxRunner(jm.raw_fn, jm.params, jmesh)(xb))
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-4)
    np.testing.assert_array_equal(got[..., 1] > got[..., 0], ref[..., 1] > ref[..., 0])
    with torch.no_grad():
        one = load_model(LITE, "cpu")(torch.from_numpy(xb)).numpy()
    np.testing.assert_allclose(got, one, rtol=1e-4, atol=1e-4)


def test_unet_runner_matches_one_process(world):
    """The converted U-Net (tests/test_torch_byo.py) through the runner on
    the (2, 2) world: its convolutions and both builtin TRANSPOSE_CONVs
    split their output channels over "model", the other new kinds read
    their inputs whole; the probabilities within 1e-4 of one process."""
    got = world[0]["unet_runner"]
    with torch.no_grad():
        one = load_model(ranks.UNET, "cpu")(torch.from_numpy(ranks.unet_batch())).numpy()
    assert got.shape == one.shape == (2, 256, 256, 1)
    np.testing.assert_allclose(got, one, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# the train step


@pytest.mark.parametrize("mode", MODES)
def test_first_step_gradients_match_one_process(world, one_process, mode):
    _, grads, _ = world[0][mode]
    ref = one_process[1]
    assert set(grads) == set(ref)
    for k, g in ref.items():
        np.testing.assert_allclose(grads[k], g, rtol=1e-4, atol=1e-4 * float(np.abs(g).max()),
                                   err_msg=k)


@pytest.mark.parametrize("mode", MODES)
def test_steps_match_one_process(world, one_process, mode):
    losses, _, params = world[0][mode]
    np.testing.assert_allclose(losses, one_process[0], rtol=1e-4)
    assert losses[-1] < losses[0]
    _params_within(params, one_process[2], 2 * ranks.LR * ranks.STEPS)


def test_dp_tp_sp_steps_match_jax_mesh_trainer(world, jmesh):
    """The JAX trainer with ``spatial_shard=True`` on its (2, 2) mesh."""
    x, y = ranks.lite_batch()
    jt = jtrainer.Trainer(jax_load_model(LITE), jax_spec(LITE), mesh=jmesh,
                          config=jtrainer.TrainConfig(learning_rate=ranks.LR,
                                                      spatial_shard=True))
    jl = [jt.step(x, y) for _ in range(ranks.STEPS)]
    losses, _, params = world[0]["dp_tp_sp"]
    np.testing.assert_allclose(losses, jl, rtol=1e-4)
    _params_within(params, {k: np.asarray(v) for k, v in jt.params.items()},
                   2 * ranks.LR * ranks.STEPS)


def test_deeplab_argmax_loss_on_a_mesh(world):
    """``tests/test_sharding.py::test_train_deeplab_argmax_loss`` on the
    synthetic deeplab (odd 257x257 rows, the 21-class argmax_person loss):
    the (2, 2) mesh's dp + tp steps as one process's."""
    x, y = ranks.deeplab_batch()
    tr = Trainer(load_model(DEEPLAB, "cpu"), spec_for_model(DEEPLAB),
                 config=TrainConfig(learning_rate=ranks.DEEPLAB_LR))
    ref = [tr.step(x, y) for _ in range(ranks.DEEPLAB_STEPS)]
    losses, params = world[0]["deeplab"]
    assert np.all(np.isfinite(losses))
    np.testing.assert_allclose(losses, ref, rtol=1e-4)
    _params_within(params, {k: v.detach().numpy() for k, v in tr.params.items()},
                   2 * ranks.DEEPLAB_LR * ranks.DEEPLAB_STEPS)


def test_evaluate_on_a_mesh(world):
    x, y = ranks.lite_batch()
    ref = Trainer(load_model(LITE, "cpu"), spec_for_model(LITE)).evaluate(x, y)
    got = world[0]["evaluate_before"]
    assert got["iou"] == ref["iou"] and 0.0 < got["iou"] < 1.0
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-5)
    assert world[0]["evaluate_after"]["loss"] < got["loss"]


def test_mesh_checkpoint_round_trips_to_one_card(world):
    res, d = world
    one = Trainer(load_model(LITE, "cpu"), spec_for_model(LITE),
                  config=TrainConfig(learning_rate=ranks.LR))
    params, opt, step = load_checkpoint(str(d / "mesh.npz"), one.params, one.opt_state)
    one.params, one.opt_state = params, opt
    assert step == 2 and opt["count"] == 2
    np.testing.assert_allclose(one.step(*ranks.lite_batch()), res["next_loss"], rtol=1e-4)
    assert res["resumed_loss"] == (2, res["next_loss"])
    back = load_model(str(d / "tuned.tflite"), "cpu")
    for k, v in res["exported_from"].items():
        np.testing.assert_array_equal(back.params[k].numpy(), v.astype(np.float16)
                                      .astype(np.float32), err_msg=k)


# ---------------------------------------------------------------------------
# serving over "data"


def test_pipeline_over_the_mesh_matches_one_process_and_jax(world, jmesh):
    frames, bgs = ranks.pipe_ticks()
    cfg = PipelineConfig(width=ranks.PIPE_W, height=ranks.PIPE_H)
    one = MultiStreamPipeline(LITE, cfg, ranks.PIPE_S, device="cpu")
    ref = JaxMultiStream(LITE, JaxConfig(width=ranks.PIPE_W, height=ranks.PIPE_H,
                                         pack_interpret=True, edge_interpret=True),
                         ranks.PIPE_S, jmesh)
    mg, geo = one.pipe.maskgen, one.pipe.geo
    bars = [_Bars(mg.ema_shape) for _ in range(ranks.PIPE_S)]
    for f, (out, masks, ema) in zip(frames, world[0]["pipeline"]):
        o, k = one.step(f, bgs)
        np.testing.assert_array_equal(out, o.numpy())
        np.testing.assert_array_equal(masks, k.numpy())
        np.testing.assert_array_equal(ema, one.ema.numpy())
        jout, jmasks = (np.asarray(a) for a in ref.step(f, bgs))
        jema = _std_ema(ref.ema)
        with torch.no_grad():
            rgb = one.pipe.decode(one.pipe._upload(f, "frames", "bgr", ranks.PIPE_S))
        margin = _margins(mg, rgb.numpy())
        for s in range(ranks.PIPE_S):
            bars[s].ema(ema[s], jema[s], margin[s])
            foot = tedge.post_footprint(torch.from_numpy(ema[s] != jema[s]), geo,
                                        mg.post_mats).numpy()
            ties = post_ties(jema[s], geo)
            bars[s].bytes([((masks[s], jmasks[s]), ties)], [foot])
            apart = _yuyv(masks[s] != jmasks[s])
            np.testing.assert_array_equal(np.where(apart, 0, out[s]),
                                          np.where(apart, 0, jout[s]))
    for b in bars:
        b.check()


def test_servers_over_the_mesh_match_solo(world):
    """Buckets padded to the data axis (3 streams in 4 slots, 1 in 2), a
    new geometry attached, a padding slot taken and a full bucket grown
    (to 6 slots) mid-run: every stream delivered once, by one rank, byte
    for byte its solo steps; threaded, every stream served and the agreed
    stall timeout ends the run on every rank."""
    res = world[0]
    assert res["server_slots"] == [4, 2] and res["server_slots_after"] == [6, 2, 2]
    assert res["server_ticks"] == [1, ranks.SERVER_FRAMES]
    frames = ranks.server_frames()
    geos = {**ranks.SERVER_GEOS, **ranks.SERVER_ATTACH}
    for name, seq in frames.items():
        got = [r[name] for r in res["server_sunk"] if r[name]]
        assert len(got) == 1, name        # one rank delivers each stream
        w, h = geos[name]
        solo = FramePipeline(LITE, PipelineConfig(width=w, height=h, out_width=w,
                                                  out_height=h), device="cpu")
        want = [solo.step(f, None)[0].numpy().tobytes() for f in seq]
        assert got[0] == want, name
    assert all(1 <= c <= ranks.SERVER_FRAMES for c in res["threaded_counts"])
    # the model ranks of a data slice (0 and 1, 2 and 3) stepped the
    # frames their lead read
    last = res["server_last_frames"]
    assert last[0] == last[1] and last[2] == last[3] and last[0] != last[2]


def test_cli_multi_on_a_mesh_opens_each_source_on_one_rank(world):
    """A (2, 2) world serving three sources that refuse a second opener:
    rank 0 opens each once to learn its geometry and closes it, and then
    only the rank that reads the stream's slot, at "model" coordinate 0,
    opens it (slots 0 and 2 on data rank 0, that is rank 0; slot 1 on data
    rank 1, rank 2)."""
    rc, opens = world[0]["cli_exclusive"]
    assert rc == 0
    assert sorted(opens) == sorted(["0 test:a", "0 test:b", "0 test:c",
                                    "0 test:a", "2 test:b", "0 test:c"])


def test_cli_multi_data_axis_2_matches_direct_steps(tmp_path):
    """``--data-axis 2`` on the CPU: a world of 2, the JAX split's (1, 2)
    mesh; three ``test:`` streams to files, each byte-equal to direct
    steps."""
    frames = 3
    argv = ["-m", LITE, "-d", "--frames", str(frames), "--data-axis", "2"]
    for name in "abc":
        argv += ["--stream", f"src=test:,sink=file:{tmp_path / name}.yuv,geo=64x48"]
    assert cli_multi.main(argv, device="cpu") == 0
    want = _direct(LITE, 64, 48, 3, frames)
    assert [(tmp_path / f"{n}.yuv").read_bytes() for n in "abc"] == want


def test_dryrun_multichip_on_a_gloo_world():
    """``entry.dryrun_multichip(4, device="cpu")``: the JAX dryrun's checks
    and bars on a (2, 2) world."""
    res = dryrun_multichip(4, device="cpu")
    assert res["mesh"] == {"data": 2, "model": 2} and np.isfinite(res["loss"])
    assert res["logits_max_diff"] <= 1e-4 and res["buckets"] == 4
