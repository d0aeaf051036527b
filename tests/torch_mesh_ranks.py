"""What each rank of ``tests/test_torch_mesh.py``'s gloo worlds runs.

A module of its own that imports no JAX (``torch.multiprocessing``
imports it afresh in every spawned rank): each function runs on every
rank of the world it is given to (``parallel.mesh.run_world``) and
returns rank 0's readings, which the test holds against the JAX mesh and
the port's one-process runs.  Inputs are made from seeds with numpy here
and in the test alike.
"""

from __future__ import annotations

import os
import pathlib

import numpy as np
import torch
import torch.distributed as dist

ROOT = pathlib.Path(__file__).resolve().parent.parent
DATA = ROOT / "tests" / "data"
LITE = str(DATA / "segm_synth_lite_96x160.tflite")
DEEPLAB = str(DATA / "deeplab_synth_257.tflite")
UNET = str(DATA / "unet_synth_256x256.tflite")
FAMILIES = {name: str(DATA / f) for name, f in (
    ("segm_lite", "segm_synth_lite_96x160.tflite"), ("segm_full", "segm_synth_full_144x256.tflite"),
    ("deeplab", "deeplab_synth_257.tflite"), ("mlkit", "selfie_synth_mlkit_256x256.tflite"),
    ("bodypix", "body-pix_synth_050_8_257.tflite"))}
LR, STEPS = 1e-3, 3
DEEPLAB_LR, DEEPLAB_STEPS = 1e-4, 2
PIPE_W, PIPE_H, PIPE_S, PIPE_TICKS = 160, 96, 2, 3
SERVER_GEOS = {"a": (64, 48), "b": (64, 48), "c": (64, 48), "d": (32, 32)}
SERVER_ATTACH = {"e": (48, 32), "f": (64, 48), "g": (64, 48)}
SERVER_FRAMES = 3


def lite_batch(n=4):
    """n normalized frames and hard targets at segm_lite's 96x160."""
    rng = np.random.default_rng(21)
    x = rng.random((n, 96, 160, 3), dtype=np.float32)
    y = (rng.random((n, 96, 160)) > 0.5).astype(np.float32)
    return x, y


def runner_batch():
    return np.random.default_rng(5).random((4, 96, 160, 3), np.float32)


def unet_batch():
    """Two frames at the converted U-Net's 256x256, one a data rank."""
    return np.random.default_rng(9).random((2, 256, 256, 3), np.float32)


def deeplab_batch():
    rng = np.random.default_rng(1234)
    x = rng.random((4, 257, 257, 3), np.float32) * 2 - 1
    return x, (rng.random((4, 257, 257)) > 0.5).astype(np.float32)


def pipe_ticks():
    """PIPE_TICKS batches of PIPE_S streams' frames and the backgrounds."""
    rng = np.random.default_rng(8)
    frames = [rng.integers(0, 256, (PIPE_S, PIPE_H, PIPE_W, 3), np.uint8)
              for _ in range(PIPE_TICKS)]
    return frames, rng.integers(0, 256, (PIPE_S, PIPE_H, PIPE_W, 3), np.uint8)


def server_frames():
    """Each stream's SERVER_FRAMES frames, by name."""
    rng = np.random.default_rng(9)
    return {k: [rng.integers(0, 256, (h, w, 3), np.uint8) for _ in range(SERVER_FRAMES)]
            for k, (w, h) in {**SERVER_GEOS, **SERVER_ATTACH}.items()}


def _host(d):
    return {k: v.detach().cpu().numpy() for k, v in d.items()}


def _trainer(mesh, spatial, lr=LR, path=LITE):
    from backscrub_tpu_torch.graph.executor import load_model
    from backscrub_tpu_torch.models.specs import spec_for_model
    from backscrub_tpu_torch.train.trainer import TrainConfig, Trainer
    return Trainer(load_model(path, mesh.device), spec_for_model(path), mesh,
                   TrainConfig(learning_rate=lr, spatial_shard=spatial))


def _steps(tr, x, y, n):
    """n steps, the first one's reduced gradients gathered whole."""
    losses = [tr.step(x, y)]
    grads = _host(tr._whole({k: p.grad for k, p in tr._trainable.items()}))
    losses += [tr.step(x, y) for _ in range(n - 1)]
    return losses, grads, _host(tr.params)


def _source(seq):
    it = iter(seq)
    return lambda: next(it, None)


def _exclusive_cli(mesh, tmp: str):
    """``cli_multi`` over ``mesh`` with three ``test:`` sources that, as a
    V4L2 camera, refuse an opener while another holds them (a lock file
    made with O_EXCL; ``FileExistsError`` is the OSError the CLI reports):
    (the CLI's exit code, "rank uri" a line for every open)."""
    from backscrub_tpu_torch import cli_multi
    from backscrub_tpu_torch.io import streams

    real = streams.open_source
    log = os.path.join(tmp, "opens.log")

    def exclusive(uri, width, height, pixfmt=""):
        lock = os.path.join(tmp, uri.replace(":", "_") + ".lock")
        os.close(os.open(lock, os.O_CREAT | os.O_EXCL))
        with open(log, "a") as f:
            f.write(f"{dist.get_rank()} {uri}\n")
        src = real(uri, width, height, pixfmt)
        close = src.close

        def release():
            close()
            os.unlink(lock)
        src.close = release
        return src

    argv = ["-m", LITE, "--frames", str(SERVER_FRAMES)]
    for name in "abc":
        argv += ["--stream", f"src=test:{name},sink=null:,geo=64x48"]
    streams.open_source = exclusive
    try:
        rc = cli_multi._serve(cli_multi.parse_args(argv), mesh.device, mesh)
    finally:
        streams.open_source = real
    dist.barrier()
    with open(log) as f:
        return rc, f.read().splitlines()


def world_checks(ckpt_dir: str) -> dict:
    """Every check of a (2, 2) world but the CLI's and the dryrun's."""
    from backscrub_tpu_torch.graph.executor import load_model
    from backscrub_tpu_torch.parallel.mesh import (MultiStreamRunner, gather_streams, make_mesh,
                                                   param_sharding_spec)
    from backscrub_tpu_torch.parallel.streams import MultiStreamPipeline
    from backscrub_tpu_torch.pipeline.frame import PipelineConfig
    from backscrub_tpu_torch.runtime.multistream import MultiGeometryServer, MultiStreamServer
    from backscrub_tpu_torch.tflite.export import export_params_to_tflite
    from backscrub_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint

    out = {}
    mesh = make_mesh(4, device="cpu")
    out["mesh"] = dict(mesh.shape)

    # the sharding rule on every synthetic family
    out["specs"] = {}
    for name, path in FAMILIES.items():
        m = load_model(path, "cpu")
        out["specs"][name] = sorted(k for k, v in m.params.items()
                                    if param_sharding_spec(k, v, mesh) is not None)

    # the tensor-parallel runner
    m = load_model(LITE, "cpu")
    out["runner"] = MultiStreamRunner(m.raw_fn, m.params, mesh)(runner_batch()).numpy()
    # a converted model's: builtin TRANSPOSE_CONV split by columns too
    u = load_model(UNET, "cpu")
    out["unet_runner"] = MultiStreamRunner(u.raw_fn, u.params, mesh)(unet_batch()).numpy()

    # dp + tp + sp, dp only, tp only
    x, y = lite_batch()
    tr = _trainer(mesh, True)
    out["evaluate_before"] = tr.evaluate(x, y)
    out["dp_tp_sp"] = _steps(tr, x, y, STEPS)
    out["evaluate_after"] = tr.evaluate(x, y)
    out["dp"] = _steps(_trainer(make_mesh(4, data=4, device="cpu"), False), x, y, STEPS)
    out["tp"] = _steps(_trainer(make_mesh(4, model=4, device="cpu"), False), x, y, STEPS)

    # deeplab's 21-class argmax loss at 257x257 on the (2, 2) mesh, dp + tp
    dx, dy = deeplab_batch()
    dl = _trainer(mesh, False, DEEPLAB_LR, DEEPLAB)
    out["deeplab"] = ([dl.step(dx, dy) for _ in range(DEEPLAB_STEPS)], _host(dl.params))

    # a checkpoint and an export written on the mesh; the checkpoint resumed
    # on the mesh gives the uninterrupted run's next loss
    ck = os.path.join(ckpt_dir, "mesh.npz")
    tr = _trainer(mesh, True)
    for _ in range(2):
        tr.step(x, y)
    save_checkpoint(ck, tr.params, tr.opt_state, step=2)
    out["next_loss"] = tr.step(x, y)
    back = _trainer(mesh, True)
    params, opt, step = load_checkpoint(ck, back.params, back.opt_state)
    back.params, back.opt_state = params, opt
    out["resumed_loss"] = (step, back.step(x, y))
    whole = tr.params
    if dist.get_rank() == 0:
        export_params_to_tflite(LITE, m, whole, os.path.join(ckpt_dir, "tuned.tflite"))
    out["exported_from"] = _host(whole)

    # the stream batch over "data", each stream's EMA on its rank
    frames, bgs = pipe_ticks()
    ms = MultiStreamPipeline(LITE, PipelineConfig(width=PIPE_W, height=PIPE_H), PIPE_S, mesh)
    out["pipeline"] = []
    for f in frames:
        o, k = ms.step(f, bgs)
        out["pipeline"].append((o.numpy(), k.numpy(), gather_streams(ms.ema, mesh).numpy()))

    # the servers: buckets padded to the data axis, elastic attaches (a new
    # geometry, a padding slot taken, a full bucket grown), every stream
    # delivered once, by the rank that serves it
    sf = server_frames()
    sunk = {k: [] for k in sf}
    server = MultiGeometryServer(
        LITE, PipelineConfig(width=0, height=0),
        [(_source(sf[k]), sunk[k].append, w, h) for k, (w, h) in SERVER_GEOS.items()],
        mesh, device="cpu", keep_alive=True)
    out["server_slots"] = [s.ms.n_streams for s in server.servers]
    ticks = [server.run(frames=1)]
    for k, (w, h) in SERVER_ATTACH.items():
        server.attach(_source(sf[k]), sunk[k].append, w, h)
    out["server_slots_after"] = [s.ms.n_streams for s in server.servers]
    ticks.append(server.run(frames=SERVER_FRAMES))
    out["server_ticks"] = ticks
    gathered = [None] * dist.get_world_size()
    dist.all_gather_object(gathered, {k: [a.tobytes() for a in v] for k, v in sunk.items()})
    out["server_sunk"] = gathered
    # the frames each rank stepped last: the lead's, broadcast over "model"
    last = [None] * dist.get_world_size()
    dist.all_gather_object(last, [s._frames[s.ms.rows].tobytes() for s in server.servers])
    out["server_last_frames"] = last

    # threaded: each stream's reader on the rank that serves it; the stall
    # timeout is agreed, so every rank stops together
    counts = [0] * 3
    threaded = MultiStreamServer(
        MultiStreamPipeline(LITE, PipelineConfig(width=64, height=48), 4, mesh),
        [_source(sf[k]) for k in "abc"],
        [lambda _o, s=s: counts.__setitem__(s, counts[s] + 1) for s in range(3)],
        threaded=True, stall_timeout=1.0)
    threaded.run()
    total = torch.tensor(counts)
    dist.all_reduce(total, group=mesh.group("data"))
    out["threaded_counts"] = total.tolist()

    out["cli_exclusive"] = _exclusive_cli(mesh, ckpt_dir)
    return out
