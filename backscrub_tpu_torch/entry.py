"""The entry points of the port (counterpart of ``__graft_entry__.py``).

``entry()`` returns the flagship single-card frame step and its example
arguments: the fused ``FramePipeline`` on the Google Meet lite model at
640x480, BGR in, packed YUYV out, the same geometry, no flips, the EMA
carried as state.  On the card one call is K1, K2 and K3, one launch each.

``dryrun_multichip(n)`` runs the JAX dryrun's checks over an n-device
(data, model) mesh, one process a device: a tensor-parallel
``MultiStreamRunner`` against one device, one dp + tp + sp train step,
the fused frame path through ``MultiStreamPipeline``, and a
``MultiGeometryServer`` with a mid-run attach of a new geometry and of a
BodyPix bucket (K2', the prefix plan), every stream byte-identical to solo
steps.  The bundled models are not in the repository, so it runs on the
committed synthetic ones: ``python -m backscrub_tpu_torch.entry dryrun 8
[cpu]``.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

from .models.specs import resolve_model_path
from .pipeline.frame import FramePipeline, PipelineConfig

FLAGSHIP = "segm_lite_v681.tflite"
WIDTH, HEIGHT = 640, 480


def frame_step(pipe: FramePipeline):
    """``pipe``'s step as a function of its state: ``fn(frame, background,
    ema) -> (output, mask, new_ema)``, the shape of the JAX package's
    ``FramePipeline._make_step("explicit", False, False, True)`` without
    the parameters (the port's weights live in the pipeline).  It is
    ``pipe.step_batch`` on a batch of one, so it decodes the input format,
    applies the background effects and the config's flips as every step
    does; ``pipe``'s own EMA is neither read nor written."""

    def fn(frame, background, ema: torch.Tensor):
        if pipe.cfg.input_format == "mjpg":     # (coefs a component, qtabs)
            frame = ([c[None] for c in frame[0]], frame[1][None])
        else:
            frame = frame[None]
        bg = None if background is None else background[None]
        out, masks, new_ema = pipe.step_batch(frame, bg, ema[None])
        if isinstance(out, tuple):      # MJPG out: coefficients a component
            return tuple(c[0] for c in out), masks[0], new_ema[0]
        return out[0], masks[0], new_ema[0]

    return fn


def entry(model: str = FLAGSHIP, device="cuda"):
    """(fn, example_args): :func:`frame_step` of the flagship pipeline and
    a seeded u8 frame and background (seed 0, as the JAX entry) and a fresh
    EMA, all on ``device`` (the card unless the caller asks for the CPU;
    raises where CUDA is asked for and absent).  ``model`` resolves
    through ``resolve_model_path``; a missing model raises."""
    pipe = FramePipeline(resolve_model_path(model), PipelineConfig(width=WIDTH, height=HEIGHT),
                         device=device)
    rng = np.random.default_rng(0)
    frame = torch.from_numpy(rng.integers(0, 256, (HEIGHT, WIDTH, 3), np.uint8)).to(pipe.device)
    bg = torch.from_numpy(rng.integers(0, 256, (HEIGHT, WIDTH, 3), np.uint8)).to(pipe.device)
    return frame_step(pipe), (frame, bg, pipe.maskgen.ema.clone())


_DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tests", "data")
DRYRUN_MODEL = os.path.join(_DATA, "segm_synth_lite_96x160.tflite")
DRYRUN_BODYPIX = os.path.join(_DATA, "body-pix_synth_050_8_257.tflite")


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """The JAX ``dryrun_multichip`` on the port: n ranks (at most the
    cards, on the card) through ``run_world``, each checking in order

    1. ``MultiStreamRunner`` logits of a stream batch of d (the data axis)
       within 1e-4 of one device's run, the two-channel mask decision
       bit-identical per stream;
    2. one dp + tp + sp train step with a finite loss;
    3. ``MultiStreamPipeline`` over the mesh at 64x48 (the fused path: K1,
       K2 and K3 on the card, their plain versions on the CPU), each
       stream's bytes identical to solo ``FramePipeline`` steps;
    4. a ``MultiGeometryServer`` of two geometries, then a mid-run attach
       of a third geometry and of a BodyPix bucket whose pipeline built
       its prefix plan (K2'), each stream's bytes identical to solo.

    Rank 0 prints one summary line; returns its readings."""
    from .parallel.mesh import run_world
    return run_world(_dryrun_rank, n_devices, device, device)


def _solo(path, w, h, device):
    from .pipeline.frame import FramePipeline, PipelineConfig
    return FramePipeline(path, PipelineConfig(width=w, height=h, out_width=w, out_height=h),
                         device=device)


def _source(seq):
    it = iter(seq)
    return lambda: next(it, None)


def _dryrun_rank(device) -> dict:
    import torch.distributed as dist
    from .graph.executor import load_model
    from .models.specs import spec_for_model
    from .parallel.mesh import MultiStreamRunner, make_mesh
    from .parallel.streams import MultiStreamPipeline
    from .pipeline.frame import PipelineConfig
    from .runtime.multistream import MultiGeometryServer
    from .train.trainer import TrainConfig, Trainer

    mesh = make_mesh(dist.get_world_size(), device=device)
    dev, dp = mesh.device, mesh.shape["data"]
    path = DRYRUN_MODEL
    model = load_model(path, dev)

    # 1. the stream batch over "data", the weights tensor-parallel over "model"
    runner = MultiStreamRunner(model.raw_fn, model.params, mesh)
    xb = np.random.default_rng(0).random((dp, 96, 160, 3), np.float32)
    y = runner(xb).cpu().numpy()
    if y.shape != (dp, 96, 160, 2) or not np.isfinite(y).all():
        raise AssertionError(f"runner output {y.shape}, finite {np.isfinite(y).all()}")
    with torch.no_grad():
        y_solo = model(torch.from_numpy(xb[:1]).to(dev)).cpu().numpy()
    np.testing.assert_allclose(y[:1], y_solo, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(y[0, ..., 1] > y[0, ..., 0],
                                  y_solo[0, ..., 1] > y_solo[0, ..., 0])
    logits_diff = float(np.abs(y[:1] - y_solo).max())
    runner(xb)
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(5):
        runner(xb)
    _sync(dev)
    batched_ms = (time.perf_counter() - t0) / 5 * 1e3

    # 2. one train step: dp + tp + sp
    trainer = Trainer(model, spec_for_model(path), mesh,
                      TrainConfig(learning_rate=1e-4, spatial_shard=True))
    x = np.random.default_rng(1).random((dp, 96, 160, 3), np.float32)
    t = (np.random.default_rng(2).random((dp, 96, 160)) > 0.5).astype(np.float32)
    loss = trainer.step(x, t)
    if not np.isfinite(loss):
        raise AssertionError(f"non-finite loss {loss}")

    # 3. the fused frame path over "data", each stream against solo steps
    W, H = 64, 48
    ms = MultiStreamPipeline(path, PipelineConfig(width=W, height=H), dp, mesh)
    if ms.pipe.maskgen.edge is None:
        raise AssertionError("the stream batch did not take the fused path")
    rng = np.random.default_rng(3)
    stream_frames = [rng.integers(0, 256, (dp, H, W, 3), np.uint8) for _ in range(2)]
    fused = [tuple(a.cpu().numpy() for a in ms.step(f)) for f in stream_frames]
    if fused[0][0].shape != (dp, H, 2 * W):
        raise AssertionError(f"stream batch output {fused[0][0].shape}")
    solo = _solo(path, W, H, dev)
    for s in range(dp):
        solo.reset()
        for k, f in enumerate(stream_frames):
            y1, m1 = solo.step(f[s], None)
            np.testing.assert_array_equal(fused[k][0][s], y1.cpu().numpy())
            np.testing.assert_array_equal(fused[k][1][s], m1.cpu().numpy())

    # 4. two geometry buckets, then a mid-run attach of a new geometry and
    # of a BodyPix bucket on its prefix plan
    geos, nf = [(64, 48), (32, 32)], 2
    frames = {g: [rng.integers(0, 256, (g[1], g[0], 3), np.uint8) for _ in range(nf)]
              for g in geos}
    sunk = {g: [] for g in geos}
    server = MultiGeometryServer(path, PipelineConfig(width=0, height=0),
                                 [(_source(frames[g]), sunk[g].append, g[0], g[1]) for g in geos],
                                 mesh, keep_alive=True)
    ticks = server.run(frames=1)
    if ticks != 1:
        raise AssertionError(f"expected 1 warm-up tick, got {ticks}")
    gc, gd = (48, 32), (64, 48)
    frames[gc] = [rng.integers(0, 256, (gc[1], gc[0], 3), np.uint8) for _ in range(nf)]
    bodypix = [rng.integers(0, 256, (gd[1], gd[0], 3), np.uint8) for _ in range(nf)]
    sunk[gc], sunk_bp = [], []
    server.attach(_source(frames[gc]), sunk[gc].append, *gc)
    server.attach(_source(bodypix), sunk_bp.append, *gd, model=DRYRUN_BODYPIX)
    if server.n_groups != len(geos) + 2:
        raise AssertionError(f"{server.n_groups} buckets after two attaches")
    bp = server.servers[[k[0] for k in server._keys].index(DRYRUN_BODYPIX)]
    if bp.ms.pipe.maskgen.edge is None or bp.ms.pipe.maskgen.edge.prefix_plan is None:
        raise AssertionError("the BodyPix bucket did not build its prefix plan")
    ticks = server.run(frames=nf)
    if ticks != nf:
        raise AssertionError(f"expected {nf} post-attach ticks, got {ticks}")
    # each stream rides slot 0 of its bucket: the rank at data 0, model 0 delivers it
    delivered = [len(sunk[g]) for g in geos + [gc]] + [len(sunk_bp)]
    for g in geos + [gc]:
        solo = _solo(path, g[0], g[1], dev)
        for k, out in enumerate(sunk[g]):
            np.testing.assert_array_equal(out, solo.step(frames[g][k], None)[0].cpu().numpy())
    solo = _solo(DRYRUN_BODYPIX, gd[0], gd[1], dev)
    if solo.maskgen.edge is None or solo.maskgen.edge.prefix_plan is None:
        raise AssertionError("the solo BodyPix pipeline did not build its prefix plan")
    for k, out in enumerate(sunk_bp):
        np.testing.assert_array_equal(out, solo.step(bodypix[k], None)[0].cpu().numpy())
    counts = torch.tensor(delivered, device=dev)
    dist.all_reduce(counts)
    if counts.tolist() != [nf] * len(delivered):
        raise AssertionError(f"deliveries a stream over the mesh {counts.tolist()}, "
                             f"expected {nf} each")
    res = dict(mesh=dict(mesh.shape), loss=loss, logits_max_diff=logits_diff,
               batched_ms=batched_ms, buckets=server.n_groups)
    if dist.get_rank() == 0:
        print(f"dryrun_multichip OK: mesh={res['mesh']} loss={loss:.4f} "
              f"batched_dispatch={batched_ms:.1f}ms/step (S={dp} streams, logits within "
              f"{logits_diff:.2g} of one device, mask decisions bit-identical; the fused "
              f"frame path over the mesh and a MultiGeometryServer of {server.n_groups} "
              f"buckets with a mid-run attach of a new geometry and of a BodyPix bucket on "
              f"its prefix plan: per-stream bytes identical to solo)")
    return res


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


if __name__ == "__main__":
    if len(sys.argv) < 2 or sys.argv[1] != "dryrun":
        sys.exit("usage: python -m backscrub_tpu_torch.entry dryrun [N] [cuda|cpu]")
    dryrun_multichip(int(sys.argv[2]) if len(sys.argv) > 2 else 8,
                     sys.argv[3] if len(sys.argv) > 3 else "cuda")
