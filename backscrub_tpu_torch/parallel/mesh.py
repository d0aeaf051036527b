"""The (data, model) device mesh on ``torch.distributed``, one process a
device (counterpart of ``backscrub_tpu/parallel/mesh.py``).

Mesh axes, as in the JAX package:

- ``data``: batch and stream parallelism: each data slice serves its own
  streams (or trains on its own rows of the batch);
- ``model``: tensor parallelism: the last dimension of a large parameter
  (a conv kernel's output channels, its bias, an FC's outputs) is split
  over the model ranks (:func:`param_sharding_spec`).  Where XLA's SPMD
  partitioner inserts the gathers, the port's graph executor does
  (``parallel/sharding.py``); with ``TrainConfig.spatial_shard`` the image
  rows go over "model" too, with halo exchanges for the convolutions.

A mesh lives in an initialised world of ``data * model`` ranks: NCCL on
the card (one card a rank), gloo on the CPU.  :func:`run_world` starts
such a world (spawned processes sharing a ``FileStore`` in a temporary
directory); a world of one needs no launcher, and :func:`make_mesh`
starts it in-process.  NCCL puts no two ranks on one card, so a world
never has more ranks than the machine has cards.

Stream batches go over "data" in strides: data rank r serves slots r,
r + d, r + 2d, ... of a batch of S (:func:`stream_slice`).  A slot then
keeps its rank when a server's batch grows, so its EMA and its reader
thread stay in the process that holds them; the whole batch, gathered,
is in slot order either way.
"""

from __future__ import annotations

import datetime
import os
import pickle
import shutil
import signal
import tempfile
import threading
from typing import Callable, Dict, Optional

import torch
import torch.distributed as dist

AXES = ("data", "model")
WORLD_TIMEOUT_S = 600      # a collective waits this long for a lost rank
CPU_WORLD = 4              # the CPU's devices: gloo ranks of a (2, 2) mesh


class Mesh:
    """A 2-D ``DeviceMesh`` named ("data", "model") and the device of this
    rank.  ``shape`` is {"data": d, "model": m}, as the JAX mesh's;
    :meth:`group` gives an axis's process group and :meth:`coord` this
    rank's index along it."""

    def __init__(self, device_mesh, device: torch.device):
        self.device_mesh = device_mesh
        self.device = device
        self.shape = {a: device_mesh.size(i) for i, a in enumerate(AXES)}
        # on the card, gloo groups of the whole mesh and of "model" for host
        # values (every rank creates every group, in one order)
        self._host = {}
        if device.type == "cuda":
            grid = device_mesh.mesh.tolist()      # [data][model] -> global rank
            self._host[None] = dist.new_group(backend="gloo")
            self._host["model"], _ = dist.new_subgroups_by_enumeration(grid, backend="gloo")

    def group(self, axis: str):
        return self.device_mesh.get_group(axis)

    def host_group(self, axis: Optional[str] = None):
        """The group for host values (flags, frames) of "model", or of every
        rank (None): gloo, so that a collective on it never waits on the
        card's queue of kernels; on the CPU the mesh's own groups."""
        if axis in self._host:
            return self._host[axis]
        return dist.group.WORLD if axis is None else self.group(axis)

    def coord(self, axis: str) -> int:
        return self.device_mesh.get_local_rank(axis)


def _backend(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def _rank_device(device: torch.device, rank: int) -> torch.device:
    return torch.device("cuda", rank % torch.cuda.device_count()) \
        if device.type == "cuda" else device


def make_mesh(n_devices: Optional[int] = None, data: Optional[int] = None,
              model: Optional[int] = None, *, device="cuda") -> Mesh:
    """A (data, model) mesh over the ranks of this world, split as the JAX
    ``make_mesh`` splits n devices: model = 2 where n is even and above
    1, data the rest, unless ``data`` or ``model`` says otherwise.

    Runs in an initialised world of n ranks (:func:`run_world`); without
    one, n must be 1 and a world of one starts here.  ``device`` is "cuda"
    (NCCL, this rank's card) or "cpu" (gloo); CUDA asked for and absent
    raises, as every entry point of the port does."""
    from .._build import resolve_device
    dev = resolve_device(device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    n = n_devices or world
    if data is not None and model is not None:
        pass
    elif data is not None:
        if n % data:
            raise ValueError(f"data={data} does not divide {n} devices")
        model = n // data
    elif model is not None:
        if n % model:
            raise ValueError(f"model={model} does not divide {n} devices")
        data = n // model
    else:
        model = 2 if n % 2 == 0 and n > 1 else 1
        data = n // model
    if data * model != world:
        raise ValueError(f"a {data}x{model} mesh needs a world of {data * model} ranks, "
                         f"this one has {world}: start them with run_world")
    if not dist.is_initialized():
        dist.init_process_group(_backend(dev), store=dist.HashStore(), rank=0, world_size=1)
    from torch.distributed.device_mesh import init_device_mesh
    rdev = _rank_device(dev, dist.get_rank())
    if rdev.type == "cuda":
        torch.cuda.set_device(rdev)
    return Mesh(init_device_mesh(dev.type, (data, model), mesh_dim_names=AXES), rdev)


def _rank_main(rank: int, fn: Callable, n: int, dev_type: str, tmp: str, args: tuple):
    """One spawned rank: join the world through the shared FileStore, run
    ``fn(*args)``, and on rank 0 keep its result for the parent."""
    if dev_type == "cuda":
        torch.cuda.set_device(rank)
    else:
        torch.set_num_threads(1)     # n ranks share the host's cores
    dist.init_process_group("nccl" if dev_type == "cuda" else "gloo",
                            store=dist.FileStore(os.path.join(tmp, "store"), n),
                            rank=rank, world_size=n,
                            timeout=datetime.timedelta(seconds=WORLD_TIMEOUT_S))
    try:
        res = fn(*args)
        if rank == 0:
            with open(os.path.join(tmp, "result.pkl"), "wb") as f:
                pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


def device_count(device) -> int:
    """The devices a mesh of every device spans: the visible cards on the
    card (``CUDA_VISIBLE_DEVICES`` limits them), CPU_WORLD on the CPU,
    standing for the JAX tests' virtual CPU devices."""
    from .._build import resolve_device
    return torch.cuda.device_count() if resolve_device(device).type == "cuda" else CPU_WORLD


def run_world(fn: Callable, n: int, device, *args):
    """Run ``fn(*args)`` on each rank of a world of n and return rank 0's
    result.  On the card n is at most the number of cards (as the JAX
    callers take ``min(n, len(jax.devices()))``); the ranks are processes
    spawned by ``torch.multiprocessing``, joined through a ``FileStore``
    in a temporary directory of their own (so concurrent worlds never
    share a port).  A world of one runs ``fn`` in this process, in the
    world already initialised here or in one started for the call.  A
    rank that raises fails the call, and the others are stopped.  A
    SIGTERM to this process goes on to every rank, so that each ends as a
    one-process run would."""
    from .._build import resolve_device
    dev = resolve_device(device)
    if dev.type == "cuda":
        n = min(n, torch.cuda.device_count())
    if n < 1:
        raise ValueError(f"a world needs at least one rank, got {n}")
    if n == 1:
        if dist.is_initialized():
            return fn(*args)
        if dev.type == "cuda":
            torch.cuda.set_device(0)
        dist.init_process_group(_backend(dev), store=dist.HashStore(), rank=0, world_size=1)
        try:
            return fn(*args)
        finally:
            dist.destroy_process_group()
    import torch.multiprocessing as mp
    tmp = tempfile.mkdtemp(prefix="bs_world_")
    ctx = mp.spawn(_rank_main, args=(fn, n, dev.type, tmp, args), nprocs=n, join=False)
    forward = threading.current_thread() is threading.main_thread()
    if forward:
        prev = signal.signal(signal.SIGTERM, lambda *_: _signal_ranks(ctx, signal.SIGTERM))
    try:
        while not ctx.join():
            pass
        with open(os.path.join(tmp, "result.pkl"), "rb") as f:
            return pickle.load(f)
    finally:
        if forward:
            signal.signal(signal.SIGTERM, prev)
        shutil.rmtree(tmp, ignore_errors=True)


def _signal_ranks(ctx, sig) -> None:
    for p in ctx.processes:
        try:
            os.kill(p.pid, sig)
        except ProcessLookupError:     # that rank has ended
            pass


def param_sharding_spec(name: str, arr, mesh: Mesh) -> Optional[int]:
    """The dimension of an executor parameter (keys ``t<idx>`` and
    ``t<idx>@<variant>``, layouts per ``ops/conv.py``) split over
    "model", or None for a replicated one, by the JAX package's rule: the
    last dimension, where it divides by the model size and is at least 8
    times it (conv kernels HWIO's O, biases (O,), FC kernels (K, O))."""
    msize = mesh.shape["model"]
    if msize == 1:
        return None
    shape = tuple(arr.shape)
    if len(shape) >= 1 and shape[-1] % msize == 0 and shape[-1] >= msize * 8:
        return len(shape) - 1
    return None


def param_specs(params: Dict[str, torch.Tensor], mesh: Mesh) -> Dict[str, Optional[int]]:
    """:func:`param_sharding_spec` of every whole parameter."""
    return {k: param_sharding_spec(k, v, mesh) for k, v in params.items()}


def shard_params(params: Dict[str, torch.Tensor], mesh: Mesh,
                 specs: Optional[Dict[str, Optional[int]]] = None) -> Dict[str, torch.Tensor]:
    """Each whole parameter as this rank keeps it, on the mesh's device:
    its own slice of a sharded dimension, a replicated one whole."""
    specs = param_specs(params, mesh) if specs is None else specs
    m, r = mesh.shape["model"], mesh.coord("model")
    out = {}
    for k, v in params.items():
        v = torch.as_tensor(v).to(mesh.device)
        dim = specs[k]
        if dim is not None:
            n = v.shape[dim] // m
            v = v.narrow(dim, r * n, n)
        out[k] = v.contiguous()
    return out


def all_gather_cat(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's ``x`` (one shape on all) concatenated along ``dim``, in
    the group's rank order."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


def gather_params(params: Dict[str, torch.Tensor], mesh: Mesh,
                  specs: Dict[str, Optional[int]]) -> Dict[str, torch.Tensor]:
    """The whole parameters from every rank's :func:`shard_params` slices
    (a collective over "model": every rank calls it)."""
    g = mesh.group("model")
    return {k: (all_gather_cat(v.detach(), specs[k], g) if specs[k] is not None
                else v.detach()) for k, v in params.items()}


def agree(mesh: Optional[Mesh], *flags: bool) -> tuple:
    """Each flag, true where it is true on any rank of the mesh (a max
    all-reduce on the host: every rank calls it alike, so the model ranks,
    which step together, stop together too); the flags as given without a
    mesh."""
    if mesh is None:
        return flags
    t = torch.tensor([int(f) for f in flags], dtype=torch.int32)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.host_group())
    return tuple(bool(v) for v in t.tolist())


def stream_slice(mesh: Optional[Mesh], S: int) -> slice:
    """This rank's rows of a stream (or training) batch of S over "data":
    slots r, r + d, ... for data coordinate r of d; every row without a
    mesh.  S must divide by d."""
    if mesh is None:
        return slice(0, S)
    d = mesh.shape["data"]
    if S % d:
        raise ValueError(f"a batch of {S} does not divide over the data axis {d}")
    return slice(mesh.coord("data"), S, d)


def gather_streams(local: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The whole batch, in slot order, from every data rank's
    :func:`stream_slice` rows (a collective over "data")."""
    d = mesh.shape["data"]
    local = local.contiguous()
    parts = [torch.empty_like(local) for _ in range(d)]
    dist.all_gather(parts, local, group=mesh.group("data"))
    # parts[r][i] is slot i * d + r
    return torch.stack(parts, dim=1).reshape((local.shape[0] * d,) + tuple(local.shape[1:]))


class MultiStreamRunner:
    """Serve a fixed batch of camera streams across a mesh.

    Wraps ``fn(params, x, tp=...)`` (``CompiledModel.raw_fn``): the
    stream batch (S, H, W, C) goes over "data" and the weights are
    tensor-parallel over "model" (``parallel/sharding.py``'s column
    split).  ``__call__`` takes the whole batch, numpy or a tensor, and
    returns the whole output, gathered over "data", as the JAX runner's
    global array; every rank calls it with the same batch."""

    def __init__(self, fn, params: Dict[str, torch.Tensor], mesh: Mesh):
        from .sharding import TensorParallel
        self.mesh = mesh
        self.specs = param_specs(params, mesh)
        self.params = shard_params(params, mesh, self.specs)
        self.tp = TensorParallel(mesh, self.specs)
        self._fn = fn

    @torch.no_grad()
    def __call__(self, stream_batch) -> torch.Tensor:
        x = torch.as_tensor(stream_batch).to(self.mesh.device)
        x = x[stream_slice(self.mesh, x.shape[0])].contiguous()
        return gather_streams(self._fn(self.params, x, tp=self.tp), self.mesh)
