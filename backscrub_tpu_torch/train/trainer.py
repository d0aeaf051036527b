"""Fine-tuning of segmentation models on one card or a mesh (counterpart of
``backscrub_tpu/train/trainer.py``).

The graph executor walks the loaded ``.tflite`` graph with PyTorch ops,
so every model it runs is differentiable: :class:`Trainer` holds the
parameters as f32 leaves, runs ``CompiledModel.raw_fn`` on them and
steps ``torch.optim.Adam`` (``AdamW`` with a weight decay), the optax
transforms of the JAX package.  The losses match each family's head
(:func:`segmentation_loss`), and ``evaluate`` measures the IoU of the
mask the deployed decode rule gives.

On a (data, model) mesh (``parallel/mesh.py``, one process a device,
every rank calling the same methods with the same whole batch) the step
is the JAX trainer's dp + tp (+ sp):

- dp: the batch N goes over "data" (N must divide by it);
- tp: parameters and Adam's moments are stored sharded by
  ``param_sharding_spec``, each rank updating its slice; the convolutions
  and FCs split their output channels over "model"
  (``parallel/sharding.py``);
- sp, with ``TrainConfig.spatial_shard``: the input and target rows go
  over "model" too, as ``P("data", "model", None, None)`` places them;
  the convolutions exchange halo rows, and the weights are gathered for
  each op.

Each rank's objective is its part of the global mean loss (its share of
the target's pixels times its mean); after the backward the gradients
are summed over "data", and in the spatial mode the replicated
parameters' over "model" too (a sharded one's gather already summed
them there).  ``step`` returns the global mean loss.  ``params`` and
``opt_state`` give and take whole tensors (gathered: a collective), so a
checkpoint or an export written on a mesh loads on one card and back.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..graph.executor import CompiledModel
from ..models.specs import ModelSpec
from ..pipeline.decode import decode_val
from ..pipeline.maskgen import set_precision_policy


@dataclasses.dataclass
class TrainConfig:
    learning_rate: float = 1e-4
    weight_decay: float = 0.0
    spatial_shard: bool = False   # shard image H over the "model" axis too (sp)


def person_probability(out: torch.Tensor, spec: ModelSpec) -> torch.Tensor:
    """Model head output -> per-pixel person probability in [0, 1]."""
    if spec.decode == "two_channel":
        return torch.softmax(out, dim=-1)[..., 1]
    if spec.decode == "argmax_not_background":
        return 1.0 - torch.softmax(out, dim=-1)[..., 0]
    if spec.decode == "argmax_person":
        return torch.softmax(out, dim=-1)[..., spec.person_class]
    if spec.decode == "threshold":
        return out[..., 0]
    raise ValueError(f"no probability decode for rule {spec.decode!r}")


def segmentation_loss(spec: ModelSpec):
    """Loss matched to each model family's output head, ``loss(out,
    target)`` with target (..., H, W) person probability in [0, 1]:

    - two_channel (Meet): softmax cross-entropy over the 2 logits
    - argmax_not_background (multiclass, class 0 background): BCE on
      P(any other class) = 1 - softmax(out)[..., 0], its log clamped below 0
    - argmax_person (DeepLab): the person class against the log-sum of the
      others
    - threshold (MLKit/BodyPix): binary cross-entropy on the probability
      map, clamped to [1e-6, 1 - 1e-6]
    """
    if spec.decode not in ("two_channel", "argmax_not_background", "argmax_person",
                           "threshold"):
        raise ValueError(f"no training loss for decode rule {spec.decode!r}")

    def loss_fn(out: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        if spec.decode == "two_channel":
            logp = F.log_softmax(out, dim=-1)
            return -torch.mean(target * logp[..., 1] + (1 - target) * logp[..., 0])
        if spec.decode == "argmax_not_background":
            log_bg = F.log_softmax(out, dim=-1)[..., 0]
            log_fg = torch.log1p(-torch.exp(torch.clamp(log_bg, max=-1e-6)))
            return -torch.mean(target * log_fg + (1 - target) * log_bg)
        if spec.decode == "argmax_person":
            pc = spec.person_class
            person = F.log_softmax(out, dim=-1)[..., pc]
            rest = torch.cat([out[..., :pc], out[..., pc + 1:]], dim=-1)
            other = torch.logsumexp(rest, dim=-1) - torch.logsumexp(out, dim=-1)
            return -torch.mean(target * person + (1 - target) * other)
        p = torch.clamp(out[..., 0], 1e-6, 1 - 1e-6)
        return -torch.mean(target * torch.log(p) + (1 - target) * torch.log1p(-p))
    return loss_fn


class Trainer:
    """Train step on the model's device (the card unless the model was
    loaded on the CPU), or over ``mesh`` (the model loaded on this rank's
    device).

    ``batch`` = (frames f32 (N, H, W, 3) normalized, target person
    probability (N, H, W)), numpy or tensors.  ``params`` are the model's
    weights as f32 leaves (its own ``params`` stay as loaded; on a mesh,
    whole tensors gathered from the slices); ``opt_state`` the
    optimizer's moments as {"count", "mu", "nu"} under the parameter keys,
    the layout of ``train/checkpoint.py``.
    """

    def __init__(self, model: CompiledModel, spec: ModelSpec, mesh=None,
                 config: TrainConfig = TrainConfig()):
        if model.quantize_mode == "int8" or any(v.dtype == torch.int8
                                                for v in model.params.values()):
            raise ValueError(
                "model was loaded with int8 quantized weights — quantization "
                "is inference-only; load with quantize=None for training")
        # cuDNN's convolutions and cuBLAS's GEMMs would otherwise train in TF32
        set_precision_policy()
        self.model, self.spec, self.mesh, self.cfg = model, spec, mesh, config
        self.loss_fn = segmentation_loss(spec)
        # f16-stored weights would give f16 moments, in which Adam's eps underflows
        params = {k: v.detach().to(torch.float32).clone() if v.is_floating_point() else v
                  for k, v in model.params.items()}
        self.tp = self.specs = None
        if mesh is not None:
            from ..parallel.mesh import param_specs, shard_params
            from ..parallel.sharding import TensorParallel
            self.specs = param_specs(params, mesh)
            self.tp = TensorParallel(mesh, self.specs, spatial=config.spatial_shard)
            params = shard_params(params, mesh, self.specs)
        self._params = {k: v.requires_grad_(True) if v.is_floating_point() else v
                        for k, v in params.items()}
        self._trainable = {k: v for k, v in self._params.items() if v.requires_grad}
        leaves = list(self._trainable.values())
        self.opt = (torch.optim.AdamW(leaves, config.learning_rate,
                                      weight_decay=config.weight_decay)
                    if config.weight_decay else
                    torch.optim.Adam(leaves, config.learning_rate))

    @property
    def device(self) -> torch.device:
        return next(iter(self._params.values())).device

    def _whole(self, local: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        if self.mesh is None:
            return local
        from ..parallel.mesh import gather_params
        return gather_params(local, self.mesh, {k: self.specs[k] for k in local})

    def _local(self, key: str, value) -> torch.Tensor:
        """A whole tensor as this rank keeps parameter ``key``."""
        v = torch.as_tensor(value)
        if self.mesh is None:
            return v
        from ..parallel.mesh import shard_params
        return shard_params({key: v}, self.mesh, {key: self.specs[key]})[key]

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        return self._whole(self._params)

    @params.setter
    def params(self, values: Dict[str, object]) -> None:
        """Copy ``values`` (whole arrays or tensors under every parameter
        key) into the trained leaves."""
        with torch.no_grad():
            for k, p in self._params.items():
                p.copy_(self._local(k, values[k]).to(p.device, p.dtype))

    @property
    def opt_state(self) -> dict:
        """{"count": steps taken, "mu": first moments, "nu": second moments},
        whole host f32 arrays under the parameter keys (zeros before the
        first step, as optax initialises them)."""
        count, mu, nu = 0, {}, {}
        for k, p in self._trainable.items():
            st = self.opt.state.get(p, {})
            if st:
                count = int(st["step"])
            mu[k] = (st["exp_avg"] if st else torch.zeros_like(p)).detach()
            nu[k] = (st["exp_avg_sq"] if st else torch.zeros_like(p)).detach()
        return {"count": count,
                "mu": {k: v.cpu().numpy() for k, v in self._whole(mu).items()},
                "nu": {k: v.cpu().numpy() for k, v in self._whole(nu).items()}}

    @opt_state.setter
    def opt_state(self, state: dict) -> None:
        count = int(state["count"])
        for k, p in self._trainable.items():
            if count == 0:
                self.opt.state.pop(p, None)
                continue
            self.opt.state[p] = {
                "step": torch.tensor(float(count), dtype=torch.float32),
                "exp_avg": self._local(k, state["mu"][k]).to(p.device, p.dtype).clone(),
                "exp_avg_sq": self._local(k, state["nu"][k]).to(p.device, p.dtype).clone()}

    def _batch(self, x, y):
        """The batch on the device; on a mesh this rank's rows of it and,
        spatially, of the targets, with the whole target's pixel count."""
        x, y = (torch.as_tensor(v).to(self.device, torch.float32) for v in (x, y))
        total = y.numel()
        if self.mesh is not None:
            from ..parallel.mesh import stream_slice
            sl = stream_slice(self.mesh, x.shape[0])
            x, y = x[sl].contiguous(), y[sl]
            if self.tp.spatial:
                lo, hi = self.tp.own_rows(y.shape[1])
                y = y[:, lo:hi]
            y = y.contiguous()
        return x, y, total

    def _parts_group(self):
        """The ranks whose objectives add up to the loss: the data axis,
        and spatially the whole mesh (the model ranks hold parts too)."""
        return dist.group.WORLD if self.tp.spatial else self.mesh.group("data")

    def _reduce_grads(self) -> None:
        """Sum each gradient over the ranks that hold parts of it, one
        all-reduce a group over the flattened gradients."""
        buckets = {}
        for k, p in self._trainable.items():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            whole_mesh = self.tp.spatial and not self.tp.sharded(k)
            buckets.setdefault(whole_mesh, []).append(p.grad)
        for whole_mesh, grads in buckets.items():
            flat = torch.cat([g.reshape(-1) for g in grads])
            dist.all_reduce(flat, group=dist.group.WORLD if whole_mesh
                            else self.mesh.group("data"))
            for g, v in zip(grads, torch.split(flat, [g.numel() for g in grads])):
                g.copy_(v.view_as(g))

    def step(self, x, y) -> float:
        """One optimizer step; returns the scalar loss (before the step)."""
        x, y, total = self._batch(x, y)
        self.opt.zero_grad(set_to_none=True)
        loss = self.loss_fn(self.model.raw_fn(self._params, x, tp=self.tp).float(), y)
        if self.mesh is not None:
            loss = loss * (y.numel() / total)       # this rank's part of the mean
        loss.backward()
        if self.mesh is not None:
            self._reduce_grads()
            loss = loss.detach().clone()
            dist.all_reduce(loss, group=self._parts_group())
        self.opt.step()
        return float(loss.detach())

    @torch.no_grad()
    def evaluate(self, x, y) -> dict:
        """Validation metrics on a batch: {'loss', 'iou'}.  The IoU compares
        the target (person where y > 0.5) with the mask the DEPLOYED decode
        rule produces (``pipeline/decode.py`` ``decode_val`` == 0), the
        train-time analog of the golden-test IoU gate."""
        x, y, total = self._batch(x, y)
        out = self.model.raw_fn(self._params, x, tp=self.tp).float()
        loss = self.loss_fn(out, y)
        pred = decode_val(out, self.spec) == 0
        tgt = y > 0.5
        inter = torch.sum(pred & tgt).to(torch.float32)
        union = torch.sum(pred | tgt).to(torch.float32)
        if self.mesh is not None:
            sums = torch.stack([loss * (y.numel() / total), inter, union])
            dist.all_reduce(sums, group=self._parts_group())
            loss, inter, union = sums
        iou = torch.where(union == 0, torch.ones_like(union), inter / torch.clamp(union, min=1))
        return {"loss": float(loss), "iou": float(iou)}

