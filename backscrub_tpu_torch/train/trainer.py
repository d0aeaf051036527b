"""Fine-tuning of segmentation models on one card (counterpart of
``backscrub_tpu/train/trainer.py``).

The graph executor walks the loaded ``.tflite`` graph with PyTorch ops,
so every model it runs is differentiable: :class:`Trainer` holds the
parameters as f32 leaves, runs ``CompiledModel.raw_fn`` on them and
steps ``torch.optim.Adam`` (``AdamW`` with a weight decay), the optax
transforms of the JAX package.  The losses match each family's head
(:func:`segmentation_loss`), and ``evaluate`` measures the IoU of the
mask the deployed decode rule gives.

The JAX trainer also shards its step over a (data, model) mesh, with
image rows over "model" where ``TrainConfig.spatial_shard`` asks; that is
ROADMAP queue 1 item 8, and ``Trainer(mesh=...)`` refuses it here.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch
import torch.nn.functional as F

from ..graph.executor import CompiledModel
from ..models.specs import ModelSpec
from ..pipeline.decode import decode_val
from ..pipeline.maskgen import set_precision_policy

@dataclasses.dataclass
class TrainConfig:
    learning_rate: float = 1e-4
    weight_decay: float = 0.0


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
    loaded on the CPU).

    ``batch`` = (frames f32 (N, H, W, 3) normalized, target person
    probability (N, H, W)), numpy or tensors.  ``params`` are the model's
    weights as f32 leaves (its own ``params`` stay as loaded);
    ``opt_state`` the optimizer's moments as {"count", "mu", "nu"} under
    the parameter keys, the layout of ``train/checkpoint.py``.
    """

    def __init__(self, model: CompiledModel, spec: ModelSpec, mesh=None,
                 config: TrainConfig = TrainConfig()):
        if mesh is not None:
            raise ValueError("the port trains on one card: the mesh's data, tensor and "
                             "spatial sharding are ROADMAP queue 1 item 8")
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
        self._params = {k: (v.detach().to(torch.float32).clone().requires_grad_(True)
                            if v.is_floating_point() else v)
                        for k, v in model.params.items()}
        self._trainable = {k: v for k, v in self._params.items() if v.requires_grad}
        leaves = list(self._trainable.values())
        self.opt = (torch.optim.AdamW(leaves, config.learning_rate,
                                      weight_decay=config.weight_decay)
                    if config.weight_decay else
                    torch.optim.Adam(leaves, config.learning_rate))

    @property
    def device(self) -> torch.device:
        return next(iter(self._params.values())).device

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        return self._params

    @params.setter
    def params(self, values: Dict[str, object]) -> None:
        """Copy ``values`` (arrays or tensors under every parameter key)
        into the trained leaves."""
        with torch.no_grad():
            for k, p in self._params.items():
                p.copy_(torch.as_tensor(values[k]).to(p.device, p.dtype))

    @property
    def opt_state(self) -> dict:
        """{"count": steps taken, "mu": first moments, "nu": second moments},
        host f32 arrays under the parameter keys (zeros before the first
        step, as optax initialises them)."""
        count, mu, nu = 0, {}, {}
        for k, p in self._trainable.items():
            st = self.opt.state.get(p, {})
            if st:
                count = int(st["step"])
            mu[k] = (st["exp_avg"] if st else torch.zeros_like(p)).detach().cpu().numpy()
            nu[k] = (st["exp_avg_sq"] if st else torch.zeros_like(p)).detach().cpu().numpy()
        return {"count": count, "mu": mu, "nu": nu}

    @opt_state.setter
    def opt_state(self, state: dict) -> None:
        count = int(state["count"])
        for k, p in self._trainable.items():
            if count == 0:
                self.opt.state.pop(p, None)
                continue
            self.opt.state[p] = {
                "step": torch.tensor(float(count), dtype=torch.float32),
                "exp_avg": torch.as_tensor(state["mu"][k]).to(p.device, p.dtype).clone(),
                "exp_avg_sq": torch.as_tensor(state["nu"][k]).to(p.device, p.dtype).clone()}

    def _batch(self, x, y):
        return tuple(torch.as_tensor(v).to(self.device, torch.float32) for v in (x, y))

    def step(self, x, y) -> float:
        """One optimizer step; returns the scalar loss (before the step)."""
        x, y = self._batch(x, y)
        self.opt.zero_grad(set_to_none=True)
        loss = self.loss_fn(self.model.raw_fn(self._params, x).float(), y)
        loss.backward()
        self.opt.step()
        return float(loss.detach())

    @torch.no_grad()
    def evaluate(self, x, y) -> dict:
        """Validation metrics on a batch: {'loss', 'iou'}.  The IoU compares
        the target (person where y > 0.5) with the mask the DEPLOYED decode
        rule produces (``pipeline/decode.py`` ``decode_val`` == 0), the
        train-time analog of the golden-test IoU gate."""
        x, y = self._batch(x, y)
        out = self.model.raw_fn(self._params, x).float()
        loss = self.loss_fn(out, y)
        pred = decode_val(out, self.spec) == 0
        tgt = y > 0.5
        inter = torch.sum(pred & tgt).to(torch.float32)
        union = torch.sum(pred | tgt).to(torch.float32)
        iou = torch.where(union == 0, torch.ones_like(union), inter / torch.clamp(union, min=1))
        return {"loss": float(loss), "iou": float(iou)}

